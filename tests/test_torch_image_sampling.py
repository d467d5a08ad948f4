"""cc_tpu_torch image ops and bilinear sampling vs cc_tpu, on shared numpy
inputs. The port's ops are NCHW, cc_tpu's NHWC."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cc_tpu.geometry import sampling as jsamp
from cc_tpu.ops import image as jimg
from cc_tpu_torch.geometry import sampling as tsamp
from cc_tpu_torch.ops import image as timg
from tests.torch_port_util import assert_close, nchw_to_nhwc, nhwc_to_nchw

torch.set_num_threads(2)

# bilinear weights are fp32 in torch and fp64-then-fp32 in cc_tpu's
# resampling matrices: a few ulps on randn payloads
RESIZE_ATOL = 2e-6
# grid_sample: the sample location differs by float32 rounding (~1e-6 px at
# these widths) times the payload's slope between taps
SAMPLE_ATOL = 1e-5


def _img(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (4, 6), (7, 3)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_upsample2x_bilinear(hw, align_corners):
    x = _img((2, *hw, 3))
    ref = jimg.upsample2x_bilinear(jnp.asarray(x), align_corners=align_corners)
    out = timg.upsample2x_bilinear(nhwc_to_nchw(x), align_corners=align_corners)
    assert_close(nchw_to_nhwc(out), ref, RESIZE_ATOL, f"{hw}")


@pytest.mark.parametrize("out_hw", [(13, 9), (3, 2), (5, 7)])
def test_resize_bilinear(out_hw):
    x = _img((1, 5, 7, 2), 1)
    ref = jimg.resize_bilinear(jnp.asarray(x), out_hw)
    out = timg.resize_bilinear(nhwc_to_nchw(x), out_hw)
    assert_close(nchw_to_nhwc(out), ref, RESIZE_ATOL, f"{out_hw}")


@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_nearest(scale):
    x = _img((2, 3, 5, 2), 2)
    ref = jimg.upsample_nearest(jnp.asarray(x), scale)
    out = timg.upsample_nearest(nhwc_to_nchw(x), scale)
    assert_close(nchw_to_nhwc(out), ref, 0.0, f"x{scale}")


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample(mode):
    img = _img((2, 9, 13, 3), 3)
    grid = np.random.RandomState(4).uniform(
        -1.3, 1.3, (2, 6, 7, 2)).astype(np.float32)
    ref = jsamp.grid_sample(jnp.asarray(img), jnp.asarray(grid), mode)
    out = tsamp.grid_sample(nhwc_to_nchw(img), torch.from_numpy(grid), mode)
    assert_close(nchw_to_nhwc(out), ref, SAMPLE_ATOL, mode)


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_flow_warp(mode):
    img = _img((2, 16, 24, 4), 5)
    flow = np.random.RandomState(6).uniform(
        -6, 6, (2, 16, 24, 2)).astype(np.float32)
    ref = jsamp.flow_warp(jnp.asarray(img), jnp.asarray(flow), mode)
    out = tsamp.flow_warp(nhwc_to_nchw(img), nhwc_to_nchw(flow), mode)
    assert_close(nchw_to_nhwc(out), ref, SAMPLE_ATOL, mode)


def test_flow_warp_fully_out_of_bounds_is_exactly_zero():
    img = _img((1, 8, 10, 3), 7)
    flow = np.full((1, 8, 10, 2), 50.0, np.float32)
    ref = np.asarray(jsamp.flow_warp(jnp.asarray(img), jnp.asarray(flow)))
    out = nchw_to_nhwc(tsamp.flow_warp(nhwc_to_nchw(img), nhwc_to_nchw(flow)))
    assert np.all(ref == 0.0)
    assert np.all(out == 0.0)


def test_unknown_padding_mode_raises():
    with pytest.raises(ValueError, match="padding_mode"):
        tsamp.grid_sample(torch.zeros(1, 1, 2, 2), torch.zeros(1, 1, 1, 2),
                          "reflection")
