"""The port's host metrics, composite masks and visualization against
cc_tpu's, on the same numpy inputs made from a seed: flow_diff,
compute_epe, outlier_err, compute_all_epes and compute_depth_errors (whose
resizes are torch's F.interpolate in the port and cc_tpu's matrix resize);
rigidity_masks and composite_flow; and the colormap tables, built without
matplotlib in the port and through it in cc_tpu."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cc_tpu.eval import composite as jcomp
from cc_tpu.losses import metrics as jmet
from cc_tpu.utils import viz as jviz
from cc_tpu_torch.eval import composite as tcomp
from cc_tpu_torch.losses import metrics as tmet
from cc_tpu_torch.utils import viz as tviz
from tests.torch_port_util import assert_close

torch.set_num_threads(2)

# fp32 metrics through a bilinear resize whose sums run in another order;
# relative to each metric
RTOL = 1e-6
# The per-pixel endpoint error after the resize: torch's fp32 bilinear
# computes each source coordinate in fp32 ((dst + 0.5) * scale - 0.5, about
# 1e-5 px off at 250 px), which moves a pixel by up to ~1e-5 of the flow's
# range; cc_tpu's matrix resize is within 3e-6 px of float64 (measured
# 6.2e-4 px on flows within +-20 px: 9e-6 of the largest error). Relative
# to the largest error; the means above average it out.
FLOW_DIFF_RTOL = 2e-5
PRED_HW = (64, 128)
# GT at the prediction's size, and at a size that needs the resize
GT_HWS = [(64, 128), (100, 250)]


def _flows(gt_hw, b=2, seed=0):
    r = np.random.RandomState(seed)
    gt = r.uniform(-20, 20, (b, *gt_hw, 3)).astype(np.float32)
    gt[..., 2] = r.rand(b, *gt_hw) > 0.3  # validity
    rigid = r.uniform(-20, 20, (b, *PRED_HW, 2)).astype(np.float32)
    non_rigid = r.uniform(-20, 20, (b, *PRED_HW, 2)).astype(np.float32)
    mask = r.rand(b, *PRED_HW, 1).astype(np.float32)
    return gt, rigid, non_rigid, mask


def _assert_rel(mine, ref, name):
    for i, (a, e) in enumerate(zip(mine, ref, strict=True)):
        assert abs(a - e) <= RTOL * max(abs(e), 1e-6), (name, i, a, e)


@pytest.mark.parametrize("gt_hw", GT_HWS)
def test_flow_metrics_match(gt_hw):
    gt, rigid, non_rigid, mask = _flows(gt_hw)
    ref = jmet.flow_diff(gt[..., :2], rigid)
    assert_close(tmet.flow_diff(gt[..., :2], rigid), ref,
                 FLOW_DIFF_RTOL * float(np.abs(ref).max()), "flow_diff")
    _assert_rel([tmet.compute_epe(gt, rigid), tmet.compute_epe(gt[..., :2],
                                                                rigid),
                 tmet.outlier_err(gt, rigid)],
                [jmet.compute_epe(gt, rigid), jmet.compute_epe(gt[..., :2],
                                                                rigid),
                 jmet.outlier_err(gt, rigid)], "epe, outliers")
    # as validate_flow calls it: torch tensors for the predictions and mask
    mine = tmet.compute_all_epes(gt, torch.from_numpy(rigid),
                                 torch.from_numpy(non_rigid),
                                 torch.from_numpy(mask))
    _assert_rel(mine, jmet.compute_all_epes(gt, rigid, non_rigid, mask),
                "compute_all_epes")


def test_depth_errors_match():
    r = np.random.RandomState(1)
    gt = r.uniform(0, 90, (3, 64, 128)).astype(np.float32)  # some invalid
    pred = r.uniform(0.5, 60, (3, 64, 128)).astype(np.float32)
    for crop in (True, False):
        _assert_rel(tmet.compute_depth_errors(gt, torch.from_numpy(pred), crop),
                    jmet.compute_depth_errors(gt, pred, crop), f"crop={crop}")


def test_rigidity_masks_and_composite_match():
    r = np.random.RandomState(2)
    b, h, w = 2, 16, 24
    flow_fwd = r.uniform(-1, 1, (b, h, w, 2)).astype(np.float32)
    # half the pixels within THRESH of F's flow, so the census matters
    near = r.rand(b, h, w, 1) < 0.5
    flow_cam = np.where(near, flow_fwd + r.uniform(-0.005, 0.005,
                                                   (b, h, w, 2)),
                        r.uniform(-1, 1, (b, h, w, 2))).astype(np.float32)
    exp_mask = r.rand(b, h, w, 4).astype(np.float32)
    args = (flow_cam, flow_fwd, exp_mask)
    mine = tcomp.rigidity_masks(*map(torch.from_numpy, args), 0.01)
    ref = jcomp.rigidity_masks(*map(jnp.asarray, args), 0.01)
    for name, a, e in zip(("rigidity", "census", "combined"), mine, ref):
        assert_close(a, e, 0.0, name)
    assert 0 < float(ref[1].mean()) < 1
    total, combined = tcomp.composite_flow(*map(torch.from_numpy, args), 0.01)
    total_ref, combined_ref = jcomp.composite_flow(*map(jnp.asarray, args),
                                                   0.01)
    assert_close(total, total_ref, 0.0, "total flow")
    assert_close(combined, combined_ref, 0.0, "combined")


@pytest.mark.parametrize("name", ["bone", "magma", "rainbow"])
def test_colormap_tables_match(name):
    """cc_tpu reads bone and magma from matplotlib; the port builds them."""
    mine, ref = tviz._get_cmap(name), jviz._get_cmap(name)
    assert_close(mine, ref, 1e-6, name)
    r = np.random.RandomState(3)
    x = r.uniform(0, 2, (40, 60)).astype(np.float32)
    x[0, :3] = (0.0, 1.0, 2.0)  # the first, last and out-of-range bins
    for max_value in (None, 1.0):
        assert_close(tviz.scalar_to_rgb(x, max_value, name),
                     jviz.scalar_to_rgb(x, max_value, name), 1e-6,
                     f"{name} max_value={max_value}")


def test_flow_images_match():
    r = np.random.RandomState(4)
    flow = r.uniform(-30, 30, (32, 48, 2)).astype(np.float32)
    flow[0, 0] = 1e8  # unknown flow
    assert_close(tviz.flow_to_image(flow), jviz.flow_to_image(flow), 0.0,
                 "flow_to_image")
    assert_close(tviz.flow_to_image_logscale(flow[1:]),
                 jviz.flow_to_image_logscale(flow[1:]), 0.0, "logscale")
    img = r.uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    assert_close(tviz.image_to_display(img), jviz.image_to_display(img), 0.0,
                 "image_to_display")


def test_viz_needs_no_matplotlib(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    tviz._CMAPS.clear()
    for name in ("bone", "magma"):
        assert tviz._get_cmap(name).shape == ((10000 if name == "bone"
                                                else 1000), 3)
