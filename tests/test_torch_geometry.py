"""cc_tpu_torch geometry vs cc_tpu on shared numpy inputs: rotations,
projection in both padding modes, inverse_warp, pose2flow, flow2oob, the
warp identity, the gradients of grid_sample, flow_warp and inverse_warp
against jax.grad, and adaptive_avg_pool. Both sides are NHWC here.
Besides: the CPU's stand-in for border padding against torch's own border
mode, and a CPU train step with a NaN pixel, dropped and not crashed."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cc_tpu import geometry as jgeo
from cc_tpu.ops import image as jimg
from cc_tpu_torch.geometry import camera, rotation, sampling, warp
from cc_tpu_torch.ops import image as timg
from tests.torch_port_util import assert_close

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

# fp32 projections and trig through a few ops, evaluated in another order
GEO_ATOL = 1e-5
# a warp: the sample location differs by float32 rounding (~1e-5 px after
# the projection) times the payload's slope between taps
WARP_ATOL = 1e-4
# gradients: sums of a few bilinear weights times O(1) cotangents
GRAD_ATOL = 1e-4
POOL_ATOL = 1e-6  # sums of at most 16 values, in another order

B, H, W = 2, 12, 16


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _camera(b=B, h=H, w=W):
    k = np.array([[w * 0.9, 0, w / 2], [0, h * 1.1, h / 2], [0, 0, 1]],
                 dtype=np.float32)[None].repeat(b, 0)
    return k, np.linalg.inv(k).astype(np.float32)


def _scene(seed, b=B, h=H, w=W, pose_scale=0.1):
    r = np.random.RandomState(seed)
    img = r.randn(b, h, w, 3).astype(np.float32)
    depth = r.uniform(1.0, 5.0, (b, h, w)).astype(np.float32)
    pose = r.uniform(-pose_scale, pose_scale, (b, 6)).astype(np.float32)
    return img, depth, pose


@pytest.mark.parametrize("mode", ["euler", "quat"])
def test_pose_vec2mat(mode):
    vec = np.random.RandomState(0).uniform(-1, 1, (5, 6)).astype(np.float32)
    ref = jgeo.pose_vec2mat(jnp.asarray(vec), mode)
    assert_close(rotation.pose_vec2mat(_t(vec), mode), ref, GEO_ATOL, mode)


def test_pixel2cam():
    _, depth, _ = _scene(1)
    _, k_inv = _camera()
    ref = jgeo.pixel2cam(jnp.asarray(depth), jnp.asarray(k_inv))
    assert_close(camera.pixel2cam(_t(depth), _t(k_inv)), ref, GEO_ATOL)


@pytest.mark.parametrize("padding", ["zeros", "border", None])
def test_cam2pixel(padding):
    """Points in front of and behind the camera (the Z clamp), some
    projecting outside the image (the zeros-mode sentinel)."""
    r = np.random.RandomState(2)
    cam = r.uniform(-3, 3, (B, H, W, 3)).astype(np.float32)
    cam[..., 2] = r.uniform(-0.5, 4.0, (B, H, W))
    rot = r.uniform(-1, 1, (B, 3, 3)).astype(np.float32) + 5 * np.eye(3,
                                                                       dtype=np.float32)
    tr = r.uniform(-1, 1, (B, 3)).astype(np.float32)
    ref = np.asarray(jgeo.cam2pixel(jnp.asarray(cam), jnp.asarray(rot),
                                    jnp.asarray(tr), padding))
    out = camera.cam2pixel(_t(cam), _t(rot), _t(tr), padding)
    # relative: Z clamped to 1e-3 makes coordinates up to ~1e4
    assert_close(out, ref, GEO_ATOL * max(1.0, np.abs(ref).max()), str(padding))
    if padding == "zeros":
        assert (ref == 2.0).any() and ((out.numpy() == 2.0) == (ref == 2.0)).all()


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("mode", ["euler", "quat"])
def test_inverse_warp(padding, mode):
    img, depth, pose = _scene(3)
    k, k_inv = _camera()
    ref = jgeo.inverse_warp(*map(jnp.asarray, (img, depth, pose, k, k_inv)),
                            rotation_mode=mode, padding_mode=padding)
    out = warp.inverse_warp(*map(_t, (img, depth, pose, k, k_inv)),
                            rotation_mode=mode, padding_mode=padding)
    assert_close(out, ref, WARP_ATOL, f"{padding} {mode}")


def test_pose2flow_and_flow2oob():
    _, depth, pose = _scene(4, pose_scale=0.3)
    k, k_inv = _camera()
    ref = jgeo.pose2flow(*map(jnp.asarray, (depth, pose, k, k_inv)))
    out = warp.pose2flow(*map(_t, (depth, pose, k, k_inv)))
    assert_close(out, ref, GEO_ATOL * max(1.0, float(np.abs(ref).max())),
                 "pose2flow")
    flow = np.random.RandomState(5).uniform(-20, 20, (B, H, W, 2)).astype(
        np.float32)
    oob_ref = np.asarray(jgeo.flow2oob(jnp.asarray(flow)))
    oob = warp.flow2oob(_t(flow))
    assert oob.dtype == torch.bool and oob_ref.any() and not oob_ref.all()
    np.testing.assert_array_equal(oob.numpy(), oob_ref)


def test_inverse_warp_equals_flow_warp_of_pose2flow():
    """The reference's own consistency probe (train.py:732-740; PARITY.md
    §2.1), on the port alone, with test_geometry.py's tolerance."""
    r = np.random.RandomState(12)
    b, h, w = 2, 32, 48
    img = r.rand(b, h, w, 3).astype(np.float32)
    depth = (r.rand(b, h, w) * 5 + 2).astype(np.float32)
    pose = r.uniform(-0.02, 0.02, (b, 6)).astype(np.float32)
    k, k_inv = _camera(b, h, w)
    direct = warp.inverse_warp(*map(_t, (img, depth, pose, k, k_inv)),
                               padding_mode="border")
    flow = warp.pose2flow(*map(_t, (depth, pose, k, k_inv)))
    via_flow = sampling.flow_warp_nhwc(_t(img), flow, padding_mode="border")
    assert_close(via_flow, direct, 1e-3, "identity")


def _grad_pair(jax_fn, torch_fn, inputs, seed):
    """Gradients of sum(cot * f(inputs)) by jax.grad and by autograd."""
    out_shape = np.asarray(jax_fn(*map(jnp.asarray, inputs))).shape
    cot = np.random.RandomState(seed).randn(*out_shape).astype(np.float32)
    argnums = tuple(range(len(inputs)))
    jgrads = jax.jit(jax.grad(
        lambda *a: jnp.sum(jnp.asarray(cot) * jax_fn(*a)),
        argnums=argnums))(*map(jnp.asarray, inputs))
    tin = [_t(x).requires_grad_() for x in inputs]
    (torch.from_numpy(cot) * torch_fn(*tin)).sum().backward()
    return [t.grad for t in tin], jgrads


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_gradients(padding):
    r = np.random.RandomState(6)
    img = r.randn(B, H, W, 3).astype(np.float32)
    grid = r.uniform(-1.2, 1.2, (B, 7, 9, 2)).astype(np.float32)
    mine, ref = _grad_pair(
        lambda i, g: jgeo.grid_sample(i, g, padding_mode=padding),
        lambda i, g: sampling.grid_sample_nhwc(i, g, padding_mode=padding),
        [img, grid], 7)
    assert_close(mine[0], ref[0], GRAD_ATOL, "d img")
    # d grid scales by (W-1)/2 from pixels to normalized units
    assert_close(mine[1], ref[1], GRAD_ATOL * W, "d grid")


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_flow_warp_gradients(padding):
    r = np.random.RandomState(8)
    img = r.randn(B, H, W, 3).astype(np.float32)
    flow = r.uniform(-4, 4, (B, H, W, 2)).astype(np.float32)
    mine, ref = _grad_pair(
        lambda i, f: jgeo.flow_warp(i, f, padding_mode=padding),
        lambda i, f: sampling.flow_warp_nhwc(i, f, padding_mode=padding),
        [img, flow], 9)
    assert_close(mine[0], ref[0], GRAD_ATOL, "d img")
    assert_close(mine[1], ref[1], GRAD_ATOL, "d flow")


def test_inverse_warp_gradients():
    """Through the projection, the Z clamp and the zeros-mode sentinel."""
    img, depth, pose = _scene(10, pose_scale=0.2)
    k, k_inv = _camera()
    mine, ref = _grad_pair(
        lambda i, d, p: jgeo.inverse_warp(i, d, p, jnp.asarray(k),
                                          jnp.asarray(k_inv)),
        lambda i, d, p: warp.inverse_warp(i, d, p, _t(k), _t(k_inv)),
        [img, depth, pose], 11)
    for name, a, e in zip(("img", "depth", "pose"), mine, ref):
        e = np.asarray(e)
        assert_close(a, e, GRAD_ATOL * max(1.0, np.abs(e).max()), f"d {name}")


@pytest.mark.parametrize("in_hw,out_hw", [
    ((16, 24), (4, 6)), ((16, 24), (8, 3)), ((16, 24), (16, 24)),
    ((13, 10), (4, 6)), ((7, 9), (3, 2))])
@pytest.mark.parametrize("channels", [3, None])
def test_adaptive_avg_pool(in_hw, out_hw, channels):
    shape = (2, *in_hw) + ((channels,) if channels else ())
    x = np.random.RandomState(12).randn(*shape).astype(np.float32)
    ref = jimg.adaptive_avg_pool(jnp.asarray(x), out_hw)
    out = timg.adaptive_avg_pool(_t(x), out_hw)
    assert_close(out, ref, POOL_ATOL, f"{in_hw}->{out_hw}")


def test_border_sampling_on_the_cpu_equals_border_mode():
    """On the CPU, border padding is the grid clamped to [-1, 1] (with no
    gradient on and beyond the edges) sampled with zeros padding: the same
    values and gradients as F.grid_sample's border mode, bit for bit, on
    grids inside, outside and exactly on the edges."""
    import torch.nn.functional as F
    r = np.random.RandomState(13)
    img = r.randn(2, 3, 9, 11).astype(np.float32)
    grid = r.uniform(-1.3, 1.3, (2, 7, 8, 2)).astype(np.float32)
    grid[0, 0, :4] = [[1, -1], [-1, 1], [1, 0.3], [-0.2, -1]]
    cot = torch.from_numpy(r.randn(2, 3, 7, 8).astype(np.float32))
    got = []
    for fn in (lambda i, g: F.grid_sample(i, g, padding_mode="border",
                                          align_corners=True),
               lambda i, g: sampling.grid_sample(i, g, "border")):
        i, g = _t(img).requires_grad_(), _t(grid).requires_grad_()
        out = fn(i, g)
        (cot * out).sum().backward()
        got.append((out.detach(), i.grad, g.grad))
    for name, a, e in zip(("value", "d img", "d grid"), *got):
        assert torch.equal(a, e), name


def test_nan_pixel_step_is_dropped_not_crashed():
    """A train step on the CPU with one NaN pixel in a reference frame
    (tests/torch_port_util.nan_pixel_step): F's border-padded feature
    warps meet NaN locations, the gradients are not finite, and
    skip_nonfinite_updates drops the step; then the same step in bf16,
    the guarded recipe (compute and loss dtype bfloat16, clip 5), dropped
    by the same guard. In a subprocess, since torch's CPU backward of
    border mode kills the process on a NaN location."""
    script = ("import torch; torch.set_num_threads(2); "
              "from torch_port_util import nan_pixel_step; "
              "print(nan_pixel_step('cpu')); "
              "print(nan_pixel_step('cpu', compute_dtype='bfloat16', "
              "loss_dtype='bfloat16', clip_grad_norm=5.0))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    res = subprocess.run([sys.executable, "-c", script], cwd=TESTS, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.returncode, res.stderr[-2000:])
    got = [ast.literal_eval(line)
           for line in res.stdout.strip().splitlines()[-2:]]
    for dtype, g in zip(("float32", "bfloat16"), got):
        assert g == {"count": 0, "notfinite": 1, "step": 1,
                     "loss_finite": False, "unchanged": True}, (dtype, g)
