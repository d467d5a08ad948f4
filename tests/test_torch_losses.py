"""cc_tpu_torch losses vs cc_tpu on shared numpy inputs: each loss
function's value and its gradients (autograd against jax.grad), and the
thresholded masks and targets by their mismatch fraction. NHWC on both
sides, two scales where a loss takes a pyramid."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cc_tpu.losses import charbonnier as jch
from cc_tpu.losses import consensus as jcons
from cc_tpu.losses import explainability as jexp
from cc_tpu.losses import photometric as jphoto
from cc_tpu.losses import smoothness as jsmooth
from cc_tpu.losses.ssim import ssim as jax_ssim
from cc_tpu_torch.losses import charbonnier as tch
from cc_tpu_torch.losses import consensus as tcons
from cc_tpu_torch.losses import explainability as texp
from cc_tpu_torch.losses import photometric as tphoto
from cc_tpu_torch.losses import smoothness as tsmooth
from cc_tpu_torch.losses import ssim as tssim
from tests.torch_port_util import assert_close

torch.set_num_threads(2)

# a scalar loss: fp32 means over a few thousand terms, in another order;
# relative to the loss
VALUE_RTOL = 2e-5
# gradients, relative to each gradient's largest entry: a few warps and
# blurs deep, summed in another order
GRAD_RTOL = 2e-4
# thresholded masks: the share of pixels allowed to fall on the other side
# of a threshold because an input differs by rounding
MISMATCH = 0.01

B, H, W = 2, 16, 24
SCALES = [(16, 24), (8, 12)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _camera(b=B, h=H, w=W):
    k = np.array([[w * 0.9, 0, w / 2], [0, h * 1.1, h / 2], [0, 0, 1]],
                 dtype=np.float32)[None].repeat(b, 0)
    return k, np.linalg.inv(k).astype(np.float32)


def _images(r, n):
    """Smooth images in [-1, 1]: a shifted base, so warps are informative."""
    base = r.rand(H + 8, W + 8, 3).astype(np.float32)
    shifts = [(4, 4), (4, 2), (4, 3), (4, 5), (4, 6)][:n]
    return [np.repeat(base[None, dy:dy + H, dx:dx + W], B, 0) * 2 - 1
            for dy, dx in shifts]


def _check(jax_loss, torch_loss, inputs, argnums, name):
    """Value and gradients w.r.t. inputs[argnums] (pytrees of arrays)."""
    jin = jax.tree_util.tree_map(jnp.asarray, inputs)
    val, grads = jax.jit(jax.value_and_grad(jax_loss, argnums=argnums))(*jin)
    tin = jax.tree_util.tree_map(_t, inputs)
    for i in argnums:
        jax.tree_util.tree_map(lambda t: t.requires_grad_(), tin[i])
    out = torch_loss(*tin)
    out.backward()
    assert_close(out.detach(), np.float32(val), VALUE_RTOL * abs(float(val)),
                 f"{name} value")
    for i, g in zip(argnums, grads):
        for k, (t, e) in enumerate(zip(jax.tree_util.tree_leaves(tin[i]),
                                       jax.tree_util.tree_leaves(g))):
            e = np.asarray(e)
            assert t.grad is not None, f"{name} arg {i}.{k}: no gradient"
            assert_close(t.grad, e, GRAD_RTOL * max(np.abs(e).max(), 1e-12),
                         f"{name} d arg {i}.{k}")


def _mismatch(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.mean(a != b))


def test_charbonnier():
    x = np.random.RandomState(0).randn(3, 5, 7, 2).astype(np.float32)
    assert_close(tch.robust_l1_per_pix(_t(x), q=0.4),
                 jch.robust_l1_per_pix(jnp.asarray(x), q=0.4), 1e-6, "per pix")
    _check(lambda a: jch.robust_l1(a, q=0.5),
           lambda a: tch.robust_l1(a, q=0.5), [x], (0,), "robust_l1")
    assert_close(tch.robust_l1(_t(x), dim=(1, 2, 3)),
                 jch.robust_l1(jnp.asarray(x), axis=(1, 2, 3)), 1e-6, "dim")
    assert_close(tch.mean32(_t(x)), jch.mean32(jnp.asarray(x)), 1e-6, "mean")


def test_ssim_map_and_gradient():
    r = np.random.RandomState(1)
    a, b = r.rand(B, H, W, 3).astype(np.float32), r.rand(B, H, W, 3).astype(
        np.float32)
    ref = jax_ssim(jnp.asarray(a), jnp.asarray(b))
    assert_close(tssim.ssim(_t(a), _t(b)), ref, 1e-5, "ssim map")
    _check(lambda x, y: jnp.mean(jax_ssim(x, y) ** 2),
           lambda x, y: (tssim.ssim(x, y) ** 2).mean(), [a, b], (0, 1), "ssim")


def test_occlusion_masks():
    r = np.random.RandomState(2)
    fb = r.uniform(-3, 3, (B, H, W, 2)).astype(np.float32)
    ff = r.uniform(-3, 3, (B, H, W, 2)).astype(np.float32)
    m1, m2 = tphoto.occlusion_masks(_t(fb), _t(ff))
    r1, _ = jphoto.occlusion_masks(jnp.asarray(fb), jnp.asarray(ff))
    assert torch.equal(m1, m2)
    assert 0 < np.asarray(r1).mean() < 1
    assert _mismatch(m1.numpy(), r1) <= MISMATCH


def test_depth_occlusion_masks():
    r = np.random.RandomState(3)
    depth = r.uniform(0.2, 3.0, (B, H, W, 1)).astype(np.float32)
    pose = r.uniform(-0.5, 0.5, (B, 4, 6)).astype(np.float32)
    k, k_inv = _camera()
    ref = jphoto.depth_occlusion_masks(*map(jnp.asarray,
                                            (depth, pose, k, k_inv)))
    out = tphoto.depth_occlusion_masks(*map(_t, (depth, pose, k, k_inv)))
    assert out.shape == ref.shape == (B, H, W, 4)
    assert 0 < np.asarray(ref).mean() < 1
    assert _mismatch(out.numpy(), ref) <= MISMATCH


def test_valid_pixels_and_oob_norm():
    r = np.random.RandomState(4)
    warped = r.randn(B, H, W, 3).astype(np.float32)
    warped[0, :5] = 0.0           # all channels exactly 0: invalid
    warped[1, 2, 3, 1] = 0.0      # one channel 0: still valid
    ref = jphoto._valid_pixels(jnp.asarray(warped))
    valid = tphoto._valid_pixels(_t(warped))
    assert_close(valid, ref, 0.0, "valid")
    for v in (valid, torch.zeros_like(valid)):  # some valid; none valid
        norm, gate = tphoto._oob_norm(v)
        jnorm, jgate = jphoto._oob_norm(jnp.asarray(v.numpy()))
        assert_close(norm, jnorm, 1e-6, "norm")
        assert_close(gate, jgate, 0.0, "gate")


def _rigid_inputs(seed, with_mask=True):
    r = np.random.RandomState(seed)
    tgt, *refs = _images(r, 5)
    depth = [r.uniform(1.0, 4.0, (B, h, w, 1)).astype(np.float32)
             for h, w in SCALES]
    masks = [r.uniform(0.05, 0.95, (B, h, w, 4)).astype(np.float32)
             for h, w in SCALES] if with_mask else [None] * len(SCALES)
    pose = r.uniform(-0.03, 0.03, (B, 4, 6)).astype(np.float32)
    k, k_inv = _camera()
    return [tgt, refs, k, k_inv, depth, masks, pose]


@pytest.mark.parametrize("padding,with_mask,wssim", [
    ("zeros", True, 0.997), ("border", False, 0.3)])
def test_photometric_reconstruction_loss(padding, with_mask, wssim):
    kw = dict(padding_mode=padding, wssim=wssim, qch=0.5)
    _check(lambda *a: jphoto.photometric_reconstruction_loss(*a, **kw),
           lambda *a: tphoto.photometric_reconstruction_loss(*a, **kw),
           _rigid_inputs(5, with_mask), (0, 1, 4, 5, 6) if with_mask
           else (0, 1, 4, 6), f"rigid {padding}")


def _flow_inputs(seed, with_mask=True):
    r = np.random.RandomState(seed)
    tgt, ref_bwd, ref_fwd = _images(r, 3)
    flows = [[r.uniform(-2, 2, (B, h, w, 2)).astype(np.float32)
              for h, w in SCALES] for _ in range(2)]
    masks = [r.uniform(0.05, 0.95, (B, h, w, 2)).astype(np.float32)
             for h, w in SCALES] if with_mask else None
    return [tgt, [ref_bwd, ref_fwd], flows, masks]


@pytest.mark.parametrize("with_mask,shared,lambda_oob", [
    (True, True, 0.0), (False, False, 0.5)])
def test_photometric_flow_loss(with_mask, shared, lambda_oob):
    kw = dict(wssim=0.997, qch=0.5, lambda_oob=lambda_oob)

    def jax_loss(tgt, refs, flows, masks):
        warped = ([jphoto.flow_warped_refs(ref, f)
                   for ref, f in zip(refs, flows)] if shared else None)
        return jphoto.photometric_flow_loss(tgt, refs, flows, masks,
                                            warped_refs=warped, **kw)

    def torch_loss(tgt, refs, flows, masks):
        warped = ([tphoto.flow_warped_refs(ref, f)
                   for ref, f in zip(refs, flows)] if shared else None)
        return tphoto.photometric_flow_loss(tgt, refs, flows, masks,
                                            warped_refs=warped, **kw)

    _check(jax_loss, torch_loss, _flow_inputs(6, with_mask),
           (0, 1, 2, 3) if with_mask else (0, 1, 2), "flow")


def test_smooth_loss():
    r = np.random.RandomState(7)
    preds = [r.randn(B, h, w, 2).astype(np.float32) for h, w in SCALES]
    _check(jsmooth.smooth_loss, tsmooth.smooth_loss, [preds], (0,), "smooth")


def test_edge_aware_smoothness_loss():
    r = np.random.RandomState(8)
    img = r.rand(B, H, W, 3).astype(np.float32)
    preds = [r.randn(B, h, w, 1).astype(np.float32) for h, w in SCALES]
    _check(jsmooth.edge_aware_smoothness_loss,
           tsmooth.edge_aware_smoothness_loss, [img, preds], (0, 1),
           "edge-aware")


def test_explainability_loss_and_logical_or():
    r = np.random.RandomState(9)
    masks = [r.uniform(0.01, 1.0, (B, h, w, 4)).astype(np.float32)
             for h, w in SCALES]
    _check(jexp.explainability_loss, texp.explainability_loss, [masks], (0,),
           "explainability")
    # a mask at exactly 0: log clamped to -100 on both sides
    zero = [np.zeros((1, 2, 2, 1), np.float32)]
    assert_close(texp.explainability_loss([_t(zero[0])]),
                 jexp.explainability_loss([jnp.asarray(zero[0])]), 0.0, "0")
    a, b = masks[1], masks[1][..., ::-1]
    assert_close(texp.logical_or(_t(a), _t(b)),
                 jexp.logical_or(jnp.asarray(a), jnp.asarray(b)), 1e-7, "or")


def test_weighted_binary_cross_entropy():
    r = np.random.RandomState(10)
    out = r.uniform(0.0, 1.0, (B, H, W, 4)).astype(np.float32)
    out[0, 0, 0] = [0.0, 1.0, 1e-9, 1 - 1e-7]  # saturated outputs
    target = (r.rand(B, H, W, 4) > 0.5).astype(np.float32)
    _check(lambda o: jcons.weighted_binary_cross_entropy(o, target, [0.5, 0.5]),
           lambda o: tcons.weighted_binary_cross_entropy(o, _t(target),
                                                         [0.5, 0.5]),
           [out], (0,), "wbce")
    _check(lambda o: jcons.weighted_binary_cross_entropy(o, target),
           lambda o: tcons.weighted_binary_cross_entropy(o, _t(target)),
           [out], (0,), "bce")


def _consensus_inputs(seed):
    r = np.random.RandomState(seed)
    tgt, ref_bwd, ref_fwd = _images(r, 3)
    flow = lambda: [r.uniform(-2, 2, (B, h, w, 2)).astype(np.float32)
                    for h, w in SCALES]
    return tgt, ref_fwd, ref_bwd, flow(), flow(), flow(), flow()


def test_consensus_exp_masks():
    tgt, ref_fwd, ref_bwd, cam_fwd, cam_bwd, fwd, bwd = _consensus_inputs(11)
    kw = dict(wssim=0.997, wrig=1.0)
    ref = jcons.consensus_exp_masks(
        *jax.tree_util.tree_map(jnp.asarray, (cam_fwd, cam_bwd, fwd, bwd,
                                              tgt, ref_fwd, ref_bwd)), **kw)
    shared = tphoto.flow_warped_refs(_t(ref_fwd), [_t(f) for f in fwd])
    for pre in (None, shared):
        out = tcons.consensus_exp_masks(
            *jax.tree_util.tree_map(_t, (cam_fwd, cam_bwd, fwd, bwd, tgt,
                                         ref_fwd, ref_bwd)),
            flow_warped_fwd=pre, **kw)
        assert len(out) == len(ref)
        for o, e in zip(out, ref):
            assert o.shape == e.shape and 0 < np.asarray(e).mean() < 1
            assert _mismatch(o.numpy(), e) <= MISMATCH


def test_consensus_depth_flow_mask_given_targets():
    """Loss 5 against cc_tpu's with identical targets, which are detached
    on both sides: the gradient reaches the masks only."""
    r = np.random.RandomState(12)
    masks = [r.uniform(0.05, 0.95, (B, h, w, 4)).astype(np.float32)
             for h, w in SCALES]
    res = lambda: [np.abs(r.randn(B, h, w, 2)).astype(np.float32) * 0.02
                   for h, w in SCALES]
    rig_bwd, rig_fwd = res(), res()
    tgt_bwd = [(r.rand(B, h, w, 1) > 0.5).astype(np.float32) for h, w in SCALES]
    tgt_fwd = [(r.rand(B, h, w, 1) > 0.5).astype(np.float32) for h, w in SCALES]
    kw = dict(THRESH=0.01, wbce=0.5)
    _check(lambda m, rb, rf, tb, tf: jcons.consensus_depth_flow_mask(
               m, rb, rf, tb, tf, **kw),
           lambda m, rb, rf, tb, tf: tcons.consensus_depth_flow_mask(
               m, rb, rf, tb, tf, **kw),
           [masks, rig_bwd, rig_fwd, tgt_bwd, tgt_fwd], (0,), "consensus")


def test_compute_joint_mask_for_depth():
    r = np.random.RandomState(13)
    masks = [r.uniform(0, 1, (B, h, w, 4)).astype(np.float32)
             for h, w in SCALES]
    rig = lambda: [np.abs(r.randn(B, h, w, 2)).astype(np.float32) * 0.02
                   for h, w in SCALES]
    rb, rf = rig(), rig()
    ref = jcons.compute_joint_mask_for_depth(
        *jax.tree_util.tree_map(jnp.asarray, (masks, rb, rf)), 0.01)
    out = tcons.compute_joint_mask_for_depth(
        *jax.tree_util.tree_map(_t, (masks, rb, rf)), 0.01)
    for o, e in zip(out, ref):
        assert not o.requires_grad and o.shape == e.shape
        assert _mismatch(o.numpy(), e) <= MISMATCH
