"""The port's flow evaluation against cc_tpu's: evaluate_flow's and
test_mask's host metrics on seeded arrays, and the evaluate_flow,
test_back2future (Back2Future and FlowNetC6) and test_flow CLIs end to
end from the same reference checkpoints on the same trees, the port on the
CPU, where F's correlation is the plain version (K1's launch counter stays
at 0). test_mask and submit_flow are in tests/test_torch_eval_submit.py.

The KITTI 2015 tree is the session fixture of tests/cli_fixtures.py
(kitti2015_dir: 2 items of 64x128 frames; test_back2future resizes them to
its fixed 256x832); the checkpoints are cc_tpu's export of drawn weights
(torch_port_util.save_drawn_checkpoint). Each cc_tpu CLI runs once, and
test_back2future once per flow net.
"""
import os

import numpy as np
import pytest
import torch

from cc_tpu.cli import evaluate_flow as jevaluate
from cc_tpu.cli import test_back2future as jb2f
from cc_tpu.cli import test_flow as jflow
from cc_tpu.utils.flow_io import flow_write_png
from cc_tpu_torch.cli import evaluate_flow as tevaluate
from cc_tpu_torch.cli import test_back2future as tb2f
from cc_tpu_torch.cli import test_flow as tflow
from cc_tpu_torch.ops import correlation as tcorr
from tests.cli_fixtures import H, W
from tests.torch_port_util import computed_once, save_drawn_checkpoint

torch.set_num_threads(2)

# float64 host metrics on equal inputs, in the same order: round-off only
F64_RTOL = 1e-12
# the EPE means: the nets agree to 1e-4 of each output's largest entry
# (tests/test_torch_models.py)
EPE_RTOL = 1e-4
# Shares (Fl, outliers) and the rigid and non-rigid partitions count
# pixels against thresholds (3 px and 5 %, the masks' 0.5 and THRESH),
# which a pixel within rounding of one may cross in one package and not
# in the other: at most this many of an item's valid pixels
EDGE_PIXELS = 3
# One pixel's endpoint error in this fixture: its GT flow lies within
# +-10 x +-5 px (|gt| < 11.2) and the drawn nets' flows within 30 px a
# component (measured: 22.3 px, FlowNetC6 at 256x832; 14.8 the four nets'
# at 64x128), so |gt - pred| < 11.2 + 42.5; a pixel that changes partition
# moves that partition's mean EPE by at most this over the valid pixels
MAX_PIXEL_EPE = 60.0
# subtracted from the drawn biases of M's two middle masks (see ckpts)
RIGID_SHIFT = [0.9, 1.4]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """_ckpts, written once per run."""
    return computed_once(tmp_path_factory, "eval_flow_ckpts",
                         lambda: _ckpts(tmp_path_factory))


def _ckpts(tmp_path_factory):
    """The paper's four nets and FlowNetC6, drawn, as the reference names
    its best checkpoints: {dispnet,posenet,masknet,flownet}_model_best."""
    d = tmp_path_factory.mktemp("ckpts")
    r = np.random.RandomState(41)
    specs = {"dispnet": ("DispResNet6", {}),
             "posenet": ("PoseNetB6", {"nb_ref_imgs": 4}),
             "masknet": ("MaskNet6", {"nb_ref_imgs": 4}),
             "flownet": ("Back2Future", {"nlevels": 6}),
             "flownetc6": ("FlowNetC6", {"nlevels": 6})}
    for name, (arch, kw) in specs.items():
        save_drawn_checkpoint(str(d / f"{name}_model_best.pth.tar"), arch,
                              r, **kw)
    # M's two middle masks, drawn, lie around 0.5 and 0.6, so that their
    # soft-OR (the rigidity) is over 0.5 at every pixel: lower their head's
    # biases so that the rigidity splits the frame, and both the rigid and
    # the non-rigid branches of the composite flow run
    path = d / "masknet_model_best.pth.tar"
    ckpt = torch.load(path, weights_only=True)
    ckpt["state_dict"]["pred_mask1.bias"][1:3] -= torch.tensor(RIGID_SHIFT)
    torch.save(ckpt, path)
    return d


def four_nets(ckpts):
    return ["--pretrained-disp", str(ckpts / "dispnet_model_best.pth.tar"),
            "--pretrained-pose", str(ckpts / "posenet_model_best.pth.tar"),
            "--pretrained-mask", str(ckpts / "masknet_model_best.pth.tar"),
            "--pretrained-flow", str(ckpts / "flownet_model_best.pth.tar")]


def n_valid(kitti_dir) -> int:
    """The fewest valid GT flow pixels of the tree's 2 training items."""
    from cc_tpu_torch.utils.flow_io import flow_read_png
    occ = os.path.join(str(kitti_dir), "data_scene_flow", "training",
                       "flow_occ")
    return min(int(flow_read_png(os.path.join(occ, f"{i:06d}_10.png"))[2]
                   .sum()) for i in range(2))


def assert_epes_close(names, mine, ref, valid):
    """EPE means within EPE_RTOL, partitions' means within EPE_RTOL plus
    MAX_PIXEL_EPE for each of EDGE_PIXELS changed pixels, shares within
    EDGE_PIXELS; `valid` the fewest valid pixels of an item."""
    edge = EDGE_PIXELS / valid
    for n, a, e in zip(names, mine, ref):
        if n in ("Fl", "Fl_gt_mask", "outliers"):
            tol = edge
        elif n.startswith("epe_total"):
            tol = EPE_RTOL * abs(e)
        else:
            tol = EPE_RTOL * abs(e) + MAX_PIXEL_EPE * edge
        assert abs(a - e) <= tol, (n, a, e, tol)


# ------------------------------------------------------------ host code


def test_compute_err_equals_cc_tpu():
    r = np.random.RandomState(42)
    u, v = r.uniform(-20, 20, (2, H, W))
    valid = (r.rand(H, W) > 0.3).astype(np.float64)
    for scale in (0.1, 3.0):
        du, dv = r.randn(2, H, W) * scale
        args = (u, v, valid, u + du, v + dv)
        np.testing.assert_allclose(tevaluate.compute_err(*args),
                                   jevaluate.compute_err(*args),
                                   rtol=F64_RTOL, atol=0)


def test_evaluate_flow_cli_equals_cc_tpu(tmp_path):
    r = np.random.default_rng(43)
    gt, pred = tmp_path / "gt", tmp_path / "pred"
    gt.mkdir(), pred.mkdir()
    for i in range(2):
        name = f"{i:06d}_10.png"
        u, v = r.uniform(-8, 8, (H, W)), r.uniform(-4, 4, (H, W))
        valid = (r.random((H, W)) > 0.2).astype(np.uint16)
        flow_write_png(str(gt / name), u, v, valid)
        flow_write_png(str(pred / name), u + r.normal(0, 3, (H, W)), v)
    argv = ["--gt-dir", str(gt), "--output-dir", str(pred), "-N", "2"]
    np.testing.assert_allclose(tevaluate.main(argv), jevaluate.main(argv),
                               rtol=F64_RTOL, atol=0)


# ------------------------------------------------------------ the CLIs


@pytest.mark.parametrize("flownet", ["Back2Future", "FlowNetC6"])
def test_back2future_cli_matches_cc_tpu(ckpts, kitti2015_dir, flownet):
    """F alone at 256x832 on 2 items: [epe_total, epe_rigid,
    epe_non_rigid, outliers], partitioned by the GT object map."""
    ckpt = "flownet" if flownet == "Back2Future" else "flownetc6"
    argv = ["--kitti-dir", str(kitti2015_dir), "--flownet", flownet,
            "--pretrained-flow", str(ckpts / f"{ckpt}_model_best.pth.tar"),
            "-N", "2"]
    ref = jb2f.main(argv)
    tcorr.launches = 0
    mine = tb2f.main(argv + ["--device", "cpu"])
    assert tcorr.launches == 0  # the plain correlation on the CPU
    print(f"test_back2future {flownet}: port {mine} cc_tpu {ref}")
    assert np.all(np.isfinite(ref)) and ref[0] > 0
    assert_epes_close(["epe_total", "epe_rigid", "epe_non_rigid",
                       "outliers"], mine, ref, n_valid(kitti2015_dir))


def test_flow_cli_matches_cc_tpu(ckpts, kitti2015_dir, tmp_path):
    """The four nets' composite flow on 2 items at 64x128: the 8 errors,
    and the dumped images, object maps and combined masks (at most
    EDGE_PIXELS of a mask's pixels differ)."""
    argv = ["--kitti-dir", str(kitti2015_dir), *four_nets(ckpts),
            "--img-height", str(H), "--img-width", str(W), "-N", "2"]
    ref, names = jflow.main(argv + ["--output-dir", str(tmp_path / "ref")])
    tcorr.launches = 0
    mine, my_names = tflow.main(argv + ["--output-dir",
                                        str(tmp_path / "mine"),
                                        "--device", "cpu"])
    assert tcorr.launches == 0
    print(f"test_flow: port {mine} cc_tpu {ref}")
    assert my_names == names and np.all(np.isfinite(ref))
    assert_epes_close(names, mine, ref, n_valid(kitti2015_dir))
    for sub in ("images", "gt", "mask"):
        files = sorted(os.listdir(tmp_path / "ref" / sub))
        assert files == sorted(os.listdir(tmp_path / "mine" / sub)) == \
            ["000.npy", "001.npy"]
        for fn in files:
            a = np.load(tmp_path / "mine" / sub / fn)
            e = np.load(tmp_path / "ref" / sub / fn)
            assert a.shape == e.shape and a.dtype == e.dtype, (sub, fn)
            if sub == "mask":
                assert (a != e).sum() <= EDGE_PIXELS, fn
                assert 0.1 < e.mean() < 0.9, fn  # both partitions run
            else:
                assert np.array_equal(a, e), (sub, fn)


@pytest.mark.parametrize("cli,argv", [
    (tb2f, ["--kitti-dir", "kitti", "--pretrained-flow", "none.pth.tar"]),
    (tflow, ["--kitti-dir", "kitti", "--pretrained-disp", "d",
             "--pretrained-pose", "p", "--pretrained-mask", "m",
             "--pretrained-flow", "f", "--output-dir", "out"]),
])
def test_flow_clis_default_to_cuda(cli, argv, tmp_path, monkeypatch):
    """--device defaults to cuda; without a GPU the CLI raises before it
    reads a file (here, checkpoints that do not exist) or writes one."""
    monkeypatch.chdir(tmp_path)
    assert cli.parser.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []
