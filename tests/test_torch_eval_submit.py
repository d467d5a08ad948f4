"""The port's motion-mask evaluation and KITTI submission against
cc_tpu's: test_mask's host metrics (mask_error, _iou) on seeded arrays,
and the test_mask and submit_flow CLIs end to end from the same reference
checkpoints on the same tree, the port on the CPU, where F's correlation
is the plain version (K1's launch counter stays at 0). The other flow CLIs
are in tests/test_torch_eval_flow.py, whose checkpoints these are.

The KITTI 2015 tree is the session fixture of tests/cli_fixtures.py
(kitti2015_dir: 2 training and 2 testing items of 64x128 frames, the
moving car in the bottom right quarter, a static car in the bottom left).
Each cc_tpu CLI runs once.
"""
import os

import numpy as np
import pytest
import torch

from cc_tpu.cli import submit_flow as jsubmit
from cc_tpu.cli import test_mask as jmask
from cc_tpu.utils.flow_io import flow_read_flo, flow_read_png
from cc_tpu_torch.cli import submit_flow as tsubmit
from cc_tpu_torch.cli import test_mask as tmask
from cc_tpu_torch.ops import correlation as tcorr
from tests.cli_fixtures import H, W
from tests.test_torch_eval_flow import EDGE_PIXELS, EPE_RTOL, four_nets
from tests.test_torch_eval_flow import ckpts  # noqa: F401  (a fixture)

torch.set_num_threads(2)

# Each class of the IoU (static and moving car) covers this many GT pixels
# of an item: a quarter of the frame. A pixel whose mask value crosses a
# threshold (the rigidity's 0.5, the census' THRESH) in one package and
# not in the other moves one count of each class: an IoU tp/(tp+fp+fn)
# by at most 2/(CLASS_PIXELS - EDGE_PIXELS) for EDGE_PIXELS such pixels
CLASS_PIXELS = (H // 2) * (W // 2)
IOU_TOL = 2 * EDGE_PIXELS / (CLASS_PIXELS - EDGE_PIXELS)
# the submission's flows: the nets agree to EPE_RTOL of the largest flow;
# the 16-bit PNG truncates to 1/64 px
PNG_STEP = 1 / 64
# test_mask's census threshold, on the flows' difference normalized by its
# largest: at the default 0.94 the census of the drawn nets' flows marks
# no pixel of this tree static, at this one some (none of the static car)
CENSUS_THRESH = 0.6


def test_mask_error_equals_cc_tpu():
    """The counts on seeded maps, of masks at the GT's size and at half of
    it (nearest resize), and the IoUs of the counts."""
    r = np.random.RandomState(51)
    mot = r.randint(0, 3, (H, W))
    seg = np.where(r.rand(H, W) > 0.4, 26, 7)
    for hw in ((H, W), (H // 2, W // 2)):
        pred = (r.rand(*hw) > 0.5).astype(np.float32)
        mine = tmask.mask_error(mot, seg, pred)
        ref = jmask.mask_error(mot, seg, pred)
        assert mine == ref and sum(ref) > 0
        assert tmask._iou(mine) == jmask._iou(ref)


def test_mask_cli_matches_cc_tpu(ckpts, kitti2015_dir):  # noqa: F811
    """Full model, census only and bare M: mean, static and moving IoU on
    2 items at 64x128, each within IOU_TOL."""
    argv = ["--kitti-dir", str(kitti2015_dir), *four_nets(ckpts),
            "--img-height", str(H), "--img-width", str(W), "-N", "2",
            "--THRESH", str(CENSUS_THRESH)]
    ref = jmask.main(argv)
    tcorr.launches = 0
    mine = tmask.main(argv + ["--device", "cpu"])
    assert tcorr.launches == 0  # the plain correlation on the CPU
    print(f"test_mask: port {mine} cc_tpu {ref}")
    assert mine.keys() == ref.keys() == {"Full Model", "Census only",
                                         "Bare"}
    assert 0 < min(ref["Full Model"][1:]) and 0 < min(ref["Bare"][1:])
    for title, e in ref.items():
        assert np.all(np.isfinite(e)), title
        np.testing.assert_allclose(mine[title], e, rtol=0, atol=IOU_TOL,
                                   err_msg=title)


def test_submit_flow_matches_cc_tpu(ckpts, kitti2015_dir,  # noqa: F811
                                    tmp_path):
    """The testing split's 2 items, run at 64x64 and resized back to the
    frames' 64x128 (torch's fp32 resize differs from cc_tpu's by up to
    2e-5 of the range, under EPE_RTOL): each .flo within EPE_RTOL of the
    largest flow and each decoded PNG within that plus PNG_STEP, but for
    at most EDGE_PIXELS pixels (the composite's rigid and non-rigid
    branches, picked by thresholds)."""
    argv = [str(ckpts), "--kitti-dir", str(kitti2015_dir), "--img-height",
            str(H), "--img-width", str(W // 2), "-N", "2"]
    jsubmit.main(argv + ["--output-dir", str(tmp_path / "ref")])
    tcorr.launches = 0
    tsubmit.main(argv + ["--output-dir", str(tmp_path / "mine"),
                         "--device", "cpu"])
    assert tcorr.launches == 0
    for sub, read in (("testing", lambda p: np.stack(
            flow_read_png(p)[:2], -1)), ("testing_flo", flow_read_flo)):
        files = sorted(os.listdir(tmp_path / "ref" / sub))
        assert files == sorted(os.listdir(tmp_path / "mine" / sub))
        assert len(files) == 2
        for fn in files:
            a = read(str(tmp_path / "mine" / sub / fn))
            e = read(str(tmp_path / "ref" / sub / fn))
            assert a.shape == e.shape == (H, W, 2), fn
            tol = EPE_RTOL * np.abs(e).max() + (PNG_STEP if sub == "testing"
                                                else 0.0)
            off = (np.abs(a - e) > tol).any(-1).sum()
            print(sub, fn, "max |port - cc_tpu|", np.abs(a - e).max(),
                  "pixels over", tol, off)
            assert off <= EDGE_PIXELS, (sub, fn, off)


@pytest.mark.parametrize("cli,argv", [
    (tmask, ["--kitti-dir", "kitti", "--pretrained-disp", "d",
             "--pretrained-pose", "p", "--pretrained-mask", "m",
             "--pretrained-flow", "f"]),
    (tsubmit, ["ckpts", "--kitti-dir", "kitti", "--output-dir", "out"]),
])
def test_mask_and_submit_default_to_cuda(cli, argv, tmp_path, monkeypatch):
    """--device defaults to cuda; without a GPU the CLI raises before it
    reads a file (here, checkpoints that do not exist) or writes one."""
    monkeypatch.chdir(tmp_path)
    assert cli.parser.parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []
