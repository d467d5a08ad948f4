"""The port's eval forward against cc_tpu's build_forward_eval, key by key,
on the same weights and batch; the uint8 normalization; the device default;
and that cc_tpu_torch imports nothing of JAX or cc_tpu, nor orbax or
joblib, which the card's machine does not have."""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cc_tpu.train import build_forward_eval, init_state, make_models as jmake
from cc_tpu.train.step import _device_normalize as jnorm
import cc_tpu_torch
from cc_tpu_torch.train import TrainConfig, forward_eval, make_models
from cc_tpu_torch.train.step import _device_normalize as tnorm
from cc_tpu_torch.weights import load_flax_weights
from tests.test_train_step import synth_batch, tiny_config
from tests.torch_port_util import assert_close, draw_flax_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("disp", "depth", "pose", "exp_mask", "flow_fwd", "flow_bwd", "occ")
# fp32 convs summed in another order by XLA and oneDNN; relative to each
# output's largest magnitude
RTOL = 1e-4


def _port_config(jcfg):
    return TrainConfig(**{f: getattr(jcfg, f)
                          for f in TrainConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def jax_eval():
    """cc_tpu's eval forward on test_train_step's config. init_state gives
    the variables' structure (traced, not compiled); the values are drawn
    with numpy."""
    cfg = tiny_config()
    state = jax.eval_shape(lambda k: init_state(cfg, k), jax.random.PRNGKey(0))
    r = np.random.RandomState(3)
    params = draw_flax_variables(state.params, r)
    stats = draw_flax_variables(state.batch_stats, r)
    batch = {k: np.array(v) for k, v in synth_batch(cfg).items()}
    out = build_forward_eval(cfg, jmake(cfg))(params, stats, batch)
    return cfg, params, stats, batch, jax.device_get(out)


def test_config_fields_and_defaults_match():
    from cc_tpu.train.config import TrainConfig as JaxConfig
    import dataclasses
    mine = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert mine == ref


def test_forward_eval_matches_build_forward_eval(jax_eval):
    jcfg, params, stats, batch, ref = jax_eval
    cfg = _port_config(jcfg)
    nets = make_models(cfg, device="cpu")
    archs = {"disp": cfg.dispnet, "pose": cfg.posenet, "mask": cfg.masknet,
             "flow": cfg.flownet}
    for name, arch in archs.items():
        load_flax_weights(nets[name], arch, params[name], stats[name])
    out = forward_eval(cfg, nets, batch)
    assert set(out) == set(ref) == set(KEYS)
    for k in KEYS:
        e = np.asarray(ref[k])
        tol = RTOL * max(1.0, float(np.max(np.abs(e))))
        assert_close(out[k], e, tol, k)


def test_device_normalize_uint8_matches():
    x = np.random.RandomState(4).randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    ref = np.asarray(jnorm(jnp.asarray(x)))
    out = tnorm(torch.from_numpy(x))
    assert out.dtype == torch.float32
    assert_close(out, ref, 0.0, "uint8")
    f = torch.zeros(2, 3)
    assert tnorm(f) is f


def test_spatial_normalize_matches():
    from cc_tpu.losses.charbonnier import spatial_normalize as jsn
    from cc_tpu_torch.losses.charbonnier import spatial_normalize as tsn
    d = np.random.RandomState(5).uniform(0.01, 10.0, (3, 8, 6, 1)).astype(
        np.float32)
    assert_close(tsn(torch.from_numpy(d)), jsn(jnp.asarray(d)), 1e-6, "disp")


def test_entry_point_defaults_to_cuda():
    cfg = TrainConfig(height=128, width=128, batch_size=1)
    if torch.cuda.is_available():
        assert cc_tpu_torch.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_models(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cc_tpu_torch.resolve_device("cuda")
    assert cc_tpu_torch.resolve_device("cpu").type == "cpu"


_BLOCK_AND_IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "orbax", "joblib", "cc_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import cc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cc_tpu_torch.__path__,
                                               "cc_tpu_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_package_imports_without_jax_or_cc_tpu():
    res = subprocess.run([sys.executable, "-c", _BLOCK_AND_IMPORT_ALL],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.strip().splitlines()[-1])
    expected = [m.name for m in pkgutil.walk_packages(
        cc_tpu_torch.__path__, "cc_tpu_torch.")]
    assert n == len(expected) > 10


def test_package_sources_name_no_jax_or_cc_tpu():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|joblib|cc_tpu)"
        r"(\.|\s|$)", re.M)
    root = os.path.join(REPO, "cc_tpu_torch")
    hits = []
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path) as f:
                    hits += [f"{path}: {m.group(0).strip()}"
                             for m in pattern.finditer(f.read())]
    assert not hits, hits
