"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library `<name>` of LIBRARIES, a source `csrc/<source>.cu` compiled
with its own flags, becomes `_build/lib<name>-<hash>.so`, a shared library
with a plain C interface, compiled for sm_90a at first use (the hash covers
the source and the flags, so an edited source is rebuilt). Builds of several
libraries run as parallel nvcc processes. A failed build raises: the port
never falls back to a kernel's plain version on the GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# library -> (source, its extra flags): the correlation kernels' float32 and
# bf16 instantiations compile as two libraries, in parallel
LIBRARIES = {"correlation": ("correlation", ()),
             "correlation_bf16": ("correlation", ("-DCC_CORRELATION_BF16",)),
             "row_gather": ("row_gather", ())}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _flags(name: str) -> tuple[str, ...]:
    return (*NVCC_FLAGS, *LIBRARIES[name][1])


def _lib_path(name: str) -> str:
    source = LIBRARIES[name][0]
    with open(os.path.join(CSRC, f"{source}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=tuple(LIBRARIES)) -> dict[str, str]:
    """Compile every named library that is not built yet, all in parallel.

    Returns {name: library path}. The compiler's report (registers, shared
    memory, spills) is kept beside each library as `<library>.log`.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    jobs = []
    for name, path in paths.items():
        if os.path.isfile(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_flags(name), "-o", tmp,
               os.path.join(CSRC, f"{LIBRARIES[name][0]}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in jobs:
        log, _ = proc.communicate()
        with open(path + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, path)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` of LIBRARIES, built first if need be."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build((name,))[name])
    return _loaded[name]
