"""Native (C++) data plane: build-on-first-use + ctypes bindings.

`lib()` returns the loaded shared library, compiling dataplane.cpp with g++
against the system OpenCV on first use (cached under _build/). Returns None
— and every caller falls back to the pure-Python pipeline — if no compiler
or OpenCV dev headers are present.

A copy of cc_tpu/native/__init__.py (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal bits.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
# beside the CUDA kernels' libraries (ops/_build.py)
_SO = os.path.join(os.path.dirname(_HERE), "_build", "libccdataplane.so")
_lock = threading.Lock()
_lib = None
_tried = False


class DpAug(ctypes.Structure):
    _fields_ = [
        ("apply_rot", ctypes.c_int),
        ("rot_deg", ctypes.c_double),
        ("apply_flip", ctypes.c_int),
        ("scaled_h", ctypes.c_int),
        ("scaled_w", ctypes.c_int),
        ("crop_x", ctypes.c_int),
        ("crop_y", ctypes.c_int),
        ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int),
        ("resize_h", ctypes.c_int),
        ("resize_w", ctypes.c_int),
        ("normalize", ctypes.c_int),
        ("mean", ctypes.c_float),
        ("std", ctypes.c_float),
        ("in_h", ctypes.c_int),      # expected decode dims (0 = unchecked)
        ("in_w", ctypes.c_int),
        ("expect_h", ctypes.c_int),  # caller-allocated output buffer dims
        ("expect_w", ctypes.c_int),  # (0 = unchecked)
    ]


_ABI_VERSION = 4  # must match dp_version() in dataplane.cpp


def _pkg_flags() -> list[str]:
    try:
        out = subprocess.run(
            ["pkg-config", "--cflags", "--libs", "opencv4"],
            capture_output=True, text=True, check=True).stdout.split()
        return out
    except (OSError, subprocess.CalledProcessError):
        return ["-I/usr/include/opencv4", "-lopencv_core",
                "-lopencv_imgproc", "-lopencv_imgcodecs"]


def build() -> str | None:
    """Compile the data plane; returns the .so path or None."""
    src = os.path.join(_HERE, "dataplane.cpp")
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(src)):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    # Compile to a per-process temp path and os.replace() into place
    # (atomic on one filesystem) so a concurrent builder in another
    # process can never CDLL a half-written binary (ADVICE r2).
    tmp = f"{_SO}.tmp.{os.getpid()}"
    cmd = (["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
           + _pkg_flags() + ["-lpthread"])
    try:
        subprocess.run(cmd, capture_output=True, text=True, check=True)
        os.replace(tmp, _SO)
    except (OSError, subprocess.CalledProcessError) as e:
        err = getattr(e, "stderr", str(e))
        print(f"cc_tpu_torch.native: data-plane build failed "
              f"(falling back to Python pipeline): {err[:500]}")
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None
    return _SO


def lib():
    """Load (building if needed) the native data plane, or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = build()
        if so is None:
            return None

        def _load(path):
            l = ctypes.CDLL(path)
            if l.dp_version() != _ABI_VERSION:
                raise OSError(
                    f"dp_version {l.dp_version()} != {_ABI_VERSION}")
            return l

        try:
            l = _load(so)
        except (OSError, AttributeError):
            # a stale/foreign-ABI binary (different OpenCV soname, an old
            # dp_aug struct layout, or a foreign .so with no dp_version
            # export at all — ctypes raises AttributeError for that):
            # rebuild from source once, then honor the fallback contract
            try:
                os.remove(so)
            except OSError:
                pass
            so = build()
            if so is None:
                return None
            try:
                l = _load(so)
            except (OSError, AttributeError) as e2:
                print(f"cc_tpu_torch.native: data plane unloadable "
                      f"(falling back to Python pipeline): {e2}")
                return None
        l.dp_process_sample.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(DpAug),
            ctypes.POINTER(ctypes.c_float)]
        l.dp_process_sample.restype = ctypes.c_int
        l.dp_pool_create.argtypes = [ctypes.c_int]
        l.dp_pool_create.restype = ctypes.c_void_p
        l.dp_pool_destroy.argtypes = [ctypes.c_void_p]
        l.dp_pool_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(DpAug), ctypes.POINTER(ctypes.c_float)]
        l.dp_pool_submit.restype = ctypes.c_int
        l.dp_pool_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
        l.dp_pool_wait.restype = ctypes.c_int
        _lib = l
        return _lib
