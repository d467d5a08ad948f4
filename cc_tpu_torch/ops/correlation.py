"""Local correlation cost volume, NHWC: [B,H,W,C] x2 -> [B,H,W,P*P].

  out[b, h, w, pi*P + pj] = mean_c f1[b, h, w, c] * f2[b, h+dy, w+dx, c]
  with dy = (pi - P//2) * dilation, dx = (pj - P//2) * dilation,
  out-of-bounds f2 taps read as 0.

Counterpart of cc_tpu/ops/correlation.py. `correlation` runs the CUDA kernel
(csrc/correlation.cu) for tensors on the GPU and the plain PyTorch version
for tensors on the CPU; it never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

# Launches of the CUDA kernel; correlation_cuda adds one per launch.
launches = 0

_MAX_PATCH = 21  # the kernel is instantiated for every odd patch up to this


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, patch_size: int,
                      dilation: int = 1) -> torch.Tensor:
    """Plain PyTorch version (mirrors correlation_xla); differentiable."""
    b, h, w, c = f1.shape
    r = (patch_size // 2) * dilation
    f2p = F.pad(f2, (0, 0, r, r, r, r))
    inv_c = 1.0 / c
    outs = []
    for pi in range(patch_size):
        for pj in range(patch_size):
            oy, ox = pi * dilation, pj * dilation
            shifted = f2p[:, oy:oy + h, ox:ox + w, :]
            outs.append(torch.sum(f1 * shifted, dim=-1) * inv_c)
    return torch.stack(outs, dim=-1)


def _check(f1: torch.Tensor, f2: torch.Tensor, patch_size: int,
           dilation: int) -> None:
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(f"correlation kernel needs both inputs on one CUDA "
                         f"device, got {f1.device} and {f2.device}")
    if f1.dtype != torch.float32 or f2.dtype != torch.float32:
        raise TypeError(f"correlation kernel takes float32 only, got "
                        f"{f1.dtype} and {f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"correlation needs two [B,H,W,C] tensors of one "
                         f"shape, got {tuple(f1.shape)} and {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation kernel needs contiguous NHWC inputs")
    if patch_size % 2 != 1 or not 1 <= patch_size <= _MAX_PATCH:
        raise ValueError(f"patch_size must be odd and at most {_MAX_PATCH}, "
                         f"got {patch_size}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise RuntimeError("the correlation kernel has no backward yet; call "
                           "it under torch.no_grad() or inference_mode()")


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, patch_size: int,
                     dilation: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of f1's device."""
    global launches
    _check(f1, f2, patch_size, dilation)
    b, h, w, c = f1.shape
    out = torch.empty((b, h, w, patch_size * patch_size), device=f1.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    from cc_tpu_torch.ops import _build
    fn = _build.load("correlation").cc_correlation_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c,
                 patch_size, dilation, stream)
    if err != 0:
        raise RuntimeError(f"correlation kernel launch failed: cudaError {err}")
    launches += 1
    return out


def correlation(f1: torch.Tensor, f2: torch.Tensor, patch_size: int,
                dilation: int = 1) -> torch.Tensor:
    """Local correlation of f1 against displaced f2 (see module docstring)."""
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_plain(f1, f2, patch_size, dilation)
    return correlation_cuda(f1, f2, patch_size, dilation)


def b2f_channel_permutations(patch_size: int = 9) -> tuple[np.ndarray, np.ndarray]:
    """Back2Future's fwd/bwd correlation channel reorders.

    Parity with the idx_fwd/idx_bwd LongTensors of the reference's
    back2future.py:56-59. fwd: transpose + flip both axes of the (pi, pj)
    displacement grid; bwd: transpose only.
    """
    n = patch_size * patch_size
    idx = np.array(
        [list(range(k, -1, -patch_size)) for k in range(n - 1, n - 1 - patch_size, -1)]
    ).flatten()
    return idx, idx[::-1].copy()
