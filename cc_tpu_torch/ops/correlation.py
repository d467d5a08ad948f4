"""Local correlation cost volume, NHWC: [B,H,W,C] x2 -> [B,H,W,P*P].

  out[b, h, w, pi*P + pj] = mean_c f1[b, h, w, c] * f2[b, h+dy, w+dx, c]
  with dy = (pi - P//2) * dilation, dx = (pj - P//2) * dilation,
  out-of-bounds f2 taps read as 0.

Counterpart of cc_tpu/ops/correlation.py and of the Pallas kernel's
custom_vjp (cc_tpu/ops/correlation_pallas.py). `correlation` runs, for
tensors on the GPU, a torch.autograd.Function whose forward and backward are
the CUDA kernels of csrc/correlation.cu; for tensors on the CPU, the plain
PyTorch version, through autograd. It never falls back from one to the
other. The backward is

  df1[p, c] = (1/C) sum_d g[p, d] f2[p + dvec(d), c]
  df2[q, c] = (1/C) sum_d g[q - dvec(d), d] f1[q - dvec(d), c]

with dvec(d) = (dy, dx) of displacement d, terms outside the image 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

# Launches of the CUDA kernels: correlation_cuda adds one to `launches`
# per forward launch, correlation_backward_cuda one to `backward_launches`
# per backward launch.
launches = 0
backward_launches = 0

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


def correlation_backward_plain(f1: torch.Tensor, f2: torch.Tensor,
                               g: torch.Tensor, patch_size: int,
                               dilation: int = 1):
    """Plain PyTorch version of the backward: (df1, df2) for the output
    gradient g [B,H,W,P*P], by cc_tpu's shifted windows
    (correlation_pallas.py:112-138). Padding g and f1 by r turns the
    transpose into shifted windows too."""
    b, h, w, c = f1.shape
    r = (patch_size // 2) * dilation
    inv_c = 1.0 / c
    pad = (0, 0, r, r, r, r)
    f2p, f1p, gp = F.pad(f2, pad), F.pad(f1, pad), F.pad(g, pad)
    df1 = torch.zeros_like(f1)
    df2 = torch.zeros_like(f2)
    for pi in range(patch_size):
        for pj in range(patch_size):
            oy, ox = pi * dilation, pj * dilation
            ch = pi * patch_size + pj
            df1 = df1 + (g[..., ch:ch + 1]
                         * f2p[:, oy:oy + h, ox:ox + w, :]) * inv_c
            iy, ix = 2 * r - oy, 2 * r - ox
            df2 = df2 + (gp[:, iy:iy + h, ix:ix + w, ch:ch + 1]
                         * f1p[:, iy:iy + h, ix:ix + w, :]) * inv_c
    return df1, df2


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, patch_size: int,
                     dilation: int = 1) -> torch.Tensor:
    """Launch the forward kernel on the current stream of f1's device. No
    autograd here: `correlation` is the differentiable entry."""
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
        err = fn(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c,
                 patch_size, dilation, _stream(f1))
    if err != 0:
        raise RuntimeError(f"correlation kernel launch failed: cudaError {err}")
    launches += 1
    return out


def correlation_backward_cuda(f1: torch.Tensor, f2: torch.Tensor,
                              g: torch.Tensor, patch_size: int,
                              dilation: int = 1):
    """Launch the backward kernel (df1 and df2 in one launch, gathers only:
    deterministic) on the current stream of f1's device. g must be
    contiguous NHWC [B,H,W,P*P]."""
    global backward_launches
    _check(f1, f2, patch_size, dilation)
    b, h, w, c = f1.shape
    if (g.device != f1.device or g.dtype != torch.float32
            or tuple(g.shape) != (b, h, w, patch_size * patch_size)
            or not g.is_contiguous()):
        raise ValueError(f"correlation backward needs a contiguous float32 "
                         f"gradient [B,H,W,P*P] on {f1.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    df1 = torch.empty_like(f1)
    df2 = torch.empty_like(f2)
    if f1.numel() == 0:
        return df1, df2
    from cc_tpu_torch.ops import _build
    fn = _build.load("correlation").cc_correlation_backward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    with torch.cuda.device(f1.device):
        err = fn(f1.data_ptr(), f2.data_ptr(), g.data_ptr(), df1.data_ptr(),
                 df2.data_ptr(), b, h, w, c, patch_size, dilation, _stream(f1))
    if err != 0:
        raise RuntimeError(f"correlation backward kernel launch failed: "
                           f"cudaError {err}")
    backward_launches += 1
    return df1, df2


class _Correlation(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, f1, f2, patch_size, dilation):
        ctx.save_for_backward(f1, f2)
        ctx.patch_size, ctx.dilation = patch_size, dilation
        return correlation_cuda(f1, f2, patch_size, dilation)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        # Back2Future reorders, concatenates and permutes the cost volume,
        # so its gradient arrives in any layout
        df1, df2 = correlation_backward_cuda(f1, f2, g.contiguous(),
                                             ctx.patch_size, ctx.dilation)
        return df1, df2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, patch_size: int,
                dilation: int = 1) -> torch.Tensor:
    """Local correlation of f1 against displaced f2 (see module docstring),
    differentiable in both inputs."""
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation_plain(f1, f2, patch_size, dilation)
    return _Correlation.apply(f1, f2, patch_size, dilation)


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
