"""Row gather: out[i, j] = img[idx[i, j], j], and 0 where the index is
outside [0, R).

The port-side counterpart of experiment E5 of scripts/exp_gather.py, a
select loop over the table's rows written as a Pallas TPU kernel (:162-179).
`row_gather` runs the CUDA kernel (csrc/row_gather.cu) for tensors on the
GPU and the plain PyTorch version for tensors on the CPU; it never falls
back from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel; row_gather_cuda adds one per launch.
launches = 0

_MAX_ROWS = 65535  # the index rows go on the grid's y dimension


def row_gather_plain(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: torch.gather on clamped indices, zeroed where
    the index is out of range. img [R, W] float, idx [N, W] integer."""
    rows = img.shape[0]
    valid = (idx >= 0) & (idx < rows)
    taken = torch.gather(img, 0, idx.clamp(0, rows - 1).long())
    return torch.where(valid, taken, torch.zeros((), dtype=img.dtype,
                                                 device=img.device))


def row_gather_cuda(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream of img's device."""
    global launches
    if img.device.type != "cuda" or idx.device != img.device:
        raise ValueError(f"row gather kernel needs both inputs on one CUDA "
                         f"device, got {img.device} and {idx.device}")
    if img.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"row gather kernel takes a float32 table and int32 "
                        f"indices, got {img.dtype} and {idx.dtype}")
    if img.dim() != 2 or idx.dim() != 2 or idx.shape[1] != img.shape[1]:
        raise ValueError(f"row gather needs img [R, W] and idx [N, W], got "
                         f"{tuple(img.shape)} and {tuple(idx.shape)}")
    if not (img.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row gather kernel needs contiguous inputs")
    if idx.shape[0] > _MAX_ROWS:
        raise ValueError(f"row gather takes at most {_MAX_ROWS} index rows, "
                         f"got {idx.shape[0]}")
    out = torch.empty(idx.shape, device=img.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    from cc_tpu_torch.ops import _build
    fn = _build.load("row_gather").cc_row_gather
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = fn(img.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 img.shape[0], idx.shape[0], img.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"row gather kernel launch failed: cudaError {err}")
    launches += 1
    return out


def row_gather(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, j] = img[idx[i, j], j], 0 for an index outside [0, R)."""
    if img.device.type == "cpu" and idx.device.type == "cpu":
        return row_gather_plain(img, idx)
    return row_gather_cuda(img, idx)
