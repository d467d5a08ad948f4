"""Optical-flow file I/O: KITTI 16-bit png codec, Middlebury .flo, PFM.

Parity: flowutils/flow_io.py (u = (u16 - 2^15)/64, TAG_FLOAT 202021.25) and
flowutils/pfm.py. Uses cv2 for 16-bit png (pypng is not in this image).

A copy of cc_tpu/utils/flow_io.py (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal bits.
"""
from __future__ import annotations

import re

import numpy as np

TAG_FLOAT = 202021.25


def flow_read_png(path: str):
    """KITTI flow png -> (u, v, valid); u = (u16 - 2^15) / 64."""
    import cv2
    raw = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(path)
    assert raw.dtype == np.uint16 and raw.ndim == 3, "not a 16-bit flow png"
    bgr = raw  # cv2 loads channels reversed: (valid, v, u)
    u16, v16, valid = bgr[..., 2], bgr[..., 1], bgr[..., 0]
    u = (u16.astype(np.float64) - 2 ** 15) / 64.0
    v = (v16.astype(np.float64) - 2 ** 15) / 64.0
    return u, v, valid


def flow_write_png(path: str, u: np.ndarray, v: np.ndarray, valid=None):
    import cv2
    if valid is None:
        valid = np.ones(u.shape, dtype=np.uint16)
    u16 = (u.astype(np.float64) * 64.0 + 2 ** 15).astype(np.uint16)
    v16 = (v.astype(np.float64) * 64.0 + 2 ** 15).astype(np.uint16)
    bgr = np.dstack((valid.astype(np.uint16), v16, u16))
    cv2.imwrite(str(path), bgr)


def flow_read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> [H, W, 2] float32."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        assert abs(tag - TAG_FLOAT) < 1e-3, f"bad .flo tag in {path}"
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def flow_write_flo(path: str, flow: np.ndarray):
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([TAG_FLOAT], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow[..., :2].astype(np.float32).tofile(f)


def flow_read(path: str) -> np.ndarray:
    """Dispatch by extension like flowutils/flowlib.py:37-52; returns
    [H, W, 2 or 3]."""
    p = str(path)
    if p.endswith(".flo"):
        return flow_read_flo(p)
    if p.endswith(".png"):
        u, v, valid = flow_read_png(p)
        return np.dstack((u, v, valid)).astype(np.float32)
    if p.endswith(".pfm"):
        return pfm_read(p)[0][..., :2]
    raise ValueError(f"unknown flow format: {p}")


def pfm_read(path: str):
    """PFM -> (data, scale). Parity: flowutils/pfm.py."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.reshape(data, shape)[::-1], scale


def pfm_write(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.flipud(image).astype(np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)
