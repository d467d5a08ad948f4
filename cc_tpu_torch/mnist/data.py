"""MNIST (IDX) and SVHN (.mat) loaders without torchvision: a copy of
cc_tpu/mnist/data.py (numpy; the train step converts to NCHW).

MNIST: standard idx files under <root>/mnist/MNIST/raw/ (or <root>/mnist/).
Normalization (0.1307, 0.3081) like the reference (mnist.py:146-147).
SVHN: <root>/svhn/{train,test}_32x32.mat, resized to 28x28 grayscale in
[0, 1] (mnist.py:151-153). Returns NHWC [N, 28, 28, 1] float32 + int labels.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np


def _open(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _find(root, name):
    for sub in ("", "MNIST/raw", "raw"):
        p = os.path.join(root, sub, name)
        if os.path.exists(p) or os.path.exists(p + ".gz"):
            return p
    raise FileNotFoundError(f"{name} not under {root}")


def load_mnist(root: str, train: bool = True):
    prefix = "train" if train else "t10k"
    with _open(_find(root, f"{prefix}-images-idx3-ubyte")) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{f.name}: not an IDX image file")
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols, 1)
    with _open(_find(root, f"{prefix}-labels-idx1-ubyte")) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{f.name}: not an IDX label file")
        labels = np.frombuffer(f.read(), np.uint8).astype(np.int32)
    images = images.astype(np.float32) / 255.0
    images = (images - 0.1307) / 0.3081
    return images, labels


def load_svhn(root: str, train: bool = True):
    """SVHN .mat -> [N, 28, 28, 1] float32 in [0, 1].

    Matches the reference's torchvision pipeline exactly (mnist.py:151-153:
    Resize(28) -> Grayscale -> ToTensor, which are PIL ops in that order:
    antialiased bilinear resize, then ITU-R 601-2 luma). Falls back to cv2
    (grayscale + non-antialiased resize, ~1-2 gray-level deltas) if PIL is
    unavailable.
    """
    from scipy.io import loadmat
    split = "train" if train else "test"
    mat = loadmat(os.path.join(root, f"{split}_32x32.mat"))
    x = mat["X"]  # [32, 32, 3, N]
    y = mat["y"].flatten().astype(np.int32)
    y[y == 10] = 0
    n = x.shape[-1]
    out = np.zeros((n, 28, 28, 1), np.float32)
    try:
        from PIL import Image
        for i in range(n):
            im = Image.fromarray(x[..., i], "RGB")
            im = im.resize((28, 28), Image.BILINEAR).convert("L")
            out[i, ..., 0] = np.asarray(im, np.float32) / 255.0
    except ImportError:
        import cv2
        for i in range(n):
            g = cv2.cvtColor(x[..., i], cv2.COLOR_RGB2GRAY)
            out[i, ..., 0] = cv2.resize(g, (28, 28)) / 255.0
    return out, y


def iterate_batches(images, labels, batch_size, shuffle=True, seed=0,
                    drop_last=True):
    n = len(images)
    order = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    end = n - n % batch_size if drop_last else n
    for i in range(0, end, batch_size):
        idx = order[i:i + batch_size]
        yield images[idx], labels[idx]
