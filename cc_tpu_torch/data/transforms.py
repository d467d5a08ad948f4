"""Joint image-list + intrinsics transforms (parity: custom_transforms.py).

The invariant (SURVEY.md §2.4): every geometric transform updates the
intrinsics consistently. Differences from the reference, by design:
- numpy HWC float32 throughout (no uint8 round-trips through PIL; the
  reference's scipy.misc.imresize quantized to uint8 internally);
- explicit np.random.Generator threading instead of global RNG state, so
  the threaded loader is deterministic per seed and race-free.

Pipelines (train.py:165-190):
  train (flownet training): [RandomRotate, RandomHorizontalFlip,
                             RandomScaleCrop, ToFloat, Normalize]
  train (flownet frozen):   [RandomHorizontalFlip, RandomScaleCrop,
                             ToFloat, Normalize]
  valid:                    [ToFloat, Normalize]
  valid flow:               [Scale(256, 832), ToFloat, Normalize]

A copy of cc_tpu/data/transforms.py (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal bits.
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
    cv2.setNumThreads(0)  # we parallelize at the sample level
except ImportError:  # pragma: no cover
    cv2 = None


def _resize(im: np.ndarray, h: int, w: int) -> np.ndarray:
    if cv2 is not None:
        return cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)
    from PIL import Image
    return np.asarray(
        Image.fromarray(im.astype(np.uint8)).resize((w, h), Image.BILINEAR)
    ).astype(im.dtype)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, images, intrinsics, rng=None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            images, intrinsics = t(images, intrinsics, rng)
        return images, intrinsics


class ToFloat:
    """images / 255 as float32 (the ArrayToTensor scaling, HWC kept)."""

    def __call__(self, images, intrinsics, rng=None):
        return [np.asarray(im, np.float32) / 255.0 for im in images], intrinsics


class Normalize:
    def __init__(self, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, images, intrinsics, rng=None):
        return [(im - self.mean) / self.std for im in images], intrinsics


class QuantizeU8:
    """Round 0..255 float images to uint8 for the compact-H2D path: the
    host ships 1/4 the bytes and the (x/255 - mean)/std normalization runs
    on device (train/step.py _device_normalize). Augmented pixels are
    interpolated floats, so this rounds them to the nearest 1/255 — a
    documented numerics delta vs the float path (bounded by 0.5/255 per
    pixel, far below photometric noise); source pixels untouched by
    interpolation round back exactly."""

    def __call__(self, images, intrinsics, rng=None):
        return [np.clip(np.rint(im), 0, 255).astype(np.uint8)
                for im in images], intrinsics


def dequantize_u8(img: np.ndarray) -> np.ndarray:
    """Host-side (numpy) twin of train/step._device_normalize for uint8
    compact-H2D batches: (x/255 - .5)/.5. Single definition so host
    consumers (e.g. training image logging) can never drift from what the
    train step computes on the device."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


class NormalizeLocally:
    """Per-sample channel mean/std over the whole image list
    (custom_transforms.py:33-44)."""

    def __call__(self, images, intrinsics, rng=None):
        stack = np.stack(images)
        mean = stack.reshape(-1, stack.shape[-1]).mean(0)
        std = stack.reshape(-1, stack.shape[-1]).std(0, ddof=1)
        return [(im - mean) / std for im in images], intrinsics


class RandomHorizontalFlip:
    """p=0.5 flip with cx update (custom_transforms.py:60-73)."""

    def __call__(self, images, intrinsics, rng):
        assert intrinsics is not None
        if rng.random() < 0.5:
            out = [np.ascontiguousarray(np.fliplr(im)) for im in images]
            k = np.copy(intrinsics)
            k[0, 2] = out[0].shape[1] - k[0, 2]
            return out, k
        return images, intrinsics


class RandomRotate:
    """p=0.5 rotation up to 10 deg, same size, intrinsics untouched
    (custom_transforms.py:75-85 — the reference also leaves K unchanged)."""

    def __call__(self, images, intrinsics, rng):
        if rng.random() > 0.5:
            return images, intrinsics
        rot = rng.uniform(0, 10)
        h, w = images[0].shape[:2]
        if cv2 is None:  # pragma: no cover
            return images, intrinsics
        m = cv2.getRotationMatrix2D((w / 2, h / 2), rot, 1.0)
        return [cv2.warpAffine(im, m, (w, h)) for im in images], intrinsics


class RandomScaleCrop:
    """Zoom up to 10% then crop back, with fx/fy/cx/cy updates
    (custom_transforms.py:90-118)."""

    def __init__(self, h: int = 0, w: int = 0):
        self.h, self.w = h, w

    def __call__(self, images, intrinsics, rng):
        assert intrinsics is not None
        k = np.copy(intrinsics)
        in_h, in_w = images[0].shape[:2]
        x_scale, y_scale = rng.uniform(1, 1.1, 2)
        scaled_h, scaled_w = int(in_h * y_scale), int(in_w * x_scale)
        k[0] *= x_scale
        k[1] *= y_scale
        scaled = [_resize(im, scaled_h, scaled_w) for im in images]

        out_h, out_w = (self.h, self.w) if (self.h and self.w) else (in_h, in_w)
        off_y = rng.integers(0, scaled_h - out_h + 1)
        off_x = rng.integers(0, scaled_w - out_w + 1)
        cropped = [im[off_y:off_y + out_h, off_x:off_x + out_w]
                   for im in scaled]
        k[0, 2] -= off_x
        k[1, 2] -= off_y
        return cropped, k


class Scale:
    """Deterministic resize to (h, w) with intrinsics update
    (custom_transforms.py:120-137)."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def __call__(self, images, intrinsics, rng=None):
        assert intrinsics is not None
        k = np.copy(intrinsics)
        in_h, in_w = images[0].shape[:2]
        k[0] *= self.w / in_w
        k[1] *= self.h / in_h
        return [_resize(im, self.h, self.w) for im in images], k


def train_transform(normalize: str = "global", with_rotation: bool = True,
                    emit: str = "float32"):
    """emit='uint8' ships un-normalized uint8 (compact-H2D mode: 4x less
    host->device traffic; normalization happens on the device). Only valid
    with global normalization — local stats are a host-side joint
    reduction over the sample."""
    ts = []
    if with_rotation:
        ts.append(RandomRotate())
    ts += [RandomHorizontalFlip(), RandomScaleCrop()]
    if emit == "uint8":
        if normalize == "local":
            raise ValueError("emit='uint8' requires global normalization")
        ts.append(QuantizeU8())
        return Compose(ts)
    ts.append(ToFloat())
    ts.append(NormalizeLocally() if normalize == "local" else Normalize())
    return Compose(ts)


def valid_transform(normalize: str = "global"):
    return Compose([ToFloat(),
                    NormalizeLocally() if normalize == "local" else Normalize()])


def valid_flow_transform(h: int = 256, w: int = 832,
                         normalize: str = "global"):
    return Compose([Scale(h, w), ToFloat(),
                    NormalizeLocally() if normalize == "local" else Normalize()])
