"""Native data-plane pipeline specs: Python draws the (seed-deterministic)
augmentation parameters, C++ (cc_tpu_torch.native) does the pixel work.

The parameter-draw sequence consumes the numpy Generator EXACTLY like the
pure-Python Compose in cc_tpu_torch/data/transforms.py, so for a given
(seed, epoch, index) the two paths produce identical samples (same cv2
ops, same parameters; see tests/test_torch_data.py).

A copy of cc_tpu/data/native_pipeline.py (the port imports nothing of cc_tpu);
tests/test_torch_data.py holds the two to equal bits.
"""
from __future__ import annotations

import ctypes

import numpy as np

from cc_tpu_torch.native import DpAug


_LIB_UNSET = object()


class _NativePipelineBase:
    """Shared native-dispatch plumbing: the library handle is resolved ONCE
    per pipeline (native.lib() takes a global lock on every call — not
    something to pay per sample from loader worker threads)."""

    _lib = _LIB_UNSET

    def process(self, paths, rng, in_h: int, in_w: int, intrinsics):
        """Full native decode+augment for one joint sample, or None when
        the native plane is unavailable (caller uses .fallback)."""
        if self._lib is _LIB_UNSET:
            from cc_tpu_torch import native
            self._lib = native.lib()
        if self._lib is None:
            return None
        aug, k = self.draw(rng, in_h, in_w, intrinsics)
        # The aug parameters (flip cx, scale-crop rect) and the output
        # allocation were both computed from (in_h, in_w) — have the C++
        # side verify the decoded image really has those dims.
        aug.in_h, aug.in_w = in_h, in_w
        imgs = process_sample(self._lib, paths, aug,
                              *self.out_hw(in_h, in_w))
        return imgs, k


class NativeTrainPipeline(_NativePipelineBase):
    """Spec equivalent of transforms.train_transform(normalize, with_rotation).

    emit='uint8' is the compact-H2D mode (see transforms.QuantizeU8): the
    C++ plane runs in raw-emit mode (0..255 floats, no /255) and the
    augmented pixels are rounded to uint8 here — the same single rint as
    the Python QuantizeU8 path, so rounding adds no divergence (any
    residual delta vs Python is the documented resize-interpolation
    library difference, see dataplane.cpp) — for 4x less host->device
    traffic; the (x/255-mean)/std normalization runs on device."""

    def __init__(self, normalize: str = "global", with_rotation: bool = True,
                 emit: str = "float32"):
        self.normalize = normalize
        self.with_rotation = with_rotation
        self.emit = emit
        if emit == "uint8" and normalize == "local":
            raise ValueError("emit='uint8' requires global normalization")
        from cc_tpu_torch.data import transforms
        self.fallback = transforms.train_transform(normalize, with_rotation,
                                                   emit)

    def process(self, paths, rng, in_h, in_w, intrinsics):
        result = super().process(paths, rng, in_h, in_w, intrinsics)
        if result is None or self.emit != "uint8":
            return result
        imgs, k = result  # raw-emit output is 0..255 floats
        return np.clip(np.rint(imgs), 0, 255).astype(np.uint8), k

    def draw(self, rng: np.random.Generator, in_h: int, in_w: int,
             intrinsics: np.ndarray):
        """Consume rng like the Compose does; return (DpAug, new_K)."""
        aug = DpAug()
        k = np.copy(intrinsics)
        if self.with_rotation:  # RandomRotate (K untouched)
            if rng.random() <= 0.5:
                aug.apply_rot = 1
                aug.rot_deg = float(rng.uniform(0, 10))
        if rng.random() < 0.5:  # RandomHorizontalFlip
            aug.apply_flip = 1
            k[0, 2] = in_w - k[0, 2]
        xs, ys = rng.uniform(1, 1.1, 2)  # RandomScaleCrop
        scaled_h, scaled_w = int(in_h * ys), int(in_w * xs)
        k[0] *= xs
        k[1] *= ys
        off_y = int(rng.integers(0, scaled_h - in_h + 1))
        off_x = int(rng.integers(0, scaled_w - in_w + 1))
        k[0, 2] -= off_x
        k[1, 2] -= off_y
        aug.scaled_h, aug.scaled_w = scaled_h, scaled_w
        aug.crop_x, aug.crop_y = off_x, off_y
        aug.out_h, aug.out_w = in_h, in_w
        if self.emit == "uint8":
            aug.normalize = -1  # device normalizes; C++ emits raw 0..255
        else:
            aug.normalize = 2 if self.normalize == "local" else 1
        aug.mean, aug.std = 0.5, 0.5
        return aug, k.astype(np.float32)

    def out_hw(self, in_h: int, in_w: int):
        return in_h, in_w


class NativeValidPipeline(_NativePipelineBase):
    """Spec equivalent of transforms.valid_flow_transform(h, w) /
    valid_transform (h=w=0 -> no resize)."""

    def __init__(self, h: int = 0, w: int = 0, normalize: str = "global"):
        self.h, self.w = h, w
        self.normalize = normalize
        from cc_tpu_torch.data import transforms
        self.fallback = (transforms.valid_flow_transform(h, w, normalize)
                         if h else transforms.valid_transform(normalize))

    def draw(self, rng, in_h: int, in_w: int, intrinsics):
        aug = DpAug()
        k = np.copy(intrinsics) if intrinsics is not None else None
        if self.h:
            aug.resize_h, aug.resize_w = self.h, self.w
            if k is not None:
                k[0] *= self.w / in_w
                k[1] *= self.h / in_h
        aug.normalize = 2 if self.normalize == "local" else 1
        aug.mean, aug.std = 0.5, 0.5
        return aug, None if k is None else k.astype(np.float32)

    def out_hw(self, in_h: int, in_w: int):
        return (self.h, self.w) if self.h else (in_h, in_w)


def process_sample(lib, paths: list[str], aug: DpAug, out_h: int,
                   out_w: int) -> np.ndarray:
    """Run the C++ decode+augment for a joint image list.

    Returns [n, out_h, out_w, 3] float32. Raises FileNotFoundError on a
    missing/undecodable path (mirrors load_image)."""
    blob = b"".join(p.encode() + b"\0" for p in paths)
    out = np.empty((len(paths), out_h, out_w, 3), np.float32)
    # The C++ plane refuses to write unless its final dims equal these —
    # a stale per-scene dim cache can therefore never corrupt the heap.
    aug.expect_h, aug.expect_w = out_h, out_w
    rc = lib.dp_process_sample(
        blob, len(paths), ctypes.byref(aug),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc == 0:
        return out
    if -len(paths) <= rc <= -1:  # decode failure at image -rc-1
        raise FileNotFoundError(
            f"native decode failed (rc={rc}) for {paths[-rc - 1]}")
    if -1000 - len(paths) <= rc <= -1001:  # dimension mismatch at -(rc+1000)
        raise ValueError(
            f"native pipeline: image {paths[-(rc + 1000)]} has "
            f"different dimensions than {paths[0]}")
    if rc == -2000:
        raise ValueError(
            f"native pipeline: {paths[0]} decoded with dims different from "
            f"the expected ({aug.in_h}, {aug.in_w}) — image sizes must be "
            f"uniform per scene directory (ETL invariant; the dim cache "
            f"probes one file per directory)")
    if rc == -2001:
        raise ValueError(
            f"native pipeline: output dims differ from the allocated "
            f"({out_h}, {out_w}) for {paths}")
    raise RuntimeError(f"native pipeline failed (rc={rc}) for {paths}")


LOADERS = ("auto", "python", "native")


def train_pipeline(normalize: str = "global", with_rotation: bool = True,
                   emit: str = "float32", loader: str = "auto"):
    """The train transform for `loader`, the train CLI's --loader: "native"
    is the C++ plane and raises when it does not build; "python" the
    Compose of transforms.train_transform; "auto" the C++ plane when it
    builds, else the Python one. Returns (transform, "native" | "python"),
    the plane that runs."""
    if loader not in LOADERS:
        raise ValueError(f"loader must be one of {LOADERS}, not {loader!r}")
    pipe = NativeTrainPipeline(normalize, with_rotation, emit)
    if loader == "python":
        return pipe.fallback, "python"
    from cc_tpu_torch import native
    if native.lib() is not None:
        return pipe, "native"
    if loader == "native":
        raise RuntimeError("loader='native' asked for, but the C++ data plane "
                           "does not build here (g++ and OpenCV's headers "
                           "are needed)")
    return pipe.fallback, "python"
