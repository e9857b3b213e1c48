"""Composable numpy image transforms: the JAX package's
``data/transforms.py``, whole (it imports no JAX; the port keeps its own
copy).

The reference builds ``transforms.Compose([transforms.ToTensor()])`` and
hands it to the dataset; torchvision applies it per sample inside the
loader workers.  This module gives the same composition surface with the
augmentations an ImageNet recipe needs (RandomResizedCrop /
RandomHorizontalFlip / Normalize), on numpy HWC arrays: the loader's NHWC
batch is the memory of the model's ``channels_last`` NCHW input, so no
transpose is made.

Determinism: random transforms draw from a ``numpy.random.Generator``
passed to ``__call__``; datasets derive it from (seed, epoch, index) so a
resumed epoch replays identical augmentations.

Each transform also exposes its *parameters* (``sample_params``) apart
from its application, so a batched native path (``csrc/fastbatch.cpp``
``fb_crop_resize_flip_normalize``, bound in ``data/native.py``) can draw
per-image parameters in Python and run a whole batch's
crop+resize+flip+normalize in multithreaded C++.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

# ImageNet channel statistics (the standard torchvision recipe constants).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Compose:
    """Apply transforms in order (torchvision's ``transforms.Compose``)."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x: np.ndarray, rng: np.random.Generator | None = None):
        for t in self.transforms:
            x = t(x, rng) if _wants_rng(t) else t(x)
        return x

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


def _wants_rng(t) -> bool:
    return getattr(t, "random", False)


class ToTensor:
    """uint8 HWC [0,255] → float32 HWC [0,1] (torchvision's ToTensor minus
    the CHW transpose: the batch stays NHWC)."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        if x.dtype == np.uint8:
            return x.astype(np.float32) / np.float32(255.0)
        return np.asarray(x, np.float32)

    def __repr__(self):
        return "ToTensor()"


class Normalize:
    """(x - mean) / std per channel, float input."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float32) - self.mean) / self.std

    def __repr__(self):
        return f"Normalize(mean={self.mean.tolist()}, std={self.std.tolist()})"


def bilinear_resize_reference(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pure-numpy bilinear resize, float32 out — the semantic reference the
    native batched kernel (csrc fb_crop_resize_flip_normalize) is tested
    against.  Half-pixel centers, clamped (align-corners=False)."""
    h, w = x.shape[:2]
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    xf = x.astype(np.float32)
    top = xf[y0][:, x0] * (1 - wx) + xf[y0][:, x1] * wx
    bot = xf[y1][:, x0] * (1 - wx) + xf[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _bilinear_resize(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize HWC via PIL when available, else pure numpy.

    PIL's C resample is the per-sample speed path; the numpy fallback keeps
    the module dependency-free.
    """
    h, w = x.shape[:2]
    if h == out_h and w == out_w:
        return x
    try:
        from PIL import Image

        if x.dtype == np.uint8:
            im = Image.fromarray(x)
            return np.asarray(im.resize((out_w, out_h), Image.BILINEAR))
    except ImportError:
        pass
    out = bilinear_resize_reference(x, out_h, out_w)
    return np.rint(out).astype(np.uint8) if x.dtype == np.uint8 else out


@dataclasses.dataclass
class Resize:
    """Resize the shorter side to ``size`` (aspect preserved)."""

    size: int

    def __call__(self, x: np.ndarray) -> np.ndarray:
        h, w = x.shape[:2]
        if h <= w:
            out_h, out_w = self.size, max(int(round(w * self.size / h)), 1)
        else:
            out_h, out_w = max(int(round(h * self.size / w)), 1), self.size
        return _bilinear_resize(x, out_h, out_w)


@dataclasses.dataclass
class CenterCrop:
    size: int

    def __call__(self, x: np.ndarray) -> np.ndarray:
        h, w = x.shape[:2]
        top = max((h - self.size) // 2, 0)
        left = max((w - self.size) // 2, 0)
        return x[top:top + self.size, left:left + self.size]


class RandomHorizontalFlip:
    random = True

    def __init__(self, p: float = 0.5):
        self.p = p

    def sample_params(self, rng: np.random.Generator) -> bool:
        return bool(rng.random() < self.p)

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return x[:, ::-1] if self.sample_params(rng) else x

    def __repr__(self):
        return f"RandomHorizontalFlip(p={self.p})"


class RandomResizedCrop:
    """Random area/aspect crop resized to ``size`` (torchvision semantics:
    10 attempts at scale/ratio sampling, center-crop fallback)."""

    random = True

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = size
        self.scale = scale
        self.ratio = ratio

    def sample_params(
        self, rng: np.random.Generator, h: int, w: int
    ) -> tuple[int, int, int, int]:
        """Returns (top, left, crop_h, crop_w)."""
        area = h * w
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = int(rng.integers(0, h - ch + 1))
                left = int(rng.integers(0, w - cw + 1))
                return top, left, ch, cw
        # Fallback: center crop at the in-range aspect closest to the image's.
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def __call__(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        top, left, ch, cw = self.sample_params(rng, x.shape[0], x.shape[1])
        crop = x[top:top + ch, left:left + cw]
        return _bilinear_resize(crop, self.size, self.size)

    def __repr__(self):
        return f"RandomResizedCrop(size={self.size})"


def imagenet_train_transform(size: int = 224) -> Compose:
    """The standard ImageNet training recipe (BASELINE configs[1]/[2])."""
    return Compose([
        RandomResizedCrop(size),
        RandomHorizontalFlip(),
        ToTensor(),
        Normalize(),
    ])


def imagenet_eval_transform(size: int = 224, resize: int | None = None) -> Compose:
    # Keep the standard 256/224 resize/crop ratio for any crop size (a fixed
    # 256 would under-resize crops larger than 256 and break collation).
    if resize is None:
        resize = max(size * 256 // 224, size)
    return Compose([Resize(resize), CenterCrop(size), ToTensor(), Normalize()])


def cifar_train_transform() -> Compose:
    """The reference's pipeline: bare ToTensor."""
    return Compose([ToTensor()])
