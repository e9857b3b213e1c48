"""ImageNet-format datasets: the counterpart of the JAX package's
``data/imagenet.py``.

- ``ImageFolder``: a torchvision-layout tree (one subdirectory a class),
  each image decoded with PIL inside the loader's worker processes and
  transformed by numpy transforms (``data/transforms.py``).  PIL is
  imported where an image is opened; without it, that raises.
- ``PackedImages``: pre-decoded uint8 records in one memory-mapped file
  (``pack_image_folder`` writes it from a tree, ``synthesize_packed_images``
  from a seed).  A batch is one multithreaded native call
  (``data/native.py``: ``crop_resize_flip_u8`` for uint8 output, which
  the train step scales and normalizes on the device, or
  ``crop_resize_flip_normalize`` for f32).  A failed build of the native
  library raises; nothing drops to numpy.  The numpy versions of the same
  batch are ``native``'s ``*_plain`` functions, which the tests use.

File format (byte for byte the JAX package's): ``PCKIMG1\\0`` | int64 n,
h, w, c (little endian) | int32 labels[n] | uint8 images[n, h, w, c],
with the class names in a ``<path>.classes`` sidecar, one a line.

Augmentation is deterministic: each sample's generator comes from (seed,
epoch, index), so a resumed epoch replays the same crops; the loader
forwards ``set_epoch``.
"""

from __future__ import annotations

import os
import struct
from typing import Sequence

import numpy as np

from . import native
from .transforms import (
    IMAGENET_MEAN, IMAGENET_STD, CenterCrop, Compose, RandomHorizontalFlip,
    RandomResizedCrop, Resize, ToTensor,
)

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
_MAGIC = b"PCKIMG1\x00"


def _sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, epoch, int(index)]))


def _open_rgb(path: str) -> np.ndarray:
    """The image at ``path`` as an (H, W, 3) uint8 array."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "reading an image folder needs PIL (the pillow package), which "
            "this Python lacks; pack the tree once where PIL is installed "
            "(pack_image_folder) and train from --dataset "
            "packed-images:<file>"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class ImageFolder:
    """Class-per-subdirectory image tree.  ``classes`` (sorted directory
    names) sizes the model's head, as the reference sizes it from the
    dataset."""

    def __init__(self, root: str, transform=None, *, seed: int = 0):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise FileNotFoundError(f"no class subdirectories under {root!r}")
        self.samples: list[tuple[str, int]] = []
        for label, cls in enumerate(self.classes):
            cdir = os.path.join(root, cls)
            for name in sorted(os.listdir(cdir)):
                if name.lower().endswith(_IMG_EXTS):
                    self.samples.append((os.path.join(cdir, name), label))
        if not self.samples:
            raise FileNotFoundError(f"no images under {root!r}")
        if transform is None:
            transform = Compose([ToTensor()])
        elif not isinstance(transform, Compose):
            transform = Compose([transform])
        self.transform = transform
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        path, label = self.samples[index]
        img = self.transform(_open_rgb(path),
                             _sample_rng(self.seed, self.epoch, index))
        return {"image": np.asarray(img, np.float32),
                "label": np.int32(label)}


def _write_header(f, n: int, size: int) -> None:
    f.write(_MAGIC)
    f.write(struct.pack("<qqqq", n, size, size, 3))


def pack_image_folder(root: str, out_path: str, *, size: int = 232,
                      classes: Sequence[str] | None = None) -> int:
    """Decode an ``ImageFolder`` tree once into a packed file: each image
    resized (shorter side) to ``size`` and center-cropped square, a
    smaller one zero-padded to shape.  Returns the number of images."""
    folder = ImageFolder(root, transform=Compose([Resize(size),
                                                  CenterCrop(size)]))
    if classes is not None and list(classes) != folder.classes:
        raise ValueError("class list mismatch")
    with open(out_path, "wb") as f:
        _write_header(f, len(folder), size)
        f.write(np.array([lbl for _, lbl in folder.samples],
                         np.int32).tobytes())
        for path, _ in folder.samples:
            arr = folder.transform(_open_rgb(path))
            if arr.shape != (size, size, 3):
                padded = np.zeros((size, size, 3), np.uint8)
                padded[:arr.shape[0], :arr.shape[1]] = arr[:size, :size]
                arr = padded
            f.write(np.ascontiguousarray(arr, np.uint8).tobytes())
    with open(out_path + ".classes", "w") as f:
        f.write("\n".join(folder.classes))
    return len(folder)


def synthesize_packed_images(path: str, *, n: int = 512, size: int = 232,
                             num_classes: int = 1000, seed: int = 0) -> None:
    """Write a packed file of random records (uniform bytes, uniform
    labels) from ``seed``: the stand-in for ImageNet where its files are
    not on the machine."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        _write_header(f, n, size)
        f.write(rng.integers(0, num_classes, n, dtype=np.int32).tobytes())
        chunk = 64
        for start in range(0, n, chunk):
            m = min(chunk, n - start)
            f.write(rng.integers(0, 256, (m, size, size, 3),
                                 dtype=np.uint8).tobytes())


class PackedImages:
    """Packed uint8 records with batched native augmentation.

    ``get_batch`` (the loader's in-process path) draws one
    RandomResizedCrop box and flip per image from its (seed, epoch,
    index) generator and assembles the batch in one native call.
    ``train=False`` takes the eval recipe: the centered ``crop_size``
    square of each record (records are already shorter-side resized), no
    flip.  ``output_dtype="uint8"`` leaves ToTensor and Normalize to the
    device: pass ``(mean, std)`` as the train step's
    ``input_normalize``."""

    def __init__(self, path: str, *, train: bool = True, crop_size: int = 224,
                 seed: int = 0, mean: np.ndarray = IMAGENET_MEAN,
                 std: np.ndarray = IMAGENET_STD,
                 output_dtype: str = "float32"):
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(
                f"output_dtype must be float32|uint8, got {output_dtype!r}")
        self.output_dtype = output_dtype
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise ValueError(f"{path!r} is not a packed image file")
            n, h, w, c = struct.unpack("<qqqq", f.read(32))
            header = f.tell()
        self.n, self.h, self.w, self.c = int(n), int(h), int(w), int(c)
        self.labels = np.memmap(path, np.int32, "r", offset=header,
                                shape=(self.n,))
        self.images = np.memmap(path, np.uint8, "r",
                                offset=header + 4 * self.n,
                                shape=(self.n, self.h, self.w, self.c))
        cls_path = path + ".classes"
        if os.path.exists(cls_path):
            with open(cls_path) as f:
                self.classes = [ln for ln in f.read().splitlines() if ln]
        else:
            self.classes = [str(i) for i in range(int(self.labels.max()) + 1)]
        self.train = train
        self.crop_size = crop_size
        self.seed = seed
        self.epoch = 0
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._rrc = RandomResizedCrop(crop_size)
        self._flip = RandomHorizontalFlip()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.n

    def params(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """The (B, 4) int32 crop boxes (top, left, h, w) and (B,) flips of
        a batch of ``indices``."""
        if not self.train:
            s = self.crop_size
            box = (max((self.h - s) // 2, 0), max((self.w - s) // 2, 0),
                   min(s, self.h), min(s, self.w))
            return (np.tile(np.array(box, np.int32), (len(indices), 1)),
                    np.zeros(len(indices), bool))
        boxes = np.empty((len(indices), 4), np.int32)
        flips = np.empty(len(indices), bool)
        for i, idx in enumerate(indices):
            rng = _sample_rng(self.seed, self.epoch, idx)
            boxes[i] = self._rrc.sample_params(rng, self.h, self.w)
            flips[i] = self._flip.sample_params(rng)
        return boxes, flips

    def get_batch(self, indices) -> dict[str, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        boxes, flips = self.params(idx)
        size = (self.crop_size, self.crop_size)
        if self.output_dtype == "uint8":
            out = native.crop_resize_flip_u8(self.images, idx, boxes, flips,
                                             size)
        else:
            out = native.crop_resize_flip_normalize(
                self.images, idx, boxes, flips, size, self.mean, self.std)
        return {"image": out,
                "label": np.asarray(self.labels[idx], np.int32)}

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        batch = self.get_batch([index])
        return {"image": batch["image"][0], "label": batch["label"][0]}
