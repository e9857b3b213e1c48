"""Datasets: the counterparts of the JAX package's ``data/datasets.py``
— CIFAR-10 (the reference's), the synthetic image families, the LM token
families and ``Subset``.

Samples are numpy arrays, generated or read on the host, NHWC for images.
The synthetic samples are deterministic functions of (seed, split, index)
through the same numpy generators as the JAX package's, so they are
bit-identical to its samples.  ``CIFAR10`` reads the python-version
archive from a local directory (nothing is downloaded) and, like
``TokenFile``, assembles batches with the native gather of
``data/native.py``.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Any

import numpy as np

from . import native
from .loader import collate

CIFAR10_CLASSES = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)


class SyntheticImages:
    """Deterministic fake image-classification dataset.

    Sample ``i`` is generated from ``hash(seed, i)`` so any rank/worker
    reconstructs the identical example without shared state — which also
    makes the per-rank sharding tests exact.
    """

    def __init__(self, n: int = 10_000, image_size: int = 32, channels: int = 3,
                 num_classes: int = 10, seed: int = 0):
        self.n = n
        self.image_size = image_size
        self.channels = channels
        self.classes = [str(c) for c in range(num_classes)]
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) | (i % self.n))
        img = rng.random((self.image_size, self.image_size, self.channels), np.float32)
        label = np.int32(rng.integers(0, len(self.classes)))
        return {"image": img, "label": label}

    @property
    def images(self) -> np.ndarray:
        """uint8 record view for ``DeviceCachedImages`` (materialized once;
        the device cache re-scales by /255 on the device, so values match
        ``__getitem__``'s floats to quantization)."""
        if not hasattr(self, "_records"):
            samples = [self[i] for i in range(self.n)]
            self._records = (
                (np.stack([s["image"] for s in samples]) * 255.0
                 ).astype(np.uint8),
                np.asarray([s["label"] for s in samples], np.int32),
            )
        return self._records[0]

    @property
    def labels(self) -> np.ndarray:
        self.images  # materialize both together
        return self._records[1]


SHAPE_CLASSES = (
    "disk", "ring", "square", "diamond", "triangle",
    "plus", "cross", "stripes_h", "stripes_v", "checker",
)


class ShapeImages:
    """Procedural 10-class shape dataset — the *learnable* synthetic family.

    ``SyntheticImages`` is iid noise: ideal for throughput benches, useless
    for convergence evidence (nothing generalizes).  This dataset exists for
    machines without network access, where the reference's CIFAR-10
    download is impossible: every sample is a
    rendered 32×32 scene whose class is a *shape* (disk/ring/square/diamond/
    triangle/plus/cross) or *texture* (axis-ish stripes, checker), under
    heavy nuisance variation — random foreground/background colors, position,
    scale, rotation, edge softness, pixel noise, and up to two distractor
    dots.  Color carries zero class signal by construction, so a classifier
    must learn spatial features; a pixel-space linear probe plateaus far
    below a convnet (the JAX package's CONVERGENCE.json), which makes
    train→val generalization here a meaningful end-to-end test of the
    training stack.

    Samples are deterministic functions of ``(seed, split, index)`` via
    ``np.random.default_rng([seed, split_salt, index])``, so train and val
    are disjoint iid draws from the same distribution and any rank/worker
    reconstructs an identical example without shared state.
    """

    def __init__(self, n: int = 50_000, *, train: bool = True, seed: int = 0):
        self.n = int(n)
        self.train = train
        self.seed = seed
        self.classes = list(SHAPE_CLASSES)

    def __len__(self) -> int:
        return self.n

    def _render(self, rng: np.random.Generator, label: int) -> np.ndarray:
        size = 32
        # Pixel-center coordinates in [-1, 1].
        c = (np.arange(size, dtype=np.float32) + 0.5) / size * 2.0 - 1.0
        xx, yy = np.meshgrid(c, c)
        # Nuisance affine: rotation, scale, translation.
        theta = rng.uniform(-0.44, 0.44)  # ±25°
        s = rng.uniform(0.55, 0.95)
        cx, cy = rng.uniform(-0.28, 0.28, 2)
        ct, st = np.cos(theta), np.sin(theta)
        u = ((xx - cx) * ct + (yy - cy) * st) / s
        v = (-(xx - cx) * st + (yy - cy) * ct) / s
        r = np.hypot(u, v)
        name = SHAPE_CLASSES[label]
        if name == "disk":
            sd = r - 0.8
        elif name == "ring":
            sd = np.maximum(r - 0.85, 0.45 - r)
        elif name == "square":
            sd = np.maximum(np.abs(u), np.abs(v)) - 0.7
        elif name == "diamond":
            sd = (np.abs(u) + np.abs(v)) - 0.95
        elif name == "triangle":
            # Apex at v=-0.85, base at v=0.7, sides widening downward.
            sd = np.maximum(v - 0.7, np.abs(u) * 1.45 - (v + 0.85))
        elif name == "plus":
            sd = np.minimum(
                np.maximum(np.abs(u) - 0.26, np.abs(v) - 0.85),
                np.maximum(np.abs(v) - 0.26, np.abs(u) - 0.85),
            )
        elif name == "cross":
            p = (u + v) * np.float32(np.sqrt(0.5))
            q = (u - v) * np.float32(np.sqrt(0.5))
            sd = np.minimum(
                np.maximum(np.abs(p) - 0.26, np.abs(q) - 0.85),
                np.maximum(np.abs(q) - 0.26, np.abs(p) - 0.85),
            )
        else:
            # Textures live inside a disk so silhouette alone (a disk) can't
            # separate them from class 0 — the classifier must resolve the
            # interior pattern.
            freq = rng.uniform(2.4, 3.6)
            phase = rng.uniform(0.0, 1.0)
            if name == "stripes_h":
                wave = np.sin((v * freq + phase) * np.pi)
            elif name == "stripes_v":
                wave = np.sin((u * freq + phase) * np.pi)
            else:  # checker
                wave = (np.sin((u * freq + phase) * np.pi)
                        * np.sin((v * freq + phase) * np.pi))
            sd = np.where(wave > 0.0, r - 0.85, np.float32(1.0))
        # Anti-aliased coverage: ~1.5px soft edge in shape-local units.
        edge = 0.09 / s
        mask = np.clip(0.5 - sd / edge, 0.0, 1.0).astype(np.float32)

        # Colors: background and foreground both uniform random; push the
        # foreground away from the background so the shape is visible, but
        # leave the direction random (color is never a class cue).
        bg = rng.uniform(0.0, 1.0, 3).astype(np.float32)
        fg = rng.uniform(0.0, 1.0, 3).astype(np.float32)
        d = fg - bg
        norm = float(np.sqrt((d * d).sum()))
        min_sep = 0.5
        if norm < min_sep:
            if norm < 1e-6:
                d = np.float32([0.577, 0.577, 0.577])
                norm = 1.0
            fg = np.clip(bg + d / norm * min_sep, 0.0, 1.0)
        img = bg + mask[..., None] * (fg - bg)

        # Distractors: up to two small dots of random color (never the size
        # of a class shape) to penalize blob-counting shortcuts.
        for _ in range(rng.integers(0, 3)):
            dx, dy = rng.uniform(-0.8, 0.8, 2)
            rad = rng.uniform(0.06, 0.12)
            dcol = rng.uniform(0.0, 1.0, 3).astype(np.float32)
            dmask = np.clip(
                0.5 - (np.hypot(xx - dx, yy - dy) - rad) / 0.06, 0.0, 1.0
            ).astype(np.float32)
            img = img + dmask[..., None] * (dcol - img)

        img = img + rng.normal(0.0, 0.05, img.shape).astype(np.float32)
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        split_salt = 0 if self.train else 1
        rng = np.random.default_rng([self.seed, split_salt, i % self.n])
        label = np.int32(rng.integers(0, len(self.classes)))
        return {"image": self._render(rng, int(label)), "label": label}

    @property
    def images(self) -> np.ndarray:
        """uint8 record view for ``DeviceCachedImages`` (materialized once;
        the cache re-scales by /255 on the device, matching
        ``__getitem__``'s floats to quantization).  Quantized sample by
        sample, so the peak is the uint8 cache, not n float32 renders held
        at once."""
        if not hasattr(self, "_records"):
            imgs = np.empty((self.n, 32, 32, 3), np.uint8)
            labels = np.empty((self.n,), np.int32)
            for i in range(self.n):
                s = self[i]
                imgs[i] = (s["image"] * 255.0).astype(np.uint8)
                labels[i] = s["label"]
            self._records = (imgs, labels)
        return self._records[0]

    @property
    def labels(self) -> np.ndarray:
        self.images  # materialize both together
        return self._records[1]


class SyntheticTokens:
    """Deterministic fake LM dataset: (seq_len,) int32 token windows, window
    ``i`` drawn from ``default_rng((seed << 32) | i)``."""

    def __init__(self, n: int = 10_000, seq_len: int = 1024,
                 vocab_size: int = 50257, seed: int = 0):
        self.n = n
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) | (i % self.n))
        return {"tokens": rng.integers(0, self.vocab_size, self.seq_len,
                                       np.int32)}


class TokenFile:
    """Memory-mapped pre-tokenized corpus (a flat uint16 .bin of token ids)
    → disjoint windows: window ``i`` starts at ``i * seq_len``."""

    def __init__(self, path: str, seq_len: int = 1024, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len

    def __len__(self) -> int:
        return max((len(self.tokens) - 1) // self.seq_len, 0)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        start = i * self.seq_len
        return {"tokens": np.asarray(self.tokens[start:start + self.seq_len],
                                     np.int32)}

    def get_batch(self, indices: list[int]) -> dict[str, np.ndarray]:
        """Windows ``indices`` as one (B, seq_len) int32 array, by the
        native gather."""
        return {"tokens": native.gather_token_windows(
            self.tokens, np.asarray(indices, np.int64), self.seq_len)}


class CIFAR10:
    """CIFAR-10 from the standard python-version archive on local disk.

    The reference's constructor surface (``data_dir``, ``train``) minus
    ``download``: nothing is fetched, so when neither the extracted batches
    nor the .tar.gz archive exist under ``data_dir`` it raises with a
    pointer to the synthetic data.  Callers choose the split; the CLI
    trains on the *train* split.
    """

    ARCHIVE = "cifar-10-python.tar.gz"
    FOLDER = "cifar-10-batches-py"

    def __init__(
        self, data_dir: str, train: bool = True, transform=None, *, seed: int = 0
    ):
        from .transforms import Compose

        self.classes = list(CIFAR10_CLASSES)
        # Normalize bare transforms to Compose so the rng-dispatch logic
        # (Compose._wants_rng) applies uniformly.
        self.transform = (
            transform
            if transform is None or isinstance(transform, Compose)
            else Compose([transform])
        )
        self.seed = seed
        self.epoch = 0
        folder = os.path.join(data_dir, self.FOLDER)
        archive = os.path.join(data_dir, self.ARCHIVE)
        if not os.path.isdir(folder) and os.path.exists(archive):
            with tarfile.open(archive, "r:gz") as tf:
                # filter="data" rejects path traversal from crafted archives
                # (pre-3.14 extractall defaults allow it).
                tf.extractall(data_dir, filter="data")
        if not os.path.isdir(folder):
            raise FileNotFoundError(
                f"CIFAR-10 not found under {data_dir!r} (need {self.FOLDER}/ or "
                f"{self.ARCHIVE}); no network egress to download. Use "
                "SyntheticImages / --synthetic-data instead."
            )
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        images, labels = [], []
        for name in names:
            with open(os.path.join(folder, name), "rb") as f:
                entry = pickle.load(f, encoding="latin1")
            images.append(entry["data"])
            labels.extend(entry["labels"])
        # (N, 3072) uint8 → (N, 32, 32, 3) NHWC.
        self.images = (
            np.vstack(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).copy()
        )
        self.labels = np.asarray(labels, np.int32)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.images)

    def prefers_get_batch(self) -> bool:
        """In-process batched fetch only when the transform fuses natively;
        arbitrary transforms go to the loader's worker pool instead of a
        serial main-process loop."""
        return self._fast_plan() is not None

    def _fast_plan(self):
        """Recognize transforms the native batched path can fuse.

        Returns "scale" (bare ToTensor — the reference pipeline),
        ("normalize", mean, std) for ToTensor→Normalize,
        or None for arbitrary compositions (per-sample path).
        """
        from .transforms import Compose, Normalize, ToTensor

        t = self.transform
        if t is None or isinstance(t, ToTensor):
            return "scale"
        steps = t.transforms if isinstance(t, Compose) else [t]
        if len(steps) == 1 and isinstance(steps[0], ToTensor):
            return "scale"
        if (
            len(steps) == 2
            and isinstance(steps[0], ToTensor)
            and isinstance(steps[1], Normalize)
        ):
            return ("normalize", steps[1].mean, steps[1].std)
        return None

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        if self.transform is None:
            # ToTensor-equivalent scaling, NHWC not CHW.
            img = self.images[i].astype(np.float32) / 255.0
        else:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, int(i)])
            )
            img = np.asarray(self.transform(self.images[i], rng), np.float32)
        return {"image": img, "label": self.labels[i]}

    def get_batch(self, indices: list[int]) -> dict[str, np.ndarray]:
        """Batched fetch.  Fusable transforms (ToTensor / ToTensor +
        Normalize) run as one native multithreaded gather
        (``data/native.py``); anything else goes sample by sample with the
        same (seed, epoch, index) RNG as __getitem__.
        """
        idx = np.asarray(indices, np.int64)
        plan = self._fast_plan()
        if plan == "scale":
            image = native.gather_images_u8(self.images, idx)
        elif plan is not None:
            _, mean, std = plan
            image = native.gather_images_u8_normalized(self.images, idx, mean, std)
        else:
            return collate([self[int(i)] for i in idx])
        return {"image": image, "label": self.labels[idx]}


class Subset:
    """View of a dataset over an index range (the CLI's token-file
    train/eval split); forwards ``get_batch``."""

    def __init__(self, dataset: Any, start: int, stop: int):
        if not (0 <= start <= stop <= len(dataset)):
            raise ValueError(f"bad subset [{start}, {stop}) of {len(dataset)}")
        self.dataset = dataset
        self.start = start
        self.stop = stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, i: int):
        return self.dataset[self.start + i]

    def get_batch(self, indices):
        shifted = [self.start + int(i) for i in indices]
        inner = getattr(self.dataset, "get_batch", None)
        if inner is not None:
            return inner(shifted)
        return collate([self.dataset[i] for i in shifted])


def cifar10(data_dir: str, train: bool = True, *, synthetic: bool = False):
    """The CLI's CIFAR-10: the local archive, or with ``synthetic`` the
    CIFAR-shaped ``SyntheticImages`` (50,000 train / 10,000 test)."""
    if synthetic:
        return SyntheticImages(
            n=50_000 if train else 10_000, image_size=32, num_classes=10
        )
    return CIFAR10(data_dir, train=train)
