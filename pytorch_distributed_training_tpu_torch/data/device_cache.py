"""Device-resident image dataset: the counterpart of the JAX package's
``data/device_cache.py``.

The uint8 records are uploaded to the device once; every step's batch is
then assembled there: the epoch's permutation, the crop box and the flips
are drawn on the device, and one gather reads the cropped, flipped rows
out of the cache.  No host-to-device copy happens after the upload, so the
step no longer waits on the host's feed.

Augmentation is RandomCrop + horizontal flip (records are pre-resized).
The crop box is drawn once per *batch* by default, flips per sample, as
the JAX cache does (``per_sample_crop=True`` draws a box per sample).
Scale/aspect jitter (RandomResizedCrop) stays in the host pipeline
(``PackedImages``).  In eval (``train=False``) the order is the identity
and the crop the exact centre.  The last partial batch is dropped.

The draws are the port's own and cannot equal JAX's threefry bits: a
``torch.Generator`` on the cache's device, seeded from (seed, epoch) for
the permutation and from (seed, epoch, step) for a step's box and flips.
A step's draws therefore do not depend on whether the steps before it
were drawn, which keeps a mid-epoch resume (which skips the consumed
steps) bitwise.  The augmentation math itself is the pure function
:func:`assemble`, JAX's ``_assemble_body`` with the random values passed
in.

Data parallelism: each rank holds the whole cache, draws the global
batch's indices, box and flips from the same seeds, and keeps its own rows
(``rank_rows``, the loader's rule), so the ranks' rows together are the
one-process batch.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from .loader import rank_rows
from .transforms import IMAGENET_MEAN, IMAGENET_STD

_PERMUTATION, _STEP = 0, 1


def device_generator(device: torch.device, *keys: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``keys`` (mixed by numpy's
    ``SeedSequence``, so nearby keys give unrelated streams)."""
    seed = np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _upload(array: np.ndarray, device) -> torch.Tensor:
    """``array`` on ``device``, copied once (a read-only memmap is read
    into host memory first: torch keeps no read-only tensors)."""
    array = np.ascontiguousarray(array)
    if not array.flags.writeable:
        array = array.copy()
    return torch.from_numpy(array).to(device)


def assemble(images: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
             oy, ox, flip, crop: int, train: bool) -> dict:
    """The batch of records ``idx`` (B,): ``images`` (N, H, W, C) and
    ``labels`` (N,) on one device.  In training, each record's
    ``crop``-square window at (``oy``, ``ox``) — (1,) tensors for one box
    per batch, (B,) for one per sample — mirrored where ``flip`` (B,
    bool) is set; in eval the exact centre crop (``oy``, ``ox`` and
    ``flip`` unused).  One gather reads the whole batch."""
    _, h, w, _ = images.shape
    lbls = labels[idx]
    if not train:
        oy0, ox0 = (h - crop) // 2, (w - crop) // 2
        return {"image": images[idx, oy0:oy0 + crop, ox0:ox0 + crop],
                "label": lbls}
    ar = torch.arange(crop, device=images.device)
    rows = oy.reshape(-1, 1, 1) + ar.view(1, crop, 1)
    ox = ox.reshape(-1, 1, 1)
    cols = torch.where(flip.view(-1, 1, 1),
                       ox + (crop - 1) - ar.view(1, 1, crop),
                       ox + ar.view(1, 1, crop))
    return {"image": images[idx.view(-1, 1, 1), rows, cols], "label": lbls}


class DeviceCachedImages:
    """Device-resident image dataset with on-device augmentation.

    ``source``: anything with ``.images`` (N, H, W, C uint8) and
    ``.labels`` (N,) — ``CIFAR10``, ``SyntheticImages``, ``ShapeImages``,
    ``PackedImages`` — or an ``(images, labels)`` tuple.  ``device``: where
    the records live (default: the CUDA device).  ``crop_size``: the
    output side (records must be at least that).  ``rank``/``world``/
    ``num_microbatches``: this process's share of each global batch
    (module docstring).  ``mean``/``std`` are the normalization the train
    step applies (``input_normalize``)."""

    def __init__(self, source: Any, *, crop_size: int, device=None,
                 train: bool = True, seed: int = 0,
                 mean: np.ndarray = IMAGENET_MEAN,
                 std: np.ndarray = IMAGENET_STD, rank: int = 0,
                 world: int = 1, num_microbatches: int = 1):
        from ..utils.device import resolve_device

        if isinstance(source, tuple):
            images, labels = source
        else:
            images, labels = source.images, source.labels
        images = np.ascontiguousarray(images)
        labels = np.ascontiguousarray(labels, dtype=np.int32)
        if images.dtype != np.uint8:
            raise ValueError(
                f"device cache wants uint8 records, got {images.dtype}")
        n, h, w, _ = images.shape
        if h < crop_size or w < crop_size:
            raise ValueError(f"records {h}x{w} smaller than crop {crop_size}")
        self.device = resolve_device(device)
        self.n = int(n)
        self.crop_size = int(crop_size)
        self.train = train
        self.seed = seed
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)
        self.rank, self.world = rank, world
        self.num_microbatches = num_microbatches
        self._images = _upload(images, self.device)
        self._labels = _upload(labels, self.device)

    def __len__(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        """Bytes the cache holds on its device."""
        return (self._images.numel() * self._images.element_size()
                + self._labels.numel() * self._labels.element_size())

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        return rank_rows(t, self.rank, self.world, self.num_microbatches)

    def permutation(self, epoch: int) -> torch.Tensor:
        """The epoch's order of the records, on the device."""
        if not self.train:
            return torch.arange(self.n, device=self.device)
        gen = device_generator(self.device, self.seed, epoch, _PERMUTATION)
        return torch.randperm(self.n, generator=gen, device=self.device)

    def draws(self, epoch: int, step: int, batch_size: int,
              per_sample_crop: bool = False):
        """(oy, ox, flip) of the global batch at (``epoch``, ``step``):
        the box (one per batch, or one per sample) and the flips."""
        h, w = self._images.shape[1:3]
        gen = device_generator(self.device, self.seed, epoch, _STEP, step)
        shape = (batch_size,) if per_sample_crop else (1,)
        oy = torch.randint(0, h - self.crop_size + 1, shape, generator=gen,
                           device=self.device)
        ox = torch.randint(0, w - self.crop_size + 1, shape, generator=gen,
                           device=self.device)
        flip = torch.rand(batch_size, generator=gen, device=self.device) < 0.5
        return oy, ox, flip

    def batches(self, epoch: int, batch_size: int, *,
                per_sample_crop: bool = False) -> Iterator[dict]:
        """This rank's ``{"image", "label"}`` rows of each global batch of
        ``epoch``, on the device: uint8 (b, crop, crop, C) images and
        int32 labels.  Nothing crosses from the host."""
        perm = self.permutation(epoch)
        for step in range(self.n // batch_size):
            idx = perm[step * batch_size:(step + 1) * batch_size]
            oy = ox = flip = None
            if self.train:
                oy, ox, flip = self.draws(epoch, step, batch_size,
                                          per_sample_crop)
                if per_sample_crop:
                    oy, ox = self._rows(oy), self._rows(ox)
                flip = self._rows(flip)
            yield assemble(self._images, self._labels, self._rows(idx), oy,
                           ox, flip, self.crop_size, self.train)

    def make_epoch_fn(self, step_fn: Callable, batch_size: int, *,
                      per_sample_crop: bool = False):
        """``run_epoch(state, epoch) -> (state, metrics)``: ``step_fn``
        over the epoch's batches, eagerly; metrics are the mean of each
        float metric over the steps and the last value of each integer
        one (JAX's reduction of its scan)."""
        def run_epoch(state, epoch: int):
            history: list[dict] = []
            for batch in self.batches(epoch, batch_size,
                                      per_sample_crop=per_sample_crop):
                state, metrics = step_fn(state, batch)
                history.append(metrics)
            return state, {
                k: (torch.stack([m[k] for m in history]).mean(0)
                    if history[-1][k].is_floating_point() else history[-1][k])
                for k in (history[-1] if history else {})}

        return run_epoch
