"""Sharded DataLoader and device prefetch: the counterpart of the JAX
package's ``data/loader.py``.

Each process iterates a disjoint 1/num_shards slice of a seeded global
permutation (DistributedSampler semantics: equal-length shards by
wrapping, reshuffled each epoch by folding the epoch into the seed), with
the JAX loader's exact index logic.  Batches are fetched in-process;
``num_workers`` is accepted for the CLI's sake (the worker pool comes with
the image datasets, whose decode needs it).  ``prefetch_to_device`` keeps
``size`` batches in flight: pinned host memory copied with
``non_blocking``, so the next batch's copy rides under the current step.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Iterable, Iterator

import numpy as np
import torch


def collate(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """Stack per-sample dicts into one batch dict."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


@dataclasses.dataclass(frozen=True)
class DataLoaderConfig:
    batch_size: int = 32
    shuffle: bool = True
    seed: int = 0
    drop_last: bool = True        # equal step counts across shards
    num_workers: int = 0


class DataLoader:
    """Iterates host-local numpy batches of a (possibly sharded) dataset."""

    def __init__(self, dataset: Any, config: DataLoaderConfig | None = None,
                 *, shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.config = config or DataLoaderConfig()
        if self.config.batch_size % num_shards != 0 and num_shards > 1:
            raise ValueError(
                f"global batch size {self.config.batch_size} must divide "
                f"evenly over {num_shards} shards"
            )
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    @property
    def local_batch_size(self) -> int:
        return self.config.batch_size // self.num_shards

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically for ``epoch``."""
        self.epoch = epoch

    def _shard_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.config.shuffle:
            rng = np.random.default_rng((self.config.seed << 20) + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            pad = (-n) % self.num_shards
            if pad:
                order = np.concatenate([order, order[:pad]])
            order = order[self.shard_index::self.num_shards]
        return order

    def __len__(self) -> int:
        per_shard = len(self._shard_indices())
        if self.config.drop_last:
            return per_shard // self.local_batch_size
        return -(-per_shard // self.local_batch_size)

    def _index_batches(self) -> Iterator[list[int]]:
        idx = self._shard_indices()
        bs = self.local_batch_size
        limit = len(idx) - (len(idx) % bs) if self.config.drop_last \
            else len(idx)
        for start in range(0, limit, bs):
            yield [int(i) for i in idx[start:start + bs]]

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        get_batch = getattr(self.dataset, "get_batch", None)
        for batch_idx in self._index_batches():
            if get_batch is not None:
                yield get_batch(batch_idx)
            else:
                yield collate([self.dataset[i] for i in batch_idx])


def to_device(batch: dict, device) -> dict:
    """numpy batch → tensors on ``device``: pinned and copied without
    blocking the host when the device is a GPU."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if torch.device(device).type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(batches: Iterable[dict], device, *,
                       size: int = 2) -> Iterator[dict]:
    """Keep ``size`` batches in flight on ``device`` ahead of the one the
    caller holds."""
    buf: deque = deque()
    it = iter(batches)
    for batch in itertools.islice(it, size):
        buf.append(to_device(batch, device))
    while buf:
        yield buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(to_device(nxt, device))
