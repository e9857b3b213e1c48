"""Sharded DataLoader and device prefetch: the counterpart of the JAX
package's ``data/loader.py``.

Each process iterates a disjoint 1/num_shards slice of a seeded global
permutation (DistributedSampler semantics: equal-length shards by
wrapping, reshuffled each epoch by folding the epoch into the seed), with
the JAX loader's exact index logic.  With ``num_microbatches`` N > 1 over
P > 1 shards the rows are dealt so that the ranks together hold JAX's
microbatches: JAX assembles the global batch process-major and splits it
row-wise into N microbatches, so rank p is handed the p-th of P equal
slices of each of them, in microbatch order (``rank_rows``), and its own
N-way split then lines up with JAX's (what sync-BN statistics need).  A
dataset with a batched ``get_batch`` (the native gathers) is fetched
in-process unless its ``prefers_get_batch()`` says no; otherwise
``num_workers > 0`` assembles batches in a pool of spawned worker
processes, at most two per worker in flight, in the index order, handing
them back through shared memory.  ``prefetch_to_device`` keeps ``size``
batches in flight: pinned host memory copied with ``non_blocking``, so
the next batch's copy rides under the current step.
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


# The spawn pool pickles the dataset once into each worker at pool creation
# (initargs), not once per task.
_WORKER_DATASET: Any = None


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(indices: list[int], epoch: int) -> dict[str, torch.Tensor]:
    # The worker's dataset copy never sees the parent's set_epoch: sync it
    # from the task, so augmentation RNG (seed, epoch, index) advances.
    if getattr(_WORKER_DATASET, "epoch", epoch) != epoch:
        _WORKER_DATASET.set_epoch(epoch)
    batch = collate([_WORKER_DATASET[i] for i in indices])
    # As tensors, torch's pickling moves the arrays through shared memory;
    # pickled as arrays, a 224 px batch (77 MB) would cross the pool's
    # pipe byte by byte and be unpickled under the trainer's GIL.
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _as_arrays(batch: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in batch.items()}


def rank_rows(global_rows, rank: int, world: int, num_microbatches: int):
    """Rank ``rank``'s rows of one global batch: the ``rank``-th of
    ``world`` equal slices of each of its ``num_microbatches`` row-wise
    microbatches, concatenated in microbatch order.  ``global_rows`` is a
    numpy array or a tensor, rows first, its trailing dimensions kept; a
    tensor is reshaped where it lies (the device caches' batches: no
    index crosses from the host)."""
    n, rest = len(global_rows), tuple(global_rows.shape[1:])
    if n % (num_microbatches * world):
        raise ValueError(
            f"global batch {n} must divide into {num_microbatches} "
            f"microbatches x {world} ranks"
        )
    return global_rows.reshape(num_microbatches, world, -1, *rest)[
        :, rank].reshape(n // world, *rest)


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
                 *, shard_index: int = 0, num_shards: int = 1,
                 num_microbatches: int = 1):
        self.dataset = dataset
        self.config = config or DataLoaderConfig()
        if self.config.batch_size % (num_shards * num_microbatches):
            raise ValueError(
                f"global batch size {self.config.batch_size} must divide "
                f"evenly over {num_shards} shards x {num_microbatches} "
                "microbatches"
            )
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.num_microbatches = num_microbatches
        self.epoch = 0

    @property
    def local_batch_size(self) -> int:
        return self.config.batch_size // self.num_shards

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle deterministically for ``epoch``; forwarded to the
        dataset, whose per-sample augmentation RNG follows the epoch."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _shard_indices(self, shard: int | None = None) -> np.ndarray:
        """Shard ``shard``'s (default: this loader's) slice of the epoch's
        permutation."""
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
            shard = self.shard_index if shard is None else shard
            order = order[shard::self.num_shards]
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
        deal = self.num_shards > 1 and self.num_microbatches > 1
        shards = ([self._shard_indices(q) for q in range(self.num_shards)]
                  if deal else None)
        for start in range(0, limit, bs):
            if deal and start + bs <= len(idx):
                # JAX's global batch of this step, process-major.
                rows = rank_rows(
                    np.concatenate([s[start:start + bs] for s in shards]),
                    self.shard_index, self.num_shards,
                    self.num_microbatches)
            else:
                # (A ragged last batch, drop_last off: this shard's own.)
                rows = idx[start:start + bs]
            yield [int(i) for i in rows]

    def _pool(self):
        """The worker pool, created once and reused across epochs.  spawn,
        not fork: the parent has threads (torch's) by then."""
        if getattr(self, "_pool_obj", None) is None:
            import multiprocessing as mp

            self._pool_obj = mp.get_context("spawn").Pool(
                self.config.num_workers, initializer=_worker_init,
                initargs=(self.dataset,),
            )
        return self._pool_obj

    def close(self) -> None:
        """Stop the worker processes."""
        pool = getattr(self, "_pool_obj", None)
        if pool is not None:
            pool.terminate()
            pool.join()
            self._pool_obj = None

    def __del__(self):
        self.close()

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        get_batch = getattr(self.dataset, "get_batch", None)
        prefers = getattr(self.dataset, "prefers_get_batch", None)
        if get_batch is not None and (prefers is None or prefers()):
            for batch_idx in self._index_batches():
                yield get_batch(batch_idx)
            return
        if self.config.num_workers <= 0:
            for batch_idx in self._index_batches():
                yield collate([self.dataset[i] for i in batch_idx])
            return
        # A bounded window of tasks, not Pool.imap: imap's feeder would
        # queue the whole epoch, which an abandoned iterator (a
        # --steps-per-epoch cap) would leave decoding behind the pool.
        pool = self._pool()
        window = 2 * self.config.num_workers
        pending: deque = deque()
        for batch_idx in self._index_batches():
            pending.append(pool.apply_async(_worker_fetch,
                                            (batch_idx, self.epoch)))
            if len(pending) >= window:
                yield _as_arrays(pending.popleft().get())
        while pending:
            yield _as_arrays(pending.popleft().get())


def to_device(batch: dict, device) -> dict:
    """numpy batch → tensors on ``device``: pinned and copied without
    blocking the host when the device is a GPU.  Tensors already there
    (a device cache's batches) pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.device == torch.device(device):
            out[k] = v
            continue
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
