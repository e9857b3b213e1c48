"""LM datasets: the counterparts of the JAX package's
``data/datasets.py::SyntheticTokens``, ``TokenFile`` and ``Subset``.

Samples are numpy arrays, generated or read on the host.  ``TokenFile``
memory-maps a flat uint16 corpus and gathers windows with numpy (the
JAX package's native ``csrc/fastbatch`` gather comes with the ResNet
slice).
"""

from __future__ import annotations

from typing import Any

import numpy as np


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
        """Windows ``indices`` as one (B, seq_len) int32 array."""
        starts = np.asarray(indices, np.int64)[:, None] * self.seq_len
        return {"tokens": self.tokens[starts + np.arange(self.seq_len)]
                .astype(np.int32)}


class Subset:
    """View of a ``get_batch`` dataset over an index range (the CLI's
    token-file train/eval split)."""

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
        return self.dataset.get_batch([self.start + int(i) for i in indices])
