"""Device-resident token stream: the counterpart of the JAX package's
``data/token_cache.py``.

The whole LM corpus is uploaded to the device once (2 bytes a token when
every id fits in 16 bits) and every (B, L) batch is assembled there:
window starts drawn on the device, one gather of the windows, a widen to
int32.  No host-to-device copy happens after the upload.

LM training samples windows IID (the nanoGPT convention) rather than
visiting examples once, so an "epoch" of :meth:`DeviceCachedTokens.batches`
is a number of draws.  The draws are the port's own (a ``torch.Generator``
on the device seeded from (seed, epoch, step)), so a step's windows do not
depend on whether the steps before it were drawn; the gather itself is the
pure function :func:`gather_windows` of the starts.  Under data
parallelism each rank draws the global batch's starts and keeps its own
rows, as the image cache does (``loader.rank_rows``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .device_cache import _STEP, _upload, device_generator
from .loader import rank_rows


def gather_windows(tokens: torch.Tensor, starts: torch.Tensor,
                   seq_len: int) -> torch.Tensor:
    """(B, ``seq_len``) int32 windows of the 1-D ``tokens`` beginning at
    ``starts`` (B,).  int16 storage holds uint16 ids and is widened
    without its sign."""
    ar = torch.arange(seq_len, device=tokens.device)
    windows = tokens[starts.view(-1, 1) + ar.view(1, -1)].to(torch.int32)
    if tokens.dtype == torch.int16:
        windows = windows & 0xFFFF
    return windows


class DeviceCachedTokens:
    """Device-resident token corpus with on-device batch assembly.

    ``tokens``: a 1-D integer array (the memmap of ``TokenFile`` /
    ``lm_corpus.load_token_bin``, or any integer ndarray), stored as
    2-byte ids when every id is in [0, 2**16), else as given.
    ``device``: where it lives (default: the CUDA device).
    ``rank``/``world``/``num_microbatches``: this process's share of each
    global batch."""

    def __init__(self, tokens, *, device=None, seed: int = 0,
                 default_seq_len: int | None = None, rank: int = 0,
                 world: int = 1, num_microbatches: int = 1):
        from ..utils.device import resolve_device

        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError(f"token stream must be 1-D, got {tokens.shape}")
        if tokens.size < 2:
            raise ValueError("token stream too short")
        if np.issubdtype(tokens.dtype, np.integer) \
                and tokens.dtype != np.uint16 \
                and 0 <= int(tokens.min()) and int(tokens.max()) < 2**16:
            # 2-byte ids halve the cache and the gather's bytes; only when
            # they fit (a negative id would wrap).
            tokens = tokens.astype(np.uint16)
        if tokens.dtype == np.uint16:
            # torch's uint16 lacks the gather: keep the bits as int16.
            tokens = tokens.view(np.int16)
        self.device = resolve_device(device)
        self.n = int(tokens.size)
        self.seed = seed
        self.default_seq_len = default_seq_len
        self.rank, self.world = rank, world
        self.num_microbatches = num_microbatches
        self._tokens = _upload(tokens, self.device)

    def __len__(self) -> int:
        return self.n

    @property
    def nbytes(self) -> int:
        """Bytes the cache holds on its device."""
        return self._tokens.numel() * self._tokens.element_size()

    def sample_batch_fn(self, batch_size: int, seq_len: int):
        """``sample(tokens, generator) -> (B, L) int32``: starts drawn
        from ``generator`` in [0, n - L] (inclusive, so the stream's last
        token can appear), then :func:`gather_windows`."""
        n = self.n
        if n < seq_len + 1:
            raise ValueError(f"corpus ({n} tokens) shorter than seq {seq_len}")

        def sample(tokens, generator):
            starts = torch.randint(0, n - seq_len + 1, (batch_size,),
                                   generator=generator, device=tokens.device)
            return gather_windows(tokens, starts, seq_len)

        return sample

    def _seq_len(self, seq_len: int | None) -> int:
        seq_len = seq_len or self.default_seq_len
        if seq_len is None:
            raise ValueError("seq_len required (or set default_seq_len)")
        return seq_len

    def batches(self, epoch: int, batch_size: int, *,
                seq_len: int | None = None, steps: int | None = None):
        """This rank's rows of ``steps`` global ``{"tokens": (B, L)
        int32}`` batches of ``epoch`` (default: corpus tokens / tokens per
        batch, one nominal pass), drawn from (seed, epoch, step)."""
        seq_len = self._seq_len(seq_len)
        if steps is None:
            steps = max(self.n // (batch_size * seq_len), 1)
        sample = self.sample_batch_fn(batch_size, seq_len)
        for step in range(steps):
            gen = device_generator(self.device, self.seed, epoch, _STEP, step)
            yield {"tokens": rank_rows(sample(self._tokens, gen), self.rank,
                                       self.world, self.num_microbatches)}

    def make_train_fn(self, step_fn: Callable, batch_size: int, seq_len: int,
                      *, steps_per_call: int):
        """``run(state, superstep) -> (state, metrics)``: ``steps_per_call``
        steps on the draws of (seed, superstep, step); each metric comes
        back stacked over the steps, (steps_per_call,), not averaged."""
        def run(state, superstep: int):
            history: list[dict] = []
            for batch in self.batches(superstep, batch_size, seq_len=seq_len,
                                      steps=steps_per_call):
                state, metrics = step_fn(state, batch)
                history.append(metrics)
            return state, {k: torch.stack([m[k] for m in history])
                           for k in history[-1]}

        return run

    def make_eval_fn(self, eval_step: Callable, batch_size: int,
                     seq_len: int, *, max_batches: int | None = None):
        """``evaluate(state) -> mean metrics`` over contiguous windows
        covering the stream once (every position scored once, no
        sampling noise), at most ``max_batches`` batches."""
        n_batches = (self.n // seq_len) // batch_size
        if max_batches is not None:
            n_batches = min(n_batches, max_batches)
        if n_batches == 0:
            raise ValueError(
                f"stream ({self.n} tokens) smaller than one eval batch "
                f"({batch_size}x{seq_len})")
        per_batch = batch_size * seq_len

        def evaluate(state):
            history = []
            for b in range(n_batches):
                starts = torch.arange(b * per_batch, (b + 1) * per_batch,
                                      seq_len, device=self.device)
                history.append(eval_step(
                    state, {"tokens": gather_windows(self._tokens, starts,
                                                     seq_len)}))
            return {k: torch.stack([m[k] for m in history]).mean(0)
                    for k in history[-1]}

        return evaluate
