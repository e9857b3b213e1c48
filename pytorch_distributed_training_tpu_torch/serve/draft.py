"""Model-free draft-token proposal for speculative decoding: a copy of the
JAX package's ``serve/draft.py`` (pure numpy, no framework in it).

Prompt lookup (Saxena's prompt-lookup decoding, vLLM's ``[ngram]``
method): the slot's own prompt + generated history is the proposal
source, plus a shared cross-request n-gram index fed from admitted
prompts.  The target model verifies every draft (serve/engine.py), so a
wrong draft costs wasted compute, never a wrong token.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


def _find_suffix_match(history: np.ndarray, n: int) -> int | None:
    """Start index of the MOST RECENT earlier occurrence of the length-n
    suffix of ``history``, or None.  The trivial occurrence (the suffix
    itself) is excluded; overlapping matches are allowed — they are what
    make period-p repetition draftable with any n-gram length."""
    if n < 1 or history.size < n + 1:
        return None
    pattern = history[-n:]
    win = np.lib.stride_tricks.sliding_window_view(history[:-1], n)
    hits = np.nonzero((win == pattern).all(axis=1))[0]
    if hits.size == 0:
        return None
    return int(hits[-1])


class NgramIndex:
    """Bounded cross-request n-gram -> continuation index.

    ``observe(tokens)`` registers every position's n-gram of an admitted
    prompt; ``lookup(suffix)`` returns the tokens that followed the most
    recently observed occurrence.  Entries hold (array, offset) pointers
    into the observed prompt (one copy per prompt, not per position) and
    evict LRU past ``max_entries`` — the same bounded-publication shape as
    the JAX package's paged-pool block LRU.
    """

    def __init__(self, n: int, *, max_entries: int = 8192):
        if n < 1:
            raise ValueError(f"ngram length must be >= 1, got {n}")
        self.n = n
        self.max_entries = max_entries
        self._entries: OrderedDict[bytes, tuple[np.ndarray, int]] = (
            OrderedDict()
        )

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every entry IN PLACE.  The reset path must clear rather
        than replace: a data-parallel serving tier shares ONE index
        across all replicas' drafters (the JAX package's
        serve/router.py), and swapping in a fresh object from one
        engine's reset would silently fork the sharing — the other
        replicas would keep feeding the orphan."""
        self._entries.clear()

    def observe(self, tokens: np.ndarray) -> None:
        tokens = np.ascontiguousarray(tokens, np.int32)
        n = self.n
        for i in range(tokens.size - n):
            key = tokens[i:i + n].tobytes()
            # Latest occurrence wins and refreshes recency (move_to_end
            # via delete+insert).
            self._entries.pop(key, None)
            self._entries[key] = (tokens, i + n)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def lookup(self, suffix: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` continuation tokens after ``suffix`` (length must
        be exactly ``n``), or an empty draft."""
        suffix = np.ascontiguousarray(suffix, np.int32)
        if suffix.size != self.n:
            return np.zeros((0,), np.int32)
        hit = self._entries.get(suffix.tobytes())
        if hit is None:
            return np.zeros((0,), np.int32)
        tokens, off = hit
        return tokens[off:off + k].astype(np.int32, copy=False)


class PromptLookupDrafter:
    """Propose up to ``k`` continuation tokens by suffix lookup.

    Longest-match-first: n-grams from ``max_ngram`` down to ``min_ngram``
    against the slot's own history, then the shared :class:`NgramIndex`
    (when given) at exactly ``max_ngram``.  ``min_ngram`` defaults to 2:
    1-gram matches on unstructured text fire constantly and verify to
    nothing, turning the drafter into pure overhead on adversarial
    workloads (the JAX bench's zero-acceptance leg pins that cost at <= 5%).
    """

    def __init__(
        self,
        *,
        max_ngram: int = 3,
        min_ngram: int = 2,
        index: NgramIndex | None = None,
    ):
        if max_ngram < 1:
            raise ValueError(f"max_ngram must be >= 1, got {max_ngram}")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"min_ngram must be in 1..max_ngram, got {min_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.index = index

    def observe_prompt(self, prompt: np.ndarray) -> None:
        """Feed an admitted prompt into the shared index (no-op without
        one) — the engine calls this at ``start``."""
        if self.index is not None:
            self.index.observe(prompt)

    def draft(self, history: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens for a slot whose
        consumed tokens are ``history`` (prompt + generated, the last
        entry being the token about to be fed).  Empty when nothing
        matches (cold start) or ``k`` <= 0.

        A match at distance ``period`` back predicts the linear
        recurrence ``x[t] = x[t - period]`` forward: the draft cycles the
        last ``period`` tokens rather than stopping at history's edge.
        For a far-back match (period >= k) that IS the plain "tokens that
        followed the match"; for the overlapping matches that repetition
        produces (period < k, e.g. a greedy decode stuck on one token,
        period 1) it extends the cycle to the full k — without this, a
        period-p loop would cap every draft at p tokens and forfeit most
        of the verify width."""
        history = np.ascontiguousarray(history, np.int32)
        if k <= 0 or history.size == 0:
            return np.zeros((0,), np.int32)
        # Cheap cold reject: every suffix match of ANY length ends with
        # the final token, so if it never occurred before there is
        # nothing to find — one vectorized compare instead of the window
        # search, which is the common case on unstructured text (the
        # adversarial-workload overhead the JAX bench pins at <= 5%).
        has_prior = bool(np.any(history[:-1] == history[-1]))
        for n in (
            range(min(self.max_ngram, history.size - 1), 0, -1)
            if has_prior else ()
        ):
            if n < self.min_ngram:
                break
            p = _find_suffix_match(history, n)
            if p is not None:
                period = history.size - n - p
                window = history[history.size - period:]
                return np.tile(window, -(-k // period))[:k].astype(
                    np.int32, copy=False
                )
        if self.index is not None and history.size >= self.index.n:
            return self.index.lookup(history[-self.index.n:], k)
        return np.zeros((0,), np.int32)
