"""Abstract program signatures and the process-wide recompile guard: the
counterpart of the JAX package's ``analysis/signature.py``.

The JAX engine compiles three AOT programs; the port's twin of a
fixed-shape program compiled once is a CUDA graph captured once
(``serve/engine.py``).  A program's identity, for "was it captured
twice?", is its abstract calling convention: each static input's shape,
dtype and device, the tensors it writes in place (the twin of JAX's
donated cache) and each output's shape and dtype.  It is neither the
Python callable nor the engine that holds it: two engines of one
configuration share a signature.  ``abstract_signature`` hashes exactly
that.

``SignatureRegistry`` is the recompile guard: every capture site (the
engine's ``_compile`` for its serving programs) records its program name
and signature in ``PROGRAM_REGISTRY``.  A scheduler trace that admits,
drafts, cancels and resets must leave each program's count at exactly
one: a second record of one signature means a program was captured again
on the tick path, and a second signature under one name means its
calling convention changed.
"""

from __future__ import annotations

import hashlib
import threading
from collections.abc import Mapping
from typing import Any


def _tensor_token(t: Any, with_device: bool = True) -> str:
    shape = tuple(getattr(t, "shape", ()))
    token = f"{shape}:{getattr(t, 'dtype', None)}"
    if with_device:
        token += f":{getattr(t, 'device', None)}"
    return token


def _leaves(group: Any) -> list:
    """A program's tensors of one kind: a sequence, or a mapping's values
    in its order."""
    if isinstance(group, Mapping):
        return list(group.values())
    return list(group)


def abstract_signature(program: Any) -> str:
    """16 hex digits of a program's abstract signature.

    ``program`` exposes ``inputs`` (its static input tensors in calling
    order, or a mapping of them), ``donated`` (the tensors it writes in
    place) and ``outputs`` (its output tensors).  Each input and donated
    tensor contributes its shape, dtype and device; each output its shape
    and dtype."""
    parts: list[str] = []
    for t in _leaves(getattr(program, "inputs", ())):
        parts.append(_tensor_token(t))
    for t in _leaves(getattr(program, "donated", ())):
        parts.append("donated:" + _tensor_token(t))
    for t in _leaves(getattr(program, "outputs", ())):
        parts.append("out:" + _tensor_token(t, with_device=False))
    if not parts:
        raise ValueError(
            f"{type(program).__name__} exposes no inputs, donated tensors "
            "or outputs: not a program?"
        )
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


class SignatureRegistry:
    """Thread-safe (name, signature) → capture-count ledger."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[tuple[str, str], int] = {}

    def record(self, name: str, signature: str) -> int:
        """Count one capture of ``name`` at ``signature``; returns the new
        count (1 = first capture)."""
        with self._lock:
            key = (name, signature)
            self._counts[key] = self._counts.get(key, 0) + 1
            return self._counts[key]

    def counts(self, name: str | None = None) -> dict[tuple[str, str], int]:
        with self._lock:
            return {
                k: v for k, v in self._counts.items()
                if name is None or k[0] == name
            }

    def snapshot(self) -> dict[tuple[str, str], int]:
        """Copy of the ledger: diff two snapshots around a trace to count
        the captures it caused."""
        return self.counts()

    def compiles_since(
        self, snapshot: dict[tuple[str, str], int]
    ) -> dict[tuple[str, str], int]:
        now = self.counts()
        return {
            k: v - snapshot.get(k, 0)
            for k, v in now.items()
            if v - snapshot.get(k, 0) > 0
        }


# The process-wide ledger capture sites record into (tests snapshot and
# diff around their traces; a registry per test would miss captures made
# inside library calls).
PROGRAM_REGISTRY = SignatureRegistry()
