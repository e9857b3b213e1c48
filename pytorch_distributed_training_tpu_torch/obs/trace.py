"""Semantic phase names for profiler timelines, one vocabulary for the repo.

A ``torch.profiler`` trace shows operator and kernel names; chasing a
pipeline bubble or an exposed cross-node transfer needs the *semantic*
phase — which tier of the gradient sync, which engine step, which tick.
This module owns the canonical names (the JAX package's :data:`PHASES`,
the same tuple, so the JAX package's tools and the port's traces agree)
and the entry points:

- :func:`annotate` — a host range (``record_function``) around host code:
  the serve engine's steps and the trainer's step dispatch;
- :func:`step_annotation` — the per-step marker (``train#<step>``), which
  groups a capture's device activity by optimizer step;
- :func:`scope` — a range around the phases inside one step (grad-sync
  tiers, grad-accum microbatches, pipeline ticks).

On the TPU ``scope`` is a trace-time ``named_scope`` that costs nothing
at run time.  Here all three are ``torch.profiler.record_function``
ranges opened at run time: each call costs host time (a few
microseconds, profiler or not), so they sit exactly where the JAX
package puts its scopes and nowhere else.  A capture (``--profile-dir``)
records them as ``user_annotation`` events.

:func:`phase_span` brackets host-side phases with BOTH a range and a
``SpanRecorder`` span (obs/spans.py), so the exported timeline
(``tools/trace_export.py``) and a live profiler capture name the same
work the same way.
"""

from __future__ import annotations

from contextlib import contextmanager

from torch.profiler import record_function

# The canonical annotation vocabulary (tests pin it equal to the JAX
# package's: renames are deliberate).
PHASES = (
    "train/step",            # one optimizer step (host span + step marker)
    "train/eval",            # eval pass batches
    "grad_accum/microbatch",  # fwd+bwd of one accumulation microbatch
    "grad_sync/rs_ici",      # tier 1: reduce-scatter within a node
    "grad_sync/ar_dcn",      # tier 2: cross-node all-reduce
    "grad_sync/ag_ici",      # tier 3: all-gather within a node
    "grad_sync/stripe",      # multi-path lane rotation around the DCN hop
    "pipeline/tick",         # one pipeline schedule tick
    "serve/prefill",         # engine chunked-prefill step
    "serve/decode",          # engine decode step
    "serve/verify",          # engine speculative multi-token verify step
)


def annotate(name: str):
    """Host range named ``name`` (see :data:`PHASES`)."""
    return record_function(name)


def step_annotation(step_num: int, name: str = "train"):
    """Per-step marker: groups device activity under step rows."""
    return record_function(f"{name}#{int(step_num)}")


def scope(name: str):
    """Range around a phase inside one step (see the module docstring)."""
    return record_function(name)


@contextmanager
def phase_span(spans, name: str, *, corr=None, **attrs):
    """One host-side phase, visible to BOTH timelines: a profiler range
    (live captures) and a recorded span on ``spans`` (a
    :class:`~.spans.SpanRecorder`, or None — then this is just
    :func:`annotate`)."""
    if spans is None:
        with record_function(name):
            yield None
        return
    with record_function(name), spans.span(name, corr=corr, **attrs) as s:
        yield s
