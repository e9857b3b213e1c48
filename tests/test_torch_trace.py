"""Spans and phase ranges of the port (``obs/spans.py``, ``obs/trace.py``)
against the JAX package's, on the CPU.

- The span vocabulary and phase names equal JAX's; the per-correlation-id
  sampling picks JAX's ids at every rate; a recorder driven through the
  same calls writes JAX's span events byte for byte.
- The scheduler's request chains on a tiny GPT-2 served from the paged
  pool with speculative decoding: every request's chain is whole (also
  under sampling: whole or absent), the engine's tick spans equal its
  decode-tick counter, the TTFT decomposition equals JAX's on the same
  log and sums to each request's TTFT, and ``tools/trace_export.py``
  builds a valid timeline with one flow per request.
- The trainer's ``train/step`` spans carry the step's anatomy and their
  ``train/host_sync``, ``train/snapshot`` and ``train/checkpoint``
  children; a ``torch.profiler`` capture of a step holds the step
  marker, one ``grad_accum/microbatch`` range a microbatch, and the
  engine's ``serve/*`` ranges.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import pytorch_distributed_training_tpu.obs as jobs
import pytorch_distributed_training_tpu.obs.trace as jtrace
import pytorch_distributed_training_tpu_torch.obs as tobs
import pytorch_distributed_training_tpu_torch.obs.trace as ttrace
from pytorch_distributed_training_tpu_torch.cli.main import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TINY = dict(num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
            max_seq_len=64)


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_vocabulary_equals_jax():
    assert ttrace.PHASES == jtrace.PHASES
    assert tobs.SPAN_NAMES == jobs.SPAN_NAMES
    assert set(ttrace.PHASES) <= set(tobs.SPAN_NAMES) | {
        "train/eval", "grad_accum/microbatch", "grad_sync/rs_ici",
        "grad_sync/ar_dcn", "grad_sync/ag_ici", "grad_sync/stripe",
        "pipeline/tick"}


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.37, 0.5, 0.9, 1.0])
def test_sampling_equals_jax(rate, tmp_path):
    ids = list(range(300)) + [f"req-{i}" for i in range(50)] + [(1, 2)]
    picked = []
    for mod in (tobs, jobs):
        em = mod.MetricsEmitter(str(tmp_path / mod.__name__), rank=0)
        rec = mod.SpanRecorder(em, sample_rate=rate)
        picked.append([c for c in ids if rec.sampled(c)])
        em.close()
    assert picked[0] == picked[1]
    if 0 < rate < 1:
        assert 0 < len(picked[0]) < len(ids)


def _spans(mod, directory):
    clock = Clock(1.0)
    em = mod.MetricsEmitter(str(directory), rank=0, clock=clock,
                            meta={"unix_time": 0.0})
    rec = mod.SpanRecorder(em, sample_rate=0.5, flush_every=3)
    for rid in range(8):
        root = rec.start_span("serve/request", corr=rid, tenant=None,
                              replica=rid % 2, prompt_len=np.int64(5))
        clock.t += 0.25
        rec.record_span("request/queued", clock.t - 0.25, clock.t,
                        corr=rid, parent=root)
        with rec.span("serve/prefill", slots=[[0, rid, 4]]) as s:
            clock.t += 0.125
            if s is not None:
                s.attrs["extra"] = (1, 2.5)
        rec.end_span(root, generated=3, finish_reason="length")
    with pytest.raises(ValueError, match="already ended"):
        span = rec.start_span("train/step", corr=None)
        rec.end_span(span)
        rec.end_span(span)
    rec.close()
    em.close()
    with open(em.path) as f:
        return f.read(), rec.recorded, rec.sampled_out


def test_span_events_are_jax_byte_for_byte(tmp_path):
    got = _spans(tobs, tmp_path / "p")
    assert got == _spans(jobs, tmp_path / "j")
    assert got[1] > 0 and got[2] > 0


def _engine(spec_k=4):
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.serve import ServingEngine

    net = create_model("gpt2", device="cpu", seed=0, cfg_overrides=TINY)
    return ServingEngine(net, num_slots=2, max_len=64, prefill_chunk=8,
                         spec_k=spec_k, device="cpu", paged=True,
                         block_size=8)


def _serve(directory, sample_rate=1.0):
    """Eight requests through the port's scheduler, traced: (events,
    scheduler)."""
    from pytorch_distributed_training_tpu_torch.serve import (
        ContinuousScheduler, Request,
    )

    em = tobs.MetricsEmitter(str(directory), rank=0)
    spans = tobs.SpanRecorder(em, sample_rate=sample_rate)
    sched = ContinuousScheduler(_engine(), max_queue=16, emitter=em,
                                spans=spans)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 256, int(n)).astype(np.int32), 6,
                    arrival_time=0.0)
            for i, n in enumerate(rng.integers(3, 20, 8))]
    sched.run(reqs)
    spans.close()
    em.summary()
    em.close()
    return tobs.read_events(em.path), sched


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return _serve(tmp_path_factory.mktemp("served"))


def test_request_chains_complete_and_ticks_counted(served):
    events, sched = served
    tobs.validate_events(events)
    spans = tobs.span_events(events)
    by_corr: dict = {}
    for s in spans:
        if s.get("corr") is not None:
            by_corr.setdefault(s["corr"], []).append(s)
    assert sorted(by_corr) == list(range(8))
    for corr, chain in by_corr.items():
        names = sorted(s["span"] for s in chain)
        assert names == ["request/decode", "request/prefill",
                         "request/queued", "serve/request"], corr
        root = next(s for s in chain if s["span"] == "serve/request")
        assert all(s["parent"] == root["sid"] for s in chain
                   if s is not root)
    ticks = sched.engine.stats()["decode_ticks"]
    n_tick_spans = sum(s["span"] in ("serve/decode", "serve/verify")
                       for s in spans)
    assert n_tick_spans == ticks == events[-1]["counters"]["decode_ticks"]
    verify = [s for s in spans if s["span"] == "serve/verify"]
    assert verify and all("accepted" in s["attrs"] for s in verify)


def test_ttft_decomposition_equals_jax_and_sums(served):
    events, sched = served
    got = tobs.ttft_decomposition(tobs.span_events(events))
    want = jobs.ttft_decomposition(jobs.span_events(events))
    assert got == want and got["requests"] == 8
    ttft = {r["id"]: r["ttft"] for r in sched.completed}
    spans = tobs.span_events(events)
    for rid, t in ttft.items():
        q = next(s for s in spans if s["span"] == "request/queued"
                 and s["corr"] == rid)["dur"]
        p = next(s for s in spans if s["span"] == "request/prefill"
                 and s["corr"] == rid)["dur"]
        assert q + p == pytest.approx(t, rel=1e-12, abs=1e-12)
    hist = events[-1]["histograms"]["ttft_s"]
    assert hist["count"] == 8
    assert hist["p50"] == pytest.approx(got["ttft_s"]["p50"], abs=1e-12)


def test_sampled_chains_are_whole_or_absent(tmp_path):
    events, _ = _serve(tmp_path, sample_rate=0.5)
    rec = tobs.SpanRecorder(tobs.MetricsEmitter(None), sample_rate=0.5)
    chains: dict = {}
    for s in tobs.span_events(events):
        if s.get("corr") is not None:
            chains.setdefault(s["corr"], 0)
            chains[s["corr"]] += 1
    want = [i for i in range(8) if jobs.SpanRecorder(
        jobs.MetricsEmitter(str(tmp_path / "j"), rank=0),
        sample_rate=0.5).sampled(i)]
    assert sorted(chains) == want and all(n == 4 for n in chains.values())
    assert rec.sampled(3) is False   # a disabled recorder samples nothing


def test_trace_export_reads_port_log(served, tmp_path):
    from tools.trace_export import build_trace, validate_chrome_trace

    events, _ = served
    directory = tmp_path / "tm"
    directory.mkdir()
    with open(directory / "events.rank00000.jsonl", "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    trace = build_trace(str(directory))
    validate_chrome_trace(trace)
    starts = {e["id"] for e in trace["traceEvents"] if e.get("ph") == "s"}
    assert len(starts) == 8


def test_train_step_spans_and_children(tmp_path):
    tm = tmp_path / "tm"
    cli(["--use-cpu", "--model", "gpt2", "--dataset", "synthetic-tokens",
         "--seq-len", "32", "--model-overrides",
         ",".join(f"{k}={v}" for k, v in TINY.items()),
         "--batch-size", "8", "--accum-steps", "2", "--steps-per-epoch",
         "4", "--num-workers", "0", "--learning-rate", "1e-3",
         "--skip-bad-steps", "--snapshot-every-steps", "2",
         "--checkpoint-dir", str(tmp_path / "ck"), "--ckpt-every-steps",
         "2", "--metrics-dir", str(tm), "--trace"])
    spans = tobs.span_events(tobs.read_events(
        str(tm / "events.rank00000.jsonl")))
    steps = {s["sid"]: s for s in spans if s["span"] == "train/step"}
    assert [s["corr"] for s in steps.values()] == [0, 1, 2, 3]
    assert all(s["attrs"] == {"microbatches": 2, "grad_sync": "flat"}
               for s in steps.values())
    kids = {}
    for s in spans:
        if s["span"] != "train/step":
            assert s["parent"] in steps, s
            kids.setdefault(s["span"], []).append(
                steps[s["parent"]]["corr"])
    # The log point at step 0; a snapshot bracket every step (the
    # manager stages at its own cadence inside it, as in JAX); the
    # checkpoints after steps 2 and 4 (indices 1, 3).
    assert kids == {"train/host_sync": [0], "train/snapshot": [0, 1, 2, 3],
                    "train/checkpoint": [1, 3]}


def test_profiler_ranges(tmp_path):
    """One ``grad_accum/microbatch`` range a microbatch and the step
    marker around each step; the engine's ``serve/prefill`` and
    ``serve/decode`` ranges: the phase names a capture carries."""
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.train import (
        Trainer, TrainerConfig, create_train_state, make_policy,
        make_train_step, optim,
    )

    net = create_model("gpt2", device="cpu", seed=0, cfg_overrides=TINY)
    state = create_train_state(net, optim.adamw(1e-3, weight_decay=0.0),
                               policy=make_policy("f32"))
    step = make_train_step(kind="lm", num_microbatches=2)
    trainer = Trainer(state, step, torch.device("cpu"),
                      TrainerConfig(prefetch=0, profile_dir=str(tmp_path),
                                    profile_steps=(1, 3)))
    batch = {"tokens": np.random.default_rng(0).integers(
        0, 256, (4, 16)).astype(np.int64)}
    trainer.run_epoch([batch] * 4)
    with open(tmp_path / "trace.rank0.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    assert names.count("grad_accum/microbatch") == 4
    assert {"train#1", "train#2"} <= set(names)
    assert "train#0" not in names and "train#3" not in names
    engine = _engine(spec_k=0)
    engine.start(0, np.arange(5, dtype=np.int32), 3)
    with torch.profiler.profile() as prof:
        engine.step()
        engine.step()
    keys = {e.key for e in prof.key_averages()}
    assert {"serve/prefill", "serve/decode"} <= keys
