"""The port's live plane (``obs/live.py``, ``obs/slo.py``, ``obs/http.py``)
against the JAX package's, on the CPU.

- The fixed-log bucket geometry, the bucket counts of a stream, their
  quantiles and merges, and the metric-name labels equal JAX's.
- ``parse_slo_spec`` gives JAX's objectives and refuses what JAX
  refuses; the multi-window burn-rate trace under a virtual clock
  (JAX's ``tests/test_live.py`` breach) fires and clears at JAX's ticks
  with JAX's alert log; the ratio objective and the promoted anomalies
  equal JAX's.
- ``render_prometheus``'s text, the aggregator's snapshot and the
  ``/metrics``, ``/healthz`` and ``/slo`` bodies of the port's endpoint
  equal JAX's over the same stream; staleness flips ``/healthz`` to 503.
- The tiny serving run's live TTFT quantile equals the offline reduction
  of its log.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import pytorch_distributed_training_tpu.obs as jobs
import pytorch_distributed_training_tpu_torch.obs as tobs


class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _live(mod, directory, clock, objectives="", **policy_kw):
    em = mod.MetricsEmitter(str(directory), rank=0, world=1, clock=clock,
                            meta={"unix_time": 0.0})
    agg = mod.LiveAggregator(clock=clock)
    pol = mod.SLOPolicy(agg, mod.parse_slo_spec(objectives)
                        if objectives else [], emitter=em, **policy_kw)
    em.attach_sink(agg)
    em.attach_sink(pol)
    return em, agg, pol


# --- buckets, quantiles, names -----------------------------------------------

VALUES = [1e-9, 1e-6, 0.00025, 0.04, 0.25, 1.0, 3.7, 1e4, 123456.0]


def test_bucket_geometry_equals_jax():
    for v in VALUES:
        assert tobs.bucket_index(v) == jobs.bucket_index(v)
    for mod in (tobs, jobs):
        with pytest.raises(ValueError, match="wants value > 0"):
            mod.bucket_index(0.0)
    for i in range(-200, 200, 7):
        assert tobs.bucket_upper(i) == jobs.bucket_upper(i)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bucket_counts_quantiles_and_merge_equal_jax(seed):
    rng = np.random.default_rng(seed)
    xs = [float(x) for x in rng.lognormal(-3, 1.5, 400)] + [0.0, 0.0]
    counts = tobs.bucket_counts_of(xs)
    assert counts == jobs.bucket_counts_of(xs)
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert tobs.quantile_from_buckets(counts, q) == \
            jobs.quantile_from_buckets(counts, q)
    halves = [tobs.FixedLogHistogram(), tobs.FixedLogHistogram()]
    whole = jobs.FixedLogHistogram()
    for i, x in enumerate(xs):
        halves[i % 2].add(x)
        whole.add(x)
    merged = halves[0].merge(halves[1])
    assert merged.bucket_counts() == whole.bucket_counts() == counts
    assert merged.quantile(99) == whole.quantile(99)
    assert merged.count_above(0.05) == whole.count_above(0.05)


@pytest.mark.parametrize("name,labels", [
    ("ttft_s", {}), ("ttft_s", {"tenant": "acme"}),
    ("tpot_s", {"tenant": "a b", "replica": 2}), ("generated_tokens",
                                                  {"replica": 0}),
])
def test_labels_roundtrip_equal_jax(name, labels):
    got = tobs.labeled(name, **labels)
    assert got == jobs.labeled(name, **labels)
    assert tobs.parse_metric_name(got) == jobs.parse_metric_name(got)
    for raw in ("kv_blocks_in_use_r3", "serve_slots_active", "x[a=1,b=2]"):
        assert tobs.parse_metric_name(raw) == jobs.parse_metric_name(raw)


# --- SLO specs, burn rates, alerts -------------------------------------------

@pytest.mark.parametrize("spec", [
    "ttft_p99=250ms", "ttft_p99=250ms,tpot_p99=40ms,goodput=0.99",
    "step_time_p95=1.5s", "ttft_p99[interactive]=250ms,goodput=0.9",
    "tpot_p50=2ms", "nonsense", "ttft_p99=", "goodput=1.5",
    "ttft_p120=1s", "bogus_p99=1s",
])
def test_parse_slo_spec_equals_jax(spec):
    def outcome(mod):
        try:
            return [dataclasses.asdict(o) for o in mod.parse_slo_spec(spec)]
        except ValueError as e:
            return f"ValueError: {e}"

    assert outcome(tobs) == outcome(jobs)


def _breach(mod, directory):
    """JAX's breach trace: a 1 s sample stream with two bad TTFTs at
    t = 13, 14 under fast 4 s / slow 12 s windows."""
    clock = Clock()
    em, agg, pol = _live(mod, directory, clock, "ttft_p99=250ms",
                         fast_window_s=4.0, slow_window_s=12.0)
    transitions = []
    for t in range(1, 25):
        clock.t = float(t)
        em.observe("ttft_s", 1.0 if t in (13, 14) else 0.01)
        transitions += [(tr["t"], tr["state"]) for tr in pol.evaluate()]
    em.close()
    with open(em.path) as f:
        return transitions, pol.alert_log, mod.reduce_alerts(
            pol.alert_log), f.read()


def test_burn_rate_trace_equals_jax(tmp_path):
    got = _breach(tobs, tmp_path / "p")
    assert got == _breach(jobs, tmp_path / "j")
    assert got[0] == [(14.0, "firing"), (19.0, "ok")]
    assert got[2]["objectives"]["ttft_p99"]["time_in_violation_s"] == 5.0


def test_goodput_objective_equals_jax(tmp_path):
    out = []
    for mod in (tobs, jobs):
        clock = Clock(1.0)
        em, agg, pol = _live(mod, tmp_path / mod.__name__, clock,
                             "goodput=0.9", fast_window_s=4.0,
                             slow_window_s=8.0)
        em.counter_add("finished_requests", 1)
        em.counter_add("shed_requests", 1)
        em.counter_add("rejected_requests", 1)
        (obj,) = pol.objectives
        out.append((pol.burn_rate(obj, 4.0, 1.0),
                    pol.burn_rate(obj, 4.0, 100.0), pol.evaluate(),
                    pol.snapshot()))
        em.close()
    assert out[0] == out[1]
    assert out[0][1] == 0.0


def _promoted(mod, directory):
    clock = Clock(1.0)
    em, agg, pol = _live(mod, directory, clock)
    rec = mod.FlightRecorder(em)
    rec.check_queue(10, 10)
    rec.check_queue(10, 10)
    for step in range(10):
        rec.check_step(step, {"grad_norm": 1.0, "dt": 0.1})
    rec.check_step(10, {"grad_norm": 100.0})
    rec.check_step(11, {"dt": 0.9})
    rec.check_step(12, {"loss": float("nan")})
    em.close()
    with open(em.path) as f:
        return f.read(), agg.counter("anomaly_alerts"), \
            mod.reduce_alerts(pol.alert_log), mod.PROMOTED_ANOMALIES


def test_promoted_anomalies_equal_jax(tmp_path):
    got = _promoted(tobs, tmp_path / "p")
    assert got == _promoted(jobs, tmp_path / "j")
    assert got[1] == 5


# --- aggregator, Prometheus text, the endpoint ---------------------------------

def _stream(mod, directory, clock):
    em, agg, pol = _live(mod, directory, clock, "ttft_p99=250ms,goodput=0.9")
    rng = np.random.default_rng(7)
    for tick in range(40):
        clock.advance(0.5)
        for view in ({}, {"tenant": "acme"}, {"replica": tick % 2}):
            em.observe(mod.labeled("ttft_s", **view),
                       float(rng.exponential(0.1)))
            em.counter_add(mod.labeled("generated_tokens", **view), 3)
        em.counter_add("finished_requests", 1)
        em.gauge(f"kv_blocks_in_use_r{tick % 2}", tick)
        em.gauge("serve_slots_active", tick % 4)
        em.heartbeat()
        pol.evaluate()
    return em, agg, pol


def test_snapshot_and_prometheus_text_equal_jax(tmp_path):
    snaps, texts = [], []
    for mod in (tobs, jobs):
        em, agg, pol = _stream(mod, tmp_path / mod.__name__, Clock(5.0))
        snaps.append((agg.snapshot(), pol.snapshot(), agg.healthz()))
        texts.append(mod.render_prometheus(agg.snapshot()))
        em.close()
    assert snaps[0] == snaps[1]
    assert texts[0] == texts[1]
    assert 'ttft_s_bucket{le="+Inf",tenant="acme"}' in texts[0]


def test_ops_endpoint_bodies_equal_jax(tmp_path):
    bodies = []
    for mod in (tobs, jobs):
        clock = Clock(5.0)
        em, agg, pol = _stream(mod, tmp_path / mod.__name__, clock)
        em.close()
        srv = mod.OpsServer(agg, pol, port=0, stale_after_s=10.0).start()
        try:
            assert srv.url.startswith("http://127.0.0.1:")
            got = {p: _fetch(srv.url + p)
                   for p in ("/metrics", "/healthz", "/slo", "/nope")}
            clock.advance(100.0)
            got["stale"] = _fetch(srv.url + "/healthz")[0]
        finally:
            srv.stop()
        bodies.append(got)
    port, jax = bodies
    assert port == jax
    assert port["/metrics"][0] == port["/healthz"][0] == \
        port["/slo"][0] == 200
    assert port["/nope"][0] == 404 and port["stale"] == 503
    assert json.loads(port["/slo"][1])["objectives"][0]["name"] == \
        "ttft_p99"


def test_live_ttft_quantile_equals_offline_log(tmp_path):
    """The serving run of the port's scheduler: the aggregator's
    whole-stream TTFT p99 equals the quantile of the summary's bucket
    counts read back from the log (what ``tools/telemetry_report.py``
    recomputes), and the SLO snapshot reports the same number."""
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.serve import (
        ContinuousScheduler, Request, ServingEngine,
    )

    em, agg, pol = _live(tobs, tmp_path, __import__("time").monotonic,
                         "ttft_p99=60s")
    net = create_model("gpt2", device="cpu", seed=0, cfg_overrides=dict(
        num_layers=2, hidden_dim=64, num_heads=2, vocab_size=256,
        max_seq_len=64))
    engine = ServingEngine(net, num_slots=2, max_len=64, prefill_chunk=8,
                           device="cpu")
    sched = ContinuousScheduler(engine, max_queue=8, emitter=em, slo=pol)
    rng = np.random.default_rng(1)
    sched.run([Request(i, rng.integers(0, 256, 6).astype(np.int32), 5)
               for i in range(6)])
    live = agg.hist("ttft_s").quantile(99)
    slo_value = pol.snapshot()["objectives"][0]
    em.summary()
    em.close()
    summary = tobs.read_events(em.path)[-1]
    offline = tobs.quantile_from_buckets(
        summary["histograms"]["ttft_s"]["buckets"], 99)
    assert live == offline
    assert slo_value["name"] == "ttft_p99"
    assert summary["histograms"]["ttft_s"]["count"] == 6
    assert agg.counter("finished_requests") == 6
