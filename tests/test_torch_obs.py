"""The port's telemetry spine (``pytorch_distributed_training_tpu_torch/
obs/``) against the JAX package's, on the CPU.

- The constant tuples, the metric registry and the exported names equal
  JAX's.
- The emitter, driven through the same calls under one injected clock,
  writes JAX's event log byte for byte (jsonl and tsv); ``percentiles``
  and ``validate_events`` (JAX's v1-v4 fixtures and malformed logs) give
  JAX's results; the flight recorder's events, ``merge_timeline`` and
  ``straggler_report`` equal JAX's on the same rank logs.
- The byte models (``dcn_step_counters`` on the configurations of JAX's
  ``tests/test_obs.py``, ``pp_step_counters``, the KV models, the
  activation estimates) equal JAX's; the sync wall model equals JAX's
  formula over the port's link constants; the flop probe counts a
  step's products exactly and launches nothing.
- The CLI: the port's and JAX's event streams of the same tiny GPT-2
  training and serving runs match in kinds, names, steps and field sets,
  their analytic fields are equal, and the JAX package's
  ``tools/telemetry_report.py`` and ``tools/trace_export.py`` read the
  port's logs; three steps with and without the telemetry flags are
  bitwise equal; the flag refusals exit 2 with JAX's messages.

The JAX CLI runs once for training and once for serving
(``tests/torch_shared.py``).
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import pytorch_distributed_training_tpu.obs as jobs
import pytorch_distributed_training_tpu_torch.obs as tobs
from pytorch_distributed_training_tpu.cli.main import main as jax_cli
from pytorch_distributed_training_tpu_torch.cli.main import main as cli
from tests.torch_shared import shared

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = ("num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,"
        "max_seq_len=64")
TRAIN_ARGV = ["--use-cpu", "--model", "gpt2", "--dataset",
              "synthetic-tokens", "--seq-len", "32", "--model-overrides",
              TINY, "--batch-size", "8", "--accum-steps", "2",
              "--steps-per-epoch", "3", "--learning-rate", "1e-3",
              "--num-workers", "0"]
SERVE_ARGV = ["--serve", "--use-cpu", "--model", "gpt2", "--seq-len", "32",
              "--model-overrides", TINY, "--serve-requests", "6",
              "--serve-slots", "2", "--serve-max-new", "8", "--serve-paged",
              "--serve-spec"]


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# --- constants, registry, names --------------------------------------------

@pytest.mark.parametrize("name", [
    "SCHEMA_VERSION", "SUPPORTED_SCHEMA_VERSIONS", "EVENT_KINDS",
    "ALERT_STATES", "PHASES", "SPAN_NAMES", "LEDGER_CATEGORIES",
    "PROMOTED_ANOMALIES", "METRIC_SCHEMA", "BACKOFF_ENV",
])
def test_constants_equal_jax(name):
    assert getattr(tobs, name) == getattr(jobs, name)


def test_exported_names_cover_jax():
    assert set(jobs.__all__) <= set(tobs.__all__)


@pytest.mark.parametrize("name,method", [
    ("mfu_live", "gauge"), ("ttft_s[tenant=a]", "observe"),
    ("kv_blocks_in_use_r1", "gauge"), ("ledger_compile_s", "gauge"),
    ("rejected_requests", "counter_add"), ("ttft_s", "gauge"),
    ("no_such_metric", "observe"), ("mfu_live[x=1]", "gauge"),
])
def test_check_metric_name_equals_jax(name, method):
    assert tobs.check_metric_name(name, method) == \
        jobs.check_metric_name(name, method)


# --- percentiles, emitter, validation ---------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentiles_equal_jax(seed):
    rng = np.random.default_rng(seed)
    xs = [float(x) for x in rng.exponential(1.0, 37)] + [None, None]
    for qs in ((50, 99), (50.0, 90, 99.9), (0, 100)):
        assert tobs.percentiles(xs, qs) == jobs.percentiles(xs, qs)
    assert tobs.percentiles([None]) == jobs.percentiles([None])


def _drive(mod, directory, fmt):
    clock = Clock(10.0)
    em = mod.MetricsEmitter(str(directory), rank=3, world=4, log_format=fmt,
                            clock=clock, meta={"unix_time": 0.0,
                                               "mode": "train"})
    em.set_step_counters({"dcn_bytes": 128.0, "dcn_syncs": 2.0})
    rng = np.random.default_rng(0)
    for step in range(6):
        clock.t += 0.125
        em.counter_add("generated_tokens", float(step))
        em.gauge("serve_slots_active", step % 3)
        em.observe("ttft_s", float(rng.exponential(0.05)))
        em.step(step, dt=0.125, loss=float(rng.normal()))
        if step == 3:
            em.anomaly("nonfinite_loss", step=step)
            em.phase("epoch_end", epoch=0)
    em.heartbeat(step=5)
    em.summary(extra={"a": [1, 2]})
    em.close()
    with open(em.path) as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["jsonl", "tsv"])
def test_emitter_log_is_jax_byte_for_byte(tmp_path, fmt):
    got = _drive(tobs, tmp_path / "port", fmt)
    want = _drive(jobs, tmp_path / "jax", fmt)
    assert got == want and len(got) > 500


def test_emitter_disabled_and_default_rank(tmp_path):
    em = tobs.MetricsEmitter(None)
    em.step(0, dt=1.0)
    assert not em.enabled and em.path is None and em.summary() is None
    em = tobs.MetricsEmitter(str(tmp_path))
    em.close()
    head = tobs.read_events(em.path)[0]
    assert head["rank"] == 0 and head["world"] == 1
    assert os.path.basename(em.path) == "events.rank00000.jsonl"


def _schema_logs() -> dict:
    v2 = jobs.read_events(os.path.join(FIXTURES, "v2_metrics_dir",
                                       "events.rank00000.jsonl"))
    v3 = jobs.read_events(os.path.join(FIXTURES, "v3_metrics_dir",
                                       "events.rank00000.jsonl"))
    v1 = [dict(ev, v=1) for ev in v2]
    v1[0] = dict(v1[0], schema=1)
    v4 = [dict(ev, v=4) for ev in v3]
    v4[0] = dict(v4[0], schema=4)
    v4.append({"v": 4, "t": v4[-1]["t"] + 1, "rank": 0, "kind": "alert",
               "alert": "ttft_p99", "state": "firing"})
    t = v3[-1]["t"]
    return {
        "v1": v1, "v2": v2, "v3": v3, "v4": v4,
        "alert_in_v3": v3 + [{"v": 3, "t": t + 1, "rank": 0,
                              "kind": "alert", "alert": "x",
                              "state": "firing"}],
        "bad_state": v4 + [{"v": 4, "t": t + 9, "rank": 0, "kind": "alert",
                            "alert": "x", "state": "maybe"}],
        "span_t1_before_t0": v3 + [{"v": 3, "t": t + 1, "rank": 0,
                                    "kind": "span", "span": "s", "sid": 1,
                                    "t0": 2.0, "t1": 1.0, "dur": -1.0}],
        "no_meta": v2[1:],
        "bad_kind": v2 + [{"v": 2, "t": t + 1, "rank": 0, "kind": "nope"}],
        "other_rank": v2 + [{"v": 2, "t": t + 1, "rank": 5,
                             "kind": "heartbeat"}],
        "time_regressed": v2 + [{"v": 2, "t": -1.0, "rank": 0,
                                 "kind": "heartbeat"}],
        "step_not_int": v2 + [{"v": 2, "t": t + 1, "rank": 0,
                               "kind": "step", "step": 1.5}],
        "empty": [],
        "schema_9": [dict(v2[0], schema=9)],
    }


@pytest.mark.parametrize("name", list(_schema_logs()))
def test_validate_events_equals_jax(name):
    events = _schema_logs()[name]

    def outcome(fn):
        try:
            fn([dict(e) for e in events])
            return "ok"
        except ValueError as e:
            return str(e)

    got, want = outcome(tobs.validate_events), outcome(jobs.validate_events)
    assert got == want
    assert (got == "ok") == (name in ("v1", "v2", "v3", "v4"))


def test_read_events_tolerates_only_a_torn_tail(tmp_path):
    path = tmp_path / "events.rank00000.jsonl"
    path.write_text('{"a": 1}\n{"b": 2}\n{"c": ')
    assert tobs.read_events(str(path), allow_truncated=True) == \
        jobs.read_events(str(path), allow_truncated=True)
    with pytest.raises(json.JSONDecodeError):
        tobs.read_events(str(path))


# --- flight recorder, rank merge --------------------------------------------

def _flight(mod, directory):
    clock = Clock()
    em = mod.MetricsEmitter(str(directory), rank=0, world=1, clock=clock,
                            meta={"unix_time": 0.0})
    rec = mod.FlightRecorder(em, grad_spike_z=4.0)
    rec.check_step(0, {"loss": float("nan")})
    for i in range(20):
        clock.t += 0.5
        rec.check_step(i + 1, {"loss": 1.0, "grad_norm": 1.0 + 0.01 * i,
                               "dt": 0.1, "skipped": 0})
    rec.check_step(30, {"loss": 1.0, "grad_norm": 100.0, "dt": 0.5,
                        "skipped": 2})
    rec.check_queue(9, max_queue=10)
    rec.check_queue(1, max_queue=10)
    em.close()
    with open(em.path) as f:
        return f.read()


def test_flight_recorder_events_equal_jax(tmp_path):
    got = _flight(tobs, tmp_path / "p")
    assert got == _flight(jobs, tmp_path / "j")
    kinds = [e.get("anomaly") for e in map(json.loads, got.splitlines())]
    assert "grad_norm_spike" in kinds and "queue_saturation" in kinds


def _rank_logs(directory):
    for rank, dts in ((0, [0.01] * 6), (1, [0.02] * 5), (2, [0.011] * 6)):
        clock = Clock(100.0 * rank)
        em = tobs.MetricsEmitter(str(directory), rank=rank, world=3,
                                 clock=clock)
        em.set_step_counters({"dcn_bytes": 64.0})
        for step, dt in enumerate(dts):
            clock.t += dt
            em.step(step, dt=dt, loss=1.0)
            if rank == 1 and step == 3:
                em.anomaly("nonfinite_loss", step=step)
        em.summary()
        em.close()


def test_merge_timeline_and_stragglers_equal_jax(tmp_path):
    _rank_logs(tmp_path)
    logs_t = tobs.load_rank_logs(str(tmp_path))
    logs_j = jobs.load_rank_logs(str(tmp_path))
    assert logs_t == logs_j and sorted(logs_t) == [0, 1, 2]
    tl_t, tl_j = tobs.merge_timeline(logs_t), jobs.merge_timeline(logs_j)
    assert tl_t == tl_j and [r["step"] for r in tl_t] == list(range(6))
    for thr in (1.25, 1.5, 3.0):
        assert tobs.straggler_report(tl_t, skew_threshold=thr) == \
            jobs.straggler_report(tl_j, skew_threshold=thr)
    assert tobs.straggler_report(tl_t)["stragglers"] == [1]


# --- cost: mfu, peaks, byte models -------------------------------------------

def test_mfu_and_peaks():
    for args in ((1e12, 0.5, 4e12), (1e12, 0.0, 4e12), (1e12, 0.5, None)):
        assert tobs.mfu(*args) == jobs.mfu(*args)
    assert tobs.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert tobs.peak_flops_for("NVIDIA H100 PCIe") == 756e12
    assert tobs.peak_flops_for("TPU v5 lite") is None
    assert tobs.peak_flops_for("NVIDIA A10") is None
    assert tobs.memory_stats("cpu") is None


class _Layout:
    """A JAX ``GradSync``'s layout seen by the port's ``GradSync``
    accounting methods."""

    def __init__(self, jsync):
        from pytorch_distributed_training_tpu_torch.comm import (
            hierarchical as th,
        )

        self._m = th.GradSync
        self.layout = types.SimpleNamespace(padded=jsync.layout.padded,
                                            n_buckets=jsync.layout.n_buckets)
        self.n_slices, self.ici_size = jsync.n_slices, jsync.ici_size
        self.config = types.SimpleNamespace(mode=jsync.config.mode,
                                            topk_frac=jsync.config.topk_frac)
        self.stripe = jsync.stripe
        self.overlap = jsync.overlap

    def dcn_bytes_per_sync(self):
        return self._m.dcn_bytes_per_sync(self)

    def ici_bytes_per_sync(self):
        return self._m.ici_bytes_per_sync(self)

    def syncs_per_step(self, n):
        return self._m.syncs_per_step(self, n)


@pytest.mark.parametrize("mode", [
    "flat", "hier", "hier-bf16", "hier-int8", "hier-int4", "hier-topk",
])
def test_dcn_step_counters_equal_jax(devices8, mode):
    """JAX's ``tests/test_obs.py`` configurations: 2 slices of 4, a 64 x 64
    kernel and its bias, accumulation 3; the port's counters through its
    own ``GradSync`` accounting on the same layout, and the flat model on
    the port's mesh of 8 ranks."""
    import jax.numpy as jnp

    from pytorch_distributed_training_tpu.comm import (
        GradSync, GradSyncConfig, MeshConfig, make_hybrid_mesh,
    )
    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig as TMeshConfig, make_mesh,
    )

    jmesh = make_hybrid_mesh(MeshConfig(data=-1), devices=devices8,
                             n_slices=2)
    params = {"w": jnp.zeros((64, 64), jnp.float32),
              "b": jnp.zeros((64,), jnp.float32)}
    if mode == "flat":
        want = jobs.dcn_step_counters(mesh=jmesh, params=params, n_slices=2,
                                      num_microbatches=3)
        got = tobs.dcn_step_counters(
            mesh=make_mesh(TMeshConfig(data=-1), world=8, rank=0),
            params={"w": torch.zeros(64, 64), "b": torch.zeros(64)},
            n_slices=2, num_microbatches=3)
    else:
        jsync = GradSync(jmesh, params, GradSyncConfig(
            mode=mode, n_slices=2, bucket_mb=0.004, topk_frac=0.25))
        want = jobs.dcn_step_counters(grad_sync=jsync, num_microbatches=3)
        got = tobs.dcn_step_counters(grad_sync=_Layout(jsync),
                                     num_microbatches=3)
    assert got == want and want["dcn_bytes"] > 0
    with pytest.raises(ValueError):
        tobs.dcn_step_counters(
            mesh=make_mesh(TMeshConfig(data=-1), world=6, rank=0),
            params={"w": torch.zeros(4)}, n_slices=4)


PP_CASES = [
    dict(schedule="1f1b", num_stages=4, num_microbatches=8,
         microbatch_rows=2, seq_len=16, hidden=32, act_itemsize=4,
         mode="int8"),
    dict(schedule="gpipe", num_stages=2, num_microbatches=4,
         microbatch_rows=4, seq_len=1024, hidden=768, act_itemsize=2,
         mode="bf16"),
    dict(schedule="interleaved", num_stages=4, num_microbatches=8,
         microbatch_rows=2, seq_len=1024, hidden=768, act_itemsize=2,
         mode="none", num_chunks=3),
]


@pytest.mark.parametrize("case", range(len(PP_CASES)))
@pytest.mark.parametrize("n_slices", [None, 2, 4])
def test_pp_step_counters_equal_jax(case, n_slices):
    kw = dict(PP_CASES[case], n_slices=n_slices)
    assert tobs.pp_step_counters(**kw) == jobs.pp_step_counters(**kw)


KV_CASES = [
    dict(num_layers=12, num_heads=12, head_dim=64, max_len=1024,
         num_slots=8, itemsize=2),
    dict(num_layers=12, num_heads=12, head_dim=64, max_len=1024,
         paged=True, num_blocks=512, block_size=16, itemsize=2, tp=2,
         index_bytes=4096),
    dict(num_layers=2, num_heads=3, head_dim=16, max_len=64, paged=True,
         num_blocks=20, block_size=8, tp=2, dtype="int8"),
    dict(num_layers=4, num_heads=4, head_dim=32, max_len=64, paged=True,
         num_blocks=9, block_size=16, dtype="int4"),
]


@pytest.mark.parametrize("case", range(len(KV_CASES)))
def test_kv_models_equal_jax(case):
    kw = KV_CASES[case]
    assert tobs.kv_pool_model_bytes(**kw) == jobs.kv_pool_model_bytes(**kw)
    block = {k: kw[k] for k in ("num_layers", "num_heads", "head_dim")}
    for dtype in (None, "bf16", "int8", "int4"):
        assert tobs.kv_block_model_bytes(**block, block_size=16,
                                         dtype=dtype) == \
            jobs.cost.kv_block_model_bytes(**block, block_size=16,
                                           dtype=dtype)
    est = dict(num_slots=8, width=16, hidden=768, num_heads=12, vocab=50257,
               mask_len=1024, paged=True, cache_bytes=10**8, itemsize=2,
               head_dim=64, kv_quant=case % 2 == 0)
    assert tobs.serve_activation_estimate(**est) == \
        jobs.serve_activation_estimate(**est)
    tr = dict(param_bytes_per_device=10**9, batch_rows_per_device=8,
              seq_len=1024, vocab=50257, itemsize=2 + case)
    assert tobs.train_activation_estimate(**tr) == \
        jobs.train_activation_estimate(**tr)


def test_tree_bytes_and_shard_factor_equal_jax():
    import jax.numpy as jnp

    mesh = types.SimpleNamespace(shape={"data": 2, "fsdp": 4, "tensor": 2})
    for spec in ((None,), ("fsdp",), ("data", None), (("data", "fsdp"),
                                                       "tensor")):
        assert tobs.spec_shard_factor(spec, mesh) == \
            jobs.spec_shard_factor(spec, mesh)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 2)}
    assert tobs.tree_bytes_per_device(
        {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    ) == jobs.tree_bytes_per_device(
        {n: jnp.zeros(s, jnp.bfloat16) for n, s in shapes.items()})


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("stripe", [1, 2])
def test_grad_sync_wall_model_is_jax_formula_on_port_links(monkeypatch,
                                                           overlap, stripe):
    """JAX's formula with the port's constants: the card's NVLink within
    a node (``obs/cost.py``) and the link of ``comm/compress.py``."""
    from pytorch_distributed_training_tpu.comm import compress as jcomp
    from pytorch_distributed_training_tpu_torch.comm import compress as tcomp
    from pytorch_distributed_training_tpu_torch.obs import cost as tcost

    monkeypatch.setattr(jobs.cost, "ICI_LATENCY_S", tcost.ICI_LATENCY_S)
    monkeypatch.setattr(jobs.cost, "ICI_BYTES_PER_S", tcost.ICI_BYTES_PER_S)
    monkeypatch.setattr(jcomp, "DCN_LATENCY_S", tcomp.LINK_LATENCY_S)
    monkeypatch.setattr(jcomp, "DCN_BYTES_PER_S", tcomp.LINK_BYTES_PER_S)
    kw = dict(ici_bytes=3.2e8, dcn_bytes=4.1e7, n_buckets=5, n_slices=2,
              ici_size=4, stripe=stripe, phase_overlap=overlap)
    assert tobs.grad_sync_wall_model(**kw) == jobs.grad_sync_wall_model(**kw)


def test_collective_census_of_a_tally():
    from pytorch_distributed_training_tpu_torch.comm import collectives

    collectives.census_start()
    collectives._tally("all-reduce", torch.zeros(8))
    collectives._tally("all-reduce", torch.zeros(4, dtype=torch.bfloat16))
    collectives._tally("collective-permute",
                       torch.zeros(6, dtype=torch.uint8))
    census = tobs.collective_census(collectives.census_stop())
    assert census == {
        "all-reduce": {"bytes": 40, "count": 2,
                       "by_dtype": {"f32": 32, "bf16": 8}},
        "collective-permute": {"bytes": 6, "count": 1,
                               "by_dtype": {"u8": 6}},
    }
    collectives._tally("all-reduce", torch.zeros(8))   # closed: no-op
    assert collectives.census_stop() == {}


def test_flop_probe_counts_products_and_launches_nothing():
    """GPT-2 at L 256 (flash-routed on the card, so ``meta`` routes it to
    the kernels' count): the probe's FLOPs are exactly the linear layers'
    forward and backward products plus each flash kernel's products over
    the causal pairs, and nothing runs or changes."""
    from pytorch_distributed_training_tpu_torch.models import create_model
    from pytorch_distributed_training_tpu_torch.ops import (
        flash_attention as fa,
    )
    from pytorch_distributed_training_tpu_torch.train import (
        create_train_state, make_policy, step_objective,
    )
    from pytorch_distributed_training_tpu_torch.train import optim

    b, l, d, h, layers, v = 2, 256, 128, 2, 2, 96
    net = create_model("gpt2", device="cpu", seed=0, cfg_overrides=dict(
        num_layers=layers, hidden_dim=d, num_heads=h, vocab_size=v,
        max_seq_len=l))
    state = create_train_state(net, optim.adamw(1e-3, weight_decay=0.0),
                               policy=make_policy("f32"))
    before = {n: p.clone() for n, p in state.params.items()}
    launches = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
                fa.flash_bwd_dkv.launches)
    rng_state = torch.get_rng_state()
    loss_fn = step_objective(state, kind="lm", policy=make_policy("f32"))
    tokens = torch.zeros((b, l), dtype=torch.int32)
    flops = tobs.count_step_flops(loss_fn, state.params, {"tokens": tokens})
    t = b * l
    linears = 3 * layers * 2 * t * 12 * d * d     # qkv, proj, fc, out
    head = 3 * 2 * t * d * v
    pairs = l * (l + 1) // 2
    attn = layers * (2 + 3 + 4) * 2 * b * h * (d // h) * pairs
    assert flops == linears + head + attn
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == launches and fa.meta_flops == 0
    assert torch.equal(torch.get_rng_state(), rng_state)
    assert all(torch.equal(before[n], p) for n, p in state.params.items())
    report = tobs.step_cost_report(flops, peak_flops=None, collectives={})
    assert report == {"flops": float(flops), "collectives": {},
                      "peak_flops": None}


# --- the CLI against JAX's -------------------------------------------------

def _run_jax(argv, directory) -> list:
    res = CliRunner().invoke(jax_cli, argv + ["--metrics-dir", directory],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return jobs.read_events(os.path.join(directory,
                                         "events.rank00000.jsonl"))


@pytest.fixture(scope="module")
def jax_train(request, tmp_path_factory):
    def compute():
        d = str(tmp_path_factory.mktemp("jax_train_tm"))
        return d, _run_jax(TRAIN_ARGV + ["--trace", "--goodput"], d)
    return shared(request, tmp_path_factory, "torch_obs_jax_train", compute)


@pytest.fixture(scope="module")
def jax_serve(request, tmp_path_factory):
    def compute():
        d = str(tmp_path_factory.mktemp("jax_serve_tm"))
        return d, _run_jax(SERVE_ARGV + ["--trace", "--slo",
                                         "ttft_p99=60s"], d)
    return shared(request, tmp_path_factory, "torch_obs_jax_serve", compute)


@pytest.fixture(scope="module")
def port_train(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_train_tm"))
    trainer = cli(TRAIN_ARGV + ["--metrics-dir", d, "--trace", "--goodput"])
    return d, tobs.read_events(os.path.join(d, "events.rank00000.jsonl")), \
        trainer


@pytest.fixture(scope="module")
def port_serve(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_serve_tm"))
    res = cli(SERVE_ARGV + ["--metrics-dir", d, "--trace", "--slo",
                            "ttft_p99=60s", "--metrics-port", "0"])
    return d, tobs.read_events(os.path.join(d, "events.rank00000.jsonl")), \
        res


def _key(e: dict) -> tuple:
    name = (e.get("record") or e.get("phase") or e.get("span")
            or e.get("anomaly") or e.get("alert"))
    return e["kind"], name, e.get("step")


def _fields(events: list) -> dict:
    out: dict = {}
    for e in events:
        out.setdefault(_key(e)[:2], set()).update(e)
    return out


# Where the port's log differs from JAX's, by design: ``compiled_cost``
# follows the first step (its census and memory come from that step),
# and has no ``bytes_accessed`` (no compiled program) and no ``memory``
# on the host.
PORT_COST_FIELDS = {"v", "t", "rank", "kind", "flops", "collectives",
                    "peak_flops"}


def test_train_stream_matches_jax(jax_train, port_train):
    _, want = jax_train
    _, got, _ = port_train
    tobs.validate_events(got)
    assert [_key(e) for e in got if e["kind"] != "compiled_cost"] == \
        [_key(e) for e in want if e["kind"] != "compiled_cost"]
    fg, fw = _fields(got), _fields(want)
    cost = fg.pop(("compiled_cost", None))
    fw.pop(("compiled_cost", None))
    assert fg == fw
    assert cost == PORT_COST_FIELDS
    kinds = [e["kind"] for e in got]
    assert kinds.index("compiled_cost") == kinds.index("step") - 1


def test_train_analytic_fields_equal_jax(jax_train, port_train):
    (_, want), (_, got, _) = jax_train, port_train
    skip = {"t", "unix_time"}
    assert {k: v for k, v in got[0].items() if k not in skip} == \
        {k: v for k, v in want[0].items() if k not in skip}
    steps_g = [e for e in got if e["kind"] == "step"]
    steps_w = [e for e in want if e["kind"] == "step"]
    assert [e["counters"] for e in steps_g] == \
        [e["counters"] for e in steps_w]
    spans_g = [e for e in got if e["kind"] == "span"]
    spans_w = [e for e in want if e["kind"] == "span"]
    assert [(e["span"], e["corr"], e.get("attrs")) for e in spans_g] == \
        [(e["span"], e["corr"], e.get("attrs")) for e in spans_w]
    led_g, led_w = got[-2], want[-2]
    assert led_g["record"] == led_w["record"] == "goodput_ledger"
    assert led_g["identity_ok"] and led_g["step_intervals"] == \
        led_w["step_intervals"] == {"compile": 1, "step_compute": 2,
                                    "rework": 0}
    assert sum(led_g["categories_ns"].values()) == led_g["wall_ns"]
    assert got[-1]["counters"] == want[-1]["counters"]
    assert sorted(got[-1]["histograms"]) == sorted(want[-1]["histograms"])
    cost = next(e for e in got if e["kind"] == "compiled_cost")
    assert cost["flops"] > 0 and cost["collectives"] == {}
    assert cost["peak_flops"] is None


def test_serve_stream_matches_jax(jax_serve, port_serve):
    _, want = jax_serve
    _, got, res = port_serve
    tobs.validate_events(got)
    fg, fw = _fields(got), _fields(want)
    assert fg == fw
    count = {}
    for e in got:
        count[_key(e)[:2]] = count.get(_key(e)[:2], 0) + 1
    n = res["summary"]["completed"]
    assert n == 6
    for name in ("serve/request", "request/queued", "request/prefill",
                 "request/decode"):
        assert count[("span", name)] == n
    assert count[("record", "request_finish")] == n
    ticks = got[-1]["counters"]["decode_ticks"]
    assert count.get(("span", "serve/decode"), 0) + \
        count.get(("span", "serve/verify"), 0) == ticks
    assert sorted(got[-1]["counters"]) == sorted(want[-1]["counters"])
    # The serve summary's keys are JAX's but the failover count
    # (``failed``), which comes with the serving fleet's modules.
    assert set(got[-1]["serve"]) == set(want[-1]["serve"]) - {"failed"}


@pytest.mark.parametrize("which", ["train", "serve"])
def test_jax_tools_read_port_logs(which, jax_train, jax_serve, port_train,
                                  port_serve, tmp_path):
    from tools.telemetry_report import build_report
    from tools.trace_export import build_trace

    port_dir = (port_train if which == "train" else port_serve)[0]
    jax_dir = (jax_train if which == "train" else jax_serve)[0]
    got, want = build_report(port_dir), build_report(jax_dir)
    assert sorted(got) == sorted(want)
    trace = build_trace(port_dir)
    assert trace["traceEvents"]
    if which == "serve":
        assert sorted(got["serving"]) == sorted(want["serving"])
        check = got["serving"]["ttft_decomposition"]["histogram_check"]
        assert check["abs_err_s"] < 1e-12
    out = subprocess.run(
        [sys.executable, "tools/telemetry_report.py", port_dir],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "telemetry report:" in out.stdout


# --- telemetry changes nothing; refusals -------------------------------------

def test_telemetry_changes_nothing(tmp_path):
    """Three steps with and without every training telemetry flag: the
    same losses and the same state, bitwise."""
    plain = cli(TRAIN_ARGV + ["--steps-per-epoch", "3"])
    flags = ["--metrics-dir", str(tmp_path / "tm"), "--trace", "--goodput",
             "--profile-dir", str(tmp_path / "prof"), "--profile-steps",
             "1:3", "--slo", "step_time_p95=1s", "--metrics-port", "0"]
    traced = cli(TRAIN_ARGV + ["--steps-per-epoch", "3", *flags])
    assert plain.last_epoch_losses == traced.last_epoch_losses
    for name, p in plain.state.params.items():
        assert torch.equal(p, traced.state.params[name]), name
    assert os.path.exists(tmp_path / "prof" / "trace.rank0.json")
    events = tobs.read_events(str(tmp_path / "tm" / "events.rank00000.jsonl"))
    phases = [e["phase"] for e in events if e["kind"] == "phase"]
    assert phases == ["epoch_start", "profile_start", "profile_stop",
                      "epoch_end"]


REFUSALS = [
    (["--profile-steps", "1:3"], "--profile-steps requires --profile-dir"),
    (["--profile-dir", "P", "--profile-steps", "x"],
     "--profile-steps must be START:STOP, got 'x'"),
    (["--profile-dir", "P", "--profile-steps", "3:3"],
     "--profile-steps window must satisfy 0 <= START < STOP, got '3:3'"),
    (["--trace"], "--trace records span events into the --metrics-dir log"),
    (["--trace", "--metrics-dir", "M", "--log-format", "tsv"],
     "--trace needs --log-format jsonl"),
    (["--goodput", "--serve", "--metrics-dir", "M"],
     "--goodput attributes a TRAINING run's wall clock"),
    (["--goodput"], "--goodput writes the goodput_ledger record into the"),
    (["--slo", "ttft_p99=1s"], "--slo/--metrics-port aggregate the "
     "telemetry spine live; pass --metrics-dir"),
    (["--metrics-port", "0"], "--slo/--metrics-port aggregate the "
     "telemetry spine live"),
    (["--slo", "nonsense", "--metrics-dir", "M"], "--slo: "),
]


@pytest.mark.parametrize("argv,message", REFUSALS)
def test_flag_refusals_exit_2_with_jax_messages(argv, message, capsys,
                                                tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli(["--use-cpu", *argv])
    assert e.value.code == 2
    err = " ".join(capsys.readouterr().err.split())
    assert message in err
    res = CliRunner().invoke(jax_cli, ["--use-cpu", *argv])
    assert res.exit_code == 2
    jax_err = " ".join(res.output.split())
    assert message in jax_err
    tail = err.split("error: ", 1)[1]
    assert tail in jax_err


def test_empty_slo_with_a_port_is_accepted(tmp_path):
    """``--slo ''`` declares no objective (JAX parses only a non-empty
    spec): the endpoint serves with an empty policy."""
    trainer = cli(TRAIN_ARGV + ["--steps-per-epoch", "1", "--metrics-dir",
                                str(tmp_path), "--slo", "",
                                "--metrics-port", "0"])
    assert trainer.state.step == 1
