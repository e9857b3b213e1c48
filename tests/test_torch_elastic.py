"""The port's elastic resizing (``resilience/elastic.py``,
``--elastic-resize``) and its ``analysis/`` (``findings.py``,
``ledger_audit.py``), against the JAX package's, on the CPU.

JAX's ``tests/test_elastic.py`` twinned case for case: the elastic fault
grammar and ``--inject-faults`` refusing it, the heartbeat-staleness
monitor, the one-process peer store (its buddies, its refusals, its
bit-identical restore of torch tensors in JAX's dtypes and a Python-int
count), the ``/slo`` block and the config defaults.

The episodes run over 4 gloo ranks (2 slices of 2;
``tests/torch_elastic_worker.py``) and are held to JAX's episode at 4
CPU devices, each run in a fresh process as JAX's own test runs it:
``slice_lost@4:1,slice_return@9`` (12 steps), ``slice_lost@4:0,
slice_return@9`` (rank 0's own slice lost) and ``host_hang@2:2`` (6
steps).  The reports are equal field for field except the three
byte-valued ones (``peer_snapshot_wire_bytes``,
``counters.elastic_peer_snapshot_bytes``, grow's ``wire_bytes``), which
are held to ``bucket_wire_bytes`` of the port's own blob.  That blob is
12 bytes longer than JAX's for the same model: the port's Adam count
(``opt_state/0/count``) is a Python int carried as int64 where JAX's is
an int32 array, and the port's constant learning rate keeps a count of
its own (``opt_state/1/count``) where optax's keeps an empty state.
Beyond JAX's cases: run-twice determinism from other processes without
an emitter, the three-way pin through ``tools/telemetry_report.py`` on
the port's event log, the final parameters within 1e-5 (relative L2)
of an uninterrupted run of the same 12 global batches, and the grow's
transfer over a group that leaves out global rank 0 (its source a
group rank, not a global one).

The CLI under a 4-rank ``torchrun`` prints JAX's ``elastic:`` lines (JAX's
CLI at ``--cpu-devices 4``), and refuses a 2-rank world with JAX's
message.  ``run_ledger_audit()`` gives JAX's report with no finding.

The JAX references and the port's launches are computed once a run and
shared by the xdist workers (``tests/torch_shared.py``).
"""

import copy
import json
import os
import subprocess
import sys
import textwrap
import urllib.request

import pytest
import torch

import pytorch_distributed_training_tpu.resilience as jres
import pytorch_distributed_training_tpu_torch.resilience as tres
from pytorch_distributed_training_tpu.resilience.faults import (
    parse_faults as jax_parse_faults,
)
from pytorch_distributed_training_tpu_torch.resilience.faults import (
    parse_faults,
)
from tests.torch_dp_worker import launch_start
from tests.torch_shared import shared_parts

NS = 1_000_000_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS_1 = "slice_lost@4:1,slice_return@9"
CASES = {"slice1": (FAULTS_1, 12),
         "slice0": ("slice_lost@4:0,slice_return@9", 12),
         "hang": ("host_hang@2:2", 6)}
# The fields whose value is the snapshot's byte count.
BYTE_FIELDS = ("peer_snapshot_wire_bytes", "elastic_peer_snapshot_bytes",
               "wire_bytes")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------- #
# the shared runs: JAX at 4 CPU devices, the port over 4 gloo ranks
# ---------------------------------------------------------------------- #

def _jax_episode(faults: str, n_steps: int) -> dict:
    """JAX's episode at 4 simulated CPU devices in a fresh process (as
    ``tests/test_elastic.py`` runs it), and its snapshot's leaves."""
    script = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        import jax
        jax.config.update("jax_platforms", "cpu")
        from pytorch_distributed_training_tpu.compat import (
            set_cpu_device_count,
        )
        set_cpu_device_count(4)
        import jax.numpy as jnp
        import numpy as np
        import optax
        from pytorch_distributed_training_tpu.models.gpt2 import (
            GPT2, GPT2Config,
        )
        from pytorch_distributed_training_tpu.resilience import (
            run_elastic_episode,
        )
        from pytorch_distributed_training_tpu.resilience.recovery import (
            SNAPSHOT_FIELDS,
        )
        from pytorch_distributed_training_tpu.train import create_train_state
        report = run_elastic_episode(faults={faults!r}, n_steps={n_steps})
        cfg = GPT2Config(vocab_size=128, max_seq_len=16, num_layers=2,
                         num_heads=2, hidden_dim=32)
        st = create_train_state(
            GPT2(cfg=cfg), jax.random.PRNGKey(0), jnp.zeros((8, 16),
            jnp.int32), optax.adam(1e-3), init_kwargs={{"train": False}})
        leaves = jax.tree_util.tree_leaves_with_path(
            {{f: getattr(st, f) for f in SNAPSHOT_FIELDS}})
        report["leaves"] = [[jax.tree_util.keystr(p), str(np.asarray(v).dtype),
                             list(np.shape(v))] for p, v in leaves]
        report["blob_len"] = sum(np.asarray(v).nbytes for _, v in leaves)
        print("REPORT " + json.dumps(report))
    """)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": ""},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPORT ")]
    assert line, proc.stdout[-4000:]
    return json.loads(line[-1][len("REPORT "):])


def _elastic_lines(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines() if ln.startswith("elastic:")]


def _jax_cli() -> list[str]:
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_training_tpu.cli.main",
         "--use-cpu", "--cpu-devices", "4", "--elastic-resize", FAULTS_1],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return _elastic_lines(proc.stdout)


def _torchrun(n: int, *extra: str):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m",
         "pytorch_distributed_training_tpu_torch.cli.main", "--distributed",
         "--use-cpu", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=180,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def _port_cli(ckpt) -> dict:
    """The CLI at 4 ranks, then again in the same checkpoint directory
    (the fault markers fired: nothing fires again), and at 2 ranks."""
    argv = ("--elastic-resize", FAULTS_1, "--checkpoint-dir", str(ckpt))
    runs = [_torchrun(4, *argv) for _ in range(2)]
    for run in runs:
        assert run.returncode == 0, run.stdout + run.stderr[-4000:]
    two = _torchrun(2, "--elastic-resize", FAULTS_1)
    return {"lines": _elastic_lines(runs[0].stdout),
            "again": _elastic_lines(runs[1].stdout),
            "markers": sorted(os.listdir(ckpt / ".elastic_state")),
            "two_rc": two.returncode, "two_err": two.stderr}


def _port(task: str, out) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    launch_start(["tests/torch_elastic_worker.py", task, str(out)], 4,
                 timeout=300).wait()
    with open(out / f"{task}.json") as f:
        res = json.load(f)
    res["metrics"] = str(out / "metrics")
    return res


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic")
    return shared_parts(request, tmp_path_factory, "torch_elastic", {
        "jax_slice1": lambda: _jax_episode(*CASES["slice1"]),
        "port_episodes": lambda: _port("episodes", base / "episodes"),
        "jax_slice0": lambda: _jax_episode(*CASES["slice0"]),
        "port_cli": lambda: _port_cli(base / "cli_ckpt"),
        "jax_hang": lambda: _jax_episode(*CASES["hang"]),
        "port_again": lambda: _port("again", base / "again"),
        "jax_cli": _jax_cli,
    })


def _port_report(runs, case: str) -> dict:
    return runs["port_episodes"][case]


def _strip(tree):
    """``tree`` without the byte-valued fields (``BYTE_FIELDS``)."""
    if isinstance(tree, dict):
        return {k: _strip(v) for k, v in tree.items()
                if k not in BYTE_FIELDS}
    if isinstance(tree, list):
        return [_strip(v) for v in tree]
    return tree


# ---------------------------------------------------------------------- #
# fault grammar
# ---------------------------------------------------------------------- #

def _parsed(parse, spec):
    try:
        return [(f.kind, f.step, f.arg) for f in parse(spec)]
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("spec", [
    "slice_lost@4:1,slice_return@9,host_hang@2", "host_hang@2:3",
    "slice_lost@4", "slice_return@9:1", "host_hang@2:0", "host_hang@2:1.5",
    "crash@5", "slice_lost@x:1", "slice_lost@-1:0", "slice_lost@4:-1"])
def test_parse_elastic_faults_grammar(spec):
    """JAX's grammar pins, and each spec parsed (or refused, with the
    same message) as JAX's parser does."""
    got = _parsed(tres.parse_elastic_faults, spec)
    assert got == _parsed(jres.parse_elastic_faults, spec)
    if spec.startswith("slice_lost@4:1"):
        assert got == [("slice_lost", 4, 1), ("slice_return", 9, None),
                       ("host_hang", 2, 8)]
    elif spec == "host_hang@2:3":
        assert got[0][2] == 3
    else:
        assert got.startswith("ValueError")


@pytest.mark.parametrize("kind", tres.ELASTIC_FAULT_KINDS)
def test_inject_faults_rejects_elastic_kinds_loudly(kind):
    arg = ":1" if kind == "slice_lost" else ""
    with pytest.raises(ValueError, match="--elastic-resize") as got:
        parse_faults(f"{kind}@3{arg}")
    with pytest.raises(ValueError) as want:
        jax_parse_faults(f"{kind}@3{arg}")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# heartbeat-staleness monitor (detection is never exit codes)
# ---------------------------------------------------------------------- #

def _beat(mons, step, ranks):
    for r in ranks:
        for mon in mons:
            mon.ingest({"kind": "heartbeat", "step": step, "hb_rank": r})


def _monitors(*a, **kw):
    return tres.SliceHealthMonitor(*a, **kw), jres.SliceHealthMonitor(*a, **kw)


def test_monitor_declares_slice_lost_past_patience():
    mons = _monitors(8, 2, patience_steps=3, stall_flag_after=1)
    for g in range(4):
        _beat(mons, g, range(8))
    for g in range(4, 8):
        _beat(mons, g, range(4))
        verdict = mons[0].observe(g)
        assert verdict == mons[1].observe(g)
        assert verdict["lost_slices"] == ([1] if g - 3 > 3 else [])
    assert mons[0].observe(7)["lost_slices"] == [1]


def test_monitor_flags_host_stall_once_per_episode():
    mons = _monitors(8, 2, patience_steps=3, stall_flag_after=1)
    others = [r for r in range(8) if r != 3]
    _beat(mons, 0, range(8))
    _beat(mons, 1, others)
    _beat(mons, 2, others)
    for _ in range(2):
        assert [m.observe(2)["stalled_ranks"] for m in mons] == [[3], [3]]
    assert mons[0].host_stalls == mons[1].host_stalls == 1
    _beat(mons, 3, range(8))
    assert mons[0].observe(3)["stalled_ranks"] == []
    _beat(mons, 4, others)
    _beat(mons, 5, others)
    assert mons[0].observe(5)["stalled_ranks"] == [3]
    assert mons[0].host_stalls == 2


@pytest.mark.parametrize("args,kw", [((7, 2), {}),
                                     ((8, 2), dict(patience_steps=2,
                                                   stall_flag_after=3))])
def test_monitor_validates_shape(args, kw):
    with pytest.raises(ValueError) as got:
        tres.SliceHealthMonitor(*args, **kw)
    with pytest.raises(ValueError) as want:
        jres.SliceHealthMonitor(*args, **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# PeerSnapshotStore (one process): buddy mapping, drop, restore
# ---------------------------------------------------------------------- #

class _FakeState:
    """Just the snapshot fields, as torch tensors of JAX's dtypes (f32,
    int32, f64) and a Python-int count: the bit-identity pin must survive
    every one byte-exactly."""

    def __init__(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        self.params = {"w": torch.randn((5, 3), generator=g)}
        self.opt_state = {"mu": torch.randn(7, generator=g),
                          "count": torch.tensor(3, dtype=torch.int32),
                          "steps": 3}
        self.batch_stats = {"mean": torch.randn(4, generator=g,
                                                dtype=torch.float64)}
        self.grad_sync_residual = {"r": torch.randn(6, generator=g)}


def _tree_bytes(tree):
    from pytorch_distributed_training_tpu_torch.resilience.elastic import (
        _flatten,
    )

    return [(type(v).__name__, str(getattr(v, "dtype", "")),
             v.numpy().tobytes() if isinstance(v, torch.Tensor) else v)
            for _, v in _flatten(tree, "")[0]]


def test_peer_store_buddy_is_same_position_next_slice():
    store = tres.PeerSnapshotStore(8, 2)
    assert store.buddy(0) == 4 and store.buddy(4) == 0
    assert store.buddy(3) == 7 and store.buddy(7) == 3
    assert store.buddy(0, ranks=[0, 1, 2, 3]) is None
    jstore = jres.PeerSnapshotStore(8, 2)
    assert all(store.buddy(r) == jstore.buddy(r) for r in range(8))


@pytest.mark.parametrize("codec", ["bf16", "int8", "int4", "topk"])
def test_peer_store_rejects_lossy_codecs(codec):
    with pytest.raises(ValueError, match="bit-identity"):
        tres.PeerSnapshotStore(8, 2, codec=codec)


def test_peer_store_restore_survives_slice_loss_bit_identically():
    from pytorch_distributed_training_tpu_torch.comm.compress import (
        bucket_wire_bytes,
    )

    store = tres.PeerSnapshotStore(8, 2)
    state = _FakeState()
    wire = store.put(3, state)
    # 15*4 + 7*4 + 4 + 8 + 4*8 + 6*4 = 156 bytes: 8 rows of 5 f32
    # columns (160, padded).
    assert store._blob_len == 156
    assert wire == 8 * bucket_wire_bytes(5, "f32")
    assert store.total_wire_bytes == wire
    store.drop_slice(1)
    step, tree = store.restore()
    assert step == 3
    for field in ("params", "opt_state", "batch_stats",
                  "grad_sync_residual"):
        assert _tree_bytes(tree[field]) == _tree_bytes(getattr(state, field))
    assert type(tree["opt_state"]["steps"]) is int


def test_peer_store_refuses_when_both_copies_die():
    store = tres.PeerSnapshotStore(8, 2)
    store.put(3, _FakeState())
    store.drop_slice(0)
    store.drop_slice(1)
    with pytest.raises(RuntimeError, match="disk tier"):
        store.restore()


def test_peer_store_refuses_digest_mismatch():
    store = tres.PeerSnapshotStore(8, 2)
    store.put(3, _FakeState())
    rank0 = store._primary[0]
    store._primary[0] = bytes(len(rank0))  # corrupt one row in place
    with pytest.raises(RuntimeError, match="digest"):
        store.restore()
    with pytest.raises(RuntimeError, match="no committed"):
        tres.PeerSnapshotStore(8, 2).restore()


# ---------------------------------------------------------------------- #
# the episodes over 4 gloo ranks against JAX's at 4 devices
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("case", list(CASES))
def test_episode_report_equals_jax(runs, case):
    """Field for field, the byte-valued fields aside (held below)."""
    got, want = _port_report(runs, case), runs[f"jax_{case}"]
    want = {k: v for k, v in want.items() if k not in ("leaves", "blob_len")}
    assert got.keys() == want.keys()
    assert _strip(got) == _strip(want)
    assert got["ledger"]["identity_ok"]


def test_snapshot_blob_against_jax(runs):
    """The port's blob is JAX's plus the counts' encoding, and every byte
    field of every case is ``bucket_wire_bytes`` of the port's blob."""
    from pytorch_distributed_training_tpu_torch.comm.compress import (
        bucket_wire_bytes,
    )

    port, jax_ = runs["port_episodes"], runs["jax_slice1"]
    ints = [(p, d) for p, kind, d, _ in port["leaves"] if kind == "int"]
    assert ints == [("opt_state/0/count", "int64"),
                    ("opt_state/1/count", "int64")]
    jax_ints = [(p, d) for p, d, _ in jax_["leaves"] if "int" in d]
    assert len(jax_ints) == 1 and jax_ints[0][1] == "int32"
    # The same f32 leaves, laid out as each framework keeps them (torch's
    # Linear weights transposed, the qkv bias whole): equal counts of
    # elements, leaves and bytes.
    def numel(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    floats = [(d, numel(s)) for _, kind, d, s in port["leaves"]
              if kind == "tensor"]
    jax_floats = [(d, numel(s)) for _, d, s in jax_["leaves"]
                  if "int" not in d]
    assert {d for d, _ in floats} == {d for d, _ in jax_floats} == {"float32"}
    assert len(floats) == len(jax_floats)
    assert sum(n for _, n in floats) == sum(n for _, n in jax_floats)
    assert port["blob_len"] - jax_["blob_len"] == (8 - 4) + 8 == 12
    blob = port["blob_len"]
    for case in CASES:
        got, want = _port_report(runs, case), runs[f"jax_{case}"]
        jrow = -(-want["blob_len"] // 16) * 4
        row = -(-blob // 16) * 4
        full = want["peer_snapshot_wire_bytes"] // (
            4 * bucket_wire_bytes(jrow // 4, "f32"))
        assert got["peer_snapshot_wire_bytes"] == \
            full * 4 * bucket_wire_bytes(row // 4, "f32") > 0
        assert got["counters"]["elastic_peer_snapshot_bytes"] == \
            got["peer_snapshot_wire_bytes"]
        for t in got["transitions"]:
            if t["transition"] == "grow":
                assert t["wire_bytes"] == bucket_wire_bytes(-(-blob // 4),
                                                            "f32")


def test_episode_shrinks_restores_and_grows_back(runs):
    report = _port_report(runs, "slice1")
    assert report["world"] == {"initial": 4, "final": 4, "n_slices": 2}
    assert report["final_step"] == 12
    assert report["restore_bit_identical"] is True
    kinds = [(t["transition"], t["step"], t["world_from"], t["world_to"])
             for t in report["transitions"]]
    assert kinds == [("shrink", 7, 4, 2), ("peer_restore", 7, 2, 2),
                     ("grow", 9, 2, 4)]
    assert report["transitions"][0]["lost_slice"] == 1
    assert report["transitions"][0]["resumed_from_step"] == 6
    assert report["transitions"][1]["restore_source"] == "peer"
    assert report["transitions"][2]["returned_slice"] == 1
    assert report["counters"] == {
        "elastic_shrinks": 1, "elastic_grows": 1,
        "elastic_peer_restores": 1,
        "elastic_peer_snapshot_bytes": report["peer_snapshot_wire_bytes"],
        "elastic_host_stalls": report["host_stalls"],
    }
    # Rank 0's own slice lost: its report still carries the survivors'
    # restore verdict and final step.
    lost0 = _port_report(runs, "slice0")
    assert lost0["restore_bit_identical"] is True
    assert lost0["final_step"] == 12
    assert lost0["transitions"][0]["lost_slice"] == 0


def test_grow_transfer_maps_the_group_rank_of_its_source(runs):
    """The grow's transfer (``elastic._broadcast_leaves``) over the group
    of global ranks 1-3 from its rank 1: every member ends with global
    rank 2's tensor and int (a ``src`` read as a global rank would have
    sent rank 1's); rank 0, outside the group, keeps its own."""
    assert runs["port_episodes"]["subgroup_grow"] == [
        [0, 0, 0, 0], [2, 2, 2, 20], [2, 2, 2, 20], [2, 2, 2, 20]]


def test_episode_preserves_the_global_batch_schedule(runs):
    report = _port_report(runs, "slice1")
    oracle = tres.oracle_batch_digests(12)
    assert oracle == jres.oracle_batch_digests(12)
    for row in report["steps"]:
        assert row["digest"] == oracle[row["step"]]
        assert row["global_rows"] == 16
        # Half the world, double the microbatches: 16 rows over 2 ranks.
        assert row["accum"] == (4 if row["world"] == 2 else 2)
    executed = [row["step"] for row in report["steps"]]
    assert executed == [0, 1, 2, 3, 4, 5, 6, 6, 7, 8, 9, 10, 11]
    assert {row["world"] for row in report["steps"]} == {2, 4}


def test_episode_ledger_attribution_exact(runs):
    """JAX's integer-ns pins: the virtual clock makes them independent of
    the world size."""
    led = _port_report(runs, "slice1")["ledger"]
    assert led["identity_ok"]
    cats = led["categories_ns"]
    assert sum(cats.values()) == led["wall_ns"] == int(12.5 * NS)
    assert cats["compile"] == int(3.375 * NS)
    assert cats["step_compute"] == int(3.75 * NS)
    assert cats["data_wait"] == int(1.75 * NS)
    assert cats["ckpt_save"] == int(1.75 * NS)
    assert cats["ckpt_restore"] == int(0.25 * NS)
    assert cats["rework"] == int(0.75 * NS)
    assert cats["supervisor_backoff"] == int(0.5 * NS)
    assert cats["other"] == int(0.375 * NS)
    assert cats["grad_sync"] == 0
    assert led["step_intervals"] == {"compile": 1, "step_compute": 10,
                                     "rework": 2}


def test_episode_is_deterministic_run_to_run(runs):
    """Other processes, no emitter: the same report."""
    assert runs["port_again"]["slice1"] == _port_report(runs, "slice1")


def test_episode_counters_match_telemetry_and_report(runs):
    """ElasticWorld's counters == rank 0's emitted telemetry == the repo's
    ``tools/telemetry_report.py`` elastic section."""
    from tools.telemetry_report import _format_text, build_report

    report = _port_report(runs, "slice1")
    tr = build_report(runs["port_episodes"]["metrics"])
    el = tr["elastic"]
    assert el["counters"] == report["counters"]
    assert all(el["counter_record_check"].values())
    assert el["restore_sources"] == {"peer": 1, "disk": 0}
    assert [t["transition"] for t in el["transitions"]] == \
        ["shrink", "peer_restore", "grow"]
    assert el["world_size_last"] == 4
    text = _format_text(tr)
    assert "elastic: 1 shrink(s) 1 grow(s)" in text
    assert "COUNTERS != RECORDS" not in text


def test_host_hang_flags_stall_without_shrinking(runs):
    report = _port_report(runs, "hang")
    assert report["transitions"] == []
    assert report["world"]["final"] == 4
    assert report["final_step"] == 6
    assert report["host_stalls"] == 1
    assert report["counters"]["elastic_host_stalls"] == 1
    assert report["counters"]["elastic_shrinks"] == 0
    assert report["ledger"]["identity_ok"]
    assert report["ledger"]["categories_ns"]["rework"] == 0


def test_episode_final_params_match_uninterrupted_run(runs):
    """The rolled-back step 6 re-ran at world 2 with 4 microbatches: the
    final parameters stay within 1e-5 (relative L2) of 12 uninterrupted
    steps at world 4, and every loss is finite."""
    res = runs["port_episodes"]
    assert res["params_rel_l2"] <= 1e-5
    assert len(res["losses"]) == 13
    assert all(4.0 < x < 5.5 for x in res["losses"])


def test_episode_refusals_match_jax():
    """Outside a group of 4 or more ranks the episode refuses as JAX's
    does at too few devices; and it takes membership faults only."""
    with pytest.raises(ValueError, match="do not form 2 slices of >= 2"):
        tres.run_elastic_episode(faults=FAULTS_1, device="cpu")
    with pytest.raises(ValueError, match="not an elastic membership"):
        tres.run_elastic_episode(faults=[tres.Fault("crash", 3)],
                                 device="cpu")


# ---------------------------------------------------------------------- #
# the CLI
# ---------------------------------------------------------------------- #

def test_cli_torchrun_prints_jax_elastic_lines(runs):
    """Rank 0 prints JAX's lines; the peer-bytes counter aside (the
    blobs differ), they are JAX's CLI's at 4 devices."""
    got, want = runs["port_cli"]["lines"], runs["jax_cli"]

    def counters(lines):
        c = json.loads(lines[-1].removeprefix("elastic: counters "))
        return c.pop("elastic_peer_snapshot_bytes"), c

    assert len(got) == 6 and got[:-1] == want[:-1]
    assert got[1:4] == ["elastic: shrink@7 4 -> 2",
                        "elastic: peer_restore@7 2 -> 2",
                        "elastic: grow@9 2 -> 4"]
    (gb, gc), (wb, wc) = counters(got), counters(want)
    assert gc == wc and gb > 0 and wb > 0


def test_cli_fault_markers_fire_once_per_run(runs):
    """Rank 0 writes the markers under ``<checkpoint-dir>/.elastic_state``;
    a second run in the same directory fires nothing on any rank."""
    cli = runs["port_cli"]
    assert cli["markers"] == ["slice_lost_4", "slice_return_9"]
    assert cli["again"][0] == ("elastic: world 4 -> 4 over 0 transitions, "
                               "final step 12")
    assert "elastic: peer restore bit-identical: None" in cli["again"][1]


def test_cli_refuses_a_two_rank_world(runs):
    cli = runs["port_cli"]
    assert cli["two_rc"] != 0
    assert "2 devices do not form 2 slices of >= 2" in cli["two_err"]


def test_cli_refuses_a_bad_plan():
    from pytorch_distributed_training_tpu_torch.cli.main import main as cli

    with pytest.raises(SystemExit, match="slice_lost wants step:slice"):
        cli(["--use-cpu", "--elastic-resize", "slice_lost@4"])


# ---------------------------------------------------------------------- #
# /slo elastic block, config
# ---------------------------------------------------------------------- #

def test_slo_elastic_block_next_to_goodput():
    from pytorch_distributed_training_tpu_torch.obs import (
        LiveAggregator, OpsServer,
    )

    ew = tres.ElasticWorld(8, 2)
    ew.count("elastic_shrinks")
    ew.transition("shrink", step=7, world_to=4, lost_slice=1)
    srv = OpsServer(LiveAggregator(), None, port=0, elastic=ew).start()
    try:
        body = urllib.request.urlopen(srv.url + "/slo", timeout=5.0).read()
        el = json.loads(body)["elastic"]
        assert el["world_size"] == 4
        assert el["initial_world_size"] == 8
        assert el["counters"]["elastic_shrinks"] == 1
        assert el["transitions"][0]["transition"] == "shrink"
    finally:
        srv.stop()
    with pytest.raises(ValueError):
        ew.transition("explode", step=0, world_to=8)


def test_elastic_config_defaults_round_trip():
    cfg = tres.ElasticConfig()
    assert cfg.n_slices == 2 and cfg.patience_steps == 3
    assert cfg.stall_flag_after == 1 and cfg.snapshot_every_steps == 2
    assert dataclass_fields(cfg) == dataclass_fields(jres.ElasticConfig())


def dataclass_fields(obj) -> dict:
    import dataclasses

    return dataclasses.asdict(obj)


# ---------------------------------------------------------------------- #
# analysis: the ledger audit and the finding records
# ---------------------------------------------------------------------- #

def test_ledger_audit_equals_jax():
    from pytorch_distributed_training_tpu.analysis import (
        ledger_audit as jaudit,
    )
    from pytorch_distributed_training_tpu_torch.analysis import (
        expected_final_categories_ns, run_ledger_audit,
    )

    findings, report = run_ledger_audit()
    assert findings == [], [f.format() for f in findings]
    assert (findings, report) == jaudit.run_ledger_audit()
    assert report["identity_ok"] and report["determinism_ok"]
    assert expected_final_categories_ns() == \
        jaudit.expected_final_categories_ns()


def test_finding_record_roundtrip():
    from pytorch_distributed_training_tpu.analysis import findings as jf
    from pytorch_distributed_training_tpu_torch.analysis import findings as tf

    f = tf.Finding(rule="tracer-leak", message="m", path="a/b.py", line=3,
                   col=7, fixit="fix", analysis_pass="lint",
                   severity="error")
    rec = tf.finding_record(f)
    tf.validate_finding_records([rec])
    assert tf.finding_from_record(rec) == f
    assert rec == jf.finding_record(jf.Finding(**{
        k: getattr(f, k) for k in ("rule", "message", "path", "line", "col",
                                   "fixit", "analysis_pass", "severity")}))
    mem = tf.memory_record("p", {"a": 1}, {"a": 2}, measured_total=3,
                           total_rel_err=0.5)
    tf.validate_memory_records([mem])
    assert mem == jf.memory_record("p", {"a": 1}, {"a": 2},
                                   measured_total=3, total_rel_err=0.5)


def test_finding_record_rejects_drift():
    from pytorch_distributed_training_tpu_torch.analysis import findings as tf

    rec = tf.finding_record(tf.Finding(rule="r", message="m", path="p"))
    with pytest.raises(ValueError):
        tf.validate_finding_records([dict(rec, findings_schema=99)])
    with pytest.raises(ValueError):
        tf.validate_finding_records([dict(rec, line="3")])
    with pytest.raises(ValueError):
        tf.Finding(rule="r", message="m", path="p", analysis_pass="vibes")


def test_findings_flow_through_obs_emitter(tmp_path):
    from pytorch_distributed_training_tpu_torch.analysis import findings as tf
    from pytorch_distributed_training_tpu_torch.obs import (
        MetricsEmitter, read_events, validate_events,
    )

    f = tf.Finding(rule="host-commit", message="m", path="x.py", line=9)
    with MetricsEmitter(str(tmp_path), rank=0, world=1) as em:
        em.emit("record", tf.finding_record(f))
        em.summary(graftcheck_findings=1)
    events = read_events(str(tmp_path / "events.rank00000.jsonl"))
    validate_events(events)
    recs = [e for e in events if e.get("record") == "graftcheck_finding"]
    assert len(recs) == 1
    got = {k: v for k, v in recs[0].items()
           if k not in ("v", "t", "rank", "kind")}
    tf.validate_finding_records([got])
    assert tf.finding_from_record(got) == f


def test_fleet_ledger_ranks_disagree_on_wall_after_elastic_shrink():
    """JAX's pin on the port's ``fleet_ledger``: a survivor's wall covers
    the whole run, a rank of the returned slice only its re-entry; the
    merge closes its identity exactly, the gap idle and attributed to the
    longest wall."""
    import pytorch_distributed_training_tpu.obs as jobs
    import pytorch_distributed_training_tpu_torch.obs as tobs

    survivor = {
        "wall_ns": int(20.0 * NS),
        "categories_ns": {
            "step_compute": int(14.0 * NS), "ckpt_restore": int(0.25 * NS),
            "rework": int(0.75 * NS), "supervisor_backoff": int(0.5 * NS),
            "other": int(4.5 * NS),
        },
        "grad_sync_ici_ns": 0, "grad_sync_dcn_ns": 0,
    }
    returned = {
        "wall_ns": int(6.0 * NS),
        "categories_ns": {"step_compute": int(5.5 * NS),
                          "other": int(0.5 * NS)},
        "grad_sync_ici_ns": 0, "grad_sync_dcn_ns": 0,
    }
    recs = {0: survivor, 1: survivor, 2: returned}
    fleet = tobs.fleet_ledger(copy.deepcopy(recs))
    assert fleet == jobs.fleet_ledger(copy.deepcopy(recs))
    assert fleet["identity_ok"]
    assert fleet["fleet_wall_ns"] == 3 * int(20.0 * NS)
    assert fleet["idle_gap_ns"] == {0: 0, 1: 0, 2: int(14.0 * NS)}
    assert fleet["idle_gap_total_ns"] == int(14.0 * NS)
    assert sum(fleet["categories_ns"].values()) \
        + fleet["idle_gap_total_ns"] == fleet["fleet_wall_ns"]
    assert fleet["categories_ns"]["rework"] == 2 * int(0.75 * NS)
    assert fleet["categories_ns"]["ckpt_restore"] == 2 * int(0.25 * NS)
    assert fleet["idle_attributed_to"] == 0


def test_elastic_and_analysis_import_without_jax():
    blocked = ", ".join(repr(m) for m in (
        "jax", "jaxlib", "flax", "optax", "orbax",
        "pytorch_distributed_training_tpu"))
    code = (
        "import sys\n"
        f"for m in ({blocked},):\n"
        "    sys.modules[m] = None\n"
        "import pytorch_distributed_training_tpu_torch.resilience.elastic\n"
        "import pytorch_distributed_training_tpu_torch.analysis\n"
        "from pytorch_distributed_training_tpu_torch.analysis import "
        "run_ledger_audit\n"
        "assert run_ledger_audit()[0] == []\n"
        "from pytorch_distributed_training_tpu_torch.analysis import "
        "lint_paths\n"
        "assert lint_paths() == []\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
