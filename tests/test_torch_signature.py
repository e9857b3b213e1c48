"""The port's recompile guard (``analysis/signature.py``) and the serving
engine's programs against the JAX package's.

Pinned on the CPU, on JAX's tiny GPT-2 (the port's engine carries its
weights through ``models/convert.py``):

- ``abstract_signature`` tracks the calling convention as JAX's does:
  two engines of one configuration share each program's signature, and a
  different slot count, chunk, ``spec_k``, KV dtype or pool layout changes
  exactly the programs whose JAX signatures it changes;
- the twin of JAX's ``test_recompile_guard_full_scheduler_trace``: the
  same scripted-drafter trace (admission, speculative verify, a
  cancellation mid-decode, ``reset()``, a second wave) on the port's paged
  engine and on JAX's records each program once, at construction, and
  nothing after, with greedy tokens equal to JAX's;
- role gating gives JAX's program set for every role with and without
  ``spec_k``, and ``DisaggServingEngine.program_signatures`` is the union
  of its two roles';
- zero new records across a quantized handoff, an autoscale re-split and
  a failover crash with its respawn and a second wave, each against JAX's
  run of the same scenario (``tests/torch_fleet.py``);
- the registry's ledger behaves as JAX's; ``draw_categorical`` draws as
  ``torch.multinomial`` does.

The JAX side is computed once a run in parts (``tests/torch_shared.py``).
On the card the programs are CUDA graphs: ``tests/test_torch_cuda_serve.py``.
"""

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_training_tpu.analysis import signature as jsig
from pytorch_distributed_training_tpu_torch.analysis import signature as tsig
from pytorch_distributed_training_tpu_torch.models.generate import (
    draw_categorical,
)
from tests.test_torch_serve_autoscale import s_resplit
from tests.torch_fleet import (
    Side, baseline, converted, drive, observe, streams, watch_respawns,
    workload,
)
from tests.torch_shared import shared, shared_parts

BASE = dict(num_slots=2, max_len=48, prefill_chunk=4, temperature=0.0,
            spec_k=3, paged=True, block_size=8)
# Each variant against BASE, with the programs whose signature it moves.
VARIANTS = {
    "again": dict(),
    "slots": dict(num_slots=3),
    "chunk": dict(prefill_chunk=8),
    "spec_k": dict(spec_k=2),
    "kv_int8": dict(kv_dtype="int8"),
    "contiguous": dict(paged=False),
}
MOVES = {"again": set(), "slots": {"prefill", "decode", "verify"},
         "chunk": {"prefill"}, "spec_k": {"verify"},
         "kv_int8": {"prefill", "decode", "verify"},
         "contiguous": {"prefill", "decode", "verify"}}
ROLES = [(role, k) for role in ("both", "prefill", "decode") for k in (0, 3)]
QUANT = dict(max_len=48, prefill_chunk=4, temperature=0.0, paged=True,
             block_size=4, kv_dtype="int8")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _registry(x: Side):
    return (jsig if x.which == "jax" else tsig).PROGRAM_REGISTRY


class _ScriptedDrafter:
    """JAX's test drafter: every decode tick proposes repeats of the last
    token, so the verify program runs on every tick."""

    index = None

    def observe_prompt(self, prompt):
        pass

    def draft(self, history, k):
        return np.full((min(2, max(k, 0)),), history[-1], np.int32)


def _scheduler_trace(x: Side) -> dict:
    """JAX's ``test_recompile_guard_full_scheduler_trace`` on ``x``'s
    paged engine; returns what both sides must share."""
    registry = _registry(x)
    before = registry.snapshot()
    engine = x.engine(**{**BASE, "num_blocks": None})
    engine.drafter = _ScriptedDrafter()
    base = registry.snapshot()
    sigs = dict(engine.program_signatures)
    # Construction recorded each signature exactly once.
    once = [registry.compiles_since(before)[(f"serve/{n}", s)]
            for n, s in sorted(sigs.items())]
    toks: dict = {}
    engine.stream_cb = lambda rid, t: toks.setdefault(rid, []).append(int(t))
    clock = x.VirtualClock()
    sched = x.ContinuousScheduler(engine, clock=clock)
    rng = np.random.default_rng(5)
    pat = rng.integers(0, 61, (3,)).astype(np.int32)
    reqs = [
        x.Request(0, np.tile(pat, 5)[:12], 10),
        # Budget far past its deadline: expires mid-decode (cancelled).
        x.Request(2, rng.integers(0, 61, 5).astype(np.int32), 30,
                  deadline=0.5),
        x.Request(1, rng.integers(0, 61, 7).astype(np.int32), 8),
        x.Request(3, np.tile(pat, 4)[:9], 6),
    ]
    for r in reqs:
        assert sched.submit(r)
    for _ in range(100):
        if sched.idle:
            break
        sched.tick()
        clock.advance(0.2)
    assert sched.idle
    reasons = {r["id"]: r["finish_reason"] for r in sched.completed}
    drafted = engine.spec_drafted_tokens
    engine.reset()
    sched2 = x.ContinuousScheduler(engine, clock=x.VirtualClock())
    assert sched2.submit(x.Request(10, np.tile(pat, 5)[:12], 8))
    for _ in range(50):
        if sched2.idle:
            break
        sched2.tick()
    assert sched2.idle
    return {"programs": sorted(sigs), "once": once, "reasons": reasons,
            "drafted": drafted > 0, "tokens": toks,
            "new": registry.compiles_since(base),
            "same_signatures": engine.program_signatures == sigs}


def _signatures(x: Side) -> dict:
    """Each variant's and each role's program signatures, and the
    disaggregated tier's with its roles'."""
    out = {"base": dict(x.engine(**{**BASE, "num_blocks": None})
                        .program_signatures)}
    for name, extra in VARIANTS.items():
        out[name] = dict(x.engine(**{**BASE, "num_blocks": None, **extra})
                         .program_signatures)
    for role, k in ROLES:
        out[f"{role}/{k}"] = sorted(x.engine(
            **{**BASE, "num_blocks": None, "spec_k": k, "role": role})
            .program_signatures)
    for k in (0, 3):
        tier = x.disagg(prefill_slots=1, decode_slots=2, max_len=48,
                        prefill_chunk=4, temperature=0.0, paged=True,
                        block_size=8, spec_k=k)
        out[f"disagg/{k}"] = (
            dict(tier.program_signatures),
            {**tier.prefill_engine.program_signatures,
             **tier.decode_engine.program_signatures})
    return out


def _quantized_handoff(x: Side) -> dict:
    """JAX's ``test_quantized_handoff_zero_new_compiles_token_exact``."""
    prompt = (np.arange(2, 16) % 61).astype(np.int32)
    ref = []
    eng = x.engine(num_slots=2, num_blocks=None, **QUANT)
    eng.stream_cb = lambda r, t: ref.append(int(t))
    eng.start("r", prompt, 8)
    while eng.busy:
        eng.step()
    tier = x.disagg(prefill_slots=1, decode_slots=1, **QUANT)
    registry = _registry(x)
    base = registry.snapshot()
    out = []
    tier.stream_cb = lambda r, t: out.append(int(t))
    tier.start("r", prompt, 8)
    while tier.busy:
        tier.step()
    return {"tokens": out, "ref": ref, "handoffs": tier.handoffs,
            "new": registry.compiles_since(base)}


def _guarded(scenario):
    """``scenario`` with the registry diffed around it: the records its
    engine constructions made are set apart, and whatever else it
    recorded (serving, re-splits, crashes, respawns) is part of what it
    returns, as ``beyond_construction``."""
    def run(x: Side, tmp) -> dict:
        registry = _registry(x)
        built: dict = {}
        engine, disagg = x.engine, x.disagg

        def counted(make):
            def build(**kw):
                before = registry.snapshot()
                out = make(**kw)
                for k, v in registry.compiles_since(before).items():
                    built[k] = built.get(k, 0) + v
                return out
            return build

        x.engine, x.disagg = counted(engine), counted(disagg)
        base = registry.snapshot()
        try:
            obs = scenario(x, tmp)
        finally:
            del x.engine, x.disagg
        new = registry.compiles_since(base)
        beyond = {f"{k[0]}:{v - built.get(k, 0)}" for k, v in new.items()
                  if v != built.get(k, 0)}
        return {"obs": obs, "beyond_construction": sorted(beyond),
                "constructed": sorted({k[0] for k in built})}
    return run


def _crash_respawn(x: Side, tmp) -> dict:
    """JAX's ``test_failover_crash_token_exact_paged`` (a crash of replica
    1 at tick 3: fence, drain, requeue), then the dead replica's respawn
    (``reset()``) and a second wave through both replicas."""
    work, second = workload(), workload(n=6, seed=4)
    oracle, oracle2 = baseline(x, work), baseline(x, second)
    engines = [x.engine() for _ in range(2)]
    clock = x.VirtualClock()
    toks = streams(engines)
    ctrl = x.FailoverController(retry_budget=2, miss_threshold=2,
                                backoff=x.backoff(0.5))
    router = x.ReplicaRouter(engines, max_queue=64, clock=clock,
                             chaos=x.chaos("replica_crash@3:1"),
                             failover=ctrl)
    respawns = watch_respawns(ctrl, router)
    drive(router, clock, [x.Request(i, p, b) for i, (p, b) in
                          enumerate(work)])
    clock.advance(1.0)
    router.tick()
    drive(router, clock, [x.Request(100 + i, p, b) for i, (p, b) in
                          enumerate(second)])
    for rid in range(len(work)):
        assert toks[rid] == oracle[rid]
    for i in range(len(second)):
        assert toks[100 + i] == oracle2[i]
    return observe(router, ctrl, toks, respawns)


def _fleet(x: Side, tmp) -> dict:
    return {"handoff": _quantized_handoff(x),
            "resplit": _guarded(s_resplit)(x, tmp),
            "crash": _guarded(_crash_respawn)(x, tmp)}


@pytest.fixture(scope="module")
def named(request, tmp_path_factory):
    return shared(request, tmp_path_factory, "torch_serve_tiny_params",
                  converted)


@pytest.fixture(scope="module")
def port(named):
    return Side("torch", named)


@pytest.fixture(scope="module")
def jax_side(request, tmp_path_factory):
    def part(fn):
        return lambda: fn(Side("jax"))
    parts = shared_parts(request, tmp_path_factory, "torch_signature", {
        "trace": part(_scheduler_trace),
        "sigs": part(_signatures),
        "fleet": lambda: _fleet(Side("jax"),
                                tmp_path_factory.mktemp("jax_fleet")),
    })
    return parts


@pytest.fixture(scope="module")
def port_sigs(port):
    return _signatures(port)


# --------------------------------------------------------------------- #
# the signature and the registry
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_abstract_signature_tracks_calling_convention(jax_side, port_sigs,
                                                      variant):
    jx, pt = jax_side["sigs"], port_sigs
    assert set(pt["base"]) == set(jx["base"]) == {"prefill", "decode",
                                                  "verify"}
    moved_jax = {p for p in jx["base"] if jx[variant][p] != jx["base"][p]}
    moved = {p for p in pt["base"] if pt[variant][p] != pt["base"][p]}
    assert moved == moved_jax == MOVES[variant]
    assert all(len(s) == 16 and int(s, 16) >= 0
               for s in pt[variant].values())


def test_signature_is_the_tensors_not_the_callable():
    """Equal tensors give equal signatures whatever holds them; shape,
    dtype, device, the donated set and the outputs each move it (JAX's
    own test of ``abstract_signature`` at (4,) against (8,))."""
    class P:
        def __init__(self, n=4, dtype=torch.int64, device="cpu",
                     donated=(), out=(4,)):
            self.inputs = [torch.zeros(n, dtype=dtype, device=device)] * 2
            self.donated = list(donated)
            self.outputs = [torch.zeros(out, dtype=torch.int64)]

    sig = tsig.abstract_signature
    cache = torch.zeros(2, 3, dtype=torch.bfloat16)
    assert sig(P()) == sig(P())
    others = [P(n=8), P(dtype=torch.int32), P(device="meta"),
              P(donated=[cache]), P(out=(4, 2))]
    assert len({sig(p) for p in [P(), *others]}) == 6

    def f(a, b):
        return a + b

    lo = jax.jit(f).lower(np.zeros((4,)), np.zeros((4,)))
    again = jax.jit(f).lower(np.zeros((4,)), np.zeros((4,)))
    other = jax.jit(f).lower(np.zeros((8,)), np.zeros((8,)))
    assert jsig.abstract_signature(lo) == jsig.abstract_signature(again)
    assert jsig.abstract_signature(lo) != jsig.abstract_signature(other)
    with pytest.raises(ValueError):
        sig(object())


def test_registry_ledger_equals_jax():
    ops = [("a", "1"), ("a", "1"), ("b", "2"), ("a", "3")]
    mine, ref = tsig.SignatureRegistry(), jsig.SignatureRegistry()
    snaps = []
    for name, s in ops:
        assert mine.record(name, s) == ref.record(name, s)
        snaps.append((mine.snapshot(), ref.snapshot()))
        assert snaps[-1][0] == snaps[-1][1]
    assert mine.counts("a") == ref.counts("a")
    assert (mine.compiles_since(snaps[0][0])
            == ref.compiles_since(snaps[0][1])
            == {("a", "1"): 1, ("b", "2"): 1, ("a", "3"): 1})
    assert mine.compiles_since(mine.snapshot()) == {}


# --------------------------------------------------------------------- #
# the engine's programs
# --------------------------------------------------------------------- #


def test_recompile_guard_full_scheduler_trace(jax_side, port):
    got, want = _scheduler_trace(port), jax_side["trace"]
    assert got["programs"] == ["decode", "prefill", "verify"]
    assert got["once"] == [1, 1, 1]
    assert got["reasons"][2] == "cancelled" and got["drafted"]
    assert got["new"] == {} and got["same_signatures"]
    assert got == want


@pytest.mark.parametrize("role,spec_k", ROLES)
def test_role_gating_builds_jax_programs(jax_side, port_sigs, role, spec_k):
    want = {"both": ["decode", "prefill"], "prefill": ["prefill"],
            "decode": ["decode"]}[role]
    if spec_k and role != "prefill":
        want = sorted(want + ["verify"])
    key = f"{role}/{spec_k}"
    assert port_sigs[key] == jax_side["sigs"][key] == want


@pytest.mark.parametrize("spec_k", [0, 3])
def test_disagg_signatures_are_the_union_of_its_roles(jax_side, port_sigs,
                                                      spec_k):
    tier, union = port_sigs[f"disagg/{spec_k}"]
    jtier, _ = jax_side["sigs"][f"disagg/{spec_k}"]
    assert tier == union
    assert sorted(tier) == sorted(jtier)
    assert set(tier) == {"prefill", "decode"} | ({"verify"} if spec_k
                                                  else set())


def test_quantized_handoff_records_nothing(jax_side, port):
    got = _quantized_handoff(port)
    assert got["new"] == {} and got["handoffs"] == 1
    assert got["tokens"] == got["ref"]
    assert got == jax_side["fleet"]["handoff"]


def test_autoscale_resplit_records_nothing(jax_side, port, tmp_path):
    got = _guarded(s_resplit)(port, tmp_path)
    assert got["beyond_construction"] == []
    assert got["constructed"] == ["serve/decode", "serve/prefill"]
    assert got["obs"]["auto"]["resplits"] >= 1
    assert got == jax_side["fleet"]["resplit"]


def test_failover_respawn_records_nothing(jax_side, port, tmp_path):
    got = _guarded(_crash_respawn)(port, tmp_path)
    assert got["beyond_construction"] == []
    assert got["constructed"] == ["serve/decode", "serve/prefill"]
    assert got["obs"]["stats"]["replica_deaths"] == 1
    assert got["obs"]["respawns"]
    assert got == jax_side["fleet"]["crash"]


def test_cpu_engines_run_their_programs_eagerly(port):
    eng = port.engine(**{**BASE, "num_blocks": None})
    stats = eng.program_stats()
    assert not eng.cuda_graphs and stats["graph_pool_bytes"] is None
    assert sorted(stats["programs"]) == ["decode", "prefill", "verify"]
    assert all(p["capture_s"] is None and p["replays"] == 0
               for p in stats["programs"].values())


def test_draw_categorical_is_multinomial():
    gen = torch.Generator().manual_seed(0)
    probs = torch.softmax(torch.randn(6, 61, generator=gen), -1)
    probs[:, 3] = 0.0
    a, b = (torch.Generator().manual_seed(5) for _ in range(2))
    for _ in range(4):
        assert torch.equal(torch.multinomial(probs, 1, generator=a)[:, 0],
                           draw_categorical(probs, b))
