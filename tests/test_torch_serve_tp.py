"""The port's tensor-parallel serving engine against the JAX package's on
converted weights.

The cases of JAX's ``tests/test_serve_tp.py``, on gloo ranks of the CPU
(``tests/torch_serve_worker.py``, launched once at world 2 and once at
world 4, every case inside): greedy tokens at TP 2 (contiguous, paged,
speculative on both pools, and the disaggregated tier) and at TP 4 (a
4-head model: the port refuses heads the tensor axis does not divide,
where JAX replicates the cache) equal JAX's single-device engine's
exactly; the TP 2 contiguous and paged cases are also held against JAX's
own TP engine on two of the simulated CPU devices, and the speculative
paged case against JAX's forced-Pallas TP engine (the kernels in
interpret mode; the port runs its kernels' plain versions on the host).
Each rank's KV pool holds its local heads, its parameters the column and
row shards ``serve_tp_rules`` names (the specs equal JAX's), every rank
takes the same prefill forwards and decode ticks, and the memory model's
components equal JAX's at TP 1 and 2.  The CLI's ``--serve-tp`` serves
under the world and refuses what it cannot serve.

The fleet (item 11b): TP 2 x 2 replicas over the world-4 launch, rank 0's
router driving its own group in lockstep and the other group through its
leader (``serve/tp.py``), is held against JAX's ``ReplicaRouter`` over
two unsharded replicas on the same scripted trace, with and without a
replica crash under a ``FailoverController``: the same greedy tokens,
routing decisions, sibling fetches and failover block; the fetched
prefix blocks are each rank's shard, bit for bit its peer's; the CLI's
``--serve-tp 2 --serve-replicas 2`` serves under the world.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pytorch_distributed_training_tpu.models import gpt2_124m as jax_gpt2
from pytorch_distributed_training_tpu.parallel.sharding import (
    infer_params_sharding as jax_infer_params_sharding,
    serve_tp_mesh, serve_tp_rules as jax_serve_tp_rules,
)
from pytorch_distributed_training_tpu.serve import ServingEngine as JaxEngine
from pytorch_distributed_training_tpu_torch.comm.mesh import (
    MeshConfig, make_mesh,
)
from pytorch_distributed_training_tpu_torch.models import (
    GPT2, GPT2Config, gpt2_params_from_jax,
)
from pytorch_distributed_training_tpu_torch.models.convert import (
    jax_leaf_dims, jax_leaf_paths,
)
from pytorch_distributed_training_tpu_torch.parallel import (
    infer_params_sharding, serve_tp_rules, shard_for_serving,
)
from pytorch_distributed_training_tpu_torch.serve import ServingEngine
from tests.torch_dp_worker import launch_start
from tests.torch_serve_worker import (
    CASES, CLI, FLEET_ENGINE, MEMORY, PROGRAMS, SMALL, SMALL4, drive,
    fleet_run,
)
from tests.torch_shared import shared_parts


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg):
    model = jax_gpt2(cfg_overrides=cfg)
    return model, model.init(jax.random.PRNGKey(0),
                             jnp.zeros((2, 8), jnp.int32),
                             train=False)["params"]


def _named(params) -> dict:
    return {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


def _jax_single() -> dict:
    """JAX's single-device engine's tokens for every case."""
    models = {2: _jax_params(SMALL), 4: _jax_params(SMALL4)}
    out = {}
    for label, (heads, kind, kw, trace, _) in CASES.items():
        m, params = models[heads]
        kw = dict(kw)
        if kind == "disagg":
            kw["num_slots"] = kw.pop("prefill_slots") + kw.pop(
                "decode_slots")
        kw.pop("spec_k", None)     # greedy speculation == plain decode
        out[label] = drive(JaxEngine(m, params, **kw), *trace())
    return out


def _jax_tp2() -> dict:
    """JAX's TP 2 engine on two simulated devices for the contiguous and
    paged cases, and its forced-Pallas TP 2 engine for ``pallas``."""
    import os

    m, params = _jax_params(SMALL)
    out = {}
    for label in ("contig", "paged"):
        engine = JaxEngine(m, params, tp_mesh=serve_tp_mesh(2),
                           **CASES[label][2])
        out[label] = drive(engine, *CASES[label][3]())
    os.environ["PDT_DECODE_ATTN"] = "pallas"
    jax.clear_caches()
    try:
        engine = JaxEngine(m, params, tp_mesh=serve_tp_mesh(2),
                           **CASES["pallas"][2])
        out["pallas"] = drive(engine, *CASES["pallas"][3]())
    finally:
        del os.environ["PDT_DECODE_ATTN"]
        jax.clear_caches()
    return out


def _jax_memory() -> dict:
    """JAX's memory models of ``MEMORY`` at TP 1 and 2 (its engines at
    ``role="prefill"``, which compile one step: the model reads the
    config alone, whatever the role)."""
    m, params = _jax_params(SMALL)
    out = {}
    for label, kw in MEMORY.items():
        for tp in (1, 2):
            engine = JaxEngine(m, params, role="prefill", **kw, **(
                {"tp_mesh": serve_tp_mesh(2)} if tp == 2 else {}))
            out[label, tp] = {p: engine.memory_model(p) for p in PROGRAMS}
    return out


def _jax_fleet() -> dict:
    """``fleet_run`` through JAX's router over two unsharded replicas,
    without and with the crash."""
    from pytorch_distributed_training_tpu.resilience import (
        ServeFaultInjector,
    )
    from pytorch_distributed_training_tpu.serve import (
        FailoverController, ReplicaRouter, Request, VirtualClock,
    )
    from pytorch_distributed_training_tpu.utils.backoff import BackoffPolicy

    ns = dict(VirtualClock=VirtualClock, ReplicaRouter=ReplicaRouter,
              Request=Request, FailoverController=FailoverController,
              ServeFaultInjector=ServeFaultInjector,
              BackoffPolicy=BackoffPolicy)
    m, params = _jax_params(SMALL)
    return {label: fleet_run(ns, [JaxEngine(m, params, **FLEET_ENGINE)
                                  for _ in range(2)], crash)
            for label, crash in (("plain", False), ("crash", True))}


def _ranks(tmp_path_factory) -> dict:
    """Each rank's results of the worker at world 2 and at world 4 (the
    two launches run at once)."""
    import pickle

    init = {2: _named(_jax_params(SMALL)[1]),
            4: _named(_jax_params(SMALL4)[1])}
    dirs, launched = {}, {}
    try:
        for world in (2, 4):
            dirs[world] = tmp_path_factory.mktemp(f"serve_tp{world}")
            for h, named in init.items():
                np.savez(dirs[world] / f"init{h}.npz", **named)
            launched[world] = launch_start(
                ["tests/torch_serve_worker.py", "tp", str(dirs[world])],
                world, timeout=240)
        for world in (2, 4):
            launched[world].wait()
    finally:
        for ranks in launched.values():
            ranks.kill()
    got = {}
    for world, d in dirs.items():
        got[world] = []
        for r in range(world):
            with open(d / f"rank{r}.pkl", "rb") as f:
                got[world].append(pickle.load(f))
    return got


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """(JAX's references, {world: [each rank's results]}), computed in
    parts that different xdist workers take at once."""
    parts = shared_parts(request, tmp_path_factory, "torch_serve_tp", {
        "ranks": lambda: _ranks(tmp_path_factory),
        "single": _jax_single, "tp2": _jax_tp2, "memory": _jax_memory,
        "fleet": _jax_fleet,
    })
    ref = {"single": parts["single"], "tp2": parts["tp2"],
           "memory": parts["memory"], "fleet": parts["fleet"]}
    return ref, parts["ranks"]


def _case(runs, world, label):
    return [r["cases"][label] for r in runs[1][world]]


@pytest.mark.parametrize("label", ["contig", "paged"])
def test_tp_engine_token_exact(runs, label):
    """TP 2 against JAX's single-device engine and JAX's own TP 2 engine:
    identical greedy streams through slot reuse, both pool layouts."""
    ref = runs[0]
    got = _case(runs, 2, label)[0]["tokens"]
    assert got == ref["single"][label] == ref["tp2"][label]


def test_tp_engine_token_exact_speculative(runs):
    """The verify step under TP: repetitive tails force multi-token
    accepts, and the emission still equals the plain engine's chain on
    both pools; the drafter fired and its drafts were accepted."""
    for label in ("spec_contig", "spec_paged"):
        lead = _case(runs, 2, label)[0]
        assert lead["tokens"] == runs[0]["single"][label], label
        assert lead["stats"]["spec_drafted_tokens"] > 0
        assert lead["stats"]["spec_accepted_tokens"] > 0


def test_tp4_engine_token_exact(runs):
    """The 4-head model at TP 4 (one head a rank) and at TP 2 (two), on
    both pools, against JAX's single-device engine."""
    ref = runs[0]["single"]
    for world in (2, 4):
        for label in ("tp4_contig", "tp4_paged_spec"):
            assert _case(runs, world, label)[0]["tokens"] == ref[label], (
                world, label)


def test_tp_engine_forced_pallas_token_exact(runs):
    """JAX's kernel route under TP (the ``*_tp`` ``shard_map`` wrappers
    in interpret mode, PDT_DECODE_ATTN=pallas) against the port's paged
    speculative TP 2 engine (its kernels' plain versions on the host),
    and both against the unsharded engine."""
    ref = runs[0]
    got = _case(runs, 2, "pallas")[0]["tokens"]
    assert got == ref["tp2"]["pallas"] == ref["single"]["pallas"]


def test_tp_disagg_token_exact(runs):
    """The disaggregated tier under TP 2 (shared paged pool, handoffs in
    lockstep) against JAX's interleaved engine."""
    lead = _case(runs, 2, "disagg_paged")[0]
    assert lead["tokens"] == runs[0]["single"]["disagg_paged"]
    assert lead["stats"]["handoffs"] == 5


def test_ranks_in_lockstep_at_local_heads(runs):
    """Every rank took the same prefill forwards and decode ticks and
    applied every call its leader broadcast; each rank's KV pool holds
    H / tp heads (contiguous (S, h, L + 1, Dh), paged (N + 1, h, bs,
    Dh))."""
    for world, results in runs[1].items():
        for label in results[0]["cases"]:
            ranks = [r["cases"][label] for r in results]
            heads = CASES[label][0]
            lead = ranks[0]
            for x in ranks:
                assert x["prefill_ticks"] == lead["prefill_ticks"] > 0
                assert x["decode_ticks"] == lead["decode_ticks"] > 0
                assert x["stats"] == lead["stats"]
                assert all(shape[1] == heads // world
                           for shape in x["cache"]), (world, label)
            assert all(x["applied"] == lead["broadcasts"]
                       for x in ranks[1:])
    contig = _case(runs, 2, "contig")[0]["cache"]
    assert contig == [(3, 1, 49, 16), (3, 1, 49, 16)]
    paged = _case(runs, 2, "paged")[0]["cache"]
    assert paged == [(19, 1, 8, 16), (19, 1, 8, 16)]


def test_tp_param_layouts(runs):
    """The rule decisions equal JAX's ``serve_tp_rules`` on a tensor-2
    mesh leaf for leaf (column split of qkv / mlp_up, row split of proj /
    mlp_down, ``wpe`` and the indivisible ``wte`` replicated), and each
    rank holds exactly the shards they name."""
    named = _named(_jax_params(SMALL)[1])
    mesh = {"tensor": 2}
    port = infer_params_sharding(
        {n: a.shape for n, a in named.items()}, mesh, serve_tp_rules())
    jax_mesh = serve_tp_mesh(2)
    _, params = _jax_params(SMALL)
    jax_specs = jax_infer_params_sharding(params, jax_mesh,
                                          jax_serve_tp_rules())
    flat = {"/".join(str(k.key) for k in path): sh.spec
            for path, sh in jax.tree_util.tree_flatten_with_path(
                jax_specs, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    paths = jax_leaf_paths(named)
    for name, spec in port.items():
        jspec = tuple(flat[paths[name]])
        jspec += (None,) * (len(spec) - len(jspec))
        dims = jax_leaf_dims(paths[name], len(spec))
        assert tuple(spec) == tuple(jspec[j] for j in dims), (
            name, spec, jspec)
    assert port["blocks.0.attn.qkv.weight"] == ("tensor", None)
    assert port["blocks.0.attn.proj.weight"] == (None, "tensor")
    assert port["blocks.0.mlp_down.weight"] == (None, "tensor")
    assert port["wpe"] == (None, None) and port["wte"] == (None, None)
    shapes = _case(runs, 2, "contig")[1]["params"]
    assert shapes["blocks.0.attn.qkv.weight"] == (48, 32)
    assert shapes["blocks.0.attn.qkv.bias"] == (48,)
    assert shapes["blocks.0.attn.proj.weight"] == (32, 16)
    assert shapes["blocks.0.mlp_up.weight"] == (64, 32)
    assert shapes["blocks.0.mlp_down.weight"] == (32, 64)
    assert shapes["wte"] == (61, 32)


def test_mesh_and_head_refusals(runs):
    """Heads the tensor axis does not divide are refused (the library
    and the CLI under a world of 2), as are a world that is not the
    tensor size times the replicas, sizes below 1 and a malformed P:D."""
    from pytorch_distributed_training_tpu_torch.cli.main import main

    model = GPT2(GPT2Config(**SMALL))
    mesh = make_mesh(MeshConfig(data=1, tensor=4), world=4, rank=0)
    with pytest.raises(ValueError, match="heads \\(2\\) divisible"):
        shard_for_serving(model, mesh)
    assert runs[1][2][0]["cli"]["refused"] == "2"
    for extra, match in (
            (["--serve-tp", "2"], "world of 2"),
            (["--serve-tp", "2", "--serve-replicas", "2"],
             "world of 4"),
            (["--serve-tp", "0"], "must be >= 1"),
            (["--serve-disagg", "3"], "P:D"),
    ):
        with pytest.raises(SystemExit, match=match):
            main(CLI[:-2] + extra)


def test_cli_serve_tp2(runs):
    """``--serve-tp 2`` through the CLI under the world: every request
    completes on the leader, both ranks stepped alike, and the leader
    counted its broadcasts."""
    lead, follower = (r["cli"] for r in runs[1][2])
    assert lead["summary"]["completed"] == 6
    assert sum(len(t) for t in lead["tokens"].values()) == \
        lead["summary"]["generated_tokens"]
    assert follower["summary"] is None and follower["tokens"] == {}
    assert follower["stats"]["decode_ticks"] == \
        lead["stats"]["decode_ticks"] > 0
    assert lead["tp"]["broadcasts"] > 0


@pytest.mark.parametrize("label", sorted(MEMORY))
@pytest.mark.parametrize("tp", [1, 2])
def test_memory_model_equal_jax(runs, label, tp):
    """Every component JAX's ``memory_model`` gives (parameters under
    ``serve_tp_rules``, the KV pool split on the heads, operands,
    activation estimate, totals) for each step, from the config."""
    ref = runs[0]["memory"][label, tp]
    if tp == 1:
        tm = GPT2(GPT2Config(**SMALL))
        engine = ServingEngine(tm, device="cpu", **MEMORY[label])
        got = {p: engine.memory_model(p) for p in PROGRAMS}
    else:
        got = runs[1][2][0]["memory"][label]
    for p in PROGRAMS:
        assert {k: got[p][k] for k in ref[p]} == ref[p], (p, got[p], ref[p])
        assert got[p]["kv_cache_resident"] > 0


# --------------------------------------------------------------------- #
# the fleet: tensor-parallel replicas across processes
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("label", ["plain", "crash"])
def test_fleet_tp2x2_equal_jax_router(runs, label):
    """TP 2 x 2 over 4 gloo ranks against JAX's router over two unsharded
    replicas: greedy tokens per id, ``routed``, ``affinity_hits``,
    ``rebalanced``, ``sibling_fetches``, ``sibling_fetch_blocks``, each
    record's outcome and the failover block (the death's tick and time,
    the drained, requeued and respawned counts) equal; both groups'
    ranks stepped alike at one head a rank, and rank 0 counted its round
    trips to the remote group."""
    ref = runs[0]["fleet"][label]
    ranks = [r["fleet"] for r in runs[1][4]]
    got = ranks[0][label]
    for key in ("tokens", "router", "failover", "records", "ticks"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    assert got["router"]["rebalanced"] > 0
    assert got["router"]["sibling_fetches"] > 0
    if label == "crash":
        fo = got["failover"]
        assert fo["replica_deaths"] == 1 and fo["respawns"] == 1
        assert fo["retried"] > 0
    assert [r["group"] for r in ranks] == [0, 0, 1, 1]
    for a, b in ((0, 1), (2, 3)):
        sa, sb = ranks[a][label]["stats"], ranks[b][label]["stats"]
        assert sa["decode_ticks"] == sb["decode_ticks"]
    assert got["stats"]["decode_ticks"] > 0
    assert ranks[1][label]["calls"] == got["broadcasts"]
    assert ranks[2][label]["calls"] > 0 and ranks[3][label]["calls"] > 0
    assert all(r[label]["heads"] == [1, 1] for r in ranks)
    assert got["remote"]["round_trips"] > 0


def test_fleet_sibling_fetch_shard_for_shard(runs):
    """The prefix blocks group 1 fetched from group 0 hold, rank by rank,
    exactly the peer's head shard (and the two shards differ)."""
    ranks = [r["fleet"]["plain"] for r in runs[1][4]]
    assert ranks[2]["stats"]["blocks_sibling_fetched"] > 0
    for a, b in ((0, 2), (1, 3)):
        pa, pb = ranks[a]["prefix_bytes"], ranks[b]["prefix_bytes"]
        assert len(pa) == len(pb) == 2
        for x, y in zip(pa, pb):
            assert x is not None and y is not None
            assert all(np.array_equal(u, v) for u, v in zip(x, y))
    assert not all(np.array_equal(u, v) for u, v in zip(
        ranks[0]["prefix_bytes"][0], ranks[1]["prefix_bytes"][0]))


def test_cli_fleet_tp2x2(runs):
    """``--serve-tp 2 --serve-replicas 2`` through the CLI under the world
    of 4: every request completes on rank 0, both replicas took work,
    the other ranks serve or follow and report no summary."""
    cli = [r["fleet"]["cli"] for r in runs[1][4]]
    lead = cli[0]
    assert lead["summary"]["completed"] == 6
    assert sum(len(t) for t in lead["tokens"].values()) == \
        lead["summary"]["generated_tokens"]
    assert all(n > 0 for n in lead["router"]["routed"])
    assert lead["remote"]["round_trips"] > 0
    assert all(c["summary"] is None and c["calls"] > 0 for c in cli[1:])
    assert cli[2]["stats"]["decode_ticks"] == cli[3]["stats"][
        "decode_ticks"] > 0
