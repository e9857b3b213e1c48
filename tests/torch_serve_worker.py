"""The rank side of ``tests/test_torch_serve_tp.py``: gloo ranks on the
CPU, launched once per world size by ``tests/torch_dp_worker.launch``
(every rank writes ``OUT/rank<r>.pkl``).  Imports the port only, never
JAX.

``tp OUT`` at world 2 or 4: the tiny GPT-2s of ``OUT/init<heads>.npz``
(JAX's weights under the port's names) served tensor-parallel over the
whole world (``parallel/sharded.py::shard_for_serving``), the first rank
driving the others in lockstep (``serve/tp.py``): every case of
``CASES`` (its greedy tokens, each rank's cache and parameter shapes,
prefill forwards and decode ticks), the memory models of ``MEMORY``, and
at world 2 the CLI's ``--serve-tp 2`` and its refusal of heads the world
does not divide.  At world 4, the fleet: TP 2 x 2 replicas
(``serve/tp.py``'s ``run_fleet_rank``), rank 0's router over its own group
and the other group's leader, on ``fleet_requests``' scripted trace, with
and without ``FLEET_CRASH`` (``fleet_run``, which the test also runs
through JAX's router over two unsharded replicas), then the CLI's
``--serve-tp 2 --serve-replicas 2``.
"""

from __future__ import annotations

import copy
import os
import pickle
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX's tests/test_serve_tp.py model, and the same widths at 4 heads (the
# port refuses heads the tensor axis does not divide).
SMALL = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=61,
             max_seq_len=48)
SMALL4 = dict(SMALL, num_heads=4)
BASE = dict(max_len=48, prefill_chunk=4, temperature=0.0)


def requests(n: int = 5, seed: int = 7):
    """JAX's ``_requests``: ragged prompts and budgets."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 61, (int(rng.integers(3, 9)),))
               .astype(np.int32) for _ in range(n)]
    return prompts, [6, 4, 8, 5, 7][:n]


def spec_requests():
    """JAX's speculative case: repetitive tails force multi-token
    accepts."""
    rng = np.random.default_rng(3)
    pat = rng.integers(0, 61, (3,)).astype(np.int32)
    prompts = [
        np.tile(pat, 5)[:12].astype(np.int32),
        np.concatenate([rng.integers(0, 61, (4,)), np.tile(pat, 4)]
                       ).astype(np.int32),
        rng.integers(0, 61, (7,)).astype(np.int32),
    ]
    return prompts, [10, 8, 6]


def disagg_requests():
    """tests/test_serve_disagg.py's ``_trace``."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 61, (n,)).astype(np.int32)
               for n in [4, 14, 6, 9, 5]]
    return prompts, [6, 5, 8, 4, 7]


# label -> (heads, engine kind, engine kwargs, trace, worlds)
CASES = {
    "contig": (2, "engine", dict(BASE, num_slots=3, block_size=8),
               requests, (2,)),
    "paged": (2, "engine", dict(BASE, num_slots=3, block_size=8,
                                paged=True), requests, (2,)),
    "spec_contig": (2, "engine", dict(BASE, num_slots=2, block_size=8,
                                      spec_k=4), spec_requests, (2,)),
    "spec_paged": (2, "engine", dict(BASE, num_slots=2, block_size=8,
                                     paged=True, spec_k=4),
                   spec_requests, (2,)),
    "pallas": (2, "engine", dict(BASE, num_slots=2, block_size=8,
                                 paged=True, spec_k=3),
               lambda: requests(3), (2,)),
    "disagg_paged": (2, "disagg", dict(BASE, prefill_slots=1,
                                       decode_slots=3, block_size=4,
                                       paged=True), disagg_requests, (2,)),
    "tp4_contig": (4, "engine", dict(BASE, num_slots=2),
                   lambda: requests(3), (2, 4)),
    "tp4_paged_spec": (4, "engine", dict(BASE, num_slots=2, block_size=8,
                                         paged=True, spec_k=3),
                       lambda: requests(3), (2, 4)),
}
# The memory models held to JAX's at TP 2: label -> engine kwargs.
MEMORY = {
    "contig": dict(BASE, num_slots=3, block_size=8),
    "paged": dict(BASE, num_slots=3, block_size=8, paged=True),
    "int8": dict(BASE, num_slots=3, block_size=8, paged=True,
                 kv_dtype="int8"),
}
PROGRAMS = ("prefill", "decode", "verify")
# The fleet at world 4: a scripted trace (a shared prefix that warms one
# replica, then a burst the affinity cap rebalances with sibling fetches),
# host tiers on every pool, and a crash of replica 1 while it holds work.
FLEET_ENGINE = dict(num_slots=2, max_len=48, prefill_chunk=4,
                    temperature=0.0, paged=True, block_size=4,
                    num_blocks=24, kv_host_mb=2.0)
FLEET_CRASH = "replica_crash@23:1"
FLEET_DT = 0.05
CLI = ["--serve", "--use-cpu", "--model", "gpt2", "--model-overrides",
       "num_layers=2,hidden_dim=64,num_heads=2,vocab_size=256,max_seq_len=64",
       "--seq-len", "32", "--serve-requests", "6", "--serve-slots", "2",
       "--serve-max-new", "8", "--serve-tp", "2"]


def fleet_requests(request_cls) -> list:
    """One shared-prefix request at 0 s (it warms one replica), then six
    more sharing the prefix and one cold at 1 s: the affinity cap
    rebalances the burst with sibling fetches."""
    base = (np.arange(8, dtype=np.int32) * 5) % 61

    def prompt(seed):
        rng = np.random.default_rng(seed)
        return np.concatenate([base, rng.integers(0, 61, (3,))
                               .astype(np.int32)])

    return [request_cls(0, prompt(99), 2, arrival_time=0.0)] + [
        request_cls(i, prompt(i), 6, arrival_time=1.0)
        for i in range(1, 7)] + [
        request_cls(9, np.asarray([2, 4, 6, 8], np.int32), 6,
                    arrival_time=1.0)]


def fleet_run(ns: dict, engines: list, crash: bool) -> dict:
    """``fleet_requests`` through a router over ``engines`` (affinity cap
    1) under a ``VirtualClock`` advanced ``FLEET_DT`` a tick, with the
    chaos plane and a failover controller when ``crash``: the tokens, the
    routing counters, the failover block and each record's outcome.
    ``ns`` holds one package's ``VirtualClock``, ``ReplicaRouter``,
    ``Request``, ``FailoverController``, ``ServeFaultInjector`` and
    ``BackoffPolicy``."""
    clock = ns["VirtualClock"]()
    toks: dict = {}
    for e in engines:
        e.stream_cb = lambda rid, t: toks.setdefault(str(rid), []).append(
            int(t))
    kw = {}
    if crash:
        kw = dict(chaos=ns["ServeFaultInjector"].from_spec(FLEET_CRASH),
                  failover=ns["FailoverController"](
                      miss_threshold=2, backoff=ns["BackoffPolicy"](
                          base_s=0.05, jitter=0.0)))
    router = ns["ReplicaRouter"](engines, clock=clock, affinity_queue_cap=1,
                                 **kw)
    pending = fleet_requests(ns["Request"])
    i = ticks = 0
    while i < len(pending) or not router.idle:
        while i < len(pending) and pending[i].arrival_time <= clock():
            router.submit(pending[i])
            i += 1
        router.tick()
        clock.advance(FLEET_DT)
        ticks += 1
        assert ticks < 2000, "the fleet trace did not converge"
    st = router.stats()
    return {
        "tokens": toks, "ticks": ticks,
        "router": {k: st[k] for k in ("routed", "affinity_hits",
                                      "rebalanced", "rejected",
                                      "sibling_fetches",
                                      "sibling_fetch_blocks")},
        "failover": st.get("failover"),
        "records": {str(r["id"]): [r["finish_reason"], r.get("retries"),
                                   r.get("replica_history")]
                    for r in router.completed},
    }


def drive(engine, prompts, budgets) -> dict:
    """JAX's ``_run``: raw engine ticks, FIFO admission into free slots;
    the streamed tokens by request."""
    out = {i: [] for i in range(len(prompts))}
    engine.stream_cb = lambda rid, tok: out[rid].append(tok)
    try:
        pend = list(range(len(prompts)))
        while pend or engine.busy:
            while pend and engine.has_free_slot and engine.can_admit(
                    prompts[pend[0]], budgets[pend[0]]):
                i = pend.pop(0)
                engine.start(i, prompts[i], budgets[i])
            engine.step()
    finally:
        engine.stream_cb = None
    return out


def _model(out: str, heads: int):
    from pytorch_distributed_training_tpu_torch.models import (
        GPT2, GPT2Config,
    )
    import torch

    cfg = SMALL if heads == 2 else SMALL4
    model = GPT2(GPT2Config(**cfg))
    with np.load(os.path.join(out, f"init{heads}.npz")) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    return model.eval()


def _tp(rank: int, world: int, out: str) -> dict:
    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.parallel import (
        shard_for_serving,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        DisaggServingEngine, LockstepEngine, ServingEngine, follow,
    )
    from pytorch_distributed_training_tpu_torch.serve.tp import (
        serving_groups,
    )

    mesh = make_mesh(MeshConfig(data=1, tensor=world))
    ctl, leader = serving_groups(mesh)
    whole = {h: _model(out, h) for h in (2, 4)}
    res: dict = {"cases": {}, "memory": {}}
    for label, (heads, kind, kw, trace, worlds) in CASES.items():
        if world not in worlds:
            continue
        model = shard_for_serving(copy.deepcopy(whole[heads]), mesh)
        if kind == "disagg":
            engine = DisaggServingEngine(model, device="cpu", **kw)
            role_engines = (engine.prefill_engine, engine.decode_engine)
        else:
            engine = ServingEngine(model, device="cpu", **kw)
            role_engines = (engine,)
        case = {
            "params": {n: tuple(p.shape) for n, p in model.named_parameters()},
            "cache": [tuple(t.shape) for t in role_engines[-1].pool.cache[0]],
        }
        if rank == leader:
            lock = LockstepEngine(engine, ctl, leader)
            try:
                case["tokens"] = drive(lock, *trace())
            except BaseException as e:
                lock.close(e)
                raise
            lock.close()
            case["broadcasts"] = lock.broadcasts
        else:
            case["applied"] = follow(engine, ctl, leader)
        case["prefill_ticks"] = sum(e.prefill_ticks for e in role_engines)
        case["decode_ticks"] = sum(e.decode_ticks for e in role_engines)
        case["stats"] = engine.stats()
        res["cases"][label] = case
    if world == 4:
        res["fleet"] = _fleet(rank, out)
    if world == 2:
        for label, kw in MEMORY.items():
            model = shard_for_serving(copy.deepcopy(whole[2]), mesh)
            engine = ServingEngine(model, device="cpu", **kw)
            res["memory"][label] = {p: engine.memory_model(p)
                                    for p in PROGRAMS}
        res["cli"] = _cli(rank)
    return res


def _fleet(rank: int, out: str) -> dict:
    """TP 2 x 2 replicas over the 4 ranks (``fleet_run`` on rank 0, with
    and without the crash), then the CLI's fleet; each rank's record."""
    import torch.distributed as dist

    from pytorch_distributed_training_tpu_torch.comm.mesh import (
        MeshConfig, make_mesh,
    )
    from pytorch_distributed_training_tpu_torch.parallel import (
        shard_for_serving,
    )
    from pytorch_distributed_training_tpu_torch.resilience import (
        ServeFaultInjector,
    )
    from pytorch_distributed_training_tpu_torch.serve import (
        FailoverController, ReplicaRouter, Request, ServingEngine,
        VirtualClock, hash_prompt_blocks,
    )
    from pytorch_distributed_training_tpu_torch.serve.tp import (
        RemoteReplica, ReplicaFabric, run_fleet_rank,
    )
    from pytorch_distributed_training_tpu_torch.utils.backoff import (
        BackoffPolicy,
    )

    ns = dict(VirtualClock=VirtualClock, ReplicaRouter=ReplicaRouter,
              Request=Request, FailoverController=FailoverController,
              ServeFaultInjector=ServeFaultInjector,
              BackoffPolicy=BackoffPolicy)
    mesh = make_mesh(MeshConfig(data=2, tensor=2))
    fabric = ReplicaFabric(mesh)
    whole = _model(out, 2)
    res: dict = {"group": fabric.group_index, "leader": fabric.leader}
    for label, crash in (("plain", False), ("crash", True)):
        model = shard_for_serving(copy.deepcopy(whole), mesh)
        engine = ServingEngine(model, device="cpu", **FLEET_ENGINE)

        def run(engines, crash=crash):
            got = fleet_run(ns, engines, crash)
            remote = [e for e in engines if isinstance(e, RemoteReplica)]
            got["remote"] = {"round_trips": remote[0].round_trips,
                             "cached_reads": remote[0].cached_reads}
            got["broadcasts"] = engines[0].broadcasts
            return got

        got = run_fleet_rank(fabric, engine, run)
        res[label] = {"calls": got} if rank else got
        res[label]["stats"] = engine.stats()
        # This rank's shard of the shared prefix's blocks (group 1 holds
        # them by the sibling fetch), by chain position.
        blocks = engine.pool.blocks
        chain = hash_prompt_blocks(fleet_requests(Request)[0].prompt,
                                   blocks.block_size)
        res[label]["prefix_bytes"] = [blocks.read_block_bytes(h)
                                      for h in chain]
        res[label]["heads"] = [tuple(t.shape)[1] for t in
                               engine.pool.blocks.cache[0]]
        dist.barrier()
    res["cli"] = _cli_fleet(rank)
    return res


def _cli_fleet(rank: int) -> dict:
    """``--serve-tp 2 --serve-replicas 2`` through the CLI (paged, a host
    tier, speculative) over the 4 ranks this process is one of."""
    from pytorch_distributed_training_tpu_torch.cli.main import main

    argv = CLI[:-2] + ["--serve-tp", "2", "--serve-replicas", "2",
                       "--serve-paged", "--serve-kv-host-mb", "1",
                       "--serve-spec"]
    result = main(argv)
    return {"summary": result["summary"], "tokens": result["tokens"],
            "stats": result["engine"], "rank": result["rank"],
            "router": result.get("router"), "remote": result.get("remote"),
            "calls": result.get("calls")}


def _cli(rank: int) -> dict:
    """``--serve-tp 2`` through the CLI in this process (it serves over
    the group this process joined), after its refusal of 3 heads over 2
    ranks."""
    from pytorch_distributed_training_tpu_torch.cli.main import main

    refused = None
    try:
        main(CLI[:4] + ["num_layers=2,hidden_dim=48,num_heads=3,"
                        "vocab_size=256,max_seq_len=64"] + CLI[5:])
    except SystemExit as e:
        refused = str(e.code)
    result = main(CLI)
    return {"refused": refused, "summary": result["summary"],
            "tokens": result["tokens"], "stats": result["engine"],
            "rank": result["rank"], "tp": result.get("tp")}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    from pytorch_distributed_training_tpu_torch.comm import init as comm_init

    torch.set_num_threads(1)
    task, out = sys.argv[1], sys.argv[2]
    comm_init.initialize("cpu")
    try:
        rank, world = comm_init.process_index(), comm_init.process_count()
        res = {"tp": _tp}[task](rank, world, out)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        comm_init.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
