"""The JAX package's serving fleet and the port's side by side, for the
parity tests of the failover, autoscale and priority controllers
(``tests/test_torch_serve_failover.py``, ``tests/test_torch_serve_autoscale
.py``).

A :class:`Side` holds one package's classes and JAX's tiny GPT-2 (the
port's carries JAX's weights through ``models/convert.py``), so one
scenario function runs on either side and returns the same observation:
the greedy tokens by request id, each record's finish reason, retries,
replica history and stamps, the controllers' stats, the ticks of every
respawn, the routing counters.  The JAX side's observations are computed
once a run and shared by the xdist workers (``tests/torch_shared.py``).
"""

from __future__ import annotations

import numpy as np

SMALL = dict(num_layers=2, hidden_dim=32, num_heads=2, vocab_size=61,
             max_seq_len=48)
ENGINE = dict(num_slots=2, max_len=48, prefill_chunk=4, temperature=0.0,
              paged=True, block_size=4, num_blocks=24)
RECORD_KEYS = ("finish_reason", "retries", "replica_history", "replica",
               "generated", "prompt_len", "max_new_tokens", "arrival",
               "admitted", "first_token", "finish", "tenant")


def jax_params():
    import jax
    import jax.numpy as jnp

    from pytorch_distributed_training_tpu.models import gpt2_124m

    m = gpt2_124m(cfg_overrides=SMALL)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((2, 8), jnp.int32),
                    train=False)["params"]
    return m, params


def converted() -> dict:
    """JAX's tiny GPT-2 weights under the port's names (numpy)."""
    import jax

    from pytorch_distributed_training_tpu_torch.models import (
        gpt2_params_from_jax,
    )

    _, params = jax_params()
    return {k: v.numpy() for k, v in gpt2_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


class Side:
    """One package's serving classes and its tiny GPT-2: ``"jax"``, or
    ``"torch"`` with the converted weights ``named``."""

    def __init__(self, which: str, named: dict | None = None):
        self.which = which
        if which == "jax":
            from pytorch_distributed_training_tpu import obs, resilience
            from pytorch_distributed_training_tpu import serve
            from pytorch_distributed_training_tpu.obs import slo
            from pytorch_distributed_training_tpu.serve import autoscale
            from pytorch_distributed_training_tpu.utils import backoff
            from pytorch_distributed_training_tpu.utils import metrics

            self.model, self.params = jax_params()
        else:
            import torch

            from pytorch_distributed_training_tpu_torch import (
                obs, resilience, serve,
            )
            from pytorch_distributed_training_tpu_torch.models import (
                GPT2, GPT2Config,
            )
            from pytorch_distributed_training_tpu_torch.obs import slo
            from pytorch_distributed_training_tpu_torch.serve import (
                autoscale,
            )
            from pytorch_distributed_training_tpu_torch.utils import (
                backoff, metrics,
            )

            model = GPT2(GPT2Config(**SMALL))
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in named.items()})
            self.model = model.eval()
        self.serve, self.obs, self.slo = serve, obs, slo
        self.resilience, self.autoscale = resilience, autoscale
        self.BackoffPolicy = backoff.BackoffPolicy
        self.RequestLogger = metrics.RequestLogger

    def __getattr__(self, name):
        return getattr(self.serve, name)

    def engine(self, **kw):
        kw = {**ENGINE, **kw}
        if self.which == "jax":
            return self.serve.ServingEngine(self.model, self.params, **kw)
        return self.serve.ServingEngine(self.model, device="cpu", **kw)

    def disagg(self, **kw):
        if self.which == "jax":
            return self.serve.DisaggServingEngine(self.model, self.params,
                                                  **kw)
        return self.serve.DisaggServingEngine(self.model, device="cpu", **kw)

    def chaos(self, spec: str, **kw):
        return self.resilience.ServeFaultInjector.from_spec(spec, **kw)

    def backoff(self, base_s: float):
        return self.BackoffPolicy(base_s=base_s, jitter=0.0)


def workload(n=8, seed=0, b_lo=4, b_hi=9):
    """JAX's ``_workload``: ragged prompts and budgets."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 61, (int(rng.integers(3, 10)),))
             .astype(np.int32), int(rng.integers(b_lo, b_hi)))
            for _ in range(n)]


def streams(engines) -> dict:
    """Every engine's streamed tokens into one dict by request id."""
    toks: dict = {}
    for e in engines:
        e.stream_cb = lambda rid, t: toks.setdefault(rid, []).append(int(t))
    return toks


def baseline(side: Side, work, **engine_kw) -> dict:
    """The greedy streams of one plain scheduler (JAX's oracle)."""
    eng = side.engine(**engine_kw)
    toks = streams([eng])
    sched = side.ContinuousScheduler(eng, max_queue=64,
                                     clock=side.VirtualClock())
    for i, (p, b) in enumerate(work):
        sched.submit(side.Request(i, p, b))
    while not sched.idle:
        sched.tick()
    return toks


def drive(router, clock, requests, max_ticks=300, dt=0.01) -> int:
    """JAX's ``_drive``: submit everything, tick until idle."""
    for r in requests:
        router.submit(r)
    ticks = 0
    while not router.idle and ticks < max_ticks:
        router.tick()
        clock.advance(dt)
        ticks += 1
    assert router.idle, "trace did not converge"
    return ticks


def watch_respawns(ctrl, router) -> list:
    """The router tick of every respawn ``ctrl`` makes."""
    ticks: list = []
    respawn = ctrl._respawn

    def logged(k, now):
        ticks.append((k, router.tick_index))
        return respawn(k, now)

    ctrl._respawn = logged
    return ticks


def _plain(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def observe(router, ctrl=None, toks=None, respawns=None, **extra) -> dict:
    """What a parity case compares: tokens, every record's fields, the
    routing counters, the controller's stats and health, respawn ticks."""
    recs = router.completed
    st = router.stats()
    out = {
        "ids": sorted(str(r["id"]) for r in recs),
        "records": {str(r["id"]): {k: r.get(k) for k in RECORD_KEYS}
                    for r in recs},
        "router": {k: st[k] for k in ("routed", "affinity_hits",
                                      "rebalanced", "rejected",
                                      "sibling_fetches",
                                      "sibling_fetch_blocks")},
        "tick": router.tick_index,
    }
    if toks is not None:
        out["tokens"] = {str(k): v for k, v in toks.items()}
    if ctrl is not None:
        out["stats"] = ctrl.stats()
        out["health"] = [(h.state, h.deaths, h.dead_role)
                         for h in ctrl.health]
    if respawns is not None:
        out["respawns"] = list(respawns)
    out.update(extra)
    return _plain(out)
