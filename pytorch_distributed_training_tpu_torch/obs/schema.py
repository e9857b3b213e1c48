"""Metric-name schema registry: every live-plane metric, declared once.

The emitter/aggregator API is stringly typed — ``emitter.gauge("mfu_live",
...)`` — so a typo'd name silently forks a new time series instead of
failing (``mfu_live`` vs ``mfu-live`` was only caught by a dashboard
going blank).  This module is the single source of truth: every
``gauge``/``counter_add``/``observe`` name in the codebase is declared
here with its instrument type, and :func:`check_metric_name` says
whether a name (labels included) is declared for an instrument; the
tests hold every name the port emits to it.

Deliberately import-free (no torch, no package ``__init__``).  The
port's own copy of the JAX package's ``obs/schema.py``: the port emits
only names registered here.

Naming conventions the checker understands:

- plain names must match a declared entry exactly;
- ``labeled=True`` entries may carry label suffixes at the call site —
  the bracket form ``name[key=value,...]`` (obs/live.py ``labeled()``)
  or a per-replica ``_r<k>`` suffix — and dynamic (f-string) names are
  accepted when their static prefix extends a declared labeled name;
- dynamic names whose static prefix is a prefix of a declared name
  (e.g. ``f"ledger_{cat}_s"``) are accepted against that family.
"""

from __future__ import annotations

GAUGE = "gauge"
COUNTER = "counter"
HISTOGRAM = "histogram"

# name -> {"type": instrument, "labeled": bool, "help": one-liner}
METRICS: dict[str, dict] = {
    # ---- training loop (train/trainer.py, obs/ledger.py) ----------------
    "mfu_live": {
        "type": GAUGE, "labeled": False,
        "help": "rolling live MFU: compiled FLOPs / median recent step time",
    },
    "step_time_s": {
        "type": HISTOGRAM, "labeled": False,
        "help": "host wall time per optimizer step",
    },
    "goodput_fraction": {
        "type": GAUGE, "labeled": False,
        "help": "(step_compute + grad_sync) / wall clock, ledger-attributed",
    },
    "ledger_compile_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: cumulative compile seconds",
    },
    "ledger_step_compute_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: cumulative step-compute seconds",
    },
    "ledger_grad_sync_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: cumulative gradient-sync seconds",
    },
    "ledger_grad_sync_ici_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: grad-sync seconds on the ICI fabric",
    },
    "ledger_grad_sync_dcn_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: grad-sync seconds on the DCN fabric",
    },
    "ledger_data_wait_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: cumulative input-wait seconds",
    },
    "ledger_ckpt_save_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: cumulative checkpoint-save seconds",
    },
    "ledger_ckpt_restore_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: cumulative checkpoint-restore seconds",
    },
    "ledger_rework_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: seconds re-executed/discarded after faults",
    },
    "ledger_supervisor_backoff_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: supervisor crash-backoff seconds",
    },
    "ledger_other_s": {
        "type": GAUGE, "labeled": False,
        "help": "goodput ledger: unattributed (setup/teardown/eval) seconds",
    },
    # ---- SLO / alerting plane (obs/slo.py) ------------------------------
    "slo_alert_transitions": {
        "type": COUNTER, "labeled": False,
        "help": "burn-rate alert state transitions",
    },
    "anomaly_alerts": {
        "type": COUNTER, "labeled": False,
        "help": "anomaly events promoted to alerts",
    },
    # ---- flight recorder (obs/flight.py) --------------------------------
    "queue_depth": {
        "type": GAUGE, "labeled": False,
        "help": "serving admission queue depth",
    },
    # ---- serving tier (serve/scheduler.py, router, failover, autoscale) -
    "ttft_s": {
        "type": HISTOGRAM, "labeled": True,
        "help": "time to first token (per tenant/replica via labels)",
    },
    "tpot_s": {
        "type": HISTOGRAM, "labeled": True,
        "help": "time per output token (per tenant/replica via labels)",
    },
    "generated_tokens": {
        "type": COUNTER, "labeled": True,
        "help": "tokens generated for finished requests",
    },
    "finished_requests": {
        "type": COUNTER, "labeled": True,
        "help": "requests finished",
    },
    "cancelled_requests": {
        "type": COUNTER, "labeled": False,
        "help": "requests cancelled past their deadline mid-decode",
    },
    "failed_requests": {
        "type": COUNTER, "labeled": False,
        "help": "requests failed after retry budget exhaustion",
    },
    "rejected_requests": {
        "type": COUNTER, "labeled": False,
        "help": "requests rejected at admission",
    },
    "shed_requests": {
        "type": COUNTER, "labeled": False,
        "help": "requests shed under brownout",
    },
    "spec_acceptance_rate": {
        "type": HISTOGRAM, "labeled": False,
        "help": "speculative decoding draft acceptance rate",
    },
    "spec_tokens_per_slot_tick": {
        "type": HISTOGRAM, "labeled": False,
        "help": "tokens committed per slot per tick under speculation",
    },
    "serve_slots_active": {
        "type": GAUGE, "labeled": True,
        "help": "busy decode slots (per replica via suffix)",
    },
    "serve_prefill_slots_active": {
        "type": GAUGE, "labeled": True,
        "help": "slots in prefill (per replica via suffix)",
    },
    "serve_decode_slots_active": {
        "type": GAUGE, "labeled": True,
        "help": "slots in decode (per replica via suffix)",
    },
    "kv_blocks_in_use": {
        "type": GAUGE, "labeled": True,
        "help": "paged-KV blocks referenced by live sequences",
    },
    "kv_blocks_cached": {
        "type": GAUGE, "labeled": True,
        "help": "paged-KV blocks held by the prefix cache",
    },
    "kv_block_occupancy": {
        "type": GAUGE, "labeled": True,
        "help": "paged-KV pool occupancy fraction",
    },
    "kv_block_bytes": {
        "type": GAUGE, "labeled": True,
        "help": "paged-KV pool bytes",
    },
    "kv_host_blocks": {
        "type": GAUGE, "labeled": True,
        "help": "KV blocks swapped to host memory",
    },
    "kv_host_bytes": {
        "type": GAUGE, "labeled": True,
        "help": "KV bytes swapped to host memory",
    },
    "router_pending_depth": {
        "type": GAUGE, "labeled": False,
        "help": "requests parked in the router awaiting placement",
    },
    "router_queue_depth": {
        "type": GAUGE, "labeled": True,
        "help": "per-replica scheduler queue depth (_r<k> suffix)",
    },
    "router_slots_active": {
        "type": GAUGE, "labeled": True,
        "help": "per-replica busy slots (_r<k> suffix)",
    },
    "replicas_dead": {
        "type": GAUGE, "labeled": False,
        "help": "replicas the failover controller declared dead",
    },
    "replicas_degraded": {
        "type": GAUGE, "labeled": False,
        "help": "replicas flagged as stragglers",
    },
    "replicas_parked": {
        "type": GAUGE, "labeled": False,
        "help": "replicas parked by the autoscaler",
    },
    "autoscale_replicas_active": {
        "type": GAUGE, "labeled": False,
        "help": "replicas the autoscale controller holds active",
    },
    "autoscale_ladder_rung": {
        "type": GAUGE, "labeled": False,
        "help": "pressure-ladder rung the autoscaler sits on",
    },
    "autoscale_split_bias": {
        "type": GAUGE, "labeled": False,
        "help": "prefill/decode role-split bias under disaggregation",
    },
    # ---- elastic world resizing (training membership plane) ----------
    "elastic_world_size": {
        "type": GAUGE, "labeled": False,
        "help": "current data-parallel world size of the elastic run",
    },
    "elastic_shrinks": {
        "type": COUNTER, "labeled": False,
        "help": "shrink-to-survivors transitions after a slice loss",
    },
    "elastic_grows": {
        "type": COUNTER, "labeled": False,
        "help": "grow-back transitions after a slice returned",
    },
    "elastic_peer_restores": {
        "type": COUNTER, "labeled": False,
        "help": "restores served from the peer-RAM snapshot tier",
    },
    "elastic_peer_snapshot_bytes": {
        "type": COUNTER, "labeled": False,
        "help": "DCN bytes spent mirroring snapshot rows to buddies",
    },
    "elastic_host_stalls": {
        "type": COUNTER, "labeled": False,
        "help": "host stalls flagged below the slice-loss patience",
    },
}

_METHOD_TYPES = {"gauge": GAUGE, "counter_add": COUNTER, "observe": HISTOGRAM}


def check_metric_name(
    name: str, method: str, *, dynamic: bool = False
) -> str | None:
    """Validate one call-site metric name against the registry.

    ``name`` is the literal string (or, with ``dynamic=True``, the static
    prefix of an f-string).  ``method`` is the emitter method used
    (``gauge`` / ``counter_add`` / ``observe``).  Returns None when the
    name checks out, else a human-readable problem description.
    """
    want_type = _METHOD_TYPES.get(method)
    if want_type is None:
        return None

    def type_problem(entry_name: str) -> str | None:
        entry = METRICS[entry_name]
        if entry["type"] != want_type:
            return (
                f"metric {entry_name!r} is declared a {entry['type']} but "
                f"used via .{method}()"
            )
        return None

    base = name.split("[", 1)[0]
    if base in METRICS:
        if "[" in name and not METRICS[base]["labeled"]:
            return (
                f"metric {base!r} is not declared labeled=True but is used "
                "with a label suffix"
            )
        return type_problem(base)
    if dynamic:
        # Static prefix of an f-string: accept a prefix of any declared
        # name (a name family like ledger_<cat>_s) or an extension of a
        # declared labeled name (per-replica suffixes).
        for entry_name, entry in METRICS.items():
            if entry_name.startswith(base) and type_problem(entry_name) is None:
                return None
            if entry["labeled"] and base.startswith(entry_name):
                return type_problem(entry_name)
        return (
            f"dynamic metric name with static prefix {base!r} matches no "
            "declared metric family (obs/schema.py)"
        )
    if base != name:
        return (
            f"labeled metric base {base!r} is not declared in obs/schema.py"
        )
    return f"metric name {name!r} is not declared in obs/schema.py"
