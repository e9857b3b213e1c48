"""Serving SLO metrics: TTFT / TPOT percentiles, goodput, queue depth —
the counterpart of the JAX package's ``serve/metrics.py`` for one engine
(the replica and failover views wait for the router's port).

- **TTFT** (time to first token): arrival → first sampled token.
- **TPOT** (time per output token): ``(finish - first_token) /
  (generated - 1)``.
- **Goodput** counts only tokens of completed requests per second.
"""

from __future__ import annotations

import numpy as np

from ..obs import percentiles


def percentile(xs, q: float) -> float | None:
    """One linear-interpolated percentile; None for an empty sample."""
    (value,) = percentiles(xs, (q,)).values()
    return value


def finalize_record(rec: dict) -> dict:
    """Derive ttft/tpot in place from a finished request's raw timestamps
    (a scheduler record or a re-read JSONL line)."""
    if rec.get("first_token") is not None:
        rec["ttft"] = rec["first_token"] - rec["arrival"]
    else:
        rec["ttft"] = None
    if (
        rec.get("finish") is not None
        and rec.get("first_token") is not None
        and rec.get("generated", 0) > 1
    ):
        rec["tpot"] = (rec["finish"] - rec["first_token"]) / (
            rec["generated"] - 1
        )
    else:
        rec["tpot"] = None
    return rec


def summarize_records(
    records: list[dict],
    *,
    elapsed: float | None = None,
    queue_depth_samples: list[int] | None = None,
    rejected: int = 0,
    active_slot_samples: list[int] | None = None,
    engine_stats: dict | None = None,
) -> dict:
    """Aggregate finished per-request records into the SLO summary.

    Deadline-shed (``"shed"``) and mid-decode cancelled (``"cancelled"``)
    requests count in their own fields and in ``finish_reasons`` but are
    excluded from ``completed`` and from every latency and goodput
    figure: nobody received what they produced."""
    finished = [r for r in records if r.get("finish") is not None]
    completed = [
        r for r in finished
        if r.get("finish_reason") not in ("shed", "cancelled")
    ]
    tokens = sum(r.get("generated", 0) for r in completed)
    if elapsed is None and completed:
        t0 = min(r["arrival"] for r in completed)
        t1 = max(r["finish"] for r in completed)
        elapsed = max(t1 - t0, 1e-9)
    out = {
        "completed": len(completed),
        "rejected": int(rejected),
        "shed": sum(1 for r in finished if r.get("finish_reason") == "shed"),
        "cancelled": sum(
            1 for r in finished if r.get("finish_reason") == "cancelled"
        ),
        "generated_tokens": int(tokens),
        "elapsed_s": round(elapsed, 4) if elapsed else None,
        "goodput_tok_per_s": (
            round(tokens / elapsed, 2) if elapsed else None
        ),
        "ttft_p50_s": percentile([r["ttft"] for r in completed], 50),
        "ttft_p99_s": percentile([r["ttft"] for r in completed], 99),
        "tpot_p50_s": percentile([r["tpot"] for r in completed], 50),
        "tpot_p99_s": percentile([r["tpot"] for r in completed], 99),
        "finish_reasons": {
            reason: sum(
                1 for r in finished if r.get("finish_reason") == reason
            )
            for reason in sorted(
                {r.get("finish_reason") for r in finished} - {None}
            )
        },
    }
    if queue_depth_samples:
        out["queue_depth_mean"] = round(
            float(np.mean(queue_depth_samples)), 2
        )
        out["queue_depth_max"] = int(np.max(queue_depth_samples))
    if active_slot_samples:
        out["live_slots_max"] = int(np.max(active_slot_samples))
        out["live_slots_mean"] = round(
            float(np.mean(active_slot_samples)), 2
        )
    if engine_stats:
        out["engine"] = dict(engine_stats)
        if engine_stats.get("spec_drafted_tokens") is not None:
            drafted = engine_stats["spec_drafted_tokens"]
            accepted = engine_stats["spec_accepted_tokens"]
            ticks = engine_stats.get("decode_ticks", 0)
            slot_ticks = engine_stats.get("decode_slot_ticks", 0)
            out["spec"] = {
                "drafted_tokens": int(drafted),
                "accepted_tokens": int(accepted),
                "rejected_tokens": int(drafted - accepted),
                "acceptance_rate": (
                    round(accepted / drafted, 4) if drafted else None
                ),
                # Batch-level emission rate (conflates live-slot count
                # with speculation)...
                "tokens_per_decode_tick": (
                    round(engine_stats["decode_tokens"] / ticks, 3)
                    if ticks else None
                ),
                # ...vs the per-slot factor: 1.0 is one token per tick.
                "tokens_per_slot_tick": (
                    round(engine_stats["decode_tokens"] / slot_ticks, 3)
                    if slot_ticks else None
                ),
            }
    for k in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s"):
        if out[k] is not None:
            out[k] = round(out[k], 6)
    return out
