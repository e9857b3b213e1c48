"""The goodput ledger against a scripted fault trace: the JAX package's
``analysis/ledger_audit.py`` (its graftcheck ``ledger`` pass), run on
the port's ledger.

The ledger's whole contract is exactness — ``sum(categories) ==
wall_clock`` to the nanosecond, and fault time (rework, restore,
backoff) attributed to the *expected* integer second counts.  Wall-clock
tests cannot pin that (machine noise swamps it), so this audit drives
the REAL :class:`~..obs.ledger.GoodputLedger` with a virtual clock
through a scripted supervised fault trace:

- **attempt 1**: compile probe, steps ``0..CRASH_STEP-1`` (checkpoint at
  the cadence), then a crash — the process dies without finalizing, the
  attempt's snapshot is only audited for mid-run identity;
- **supervisor**: sleeps :data:`BACKOFF_S` and relaunches (the child
  inherits the cumulative backoff, exactly as ``utils/supervisor.py``
  hands it over through the env);
- **attempt 2**: restores from the last committed checkpoint
  (``ckpt_restore`` bracket), reads the progress watermark, re-executes
  the lost steps (``rework``, minus the first step which is ``compile``
  — the restart's recompile takes precedence), finishes the run, and
  finalizes.

Every duration in the script is a binary-exact float (multiples of
2^-3 s), so each expected category total is ONE exact integer in ns —
the audit asserts equality, not closeness.  The whole trace runs twice
and the two result dicts must be identical (the ledger holds no hidden
real-clock reads), and a two-rank fleet merge (rank 1 scripted slower)
must satisfy ``sum(categories) + idle_gap == n x max_wall`` with the
idle residual attributed to the straggler.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

from ..obs.ledger import GoodputLedger, fleet_ledger
from .findings import Finding

# Scripted durations (seconds).  All are multiples of 2^-3 so every sum
# is a binary-exact float and _ns() conversion is exact on every
# platform — the audit's equality assertions depend on this.
COMPILE_PROBE_S = 4.0     # CLI compile-probe bracket, every attempt
PULL_S = 0.125            # input-pipeline pull per batch -> data_wait
DISPATCH_S = 0.5          # batch-ready -> dispatch (device-bound wait)
TAIL_S = 0.25             # post-dispatch host tail
CKPT_S = 1.0              # checkpoint save bracket
RESTORE_S = 2.0           # checkpoint restore bracket (attempt 2)
BACKOFF_S = 2.5           # supervisor crash backoff before attempt 2
EPOCH_TAIL_S = 0.5        # post-loop epoch bookkeeping -> other
GS_PER_STEP_S = 0.25      # analytic grad-sync quota per step
GS_ICI_SHARE = 0.5        # half the quota on the ICI fabric

N_STEPS = 8               # global steps 0..7
CKPT_EVERY = 3            # commit after steps 2 and 5 (global 3, 6)
CRASH_STEP = 5            # crash before step 5 dispatches (progress = 5)
RESUME_STEP = 3           # last committed checkpoint (global step 3)


class _VirtualClock:
    """Monotonic clock the script advances explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


def _batches(clock: _VirtualClock, n: int) -> Any:
    for _ in range(n):
        clock.advance(PULL_S)
        yield None


def _run_attempt(
    clock: _VirtualClock,
    progress_path: str,
    *,
    start_step: int,
    stop_before: int,
    inherited_backoff_s: float,
    restore: bool,
    extra_tail_s: float = 0.0,
) -> dict[str, Any]:
    """One process of the supervised run, scripted against the virtual
    clock; returns the ledger's final (or crash-instant) snapshot."""
    ledger = GoodputLedger(
        clock=clock, progress_path=progress_path,
        inherited_backoff_s=inherited_backoff_s,
    )
    if restore:
        prev = GoodputLedger.read_progress(progress_path)
        if prev is not None:
            ledger.set_rework_until(prev)
        with ledger.bracket("ckpt_restore"):
            clock.advance(RESTORE_S)
    with ledger.bracket("compile"):
        clock.advance(COMPILE_PROBE_S)
    ledger.set_grad_sync_model(GS_PER_STEP_S, ici_share=GS_ICI_SHARE)

    crashed = False
    step = start_step
    for _ in ledger.wrap_batches(_batches(clock, N_STEPS - start_step)):
        if step == stop_before:
            crashed = True
            break  # the crash: no finalize, the attempt's log is lost
        clock.advance(DISPATCH_S)
        ledger.begin_step(step)
        clock.advance(TAIL_S + extra_tail_s)
        if (step + 1) % CKPT_EVERY == 0:
            with ledger.bracket("ckpt_save"):
                clock.advance(CKPT_S)
        step += 1
        ledger.note_progress(step)
    if crashed:
        return ledger.snapshot()
    clock.advance(EPOCH_TAIL_S)
    return ledger.finalize()


def _run_trace(extra_tail_s: float = 0.0) -> dict[str, Any]:
    """The full supervised fault trace: crash, backoff, restore, finish.
    Returns the crash-instant snapshot and the surviving final record."""
    with tempfile.TemporaryDirectory(prefix="ledger_audit_") as tmp:
        progress = os.path.join(tmp, ".progress")
        clock = _VirtualClock()
        crash_snap = _run_attempt(
            clock, progress, start_step=0, stop_before=CRASH_STEP,
            inherited_backoff_s=0.0, restore=False,
            extra_tail_s=extra_tail_s,
        )
        clock.advance(BACKOFF_S)  # the supervisor's sleep
        final = _run_attempt(
            clock, progress, start_step=RESUME_STEP, stop_before=N_STEPS,
            inherited_backoff_s=BACKOFF_S, restore=True,
            extra_tail_s=extra_tail_s,
        )
    return {"crash": crash_snap, "final": final}


def _ns(seconds: float) -> int:
    return int(round(seconds * 1e9))


def expected_final_categories_ns() -> dict[str, int]:
    """Attempt 2's expected attribution, derived from the script's
    constants — the numbers the audit pins the real ledger against."""
    step_interval = DISPATCH_S + TAIL_S
    n_resumed = N_STEPS - RESUME_STEP            # steps 3..7
    n_rework = CRASH_STEP - RESUME_STEP - 1      # step 4 (3 is compile)
    n_fresh = N_STEPS - CRASH_STEP               # steps 5..7
    n_ckpts = sum(
        1 for s in range(RESUME_STEP, N_STEPS) if (s + 1) % CKPT_EVERY == 0
    )
    return {
        "compile": _ns(COMPILE_PROBE_S + step_interval),
        "rework": _ns(n_rework * step_interval),
        "grad_sync": _ns(n_fresh * GS_PER_STEP_S),
        "step_compute": _ns(n_fresh * (step_interval - GS_PER_STEP_S)),
        "data_wait": _ns(n_resumed * PULL_S),
        "ckpt_save": _ns(n_ckpts * CKPT_S),
        "ckpt_restore": _ns(RESTORE_S),
        "supervisor_backoff": _ns(BACKOFF_S),
        "other": _ns(EPOCH_TAIL_S),
    }


def run_ledger_audit() -> tuple[list[Finding], dict[str, Any]]:
    """The ``ledger`` audit: scripted-trace attribution
    (EXACT), mid-run + final identity (EXACT), run-twice determinism,
    and the two-rank fleet-merge identity with straggler attribution."""
    findings: list[Finding] = []

    def _fail(rule: str, message: str) -> None:
        findings.append(Finding(
            rule=rule, message=message, path="ledger/fault-trace",
            analysis_pass="ledger",
            fixit="obs/ledger.py attribution drifted from the scripted "
                  "trace — every charge must be integer-ns and land in "
                  "exactly one category",
        ))

    run_a = _run_trace()
    run_b = _run_trace()
    if run_a != run_b:
        _fail(
            "ledger-determinism",
            "two runs of the identical scripted trace produced different "
            "ledgers — a hidden real-clock read or ordering dependence",
        )

    for label, snap in (("crash", run_a["crash"]), ("final", run_a["final"])):
        total = sum(snap["categories_ns"].values())
        if total != snap["wall_ns"]:
            _fail(
                "ledger-identity",
                f"{label} snapshot: sum(categories)={total}ns != "
                f"wall={snap['wall_ns']}ns (off by "
                f"{total - snap['wall_ns']}ns)",
            )

    final = run_a["final"]
    expected = expected_final_categories_ns()
    for cat, exp in expected.items():
        got = final["categories_ns"].get(cat, 0)
        if got != exp:
            _fail(
                "ledger-attribution",
                f"category {cat}: got {got}ns, scripted trace expects "
                f"exactly {exp}ns",
            )
    gs_ici_exp = _ns(
        (N_STEPS - CRASH_STEP) * GS_PER_STEP_S * GS_ICI_SHARE
    )
    if final["grad_sync_ici_ns"] != gs_ici_exp:
        _fail(
            "ledger-attribution",
            f"grad_sync ICI split: got {final['grad_sync_ici_ns']}ns, "
            f"expects exactly {gs_ici_exp}ns",
        )
    rework_intervals = final["step_intervals"].get("rework", 0)
    if rework_intervals != CRASH_STEP - RESUME_STEP - 1:
        _fail(
            "ledger-attribution",
            f"rework step intervals: got {rework_intervals}, expects "
            f"{CRASH_STEP - RESUME_STEP - 1} (first resumed step is "
            "compile, not rework)",
        )

    # Fleet merge: rank 1 runs the same trace with a slower host tail;
    # rank 0's gap to it is idle, attributed to the straggler, and the
    # fleet identity must hold in integer ns.
    slow = _run_trace(extra_tail_s=0.125)["final"]
    fleet = fleet_ledger({0: final, 1: slow}, straggler_rank=1)
    if not fleet["identity_ok"]:
        _fail(
            "ledger-identity",
            "fleet merge: sum(categories) + idle_gap != n_ranks x "
            "max(rank wall)",
        )
    if fleet["idle_attributed_to"] != 1:
        _fail(
            "ledger-attribution",
            f"fleet idle attributed to rank "
            f"{fleet['idle_attributed_to']}, scripted straggler is rank 1",
        )

    report = {
        "expected_s": {k: v / 1e9 for k, v in expected.items()},
        "got_s": {
            k: v / 1e9 for k, v in final["categories_ns"].items()
        },
        "wall_s": final["wall_s"],
        "goodput_fraction": final["goodput_fraction"],
        "identity_ok": final["identity_ok"],
        "determinism_ok": run_a == run_b,
        "fleet_identity_ok": fleet["identity_ok"],
        "fleet_idle_gap_s": {
            r: v / 1e9 for r, v in fleet["idle_gap_ns"].items()
        },
        "findings": len(findings),
    }
    return findings, report
