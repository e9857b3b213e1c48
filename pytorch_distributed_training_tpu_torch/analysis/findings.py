"""Analyzer findings: the one record shape the JAX package's graftcheck
passes emit, copied so the port needs no JAX.  The port runs one pass of
its own, the goodput-ledger audit (``analysis/ledger_audit.py``); its
findings take this shape too.

A finding is one violation (or audit mismatch) with enough context to
jump to it and enough structure for a machine to gate on it.  The JSONL
wire form rides the obs spine (``MetricsEmitter.emit("record", ...)``),
so the telemetry tooling that reads step events reads analyzer runs;
``finding_record`` / ``finding_from_record`` are the schema roundtrip,
and ``validate_finding_records`` is the reader-side contract (an emitter
that validates through it fails on a schema drift, not a later reader).
"""

from __future__ import annotations

import dataclasses
from typing import Any

# Bump when the record shape changes; readers reject unknown versions the
# same way obs/emitter.py's event schema does.  v2: the pass-3 kinds —
# ``shardflow`` (sharding-flow lint + train-state coverage), ``reshard``
# (compiled collective inventory vs the expected model), ``memory`` (HBM
# peak vs the analytic byte model) — plus the ``graftcheck_memory``
# per-program record below.
FINDINGS_SCHEMA_VERSION = 2

RECORD_KIND = "graftcheck_finding"
MEMORY_RECORD_KIND = "graftcheck_memory"

# "ledger" (the scripted goodput-ledger audit) widens the value set only
# — the record SHAPE is unchanged, so the schema version stays at 2.
PASSES = ("lint", "hlo", "shardflow", "reshard", "memory", "ledger")
SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer violation.

    ``rule`` is the stable id the inline escape hatch names
    (``# graftcheck: disable=<rule>``); ``fixit`` is the remediation the
    rule prescribes, not a restatement of the problem.  ``path``/``line``
    locate lint findings; HLO-audit findings use the program name as
    ``path`` and line 0 (there is no source line for a compiled
    artifact).
    """

    rule: str
    message: str
    path: str
    line: int = 0
    col: int = 0
    fixit: str = ""
    analysis_pass: str = "lint"
    severity: str = "error"

    def __post_init__(self):
        if self.analysis_pass not in PASSES:
            raise ValueError(
                f"pass {self.analysis_pass!r} not in {PASSES}"
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {SEVERITIES}"
            )

    def format(self) -> str:
        """The human line: ``path:line:col: rule: message [fix: ...]``."""
        loc = f"{self.path}:{self.line}:{self.col}" if self.line else self.path
        out = f"{loc}: {self.rule}: {self.message}"
        if self.fixit:
            out += f"  [fix: {self.fixit}]"
        return out


def finding_record(finding: Finding) -> dict[str, Any]:
    """The JSONL payload for one finding (the obs ``record`` event body)."""
    return {
        "record": RECORD_KIND,
        "findings_schema": FINDINGS_SCHEMA_VERSION,
        "rule": finding.rule,
        "message": finding.message,
        "path": finding.path,
        "line": int(finding.line),
        "col": int(finding.col),
        "fixit": finding.fixit,
        "analysis_pass": finding.analysis_pass,
        "severity": finding.severity,
    }


def finding_from_record(record: dict[str, Any]) -> Finding:
    """Wire → Finding, validating on the way in (the roundtrip inverse)."""
    validate_finding_records([record])
    return Finding(
        rule=record["rule"],
        message=record["message"],
        path=record["path"],
        line=record["line"],
        col=record["col"],
        fixit=record.get("fixit", ""),
        analysis_pass=record["analysis_pass"],
        severity=record["severity"],
    )


def validate_finding_records(records: list[dict[str, Any]]) -> None:
    """Schema check for finding records; raises ValueError on the first
    violation (mirrors ``obs.emitter.validate_events``)."""
    for i, rec in enumerate(records):
        if rec.get("record") != RECORD_KIND:
            raise ValueError(
                f"record {i} is not a {RECORD_KIND}: {rec.get('record')!r}"
            )
        if rec.get("findings_schema") != FINDINGS_SCHEMA_VERSION:
            raise ValueError(
                f"record {i} schema {rec.get('findings_schema')!r} != "
                f"supported {FINDINGS_SCHEMA_VERSION}"
            )
        for field, kind in (
            ("rule", str), ("message", str), ("path", str),
            ("line", int), ("col", int), ("analysis_pass", str),
            ("severity", str),
        ):
            if not isinstance(rec.get(field), kind):
                raise ValueError(
                    f"record {i} field {field!r} is not {kind.__name__}: "
                    f"{rec.get(field)!r}"
                )
        if rec["analysis_pass"] not in PASSES:
            raise ValueError(
                f"record {i} pass {rec['analysis_pass']!r} not in {PASSES}"
            )
        if rec["severity"] not in SEVERITIES:
            raise ValueError(
                f"record {i} severity {rec['severity']!r} not in "
                f"{SEVERITIES}"
            )


def memory_record(
    program: str, measured: dict[str, int], model: dict[str, int],
    *, measured_total: int | None = None,
    total_rel_err: float | None = None,
) -> dict[str, Any]:
    """The per-program HBM-audit JSONL payload (obs ``record`` event body):
    the measured ``memory_analysis()`` components next to the analytic
    model's, so a telemetry reader can recompute the pin without the
    artifact.

    ``measured_total``/``total_rel_err`` are the AUDIT's computed peak
    and relative error — which apply the deserialized-alias fallback
    (a warm persistent-compilation-cache executable reports
    ``alias_size_in_bytes == 0``; see ``audit_program_memory``) that a
    reader recomputing from the raw ``measured`` dict would miss."""
    rec = {
        "record": MEMORY_RECORD_KIND,
        "findings_schema": FINDINGS_SCHEMA_VERSION,
        "program": program,
        "measured": {k: int(v) for k, v in measured.items()},
        "model": {k: int(v) for k, v in model.items()},
    }
    if measured_total is not None:
        rec["measured_total"] = int(measured_total)
    if total_rel_err is not None:
        rec["total_rel_err"] = float(total_rel_err)
    return rec


def validate_memory_records(records: list[dict[str, Any]]) -> None:
    """Schema check for ``graftcheck_memory`` records (the emitting-side
    gate, mirroring ``validate_finding_records``)."""
    for i, rec in enumerate(records):
        if rec.get("record") != MEMORY_RECORD_KIND:
            raise ValueError(
                f"record {i} is not a {MEMORY_RECORD_KIND}: "
                f"{rec.get('record')!r}"
            )
        if rec.get("findings_schema") != FINDINGS_SCHEMA_VERSION:
            raise ValueError(
                f"record {i} schema {rec.get('findings_schema')!r} != "
                f"supported {FINDINGS_SCHEMA_VERSION}"
            )
        if not isinstance(rec.get("program"), str):
            raise ValueError(f"record {i} program is not a str")
        for field in ("measured", "model"):
            val = rec.get(field)
            if not isinstance(val, dict) or not all(
                isinstance(k, str) and isinstance(v, int)
                for k, v in val.items()
            ):
                raise ValueError(
                    f"record {i} field {field!r} is not a str->int dict: "
                    f"{val!r}"
                )
        if "measured_total" in rec and not isinstance(
            rec["measured_total"], int
        ):
            raise ValueError(f"record {i} measured_total is not an int")
        if "total_rel_err" in rec and not isinstance(
            rec["total_rel_err"], (int, float)
        ):
            raise ValueError(f"record {i} total_rel_err is not a number")
