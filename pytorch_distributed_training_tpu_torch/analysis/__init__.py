"""Analysis of the port: the JAX package's ``analysis/`` where it applies
to torch code.

- :mod:`analysis.findings` — the schema-versioned finding record every
  analyzer pass emits through the obs spine (``graftcheck_finding``, and
  the ``graftcheck_memory`` record), with its validators;
- :mod:`analysis.ledger_audit` — the goodput ledger (``obs/ledger.py``)
  driven through a scripted supervised fault trace on a virtual clock:
  every category an exact integer in ns, the identity exact mid-run and
  final, run-twice determinism, and the two-rank fleet merge.

Not ported, and why:

- ``hlo_audit.py``, ``reshard_audit.py`` and ``shardflow.py`` audit the
  XLA programs JAX compiles (donation, collective census, HBM peaks);
  the port compiles no program, so they have no twin on the card.  The
  port's placements are held to JAX's ``infer_params_sharding`` by its
  tests instead.
- ``lint.py``'s rules are JAX's bug classes (tracer leaks, host commits
  to AOT programs); the port's own need their own design.
- ``signature.py`` guards recompiles; it waits for CUDA graphs.
"""

from . import findings, ledger_audit
from .findings import (
    FINDINGS_SCHEMA_VERSION,
    MEMORY_RECORD_KIND,
    Finding,
    finding_from_record,
    finding_record,
    memory_record,
    validate_finding_records,
    validate_memory_records,
)
from .ledger_audit import expected_final_categories_ns, run_ledger_audit

__all__ = [
    "FINDINGS_SCHEMA_VERSION",
    "MEMORY_RECORD_KIND",
    "Finding",
    "expected_final_categories_ns",
    "finding_from_record",
    "finding_record",
    "findings",
    "ledger_audit",
    "memory_record",
    "run_ledger_audit",
    "validate_finding_records",
    "validate_memory_records",
]
