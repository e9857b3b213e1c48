"""Analysis of the port: the JAX package's ``analysis/`` where it applies
to torch code.

- :mod:`analysis.lint` — the AST lint of the port's own sources
  (``python -m pytorch_distributed_training_tpu_torch.analysis.lint``):
  JAX's rules that carry over (``debug-stray``, ``axis-literal``,
  ``shard-axis-unknown``, ``metric-name``), twins of its tracing rules
  (``host-read``, ``global-rng``) and the port's own bug classes
  (``raw-collective``, ``argv-bool``, ``init-shadows-submodule``);
- :mod:`analysis.findings` — the schema-versioned finding record every
  analyzer pass emits through the obs spine (``graftcheck_finding``, and
  the ``graftcheck_memory`` record), with its validators;
- :mod:`analysis.ledger_audit` — the goodput ledger (``obs/ledger.py``)
  driven through a scripted supervised fault trace on a virtual clock:
  every category an exact integer in ns, the identity exact mid-run and
  final, run-twice determinism, and the two-rank fleet merge;
- :mod:`analysis.signature` — the recompile guard: the serving engine's
  programs (CUDA graphs on the card, captured once at construction)
  record their abstract signatures in ``PROGRAM_REGISTRY``.

Not ported, and why:

- ``hlo_audit.py``, ``reshard_audit.py`` and the semantic half of
  ``shardflow.py`` audit the XLA programs JAX compiles (donation,
  collective census, HBM peaks); the port compiles no XLA program, so
  they have no twin on the card.  The port's placements are held to
  JAX's ``infer_params_sharding`` by its tests instead.
  ``shardflow.py``'s ``shard-axis-unknown`` rule is the lint's.
"""

from . import findings, ledger_audit, signature
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
from .signature import PROGRAM_REGISTRY, SignatureRegistry, abstract_signature

_LINT_NAMES = ("Rule", "RULES", "iter_python_files", "lint_paths",
               "lint_source")


def __getattr__(name: str):
    """The lint's names, imported on first use: ``python -m`` of the lint
    module must not find it imported already by its package."""
    if name in _LINT_NAMES or name == "lint":
        import importlib

        lint = importlib.import_module(f"{__name__}.lint")
        return lint if name == "lint" else getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "FINDINGS_SCHEMA_VERSION",
    "MEMORY_RECORD_KIND",
    "PROGRAM_REGISTRY",
    "Finding",
    "RULES",
    "Rule",
    "SignatureRegistry",
    "abstract_signature",
    "expected_final_categories_ns",
    "finding_from_record",
    "finding_record",
    "findings",
    "iter_python_files",
    "ledger_audit",
    "lint",
    "lint_paths",
    "lint_source",
    "memory_record",
    "run_ledger_audit",
    "signature",
    "validate_finding_records",
    "validate_memory_records",
]
