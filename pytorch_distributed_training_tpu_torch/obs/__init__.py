"""Unified telemetry: the one spine the port's training and serving
report through, the twin of the JAX package's ``obs/`` (its own copy:
nothing here imports that package).  The event log is JAX's byte for
byte — schema v4, its kinds, phases, span names, ledger categories and
metric registry, its field names — so the repo's
``tools/telemetry_report.py`` and ``tools/trace_export.py`` read the
port's logs.

- ``emitter``  — :class:`MetricsEmitter`: counters, gauges, histograms
  and the schema-versioned per-process JSONL event log (rank-tagged, one
  writer per process), and the shared :func:`percentiles`;
- ``trace``    — the phase names (:data:`PHASES`) as
  ``torch.profiler.record_function`` ranges around the trainer's step,
  the grad-sync tiers, the microbatches, the pipeline ticks and the
  serve engine's steps;
- ``cost``     — the step's FLOPs counted on ``meta`` tensors, MFU, the
  collective census of the first step, the allocator's peaks, and the
  analytic DCN, ICI, stage-boundary and KV byte models;
- ``flight``   — the flight recorder: anomaly detection on the write
  side, step-aligned rank merge and straggler flagging on the read side;
- ``spans``    — request and step spans on the same log;
- ``ledger``   — the goodput ledger: every nanosecond of a training
  run's wall clock in exactly one category;
- ``live``, ``slo``, ``http`` — the live plane: the online aggregator,
  the multi-window burn-rate SLO policy and the ``/metrics``,
  ``/healthz``, ``/slo`` endpoint.
"""

from .cost import (
    collective_census,
    compiled_cost,
    count_step_flops,
    dcn_step_counters,
    grad_sync_wall_model,
    kv_block_model_bytes,
    kv_pool_model_bytes,
    kv_position_bytes,
    memory_stats,
    memory_totals,
    mfu,
    peak_flops_for,
    pp_step_counters,
    serve_activation_estimate,
    spec_shard_factor,
    step_cost_report,
    train_activation_estimate,
    tree_bytes_per_device,
)
from .emitter import (
    ALERT_STATES,
    EVENT_KINDS,
    SCHEMA_VERSION,
    SUPPORTED_SCHEMA_VERSIONS,
    MetricsEmitter,
    percentiles,
    read_events,
    validate_events,
)
from .http import OpsServer, render_prometheus
from .live import (
    FixedLogHistogram,
    LiveAggregator,
    bucket_counts_of,
    bucket_index,
    bucket_upper,
    labeled,
    parse_metric_name,
    quantile_from_buckets,
)
from .slo import (
    PROMOTED_ANOMALIES,
    Objective,
    SLOPolicy,
    parse_slo_spec,
    reduce_alerts,
)
from .spans import (
    SPAN_NAMES,
    Span,
    SpanRecorder,
    span_events,
    ttft_decomposition,
)
from .flight import (
    FlightRecorder,
    load_rank_logs,
    merge_timeline,
    straggler_report,
)
from .ledger import (
    BACKOFF_ENV,
    CATEGORIES as LEDGER_CATEGORIES,
    GoodputLedger,
    fleet_ledger,
)
from .schema import METRICS as METRIC_SCHEMA, check_metric_name
from .trace import PHASES, annotate, phase_span, scope, step_annotation

__all__ = [
    "ALERT_STATES",
    "BACKOFF_ENV",
    "EVENT_KINDS",
    "GoodputLedger",
    "LEDGER_CATEGORIES",
    "METRIC_SCHEMA",
    "check_metric_name",
    "fleet_ledger",
    "FixedLogHistogram",
    "FlightRecorder",
    "LiveAggregator",
    "MetricsEmitter",
    "Objective",
    "OpsServer",
    "PHASES",
    "PROMOTED_ANOMALIES",
    "SLOPolicy",
    "SCHEMA_VERSION",
    "SPAN_NAMES",
    "SUPPORTED_SCHEMA_VERSIONS",
    "Span",
    "SpanRecorder",
    "annotate",
    "bucket_counts_of",
    "bucket_index",
    "bucket_upper",
    "collective_census",
    "compiled_cost",
    "count_step_flops",
    "dcn_step_counters",
    "grad_sync_wall_model",
    "kv_block_model_bytes",
    "kv_pool_model_bytes",
    "kv_position_bytes",
    "labeled",
    "load_rank_logs",
    "memory_stats",
    "memory_totals",
    "merge_timeline",
    "mfu",
    "parse_metric_name",
    "parse_slo_spec",
    "peak_flops_for",
    "percentiles",
    "phase_span",
    "pp_step_counters",
    "quantile_from_buckets",
    "read_events",
    "reduce_alerts",
    "render_prometheus",
    "scope",
    "span_events",
    "ttft_decomposition",
    "serve_activation_estimate",
    "spec_shard_factor",
    "step_annotation",
    "step_cost_report",
    "train_activation_estimate",
    "tree_bytes_per_device",
    "straggler_report",
    "validate_events",
]
