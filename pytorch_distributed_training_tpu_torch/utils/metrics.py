"""Human-facing metrics logging (stdout + JSONL): the counterpart of the
JAX package's ``utils/metrics.py``.  Only rank 0 of a ``torch.distributed``
job emits, so multi-process runs don't interleave output."""

from __future__ import annotations

import json
import os
from typing import Any


class _JsonlEmitter:
    """Shared emit rule + JSONL path setup."""

    def __init__(self, jsonl_path: str | None, only_rank0: bool):
        self.jsonl_path = jsonl_path
        self.only_rank0 = only_rank0
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)

    def _is_emitter(self) -> bool:
        if not self.only_rank0:
            return True
        import torch.distributed as dist

        return not dist.is_initialized() or dist.get_rank() == 0

    def _append(self, record: dict[str, Any]) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")


class MetricsLogger(_JsonlEmitter):
    def __init__(self, jsonl_path: str | None = None, only_rank0: bool = True):
        super().__init__(jsonl_path, only_rank0)

    def log(self, record: dict[str, Any]) -> None:
        if not self._is_emitter():
            return
        parts = []
        for k, v in record.items():
            parts.append(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}")
        print(" | ".join(parts))
        if self.jsonl_path:
            self._append(record)


class RequestLogger(_JsonlEmitter):
    """Per-request serving records, one JSONL line per finished request
    (never printed): the raw material TTFT/TPOT percentiles reduce."""

    _FIELDS = (
        "id", "prompt_len", "max_new_tokens", "arrival", "deadline",
        "tenant", "replica", "admitted", "first_token", "finish",
        "finish_reason", "generated", "ttft", "tpot",
        # Failover provenance (serve/failover.py): the re-placements and
        # the replicas that held the request, in order.
        "retries", "replica_history",
    )

    def __init__(self, jsonl_path: str, only_rank0: bool = True):
        super().__init__(jsonl_path, only_rank0)

    def log(self, record: dict[str, Any]) -> None:
        if not self._is_emitter():
            return
        self._append({k: record[k] for k in self._FIELDS if k in record})

    def read(self) -> list[dict[str, Any]]:
        """Load the records back (the recompute path)."""
        with open(self.jsonl_path) as f:
            return [json.loads(line) for line in f if line.strip()]
