"""The scrapeable ops endpoint over the live plane — stdlib only.

A background :class:`~http.server.ThreadingHTTPServer` on a daemon
thread (``--metrics-port``; port 0 binds an ephemeral port, which is
what the tests and the dryrun leg use) serving three read-only views of
one process's :class:`~.live.LiveAggregator` / :class:`~.slo.SLOPolicy`:

- ``/metrics`` — Prometheus text exposition (version 0.0.4): counters,
  gauges, and the fixed-log-bucket histograms as cumulative
  ``_bucket{le=...}`` lines — the bucket boundaries are deterministic
  (obs/live.py), so a Prometheus server scraping two replicas can merge
  their histograms exactly, the same merge the tests pin.  Label-bearing
  metric names (``ttft_s[tenant=acme]``, ``..._r2``) render as proper
  Prometheus labels via the shared ``parse_metric_name`` decoder.
- ``/healthz`` — per-component liveness from heartbeat staleness
  (ranks from event flow, serve/router/roles/replicas from their
  per-tick gauges); HTTP 200 when everything is fresh, 503 otherwise —
  a k8s-style liveness probe.
- ``/slo`` — JSON objective status: cumulative SLIs, both window burn
  rates, active alerts, the reduced alert history, the span-derived
  live TTFT decomposition (obs/spans.py) when tracing is on, and —
  under a closed-loop tier (serve/autoscale.py) — a ``controller``
  block: fleet size, role split, pressure-ladder rung, and the last N
  autoscale actions with their cause attributions — and, on a training
  run under ``--goodput``, a ``goodput`` block: the live goodput
  ledger's identity-exact wall-clock attribution (obs/ledger.py).  An
  elastic run (``--elastic-resize``) adds an ``elastic`` block next to
  it: world size, active slices, transition counters + log
  (resilience/elastic.py).

The handler thread only READS (the aggregator's lock guards the
snapshot); all mutation stays on the host control loop.  Nothing here
ever touches a device — the endpoint is host-thread-only by
construction.  The listener binds ``127.0.0.1`` only.

The port's own copy of the JAX package's ``obs/http.py``.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from .live import LiveAggregator, ZERO_BUCKET, bucket_upper, parse_metric_name

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(base: str) -> str:
    name = _NAME_RE.sub("_", base)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _escape(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def _prom_labels(labels: dict[str, str], extra: dict[str, str] | None = None
                 ) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(
        f'{_prom_name(k)}="{_escape(v)}"'
        for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def render_prometheus(snapshot: dict[str, Any]) -> str:
    """The ``/metrics`` body from one aggregator snapshot.  Pure (no
    aggregator access), so tests can render without a server and the
    scraped text is a deterministic function of the live state."""
    lines: list[str] = []
    families: dict[str, list[tuple[dict[str, str], float]]] = {}
    for name, value in sorted(snapshot.get("counters", {}).items()):
        base, labels = parse_metric_name(name)
        families.setdefault(base, []).append((labels, value))
    for base, series in families.items():
        pn = _prom_name(base)
        lines.append(f"# TYPE {pn} counter")
        for labels, value in series:
            lines.append(f"{pn}{_prom_labels(labels)} {value:.17g}")
    families = {}
    for name, value in sorted(snapshot.get("gauges", {}).items()):
        base, labels = parse_metric_name(name)
        families.setdefault(base, []).append((labels, value))
    for base, series in families.items():
        pn = _prom_name(base)
        lines.append(f"# TYPE {pn} gauge")
        for labels, value in series:
            lines.append(f"{pn}{_prom_labels(labels)} {value:.17g}")
    hist_families: dict[str, list[tuple[dict[str, str], dict]] ] = {}
    for name, red in sorted(snapshot.get("histograms", {}).items()):
        base, labels = parse_metric_name(name)
        hist_families.setdefault(base, []).append((labels, red))
    for base, series in hist_families.items():
        pn = _prom_name(base)
        lines.append(f"# TYPE {pn} histogram")
        for labels, red in series:
            buckets = red.get("buckets", {})
            cum = buckets.get(ZERO_BUCKET, 0)
            for i in sorted(int(k) for k in buckets if k != ZERO_BUCKET):
                cum += buckets[str(i)]
                le = _prom_labels(labels, {"le": f"{bucket_upper(i):.9g}"})
                lines.append(f"{pn}_bucket{le} {cum}")
            inf = _prom_labels(labels, {"le": "+Inf"})
            lines.append(f"{pn}_bucket{inf} {red['count']}")
            lines.append(
                f"{pn}_sum{_prom_labels(labels)} {red['sum']:.17g}"
            )
            lines.append(f"{pn}_count{_prom_labels(labels)} {red['count']}")
    return "\n".join(lines) + "\n"


class OpsServer:
    """``/metrics`` + ``/healthz`` + ``/slo`` over one aggregator (and
    optionally one policy).  ``port=0`` binds ephemeral; :attr:`port`
    holds the bound port after :meth:`start`.  Loopback-only by default —
    this is an operator surface, not a public one."""

    def __init__(
        self,
        aggregator: LiveAggregator,
        policy=None,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        stale_after_s: float = 10.0,
        controller=None,
        ledger=None,
        elastic=None,
    ):
        self.aggregator = aggregator
        self.policy = policy
        # Elastic membership plane (resilience/elastic.py::ElasticWorld):
        # when present, /slo grows an "elastic" block next to the goodput
        # block — world size, active slices, transition counters + log.
        # snapshot() copies plain ints/dicts on the control thread.
        self.elastic = elastic
        # Training goodput ledger (obs/ledger.py): when present, /slo
        # grows a "goodput" block — the live identity-exact wall-clock
        # attribution.  snapshot() is a pure read on the host control
        # thread's ledger (ints + one clock read, no lock needed: the
        # worst a torn read costs is one interval's attribution, and the
        # final record is emitted from the control thread itself).
        self.ledger = ledger
        # Autoscale controller (serve/autoscale.py): when present, /slo
        # grows a "controller" block — fleet size, role split, ladder
        # rung, last N actions with causes.  Lock ordering: the handler
        # takes the policy lock (snapshot) and RELEASES it before the
        # controller lock — sequential, never nested, so the control
        # loop can hold either without deadlocking a scrape.
        self.controller = controller
        self.host = host
        self.port = int(port)
        self.stale_after_s = float(stale_after_s)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ---- request handling ---------------------------------------------

    def _respond(self, path: str) -> tuple[int, str, str]:
        """(status, content-type, body) for one GET — split from the
        handler so tests can exercise routing without sockets."""
        if path.split("?", 1)[0] == "/metrics":
            body = render_prometheus(self.aggregator.snapshot())
            return 200, "text/plain; version=0.0.4", body
        if path.split("?", 1)[0] == "/healthz":
            health = self.aggregator.healthz(
                stale_after_s=self.stale_after_s
            )
            return (
                200 if health["ok"] else 503,
                "application/json",
                json.dumps(health) + "\n",
            )
        if path.split("?", 1)[0] == "/slo":
            payload: dict[str, Any] = (
                self.policy.snapshot() if self.policy is not None
                else {"objectives": [], "active_alerts": [],
                      "alerts": {"transitions": 0, "objectives": {},
                                 "anomaly_alerts": {"count": 0,
                                                    "by_alert": {}}}}
            )
            decomp = self.aggregator.ttft_decomposition()
            if decomp is not None:
                payload["ttft_decomposition"] = decomp
            if self.controller is not None:
                payload["controller"] = self.controller.snapshot()
            if self.ledger is not None:
                payload["goodput"] = self.ledger.snapshot()
            if self.elastic is not None:
                payload["elastic"] = self.elastic.snapshot()
            return 200, "application/json", json.dumps(payload) + "\n"
        return 404, "text/plain", "not found\n"

    def start(self) -> "OpsServer":
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                status, ctype, body = server._respond(self.path)
                data = body.encode()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # silence per-request stderr
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "OpsServer":
        return self if self._httpd is not None else self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
