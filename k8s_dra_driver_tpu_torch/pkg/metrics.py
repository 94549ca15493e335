"""Prometheus-style metrics with text exposition.

The subset of the JAX package's ``pkg/metrics.py`` that this package uses:
Counter, Gauge and Histogram with label vectors, a Registry and the same
text exposition format, line for line; and the families of the claim path
(DRA requests, informer, workqueue, allocator, fake-apiserver wire path),
of the ComputeDomain controller and daemon, and of the self-healing path
(remediation and node leases), named ``gpu_dra_*`` where
the JAX package's are ``tpu_dra_*``; and :class:`MetricsServer`, the
``/metrics`` and ``/debug/<name>`` endpoint every binary serves.

Histogram exemplars take an explicit trace id only; there is no tracer in
this package yet to supply one from an active span.
"""

from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Callable, Iterable, Optional, Sequence


def exponential_buckets(start: float, factor: float, count: int) -> list[float]:
    return [start * factor ** i for i in range(count)]


def escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or a value like ``say "hi"\\n``
    corrupts every scrape of the whole exposition."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: dict[str, str]) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(labels[n] for n in self.label_names)

    @staticmethod
    def _fmt_labels(names: Sequence[str], values: Sequence[str],
                    extra: str = "") -> str:
        pairs = [f'{n}="{escape_label_value(v)}"'
                 for n, v in zip(names, values)]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Metric):
    TYPE = "counter"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.TYPE}"
        with self._lock:
            for key, v in sorted(self._values.items()):
                yield f"{self.name}{self._fmt_labels(self.label_names, key)} {v}"


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[self._key(labels)] = value

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)


class Histogram(_Metric):
    TYPE = "histogram"

    def __init__(self, name: str, help_: str, buckets: Sequence[float],
                 label_names: Sequence[str] = (), exemplars: bool = False):
        super().__init__(name, help_, label_names)
        self.buckets = sorted(buckets)
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        # Last (trace_id, value, ts) per bucket and labelset, exposed as
        # "# EXEMPLAR" comment lines that plain scrapers skip.
        self.exemplars = exemplars
        self._exemplars: dict[tuple[str, ...],
                              dict[str, tuple[str, float, float]]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None,
                **labels: str) -> None:
        """``exemplar``: a trace id recorded on the bucket the value lands
        in, when the histogram keeps exemplars; None records none."""
        key = self._key(labels)
        tid = exemplar if self.exemplars and exemplar else ""
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            landed: Optional[str] = None
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    if landed is None:
                        landed = str(b)
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            if tid:
                self._exemplars.setdefault(key, {})[landed or "+Inf"] = (
                    tid, value, time.time())

    def count(self, **labels: str) -> int:
        with self._lock:
            return self._totals.get(self._key(labels), 0)

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.TYPE}"
        with self._lock:
            for key in sorted(self._totals):
                cumulative = self._counts[key]
                ex = self._exemplars.get(key, {})
                for b, c in zip(self.buckets, cumulative):
                    le = self._fmt_labels(self.label_names, key, f'le="{b}"')
                    yield f"{self.name}_bucket{le} {c}"
                    if str(b) in ex:
                        tid, v, ts = ex[str(b)]
                        yield (f"# EXEMPLAR {self.name}_bucket{le} "
                               f"trace_id={tid} value={v} ts={ts}")
                inf = self._fmt_labels(self.label_names, key, 'le="+Inf"')
                yield f"{self.name}_bucket{inf} {self._totals[key]}"
                if "+Inf" in ex:
                    tid, v, ts = ex["+Inf"]
                    yield (f"# EXEMPLAR {self.name}_bucket{inf} "
                           f"trace_id={tid} value={v} ts={ts}")
                lbl = self._fmt_labels(self.label_names, key)
                yield f"{self.name}_sum{lbl} {self._sums[key]}"
                yield f"{self.name}_count{lbl} {self._totals[key]}"


class Registry:
    def __init__(self) -> None:
        self._metrics: list[_Metric] = []
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if any(m.name == metric.name for m in self._metrics):
                raise ValueError(f"metric {metric.name} already registered")
            self._metrics.append(metric)
        return metric

    def expose_text(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


# -- DRA request metrics (the dra_requests.go:27-85 family) -----------------

REQUEST_DURATION_BUCKETS = exponential_buckets(0.05, 2, 9)  # 0.05 s → 12.8 s


class DRAMetrics:
    """The per-process DRA metric family. Instantiate once per plugin
    (``init_dra_metrics``) and thread through; a fresh instance per test
    keeps tests independent."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.requests_total = r.register(Counter(
            "gpu_dra_requests_total",
            "Total number of DRA prepare and unprepare requests.",
            ("driver", "operation")))
        self.request_duration_seconds = r.register(Histogram(
            "gpu_dra_request_duration_seconds",
            "Duration of DRA prepare and unprepare requests.",
            REQUEST_DURATION_BUCKETS, ("driver", "operation"),
            exemplars=True))
        self.requests_inflight = r.register(Gauge(
            "gpu_dra_requests_inflight",
            "Number of in-flight DRA prepare and unprepare requests.",
            ("driver", "operation")))
        self.prepared_devices = r.register(Gauge(
            "gpu_dra_prepared_devices",
            "Current number of prepared devices by device type.",
            ("node", "driver", "device_type")))
        self.node_prepare_errors_total = r.register(Counter(
            "gpu_dra_node_prepare_errors_total",
            "Total number of failures during DRA node prepare.",
            ("driver", "error_type")))
        self.node_unprepare_errors_total = r.register(Counter(
            "gpu_dra_node_unprepare_errors_total",
            "Total number of failures during DRA node unprepare.",
            ("driver", "error_type")))
        # Concurrent-prepare observability (docs/performance.md): how many
        # claims are inside DeviceState right now (requests_inflight counts
        # kubelet batch requests; this counts per-claim critical sections),
        # and how many checkpoint RMWs each group-commit batch coalesced.
        self.prepare_inflight = r.register(Gauge(
            "gpu_dra_prepare_inflight",
            "Claims with a prepare/unprepare currently executing in "
            "device state.",
            ("driver",)))
        self.checkpoint_batch_size = r.register(Histogram(
            "gpu_dra_checkpoint_batch_size",
            "Checkpoint transactions coalesced per group-commit batch.",
            (1, 2, 4, 8, 16, 32), ("driver",)))

    def timed_request(self, driver: str, operation: str,
                      trace_id: str = ""):
        """Context manager: counts the request, tracks inflight, observes
        duration — wrap each Prepare/Unprepare batch with it.
        ``trace_id`` (the batch's claim trace, extracted from its
        traceparent annotation) becomes the duration exemplar."""
        return _TimedRequest(self, driver, operation, trace_id)


class ControllerMetrics:
    """The CD controller's metric family (the controller-runtime
    reconcile-counter analogue the reference gets from client-go)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.reconciles_total = r.register(Counter(
            "gpu_dra_cd_reconciles_total",
            "Total ComputeDomain reconcile executions.",
            ("outcome",)))  # success | error | teardown
        self.reconcile_duration_seconds = r.register(Histogram(
            "gpu_dra_cd_reconcile_duration_seconds",
            "Duration of ComputeDomain reconcile executions.",
            REQUEST_DURATION_BUCKETS, ()))
        self.orphans_swept_total = r.register(Counter(
            "gpu_dra_cd_orphans_swept_total",
            "Orphaned objects removed by the cleanup sweep.",
            ("category",)))  # children | cliques | labels
        self.compute_domains = r.register(Gauge(
            "gpu_dra_compute_domains",
            "ComputeDomains currently known to the controller.", ()))


class DaemonMetrics:
    """The CD daemon's sync-loop health: consecutive failures as a gauge
    (0 = healthy; a climbing value is a degrading node the operator can
    alert on long before the CD flips NotReady)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        self.sync_consecutive_failures = self.registry.register(Gauge(
            "gpu_dra_cd_daemon_sync_consecutive_failures",
            "Consecutive ComputeDomainDaemon sync_once failures.",
            ("node",)))


class InformerMetrics:
    """Watch-stream health counters for the informer layer. One process-
    global instance by default (:func:`default_informer_metrics`): every
    informer in a process feeds the same reconnect counters, labelled by
    kind — that is the operator view of a flapping API server."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.watch_reconnects_total = r.register(Counter(
            "gpu_dra_informer_watch_reconnects_total",
            "Watch streams re-established after dying behind the informer.",
            ("kind",)))
        self.resync_failures_total = r.register(Counter(
            "gpu_dra_informer_resync_failures_total",
            "Failed attempts to re-establish a dead watch (server down).",
            ("kind",)))
        self.relists_total = r.register(Counter(
            "gpu_dra_informer_relists_total",
            "Full relists after a dead watch could not resume from the "
            "event backlog (expired resume point or server-side "
            "backpressure disconnect).",
            ("kind",)))
        self.cache_objects = r.register(Gauge(
            "gpu_dra_informer_cache_objects",
            "Objects currently held in an informer's local cache.",
            ("kind",)))


_default_informer_metrics: Optional[InformerMetrics] = None


def default_informer_metrics() -> InformerMetrics:
    global _default_informer_metrics
    if _default_informer_metrics is None:
        _default_informer_metrics = InformerMetrics()
    return _default_informer_metrics


class WorkQueueMetrics:
    """Workqueue health, client-go's ``workqueue_*`` family GPU-named: how
    deep each queue is, how long items wait before a worker picks them up,
    and how long the work itself takes. One process-global instance by
    default (:func:`default_workqueue_metrics`), labelled by queue name —
    served through the controller main's MetricsServer."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.depth = r.register(Gauge(
            "gpu_dra_workqueue_depth",
            "Items currently queued (due or backing off, incl. parked "
            "re-queues), excluding items being processed.",
            ("queue",)))
        self.queue_latency_seconds = r.register(Histogram(
            "gpu_dra_workqueue_queue_latency_seconds",
            "Time from enqueue until a worker starts the item.",
            exponential_buckets(0.001, 4, 8), ("queue",)))
        self.work_duration_seconds = r.register(Histogram(
            "gpu_dra_workqueue_work_duration_seconds",
            "Time a worker spends processing one item.",
            exponential_buckets(0.0005, 4, 8), ("queue",)))


_default_workqueue_metrics: Optional[WorkQueueMetrics] = None


def default_workqueue_metrics() -> WorkQueueMetrics:
    global _default_workqueue_metrics
    if _default_workqueue_metrics is None:
        _default_workqueue_metrics = WorkQueueMetrics()
    return _default_workqueue_metrics


class AllocatorMetrics:
    """Allocator index/cache effectiveness. One process-global instance by
    default (:func:`default_allocator_metrics`), served through the same
    MetricsServer as the plugin's DRA family: ``cache`` labels the index —
    ``slices`` (device/view/capacity index per ResourceSlice generation),
    ``usage`` (consumed counters + held devices per claim generation),
    ``candidates`` (class-filtered candidate lists), ``selector`` (compiled
    CEL expressions), ``topology`` (the per-pool free-box geometry).

    The placement families (docs/performance.md, "Topology-aware
    allocation"): ``allocations_total`` counts allocation attempts by
    outcome — ``fragmented`` means the claim bounced while aggregate free
    capacity existed (the defrag planner's SLO signal);
    ``fragmentation`` is 1 − largest-allocatable-subslice ÷ free-chips
    per node pool (0 = one contiguous free box, → 1 as free capacity
    splinters); ``utilization`` is drawn ÷ healthy chips per node pool
    (cordoned/tainted chips excluded — the occupancy number the
    canary/usage dashboards read directly instead of deriving);
    ``candidates_scanned_total`` counts per-placement scoring work so
    best-fit's scan cost is visible next to its hit-rate."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.cache_hits_total = r.register(Counter(
            "gpu_dra_allocator_cache_hits_total",
            "Allocator index/cache lookups served without recomputation.",
            ("cache",)))
        self.cache_misses_total = r.register(Counter(
            "gpu_dra_allocator_cache_misses_total",
            "Allocator index/cache lookups that had to recompute.",
            ("cache",)))
        self.cache_evictions_total = r.register(Counter(
            "gpu_dra_allocator_cache_evictions_total",
            "Entries evicted from the allocator's bounded memo caches "
            "(candidates LRU, compiled-selector LRU) at their size caps.",
            ("cache",)))
        self.allocations_total = r.register(Counter(
            "gpu_dra_allocator_allocations_total",
            "Allocation attempts by outcome: success, unsatisfiable (no "
            "capacity anywhere), fragmented (free capacity exists but no "
            "placement fits — the defrag planner's signal).",
            ("outcome",)))
        self.fragmentation = r.register(Gauge(
            "gpu_dra_allocator_fragmentation",
            "Free-capacity fragmentation per node pool: 1 - largest "
            "allocatable subslice / free chips (0 = contiguous).",
            ("node", "pool")))
        self.candidates_scanned_total = r.register(Counter(
            "gpu_dra_allocator_candidates_scanned_total",
            "Placement candidates examined during allocation, by "
            "strategy (best-fit scores every free placement; first-fit "
            "stops at the first).",
            ("strategy",)))
        self.utilization = r.register(Gauge(
            "gpu_dra_allocator_utilization",
            "Fraction of healthy (un-tainted, un-cordoned) chips per "
            "node pool currently drawn by allocations — refreshed on "
            "allocate/release alongside the fragmentation gauge.",
            ("node", "pool")))

    def hit(self, cache: str) -> None:
        self.cache_hits_total.inc(cache=cache)

    def miss(self, cache: str) -> None:
        self.cache_misses_total.inc(cache=cache)

    def evict(self, cache: str, n: int = 1) -> None:
        self.cache_evictions_total.inc(n, cache=cache)


_default_allocator_metrics: Optional[AllocatorMetrics] = None


def default_allocator_metrics() -> AllocatorMetrics:
    global _default_allocator_metrics
    if _default_allocator_metrics is None:
        _default_allocator_metrics = AllocatorMetrics()
    return _default_allocator_metrics


class RemediationMetrics:
    """Self-healing pipeline health (docs/self-healing.md): claims drained
    off tainted devices, devices inside the taint→drain→repair→rejoin
    pipeline right now, how long a device's recovery takes, how drained
    claims fared at reallocation, and the defrag planner's preemptions. One
    process-global instance by default (:func:`default_remediation_metrics`):
    the node-side DrainController and the cluster-side ClaimReallocator feed
    the same families."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.drains_total = r.register(Counter(
            "gpu_dra_remediation_drains_total",
            "Claims gracefully drained off tainted devices.",
            ("driver",)))
        self.active_drains = r.register(Gauge(
            "gpu_dra_remediation_active_drains",
            "Devices currently inside the taint->drain->repair->rejoin "
            "pipeline.",
            ("node",)))
        self.recovery_seconds = r.register(Histogram(
            "gpu_dra_remediation_recovery_seconds",
            "Taint observed -> device rejoined the published ResourceSlice, "
            "per device.",
            exponential_buckets(0.1, 2, 10), ("node",)))
        self.reallocations_total = r.register(Counter(
            "gpu_dra_remediation_reallocations_total",
            "Drained claims re-bound by the reallocation controller, by "
            "outcome.",
            ("outcome",)))  # success | failed
        self.preemptions_total = r.register(Counter(
            "gpu_dra_remediation_preemptions_total",
            "Defrag-planner preemptions of movable claims, by outcome "
            "(annotated | skipped_bounded | skipped_unmovable).",
            ("outcome",)))


_default_remediation_metrics: Optional[RemediationMetrics] = None


def default_remediation_metrics() -> RemediationMetrics:
    global _default_remediation_metrics
    if _default_remediation_metrics is None:
        _default_remediation_metrics = RemediationMetrics()
    return _default_remediation_metrics


class NodeMetrics:
    """Node failure domains (docs/self-healing.md, "Whole-node repair"):
    lease renewals on the node side, cordon counts and fence-to-uncordon
    durations on the cluster side. One process-global instance by default
    (:func:`default_node_metrics`)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.lease_renewals_total = r.register(Counter(
            "gpu_dra_node_lease_renewals_total",
            "Node-lease heartbeat renewals that landed.",
            ("node",)))
        self.cordons_total = r.register(Counter(
            "gpu_dra_node_cordons_total",
            "Whole-node cordons, by reason (node-lost | requested).",
            ("reason",)))
        self.fence_seconds = r.register(Histogram(
            "gpu_dra_node_fence_seconds",
            "Node fenced (cordon started) -> fence cleared and node "
            "uncordoned, per node-loss episode.",
            exponential_buckets(0.5, 2, 10), ("node",)))


_default_node_metrics: Optional[NodeMetrics] = None


def default_node_metrics() -> NodeMetrics:
    global _default_node_metrics
    if _default_node_metrics is None:
        _default_node_metrics = NodeMetrics()
    return _default_node_metrics


class _TimedRequest:
    def __init__(self, m: DRAMetrics, driver: str, operation: str,
                 trace_id: str = ""):
        self.m = m
        self.driver = driver
        self.operation = operation
        self.trace_id = trace_id

    def __enter__(self) -> "_TimedRequest":
        self.t0 = time.monotonic()
        self.m.requests_total.inc(driver=self.driver, operation=self.operation)
        self.m.requests_inflight.inc(driver=self.driver, operation=self.operation)
        return self

    def __exit__(self, *exc) -> None:
        self.m.requests_inflight.dec(driver=self.driver, operation=self.operation)
        self.m.request_duration_seconds.observe(
            time.monotonic() - self.t0,
            exemplar=self.trace_id or None,
            driver=self.driver, operation=self.operation)


# -- /metrics HTTP server ---------------------------------------------------

class MetricsServer:
    """Threaded ``/metrics`` endpoint (prometheus_httpserver.go:52).

    Accepts additional registries so one endpoint can expose a process's
    whole metric surface — e.g. a plugin's DRAMetrics plus the shared
    informer reconnect counters — without merging them at registration.

    ``debug``: name → zero-arg callable; each is served as JSON under
    ``/debug/<name>`` (docs/observability.md, "Debug endpoints") with
    ``/debug`` itself listing what is available. Callables run on the
    scrape thread and must be cheap, read-only snapshots; a callable that
    raises yields a 500 with the error text rather than killing the
    server thread."""

    def __init__(self, registry: Registry, *extra_registries: Registry,
                 host: str = "127.0.0.1", port: int = 0,
                 debug: Optional[dict[str, Callable[[], object]]] = None):
        regs = (registry, *extra_registries)
        debug_handlers = dict(debug or {})

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes,
                      content_type: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0].rstrip("/")
                if path in ("", "/metrics"):
                    body = "".join(r.expose_text() for r in regs).encode()
                    self._send(200, body, "text/plain; version=0.0.4")
                    return
                if path == "/debug":
                    body = json.dumps(
                        {"endpoints": sorted(f"/debug/{k}"
                                             for k in debug_handlers)}
                    ).encode()
                    self._send(200, body, "application/json")
                    return
                if path.startswith("/debug/"):
                    name = path[len("/debug/"):]
                    fn = debug_handlers.get(name)
                    if fn is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    try:
                        body = json.dumps(fn(), default=str).encode()
                    except Exception as e:  # noqa: BLE001 — a broken
                        # snapshot must not kill the serving thread.
                        self._send(500, f"debug handler {name} failed: "
                                        f"{e}".encode(), "text/plain")
                        return
                    self._send(200, body, "application/json")
                    return
                self.send_response(404)
                self.end_headers()

            def log_message(self, *args) -> None:
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics", daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
