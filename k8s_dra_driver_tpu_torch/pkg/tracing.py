"""Claim-lifecycle tracing: the span library and its trace store.

The counterpart of the JAX package's ``pkg/tracing.py``. "claim→ready
p50" is one number with no breakdown of queue wait vs allocate vs
checkpoint vs CDI vs watch delivery; this module supplies the breakdown as
a lightweight span library in the OpenTelemetry shape (trace_id/span_id/
parent, span attributes and events, ok/error status) with W3C
``traceparent`` context propagated **through object annotations**: the
creator of a ResourceClaim stamps
``metadata.annotations["tpu.google.com/traceparent"]`` and every layer that
later touches the claim (allocator, NodePrepareLoop, the kubelet plugins'
device state, checkpoint transactions, CDI writes, the CD controller for
annotated ComputeDomains) opens a child span against that context — one
trace stitches claim-create → allocate → prepare (checkpoint transact, CDI
write) → Ready across threads, components and processes. The annotation
key and its format are the JAX package's, byte for byte, so a claim
stamped by either package's :func:`inject` is read by the other's
:func:`extract`.

Near-zero-overhead contract (as ``pkg.faultpoints``): with tracing
disabled — the default — every tracer entry point reads one flag and
returns a shared no-op span; call sites still evaluate their (small,
literal) attribute dicts before the call.

Finished spans land in a **bounded ring buffer** (:class:`TraceStore`);
eviction drops the oldest spans and counts them (``dropped``) rather than
growing without limit. :func:`audit_traces` checks completeness (exactly
one ended root per trace with an ok/error status, no orphan parents, no
un-ended spans). :func:`phase_breakdown` turns a trace set into per-phase
p50/p99 latencies.

Fault injection is self-explaining: ``pkg.faultpoints`` annotates the
ACTIVE span with a ``fault.injected`` event whenever a schedule fires, so
a chaos trace carries its own injections inline.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from typing import Any, Iterator, Optional

from k8s_dra_driver_tpu_torch.pkg import sanitizer

#: annotation key carrying the W3C-style trace context on API objects —
#: the JAX package's key, so that traces cross between the two packages.
TRACEPARENT_ANNOTATION = "tpu.google.com/traceparent"

#: finished spans retained by a tracer's ring buffer by default.
DEFAULT_CAPACITY = 8192

_TRACEPARENT_VERSION = "00"


class SpanContext:
    """The propagatable identity of a span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def traceparent(self) -> str:
        return f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}-01"


def format_traceparent(ctx: SpanContext) -> str:
    return ctx.traceparent()


def parse_traceparent(value: str) -> Optional[SpanContext]:
    """``00-<32 hex>-<16 hex>-<flags>`` → SpanContext, else None (a
    malformed header is ignored, never fatal — same as real tracers)."""
    parts = (value or "").strip().split("-")
    if len(parts) != 4:
        return None
    _version, trace_id, span_id, _flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    return SpanContext(trace_id, span_id)


# Span ids only need uniqueness, not cryptographic strength —
# random.getrandbits avoids uuid4's per-call os.urandom syscall (~6 spans
# per claim).
_id_rng = random.Random()


def _new_trace_id() -> str:
    return f"{_id_rng.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_id_rng.getrandbits(64):016x}"


class Span:
    """One timed operation. Also a context manager: ``with`` exits set an
    error status on exception (without swallowing it) and end the span.

    Spans are thread-affine by convention: started and ended on one
    thread, becoming that thread's *active* span for the duration so
    nested instrumentation points (checkpoint transact inside a prepare)
    parent automatically.
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start", "end_ts",
                 "attributes", "events", "status", "status_message",
                 "_tracer", "_ended")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 parent_id: str, attributes: Optional[dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.start = time.time()
        self.end_ts = 0.0
        # The tracer takes ownership of a provided attributes dict (call
        # sites pass fresh literals); most spans have no events, so the
        # list is lazy — both save an allocation on the per-claim path.
        self.attributes: dict[str, Any] = \
            attributes if attributes is not None else {}
        self.events: Optional[list[dict[str, Any]]] = None
        self.status = "unset"
        self.status_message = ""
        self._ended = False

    # -- recording -----------------------------------------------------------

    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str,
                  attributes: Optional[dict[str, Any]] = None) -> "Span":
        if self.events is None:
            self.events = []
        self.events.append({"time": time.time(), "name": name,
                            "attributes": dict(attributes or {})})
        return self

    def set_status(self, status: str, message: str = "") -> "Span":
        if status not in ("ok", "error", "unset"):
            raise ValueError(f"span status must be ok|error|unset, "
                             f"got {status!r}")
        self.status = status
        self.status_message = message
        return self

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def traceparent(self) -> str:
        return self.context().traceparent()

    @property
    def recording(self) -> bool:
        return True

    def duration_s(self) -> float:
        return max(0.0, (self.end_ts or time.time()) - self.start)

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_ts = time.time()
        self._tracer._on_end(self)

    # -- context manager -----------------------------------------------------

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, _tb) -> None:
        if exc is not None and self.status == "unset":
            self.set_status("error", f"{type(exc).__name__}: {exc}")
        elif self.status == "unset":
            self.set_status("ok")
        self.end()

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end_ts,
            "duration_ms": round((self.end_ts - self.start) * 1e3, 4)
            if self.end_ts else None,
            "attributes": dict(self.attributes),
            "events": list(self.events or ()),
            "status": self.status,
            "status_message": self.status_message,
        }


class _NoopSpan:
    """The shared disabled-mode span: every method is a cheap no-op. One
    instance serves every call site (no allocation on the hot path)."""

    __slots__ = ()

    trace_id = ""
    span_id = ""
    parent_id = ""
    name = ""
    status = "unset"
    status_message = ""

    def set_attribute(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def add_event(self, name: str, attributes=None) -> "_NoopSpan":
        return self

    def set_status(self, status: str, message: str = "") -> "_NoopSpan":
        return self

    def context(self) -> None:
        return None

    def traceparent(self) -> str:
        return ""

    @property
    def recording(self) -> bool:
        return False

    def duration_s(self) -> float:
        return 0.0

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class TraceStore:
    """Bounded ring buffer of FINISHED spans. Append is one lock + one
    deque push; eviction is counted, not silent (``dropped`` tells an
    audit that trace completeness can no longer be proven)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._mu = sanitizer.new_lock("TraceStore._mu")
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._appended = 0

    def add(self, span: Span) -> None:
        with self._mu:
            self._spans.append(span)
            self._appended += 1

    def __len__(self) -> int:
        with self._mu:
            return len(self._spans)

    @property
    def appended(self) -> int:
        """Spans EVER added (ended), including since-evicted ones."""
        with self._mu:
            return self._appended

    @property
    def dropped(self) -> int:
        with self._mu:
            return self._appended - len(self._spans)

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()
            self._appended = 0

    def spans(self) -> list[dict[str, Any]]:
        with self._mu:
            snapshot = list(self._spans)
        return [s.to_dict() for s in snapshot]

    def traces(self) -> dict[str, list[dict[str, Any]]]:
        """Finished spans grouped by trace_id, each trace's spans sorted
        by start time (roots naturally first)."""
        out: dict[str, list[dict[str, Any]]] = {}
        for s in self.spans():
            out.setdefault(s["trace_id"], []).append(s)
        for spans in out.values():
            spans.sort(key=lambda s: (s["start"], s["span_id"]))
        return out

    def export_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({
            "capacity": self.capacity,
            "dropped": self.dropped,
            "spans": self.spans(),
        }, indent=indent, sort_keys=False)


class Tracer:
    """Span factory + per-thread active-span stack + trace store.

    Disabled by default: :meth:`start_span` (and every module-level
    convenience) returns :data:`NOOP_SPAN` until :meth:`enable` — the
    production hot path pays one attribute read."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.store = TraceStore(capacity)
        self._enabled = False
        self._tls = threading.local()
        # Spans STARTED since the last enable(): started - store.appended
        # is the number of started-but-never-ended spans, the only way a
        # leaked non-root span (which never reaches the store) is
        # detectable (audit_traces can only see ended spans).
        self._started = 0
        self._started_mu = sanitizer.new_lock("Tracer._started_mu")

    # -- lifecycle -----------------------------------------------------------

    def enable(self, capacity: Optional[int] = None,
               reset: bool = True) -> "Tracer":
        if capacity is not None and capacity != self.store.capacity:
            self.store = TraceStore(capacity)
        elif reset:
            self.store.clear()
        if reset or capacity is not None:
            with self._started_mu:
                self._started = 0
        self._enabled = True
        return self

    def started_spans(self) -> int:
        with self._started_mu:
            return self._started

    def disable(self) -> None:
        self._enabled = False

    def enabled(self) -> bool:
        return self._enabled

    # -- active-span stack ---------------------------------------------------

    def _stack(self) -> list[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def current(self) -> Optional[Span]:
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    # -- span creation -------------------------------------------------------

    def start_span(self, name: str,
                   parent: Optional[object] = None,
                   attributes: Optional[dict[str, Any]] = None,
                   activate: bool = True,
                   new_root: bool = False):
        """Open a span. ``parent`` may be a :class:`Span`, a
        :class:`SpanContext`, or None — None parents onto this thread's
        active span, or starts a NEW root trace if there is none.
        ``new_root=True`` forces a fresh trace regardless of the active
        span (harnesses minting many roots from one thread).
        ``activate=True`` pushes the span onto the thread's active stack
        (popped by ``end``)."""
        if not self._enabled:
            return NOOP_SPAN
        if new_root:
            parent = None
        elif parent is None:
            parent = self.current()
        if isinstance(parent, _NoopSpan):
            parent = None
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, SpanContext):
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = _new_trace_id(), ""
        span = Span(self, name, trace_id, parent_id, attributes)
        with self._started_mu:
            self._started += 1
        if activate:
            self._stack().append(span)
        return span

    def child_span(self, name: str,
                   attributes: Optional[dict[str, Any]] = None):
        """A span ONLY when this thread already has an active span —
        instrumentation for shared subsystems (checkpoint, CDI) that must
        never mint stray root traces when invoked outside a traced
        operation (e.g. unprepare, GC sweeps)."""
        if not self._enabled:
            return NOOP_SPAN
        cur = self.current()
        if cur is None:
            return NOOP_SPAN
        return self.start_span(name, parent=cur, attributes=attributes)

    def span_for_object(self, name: str, obj: Optional[dict],
                        attributes: Optional[dict[str, Any]] = None):
        """A span parented onto this thread's active span, else onto the
        context propagated in ``obj``'s annotations, else a no-op — the
        cross-thread stitch points (device state, claim watcher,
        controller) use this so untraced objects stay unrecorded instead
        of spawning orphan roots."""
        if not self._enabled:
            return NOOP_SPAN
        parent: Optional[object] = self.current()
        if parent is None and obj is not None:
            parent = self.extract(obj)
        if parent is None:
            return NOOP_SPAN
        return self.start_span(name, parent=parent, attributes=attributes)

    def _on_end(self, span: Span) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack:
            if stack[-1] is span:
                stack.pop()
            else:
                # Out-of-order end (ended from a different frame); drop it
                # from wherever it sits so the stack cannot leak.
                try:
                    stack.remove(span)
                except ValueError:
                    pass
        self.store.add(span)

    # -- propagation ---------------------------------------------------------

    def inject(self, span: object, obj: dict) -> dict:
        """Stamp ``span``'s context into ``obj.metadata.annotations``
        (mutates and returns ``obj``). No-op for no-op spans."""
        ctx = span.context() if hasattr(span, "context") else span
        if not isinstance(ctx, SpanContext):
            return obj
        meta = obj.setdefault("metadata", {})
        annotations = meta.setdefault("annotations", {})
        annotations[TRACEPARENT_ANNOTATION] = ctx.traceparent()
        return obj

    def extract(self, obj: Optional[dict]) -> Optional[SpanContext]:
        if not obj:
            return None
        annotations = (obj.get("metadata") or {}).get("annotations") or {}
        value = annotations.get(TRACEPARENT_ANNOTATION, "")
        return parse_traceparent(value) if value else None

    # -- introspection -------------------------------------------------------

    def debug_snapshot(self, limit: int = 200) -> dict[str, Any]:
        """The ``/debug/traces`` payload: bounded, newest-first."""
        spans = self.store.spans()
        return {
            "enabled": self._enabled,
            "capacity": self.store.capacity,
            "stored_spans": len(spans),
            "dropped_spans": self.store.dropped,
            "traces": len({s["trace_id"] for s in spans}),
            "spans": spans[-limit:],
        }


# -- the process-global default tracer ---------------------------------------

_default = Tracer()


def default_tracer() -> Tracer:
    return _default


def enable(capacity: Optional[int] = None, reset: bool = True) -> Tracer:
    return _default.enable(capacity=capacity, reset=reset)


def disable() -> None:
    _default.disable()


def enabled() -> bool:
    return _default.enabled()


def start_span(name: str, parent: Optional[object] = None,
               attributes: Optional[dict[str, Any]] = None,
               activate: bool = True, new_root: bool = False):
    return _default.start_span(name, parent=parent, attributes=attributes,
                               activate=activate, new_root=new_root)


def child_span(name: str, attributes: Optional[dict[str, Any]] = None):
    return _default.child_span(name, attributes=attributes)


def span_for_object(name: str, obj: Optional[dict],
                    attributes: Optional[dict[str, Any]] = None):
    return _default.span_for_object(name, obj, attributes=attributes)


def current_span() -> Optional[Span]:
    return _default.current()


def inject(span: object, obj: dict) -> dict:
    return _default.inject(span, obj)


def extract(obj: Optional[dict]) -> Optional[SpanContext]:
    return _default.extract(obj)


def debug_snapshot() -> dict[str, Any]:
    return _default.debug_snapshot()


def annotate_fault(point: str, hit: int, action: str) -> None:
    """Called by ``pkg.faultpoints`` whenever a schedule fires: record the
    injection on the ACTIVE span so chaos traces are self-explaining.
    Must never raise (a tracing hiccup cannot be allowed to alter fault
    semantics) and never imports faultpoints back (no cycle)."""
    if not _default._enabled:
        return
    span = _default.current()
    if span is None:
        return
    try:
        span.add_event("fault.injected",
                       {"point": point, "hit": hit, "action": action})
        span.set_attribute("fault.injected", True)
    except Exception:  # noqa: BLE001 — observability must not alter behavior
        pass


# -- analysis helpers (the trace oracles) -------------------------------------

def audit_traces(traces: dict[str, list[dict[str, Any]]],
                 dropped: int = 0) -> list[str]:
    """Completeness/well-formedness problems across a trace set; empty
    means every trace is complete. A trace is complete when it has exactly
    one root span (no parent), the root ENDED with an ok/error status,
    every span ended, and every parent_id resolves inside the trace.

    ``dropped``: the store's eviction count — a nonzero value makes
    completeness unprovable (spans may be missing), reported as its own
    problem so callers size their ring buffer instead of trusting a
    silently truncated audit."""
    problems: list[str] = []
    if dropped:
        problems.append(f"ring buffer dropped {dropped} spans; "
                        "completeness unprovable (raise capacity)")
    for trace_id, spans in traces.items():
        ids = {s["span_id"] for s in spans}
        roots = [s for s in spans if not s["parent_id"]]
        if len(roots) != 1:
            problems.append(
                f"trace {trace_id}: {len(roots)} root spans (want exactly 1)")
        for root in roots:
            if not root["end"]:
                problems.append(f"trace {trace_id}: root span "
                                f"{root['name']!r} never ended")
            if root["status"] not in ("ok", "error"):
                problems.append(
                    f"trace {trace_id}: root span {root['name']!r} ended "
                    f"with status {root['status']!r} (want ok|error)")
        for s in spans:
            if not s["end"]:
                problems.append(f"trace {trace_id}: span {s['name']!r} "
                                f"({s['span_id']}) never ended")
            if s["parent_id"] and s["parent_id"] not in ids:
                problems.append(
                    f"trace {trace_id}: span {s['name']!r} is orphaned "
                    f"(parent {s['parent_id']} not in trace)")
    return problems


def _pct(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_breakdown(
        traces: dict[str, list[dict[str, Any]]]) -> dict[str, dict[str, Any]]:
    """Per-phase latency distribution across a trace set: every span name
    becomes a phase (count, p50/p99/max in ms), plus two derived phases —
    ``watch_delivery`` (root start → first ``node_prepare`` start: watch
    fan-out + informer dispatch wait, only present when claims flowed
    through the NodePrepareLoop) and ``total`` (root span duration, the
    claim→ready headline the other phases decompose). The derived phases
    use only roots that ended ``ok``: an aborted cycle (allocation
    contention, injected failure) ends its root in microseconds and would
    deflate the claim→ready distribution it claims to describe."""
    samples: dict[str, list[float]] = {}
    for spans in traces.values():
        root = next((s for s in spans if not s["parent_id"]), None)
        root_ok = (root is not None and root["end"]
                   and root["status"] == "ok")
        for s in spans:
            if not s["end"]:
                continue
            if s["parent_id"]:
                samples.setdefault(s["name"], []).append(
                    s["end"] - s["start"])
            elif root_ok:
                samples.setdefault("total", []).append(s["end"] - s["start"])
        if root_ok:
            np_span = next((s for s in spans if s["name"] == "node_prepare"),
                           None)
            if np_span is not None:
                samples.setdefault("watch_delivery", []).append(
                    max(0.0, np_span["start"] - root["start"]))
    out: dict[str, dict[str, Any]] = {}
    for name, xs in sorted(samples.items()):
        out[name] = {
            "count": len(xs),
            "p50_ms": round(_pct(xs, 0.50) * 1e3, 3),
            "p99_ms": round(_pct(xs, 0.99) * 1e3, 3),
            "max_ms": round(max(xs) * 1e3, 3) if xs else 0.0,
        }
    return out


def summarize_store(store: TraceStore, top_problems: int = 10,
                    started: Optional[int] = None) -> dict[str, Any]:
    """The shared trace-health report: trace/span counts, how many traces
    are COMPLETE (audit-clean), the audit problems, how many traces carry
    injected-fault annotations, and the per-phase latency breakdown.

    ``started``: the tracer's started-span count (``started_spans()``).
    Only ENDED spans reach the store, so a leaked non-root span is
    invisible to the per-trace audit; ``started - appended`` is the only
    signal. Pass it ONLY when every span must have ended by now (a
    harness's workers joined) — a harness summarizing while instrumented
    threads are still live would flag legitimately in-flight spans."""
    traces = store.traces()
    complete = 0
    # Reuse audit_traces' dropped-spans message (one source of truth).
    problems: list[str] = audit_traces({}, dropped=store.dropped)
    if started is not None and started > store.appended:
        problems.append(
            f"{started - store.appended} spans started but never ended "
            "(span leak: every start_span/child_span must reach end())")
    for trace_id, spans in traces.items():
        trace_problems = audit_traces({trace_id: spans})
        if trace_problems:
            problems.extend(trace_problems)
        else:
            complete += 1
    fault_annotated = sum(
        1 for spans in traces.values()
        if any(ev["name"] == "fault.injected"
               for s in spans for ev in s["events"]))
    return {
        "traces": len(traces),
        "spans": sum(len(v) for v in traces.values()),
        "complete": complete,
        "audit_problem_count": len(problems),
        "audit_problems": problems[:top_problems],
        "dropped_spans": store.dropped,
        "fault_annotated_traces": fault_annotated,
        "phases": phase_breakdown(traces),
    }


def iter_roots(
        traces: dict[str, list[dict[str, Any]]]) -> Iterator[dict[str, Any]]:
    for spans in traces.values():
        for s in spans:
            if not s["parent_id"]:
                yield s


def _reset_for_tests(capacity: int = DEFAULT_CAPACITY) -> None:
    """Disable + empty the default tracer (registry-free, unlike
    faultpoints there is nothing import-scoped to preserve)."""
    _default.disable()
    _default.store = TraceStore(capacity)
