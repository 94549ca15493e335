"""Span API of the claim-path tracer, in its disabled state.

The JAX package's ``pkg/tracing.py`` records W3C-traceparent spans across
the claim path when enabled; disabled (its default), every span is one
shared no-op. This package keeps that disabled surface — the calls the
copied modules make — so that the tracer can be ported later without
touching them.
"""

from __future__ import annotations

from typing import Any, Optional

class _NoopSpan:
    """The shared disabled-mode span: every method is a cheap no-op."""

    __slots__ = ()

    trace_id = ""
    span_id = ""
    parent_id = ""
    name = ""

    def set_attribute(self, key: str, value: Any) -> "_NoopSpan":
        return self

    def add_event(self, name: str, attributes=None) -> "_NoopSpan":
        return self

    def set_status(self, status: str, message: str = "") -> "_NoopSpan":
        return self

    @property
    def recording(self) -> bool:
        return False

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def child_span(name: str,
               attributes: Optional[dict[str, Any]] = None) -> _NoopSpan:
    return NOOP_SPAN


def start_span(name: str, parent: Optional[object] = None,
               attributes: Optional[dict[str, Any]] = None,
               activate: bool = True, new_root: bool = False) -> _NoopSpan:
    return NOOP_SPAN


def span_for_object(name: str, obj: Optional[dict],
                    attributes: Optional[dict[str, Any]] = None) -> _NoopSpan:
    return NOOP_SPAN


def current_span() -> None:
    """No span is ever active while tracing is disabled."""
    return None


def inject(span: object, obj: dict) -> dict:
    """Stamps a span's traceparent on an object: no-op spans stamp none."""
    return obj


def extract(obj: Optional[dict]) -> None:
    """The traceparent an object carries: none is read while disabled."""
    return None


def annotate_fault(point: str, hit: int, action: str) -> None:
    """Records an injected fault on the active span: none is active."""


#: the JAX tracer's default span-store capacity, reported as it reports it.
DEFAULT_CAPACITY = 8192


def debug_snapshot() -> dict[str, Any]:
    """The ``/debug/traces`` payload, as the JAX tracer serves it while
    disabled: no span stored, none dropped."""
    return {"enabled": False, "capacity": DEFAULT_CAPACITY,
            "stored_spans": 0, "dropped_spans": 0, "traces": 0, "spans": []}
