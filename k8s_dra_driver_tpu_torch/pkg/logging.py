"""Shared structured-logging setup for every binary.

The counterpart of the JAX package's ``pkg/logging.py`` (the reference's
klog wiring, ``pkg/flags/logging.go``): a classic text formatter or
machine-parseable JSON lines (``--log-format json``), each record carrying
the emitting ``component`` (binary name) and — when the record is produced
inside a recording trace span (``pkg/tracing.py``) — its
``trace_id``/``span_id``.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import IO, Optional

from k8s_dra_driver_tpu_torch.pkg import tracing

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

LOG_FORMATS = ("text", "json")


def parse_level(name: str) -> int:
    try:
        return LOG_LEVELS[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown log level {name!r} (known: {', '.join(LOG_LEVELS)})"
        ) from None


def _trace_ids() -> tuple[str, str]:
    span = tracing.current_span()
    if span is None or not span.recording:
        return "", ""
    return span.trace_id, span.span_id


class JSONFormatter(logging.Formatter):
    """One JSON object per line: ts (epoch seconds), level, component,
    logger, message, optional trace_id/span_id and exception text."""

    def __init__(self, component: str = ""):
        super().__init__()
        self.component = component

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "component": self.component,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id, span_id = _trace_ids()
        if trace_id:
            doc["trace_id"] = trace_id
            doc["span_id"] = span_id
        if record.exc_info and record.exc_info[0] is not None:
            doc["exception"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


class TextFormatter(logging.Formatter):
    """The classic human format, plus component and (when present) a
    ``trace=<id>`` suffix so a traced operation's lines are greppable."""

    def __init__(self, component: str = ""):
        super().__init__(fmt="%(asctime)s %(name)s %(levelname)s %(message)s")
        self.component = component
        self.converter = time.localtime

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        if self.component:
            line = f"{self.component} {line}"
        trace_id, _span_id = _trace_ids()
        if trace_id:
            line = f"{line} trace={trace_id}"
        return line


def setup_logging(component: str = "", level: str = "info",
                  fmt: str = "text",
                  stream: Optional[IO[str]] = None) -> logging.Handler:
    """(Re)configure the root logger: one stream handler with the chosen
    formatter. Idempotent — previously installed handlers from an earlier
    call are replaced, not stacked (re-exec'd mains, tests)."""
    if fmt not in LOG_FORMATS:
        raise ValueError(
            f"unknown log format {fmt!r} (known: {', '.join(LOG_FORMATS)})")
    root = logging.getLogger()
    root.setLevel(parse_level(level))
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JSONFormatter(component) if fmt == "json"
                         else TextFormatter(component))
    handler._gpu_dra_logging = True  # type: ignore[attr-defined]
    for h in list(root.handlers):
        if getattr(h, "_gpu_dra_logging", False):
            root.removeHandler(h)
    root.addHandler(handler)
    return handler
