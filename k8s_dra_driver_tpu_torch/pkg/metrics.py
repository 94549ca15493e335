"""Prometheus-style metrics with text exposition.

The subset of the JAX package's ``pkg/metrics.py`` that the serving
engine's ``ServingMetrics`` uses: Counter, Gauge and Histogram with label
vectors, a Registry, and the same text exposition format, line for line.

Histogram exemplars take an explicit trace id only; there is no tracer in
this package yet to supply one from an active span.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional, Sequence


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
