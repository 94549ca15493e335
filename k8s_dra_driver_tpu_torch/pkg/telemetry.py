"""Fleet telemetry: cluster-wide metrics aggregation + recording rules.

The counterpart of the JAX package's ``pkg/telemetry.py``, with the
``gpu_dra_fleet_*`` family prefix. Every node serves its own ``/metrics``
(``pkg/metrics.MetricsServer``); this plane sees the *fleet*: it scrapes
the N node endpoints, aggregates them, and turns the offline SLOs into
online series (docs/observability.md, "Fleet telemetry"):

- :func:`parse_exposition` — a parser that round-trips the text
  exposition format ``pkg/metrics`` emits (label escaping, histogram
  buckets, ``_sum``/``_count``, ``# EXEMPLAR`` lines).
- :class:`FleetScraper` — polls every node's MetricsServer over HTTP;
  scrape failures are **per-target and never fatal** (the
  ``telemetry.scrape`` fault point proves it): a failing target keeps
  serving its last-good sample set until ``stale_after`` consecutive
  failures, then is **staleness-marked** and excluded from aggregation
  until it scrapes clean again.
- :class:`FleetAggregator` — merges counters, gauges, and histograms
  across targets into fleet-level families, renamed ``gpu_dra_X`` →
  ``gpu_dra_fleet_X`` (:func:`fleet_family_name`), re-served on the CD
  controller's MetricsServer (the aggregator duck-types a Registry via
  ``expose_text``) plus ``/debug/fleet``.
- :class:`RecordingRules` — windowed ``rate``/``increase`` and
  histogram-quantile evaluation over a bounded in-memory sample ring
  (per-series capacity + a series-count cap with counted drops), the
  substrate ``pkg/slo.py`` computes burn rates from.
- :class:`FleetTelemetry` — the facade the controller main assembles:
  one tick = scrape → aggregate → observe rules → evaluate SLOs, on a
  loop thread.
"""

from __future__ import annotations

import logging
import math
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from k8s_dra_driver_tpu_torch.pkg import faultpoints, sanitizer
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    escape_label_value,
    exponential_buckets,
)

logger = logging.getLogger(__name__)

# Fault point (docs/fault-injection.md): one scrape of ONE target fails.
# The contract it proves: a scrape failure is absorbed per-target —
# counted, eventually staleness-marking the target — and can never fail
# the scrape round, the aggregation, or the SLO evaluation riding on it.
FP_SCRAPE = faultpoints.register(
    "telemetry.scrape", "one fleet scrape of one target's /metrics fails")

#: fleet-family naming contract: every aggregated family is the source
#: family with this prefix spliced in after ``gpu_dra_``.
FLEET_PREFIX = "gpu_dra_fleet_"


def fleet_family_name(name: str) -> str:
    """``gpu_dra_X`` → ``gpu_dra_fleet_X`` (non-``gpu_dra_`` names are
    prefixed wholesale; already-fleet names pass through so a controller
    scraping a controller cannot double-prefix)."""
    if name.startswith(FLEET_PREFIX):
        return name
    if name.startswith("gpu_dra_"):
        return FLEET_PREFIX + name[len("gpu_dra_"):]
    return FLEET_PREFIX + name


# --------------------------------------------------------------------------
# Exposition text-format parser (the pkg/metrics emit side's round trip)
# --------------------------------------------------------------------------

@dataclass
class Sample:
    """One exposition line: full sample name (``_bucket``/``_sum``/
    ``_count`` suffixes included), unescaped labels, float value."""

    name: str
    labels: dict[str, str]
    value: float


@dataclass
class Exemplar:
    """One ``# EXEMPLAR`` comment line (docs/observability.md, "Trace
    exemplars"): a sample's last-per-bucket trace attribution — the
    pointer that makes a latency tail clickable into the trace that
    produced it inside an incident bundle."""

    sample_name: str
    labels: dict[str, str]
    trace_id: str
    value: float
    ts: float


@dataclass
class Family:
    """One metric family: declared TYPE/HELP plus every sample line."""

    name: str
    type: str = "untyped"
    help: str = ""
    samples: list[Sample] = field(default_factory=list)
    exemplars: list[Exemplar] = field(default_factory=list)


class ExpositionParseError(ValueError):
    """A line the text format does not allow (bad label block, bad
    value). Carries line number context for scrape diagnostics."""


def _unescape_label_value(s: str) -> str:
    """Inverse of :func:`pkg.metrics.escape_label_value`."""
    out: list[str] = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:  # unknown escape: the format says pass through
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_label_block(block: str, lineno: int) -> dict[str, str]:
    """``name="value",…`` (no surrounding braces), escape-aware."""
    labels: dict[str, str] = {}
    i = 0
    n = len(block)
    while i < n:
        while i < n and block[i] in ", ":
            i += 1
        if i >= n:
            break
        eq = block.find("=", i)
        if eq < 0:
            raise ExpositionParseError(
                f"line {lineno}: label pair without '=' in {block!r}")
        name = block[i:eq].strip()
        j = eq + 1
        if j >= n or block[j] != '"':
            raise ExpositionParseError(
                f"line {lineno}: label value for {name!r} is not quoted")
        j += 1
        raw: list[str] = []
        while j < n:
            c = block[j]
            if c == "\\" and j + 1 < n:
                raw.append(block[j:j + 2])
                j += 2
                continue
            if c == '"':
                break
            raw.append(c)
            j += 1
        if j >= n:
            raise ExpositionParseError(
                f"line {lineno}: unterminated label value for {name!r}")
        labels[name] = _unescape_label_value("".join(raw))
        i = j + 1
    return labels


_SAMPLE_SUFFIXES = ("_bucket", "_sum", "_count")


def base_family_name(sample_name: str,
                     families: dict[str, Family]) -> str:
    """The family a sample line belongs to: exact name, else the
    histogram base when the ``_bucket``/``_sum``/``_count`` suffix
    matches a declared family."""
    if sample_name in families:
        return sample_name
    for suffix in _SAMPLE_SUFFIXES:
        if sample_name.endswith(suffix):
            base = sample_name[:-len(suffix)]
            if base in families:
                return base
    return sample_name


def _split_name_labels(line: str,
                       lineno: int) -> tuple[str, dict[str, str], str]:
    """``name{labels} rest`` / ``name rest`` → (name, labels, rest),
    escape-aware (a ``}`` inside a quoted label value must not terminate
    the block)."""
    if "{" in line:
        brace = line.index("{")
        name = line[:brace]
        j = brace + 1
        in_quotes = False
        while j < len(line):
            c = line[j]
            if in_quotes:
                if c == "\\":
                    j += 2
                    continue
                if c == '"':
                    in_quotes = False
            elif c == '"':
                in_quotes = True
            elif c == "}":
                break
            j += 1
        if j >= len(line):
            raise ExpositionParseError(
                f"line {lineno}: unterminated label block")
        labels = _parse_label_block(line[brace + 1:j], lineno)
        return name, labels, line[j + 1:].strip()
    parts = line.split(None, 1)
    if len(parts) != 2:
        raise ExpositionParseError(
            f"line {lineno}: sample line without a value: {line!r}")
    return parts[0], {}, parts[1]


_EXEMPLAR_PREFIX = "# EXEMPLAR "


def _parse_exemplar_line(line: str, lineno: int) -> Optional[Exemplar]:
    """``# EXEMPLAR name{labels} trace_id=… value=… ts=…`` → Exemplar,
    else None — a malformed exemplar is ignored like any other comment
    (the attribution is advisory; the samples are the contract)."""
    try:
        name, labels, rest = _split_name_labels(
            line[len(_EXEMPLAR_PREFIX):].strip(), lineno)
        fields = dict(tok.split("=", 1) for tok in rest.split()
                      if "=" in tok)
        if "trace_id" not in fields:
            return None
        return Exemplar(sample_name=name, labels=labels,
                        trace_id=fields["trace_id"],
                        value=float(fields.get("value", "nan")),
                        ts=float(fields.get("ts", "0")))
    except (ExpositionParseError, ValueError):
        return None


def parse_exposition(text: str) -> dict[str, Family]:
    """Parse one ``/metrics`` payload (text format 0.0.4) into families.

    Raises :class:`ExpositionParseError` on malformed lines — a scrape of
    a corrupt exposition must fail loudly (per-target, absorbed by the
    scraper) rather than aggregate garbage. ``# EXEMPLAR`` comment lines
    (the trace-exemplar extension ``pkg/metrics`` emits) are parsed into
    ``Family.exemplars``; other comments are ignored.
    """
    families: dict[str, Family] = {}

    def family(name: str) -> Family:
        fam = families.get(name)
        if fam is None:
            fam = Family(name)
            families[name] = fam
        return fam

    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            if line.startswith(_EXEMPLAR_PREFIX):
                ex = _parse_exemplar_line(line, lineno)
                if ex is not None:
                    family(base_family_name(ex.sample_name,
                                            families)).exemplars.append(ex)
                continue
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                family(parts[2]).type = parts[3] if len(parts) > 3 else ""
            elif len(parts) >= 3 and parts[1] == "HELP":
                family(parts[2]).help = parts[3] if len(parts) > 3 else ""
            continue  # other comments are legal and ignored
        name, labels, rest = _split_name_labels(line, lineno)
        value_tok = rest.split()[0] if rest.split() else ""
        try:
            value = float(value_tok)
        except ValueError as e:
            raise ExpositionParseError(
                f"line {lineno}: bad sample value {value_tok!r}") from e
        fam = family(base_family_name(name, families))
        fam.samples.append(Sample(name=name, labels=labels, value=value))
    return families


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return str(v)


def render_exposition(families: Iterable[Family]) -> str:
    """Families → text format (the emit half of the round trip; label
    values re-escaped exactly as ``pkg/metrics`` escapes them, exemplar
    comments re-emitted after their family's samples)."""
    lines: list[str] = []

    def fmt(name: str, labels: dict[str, str]) -> str:
        if not labels:
            return name
        pairs = ",".join(f'{k}="{escape_label_value(v)}"'
                         for k, v in labels.items())
        return f"{name}{{{pairs}}}"

    for fam in families:
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.type}")
        for s in fam.samples:
            lines.append(f"{fmt(s.name, s.labels)} {_fmt_value(s.value)}")
        for ex in fam.exemplars:
            lines.append(
                f"{_EXEMPLAR_PREFIX}{fmt(ex.sample_name, ex.labels)} "
                f"trace_id={ex.trace_id} value={ex.value} ts={ex.ts}")
    return "\n".join(lines) + "\n"


def collect_exemplars(per_target: dict[str, dict[str, Family]],
                      cap: int = 64) -> list[dict[str, Any]]:
    """Flatten every target's parsed exemplars into bounded bundle rows
    (newest first) — the incident bundle's metric→trace join surface."""
    rows: list[dict[str, Any]] = []
    for target, families in per_target.items():
        for fam in families.values():
            for ex in fam.exemplars:
                rows.append({
                    "target": target,
                    "family": fam.name,
                    "sample": ex.sample_name,
                    "labels": dict(ex.labels),
                    "trace_id": ex.trace_id,
                    "value": ex.value,
                    "ts": ex.ts,
                })
    rows.sort(key=lambda r: -r["ts"])
    return rows[:cap]


def semantic_samples(
        families: dict[str, Family]) -> dict[tuple, float]:
    """Canonical value map for round-trip equality in tests:
    (family, sample name, sorted label items) → value."""
    out: dict[tuple, float] = {}
    for fam in families.values():
        for s in fam.samples:
            out[(fam.name, s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


# --------------------------------------------------------------------------
# Fleet scrape-health metrics (served next to the aggregate)
# --------------------------------------------------------------------------

class FleetMetrics:
    """The telemetry plane's own health families (docs/observability.md,
    "Fleet telemetry"): scrape outcomes, target up/stale counts, scrape
    latency, recording-rule outputs as first-class series, and ring
    eviction (bounded memory is a contract, silent drops are not)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.scrapes_total = r.register(Counter(
            "gpu_dra_fleet_scrapes_total",
            "Per-target scrape attempts by outcome (success / error).",
            ("outcome",)))
        self.targets = r.register(Gauge(
            "gpu_dra_fleet_targets",
            "Scrape targets by state (up / stale).",
            ("state",)))
        self.scrape_seconds = r.register(Histogram(
            "gpu_dra_fleet_scrape_seconds",
            "Wall time of one whole scrape round across all targets.",
            exponential_buckets(0.001, 4, 8), ()))
        self.rule_value = r.register(Gauge(
            "gpu_dra_fleet_rule_value",
            "Latest value of each recording rule (claim-ready latency, "
            "error ratios, recovery time) as a first-class series.",
            ("rule",)))
        self.series_dropped_total = r.register(Counter(
            "gpu_dra_fleet_series_dropped_total",
            "Series the recording-rule ring refused at its series cap.",
            ()))
        self.window_truncated_total = r.register(Counter(
            "gpu_dra_fleet_window_truncated_total",
            "Windowed queries that reached past the ring's retained "
            "span (result degraded to since-oldest-sample).",
            ()))


_default_fleet_metrics: Optional[FleetMetrics] = None


def default_fleet_metrics() -> FleetMetrics:
    global _default_fleet_metrics
    if _default_fleet_metrics is None:
        _default_fleet_metrics = FleetMetrics()
    return _default_fleet_metrics


# --------------------------------------------------------------------------
# Fleet scraper
# --------------------------------------------------------------------------

@dataclass
class _TargetState:
    name: str
    url: str
    families: Optional[dict[str, Family]] = None  # last GOOD parse
    last_success: Optional[float] = None
    consecutive_failures: int = 0
    scrapes: int = 0
    failures: int = 0
    last_error: str = ""


def _http_fetch(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", errors="replace")


def normalize_target(spec: str) -> tuple[str, str]:
    """``host:port`` / full URL → (name, /metrics URL)."""
    spec = spec.strip()
    url = spec if "://" in spec else f"http://{spec}"
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    return spec, url


class FleetScraper:
    """Polls every target's ``/metrics`` and keeps per-target state.

    Failure contract (the ``telemetry.scrape`` fault point's leg): one
    target failing — connection refused, timeout, corrupt exposition,
    injected — is counted and absorbed; its last-good families keep
    feeding the aggregate until ``stale_after`` consecutive failures,
    after which the target is staleness-marked and EXCLUDED until a clean
    scrape. ``scrape_once`` never raises.
    """

    def __init__(
        self,
        targets: Iterable[str | tuple[str, str]] = (),
        timeout_s: float = 2.0,
        stale_after: int = 3,
        metrics: Optional[FleetMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
        fetch: Optional[Callable[[str, str], str]] = None,
    ):
        """``fetch(name, url) -> text`` is injectable for tests; the
        default is a plain HTTP GET."""
        self.timeout_s = timeout_s
        self.stale_after = max(1, stale_after)
        self.metrics = metrics or default_fleet_metrics()
        self.clock = clock
        self._fetch = fetch or (
            lambda _name, url: _http_fetch(url, self.timeout_s))
        self._mu = sanitizer.new_lock("FleetScraper._mu")
        self._targets: dict[str, _TargetState] = {}
        self.set_targets(targets)

    def set_targets(self, targets: Iterable[str | tuple[str, str]]) -> None:
        """Replace the target set (nodes joining/leaving); state of
        targets that persist is kept."""
        specs: list[tuple[str, str]] = []
        for t in targets:
            if isinstance(t, tuple):
                specs.append(t)
            else:
                specs.append(normalize_target(t))
        with self._mu:
            fresh: dict[str, _TargetState] = {}
            for name, url in specs:
                prev = self._targets.get(name)
                if prev is not None and prev.url == url:
                    fresh[name] = prev
                else:
                    fresh[name] = _TargetState(name=name, url=url)
            self._targets = fresh

    def target_names(self) -> list[str]:
        with self._mu:
            return sorted(self._targets)

    def _stale(self, st: _TargetState) -> bool:
        return (st.families is None
                or st.consecutive_failures >= self.stale_after)

    def scrape_once(self) -> dict[str, dict[str, Family]]:
        """One round over every target. Returns the non-stale targets'
        families (the aggregation input). Never raises."""
        with self._mu:
            states = list(self._targets.values())
        t0 = self.clock()
        for st in states:
            st.scrapes += 1
            try:
                faultpoints.maybe_fail(FP_SCRAPE)
                families = parse_exposition(self._fetch(st.name, st.url))
            except Exception as e:  # noqa: BLE001 — per-target, absorbed:
                # a down node must not take the telemetry plane with it.
                st.failures += 1
                st.consecutive_failures += 1
                st.last_error = repr(e)
                self.metrics.scrapes_total.inc(outcome="error")
                if st.consecutive_failures == self.stale_after:
                    logger.warning(
                        "scrape target %s stale after %d consecutive "
                        "failures (last: %s)", st.name,
                        st.consecutive_failures, st.last_error)
                continue
            st.families = families
            st.last_success = self.clock()
            st.consecutive_failures = 0
            st.last_error = ""
            self.metrics.scrapes_total.inc(outcome="success")
        self.metrics.scrape_seconds.observe(self.clock() - t0)
        up = sum(1 for st in states if not self._stale(st))
        self.metrics.targets.set(up, state="up")
        self.metrics.targets.set(len(states) - up, state="stale")
        return {st.name: st.families for st in states
                if not self._stale(st) and st.families is not None}

    def target_families(self) -> dict[str, dict[str, Family]]:
        """Last-good parsed families per NON-STALE target — the incident
        bundle's exemplar source (the same view aggregation consumes)."""
        with self._mu:
            states = list(self._targets.values())
        return {st.name: st.families for st in states
                if not self._stale(st) and st.families is not None}

    def target_report(self) -> list[dict[str, Any]]:
        """Per-target scrape health for ``/debug/fleet`` and harness
        oracles."""
        with self._mu:
            states = list(self._targets.values())
        now = self.clock()
        return [{
            "name": st.name,
            "url": st.url,
            "stale": self._stale(st),
            "scrapes": st.scrapes,
            "failures": st.failures,
            "consecutive_failures": st.consecutive_failures,
            "last_success_age_s": (round(now - st.last_success, 3)
                                   if st.last_success is not None else None),
            "last_error": st.last_error,
        } for st in sorted(states, key=lambda s: s.name)]


# --------------------------------------------------------------------------
# Fleet aggregator
# --------------------------------------------------------------------------

class FleetAggregator:
    """Merges per-target families into ``gpu_dra_fleet_*`` families.

    Merge semantics per sample key (renamed sample name + label set):
    counters, histograms (bucket/sum/count sample-wise), gauges, and
    untyped all SUM across targets — a fleet counter is the fleet's
    total, a fleet gauge (inflight, prepared devices) is the fleet-wide
    occupancy. Duck-types a ``pkg.metrics.Registry`` via
    :meth:`expose_text`, so the controller's MetricsServer re-serves the
    aggregate directly.
    """

    def __init__(self) -> None:
        self._mu = sanitizer.new_lock("FleetAggregator._mu")
        self._families: dict[str, Family] = {}

    def aggregate(
        self, per_target: dict[str, dict[str, Family]],
    ) -> dict[str, Family]:
        merged: dict[str, Family] = {}
        acc: dict[tuple, float] = {}
        sample_meta: dict[tuple, tuple[str, dict[str, str]]] = {}
        for families in per_target.values():
            for fam in families.values():
                out_name = fleet_family_name(fam.name)
                out = merged.get(out_name)
                if out is None:
                    out = Family(out_name, type=fam.type,
                                 help=fam.help)
                    merged[out_name] = out
                for s in fam.samples:
                    s_name = (out_name + s.name[len(fam.name):]
                              if s.name.startswith(fam.name)
                              else fleet_family_name(s.name))
                    key = (out_name, s_name,
                           tuple(sorted(s.labels.items())))
                    acc[key] = acc.get(key, 0.0) + s.value
                    sample_meta[key] = (s_name, s.labels)
        for key in sorted(acc, key=lambda k: (k[0], k[1], k[2])):
            fam_name, _, _ = key
            s_name, labels = sample_meta[key]
            merged[fam_name].samples.append(
                Sample(name=s_name, labels=dict(labels), value=acc[key]))
        with self._mu:
            self._families = merged
        return merged

    def families(self) -> dict[str, Family]:
        with self._mu:
            return dict(self._families)

    def expose_text(self) -> str:
        with self._mu:
            fams = [self._families[k] for k in sorted(self._families)]
        return render_exposition(fams)


# --------------------------------------------------------------------------
# Recording rules: windowed derivations over a bounded sample ring
# --------------------------------------------------------------------------

class RecordingRules:
    """Bounded in-memory time series over the scraped fleet, plus the
    windowed derivations Prometheus recording rules would compute:
    counter ``increase``/``rate`` (reset-aware), ratio-of-increases, and
    ``histogram_quantile`` over bucket increases.

    Series are ringed **per target** (``observe_targets``), NOT over the
    fleet sum: a summed series jumps by a node's whole lifetime totals
    whenever the contributing target set changes — a staleness-marked
    target dropping out reads as a giant counter reset, a rejoining one
    as a burst of traffic — and either would fabricate burn inside every
    trailing window. Per-target rings keep each series a true counter
    (a node-plugin restart is a genuine per-target reset, handled by the
    reset-aware increase), and windowed queries sum the per-series
    increases. Derivations read the FLEET family names; sample names are
    mapped through :func:`fleet_family_name` at observe time.

    Memory is bounded two ways: each series keeps at most
    ``ring_capacity`` (t, value) points, and at most ``max_series``
    distinct series are tracked — past the cap new series are COUNTED as
    dropped (``gpu_dra_fleet_series_dropped_total``), never silently
    absorbed. A query window reaching past the retained span (ring at
    capacity with its oldest point inside the window) is likewise
    counted (``gpu_dra_fleet_window_truncated_total``): the result
    degrades to since-oldest-sample, visibly, never silently.

    A counter starts at zero. A series that a target's previous snapshot
    did not have was born since, so its ring opens with a zero at that
    snapshot's time and its first value counts as increase (the zero
    Prometheus ingests at a series' created timestamp). Without it the
    first failed prepare a node reports under a new ``error_type`` was the
    series' baseline and counted for nothing, and a burn-rate alert fired
    only on the second. A target's first snapshot gives no such bound:
    there each series' first point stays its baseline, so lifetime totals
    never read as burn.
    """

    def __init__(
        self,
        ring_capacity: int = 512,
        max_series: int = 8192,
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[FleetMetrics] = None,
    ):
        self.ring_capacity = ring_capacity
        self.max_series = max_series
        self.clock = clock
        self.metrics = metrics or default_fleet_metrics()
        self._mu = sanitizer.new_lock("RecordingRules._mu")
        # (fleet sample name, target, sorted label items)
        #   -> (labels, deque[(t, v)])
        self._rings: dict[tuple, tuple[dict[str, str], deque]] = {}
        # target -> when its last snapshot was observed
        self._last_seen: dict[str, float] = {}
        self.dropped_series = 0

    _OBSERVED_TYPES = ("counter", "histogram")

    def observe_targets(self, per_target: dict[str, dict[str, Family]],
                        now: Optional[float] = None) -> None:
        """Append one scrape round's per-target snapshots (the
        :meth:`FleetScraper.scrape_once` output — base family names,
        renamed here)."""
        t = self.clock() if now is None else now
        with self._mu:
            for target, families in per_target.items():
                self._observe_locked(families, t, target, rename=True)

    def observe(self, families: dict[str, Family],
                now: Optional[float] = None) -> None:
        """Single-source form (tests, pre-aggregated feeds): sample
        names already fleet-level, ringed under one anonymous target.
        Only counters and histograms are ringed — windowed derivations
        are defined on monotone series; gauges are served live by the
        aggregator."""
        t = self.clock() if now is None else now
        with self._mu:
            self._observe_locked(families, t, "", rename=False)

    def _observe_locked(self, families: dict[str, Family], t: float,
                        target: str, rename: bool) -> None:
        born = self._last_seen.get(target)
        self._last_seen[target] = t
        for fam in families.values():
            if fam.type not in self._OBSERVED_TYPES:
                continue
            for s in fam.samples:
                name = fleet_family_name(s.name) if rename else s.name
                key = (name, target, tuple(sorted(s.labels.items())))
                entry = self._rings.get(key)
                if entry is None:
                    if len(self._rings) >= self.max_series:
                        self.dropped_series += 1
                        self.metrics.series_dropped_total.inc()
                        continue
                    entry = (dict(s.labels),
                             deque(maxlen=self.ring_capacity))
                    self._rings[key] = entry
                    if born is not None:
                        entry[1].append((born, 0.0))
                entry[1].append((t, s.value))

    # -- window math ---------------------------------------------------------

    @staticmethod
    def _ring_increase(samples: deque, start: float) -> Optional[float]:
        """Reset-aware increase since ``start``: baseline = the last
        point at/before ``start`` (else the first point in window).
        None when fewer than 2 usable points exist."""
        window: list[tuple[float, float]] = []
        baseline: Optional[tuple[float, float]] = None
        for t, v in samples:
            if t <= start:
                baseline = (t, v)
            else:
                window.append((t, v))
        pts = ([baseline] if baseline is not None else []) + window
        if len(pts) < 2:
            return None
        acc = 0.0
        prev = pts[0][1]
        for _t, v in pts[1:]:
            acc += (v - prev) if v >= prev else v  # v < prev: counter reset
            prev = v
        return acc

    def _matching(self, sample_name: str,
                  match: Optional[dict[str, str]]) -> list[deque]:
        out = []
        for (name, _target, _items), (labels, ring) in self._rings.items():
            if name != sample_name:
                continue
            if match and any(labels.get(k) != v for k, v in match.items()):
                continue
            out.append(ring)
        return out

    def _note_truncation(self, rings: list[deque], start: float) -> None:
        """A full ring whose oldest retained point is younger than the
        window start means the window reaches past retention — the query
        silently degrades to since-oldest unless counted here."""
        if any(r.maxlen is not None and len(r) == r.maxlen
               and r[0][0] > start for r in rings):
            self.metrics.window_truncated_total.inc()

    def increase(self, sample_name: str, window_s: float,
                 match: Optional[dict[str, str]] = None) -> Optional[float]:
        """Summed reset-aware increase over the trailing window across
        every series of ``sample_name`` whose labels ⊇ ``match``. None
        when no series has enough data yet."""
        start = self.clock() - window_s
        with self._mu:
            rings = self._matching(sample_name, match)
            self._note_truncation(rings, start)
            incs = [self._ring_increase(r, start) for r in rings]
        incs = [i for i in incs if i is not None]
        if not incs:
            return None
        return sum(incs)

    def rate(self, sample_name: str, window_s: float,
             match: Optional[dict[str, str]] = None) -> Optional[float]:
        inc = self.increase(sample_name, window_s, match)
        if inc is None:
            return None
        return inc / window_s if window_s > 0 else None

    def ratio(self, num_name: str, den_name: str, window_s: float,
              num_match: Optional[dict[str, str]] = None,
              den_match: Optional[dict[str, str]] = None,
              ) -> Optional[float]:
        """increase(num)/increase(den) over the same window — the
        error-ratio form burn rates are computed from. None when the
        denominator saw no traffic (no traffic = no burn, NOT an
        alert)."""
        den = self.increase(den_name, window_s, den_match)
        if not den:
            return None
        num = self.increase(num_name, window_s, num_match) or 0.0
        return max(0.0, min(1.0, num / den))

    def _bucket_increases(
        self, family: str, window_s: float,
        match: Optional[dict[str, str]],
    ) -> tuple[list[tuple[float, float]], float]:
        """[(le, increase)] sorted by le (cumulative), + total count
        increase, over the window."""
        start = self.clock() - window_s
        by_le: dict[float, float] = {}
        with self._mu:
            for (name, _target, _items), (labels, ring) in \
                    self._rings.items():
                if name != family + "_bucket":
                    continue
                if match and any(labels.get(k) != v
                                 for k, v in match.items()
                                 if k != "le"):
                    continue
                try:
                    le = float(labels.get("le", ""))
                except ValueError:
                    continue
                self._note_truncation([ring], start)
                inc = self._ring_increase(ring, start)
                if inc is not None:
                    by_le[le] = by_le.get(le, 0.0) + inc
        buckets = sorted(by_le.items())
        total = by_le.get(math.inf, 0.0)
        return buckets, total

    def bucket_good_ratio(
        self, family: str, le: float, window_s: float,
        match: Optional[dict[str, str]] = None,
    ) -> Optional[float]:
        """Fraction of the window's observations ≤ ``le`` — the "good
        events" ratio a latency SLO is made of. ``le`` must be one of the
        histogram's bucket bounds. None without traffic."""
        buckets, total = self._bucket_increases(family, window_s, match)
        if total <= 0:
            return None
        good = 0.0
        for b, inc in buckets:
            if b <= le:
                good = max(good, inc)  # cumulative: the largest le ≤ bound
        return max(0.0, min(1.0, good / total))

    def quantile(self, family: str, q: float, window_s: float,
                 match: Optional[dict[str, str]] = None) -> Optional[float]:
        """``histogram_quantile(q, increase(family_bucket[window]))`` with
        Prometheus's linear interpolation inside the winning bucket (and
        its convention of returning the highest finite bound when the
        quantile lands in +Inf)."""
        buckets, total = self._bucket_increases(family, window_s, match)
        if total <= 0:
            return None
        want = q * total
        prev_le, prev_cum = 0.0, 0.0
        finite = [b for b in buckets if not math.isinf(b[0])]
        for le, cum in buckets:
            if cum >= want:
                if math.isinf(le):
                    return finite[-1][0] if finite else None
                span = cum - prev_cum
                if span <= 0:
                    return le
                frac = (want - prev_cum) / span
                return prev_le + (le - prev_le) * frac
            if not math.isinf(le):
                prev_le, prev_cum = le, cum
        return finite[-1][0] if finite else None

    def series_count(self) -> int:
        with self._mu:
            return len(self._rings)

    def dump_recent(self, sample_names: Iterable[str], window_s: float,
                    max_series: int = 64,
                    max_points: int = 64) -> dict[str, list[list[float]]]:
        """Raw per-target ring points for the trailing window, bounded
        both ways — the incident bundle's "recording-rule windows around
        the burn" section. Keys are ``sample{target=…,label=…}`` strings;
        values are ``[t, v]`` pairs oldest-first (the newest
        ``max_points`` of each series)."""
        start = self.clock() - window_s
        wanted = set(sample_names)
        out: dict[str, list[list[float]]] = {}
        with self._mu:
            for (name, target, items), (_labels, ring) in \
                    self._rings.items():
                if name not in wanted and not any(
                        name.startswith(w) for w in wanted):
                    continue
                pts = [[round(t, 4), v] for t, v in ring if t >= start]
                if not pts:
                    continue
                lbl = ",".join([f"target={target}"]
                               + [f"{k}={v}" for k, v in items])
                out[f"{name}{{{lbl}}}"] = pts[-max_points:]
                if len(out) >= max_series:
                    break
        return out


# --------------------------------------------------------------------------
# Named recording rules (the first-class series the SLOs read)
# --------------------------------------------------------------------------

#: fleet family names the default rules and SLOs are written against
#: (the :func:`fleet_family_name` images of the pkg/metrics families).
FLEET_REQUESTS_TOTAL = "gpu_dra_fleet_requests_total"
FLEET_REQUEST_DURATION = "gpu_dra_fleet_request_duration_seconds"
FLEET_PREPARE_ERRORS = "gpu_dra_fleet_node_prepare_errors_total"
FLEET_RECOVERY_SECONDS = "gpu_dra_fleet_remediation_recovery_seconds"
FLEET_ALLOCATIONS_TOTAL = "gpu_dra_fleet_allocator_allocations_total"
FLEET_CANARY_PROBES = "gpu_dra_fleet_canary_probes_total"
FLEET_SERVING_CLAIM_ATTEMPTS = "gpu_dra_fleet_serving_claim_attempts_total"


@dataclass(frozen=True)
class Rule:
    """One named recording rule: evaluated every tick, served as
    ``gpu_dra_fleet_rule_value{rule=…}`` and readable by SLOs."""

    name: str
    fn: Callable[[RecordingRules, float], Optional[float]]


def default_rules() -> tuple[Rule, ...]:
    """The shipped rule set (docs/observability.md): the offline SLO
    surfaces — claim-ready latency, prepare error ratio, remediation
    recovery time — as online series."""
    return (
        Rule("claim_ready_p99_seconds",
             lambda r, w: r.quantile(
                 FLEET_REQUEST_DURATION, 0.99, w,
                 match={"operation": "prepare"})),
        Rule("claim_ready_p50_seconds",
             lambda r, w: r.quantile(
                 FLEET_REQUEST_DURATION, 0.50, w,
                 match={"operation": "prepare"})),
        Rule("prepare_error_ratio",
             lambda r, w: r.ratio(
                 FLEET_PREPARE_ERRORS, FLEET_REQUESTS_TOTAL, w,
                 den_match={"operation": "prepare"})),
        Rule("recovery_p99_seconds",
             lambda r, w: r.quantile(FLEET_RECOVERY_SECONDS, 0.99, w)),
        # Admission health (docs/performance.md, "Topology-aware
        # allocation"): the fraction of allocation attempts that bounced
        # while aggregate capacity existed — fragmentation, the defrag
        # planner's signal.
        Rule("allocation_fragmented_ratio",
             lambda r, w: r.ratio(
                 FLEET_ALLOCATIONS_TOTAL, FLEET_ALLOCATIONS_TOTAL, w,
                 num_match={"outcome": "fragmented"})),
        # The user-perspective surface (docs/observability.md,
        # "Synthetic probing"): the fraction of synthetic canary probes
        # completing the full claim lifecycle — the canary_availability
        # SLO's signal, served as a first-class dashboard series.
        Rule("canary_success_ratio",
             lambda r, w: r.ratio(
                 FLEET_CANARY_PROBES, FLEET_CANARY_PROBES, w,
                 num_match={"outcome": "ok"})),
        # Serving readiness (docs/observability.md, "Serving
        # dataplane"): the fraction of replica serve sessions whose
        # claim reached a first decoded batch inside the deadline —
        # the claim_ready SLO's signal, measured over the LIVE fleet
        # families, not an offline percentile.
        Rule("serving_claim_ready_ratio",
             lambda r, w: r.ratio(
                 FLEET_SERVING_CLAIM_ATTEMPTS,
                 FLEET_SERVING_CLAIM_ATTEMPTS, w,
                 num_match={"outcome": "ok"})),
    )


# --------------------------------------------------------------------------
# FleetTelemetry: the assembled plane
# --------------------------------------------------------------------------

class FleetTelemetry:
    """scraper → aggregator → recording rules → SLO engine, one tick at
    a time on a loop thread (or driven by ``tick()`` in tests).

    ``slo_engine`` is any object with an ``evaluate()`` method (see
    :class:`pkg.slo.SloEngine`); it is handed the same
    :class:`RecordingRules` this instance feeds. The controller main
    passes ``self.aggregator`` to its MetricsServer as an extra registry
    and mounts :meth:`debug_snapshot` at ``/debug/fleet``.
    """

    def __init__(
        self,
        targets: Iterable[str | tuple[str, str]] = (),
        interval_s: float = 15.0,
        rule_window_s: float = 300.0,
        rules: Optional[tuple[Rule, ...]] = None,
        slo_engine: Optional[Any] = None,
        metrics: Optional[FleetMetrics] = None,
        clock: Callable[[], float] = time.monotonic,
        scraper: Optional[FleetScraper] = None,
        ring_capacity: int = 2048,
        **scraper_kwargs: Any,
    ):
        """``ring_capacity``: per-series retention in scrape rounds —
        the default 2048 covers ~8.5 h at the 15 s production interval
        (the page pair and the ticket SHORT window in full; the 3 d
        ticket long window evaluates over retained history, counted in
        ``gpu_dra_fleet_window_truncated_total``). Size it to
        ``max_window / interval_s`` when full 3 d fidelity matters and
        the target count affords the memory."""
        self.metrics = metrics or default_fleet_metrics()
        self.clock = clock
        self.interval_s = interval_s
        self.rule_window_s = rule_window_s
        self.scraper = scraper or FleetScraper(
            targets, metrics=self.metrics, clock=clock, **scraper_kwargs)
        self.aggregator = FleetAggregator()
        self.rules = RecordingRules(ring_capacity=ring_capacity,
                                    clock=clock, metrics=self.metrics)
        self.rule_defs = rules if rules is not None else default_rules()
        self.slo_engine = slo_engine
        self._mu = sanitizer.new_lock("FleetTelemetry._mu")
        self._rule_values: dict[str, Optional[float]] = {}
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> dict[str, Family]:
        """One full round; never raises (scrape failures are per-target,
        rule/SLO failures are logged — the telemetry loop must outlive
        any one bad evaluation)."""
        per_target = self.scraper.scrape_once()
        families = self.aggregator.aggregate(per_target)
        # Ring PER TARGET, not the aggregate: the summed series jumps by
        # whole lifetime totals when the target set changes (staleness,
        # rejoin, node restart), which would read as burn.
        self.rules.observe_targets(per_target)
        values: dict[str, Optional[float]] = {}
        for rule in self.rule_defs:
            try:
                v = rule.fn(self.rules, self.rule_window_s)
            except Exception:  # noqa: BLE001 — one bad rule must not
                # starve the others or the SLO evaluation.
                logger.exception("recording rule %s failed", rule.name)
                v = None
            values[rule.name] = v
            if v is not None:
                self.metrics.rule_value.set(v, rule=rule.name)
        with self._mu:
            self._rule_values = values
            self._ticks += 1
        if self.slo_engine is not None:
            try:
                self.slo_engine.evaluate()
            except Exception:  # noqa: BLE001 — ditto
                logger.exception("SLO evaluation failed this tick")
        return families

    def rule_values(self) -> dict[str, Optional[float]]:
        with self._mu:
            return dict(self._rule_values)

    def ticks(self) -> int:
        with self._mu:
            return self._ticks

    def debug_snapshot(self) -> dict[str, Any]:
        """The ``/debug/fleet`` payload."""
        with self._mu:
            rule_values = dict(self._rule_values)
            ticks = self._ticks
        out: dict[str, Any] = {
            "ticks": ticks,
            "interval_s": self.interval_s,
            "rule_window_s": self.rule_window_s,
            "targets": self.scraper.target_report(),
            "families": sorted(self.aggregator.families()),
            "rules": rule_values,
            "series": self.rules.series_count(),
            "series_dropped": self.rules.dropped_series,
        }
        if self.slo_engine is not None and hasattr(
                self.slo_engine, "debug_snapshot"):
            out["slo"] = self.slo_engine.debug_snapshot()
        return out

    # -- loop ----------------------------------------------------------------

    def start(self) -> "FleetTelemetry":
        self._thread = threading.Thread(
            target=self._run, name="fleet-telemetry", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must never die
                logger.exception("fleet telemetry tick crashed; continuing")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
