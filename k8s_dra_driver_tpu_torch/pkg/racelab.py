"""racelab: vector-clock happens-before race detection and seeded schedule
fuzzing.

The Go reference driver gets data-race detection from ``go test -race``;
the sanitizer (``pkg/sanitizer.py``) asserts lock *discipline* (order
graph, guarded mutations) but cannot say whether two accesses on different
threads were *ordered*. This module is that half: a FastTrack-style
happens-before detector plus a PCT-style schedule perturber, both for
tests and checking harnesses.

**Detector.** Every thread carries a vector clock (tid → logical time).
Happens-before edges come from:

- lock release → later acquire of the SAME lock instance
  (:func:`on_acquire` / :func:`on_release`, fed by ``TrackedLock``);
- thread create → child start, and child end → ``join()`` return
  (:func:`install` hooks ``threading.Thread.start``/``join`` — covering
  ``threading.Timer`` arming, which is just ``Thread.start``);
- explicit hand-off channels (:func:`hb_send` / :func:`hb_recv`) where an
  object changes threads without a common lock: workqueue enqueue →
  worker pop, watch event delivery → handler dispatch, a group-committed
  transaction → its waiter.

Tracked memory cells (``sanitizer.track_state`` wraps the known shared
structures; each dict key is its own cell, plus one ``<keys>`` cell for
the key set) keep FastTrack epochs: the last write as a single
``(tid, clock)`` epoch, reads as an epoch that inflates to a full vector
clock only when concurrent readers appear. A write not ordered after the
previous write AND all previous reads — or a read not ordered after the
previous write — is a data race, reported with **both** stacks, bounded
and counted, never raised into product code (a detector that crashes the
code under test hides every later race; tests assert :func:`reports` /
:func:`report_summary`, and the sanitizer's pytest guard fails any test
that leaves one behind).

**Schedule fuzzer.** :class:`ScheduleFuzzer` perturbs thread
interleavings deterministically per seed, PCT-style: each thread gets a
seeded priority; at every cooperative preemption point (every
``TrackedLock.acquire`` and every ``faultpoints.maybe_fail``/``fires``
call) the fuzzer decides — as a pure function of ``(seed, point name,
per-point hit number)``, the ``faultpoints`` determinism contract —
whether the thread yields and for how long (scaled by its priority, so
low-priority threads consistently lag), with seeded priority-change
points sprinkled over the run. The decision log is a deterministic
function of the seed.

Activation: ``GPU_DRA_SANITIZE=race`` (see ``sanitizer``), or
:func:`enable` programmatically. Off (the default), every entry point is
one module-global read and a return.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Iterator, Optional

# -- bounds (bounded + counted, never silent) --------------------------------

MAX_REPORTS = 200          # distinct race reports kept (dupes only count)
MAX_CELLS = 200_000        # tracked memory cells; overflow stops tracking NEW
MAX_CHANNELS = 65_536      # hand-off channels; overflow evicts oldest (FIFO)
_STACK_DEPTH = 6           # frames captured per access for reports

_active = False            # THE flag every entry point reads first
_mu = threading.Lock()     # guards all detector state below (leaf lock:
                           # nothing is acquired while it is held)

_tls = threading.local()
_next_tid = [1]

_cells: dict = {}                      # cell key -> _Cell
_cells_dropped = [0]                   # accesses untracked after MAX_CELLS
_channels: "OrderedDict[Any, dict]" = OrderedDict()   # chan key -> VC
_channels_evicted = [0]

_reports: "OrderedDict[tuple, dict]" = OrderedDict()  # dedup key -> report
_reports_dropped = [0]

# Per-structure serials: cells are keyed (name, serial, key) so two
# INSTANCES of the same structure (every Checkpoint parse, every
# FakeClient's shards) never share cells — an access on one is not an
# ordering fact about the other. A monotonically increasing serial, not
# id(): CPython recycles ids, and a recycled id would graft a dead
# object's epochs onto a fresh one (phantom races).
_next_sid = [1]


def new_cell(name: str) -> tuple:
    """A fresh, never-reused cell identity for explicit
    note_read/note_write instrumentation (``sanitizer.note_*``)."""
    with _mu:
        sid = _next_sid[0]
        _next_sid[0] += 1
    return (name, sid)


def enable() -> None:
    global _active
    install()
    _active = True


def disable() -> None:
    global _active
    _active = False


def active() -> bool:
    return _active


# -- thread state ------------------------------------------------------------

class _ThreadState:
    __slots__ = ("tid", "vc")

    def __init__(self, tid: int):
        self.tid = tid
        self.vc: dict[int, int] = {tid: 1}

    def epoch(self) -> tuple[int, int]:
        return (self.tid, self.vc[self.tid])

    def tick(self) -> None:
        self.vc[self.tid] += 1


def _state() -> _ThreadState:
    st = getattr(_tls, "state", None)
    if st is None:
        with _mu:
            tid = _next_tid[0]
            _next_tid[0] += 1
        st = _tls.state = _ThreadState(tid)
        # A thread whose start() was hooked carries its creator's clock.
        seed_vc = getattr(threading.current_thread(),
                          "_gpu_race_start_vc", None)
        if seed_vc:
            _merge(st.vc, seed_vc)
    return st


def _merge(dst: dict, src: dict) -> None:
    for t, c in src.items():
        if c > dst.get(t, 0):
            dst[t] = c


def _hb(epoch: Optional[tuple], vc: dict) -> bool:
    """epoch happened-before (or equals) the point described by vc."""
    if epoch is None:
        return True
    t, c = epoch
    return c <= vc.get(t, 0)


def _stack() -> tuple:
    """A cheap stack snapshot: (file:line fn) for the innermost frames
    outside this module — no linecache, a few microseconds, captured on
    EVERY tracked access, so it must stay this light."""
    f = sys._getframe(1)
    out = []
    while f is not None and len(out) < _STACK_DEPTH:
        co = f.f_code
        if not co.co_filename.endswith(("racelab.py", "sanitizer.py")):
            name = co.co_filename.rsplit("/", 1)[-1]
            out.append(f"{name}:{f.f_lineno} {co.co_name}")
        f = f.f_back
    return tuple(out)


# -- cells (FastTrack epochs) ------------------------------------------------

class _Cell:
    __slots__ = ("wr", "wr_stack", "wr_tid",
                 "rd", "rd_vc", "rd_stack", "rd_tid")

    def __init__(self):
        self.wr: Optional[tuple] = None      # (tid, clk) last-write epoch
        self.wr_stack: tuple = ()
        self.wr_tid = 0
        self.rd: Optional[tuple] = None      # single-reader epoch, or
        self.rd_vc: Optional[dict] = None    # inflated concurrent-reader VC
        self.rd_stack: tuple = ()
        self.rd_tid = 0


def _cell(key: Any) -> Optional[_Cell]:
    """Caller holds ``_mu``."""
    c = _cells.get(key)
    if c is None:
        if len(_cells) >= MAX_CELLS:
            _cells_dropped[0] += 1
            return None
        c = _cells[key] = _Cell()
    return c


def _site_name(key: Any) -> str:
    """The structure NAME inside a cell key — the dedup granularity.
    Cell keys nest ``((name, sid), k)``: deduping on the full key (or the
    instance serial) would let ONE racy code-site pair looping over many
    keys/instances burn all MAX_REPORTS slots and silently drop every
    later DISTINCT race. One defect = one counted report."""
    while isinstance(key, tuple) and key:
        key = key[0]
    return str(key)


def _report(kind: str, key: Any, st: _ThreadState, cur_stack: tuple,
            prev_tid: int, prev_stack: tuple) -> None:
    """Caller holds ``_mu``. Dedup by (kind, structure name, both
    innermost frames) — the site pair; repeats only bump ``count``."""
    dk = (kind, _site_name(key), cur_stack[:1], prev_stack[:1])
    rep = _reports.get(dk)
    if rep is not None:
        rep["count"] += 1
        return
    if len(_reports) >= MAX_REPORTS:
        _reports_dropped[0] += 1
        return
    _reports[dk] = {
        "kind": kind,
        "cell": _render_cell(key),
        "count": 1,
        "current": {"tid": st.tid, "stack": list(cur_stack)},
        "previous": {"tid": prev_tid, "stack": list(prev_stack)},
    }


def _render_cell(key: Any) -> str:
    def flat(x: Any) -> Iterator[str]:
        if isinstance(x, tuple):
            for p in x:
                yield from flat(p)
        else:
            yield str(x)
    return "/".join(flat(key))


def on_write(key: Any) -> None:
    """One tracked write to cell ``key`` by the current thread."""
    if not _active:
        return
    st = _state()
    stack = _stack()
    with _mu:
        c = _cell(key)
        if c is None:
            return
        if not _hb(c.wr, st.vc):
            _report("write-write", key, st, stack, c.wr_tid, c.wr_stack)
        if c.rd_vc is not None:
            if any(clk > st.vc.get(t, 0) for t, clk in c.rd_vc.items()):
                _report("read-write", key, st, stack, c.rd_tid, c.rd_stack)
        elif not _hb(c.rd, st.vc):
            _report("read-write", key, st, stack, c.rd_tid, c.rd_stack)
        c.wr = st.epoch()
        c.wr_tid = st.tid
        c.wr_stack = stack
        # This write is ordered after everything recorded (or already
        # reported); later accesses race with the WRITE, not stale reads.
        c.rd = None
        c.rd_vc = None


def on_read(key: Any) -> None:
    """One tracked read of cell ``key`` by the current thread."""
    if not _active:
        return
    st = _state()
    stack = _stack()
    with _mu:
        c = _cell(key)
        if c is None:
            return
        if not _hb(c.wr, st.vc):
            _report("write-read", key, st, stack, c.wr_tid, c.wr_stack)
        if c.rd_vc is not None:
            c.rd_vc[st.tid] = st.vc[st.tid]
        elif c.rd is None or _hb(c.rd, st.vc):
            c.rd = st.epoch()               # same-epoch / ordered reader
        else:
            c.rd_vc = {c.rd[0]: c.rd[1], st.tid: st.vc[st.tid]}
        c.rd_tid = st.tid
        c.rd_stack = stack


# -- HB edges ----------------------------------------------------------------

def on_acquire(lock: Any) -> None:
    """TrackedLock hook: joining the lock's release clock orders this
    thread after everything done under previous critical sections."""
    if not _active:
        return
    st = _state()
    vc = getattr(lock, "_race_vc", None)
    if vc:
        with _mu:
            _merge(st.vc, vc)


def on_release(lock: Any) -> None:
    if not _active:
        return
    st = _state()
    with _mu:
        vc = getattr(lock, "_race_vc", None)
        if vc is None:
            vc = dict(st.vc)
            try:
                lock._race_vc = vc
            except AttributeError:
                return          # __slots__ lock without the attribute
        else:
            _merge(vc, st.vc)
        st.tick()


def hb_send(key: Any) -> None:
    """Publish the current thread's clock on channel ``key`` (release
    semantics: the sender's own clock then advances)."""
    if not _active:
        return
    st = _state()
    with _mu:
        vc = _channels.get(key)
        if vc is None:
            while len(_channels) >= MAX_CHANNELS:
                _channels.popitem(last=False)
                _channels_evicted[0] += 1
            vc = _channels[key] = {}
        else:
            _channels.move_to_end(key)
        _merge(vc, st.vc)
        st.tick()


def hb_recv(key: Any) -> None:
    """Join channel ``key``'s clock into the current thread (acquire
    semantics). Unknown channels are a no-op — an hb_recv with no prior
    hb_send establishes nothing, it does not invent an ordering."""
    if not _active:
        return
    st = _state()
    with _mu:
        vc = _channels.get(key)
        if vc:
            _merge(st.vc, vc)


# -- thread create/join hooks ------------------------------------------------

# The start/join that the hooks wrap: whatever the process had when they
# went on (another detector's hooks stay in the chain).
_next_start = threading.Thread.start
_next_join = threading.Thread.join


def _hooked_start(self: threading.Thread) -> None:
    if _active:
        st = _state()
        self._gpu_race_start_vc = dict(st.vc)
        st.tick()
        orig_run = self.run

        def run_with_edges() -> None:
            try:
                orig_run()
            finally:
                child = getattr(_tls, "state", None)
                if child is not None:
                    self._gpu_race_end_vc = dict(child.vc)

        self.run = run_with_edges
    _next_start(self)


def _hooked_join(self: threading.Thread,
                 timeout: Optional[float] = None) -> None:
    _next_join(self, timeout)
    if _active and not self.is_alive():
        end_vc = getattr(self, "_gpu_race_end_vc", None)
        if end_vc:
            st = _state()
            with _mu:
                _merge(st.vc, end_vc)


def install() -> None:
    """Put the Thread start/join hooks on top, over whatever start/join the
    process has now; a no-op while they are on top. The hooks check
    :func:`active` per call, so installing costs nothing while disabled.
    Called by every :func:`enable`, so hooks that another detector put
    over these are wrapped again rather than lost."""
    global _next_start, _next_join
    current = threading.Thread.start
    if current is _hooked_start or any(
            v is _hooked_start
            for v in (getattr(current, "__globals__", None) or {}).values()):
        return      # ours are on top, or the hooks on top already call ours
    _next_start = threading.Thread.start
    _next_join = threading.Thread.join
    threading.Thread.start = _hooked_start          # type: ignore[method-assign]
    threading.Thread.join = _hooked_join            # type: ignore[method-assign]


# -- reporting ---------------------------------------------------------------

def reports() -> list[dict]:
    with _mu:
        return [dict(r) for r in _reports.values()]


def report_summary() -> dict:
    with _mu:
        return {
            "races": len(_reports),
            "race_hits": sum(r["count"] for r in _reports.values()),
            "reports_dropped": _reports_dropped[0],
            "cells": len(_cells),
            "cells_dropped": _cells_dropped[0],
            "channels": len(_channels),
            "channels_evicted": _channels_evicted[0],
        }


def reset() -> None:
    """Clear cells, channels, and reports (test isolation). Thread clocks
    survive — they are identities, not findings — but every HB fact about
    tracked memory is dropped."""
    with _mu:
        _cells.clear()
        _cells_dropped[0] = 0
        _channels.clear()
        _channels_evicted[0] = 0
        _reports.clear()
        _reports_dropped[0] = 0


# -- schedule fuzzer ---------------------------------------------------------

class ScheduleFuzzer:
    """PCT-style cooperative schedule perturbation, seeded.

    Every decision is a pure function of ``(seed, point name, per-point
    hit number)`` — the ``faultpoints`` determinism contract — so the
    sorted decision log of two same-seed runs compares equal regardless
    of how threads interleaved *between* points. Per-thread priorities
    (seeded by racelab tid, which is creation-ordered) scale the yield
    duration: low-priority threads consistently lag, which is what
    flushes out code that only works in the creation-order interleaving.
    ``change_points`` hits reassign the deciding thread's priority
    mid-run, the PCT trick that bounds the number of priority inversions
    a bug needs.
    """

    def __init__(self, seed: int = 0, yield_rate: float = 0.25,
                 max_sleep_s: float = 0.002, reprio_rate: float = 0.02):
        self.seed = seed
        self.yield_rate = yield_rate
        self.max_sleep_s = max_sleep_s
        self.reprio_rate = reprio_rate
        self._mu = threading.Lock()
        self._hits: dict[str, int] = {}
        self._prio: dict[int, float] = {}
        self._log: list[tuple[str, int, str]] = []

    def _priority(self, tid: int) -> float:
        p = self._prio.get(tid)
        if p is None:
            p = self._prio[tid] = random.Random(
                f"{self.seed}:prio:{tid}").random()
        return p

    def preempt(self, name: str) -> None:
        with self._mu:
            n = self._hits.get(name, 0) + 1
            self._hits[name] = n
        rng = random.Random(f"{self.seed}:{name}:{n}")
        tid = _state().tid if _active else 0
        # Priority-change points keyed (seed, point, hit) — NOT a global
        # step counter, whose crossing thread would depend on the very
        # interleaving being fuzzed. Every log entry is a pure function
        # of the seed and the per-point hit number.
        if rng.random() < self.reprio_rate:
            with self._mu:
                self._prio[tid] = random.Random(
                    f"{self.seed}:reprio:{name}:{n}").random()
                self._log.append((name, n, "reprio"))
        if rng.random() >= self.yield_rate:
            return
        with self._mu:
            self._log.append((name, n, "yield"))
            prio = self._priority(tid)
        time.sleep((1.0 - prio) * self.max_sleep_s * rng.random())

    def log(self) -> list[tuple[str, int, str]]:
        """Every decision as (point, hit#, action), sorted — two same-seed
        runs compare equal even when threads interleaved differently
        between points (same contract as ``faultpoints.FaultPlan.log``)."""
        with self._mu:
            return sorted(self._log)


_fuzzer: Optional[ScheduleFuzzer] = None


def set_fuzzer(f: Optional[ScheduleFuzzer]) -> Optional[ScheduleFuzzer]:
    global _fuzzer
    prev = _fuzzer
    _fuzzer = f
    return prev


def current_fuzzer() -> Optional[ScheduleFuzzer]:
    return _fuzzer


def maybe_preempt(name: str) -> None:
    """The cooperative preemption point: one global read when no fuzzer
    is installed. Call sites: ``TrackedLock.acquire`` (sanitizer) and
    ``faultpoints.maybe_fail``/``fires``."""
    f = _fuzzer
    if f is not None:
        f.preempt(name)


class _FuzzCtx:
    def __init__(self, fuzzer: ScheduleFuzzer):
        self.fuzzer = fuzzer
        self._prev: Optional[ScheduleFuzzer] = None

    def __enter__(self) -> ScheduleFuzzer:
        self._prev = set_fuzzer(self.fuzzer)
        return self.fuzzer

    def __exit__(self, *exc: object) -> None:
        set_fuzzer(self._prev)


def fuzz(seed: int = 0, **kw: Any) -> _FuzzCtx:
    """``with racelab.fuzz(seed=7): ...`` — install a seeded fuzzer for
    the block, restoring whatever was installed before."""
    return _FuzzCtx(ScheduleFuzzer(seed=seed, **kw))


# -- tracked structures ------------------------------------------------------

_KEYS = "<keys>"


class TrackedDict(dict):
    """A dict whose accesses feed the detector; optionally also enforces
    the ``GuardedDict`` contract (mutations must hold ``guard``).

    Cell granularity: each key is its own cell, and the key *set* is one
    more (``<keys>``) — two threads writing different existing keys do
    not conflict structurally, while an insert racing an iteration does.
    """

    def __init__(self, name: str, initial: Optional[dict] = None,
                 guard: Any = None, on_unguarded: Any = None):
        super().__init__(initial or {})
        self._race_name = new_cell(name)
        self._race_guard = guard
        self._race_on_unguarded = on_unguarded

    # -- helpers --

    def _wcell(self, k: Any, structural: bool) -> None:
        if self._race_guard is not None and self._race_on_unguarded \
                is not None and not self._race_guard.held_by_current_thread():
            self._race_on_unguarded(self._race_name[0])
        on_write((self._race_name, k))
        if structural:
            on_write((self._race_name, _KEYS))

    def _rcell(self, k: Any) -> None:
        on_read((self._race_name, k))

    # -- mutations --

    def __setitem__(self, k: Any, v: Any) -> None:
        self._wcell(k, structural=not dict.__contains__(self, k))
        super().__setitem__(k, v)

    def __delitem__(self, k: Any) -> None:
        self._wcell(k, structural=True)
        super().__delitem__(k)

    def pop(self, *a: Any, **kw: Any) -> Any:
        if a:
            self._wcell(a[0], structural=True)
        return super().pop(*a, **kw)

    def popitem(self) -> Any:
        kv = super().popitem()
        self._wcell(kv[0], structural=True)
        return kv

    def clear(self) -> None:
        self._wcell(_KEYS, structural=True)
        super().clear()

    def update(self, *a: Any, **kw: Any) -> None:
        incoming = dict(*a, **kw)
        for k in incoming:
            self._wcell(k, structural=not dict.__contains__(self, k))
        super().update(incoming)

    def setdefault(self, k: Any, default: Any = None) -> Any:
        if dict.__contains__(self, k):
            self._rcell(k)
            return self[k]
        self._wcell(k, structural=True)
        return super().setdefault(k, default)

    # -- reads --

    def __getitem__(self, k: Any) -> Any:
        self._rcell(k)
        return super().__getitem__(k)

    def get(self, k: Any, default: Any = None) -> Any:
        self._rcell(k)
        return super().get(k, default)

    def __contains__(self, k: Any) -> bool:
        self._rcell(k)
        return super().__contains__(k)

    def __iter__(self) -> Iterator:
        on_read((self._race_name, _KEYS))
        return super().__iter__()

    def __len__(self) -> int:
        on_read((self._race_name, _KEYS))
        return super().__len__()

    def keys(self):  # noqa: D102
        on_read((self._race_name, _KEYS))
        return super().keys()

    def values(self):  # noqa: D102
        on_read((self._race_name, _KEYS))
        return super().values()

    def items(self):  # noqa: D102
        on_read((self._race_name, _KEYS))
        return super().items()


class TrackedSet(set):
    """A set whose accesses feed the detector (per-element cells plus the
    structural ``<keys>`` cell)."""

    def __init__(self, name: str, initial: Any = ()):
        super().__init__(initial)
        self._race_name = new_cell(name)

    def add(self, v: Any) -> None:
        on_write((self._race_name, v))
        if not set.__contains__(self, v):
            on_write((self._race_name, _KEYS))
        super().add(v)

    def discard(self, v: Any) -> None:
        on_write((self._race_name, v))
        on_write((self._race_name, _KEYS))
        super().discard(v)

    def remove(self, v: Any) -> None:
        on_write((self._race_name, v))
        on_write((self._race_name, _KEYS))
        super().remove(v)

    def pop(self) -> Any:
        on_write((self._race_name, _KEYS))
        return super().pop()

    def clear(self) -> None:
        on_write((self._race_name, _KEYS))
        super().clear()

    def __contains__(self, v: Any) -> bool:
        on_read((self._race_name, v))
        return super().__contains__(v)

    def __iter__(self) -> Iterator:
        on_read((self._race_name, _KEYS))
        return super().__iter__()

    def __len__(self) -> int:
        on_read((self._race_name, _KEYS))
        return super().__len__()
