"""Happens-before hooks of the race detector, and the schedule fuzzer.

The JAX package's ``pkg/racelab.py`` is a vector-clock race detector that
its sanitizer's race mode turns on. This package keeps the hooks its
modules call — cell identities and hand-off edges, which record nothing:
the detector and its reports are not part of this package — and the
seeded schedule fuzzer (:func:`fuzz`), whose preemption point is every
``faultpoints.maybe_fail``/``fires`` call.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Any, Optional

_serials = itertools.count(1)
_mu = threading.Lock()


def new_cell(name: str) -> tuple:
    """A fresh, never-reused cell identity (a serial, not ``id()``, so a
    recycled address can never alias two cells)."""
    with _mu:
        return (name, next(_serials))


def hb_send(key: Any) -> None:
    """Release edge on channel ``key``: a no-op without the detector."""


def hb_recv(key: Any) -> None:
    """Acquire edge on channel ``key``: a no-op without the detector."""


def on_read(key: Any) -> None:
    """Read of cell ``key``: a no-op without the detector."""


def on_write(key: Any) -> None:
    """Write of cell ``key``: a no-op without the detector."""


#: Share of preemption points that draw a fresh thread priority.
REPRIO_RATE = 0.02


class ScheduleFuzzer:
    """PCT-style cooperative schedule perturbation, seeded.

    Every decision is a pure function of ``(seed, point name, per-point
    hit number)`` — the ``faultpoints`` determinism contract — whatever
    the threads do between points. Without the detector every thread
    shares one seeded priority (the JAX fuzzer's behaviour with the
    detector off), which scales the yield duration; a ``REPRIO_RATE``
    share of hits reassign it mid-run.
    """

    def __init__(self, seed: int = 0, yield_rate: float = 0.25,
                 max_sleep_s: float = 0.002):
        self.seed = seed
        self.yield_rate = yield_rate
        self.max_sleep_s = max_sleep_s
        self._mu = threading.Lock()
        self._hits: dict[str, int] = {}
        self._prio: Optional[float] = None

    def _priority(self) -> float:
        if self._prio is None:
            self._prio = random.Random(f"{self.seed}:prio:0").random()
        return self._prio

    def preempt(self, name: str) -> None:
        with self._mu:
            n = self._hits.get(name, 0) + 1
            self._hits[name] = n
        rng = random.Random(f"{self.seed}:{name}:{n}")
        if rng.random() < REPRIO_RATE:
            with self._mu:
                self._prio = random.Random(
                    f"{self.seed}:reprio:{name}:{n}").random()
        if rng.random() >= self.yield_rate:
            return
        with self._mu:
            prio = self._priority()
        time.sleep((1.0 - prio) * self.max_sleep_s * rng.random())


_fuzzer: Optional[ScheduleFuzzer] = None


def set_fuzzer(f: Optional[ScheduleFuzzer]) -> Optional[ScheduleFuzzer]:
    global _fuzzer
    prev = _fuzzer
    _fuzzer = f
    return prev


def maybe_preempt(name: str) -> None:
    """The cooperative preemption point: one global read when no fuzzer
    is installed."""
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
