"""faultlab: deterministic, seed-driven fault injection.

The driver's whole contract is surviving the failures Kubernetes assumes
will happen — kubelet plugin restarts, API-server blips, watch-stream
drops, devices going unhealthy mid-prepare. The reference proves its
recovery paths with a dedicated stress tier
(``tests/bats/test_gpu_stress.bats``); this module is the injection half
of this repo's analogue: a process-global registry of *named fault
points* that production code threads through with one call::

    faultpoints.maybe_fail("k8sclient.http.get")

With no plan active (the default), that call is a read of one
module-level variable and an immediate return — zero overhead on every
production path. With a plan active, the point's *schedule* decides per
hit whether to raise an injected error, sleep (latency), or raise
:class:`FaultCrash` (simulated process death — a ``BaseException`` so the
driver's own ``except Exception`` recovery code cannot swallow it, just
as it could not catch a real SIGKILL).

Determinism: every decision is a pure function of ``(seed, point name,
hit number)`` — per-point hit counters plus a hash-seeded RNG per hit —
so the same ``GPU_DRA_FAULTS`` string replays the same injection
sequence regardless of thread interleaving between *different* points.
:func:`injection_log` returns what fired for test assertions and for
reproducing a chaos failure from its seed (docs/fault-injection.md).

Schedule syntax (also the ``GPU_DRA_FAULTS`` env var format)::

    seed=42;<point>=<mode>:<arg>[:<kind>];<point2>=...

Modes:

- ``nth:N``        fire on exactly the Nth hit (1-based), once
- ``first:N``      fire on hits 1..N
- ``every:N``      fire on every Nth hit
- ``rate:P``       fire with probability P per hit (seed-deterministic)
- ``latency:S``    sleep S seconds on every hit (never raises)
- ``crash-nth:N``  raise :class:`FaultCrash` on the Nth hit

``kind`` selects one of the error factories the point was registered
with (e.g. ``conflict`` on the API verbs); omitted → the point's default
error, falling back to :class:`InjectedFault`.

Registration: call sites register their point names at import time with
a string literal (``FP_X = register("layer.op", "what it fails")``) so
the driverlint DL205 invariant can statically enumerate the catalog and
demand that every point is documented in docs/fault-injection.md and
exercised by at least one test.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from k8s_dra_driver_tpu_torch.pkg import racelab, tracing
from k8s_dra_driver_tpu_torch.pkg.errors import PermanentError

logger = logging.getLogger(__name__)

ENV_FAULTS = "GPU_DRA_FAULTS"

_MODES = ("nth", "first", "every", "rate", "latency", "crash-nth")


class InjectedFault(RuntimeError):
    """The default (retryable) error a firing fault point raises."""


class FaultCrash(BaseException):
    """Simulated process death at a crash point.

    Deliberately a ``BaseException``: recovery code under test catches
    ``Exception`` (workqueue retries, daemon keep-alive loops), and a
    simulated crash must tear through all of it exactly like a SIGKILL —
    only the test harness (the "supervisor") catches it.
    """


class FaultSpecError(PermanentError, ValueError):
    """Malformed ``GPU_DRA_FAULTS`` / schedule spec string.

    Also a :class:`PermanentError`: when a config mistake is only
    detectable at injection time (an unknown error kind for a point whose
    registration happens after env activation), the raise lands inside
    driver code — marking it permanent keeps the retry machinery under
    test from swallowing the operator's typo as a transient failure."""


@dataclass
class _Point:
    name: str
    description: str
    errors: dict[str, Callable[[str], BaseException]] = field(
        default_factory=dict)
    default_error: str = ""


_registry: dict[str, _Point] = {}
_registry_mu = threading.Lock()  # leaf lock; plain on purpose — new_lock
# would recurse through sanitizer at import and the registry is touched
# from maybe_fail's hot error path


def register(name: str, description: str,
             errors: Optional[dict[str, Callable[[str], BaseException]]] = None,
             default_error: str = "") -> str:
    """Declare a fault point. Idempotent per name (later registrations
    merge error factories); returns ``name`` so call sites can bind it to
    a module constant. ``errors`` maps kind → factory taking the message.
    """
    with _registry_mu:
        point = _registry.get(name)
        if point is None:
            point = _Point(name, description)
            _registry[name] = point
        if errors:
            point.errors.update(errors)
        if default_error:
            point.default_error = default_error
    return name


def registered() -> dict[str, str]:
    """Point name → description, for docs/DL205 and introspection."""
    with _registry_mu:
        return {n: p.description for n, p in sorted(_registry.items())}


# -- schedules ---------------------------------------------------------------

@dataclass
class _Schedule:
    point: str
    mode: str
    arg: float
    kind: str = ""

    def decision(self, seed: int, hit: int) -> Optional[str]:
        """What to do on ``hit`` (1-based): None | 'fail' | 'sleep' |
        'crash'. Pure in (seed, point, hit) — thread-interleaving between
        points cannot change any point's own sequence."""
        if self.mode == "nth":
            return "fail" if hit == int(self.arg) else None
        if self.mode == "first":
            return "fail" if hit <= int(self.arg) else None
        if self.mode == "every":
            n = int(self.arg)
            return "fail" if n > 0 and hit % n == 0 else None
        if self.mode == "rate":
            rng = random.Random(f"{seed}:{self.point}:{hit}")
            return "fail" if rng.random() < self.arg else None
        if self.mode == "latency":
            return "sleep"
        if self.mode == "crash-nth":
            return "crash" if hit == int(self.arg) else None
        return None


def _parse_schedule(point: str, spec: str) -> _Schedule:
    parts = spec.split(":")
    if not parts or parts[0] not in _MODES:
        raise FaultSpecError(
            f"fault point {point!r}: unknown mode {parts[0]!r} "
            f"(known: {', '.join(_MODES)})")
    mode = parts[0]
    if len(parts) < 2:
        raise FaultSpecError(f"fault point {point!r}: mode {mode} needs an "
                             f"argument (e.g. {mode}:3)")
    try:
        arg = float(parts[1])
    except ValueError as e:
        raise FaultSpecError(
            f"fault point {point!r}: bad argument {parts[1]!r}") from e
    if arg < 0:
        raise FaultSpecError(f"fault point {point!r}: negative argument")
    if mode in ("nth", "first", "every", "crash-nth") and (
            arg != int(arg) or arg < 1):
        # Hits are 1-based; a count of 0 (or a fraction) would parse fine
        # and then never fire — a schedule that silently injects nothing.
        raise FaultSpecError(
            f"fault point {point!r}: {mode} needs an integer hit count "
            f">= 1, got {parts[1]!r}")
    if mode == "rate" and arg > 1:
        raise FaultSpecError(
            f"fault point {point!r}: rate must be a probability in [0, 1], "
            f"got {parts[1]!r}")
    kind = parts[2] if len(parts) > 2 else ""
    return _Schedule(point=point, mode=mode, arg=arg, kind=kind)


class FaultPlan:
    """A parsed fault schedule: per-point schedules + the seed.

    Build from a spec string (the ``GPU_DRA_FAULTS`` format) or
    programmatically via :meth:`add`. One plan instance carries the hit
    counters and the injection log, so a fresh plan replays from hit 1.
    """

    def __init__(self, spec: str = "", seed: int = 0):
        self.seed = seed
        self.schedules: dict[str, _Schedule] = {}
        self._mu = threading.Lock()  # plain on purpose, like _registry_mu:
        # maybe_fail IS the fuzzer's preemption point — a TrackedLock here
        # would make every hit-counter update a preemption point of its
        # own (recursion through racelab) and skew every latency schedule
        self._hits: dict[str, int] = {}
        self._log: list[tuple[str, int, str]] = []
        for clause in (spec or "").split(";"):
            clause = clause.strip()
            if not clause:
                continue
            key, _, val = clause.partition("=")
            key = key.strip()
            val = val.strip()
            if not val:
                raise FaultSpecError(f"malformed clause {clause!r} "
                                     "(want point=mode:arg or seed=N)")
            if key == "seed":
                try:
                    self.seed = int(val)
                except ValueError:
                    raise FaultSpecError(
                        f"seed must be an integer, got {val!r}") from None
                continue
            self.schedules[key] = _parse_schedule(key, val)

    def add(self, point: str, spec: str) -> "FaultPlan":
        self.schedules[point] = _parse_schedule(point, spec)
        return self

    def hit(self, name: str) -> tuple[Optional[str], _Schedule, int]:
        """Record one hit on ``name``; returns (decision, schedule, hit#)."""
        sched = self.schedules.get(name)
        if sched is None:
            return None, None, 0  # type: ignore[return-value]
        with self._mu:
            n = self._hits.get(name, 0) + 1
            self._hits[name] = n
        decision = sched.decision(self.seed, n)
        if decision is not None:
            with self._mu:
                self._log.append((name, n, decision))
        return decision, sched, n

    def log(self) -> list[tuple[str, int, str]]:
        """Everything that fired, as (point, hit#, action). Sorted by
        (point, hit#) so two runs of the same seed compare equal even when
        different points interleaved differently across threads."""
        with self._mu:
            return sorted(self._log)

    def hits(self) -> dict[str, int]:
        """Per-point hit counters for every SCHEDULED point, fired or
        not. The crashlab explorer's site-enumeration probe: schedule a
        never-firing ``nth`` on each crash-capable point, run the
        scenario, and the counters ARE the crash-site list — a pure
        function of the code path, no wall clock (pkg/crashlab.py)."""
        with self._mu:
            return dict(sorted(self._hits.items()))


# -- activation --------------------------------------------------------------

# THE single module-level flag the zero-overhead contract hangs on:
# maybe_fail()/fires() read this once and return immediately when None.
_active: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _active


def activate(plan: FaultPlan) -> FaultPlan:
    """Install ``plan``. Error kinds are validated against every point
    already registered — a typo'd kind fails HERE, not mid-injection.
    Points not yet registered (env activation runs at faultpoints import,
    before the registering modules load) are validated lazily at first
    hit instead (:func:`_raise_for`)."""
    global _active
    with _registry_mu:
        for name, sched in plan.schedules.items():
            point = _registry.get(name)
            if (point is not None and sched.kind
                    and sched.kind not in point.errors):
                raise FaultSpecError(
                    f"fault point {name!r} has no registered error kind "
                    f"{sched.kind!r} (known: {sorted(point.errors)})")
    if plan.schedules:
        logger.info("faultpoints: activating plan (seed=%d, points=%s)",
                    plan.seed, sorted(plan.schedules))
    _active = plan
    return plan


def deactivate() -> None:
    global _active
    _active = None


class _InjectedCtx:
    """Context manager returned by :func:`injected` — also usable as a
    plain object carrying the plan for log assertions. Restores whatever
    plan was active on entry (instead of blindly deactivating), so a
    nested/overlapping ``injected()`` cannot silently leave the rest of
    an outer block running with no injection at all."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self._prev = active_plan()
        activate(self.plan)
        return self.plan

    def __exit__(self, *exc: object) -> None:
        if self._prev is not None:
            activate(self._prev)
        else:
            deactivate()


def injected(spec: str = "", seed: int = 0,
             plan: Optional[FaultPlan] = None) -> _InjectedCtx:
    """``with faultpoints.injected("cdi.write=nth:1") as plan: ...``"""
    return _InjectedCtx(plan if plan is not None else FaultPlan(spec, seed))


def injection_log() -> list[tuple[str, int, str]]:
    plan = _active
    return plan.log() if plan is not None else []


def configure_from_env(environ: Optional[dict] = None) -> bool:
    """Activate a plan from ``GPU_DRA_FAULTS`` when set (real processes:
    the env var is the only injection surface). Returns whether a plan
    was activated."""
    env = os.environ if environ is None else environ
    spec = env.get(ENV_FAULTS, "").strip()
    if not spec:
        return False
    activate(FaultPlan(spec))
    return True


# -- the injection surface ---------------------------------------------------

def is_injected(err: BaseException) -> bool:
    """Whether ``err`` (or anything on its cause/context chain) was raised
    by a fault point. Chaos harnesses use this to separate scheduled
    failures from real bugs — errors merely *similar* to injected ones
    (a genuine timeout, a genuine conflict) do not qualify."""
    seen: set[int] = set()
    cur: Optional[BaseException] = err
    while cur is not None and id(cur) not in seen:
        if getattr(cur, "_gpu_dra_injected", False):
            return True
        seen.add(id(cur))
        cur = cur.__cause__ or cur.__context__
    return False


def _raise_for(sched: _Schedule, name: str, hit: int) -> None:
    with _registry_mu:
        point = _registry.get(name)
    msg = f"injected fault at {name} (hit {hit}, mode {sched.mode})"
    kind = sched.kind or (point.default_error if point else "")
    if kind and (point is None or kind not in point.errors):
        raise FaultSpecError(
            f"fault point {name!r} has no registered error kind {kind!r}")
    err = point.errors[kind](msg) if kind else InjectedFault(msg)
    # Provenance marker for is_injected(): survives wrapping via
    # raise-from because the walk follows the cause/context chain.
    err._gpu_dra_injected = True  # type: ignore[attr-defined]
    raise err


def maybe_fail(name: str) -> None:
    """The fault point. No-op unless a plan schedules ``name``; otherwise
    raises the scheduled error / :class:`FaultCrash`, or sleeps (latency).
    """
    # Cooperative preemption point for the schedule fuzzer (race mode):
    # every fault point is also a place the real system can interleave.
    racelab.maybe_preempt(name)
    plan = _active
    if plan is None:
        return
    decision, sched, hit = plan.hit(name)
    if decision is None:
        return
    # Chaos traces are self-explaining: the firing decision is recorded on
    # the thread's active span BEFORE its effect lands (docs/observability.md).
    tracing.annotate_fault(name, hit, decision)
    if decision == "sleep":
        time.sleep(sched.arg)
        return
    if decision == "crash":
        raise FaultCrash(f"injected crash at {name} (hit {hit})")
    _raise_for(sched, name, hit)


def fires(name: str) -> bool:
    """Boolean variant for value-altering injections (a chip vanishing
    from an enumeration, a watch stream dropping): returns whether the
    schedule fired instead of raising. Latency schedules still sleep,
    and crash schedules still raise :class:`FaultCrash` — a crash-here
    request must mean process death at this site, not a quiet value
    alteration."""
    racelab.maybe_preempt(name)
    plan = _active
    if plan is None:
        return False
    decision, sched, hit = plan.hit(name)
    if decision is None:
        return False
    tracing.annotate_fault(name, hit, decision)
    if decision == "sleep":
        time.sleep(sched.arg)
        return False
    if decision == "crash":
        raise FaultCrash(f"injected crash at {name} (hit {hit})")
    return True


def iter_points() -> Iterator[tuple[str, str]]:
    yield from registered().items()


def _reset_for_tests() -> None:
    """Drop the active plan (NOT the registry — registration is
    import-time and global by design)."""
    deactivate()


# Real processes opt in via the environment; in-process tests use
# injected()/activate() directly.
configure_from_env()
