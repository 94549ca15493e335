"""Shared process-assembly contract for every binary.

The counterpart of the JAX package's ``pkg/process.py``. The reference
gives each binary one ``RunPlugin``-shaped entrypoint that assembles
components and tears them down in reverse order on SIGTERM
(``cmd/gpu-kubelet-plugin/main.go:236-359``). Every binary here follows the
same contract: ``run_*(args, block=True) -> ProcessHandle``, where
``block=True`` (production) waits for SIGTERM/SIGINT and stops everything
before returning, and ``block=False`` (tests / embedding) returns the
running handle — the caller owns ``handle.stop()``.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Callable

logger = logging.getLogger(__name__)

#: How long the main thread of a blocked ``run_*`` waits at a time before
#: it runs any signal handler another thread's signal left pending.
SIGNAL_POLL_S = 0.2


class ProcessHandle:
    """Everything a ``run_*`` entrypoint started. The main registers each
    component's stop callback in start order via ``on_stop``; ``stop()``
    invokes them in reverse, so shutdown is the exact reverse of start
    order for every binary regardless of which components it has.

    Keyword arguments become attributes (``handle.driver``,
    ``handle.servers``, …) so tests can reach the parts.
    """

    def __init__(self, binary: str, **parts: object):
        self.binary = binary
        self._stops: list[Callable[[], None]] = []
        for name, part in parts.items():
            setattr(self, name, part)

    def on_stop(self, fn: Callable[[], None]) -> None:
        """Register a stop callback; call in component start order."""
        self._stops.append(fn)

    def stop(self) -> None:
        for fn in reversed(self._stops):
            fn()
        logger.info("%s stopped", self.binary)


def block_until_signaled(handle: ProcessHandle, ready: str = "") -> None:
    """Production tail of every ``run_*``: park until SIGTERM/SIGINT,
    then stop the handle (main.go:300-359 signal flow). ``ready`` is
    logged once the handlers are installed, so a caller that waits for
    that line before it sends SIGTERM always reaches the handler; a signal
    that comes earlier, during assembly, takes the default action (the
    process dies with -15), as in the JAX package.

    The main thread waits in slices of SIGNAL_POLL_S, not at once: Python
    runs a signal's handler only in the main thread, between bytecodes,
    and the kernel may deliver SIGTERM to any thread of the process. An
    untimed wait is woken only by a signal delivered to the main thread
    itself, so a SIGTERM taken by one of the binary's other threads left
    it parked for good (a controller process under CPU load, a few runs in
    a hundred)."""
    stop_evt = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop_evt.set())
    signal.signal(signal.SIGINT, lambda *a: stop_evt.set())
    if ready:
        logger.info("%s", ready)
    while not stop_evt.wait(SIGNAL_POLL_S):
        pass
    handle.stop()
