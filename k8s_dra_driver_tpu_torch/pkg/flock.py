"""File-based lock with poll/timeout/cancel.

Analogue of the reference's ``pkg/flock`` (``flock.go:25-136``): protects
prepare/unprepare and checkpoint read-mutate-write across *processes* (more
than one driver pod may run on a node, but at most one RMW may execute at a
time). Uses non-blocking ``flock(2)`` with polling — same trade-off as the
reference: no signal games to cancel a blocking flock, at the cost of up to
one poll period of acquisition latency after a release. The kernel releases
the lock when the process dies (its fds close), including on crash.

Hot-path shape: one ``Flock`` instance keeps its lock-file fd OPEN for its
lifetime and serializes same-instance acquirers on an internal mutex
(``flock(2)`` is per open-file-description, so two threads sharing the fd
would not exclude each other without it). Acquire/release are then a single
``flock`` syscall each instead of mkdir+open+flock+close per cycle — on a
network filesystem that is the difference between one round-trip and four
on every checkpoint commit.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import threading
import time
from typing import Callable, Iterator, Optional

from k8s_dra_driver_tpu_torch.pkg import sanitizer


class FlockTimeout(TimeoutError):
    pass


class Flock:
    def __init__(self, path: str):
        self.path = path
        # In-process exclusion between threads of THIS instance (they share
        # one open-file-description, invisible to each other via flock).
        self._mu = sanitizer.new_lock("Flock._mu")
        self._fd: Optional[int] = None
        self._fd_mu = sanitizer.new_lock("Flock._fd_mu")

    def _ensure_fd(self) -> int:
        with self._fd_mu:
            if self._fd is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fd = os.open(self.path, os.O_RDWR | os.O_CREAT, 0o644)
            return self._fd

    def acquire(
        self,
        timeout: float = 0.0,
        poll_period: float = 0.1,
        cancel: Optional[threading.Event] = None,
    ) -> Callable[[], None]:
        """Acquire the exclusive lock; returns a release callable.

        ``timeout`` <= 0 disables the deadline. ``cancel`` (optional Event)
        aborts the wait early — the ctx-cancellation analogue.
        """
        t0 = time.monotonic()

        def wait_or_give_up(release_mu: bool) -> None:
            """One poll step; raises when out of budget."""
            if timeout > 0 and time.monotonic() - t0 > timeout:
                if release_mu:
                    self._mu.release()
                raise FlockTimeout(f"timeout acquiring lock ({self.path})")
            if cancel is not None and cancel.is_set():
                if release_mu:
                    self._mu.release()
                raise InterruptedError(f"canceled acquiring lock ({self.path})")
            time.sleep(poll_period)

        while not self._mu.acquire(blocking=False):
            wait_or_give_up(release_mu=False)
        try:
            fd = self._ensure_fd()
        except BaseException:
            # An open/mkdir failure must not leave _mu held — that would
            # wedge this instance (every later acquire times out) for a
            # transient filesystem error the caller retries through.
            self._mu.release()
            raise
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                pass
            except OSError:
                self._mu.release()
                raise
            wait_or_give_up(release_mu=True)

        def release() -> None:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                self._mu.release()

        return release

    @contextlib.contextmanager
    def held(self, timeout: float = 0.0, poll_period: float = 0.1) -> Iterator[None]:
        release = self.acquire(timeout=timeout, poll_period=poll_period)
        try:
            yield
        finally:
            release()
