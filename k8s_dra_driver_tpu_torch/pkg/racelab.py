"""Happens-before hooks of the race detector, in their off state.

The JAX package's ``pkg/racelab.py`` is a vector-clock race detector that
its sanitizer's race mode turns on. This package keeps only the hooks its
modules call — cell identities, hand-off edges and the schedule fuzzer's
preemption point — and none of them records anything: the detector, its
reports and the fuzzer are not part of this package.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any

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


def maybe_preempt(name: str) -> None:
    """The schedule fuzzer's preemption point: a no-op without a fuzzer."""
