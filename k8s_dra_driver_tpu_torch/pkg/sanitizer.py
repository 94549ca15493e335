"""Lock and shared-state constructors, in the sanitizer's off state.

The JAX package's ``pkg/sanitizer.py`` can wrap every lock and shared
structure for lock-order and race checking (``TPU_DRA_SANITIZE``); off, its
constructors return plain objects, which is all this package does: the
copied modules build their locks and shared maps through these names so
that a checked mode can be added here without touching them.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from k8s_dra_driver_tpu_torch.pkg import racelab


def new_lock(name: str, reentrant: bool = False):
    """A plain ``threading.Lock`` (``RLock`` when ``reentrant``)."""
    return threading.RLock() if reentrant else threading.Lock()


def guarded_dict(lock: Any, name: str, initial: Optional[dict] = None) -> dict:
    """A plain dict, meant to be mutated only under ``lock``."""
    return dict(initial or {})


def track_state(obj: Any, name: str) -> Any:
    """``obj`` itself: shared-state tracking is off."""
    return obj


def new_cell(name: str) -> Any:
    return racelab.new_cell(name)


def note_read(cell: Any) -> None:
    racelab.on_read(cell)


def note_write(cell: Any) -> None:
    racelab.on_write(cell)
