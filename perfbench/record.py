"""What a run leaves for the metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from perfbench.roofline import TraceSummary


@dataclass
class Sent:
    """One request the harness submitted: the engine's request object
    (which the engine fills in: ``admit_t``, ``first_token_t``,
    ``done_t``, ``generated``, ``outcome``, on the engine's monotonic
    clock), when it was due and submitted, whether it was due in the
    window, and whether the engine refused it."""
    req: object
    due_t: float
    submit_t: float
    in_window: bool
    rejected: bool = False

    @property
    def completed(self) -> bool:
        return getattr(self.req, "outcome", None) == "completed"


@dataclass
class Run:
    """One run of a cell, as the readers see it. Times are monotonic
    seconds; ``t0`` is the first due request of the window, ``t_end`` its
    close, ``grace_end`` the moment the harness stopped waiting for the
    window's requests. ``counters`` holds the engine counters' growth over
    the window (``steps``, ``decode_steps``, ``decode_tokens``,
    ``prefill_tokens``)."""
    cell: dict
    config: dict
    mix: dict
    seed: int
    setup_s: float
    claim_ready_ms: float
    t0: float
    t_end: float
    grace_end: float
    counters: Dict[str, int]
    sent: List[Sent] = field(default_factory=list)
    trace: Optional[TraceSummary] = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    @property
    def window_sent(self) -> List[Sent]:
        """The requests due in the window."""
        return [s for s in self.sent if s.in_window]
