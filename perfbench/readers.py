"""The arithmetic of the metric readers (``perfbench/metrics/<name>.py``).

Each function takes a ``record.Run`` and returns the metric's value, or
None where the run holds nothing to read (a reader never returns 0 for a
share it could not measure).
"""

from __future__ import annotations

from typing import Optional


def decode_tok_s(run) -> Optional[float]:
    """Decode tokens the engine committed in the window over its seconds."""
    return run.counters["decode_tokens"] / run.window_s


def step_ms(run) -> Optional[float]:
    """The window's seconds over the engine steps taken in it."""
    steps = run.counters["steps"]
    return run.window_s / steps * 1e3 if steps else None


def decode_attn_roofline(run) -> Optional[float]:
    """The least time of the traced sub-window's decode calls over their
    kernels' device time, in percent."""
    t = run.trace
    if t is None or t.attn_us <= 0:
        return None
    return 100.0 * t.attn_least_s / (t.attn_us / 1e6)


def device_idle_pct(run) -> Optional[float]:
    """The share of the traced sub-window in which no device operation ran,
    in percent."""
    t = run.trace
    if t is None or t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)


def step_mfu(run) -> Optional[float]:
    """The least time of the traced sub-window's decode calls over the
    sub-window's wall time, in percent: the whole step's share of the
    device's roofline."""
    t = run.trace
    if t is None or t.attn_calls == 0:
        return None
    return 100.0 * t.attn_least_s / (t.window_us / 1e6)
