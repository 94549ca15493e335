"""Operations, bytes and the least time of decode attention; the reduction
of a device trace to busy time, kernel time and roofline shares.

Bytes count each input byte once and each output byte once, whatever a
kernel reads again: for each slot b of a call, its ``lens[b]`` valid K and
V rows (``lens`` clamped to 1..cap, as the engine passes them), q and the
output, and the lengths. Operations are the two products, ``2 h ql L d``
for q K^T and ``2 h ql L dv`` for P V, summed over the slots; the softmax
is not counted. The least time is the larger of bytes over the peak bytes
per second and operations over the peak rate of the cache's dtype.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"

#: Device kernels whose name matches this are decode attention's: the
#: port's decode kernels (``decode_ring_kernel``, ``stream_decode_kernel``,
#: the wide and f32 decode kernels and their merges) and any attention
#: kernel a later program calls from the same place.
ATTN_KERNEL = re.compile(r"decode|attn|attention", re.IGNORECASE)


def peaks(device_name: str) -> Optional[dict]:
    """The peaks of the device whose name contains a key of
    ``peaks.json``; None for a device the table does not hold."""
    table = json.loads(PEAKS_FILE.read_text())["devices"]
    for key, row in table.items():
        if key in device_name:
            return row
    return None


def decode_bytes(lens: Sequence[int], h: int, ql: int, d: int, dv: int,
                 k_size: int, v_size: int, q_size: int) -> int:
    """Bytes one decode call needs: each valid K and V row once, q and the
    output once, and the int32 lengths."""
    keys = sum(lens)
    b = len(lens)
    return (keys * h * (d * k_size + dv * v_size)
            + b * h * ql * (d + dv) * q_size + 4 * b)


def decode_flops(lens: Sequence[int], h: int, ql: int, d: int,
                 dv: int) -> int:
    """Operations of one decode call: q K^T and P V over the valid keys."""
    return 2 * h * ql * sum(lens) * (d + dv)


def least_seconds(nbytes: float, flops: float, peak: dict,
                  dtype: str) -> float:
    """The least time the device needs: bytes at its bandwidth or
    operations at its rate for ``dtype``, whichever is longer."""
    return max(nbytes / peak["hbm_bytes_per_s"],
               flops / peak["flops_per_s"][dtype])


@dataclass
class DeviceOp:
    """One kernel, copy or fill the device ran, in the trace's microseconds."""
    name: str
    start_us: float
    end_us: float


@dataclass
class Call:
    """One decode-attention call: when the host made it (in the trace's
    microseconds) and the least time its work needs."""
    t_us: float
    least_s: float


@dataclass
class TraceSummary:
    """What a traced sub-window of ``window_us`` holds: device busy time,
    decode-attention kernel time and the least time of those calls'
    work, and the breakdown's top device operations and idle gaps."""
    window_us: float
    busy_us: float
    attn_us: float = 0.0
    attn_least_s: float = 0.0
    attn_calls: int = 0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = name.strip().replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def union_us(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(ops: Sequence[DeviceOp], calls: Sequence[Call],
              w0_us: float, w1_us: float, top: int = 10) -> TraceSummary:
    """Reduce a trace to the sub-window ``[w0_us, w1_us]``.

    Busy time is the union of every device operation clipped to the
    window. Each decode-attention kernel (``ATTN_KERNEL``) belongs to the
    latest call the host made before it started (a step waits for its
    attend before the next step calls again); a call counts when it has
    kernels and all of them lie inside the window, and then its kernels'
    time and its least time are summed. Idle gaps are named by the device
    operations on either side."""
    inside = sorted((op for op in ops
                     if op.end_us > w0_us and op.start_us < w1_us),
                    key=lambda op: op.start_us)
    clipped = [(max(op.start_us, w0_us), min(op.end_us, w1_us))
               for op in inside]
    out = TraceSummary(window_us=w1_us - w0_us, busy_us=union_us(clipped))

    by_name: Dict[str, float] = {}
    for op, (s, e) in zip(inside, clipped):
        key = short_name(op.name)
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    out.device_ops = sorted(((k, v / 1e6) for k, v in by_name.items()),
                            key=lambda kv: -kv[1])[:top]

    gaps: Dict[str, float] = {}
    prev_end, prev_name = w0_us, "window start"
    for op, (s, e) in zip(inside, clipped):
        if s > prev_end:
            key = f"{prev_name} -> {short_name(op.name, 48)}"
            gaps[key] = gaps.get(key, 0.0) + (s - prev_end)
        if e >= prev_end:
            prev_end, prev_name = e, short_name(op.name, 48)
    if w1_us > prev_end:
        key = f"{prev_name} -> window end"
        gaps[key] = gaps.get(key, 0.0) + (w1_us - prev_end)
    out.idle_gaps = sorted(((k, v / 1e6) for k, v in gaps.items()),
                           key=lambda kv: -kv[1])[:top]

    times = [c.t_us for c in calls]
    owned: Dict[int, List[DeviceOp]] = {}
    for op in ops:
        if not ATTN_KERNEL.search(op.name):
            continue
        i = bisect.bisect_right(times, op.start_us) - 1
        if i >= 0:
            owned.setdefault(i, []).append(op)
    for i, kernels in owned.items():
        if all(w0_us <= k.start_us and k.end_us <= w1_us for k in kernels):
            out.attn_us += sum(k.end_us - k.start_us for k in kernels)
            out.attn_least_s += calls[i].least_s
            out.attn_calls += 1
    return out
