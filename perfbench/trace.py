"""The traced run: the device trace of a steady sub-window and the decode
calls made in it.

``torch.profiler`` runs from the end of set-up to the close of the window
(so that starting it stalls nothing inside the window), and a
``record_function`` marker on the harness's thread bounds the sub-window
that is reduced. ``AttendRecorder`` wraps the engine's attend: while armed
it notes each call's host time, its inputs' shapes and element sizes and
its lengths tensor (kept as passed, not copied), so that each call's bytes
and operations can be counted from what it attended. Host times map onto
the trace's clock through the marker, whose start is taken on both.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from perfbench import roofline

MARKER = "perfbench.traced_window"

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


class AttendRecorder:
    """An engine's attend that notes its calls while ``calls`` is a list."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: Optional[list] = None

    def __call__(self, q, k, v, lens, *args, **kwargs):
        calls = self.calls
        if calls is not None:
            calls.append((time.monotonic(), tuple(q.shape), v.shape[3],
                          q.element_size(), k.element_size(),
                          v.element_size(), _DTYPE_NAMES.get(k.dtype),
                          lens))
        return self.inner(q, k, v, lens, *args, **kwargs)


class Tracer:
    """The profiler over the window and the marker of its sub-window."""

    def __init__(self, recorder: AttendRecorder):
        self.recorder = recorder
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._mark = None
        self._calls: Optional[list] = None
        self.m0: Optional[float] = None

    def start(self) -> None:
        self.recorder.calls = []
        self.prof.start()

    def begin(self) -> None:
        self._mark = torch.autograd.profiler.record_function(MARKER)
        self.m0 = time.monotonic()
        self._mark.__enter__()

    def end(self) -> None:
        self._mark.__exit__(None, None, None)

    def stop(self) -> None:
        self.prof.stop()
        self.recorder.calls, self._calls = None, self.recorder.calls

    def summary(self, device_name: str) -> Optional[roofline.TraceSummary]:
        """The sub-window's summary; None where the trace holds no device
        operation or no marker, or the device has no row of peaks."""
        events = self.prof.events()
        marks = [e for e in events if e.name == MARKER]
        ops = [roofline.DeviceOp(e.name, e.time_range.start,
                                 e.time_range.end)
               for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
        peak = roofline.peaks(device_name)
        if not marks or not ops or peak is None or self.m0 is None:
            return None
        w0, w1 = marks[0].time_range.start, marks[0].time_range.end
        offset = w0 - self.m0 * 1e6
        return roofline.summarize(ops, self._call_costs(peak, offset), w0, w1)

    def _call_costs(self, peak: dict, offset_us: float
                    ) -> List[roofline.Call]:
        calls = self._calls or []
        if not calls:
            return []
        lens = torch.stack([c[-1] for c in calls]).cpu().tolist()
        out = []
        for (t, (_, h, ql, d), dv, qs, ks, vs, dtype, _), ls in zip(
                calls, lens):
            ls = [max(1, int(n)) for n in ls]
            nbytes = roofline.decode_bytes(ls, h, ql, d, dv, ks, vs, qs)
            flops = roofline.decode_flops(ls, h, ql, d, dv)
            out.append(roofline.Call(
                t * 1e6 + offset_us,
                roofline.least_seconds(nbytes, flops, peak, dtype)))
        return out
