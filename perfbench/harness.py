"""One run of one cell: set-up, the measured window, the checks.

Set-up: a claim for the card through the port's claim path
(``claim.open_claim``), ``bind_engine`` on its CDI spec at the
configuration's widths and engine settings, the engine's own thread
started, and a warm-up of the cell's shapes: in a backlog, the backlog
itself until every slot has turned over once; before an open loop, one
burst of a slot's worth of the mix's sizes, all finished. ``setup_s``
runs from the start of the process to the first due request of the
window.

The window: ``seconds`` of the mix's traffic, driven from this thread (a
backlog kept at ``queued_min`` waiting requests; an open loop submitted
at each request's due time). At its close the engine's counters, the
lengths it attends and the peak device memory are read; then the harness
waits up to ``grace_s`` for every request due in the window, drains the
engine and makes the checks (``check``): the engine's rows with its slabs
as they are, then, once the engine is freed, its attend on random inputs
against the plain reference.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from collections import deque
from typing import Callable, List, Optional

import torch

from k8s_dra_driver_tpu_torch.compute.serving import (
    DecodeRequest,
    ServingMetrics,
    bind_engine,
)

from perfbench import check, claim as claims, generate, reference
from perfbench.manifest import Bench
from perfbench.record import Run, Sent
from perfbench.stats import percentile
from perfbench.trace import AttendRecorder, Tracer

POLL_S = 0.002
#: How often the backlog is topped up during the window.
BACKLOG_POLL_S = 0.01
#: The longest a warm-up may take before the run fails.
WARMUP_TIMEOUT_S = 300.0
#: An open loop's first request is due this long after its warm-up.
LEAD_S = 0.05
#: The traced sub-window: at most this long, ending this long before the
#: window closes.
TRACE_S = 3.0
TRACE_END_GAP_S = 0.5


def log(stage: str, **kv) -> None:
    print(" ".join([f"[{stage}]", *(f"{k}={v}" for k, v in kv.items())]),
          file=sys.stderr, flush=True)


class Hooks:
    """Calls to make at given monotonic times from the driving thread."""

    def __init__(self):
        self.todo: List[tuple] = []

    def at(self, t: float, fn: Callable) -> None:
        self.todo.append((t, fn))
        self.todo.sort(key=lambda tf: tf[0])

    def run(self, now: float) -> None:
        while self.todo and self.todo[0][0] <= now:
            self.todo.pop(0)[1]()

    def sleep_until(self, t: float) -> None:
        while True:
            now = time.monotonic()
            self.run(now)
            if now >= t:
                return
            nxt = min([t] + [h[0] for h in self.todo[:1]])
            time.sleep(max(0.0, min(nxt - now, 0.05)))


class Driver:
    """Submits the mix's requests to the engine and keeps what it sent."""

    def __init__(self, engine):
        self.engine = engine
        self.sent: List[Sent] = []

    def submit(self, r: generate.Request, due_t: Optional[float],
               in_window: bool) -> Sent:
        req = DecodeRequest(rid=r.rid, tenant=r.tenant,
                            prompt_tokens=r.prompt_tokens,
                            max_new_tokens=r.max_new_tokens)
        t = time.monotonic()
        ok = self.engine.submit(req)
        s = Sent(req, t if due_t is None else due_t, t, in_window,
                 rejected=not ok)
        self.sent.append(s)
        return s

    def _alive(self) -> None:
        thread = getattr(self.engine, "_thread", None)
        if thread is not None and not thread.is_alive():
            raise RuntimeError("the engine's thread died")

    def wait(self, cond: Callable[[], bool], timeout: float,
             what: str) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            self._alive()
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{what} within {timeout} s")
            time.sleep(POLL_S)

    def backlog(self, mix: dict, seed: int, seconds: float, hooks: Hooks,
                prepare: Callable[[], None],
                on_window: Callable[[], None]) -> tuple:
        """Warm up, call ``prepare``, then hold the backlog for
        ``seconds``, calling ``on_window`` as it opens; (t0, t_end).

        The backlog is counted from the requests themselves (submitted and
        not yet admitted), not by asking the engine under its lock, and
        topped up every BACKLOG_POLL_S to ``queued_min`` plus the most the
        engine can admit before the next look (every slot's worth)."""
        reqs = generate.stream(mix, seed)
        target = int(mix["queued_min"]) + self.engine.max_batch
        eng = self.engine
        waiting: deque = deque()

        def top_up(in_window: bool) -> None:
            while waiting and (waiting[0].req.admit_t is not None
                               or waiting[0].rejected):
                waiting.popleft()
            for _ in range(target - len(waiting)):
                waiting.append(self.submit(next(reqs), None, in_window))

        deadline = time.monotonic() + WARMUP_TIMEOUT_S
        while len({s.req.slot for s in self.sent
                   if s.completed}) < eng.max_batch:
            top_up(False)
            self._alive()
            if time.monotonic() >= deadline:
                raise TimeoutError("backlog warm-up: every slot turned over")
            time.sleep(BACKLOG_POLL_S)
        prepare()
        t0 = time.monotonic()
        on_window()
        t_end = t0 + seconds
        while True:
            now = time.monotonic()
            hooks.run(now)
            if now >= t_end:
                return t0, t_end
            top_up(True)
            hooks.sleep_until(min(now + BACKLOG_POLL_S, t_end))

    def open_loop(self, mix: dict, seed: int, seconds: float, hooks: Hooks,
                  prepare: Callable[[], None],
                  on_window: Callable[[], None]) -> tuple:
        """Warm up with one burst, call ``prepare``, then submit each
        request at its due time for ``seconds``, calling ``on_window`` as
        the window opens; (t0, t_end)."""
        warm = [self.submit(r, None, False) for r in
                generate.warmup(mix, seed, self.engine.max_batch)]
        self.wait(lambda: all(s.completed or s.rejected for s in warm),
                  WARMUP_TIMEOUT_S, "open-loop warm-up")
        prepare()
        arrivals = generate.arrivals(mix, seed, seconds)
        t0 = time.monotonic() + LEAD_S
        hooks.sleep_until(t0)
        on_window()
        for r in arrivals:
            due = t0 + r.due_s
            hooks.sleep_until(due)
            self.submit(r, due, True)
        hooks.sleep_until(t0 + seconds)
        return t0, t0 + seconds


def _counters(engine) -> dict:
    with engine._mu:
        return {k: getattr(engine, k) for k in
                ("steps", "decode_steps", "decode_tokens", "prefill_tokens")}


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def card_device_lib() -> tuple:
    """The host's device library (NVML where it loads) and the UUID of
    torch's ``cuda:0``, which the library must hold."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import locate_gpu
    u = str(torch.cuda.get_device_properties(0).uuid)
    uuid = u if u.upper().startswith("GPU-") else f"GPU-{u}"
    return locate_gpu(uuid)[0], uuid


#: The window of each traffic kind (``generate.KINDS``): the driver's
#: method that runs it.
WINDOWS = {"backlog": Driver.backlog, "poisson": Driver.open_loop}


def bind(spec: dict, name: str, config: dict, device: Optional[str] = None,
         uuids: Optional[dict] = None):
    """``bind_engine`` on a claim's CDI spec at the configuration's widths,
    with every setting of its ``engine`` passed as the engine's keyword."""
    return bind_engine(
        spec, name, device=device, uuids=uuids, metrics=ServingMetrics(),
        heads=int(config["num_attention_heads"]),
        head_dim=int(config["head_dim"]), **config["engine"])


def run_cell(bench: Bench, cell_name: str, seed: int, seconds: float,
             trace: bool, t_start: float, *, device_lib=None,
             gpu_uuid: Optional[str] = None, device: Optional[str] = None,
             uuids: Optional[dict] = None, control: Optional[str] = None,
             fault: Optional[Callable] = None,
             grace_s: float = 60.0) -> dict:
    """Run ``cell_name`` and return its result line as a dict.

    On the card (``device`` None) the GPU is torch's ``cuda:0``, found by
    UUID through the host's device library; a caller may pass another
    library, its GPU's UUID, ``device="cpu"`` and the ``uuids`` to match
    the spec against instead. ``control="tf32"`` puts the reference at
    TF32 in the place of the engine's attend (``reference.CONTROLS``). ``fault(engine)``, called
    when the window opens, may break the timed path underneath."""
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    generate.check_mix(mix)
    limits = dict(config["checks"])

    if device_lib is None:
        device_lib, gpu_uuid = card_device_lib()
    t_claim = time.monotonic()
    claim = claims.open_claim(device_lib, gpu_uuid)
    log("setup", to_claim_s=t_claim - t_start,
        claim_ready_ms=claim.claim_ready_ms)
    engine = None
    try:
        engine = bind(claim.spec, cell_name, config, device, uuids)
        if device is None and engine.device != torch.device("cuda", 0):
            raise RuntimeError(f"engine bound to {engine.device}, not the "
                               "claimed card cuda:0")
        if control is not None:
            engine.attend = reference.CONTROLS[control]
        tracer = None
        if trace:
            engine.attend = recorder = AttendRecorder(engine.attend)
            tracer = Tracer(recorder)
        drv = Driver(engine)
        engine.start()
        t_built = time.monotonic()
        log("setup", engine_bound_s=t_built - t_start)

        hooks = Hooks()
        opened = {}

        def prepare() -> None:
            if tracer is not None:
                tracer.start()

        def on_window() -> None:
            t0 = time.monotonic()
            if fault is not None:
                fault(engine)
            if tracer is not None:
                length = min(TRACE_S, seconds / 4)
                t1 = t0 + seconds - TRACE_END_GAP_S
                hooks.at(t1 - length, tracer.begin)
                hooks.at(t1, tracer.end)
            opened["counters"] = _counters(engine)

        t0, t_end = WINDOWS[mix["kind"]](drv, mix, seed, seconds, hooks,
                                         prepare, on_window)
        counters = {k: v - opened["counters"][k]
                    for k, v in _counters(engine).items()}
        lens = check.lens_at(engine, drv.sent, engine.max_batch)
        on_card = engine.device.type == "cuda"
        mem_peak = (torch.cuda.max_memory_allocated(engine.device)
                    if on_card else 0)
        if tracer is not None:
            tracer.stop()
        late = [s.submit_t - s.due_t for s in drv.sent if s.in_window]
        log("window", seconds=t_end - t0, steps=counters["steps"],
            decode_tokens=counters["decode_tokens"],
            prefill_tokens=counters["prefill_tokens"],
            requests=len(late), warmup_s=t0 - t_built,
            generator_late_p50_ms=_ms(percentile(late, 50)),
            generator_late_p99_ms=_ms(percentile(late, 99)),
            generator_late_max_ms=_ms(max(late) if late else None))

        window = [s for s in drv.sent if s.in_window]
        try:
            drv.wait(lambda: all(s.completed or s.rejected for s in window),
                     grace_s, "the window's requests")
        except TimeoutError as e:
            log("grace", unfinished=str(e))
        grace_end = time.monotonic()
        engine.drain(timeout=0.0)

        numbers = {"unanswered": check.unanswered(drv.sent),
                   "unaccounted": check.unaccounted(engine, drv.sent),
                   "rows_err": check.rows_error(engine, drv.sent)}
        attend = getattr(engine, "attend", None)
        if isinstance(attend, AttendRecorder):
            attend = attend.inner
        slab = (engine.max_batch, engine.heads, engine.kv_cap,
                engine.head_dim)
        dev = engine.device
        slab_dtype = engine._K.dtype
        run = Run(cell=cell, config=config, mix=mix, seed=seed,
                  setup_s=t0 - t_start, claim_ready_ms=claim.claim_ready_ms,
                  t0=t0, t_end=t_end, grace_end=grace_end, counters=counters,
                  sent=drv.sent,
                  trace=(tracer.summary(_device_name(dev))
                         if tracer is not None else None))
        engine = drv.engine = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        numbers["attn_err"] = check.kernel_error(
            attend, slab, slab_dtype, dev, lens, seed)
    finally:
        if engine is not None:
            engine.stop()
        residue = claim.close()
    if residue:
        raise RuntimeError(f"the claim left {residue} behind")

    correct, checks = check.verdict(numbers, limits)
    metrics = {}
    for m in bench.metrics(cell_name, per_layer=trace):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    window_sent = run.window_sent
    result = {
        "correct": correct,
        "attempted": len(window_sent),
        "failed": sum(1 for s in window_sent
                      if s.rejected or not s.completed),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": _device_name(dev),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(mem_peak)},
    }
    if run.trace is not None:
        t = run.trace
        result["device"]["busy_s"] = t.busy_us / 1e6
        result["device"]["window_s"] = t.window_us / 1e6
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
    result["checks"] = checks
    return result


def _ms(x: Optional[float]) -> Optional[float]:
    return None if x is None or not math.isfinite(x) else x * 1e3
