"""Shared process utilities: debug signal handlers, stack dumps and the
``/debug/*`` handler set.

The counterpart of the JAX package's ``internal/common.py`` (the
reference's ``internal/common``, ``util.go:29-118``): every binary arms a
SIGUSR2 handler that dumps all thread stacks to a file for live-process
forensics, and mounts one uniform set of debug endpoints.
"""

from __future__ import annotations

import faulthandler
import logging
import signal
import os
import sys
import tempfile
import threading
import traceback

logger = logging.getLogger(__name__)

STACK_DUMP_PATH = os.path.join(tempfile.gettempdir(), "thread-stacks.dump")


def dump_stacks(path: str = STACK_DUMP_PATH) -> str:
    """Write every thread's current stack to ``path`` and return it."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    text = "\n".join(out) + "\n"
    try:
        with open(path, "w") as f:
            f.write(text)
    except OSError as e:
        logger.warning("cannot write stack dump to %s: %s", path, e)
    return text


def standard_debug_handlers() -> dict:
    """The ``/debug/*`` endpoint set every binary's MetricsServer mounts
    (docs/observability.md, "Debug endpoints"): traces (the tracer's
    ring buffer), informers (cache/stream health), workqueue (depth +
    in-processing keys), inflight (per-claim flight locks), slo
    (objective states, burn rates, transition history), nodelease (lease
    epochs, fence acks, cordon state), incidents (the flight recorder's
    bundle index + newest bundle), profile (the continuous profiler's
    folded stacks + lock contention), canary
    (per-node synthetic-probe history + last failure), and usage (the
    per-tenant GPU-seconds ledger + cluster utilization). The last six
    serve empty lists in processes that never assemble the component —
    the endpoint set is uniform across binaries. Imported lazily so this
    helper stays importable from any layer."""
    from k8s_dra_driver_tpu_torch.k8sclient.informer import (
        informer_debug_snapshot,
    )
    from k8s_dra_driver_tpu_torch.pkg import tracing
    from k8s_dra_driver_tpu_torch.pkg.blackbox import (
        incidents_debug_snapshot,
        profile_debug_snapshot,
    )
    from k8s_dra_driver_tpu_torch.pkg.canary import canary_debug_snapshot
    from k8s_dra_driver_tpu_torch.pkg.inflight import inflight_debug_snapshot
    from k8s_dra_driver_tpu_torch.pkg.nodelease import (
        nodelease_debug_snapshot,
    )
    from k8s_dra_driver_tpu_torch.pkg.slo import slo_debug_snapshot
    from k8s_dra_driver_tpu_torch.pkg.usage import usage_debug_snapshot
    from k8s_dra_driver_tpu_torch.pkg.workqueue import (
        workqueue_debug_snapshot,
    )

    return {
        "traces": tracing.debug_snapshot,
        "informers": informer_debug_snapshot,
        "workqueue": workqueue_debug_snapshot,
        "inflight": inflight_debug_snapshot,
        "slo": slo_debug_snapshot,
        "nodelease": nodelease_debug_snapshot,
        "incidents": incidents_debug_snapshot,
        "profile": profile_debug_snapshot,
        "canary": canary_debug_snapshot,
        "usage": usage_debug_snapshot,
    }


def start_debug_signal_handlers(path: str = STACK_DUMP_PATH) -> None:
    """Arm SIGUSR2 → full thread-stack dump (util.go:34-70). Safe to call
    from non-main threads (no-op there) and in environments without signals."""
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        signal.signal(
            signal.SIGUSR2,
            lambda signum, frame: dump_stacks(path))
        # Also arm faulthandler for hard crashes (SIGSEGV etc.).
        faulthandler.enable()
        logger.debug("SIGUSR2 stack dumper armed (dump → %s)", path)
    except (ValueError, OSError, RuntimeError) as e:
        logger.debug("debug signal handlers unavailable: %s", e)
