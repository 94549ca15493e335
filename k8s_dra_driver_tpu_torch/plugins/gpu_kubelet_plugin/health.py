"""Device health monitor: poll loop → DeviceTaint → slice republish.

The counterpart of the JAX package's ``plugins/tpu_kubelet_plugin/
health.py``, itself the analogue of the reference's NVML event monitor
(``cmd/gpu-kubelet-plugin/device_health.go:103-273``). Its signals: the
GPU's health from the device library — with the NVML backend, critical
XID and double-bit ECC events from an NVML event session the monitor holds
(``gpulib.device_lib.NvmlEventSession``), application XIDs skipped — and
the GPU's presence in enumeration and its ``/dev/nvidia<minor>`` node
("gpu-lost": a GPU vanishing from enumeration). Events map to KEP-5055
DeviceTaints under the one-key-per-dimension schema
(``device_health.go:35-39``) and are consumed by the driver's taint +
republish path (``driver.go:503-575``).

The monitor runs as a daemon thread; the mock backend's fault injection
(``MockDeviceLib.set_unhealthy``, the ``gpulib.gpu.unhealthy`` and
``gpulib.gpu.vanish`` fault points) drives it in tests.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from k8s_dra_driver_tpu_torch.gpulib.chip import GpuInfo, HealthState
from k8s_dra_driver_tpu_torch.kubeletplugin.types import DeviceTaint
from k8s_dra_driver_tpu_torch.pkg import faultpoints

logger = logging.getLogger(__name__)

DRIVER_NAME = "gpu.nvidia.com"

# Fault point at the top of every health poll round (docs/fault-injection.md):
# a failing probe must be absorbed — the loop stays alive and the missed
# transition fires on the NEXT poll (state commits only after the handler
# ran), never lost.
FP_HEALTH_PROBE = faultpoints.register(
    "health.probe", "one whole health poll round fails before any read")

TAINT_KEY_ECC = f"{DRIVER_NAME}/ecc"
TAINT_KEY_GPU_LOST = f"{DRIVER_NAME}/gpu-lost"
TAINT_KEY_XID = f"{DRIVER_NAME}/xid"

EVENT_ECC = "ecc"
EVENT_GPU_LOST = "gpu-lost"
EVENT_XID = "xid"
EVENT_RECOVERED = "recovered"

_EVENT_TO_TAINT_KEY = {
    EVENT_ECC: TAINT_KEY_ECC,
    EVENT_GPU_LOST: TAINT_KEY_GPU_LOST,
    EVENT_XID: TAINT_KEY_XID,
}

#: every taint key the health pipeline can apply — the set the remediation
#: rejoin clears in one atomic republish (docs/self-healing.md).
HEALTH_TAINT_KEYS = tuple(_EVENT_TO_TAINT_KEY.values())

#: default GPU-vanish flap-damping hysteresis (docs/self-healing.md,
#: "Flap damping"): a GPU must be absent from this many CONSECUTIVE polls
#: before the gpu-lost event fires and the drain pipeline starts. A
#: single-poll flap (a transient enumeration blip, the ``gpulib.gpu.vanish``
#: fault point) produces no taint and no drain. 1 = fire on the first
#: absent poll (no damping).
DEFAULT_VANISH_GRACE = 2


@dataclass
class DeviceHealthEvent:
    device: str               # DRA device name (gpu-<i>)
    event_type: str           # EVENT_* (EVENT_RECOVERED clears taints)
    reason: str = ""


def health_event_to_taint(event: DeviceHealthEvent) -> Optional[DeviceTaint]:
    key = _EVENT_TO_TAINT_KEY.get(event.event_type)
    if key is None:
        return None
    return DeviceTaint(key=key, value=event.reason or event.event_type,
                       effect="NoSchedule")


class DeviceHealthMonitor:
    """Polls GPU health and emits events on state TRANSITIONS (healthy →
    unhealthy and back) so the consumer performs one republish per change,
    not one per poll.

    Started, it holds the device library's NVML event session where the
    library has one (:meth:`start` opens it, :meth:`stop` frees it);
    :attr:`nvml_events` says whether NVML registered the GPUs for events,
    or why not."""

    def __init__(
        self,
        device_lib,
        on_event: Callable[[DeviceHealthEvent], None],
        poll_interval: float = 5.0,
        forget_after: int = 120,
        on_forget: Optional[Callable[[str], None]] = None,
        vanish_grace: int = DEFAULT_VANISH_GRACE,
        fast_drain: Optional[Callable[[], bool]] = None,
    ):
        """``forget_after``: consecutive absent polls (after the gpu-lost
        event was delivered) before a vanished GPU is pruned from the
        monitor's memory; ``on_forget(name)`` lets the consumer drop its
        own state (taints) so a later REPLACEMENT GPU under the same name
        starts fresh.

        ``vanish_grace``: flap-damping hysteresis — a GPU must be absent
        from this many consecutive polls before the gpu-lost event fires.
        A GPU that reappears inside the window produces NO event at all.

        ``fast_drain``: zero-arg hook consulted while a GPU is inside the
        grace window; True collapses the grace to 1 — "drain immediately"
        (an SLO fast-burn alert firing, in the JAX package's wiring)."""
        self.device_lib = device_lib
        self.on_event = on_event
        self.poll_interval = poll_interval
        self.forget_after = forget_after
        self.on_forget = on_forget
        self.vanish_grace = max(1, vanish_grace)
        self.fast_drain = fast_drain
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_state: dict[str, tuple[str, str]] = {}  # dev → (state, type)
        self._known: set[str] = set()
        self._absent_polls: dict[str, int] = {}
        self._vanish_streak: dict[str, int] = {}  # pre-event absent polls
        self._first_poll_done = False
        self.events_session = None

    @property
    def nvml_events(self) -> str:
        """``supported``; the NVML error a registration met; or why no
        session is open."""
        if self.events_session is not None:
            return self.events_session.status
        return (f"no session (backend "
                f"{getattr(self.device_lib, 'backend', '?')})")

    # -- single poll (exposed for deterministic tests) -----------------------

    def poll_once(self) -> list[DeviceHealthEvent]:
        try:
            faultpoints.maybe_fail(FP_HEALTH_PROBE)
            if hasattr(self.device_lib, "refresh"):
                self.device_lib.refresh()
            gpus: list[GpuInfo] = self.device_lib.enumerate_gpus()
        except Exception as e:  # noqa: BLE001 — keep the loop alive
            logger.warning("health poll enumeration failed: %s", e)
            return []
        # (event, state-key, new-state) transitions; state commits only after
        # the handler succeeds, so a failed taint/republish is re-attempted
        # on the next poll instead of being lost forever.
        pending: list[tuple[DeviceHealthEvent, str, tuple[str, str]]] = []
        seen: set[str] = set()
        for gpu in gpus:
            name = gpu.canonical_name
            seen.add(name)
            try:
                health = self.device_lib.gpu_health(gpu)
            except Exception as e:  # noqa: BLE001
                logger.warning("health read failed for %s: %s", name, e)
                continue
            if (health.state != HealthState.UNHEALTHY
                    and gpu.health.state == HealthState.UNHEALTHY):
                # Enumeration-carried health counts too: the backend (or
                # the gpulib.gpu.unhealthy fault point) may mark a GPU
                # unhealthy at enumeration time without the per-GPU
                # health read reflecting it.
                health = gpu.health
            if health.state == HealthState.UNHEALTHY:
                etype = EVENT_ECC if health.ecc_errors > 0 else EVENT_XID
                new = ("unhealthy", etype)
                if self._last_state.get(name) != new:
                    pending.append((DeviceHealthEvent(
                        device=name, event_type=etype, reason=health.reason),
                        name, new))
            else:
                if self._last_state.get(name, ("healthy", ""))[0] != "healthy":
                    pending.append((DeviceHealthEvent(
                        device=name, event_type=EVENT_RECOVERED),
                        name, ("healthy", "")))
                elif self._first_poll_done and name not in self._last_state:
                    # A GPU appearing AFTER startup (hotplug add, or a
                    # replacement for a forgotten GPU): surface it as a
                    # recovery so the consumer republishes. Keyed on
                    # _last_state (which commits only after the handler
                    # succeeds), NOT on _known, so a failed republish
                    # re-fires next poll. The first poll learns the
                    # population silently.
                    pending.append((DeviceHealthEvent(
                        device=name, event_type=EVENT_RECOVERED),
                        name, ("healthy", "")))
                else:
                    self._last_state[name] = ("healthy", "")
        # GPU lost: previously known devices that vanished from enumeration.
        for name in self._known - seen:
            if self._last_state.get(name) != ("unhealthy", EVENT_GPU_LOST):
                # Flap damping: the lost event — and the taint + drain
                # pipeline behind it — waits out ``vanish_grace``
                # consecutive absent polls; ``fast_drain`` collapses it.
                streak = self._vanish_streak.get(name, 0) + 1
                self._vanish_streak[name] = streak
                grace = self.vanish_grace
                if grace > 1 and self.fast_drain is not None:
                    try:
                        if self.fast_drain():
                            grace = 1
                    except Exception:  # noqa: BLE001 — an alerting
                        # hiccup must not change health semantics.
                        logger.exception("fast_drain hook failed; "
                                         "keeping damped grace")
                if streak < grace:
                    logger.info(
                        "GPU %s absent (poll %d/%d): damping the flap",
                        name, streak, grace)
                    continue
                pending.append((DeviceHealthEvent(
                    device=name, event_type=EVENT_GPU_LOST,
                    reason="GPU disappeared from enumeration"),
                    name, ("unhealthy", EVENT_GPU_LOST)))
                continue
            # Lost event already delivered: count toward the forget horizon
            # so a physically removed GPU is eventually pruned.
            self._absent_polls[name] = self._absent_polls.get(name, 0) + 1
            if self._absent_polls[name] >= self.forget_after:
                logger.info("forgetting removed GPU %s after %d absent "
                            "polls", name, self._absent_polls[name])
                if self.on_forget is not None:
                    try:
                        self.on_forget(name)
                    except Exception:  # noqa: BLE001 — retried next poll
                        logger.exception("on_forget(%s) failed; keeping "
                                         "state for retry", name)
                        continue
                self._known.discard(name)
                self._last_state.pop(name, None)
                self._absent_polls.pop(name, None)
                self._vanish_streak.pop(name, None)
        for name in seen:
            self._absent_polls.pop(name, None)  # back: reset the horizon
            self._vanish_streak.pop(name, None)  # flap over: reset grace
        self._known |= seen
        self._first_poll_done = True
        events: list[DeviceHealthEvent] = []
        for ev, name, new_state in pending:
            try:
                self.on_event(ev)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "health event handler failed for %s (will retry)", ev)
                continue  # state NOT committed → retried next poll
            self._last_state[name] = new_state
            events.append(ev)
        return events

    # -- loop ----------------------------------------------------------------

    def open_events(self):
        """Open the device library's NVML event session, if it has one
        (idempotent); its refusal of a GPU is in :attr:`nvml_events`."""
        opener = getattr(self.device_lib, "open_health_events", None)
        if self.events_session is None and opener is not None:
            self.events_session = opener()
        return self.events_session

    def start(self) -> "DeviceHealthMonitor":
        self.open_events()
        self._thread = threading.Thread(
            target=self._run, name="gpu-health-monitor", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the loop must never die
                logger.exception("health poll crashed; continuing")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self.events_session is not None:
            self.device_lib.close_health_events()


def attach_health_monitor(driver, poll_interval: float = 5.0,
                          start: bool = True,
                          forget_after: int = 120,
                          vanish_grace: int = DEFAULT_VANISH_GRACE,
                          fast_drain: Optional[Callable[[], bool]] = None,
                          ) -> DeviceHealthMonitor:
    """Wire a monitor to a GpuDriver: events become taints + republish
    (the driver.go:503-575 consumption path). ``vanish_grace`` /
    ``fast_drain``: GPU-vanish flap damping and its override — damped by
    default so a single-poll enumeration blip drains nothing."""

    all_keys = HEALTH_TAINT_KEYS

    def on_event(ev: DeviceHealthEvent) -> None:
        if ev.event_type == EVENT_RECOVERED:
            # One atomic clear of every fault-type key → one republish.
            changed = driver.update_device_taints(ev.device,
                                                  clear_keys=all_keys)
            if not changed:
                # Untainted recovery = a NEW device surfacing (hotplug add /
                # replacement after a forget): publication still needs the
                # refresh the taint path would have done.
                driver.republish()
            logger.info("device %s recovered: taints cleared", ev.device)
            return
        taint = health_event_to_taint(ev)
        if taint is not None:
            logger.warning("device %s unhealthy (%s): tainting",
                           ev.device, ev.reason)
            # Adding a fault taint also clears the OTHER fault keys so a
            # reclassification (xid → ecc) never leaves a stale taint.
            other = tuple(k for k in all_keys if k != taint.key)
            driver.update_device_taints(ev.device, add=taint, clear_keys=other)

    def on_forget(name: str) -> None:
        # Drop the dead GPU's taints so a replacement GPU surfacing under
        # the same device name is not born pre-tainted.
        driver.update_device_taints(name, clear_keys=all_keys)

    monitor = DeviceHealthMonitor(
        driver.state.device_lib, on_event, poll_interval=poll_interval,
        forget_after=forget_after, on_forget=on_forget,
        vanish_grace=vanish_grace, fast_drain=fast_drain)
    if start:
        monitor.start()
    return monitor
