"""The GPU port's health monitor, NVML health events and health probe.

The scenarios of the JAX package's ``tests/test_health_cleanup.py``
``TestHealthMonitor`` on the port's ``h100-8`` mock (fault → taint →
republish → recovery, flap damping, the forget horizon, handler retries),
the NVML event path through a fake event API (a critical XID taints, an
application XID does not, a refused registration is reported), the
``driver_probe`` health probe, and one seeded scenario driven through
both packages (``TestAgainstJax``).
"""

import copy
import ctypes
import time

import numpy as np
import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxFakeClient
from k8s_dra_driver_tpu.k8sclient.client import new_object as jax_new_object
from k8s_dra_driver_tpu.pkg.events import list_events as jax_list_events
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    DriverConfig as JaxDriverConfig,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import TpuDriver
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin.health import (
    attach_health_monitor as jax_attach_health_monitor,
)
from k8s_dra_driver_tpu.tpulib import MockDeviceLib as JaxMockDeviceLib
from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import AllocationError, Allocator
from k8s_dra_driver_tpu_torch.pkg import faultpoints
from k8s_dra_driver_tpu_torch.pkg.events import list_events
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health import (
    EVENT_ECC,
    EVENT_GPU_LOST,
    EVENT_RECOVERED,
    EVENT_XID,
    HEALTH_TAINT_KEYS,
    TAINT_KEY_ECC,
    TAINT_KEY_XID,
    DeviceHealthMonitor,
    attach_health_monitor,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck import (
    STATUS_NOT_SERVING,
    STATUS_SERVING,
    driver_probe,
)

DRIVER = "gpu.nvidia.com"


@pytest.fixture()
def cluster(tmp_path):
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    lib = dl.MockDeviceLib("h100-8")
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=0.5),
        device_lib=lib).start()
    return client, driver, lib


def _claim(client, name, selectors=None):
    req = {"name": "gpu", "exactly": {
        "deviceClassName": DRIVER, "allocationMode": "ExactCount",
        "count": 1}}
    if selectors:
        req["exactly"]["selectors"] = [{"cel": {"expression": s}}
                                       for s in selectors]
    return client.create(new_object(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [req]}}))


def _published(client, name):
    return next(d for d in client.list("ResourceSlice")[0]["spec"]["devices"]
                if d["name"] == name)


def _without(lib, index):
    real = lib.enumerate_gpus
    lib.enumerate_gpus = lambda: [g for g in real() if g.index != index]
    return real


class TestHealthMonitor:
    def test_fault_to_taint_to_recovery(self, cluster):
        """Inject fault → device tainted in the published slice → clear →
        untainted, and the allocator refuses the tainted GPU meanwhile."""
        client, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        lib.set_unhealthy(2, "double-bit ECC storm", ecc_errors=9)
        events = monitor.poll_once()
        assert [e.event_type for e in events] == [EVENT_ECC]
        assert _published(client, "gpu-2")["taints"][0]["key"] == \
            TAINT_KEY_ECC
        with pytest.raises(AllocationError):
            Allocator(client).allocate(_claim(
                client, "want2",
                selectors=["device.attributes['index'] == 2"]))
        lib.set_healthy(2)
        events = monitor.poll_once()
        assert [e.event_type for e in events] == [EVENT_RECOVERED]
        assert "taints" not in _published(client, "gpu-2")
        Allocator(client).allocate(_claim(
            client, "now-ok", selectors=["device.attributes['index'] == 2"]))

    def test_xid_without_ecc_is_an_xid_taint(self, cluster):
        client, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        lib.set_unhealthy(5, "XID 79", xid_errors=1)
        assert [e.event_type for e in monitor.poll_once()] == [EVENT_XID]
        assert [t["key"] for t in _published(client, "gpu-5")["taints"]] \
            == [TAINT_KEY_XID]

    def test_transition_not_repeated(self, cluster):
        _, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        lib.set_unhealthy(1, "xid")
        assert len(monitor.poll_once()) == 1
        assert monitor.poll_once() == []  # same state: no event storm

    def test_gpu_lost(self, cluster):
        client, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        monitor.poll_once()  # learn the full population
        _without(lib, 5)
        # Default flap damping (grace 2): the first absent poll is damped.
        assert monitor.poll_once() == []
        events = monitor.poll_once()
        assert [e.event_type for e in events] == [EVENT_GPU_LOST]
        assert events[0].device == "gpu-5"
        devices = {d["name"]
                   for d in client.list("ResourceSlice")[0]["spec"]["devices"]}
        assert "gpu-5" not in devices

    def test_single_poll_vanish_flap_is_damped(self, cluster):
        client, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        monitor.poll_once()
        real = _without(lib, 5)
        assert monitor.poll_once() == []      # damped
        lib.enumerate_gpus = real
        assert monitor.poll_once() == []      # back: flap over, no events
        assert monitor._vanish_streak == {}
        assert not _published(client, "gpu-5").get("taints")
        assert not driver.device_taints()

    def test_vanish_fault_point_flap_is_damped(self, cluster):
        """The ``gpulib.gpu.vanish`` point in schedule position: one
        enumeration without the last GPU taints nothing."""
        _, driver, _lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        monitor.poll_once()
        with faultpoints.injected("gpulib.gpu.vanish=nth:1"):
            assert monitor.poll_once() == []
            assert monitor.poll_once() == []
        assert not driver.device_taints()

    def test_unhealthy_fault_point_taints_gpu0(self, cluster):
        """The ``gpulib.gpu.unhealthy`` point marks GPU 0 unhealthy at
        enumeration; the monitor reads enumeration-carried health."""
        client, driver, _lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        with faultpoints.injected("gpulib.gpu.unhealthy=every:1"):
            events = monitor.poll_once()
        assert [(e.device, e.event_type) for e in events] == [
            ("gpu-0", EVENT_XID)]
        assert TAINT_KEY_XID in [
            t["key"] for t in _published(client, "gpu-0")["taints"]]
        assert [e.event_type for e in monitor.poll_once()] == [
            EVENT_RECOVERED]

    def test_fast_burn_collapses_vanish_grace(self, cluster):
        _, driver, lib = cluster
        burning = [False]
        monitor = attach_health_monitor(driver, start=False, vanish_grace=3,
                                        fast_drain=lambda: burning[0])
        monitor.poll_once()
        _without(lib, 5)
        assert monitor.poll_once() == []      # damped (grace 3)
        burning[0] = True
        events = monitor.poll_once()          # alert firing: immediate
        assert [e.event_type for e in events] == [EVENT_GPU_LOST]
        assert events[0].device == "gpu-5"

    def test_fast_drain_hook_failure_keeps_damping(self, cluster):
        _, driver, lib = cluster

        def boom() -> bool:
            raise RuntimeError("alerting plane down")

        monitor = attach_health_monitor(driver, start=False, vanish_grace=2,
                                        fast_drain=boom)
        monitor.poll_once()
        _without(lib, 5)
        assert monitor.poll_once() == []      # hook failed → stay damped
        assert [e.event_type for e in monitor.poll_once()] == [
            EVENT_GPU_LOST]

    def test_removed_gpu_forgotten_after_horizon(self, cluster):
        client, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False, forget_after=3,
                                        vanish_grace=1)
        monitor.poll_once()
        real = _without(lib, 5)
        assert [e.event_type for e in monitor.poll_once()] == [
            EVENT_GPU_LOST]
        assert "gpu-5" in monitor._known
        for _ in range(3):
            monitor.poll_once()
        assert "gpu-5" not in monitor._known
        assert "gpu-5" not in monitor._last_state
        assert "gpu-5" not in driver._taints  # replacement starts fresh
        lib.enumerate_gpus = real
        monitor.poll_once()
        assert not _published(client, "gpu-5").get("taints")

    def test_hotplug_add_event_retried_after_handler_failure(self, cluster):
        _, _driver, lib = cluster
        fired, fail = [], [True]

        def flaky(ev):
            if fail[0]:
                raise RuntimeError("transient")
            fired.append(ev)

        monitor = DeviceHealthMonitor(lib, flaky)
        monitor.poll_once()  # learn population
        real = lib.enumerate_gpus
        extra = copy.deepcopy(real()[0])
        extra.index = 9
        lib.enumerate_gpus = lambda: real() + [extra]
        assert monitor.poll_once() == []      # handler failed: not committed
        fail[0] = False
        events = monitor.poll_once()          # re-fired and committed
        assert [e.event_type for e in events] == [EVENT_RECOVERED]
        assert events[0].device == "gpu-9"
        assert monitor.poll_once() == []      # no storm

    def test_reappearance_resets_forget_horizon(self, cluster):
        _, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False, forget_after=3,
                                        vanish_grace=1)
        monitor.poll_once()
        real = _without(lib, 5)
        monitor.poll_once()  # lost event
        monitor.poll_once()  # absent 1
        lib.enumerate_gpus = real
        assert [e.event_type for e in monitor.poll_once()] == [
            EVENT_RECOVERED]
        assert monitor._absent_polls == {}

    def test_failed_handler_retried_next_poll(self, cluster):
        _, _driver, lib = cluster
        attempts = {"n": 0}
        fired = []

        def flaky_handler(ev):
            attempts["n"] += 1
            if attempts["n"] == 1:
                raise RuntimeError("transient republish failure")
            fired.append(ev)

        monitor = DeviceHealthMonitor(lib, flaky_handler)
        lib.set_unhealthy(4, "ecc", ecc_errors=1)
        assert monitor.poll_once() == []      # handler failed: not committed
        assert len(monitor.poll_once()) == 1  # retried and committed
        assert fired[0].device == "gpu-4"
        assert monitor.poll_once() == []

    def test_reclassification_replaces_taint(self, cluster):
        client, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        lib.set_unhealthy(6, "XID 48")           # no ecc → xid taint
        monitor.poll_once()
        lib.set_unhealthy(6, "now ecc", ecc_errors=3)
        monitor.poll_once()
        assert [t["key"] for t in _published(client, "gpu-6")["taints"]] \
            == [TAINT_KEY_ECC]

    def test_health_probe_fault_absorbed_transition_not_lost(self, cluster):
        _, driver, lib = cluster
        monitor = attach_health_monitor(driver, start=False)
        lib.set_unhealthy(0, "ecc", ecc_errors=3)
        with faultpoints.injected("health.probe=nth:1"):
            assert monitor.poll_once() == []
            events = monitor.poll_once()
        assert [e.device for e in events] == ["gpu-0"]
        assert "gpu-0" in driver.device_taints()

    def test_background_loop(self, cluster):
        client, driver, lib = cluster
        monitor = attach_health_monitor(driver, poll_interval=0.05)
        try:
            lib.set_unhealthy(0, "bg fault")
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if _published(client, "gpu-0").get("taints"):
                    break
                time.sleep(0.02)
            else:
                pytest.fail("taint never appeared")
        finally:
            monitor.stop()
        assert monitor.nvml_events == "no session (backend mock)"

    def test_health_taint_keys(self):
        assert HEALTH_TAINT_KEYS == ("gpu.nvidia.com/ecc",
                                     "gpu.nvidia.com/gpu-lost",
                                     "gpu.nvidia.com/xid")


# --------------------------------------------------------------------------
# NVML health events
# --------------------------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"
UUID0 = "GPU-73c4229c-ad5b-35c2-99a6-411722b9ffae"


class _FakeSession:
    """Stands in for ``NvmlEventSession``: queued raw events, a status."""

    def __init__(self, status=dl.EVENTS_SUPPORTED):
        self.status = status
        self.pending: list = []
        self.closed = False

    def poll(self):
        out, self.pending = self.pending, []
        return out

    def close(self):
        self.closed = True


class _FakeNvml:
    """Stands in for the NVML binding, with the event API: what a
    sandboxed container's NVML reports (no PCI address)."""

    def __init__(self, gpus, session):
        self.gpus = gpus
        self.session = session

    def enumerate(self):
        return list(self.gpus), "580.159.03"

    def open_events(self):
        return self.session


def _nvml_lib(tmp_path, session, n=2):
    raws = []
    for i in range(n):
        (tmp_path / f"nvidia{i}").write_text("")
        raws.append(dl.RawGpu(uuid=UUID0[:-1] + str(i), minor=i, pci_bdf="",
                              product_name=H100))
    lib = dl.SysfsDeviceLib(dev_root=str(tmp_path),
                            sysfs_root=str(tmp_path / "nosys"),
                            backend=dl.BACKEND_NVML, env={},
                            nvml=_FakeNvml(raws, session))
    return lib, raws


def _nvml_driver(tmp_path, lib):
    client = FakeClient()
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=0.5),
        device_lib=lib).start()
    return client, driver


class TestNvmlEvents:
    @pytest.mark.parametrize("xid,tainted", [(79, True), (48, True),
                                             (13, False), (31, False),
                                             (43, False), (45, False),
                                             (68, False), (109, False)])
    def test_critical_xid_taints_application_xid_does_not(
            self, tmp_path, xid, tainted):
        session = _FakeSession()
        lib, raws = _nvml_lib(tmp_path, session)
        client, driver = _nvml_driver(tmp_path, lib)
        monitor = attach_health_monitor(driver, start=False)
        assert monitor.open_events() is session
        monitor.poll_once()
        session.pending.append((raws[1].uuid, dl.NVML_EVENT_XID_CRITICAL,
                                xid))
        events = monitor.poll_once()
        if tainted:
            assert [(e.device, e.event_type) for e in events] == [
                ("gpu-1", EVENT_XID)]
            assert f"XID {xid}" in events[0].reason
            assert TAINT_KEY_XID in [
                t["key"] for t in _published(client, "gpu-1")["taints"]]
        else:
            assert events == []
            assert not driver.device_taints()

    def test_events_stick_until_repaired(self, tmp_path):
        session = _FakeSession()
        lib, raws = _nvml_lib(tmp_path, session)
        _client, driver = _nvml_driver(tmp_path, lib)
        monitor = attach_health_monitor(driver, start=False)
        monitor.open_events()
        session.pending.append((raws[0].uuid, dl.NVML_EVENT_DOUBLE_BIT_ECC,
                                0))
        assert [e.event_type for e in monitor.poll_once()] == [EVENT_ECC]
        assert monitor.poll_once() == []            # no new event, still bad
        assert not driver.device_healthy("gpu-0")
        lib.set_healthy(0)                          # the repair
        assert driver.device_healthy("gpu-0")
        assert [e.event_type for e in monitor.poll_once()] == [
            EVENT_RECOVERED]

    def test_not_supported_is_reported_and_presence_still_watched(
            self, tmp_path):
        session = _FakeSession(
            status="nvmlDeviceRegisterEvents: Not Supported (code 3)")
        lib, raws = _nvml_lib(tmp_path, session)
        _client, driver = _nvml_driver(tmp_path, lib)
        monitor = attach_health_monitor(driver, start=False,
                                        vanish_grace=1)
        monitor.open_events()
        assert "Not Supported (code 3)" in monitor.nvml_events
        monitor.poll_once()
        lib._nvml.gpus = raws[:1]                   # GPU 1 leaves NVML
        assert [(e.device, e.event_type) for e in monitor.poll_once()] == [
            ("gpu-1", EVENT_GPU_LOST)]

    def test_monitor_stop_closes_the_session(self, tmp_path):
        session = _FakeSession()
        lib, _raws = _nvml_lib(tmp_path, session)
        _client, driver = _nvml_driver(tmp_path, lib)
        monitor = attach_health_monitor(driver, poll_interval=0.05)
        assert monitor.events_session is session
        monitor.stop()
        assert session.closed and lib._events is None

    def test_session_never_freed_under_a_reader(self, tmp_path):
        """The monitor's and the drain controller's threads both read
        health, and the monitor's stop frees the NVML event set: under
        many readers and a short switch interval no read meets a freed
        set, and every event is folded exactly once."""
        import sys
        import threading

        class _CheckedSession(_FakeSession):
            def __init__(self):
                super().__init__()
                self.mu = threading.Lock()
                self.bad = 0

            def poll(self):
                if self.closed:
                    self.bad += 1
                time.sleep(0)            # NVML's wait: the GIL is released
                if self.closed:
                    self.bad += 1
                with self.mu:
                    out, self.pending = self.pending[:3], self.pending[3:]
                return out

        session = _CheckedSession()
        lib, raws = _nvml_lib(tmp_path, session)
        lib.open_health_events()
        n = 300
        session.pending = [(raws[i % 2].uuid, dl.NVML_EVENT_XID_CRITICAL,
                            79) for i in range(n)]
        gpus = lib.enumerate_gpus()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [
                lib.gpu_health(gpus[k % 2]) for k in range(300)])
                for _ in range(16)]
            for t in threads:
                t.start()
            while session.pending:
                time.sleep(0.001)
            lib.close_health_events()        # the monitor's stop
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        assert session.closed and session.bad == 0
        assert sum(lib.gpu_health(g).xid_errors for g in gpus) == n

    def test_procfs_library_has_no_session(self, tmp_path):
        lib = dl.SysfsDeviceLib(dev_root=str(tmp_path), env={})
        assert lib.open_health_events() is None

    @pytest.mark.parametrize("etype,data,want", [
        (dl.NVML_EVENT_XID_CRITICAL, 79, "xid"),
        (dl.NVML_EVENT_XID_CRITICAL, 13, None),
        (dl.NVML_EVENT_DOUBLE_BIT_ECC, 0, "ecc"),
        (0x4, 0, None),                      # a P-state change
    ])
    def test_classify(self, etype, data, want):
        got = dl.classify_nvml_event(etype, data)
        assert (got[0] if got else None) == want


class _FakeNvmlLib:
    """The NVML C entry points the event session calls, writing through
    ctypes pointers as the library does; ``register_rc`` is what
    ``nvmlDeviceRegisterEvents`` returns."""

    def __init__(self, n, register_rc=dl.NVML_SUCCESS,
                 create_rc=dl.NVML_SUCCESS):
        self.n = n
        self.register_rc = register_rc
        self.create_rc = create_rc
        self.inits = 0
        self.freed = []
        self.queue = []          # (handle, eventType, eventData)

    def nvmlErrorString(self, rc):
        return {3: b"Not Supported", 10: b"Timeout"}.get(rc, b"Unknown")

    def nvmlInit_v2(self):
        self.inits += 1
        return 0

    def nvmlShutdown(self):
        self.inits -= 1
        return 0

    def nvmlEventSetCreate(self, ref):
        ref._obj.value = 0xE0
        return self.create_rc

    def nvmlDeviceGetCount_v2(self, ref):
        ref._obj.value = self.n
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, ref):
        ref._obj.value = 0x1000 + i
        return 0

    def nvmlDeviceGetUUID(self, h, buf, size):
        buf.value = f"GPU-fake-{h.value - 0x1000}".encode()
        return 0

    def nvmlDeviceRegisterEvents(self, h, types, event_set):
        assert types == (dl.NVML_EVENT_XID_CRITICAL
                         | dl.NVML_EVENT_DOUBLE_BIT_ECC)
        return self.register_rc

    def nvmlEventSetWait_v2(self, event_set, ref, timeout):
        assert timeout == 0
        if not self.queue:
            return dl.NVML_ERROR_TIMEOUT
        h, etype, data = self.queue.pop(0)
        ref._obj.device, ref._obj.eventType, ref._obj.eventData = \
            h, etype, data
        return 0

    def nvmlEventSetFree(self, event_set):
        self.freed.append(event_set.value)
        return 0


def _binding(fake):
    b = dl.NvmlBinding.__new__(dl.NvmlBinding)
    b._lib, b.path = fake, "fake"
    return b


class TestNvmlEventSession:
    def test_registered_session_reads_without_waiting(self):
        fake = _FakeNvmlLib(2)
        s = _binding(fake).open_events()
        assert s.status == dl.EVENTS_SUPPORTED
        assert fake.inits == 1               # the session's own init
        fake.queue = [(0x1001, dl.NVML_EVENT_XID_CRITICAL, 79),
                      (0x1000, dl.NVML_EVENT_DOUBLE_BIT_ECC, 0)]
        assert s.poll() == [("GPU-fake-1", dl.NVML_EVENT_XID_CRITICAL, 79),
                            ("GPU-fake-0", dl.NVML_EVENT_DOUBLE_BIT_ECC, 0)]
        assert s.poll() == [] and s.delivered == 2
        s.close()
        s.close()                            # idempotent
        assert fake.inits == 0 and fake.freed == [0xE0]

    def test_not_supported_registration_reported_not_raised(self):
        fake = _FakeNvmlLib(1, register_rc=dl.NVML_ERROR_NOT_SUPPORTED)
        s = _binding(fake).open_events()
        assert s.status == ("nvmlDeviceRegisterEvents: Not Supported "
                            "(code 3)")
        assert s.refused == {"GPU-fake-0": "Not Supported (code 3)"}
        fake.queue = [(0x1000, dl.NVML_EVENT_XID_CRITICAL, 79)]
        assert s.poll() == []                # nothing registered
        s.close()
        assert fake.inits == 0

    def test_refused_event_set_reported(self):
        fake = _FakeNvmlLib(1, create_rc=dl.NVML_ERROR_NOT_SUPPORTED)
        s = _binding(fake).open_events()
        assert s.status == "nvmlEventSetCreate: Not Supported (code 3)"
        assert s.poll() == []
        s.close()
        assert fake.inits == 0 and fake.freed == []

    def test_event_data_layout(self):
        assert ctypes.sizeof(dl._NvmlEventData) == 32


# --------------------------------------------------------------------------
# driver_probe
# --------------------------------------------------------------------------

class TestDriverProbe:
    def test_serving_and_gates(self, cluster):
        _client, driver, _lib = cluster

        class Drainer:
            draining = False

        drainer, fenced = Drainer(), [False]
        assert driver_probe(driver) == STATUS_SERVING
        assert driver_probe(driver, drainer,
                            fenced=lambda: fenced[0]) == STATUS_SERVING
        drainer.draining = True
        assert driver_probe(driver, drainer) == STATUS_NOT_SERVING
        drainer.draining = False
        fenced[0] = True
        assert driver_probe(driver, drainer,
                            fenced=lambda: fenced[0]) == STATUS_NOT_SERVING

    def test_crashing_gate_is_not_serving(self, cluster):
        _client, driver, _lib = cluster

        def boom():
            raise RuntimeError("gate down")

        assert driver_probe(driver, fenced=boom) == STATUS_NOT_SERVING

    def test_corrupt_checkpoint_is_not_serving(self, cluster):
        _client, driver, _lib = cluster
        with open(driver.state.checkpoints.path, "w") as f:
            f.write("{torn")
        assert driver_probe(driver) == STATUS_NOT_SERVING

    def test_unregistered_is_not_serving(self, cluster):
        _client, driver, _lib = cluster
        driver.stop()
        assert driver_probe(driver) == STATUS_NOT_SERVING

    def test_probe_not_blocked_by_prepare_flock(self, cluster):
        """The probe reads the checkpoint without the node flock: a
        prepare holding it does not make the plugin look dead."""
        _client, driver, _lib = cluster
        with driver.state.lock.held(timeout=5.0):
            t0 = time.monotonic()
            assert driver_probe(driver) == STATUS_SERVING
            assert time.monotonic() - t0 < 1.0


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------

_KEYS = {"tpu.google.com/ecc": "ecc", "tpu.google.com/chip-lost": "lost",
         "tpu.google.com/interrupt": "xid", "gpu.nvidia.com/ecc": "ecc",
         "gpu.nvidia.com/gpu-lost": "lost", "gpu.nvidia.com/xid": "xid"}
_EVENTS = {"ecc": "ecc", "chip-lost": "lost", "gpu-lost": "lost",
           "interrupt": "xid", "xid": "xid", "recovered": "recovered"}


def _jax_side(tmp_path):
    client = JaxFakeClient()
    client.create(jax_new_object(
        "DeviceClass", "tpu.google.com",
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'tpu'"}}]}))
    lib = JaxMockDeviceLib("v5e-8")
    driver = TpuDriver(client, JaxDriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "jax-state"),
        cdi_root=str(tmp_path / "jax-cdi"), env={}, retry_timeout=0.5),
        device_lib=lib).start()
    return (client, driver, lib, jax_attach_health_monitor(
        driver, start=False), "enumerate_chips", jax_list_events)


def _port_side(tmp_path):
    client, driver, lib = (FakeClient(), None, dl.MockDeviceLib("h100-8"))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=0.5),
        device_lib=lib).start()
    return (client, driver, lib, attach_health_monitor(driver, start=False),
            "enumerate_gpus", list_events)


def _scenario(seed):
    """A seeded run of health steps on 8 devices: faults with and
    without ECC, recoveries, and vanishes of 1 poll (inside the grace
    window) and 2 polls (past it)."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(12):
        i = int(rng.integers(0, 8))
        kind = ["ecc", "xid", "heal", "flap", "vanish"][int(rng.integers(5))]
        steps.append((kind, i))
    return steps


def _drive(side, steps):
    client, driver, lib, monitor, enum_name, events_of = side
    real = getattr(lib, enum_name)
    gone: dict = {}

    def enumerate_now():
        return [g for g in real() if g.index not in gone]

    setattr(lib, enum_name, enumerate_now)
    trace = []
    monitor.poll_once()
    for kind, i in steps:
        if kind == "ecc":
            lib.set_unhealthy(i, "ecc", ecc_errors=2)
        elif kind == "xid":
            lib.set_unhealthy(i, "fault")
        elif kind == "heal":
            lib.set_healthy(i)
        polls = 2 if kind == "vanish" else 1
        if kind in ("flap", "vanish"):
            gone[i] = True
        for _ in range(polls):
            evs = monitor.poll_once()
            trace.append(sorted((e.device.split("-")[1],
                                 _EVENTS[e.event_type]) for e in evs))
        gone.pop(i, None)
        evs = monitor.poll_once()
        trace.append(sorted((e.device.split("-")[1], _EVENTS[e.event_type])
                            for e in evs))
        devices = client.list("ResourceSlice")[0]["spec"]["devices"]
        trace.append(sorted(
            (d["name"].split("-")[1], _KEYS[t["key"]])
            for d in devices if d["name"].split("-")[0] in ("tpu", "gpu")
            for t in d.get("taints") or []))
    reasons = [e["reason"] for e in sorted(
        events_of(client), key=lambda e: int(
            e["metadata"]["resourceVersion"]))]
    return trace, reasons


class TestAgainstJax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_health_steps_match(self, tmp_path, seed):
        steps = _scenario(seed)
        jax_trace, jax_reasons = _drive(_jax_side(tmp_path), steps)
        port_trace, port_reasons = _drive(_port_side(tmp_path), steps)
        assert port_trace == jax_trace
        assert port_reasons == jax_reasons

    def test_vanish_flap_inside_grace_window(self, tmp_path):
        """One poll absent, then back: neither package taints, drains or
        emits an event."""
        steps = [("flap", 3), ("flap", 6)]
        jax_trace, jax_reasons = _drive(_jax_side(tmp_path), steps)
        port_trace, port_reasons = _drive(_port_side(tmp_path), steps)
        assert port_trace == jax_trace
        assert all(t == [] for t in port_trace)
        assert port_reasons == jax_reasons == []
