"""GPU DRA driver: resource generation, publication, claim dispatch.

Copied from the JAX package's ``plugins/tpu_kubelet_plugin/driver.py`` and
cut to whole GPUs: the MIG and passthrough gates raise at assembly
(``validate_gate_dependencies``). The taint surface is driven by the health
monitor (``health.attach_health_monitor``) and the drain surface
(``device_healthy`` … ``rejoin_device``) by the drain controller
(``kubeletplugin/remediation.py``). As there, the analogue of the reference's driver core (``cmd/gpu-kubelet-plugin/
driver.go``): ``NewDriver`` :70 (assembly), ``GenerateDriverResources``
:190-307 (flat vs KEP-4815 partitionable slices), ``PrepareResourceClaims``
:344-443 (batch dispatch with per-claim flock + metrics + phase timings),
``publishResources`` :462-501. The retry-until-deadline batch semantics
come from the CD plugin (``cmd/compute-domain-kubelet-plugin/driver.go:
60-80,178-207``) — the GPU plugin gained them too via the shared workqueue.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

from k8s_dra_driver_tpu_torch.cdi.spec import CDIHandler
from k8s_dra_driver_tpu_torch.gpulib.chip import HealthState
from k8s_dra_driver_tpu_torch.gpulib.device_lib import DeviceLib, new_device_lib
from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient, Obj
from k8s_dra_driver_tpu_torch.kubeletplugin import (
    Device,
    DriverResources,
    Helper,
    Pool,
    PrepareResult,
    Slice,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef, DeviceTaint, claim_uid
from k8s_dra_driver_tpu_torch.pkg import bootid, sanitizer, tracing
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_DEVICE_TAINTED,
    REASON_PREPARE_FAILED,
    REASON_UNPREPARE_FAILED,
    TYPE_WARNING,
    EventRecorder,
)
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    DRA_LIST_TYPE_ATTRIBUTES,
    FeatureGates,
    new_feature_gates,
    validate_gate_dependencies,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import DRAMetrics
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    apply_cordon_taint,
    live_prepared_refs,
)
from k8s_dra_driver_tpu_torch.pkg.workqueue import (
    WorkQueue,
    default_prep_unprep_rate_limiter,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import partitions
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
    DeviceState,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health import (
    HEALTH_TAINT_KEYS,
)

logger = logging.getLogger(__name__)

# Retry budget per kubelet Prepare/Unprepare call (cd driver.go:61-66).
ERROR_RETRY_MAX_TIMEOUT = 45.0
PU_LOCK_NAME = "pu.lock"
CHECKPOINT_NAME = "checkpoint.json"


def _log_request(operation: str, errors: dict) -> None:
    """One line per Prepare/Unprepare request, each claim UID with its
    outcome: the per-claim record behind ``gpu_dra_requests_total``, which
    counts requests (an idempotent republish or a retry is one more)."""
    logger.info("%s request: %s", operation, " ".join(
        f"{uid}={'ok' if err is None else 'failed'}"
        for uid, err in errors.items()))


@dataclass
class DriverConfig:
    node_name: str
    state_dir: str                   # checkpoint + locks live here
    cdi_root: str
    feature_gates: Optional[FeatureGates] = None
    env: Optional[dict[str, str]] = None
    retry_timeout: float = ERROR_RETRY_MAX_TIMEOUT


class GpuDriver:
    """One per node. Implements the DRAPlugin protocol for the Helper."""

    def __init__(
        self,
        client: FakeClient,
        config: DriverConfig,
        device_lib: Optional[DeviceLib] = None,
        metrics: Optional[DRAMetrics] = None,
    ):
        self.config = config
        self.gates = config.feature_gates or new_feature_gates()
        validate_gate_dependencies(self.gates)
        env = dict(os.environ if config.env is None else config.env)
        self.device_lib = device_lib or new_device_lib(env)
        self.metrics = metrics or DRAMetrics()
        self.pool_name = config.node_name
        self.cdi = CDIHandler(config.cdi_root)
        self.state = DeviceState(
            device_lib=self.device_lib,
            cdi=self.cdi,
            checkpoint_path=os.path.join(config.state_dir, CHECKPOINT_NAME),
            lock_path=os.path.join(config.state_dir, PU_LOCK_NAME),
            node_boot_id=bootid.read_boot_id(env),
            pool_name=self.pool_name,
            gates=self.gates,
            metrics=self.metrics,
        )
        self.state.sweep_unknown_claim_artifacts()
        # Operator-facing transitions become durable Event objects
        # (docs/observability.md); recording is fire-and-forget.
        self.events = EventRecorder(client, "gpu-kubelet-plugin",
                                    host=config.node_name)
        self.helper = Helper(client, DRIVER_NAME, config.node_name, self)
        self._generation = 1
        # Taint state is touched from more than one thread (the health
        # monitor's and the drain controller's polls): the RMW in
        # update_device_taints, the snapshot in device_taints, and the
        # publication read all serialize here. Reentrant because
        # update_device_taints republishes (→ generate_driver_resources)
        # while holding it.
        self._taints_mu = sanitizer.new_lock("GpuDriver._taints_mu",
                                             reentrant=True)
        self._taints: dict[str, list[DeviceTaint]] = sanitizer.track_state(
            {}, "GpuDriver._taints")
        # Node-scope cordon (docs/self-healing.md, "Whole-node repair"):
        # while set, every published device carries the NoSchedule cordon
        # taint, excluding the whole node from new allocations in one
        # republish. Guarded by _taints_mu like the per-device taints.
        self._cordon_reason: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "GpuDriver":
        self.helper.start()
        self.publish_resources()
        return self

    def stop(self, unpublish: bool = False) -> None:
        if unpublish:
            self.helper.unpublish_resources()
        self.helper.stop()

    # -- resource generation (GenerateDriverResources, driver.go:190-307) ----

    def generate_driver_resources(self) -> DriverResources:
        """One device per GPU, with its taints and, while the node is
        cordoned, the cordon taint on every device."""
        list_attrs = self.gates.enabled(DRA_LIST_TYPE_ATTRIBUTES)
        devices: list[Device] = [
            partitions.full_gpu_device(g, list_type_attrs=list_attrs)
            for g in self.state.gpus
        ]
        # One snapshot under the lock: the taint surface may be mutated
        # from another thread.
        taint_snapshot = self.device_taints()
        for d in devices:
            taints = taint_snapshot.get(d.name)
            if taints:
                d.taints = list(taints)
        with self._taints_mu:
            cordon_reason = self._cordon_reason
        if cordon_reason:
            # Node-scope cordon: EVERY device is excluded in this one
            # publication.
            apply_cordon_taint(devices, cordon_reason)
        return DriverResources(pools={
            self.pool_name: Pool(
                generation=self._generation,
                slices=[Slice(devices=devices)],
            )
        })

    def publish_resources(self) -> None:
        self.helper.publish_resources(self.generate_driver_resources())

    def republish(self) -> None:
        """Regenerate (with a generation bump) and publish — used after
        health-taint changes and enumeration refreshes."""
        self._generation += 1
        self.state.refresh_enumeration()
        self.publish_resources()

    # -- device taints (consumed by the health monitor, driver.go:503-575) ---

    def update_device_taints(
        self,
        device: str,
        add: Optional[DeviceTaint] = None,
        clear_keys: tuple[str, ...] = (),
    ) -> bool:
        """Apply a taint change atomically with ONE republish: optionally
        remove keys, optionally add/replace one taint. No-op changes skip
        the republish entirely. Returns whether anything changed (and hence
        a republish happened) — consumers that need publication refreshed
        regardless (e.g. a replacement GPU appearing untainted) call
        republish() themselves on False.

        Serialized on ``_taints_mu`` (held through the republish): the
        health monitor and the drain controller race here, and a re-taint
        landing between an unlocked rejoin-clear's read and write would be
        silently lost."""
        with self._taints_mu:
            current = list(self._taints.get(device, []))
            updated = [t for t in current
                       if t.key not in clear_keys
                       and (add is None or t.key != add.key)]
            if add is not None:
                updated.append(add)
            if [t.key for t in updated] == [t.key for t in current] and (
                    add is None or add in current):
                return False  # nothing changed
            prev = self._taints.get(device)
            if updated:
                self._taints[device] = updated
            else:
                self._taints.pop(device, None)
            try:
                self.republish()
            except BaseException:
                # Roll the in-memory change back so a retry is not
                # swallowed by the nothing-changed early return while the
                # published slices still miss the taint.
                if prev is None:
                    self._taints.pop(device, None)
                else:
                    self._taints[device] = prev
                raise
        if add is not None:
            # A taint landing on a published device is the start of the
            # self-healing pipeline — the durable, operator-facing record
            # the drain controller's Events chain from.
            self.events.event_for_ref(
                self._node_ref(), REASON_DEVICE_TAINTED,
                f"device {device} tainted: {add.key}={add.value} "
                f"({add.effect})", TYPE_WARNING)
        return True

    def set_device_taint(self, device: str, taint: DeviceTaint) -> None:
        self.update_device_taints(device, add=taint)

    def clear_device_taint(self, device: str, key: str) -> None:
        self.update_device_taints(device, clear_keys=(key,))

    def _node_ref(self) -> dict:
        return {"apiVersion": "v1", "kind": "Node",
                "name": self.config.node_name, "namespace": "", "uid": ""}

    def device_taints(self) -> dict[str, list[DeviceTaint]]:
        """Snapshot of the current per-device taints — the drain
        controller's poll source and the publication read (both race the
        monitor's mutations)."""
        with self._taints_mu:
            return {dev: list(taints)
                    for dev, taints in self._taints.items()}

    # -- remediation surface (kubeletplugin/remediation.py wiring) -----------

    def device_healthy(self, device: str) -> bool:
        """Freshest health read for one GPU device (drain-cancel and
        rejoin decisions read through the device lib, not the enumeration
        snapshot, which lags a refresh). A vanished GPU is unhealthy."""
        try:
            for gpu in self.device_lib.enumerate_gpus():
                if gpu.canonical_name == device:
                    health = self.device_lib.gpu_health(gpu)
                    return (health.state == HealthState.HEALTHY
                            and gpu.health.state == HealthState.HEALTHY)
        except Exception:  # noqa: BLE001 — cannot confirm healthy
            return False
        return False

    def affected_claims(self, device: str) -> list[ClaimRef]:
        """Prepared claims whose devices cover ``device``."""
        return self.state.claims_holding_device(device)

    def claim_device_count(self, ref: ClaimRef) -> int:
        """Physical GPUs held by a prepared claim — the drain controller's
        smallest-first priority key."""
        return self.state.claim_device_count(ref.uid)

    def drain_claim(self, ref: ClaimRef, reason: str = "") -> bool:
        """Gracefully unprepare one claim, leaving a crash-safe
        PrepareAborted tombstone (DeviceState.drain)."""
        drained = self.state.drain(ref, reason=reason)
        if drained:
            self._update_prepared_gauge()
        return drained

    def rejoin_device(self, device: str) -> bool:
        """Repair-complete side of the pipeline: re-enumerate, verify the
        GPU is back and healthy, and clear every health taint in ONE
        republish so the device rejoins the published ResourceSlice.
        Returns False (retry next poll) while the GPU is still bad."""
        if not self.device_healthy(device):
            return False
        if not self.update_device_taints(device,
                                         clear_keys=HEALTH_TAINT_KEYS):
            # Taints already cleared (health monitor observed the recovery
            # first): the repaired GPU still needs a re-enumerated publish.
            self.republish()
        return True

    def adopt_boot_id(self, new_id: str) -> None:
        self.state.adopt_boot_id(new_id)

    # -- node-scope cordon (docs/self-healing.md, "Whole-node repair") -------

    @property
    def cordoned(self) -> bool:
        with self._taints_mu:
            return self._cordon_reason is not None

    def set_cordon(self, reason: str = "cordoned") -> bool:
        """Taint every published device NoSchedule in ONE republish —
        the node leaves the allocatable pool wholesale. Idempotent;
        returns whether anything changed."""
        with self._taints_mu:
            if self._cordon_reason == reason:
                return False
            prev = self._cordon_reason
            self._cordon_reason = reason
            try:
                self.republish()
            except BaseException:
                self._cordon_reason = prev
                raise
        return True

    def clear_cordon(self) -> bool:
        """Drop the cordon taint from every device in one republish —
        the rejoin half of a voluntary cordon. Idempotent."""
        with self._taints_mu:
            if self._cordon_reason is None:
                return False
            prev = self._cordon_reason
            self._cordon_reason = None
            try:
                self.republish()
            except BaseException:
                self._cordon_reason = prev
                raise
        return True

    def all_prepared_claims(self) -> list[ClaimRef]:
        """Every live (non-tombstoned) prepared claim — the node-scope
        drain's work list (a whole-node cordon drains everything, not
        just claims covering one tainted device)."""
        return live_prepared_refs(self.state)

    # -- DRA plugin interface ------------------------------------------------

    def _queue(self) -> WorkQueue:
        # Named per plugin so the shared workqueue metric family keeps the
        # plugins' request queues' histograms apart.
        return WorkQueue(default_prep_unprep_rate_limiter(),
                         name="gpu-requests")

    def prepare_resource_claims(
        self, claims: list[Obj]) -> dict[str, PrepareResult]:
        """Batch prepare with retry-until-deadline semantics: retryable
        failures back off through the workqueue within a 45 s budget;
        permanent errors short-circuit (cd driver.go:178-207)."""
        # The batch's claim trace becomes the duration histogram's
        # exemplar (docs/observability.md, "Trace exemplars"): extracted
        # from the annotation because the per-claim spans have ended by
        # the time the batch timer observes.
        ctx = tracing.extract(claims[0]) if claims else None
        with self.metrics.timed_request(
                DRIVER_NAME, "prepare",
                trace_id=ctx.trace_id if ctx is not None else ""):
            q = self._queue()
            for claim in claims:
                # First attempt immediate; only retries pay backoff (beats
                # the reference's AddRateLimited-on-first-enqueue, which
                # eats the full 250 ms base delay before attempt one).
                q.enqueue(claim_uid(claim), claim, self._prepare_one,
                          rate_limited=False)
            results, errors = q.run_until_deadline(self.config.retry_timeout)
        out: dict[str, PrepareResult] = {}
        for uid, refs in results.items():
            out[uid] = PrepareResult(devices=refs)
        by_uid = {claim_uid(c): c for c in claims}
        for uid, err in errors.items():
            self.metrics.node_prepare_errors_total.inc(
                driver=DRIVER_NAME, error_type=type(err).__name__)
            if uid in by_uid:
                self.events.event(by_uid[uid], REASON_PREPARE_FAILED,
                                  f"node prepare failed: {err}", TYPE_WARNING)
            out[uid] = PrepareResult(error=err)
        self._update_prepared_gauge()
        _log_request("prepare", {u: r.error for u, r in out.items()})
        return out

    def _prepare_one(self, claim: Obj):
        # One span per attempt wrapping the whole driver-side prepare
        # (flight-lock wait included): its duration IS the old
        # t_prep_total log line, now attributable inside the claim's
        # trace — and inside incident bundles — instead of a throwaway
        # debug line (docs/observability.md).
        with tracing.span_for_object(
                "driver_prepare", claim,
                attributes={"driver": DRIVER_NAME,
                            "claim": claim_uid(claim)}):
            return self.state.prepare(claim)

    def unprepare_resource_claims(
        self, refs: list[ClaimRef]) -> dict[str, Optional[Exception]]:
        with self.metrics.timed_request(DRIVER_NAME, "unprepare"):
            q = self._queue()
            for ref in refs:
                q.enqueue(ref.uid, ref, self._unprepare_one,
                          rate_limited=False)
            results, errors = q.run_until_deadline(self.config.retry_timeout)
        out: dict[str, Optional[Exception]] = {uid: None for uid in results}
        by_uid = {r.uid: r for r in refs}
        for uid, err in errors.items():
            self.metrics.node_unprepare_errors_total.inc(
                driver=DRIVER_NAME, error_type=type(err).__name__)
            if uid in by_uid:
                self.events.event_for_claim_ref(
                    by_uid[uid], REASON_UNPREPARE_FAILED,
                    f"node unprepare failed: {err}")
            out[uid] = err
        self._update_prepared_gauge()
        _log_request("unprepare", out)
        return out

    def _unprepare_one(self, ref: ClaimRef) -> None:
        self.state.unprepare(ref)

    def _update_prepared_gauge(self) -> None:
        n = 0
        try:
            # Lock-free snapshot: a gauge refresh must not queue behind a
            # concurrent batch commit's flock (atomic writes keep the
            # unlocked read consistent, at most one commit stale).
            prepared = self.state.prepared_claims_nolock()
        except Exception:  # noqa: BLE001 — a bad checkpoint already failed
            # the request itself; the gauge must not mask that error with
            # its own crash.
            logger.warning("prepared-devices gauge: checkpoint unreadable")
            return
        for pc in prepared.values():
            n += len(pc.prepared_devices)
        self.metrics.prepared_devices.set(
            n, node=self.config.node_name, driver=DRIVER_NAME,
            device_type=partitions.DEVICE_TYPE_GPU)
