"""ComputeDomain DRA kubelet plugin driver.

Copied from the JAX package's ``plugins/compute_domain_kubelet_plugin/
driver.py`` onto the GPU device library. The analogue of ``cmd/compute-domain-kubelet-plugin/driver.go``: ``NewDriver``
:89 (state + helper assembly, Serialize(false) because channel prepare is
codependent — the first Prepare only completes after the controller's
DaemonSet reacts to the node label that same Prepare applied),
``PrepareResourceClaims`` :178-207 (45 s retry-until-deadline through the
rate-limited workqueue, permanent errors short-circuit),
``publishResources`` (channel-0 + daemon device per node).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

from k8s_dra_driver_tpu_torch.cdi.spec import CDIHandler
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    DeviceLib,
    enforce_fabric_consistency,
    new_device_lib,
)
from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient, Obj
from k8s_dra_driver_tpu_torch.kubeletplugin import (
    DriverResources,
    Helper,
    Pool,
    PrepareResult,
    Slice,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import set_ready
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef, claim_uid
from k8s_dra_driver_tpu_torch.pkg import bootid, sanitizer
from k8s_dra_driver_tpu_torch.pkg.errors import StaleAbortedClaimError
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_PREPARE_FAILED,
    REASON_UNPREPARE_FAILED,
    TYPE_WARNING,
    EventRecorder,
)
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    CRASH_ON_NVLINK_FABRIC_ERRORS,
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
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.computedomain import (
    MASTER_PORT,
    ComputeDomainManager,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.device_state import (
    CdDeviceState,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.devices import (
    CD_DRIVER_NAME,
    published_devices,
)

logger = logging.getLogger(__name__)

ERROR_RETRY_MAX_TIMEOUT = 45.0
PU_LOCK_NAME = "pu.lock"
CHECKPOINT_NAME = "checkpoint.json"


@dataclass
class CdDriverConfig:
    node_name: str
    state_dir: str
    cdi_root: str
    namespace: Optional[str] = None
    driver_namespace: Optional[str] = None
    feature_gates: Optional[FeatureGates] = None
    env: Optional[dict[str, str]] = None
    retry_timeout: float = ERROR_RETRY_MAX_TIMEOUT
    channel_count: Optional[int] = None
    clock: Optional[object] = None
    sleep: Optional[object] = None
    # The port every channel claim's MASTER_PORT names (cluster-wide).
    master_port: int = MASTER_PORT


class CdDriver:
    """One per node, alongside the GPU plugin (the two-container node
    DaemonSet model, kubeletplugin.yaml:88,211)."""

    def __init__(
        self,
        client: FakeClient,
        config: CdDriverConfig,
        device_lib: Optional[DeviceLib] = None,
        metrics: Optional[DRAMetrics] = None,
    ):
        self.client = client
        self.config = config
        self.gates = config.feature_gates or new_feature_gates()
        validate_gate_dependencies(self.gates)
        env = dict(os.environ if config.env is None else config.env)
        self.device_lib = device_lib or new_device_lib(env)
        self.metrics = metrics or DRAMetrics()
        self.pool_name = config.node_name
        self.cdi = CDIHandler(config.cdi_root, device_class="cd-claim")
        self.cd_manager = ComputeDomainManager(
            client=client,
            node_name=config.node_name,
            node_info=self.device_lib.node_info(),
            namespace=config.namespace,
            gates=self.gates,
            domains_root=os.path.join(config.state_dir, "domains"),
            driver_namespace=config.driver_namespace,
            master_port=config.master_port,
        )
        kwargs = {}
        if config.clock is not None:
            kwargs["clock"] = config.clock
        self.events = EventRecorder(client, "compute-domain-kubelet-plugin",
                                    host=config.node_name)
        self.state = CdDeviceState(
            cdi=self.cdi,
            cd_manager=self.cd_manager,
            checkpoint_path=os.path.join(config.state_dir, CHECKPOINT_NAME),
            lock_path=os.path.join(config.state_dir, PU_LOCK_NAME),
            node_boot_id=bootid.read_boot_id(env),
            pool_name=self.pool_name,
            gates=self.gates,
            channel_count=config.channel_count,
            metrics=self.metrics,
            events=self.events,
            **kwargs,
        )
        self.helper = Helper(client, CD_DRIVER_NAME, config.node_name, self)
        self._generation = 1
        # Node-scope cordon flag + publication serialization
        # (docs/self-healing.md, "Whole-node repair"): the drain
        # controller's poll thread (set_cordon/clear_cordon) and the
        # lease heartbeat's fence-cleanup republish race the generation
        # bump — interleaved publishes could let a later generation
        # carry an older device view (e.g. win without the cordon
        # taint). Mirrors GpuDriver._taints_mu.
        self._publish_mu = sanitizer.new_lock("CdDriver._publish_mu")
        self._cordon_reason: Optional[str] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "CdDriver":
        self.helper.start()
        # Fabric agreement before advertising identity: a clique label from
        # a miscabled node would draw CD daemons onto a broken domain.
        try:
            enforce_fabric_consistency(
                self.device_lib.enumerate_gpus(),
                strict=self.gates.enabled(CRASH_ON_NVLINK_FABRIC_ERRORS))
        except BaseException:
            self.helper.stop()
            raise
        # Advertise this node's clique before any CD can target it.
        self.cd_manager.set_clique_label()
        self.publish_resources()
        return self

    def stop(self, unpublish: bool = False) -> None:
        if unpublish:
            self.helper.unpublish_resources()
        self.helper.stop()

    # -- resource publication --------------------------------------------------

    def generate_driver_resources(self) -> DriverResources:
        devices = published_devices(
            self.state.allocatable,
            self.cd_manager.node_info,
            host_managed=self.state.host_managed,
        )
        if self._cordon_reason:
            apply_cordon_taint(devices, self._cordon_reason)
        return DriverResources(pools={
            self.pool_name: Pool(
                generation=self._generation,
                slices=[Slice(devices=devices)],
            )
        })

    def publish_resources(self) -> None:
        self.helper.publish_resources(self.generate_driver_resources())

    def republish(self) -> None:
        """Regenerate with a generation bump and publish — the cordon /
        uncordon and fence-rejoin paths' one-write publication,
        serialized so concurrent republishers cannot interleave a newer
        generation with an older device view."""
        with self._publish_mu:
            self._republish_locked()

    def _republish_locked(self) -> None:
        self._generation += 1
        self.publish_resources()

    # -- DRA plugin interface --------------------------------------------------

    def _queue(self) -> WorkQueue:
        kwargs = {}
        if self.config.clock is not None:
            kwargs["clock"] = self.config.clock
        if self.config.sleep is not None:
            kwargs["sleep"] = self.config.sleep
        # Named per plugin so the shared workqueue metric family keeps the
        # GPU and CD request queues' histograms apart.
        return WorkQueue(default_prep_unprep_rate_limiter(),
                         name="cd-requests", **kwargs)

    def prepare_resource_claims(
            self, claims: list[Obj]) -> dict[str, PrepareResult]:
        with self.metrics.timed_request(CD_DRIVER_NAME, "prepare"):
            q = self._queue()
            for claim in claims:
                q.enqueue(claim_uid(claim), claim, self.state.prepare,
                          rate_limited=False)
            results, errors = q.run_until_deadline(self.config.retry_timeout)
        out: dict[str, PrepareResult] = {}
        for uid, refs in results.items():
            out[uid] = PrepareResult(devices=refs)
        by_uid = {claim_uid(c): c for c in claims}
        for uid, err in errors.items():
            self.metrics.node_prepare_errors_total.inc(
                driver=CD_DRIVER_NAME, error_type=type(err).__name__)
            if uid in by_uid:
                self.events.event(by_uid[uid], REASON_PREPARE_FAILED,
                                  f"node prepare failed: {err}", TYPE_WARNING)
            out[uid] = PrepareResult(error=err)
        self._update_prepared_gauge()
        return out

    def unprepare_resource_claims(
            self, refs: list[ClaimRef]) -> dict[str, Optional[Exception]]:
        with self.metrics.timed_request(CD_DRIVER_NAME, "unprepare"):
            q = self._queue()
            for ref in refs:
                q.enqueue(ref.uid, ref, self._unprepare_one,
                          rate_limited=False)
            results, errors = q.run_until_deadline(self.config.retry_timeout)
        out: dict[str, Optional[Exception]] = {uid: None for uid in results}
        by_uid = {r.uid: r for r in refs}
        for uid, err in errors.items():
            self.metrics.node_unprepare_errors_total.inc(
                driver=CD_DRIVER_NAME, error_type=type(err).__name__)
            if uid in by_uid:
                self.events.event_for_claim_ref(
                    by_uid[uid], REASON_UNPREPARE_FAILED,
                    f"node unprepare failed: {err}")
            out[uid] = err
        self._update_prepared_gauge()
        return out

    def _unprepare_one(self, ref: ClaimRef) -> None:
        self.state.unprepare(ref)

    def resolve_drained_claims(
            self, claims: list[Obj]) -> dict[str, Optional[Exception]]:
        """The claim watcher's resolution of a stale prepare of a claim
        allocated again to the devices it was drained off: drop each
        claim's drain tombstone (``CdDeviceState.resolve_drained``). The
        unprepare of a tombstone stays a no-op here, as in the reference,
        so the resolution cannot go through it. A claim whose tombstone is
        a rolled-back prepare's maps to a StaleAbortedClaimError: it stays
        refused until the GC expires it."""
        out: dict[str, Optional[Exception]] = {}
        for claim in claims:
            uid = claim_uid(claim)
            try:
                out[uid] = None if self.state.resolve_drained(claim) else \
                    StaleAbortedClaimError(
                        f"claim {uid}: its tombstone is a rolled-back "
                        "prepare's, not a drain's")
            except Exception as e:  # noqa: BLE001 — reported per claim,
                # like the request methods' errors; the watcher retries.
                out[uid] = e
        return out

    # -- remediation surface (kubeletplugin/remediation.py wiring) -------------

    def drain_claim(self, ref: ClaimRef, reason: str = "") -> bool:
        """Gracefully unprepare one claim with a PrepareAborted tombstone —
        the node-repair drain path (docs/self-healing.md); CD channel
        devices carry no health taints of their own, so drains arrive here
        through node-level remediation, not a taint poll. The claim's Ready
        status entries of this node are retracted first (``Ready: False``,
        reason ``Drained``), under the claim's flight lock, so that Ready
        never outlives the prepared record (CdDeviceState.drain)."""
        drained = self.state.drain(
            ref, reason=reason,
            retract=lambda: set_ready(self.client, ref, CD_DRIVER_NAME,
                                      self.pool_name, False))
        if drained:
            self._update_prepared_gauge()
        return drained

    def adopt_boot_id(self, new_id: str) -> None:
        """Companion wiring for simulated node repair: when the node's boot
        id flips, every plugin on the node adopts it, exactly as a real
        reboot re-bootstraps each."""
        self.state.adopt_boot_id(new_id)

    @property
    def cordoned(self) -> bool:
        with self._publish_mu:
            return self._cordon_reason is not None

    def set_cordon(self, reason: str = "cordoned") -> bool:
        """Node-scope cordon (see GpuDriver.set_cordon): every channel/
        daemon device leaves the allocatable pool in one republish."""
        with self._publish_mu:
            if self._cordon_reason == reason:
                return False
            prev = self._cordon_reason
            self._cordon_reason = reason
            try:
                self._republish_locked()
            except BaseException:
                self._cordon_reason = prev
                raise
        return True

    def clear_cordon(self) -> bool:
        with self._publish_mu:
            if self._cordon_reason is None:
                return False
            prev = self._cordon_reason
            self._cordon_reason = None
            try:
                self._republish_locked()
            except BaseException:
                self._cordon_reason = prev
                raise
        return True

    def all_prepared_claims(self) -> list[ClaimRef]:
        """Every live (non-tombstoned) prepared claim — the node-scope
        drain's work list for this plugin."""
        return live_prepared_refs(self.state)

    def _update_prepared_gauge(self) -> None:
        by_type = {"channel": 0, "daemon": 0}
        try:
            prepared = self.state.prepared_claims_nolock()
        except Exception:  # noqa: BLE001 — see GpuDriver._update_prepared_gauge
            logger.warning("prepared-devices gauge: checkpoint unreadable")
            return
        for pc in prepared.values():
            for d in pc.prepared_devices:
                t = "daemon" if d.get("device") == "daemon" else "channel"
                by_type[t] += 1
        for dtype, n in by_type.items():
            self.metrics.prepared_devices.set(
                n, node=self.config.node_name, driver=CD_DRIVER_NAME,
                device_type=dtype)
