"""ComputeDomain plugin device state: the PrepareAborted-aware checkpoint
state machine plus channel/daemon prepare paths.

Copied from the JAX package's ``plugins/compute_domain_kubelet_plugin/
device_state.py`` onto the GPU plugin's checkpoint. The analogue of ``cmd/compute-domain-kubelet-plugin/device_state.go``:
``Prepare`` :187 (idempotency, stale-aborted rejection, overlap check),
``Unprepare`` :264 (Completed → delete; Started → rollback + short-lived
PrepareAborted entry so stale prepare retries cannot resurrect state after
unprepare; Aborted → noop), ``markClaimPrepareAbortedInCheckpoint`` :430,
``deleteExpiredPrepareAbortedClaimsFromCheckpoint`` :448,
``assertImexChannelNotAllocated`` :878, and the three config-apply paths
(``applyComputeDomainChannelConfig{DriverManaged,HostManaged}`` :647/:690,
``applyComputeDomainDaemonConfig`` :735).

Channel prepare injects the node's torch.distributed rendezvous env instead
of IMEX channel device nodes; see
``computedomain.ComputeDomainManager.worker_env``.

Concurrency model mirrors the GPU plugin's ``DeviceState``
(docs/performance.md): same-claim operations serialize on a per-claim
in-flight lock, disjoint claims overlap, and every cross-claim invariant
(idempotency, stale-aborted rejection, channel-overlap validation, the
PrepareStarted registration) lives inside one group-committed checkpoint
transaction so concurrent claims validate against each other's records.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Optional

from k8s_dra_driver_tpu_torch.api.configs import (
    ALLOCATION_MODE_ALL,
    ComputeDomainChannelConfig,
    ComputeDomainDaemonConfig,
    ConfigError,
    strict_decode,
)
from k8s_dra_driver_tpu_torch.cdi.spec import CDIDevice, CDIHandler
from k8s_dra_driver_tpu_torch.k8sclient.client import Obj
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import (
    REASON_UNPREPARING,
    set_ready,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
    ClaimRef,
    PreparedDeviceRef,
    claim_allocation_configs,
    claim_allocation_results,
    claim_uid,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints, tracing
from k8s_dra_driver_tpu_torch.pkg.errors import (
    PermanentError,
    StaleAbortedClaimError,
)
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_PREPARE_ABORTED,
    TYPE_WARNING,
    EventRecorder,
)
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    HOST_MANAGED_RENDEZVOUS,
    FeatureGates,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.pkg.flock import Flock
from k8s_dra_driver_tpu_torch.pkg.inflight import ClaimFlightTable
from k8s_dra_driver_tpu_torch.pkg.metrics import DRAMetrics
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.computedomain import (
    ComputeDomainManager,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.devices import (
    CD_DRIVER_NAME,
    CHANNEL_TYPE,
    DAEMON_TYPE,
    AllocatableDevice,
    enumerate_devices,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
    STATE_PREPARE_STARTED,
    Checkpoint,
    CheckpointError,
    CheckpointManager,
    PreparedClaimCP,
    bootstrap_checkpoint,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    FP_PREPARE,
    OverlapError,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.prepared import (
    PreparedDevice,
)

logger = logging.getLogger(__name__)

# How long an aborted-claim tombstone lingers before GC. Long enough to
# outlive any in-flight kubelet prepare retry for the dead claim version,
# short enough not to accumulate (cleanup.go TTL semantics).
PREPARE_ABORTED_TTL = 10 * 60.0


class CdDeviceState:
    """Checkpoint + prepare/unprepare for channel and daemon devices."""

    def __init__(
        self,
        cdi: CDIHandler,
        cd_manager: ComputeDomainManager,
        checkpoint_path: str,
        lock_path: str,
        node_boot_id: str = "",
        pool_name: str = "",
        driver_name: str = CD_DRIVER_NAME,
        gates: Optional[FeatureGates] = None,
        channel_count: Optional[int] = None,
        aborted_ttl: float = PREPARE_ABORTED_TTL,
        clock: Callable[[], float] = time.time,
        metrics: Optional[DRAMetrics] = None,
        events: Optional[EventRecorder] = None,
    ):
        self.cdi = cdi
        self.cd_manager = cd_manager
        self.lock = Flock(lock_path)
        self.metrics = metrics
        self.checkpoints = CheckpointManager(
            checkpoint_path, flock=self.lock, on_batch=self._observe_batch)
        self.node_boot_id = node_boot_id
        self.pool_name = pool_name
        self.driver_name = driver_name
        self.gates = gates or new_feature_gates()
        self.aborted_ttl = aborted_ttl
        self.clock = clock
        self.events = events
        self._flights = ClaimFlightTable(
            "CdDeviceState", on_change=self._set_inflight_gauge,
            lock_dir=os.path.join(os.path.dirname(lock_path) or ".",
                                  "claim-locks"))
        kwargs = {} if channel_count is None else {"channel_count": channel_count}
        self.allocatable: dict[str, AllocatableDevice] = enumerate_devices(**kwargs)
        self._bootstrap_checkpoint()

    @property
    def host_managed(self) -> bool:
        return self.gates.enabled(HOST_MANAGED_RENDEZVOUS)

    # -- metrics hooks --------------------------------------------------------

    def _set_inflight_gauge(self, n: int) -> None:
        if self.metrics is not None:
            self.metrics.prepare_inflight.set(n, driver=self.driver_name)

    def _observe_batch(self, size: int) -> None:
        if self.metrics is not None:
            self.metrics.checkpoint_batch_size.observe(
                size, driver=self.driver_name)

    # -- startup (same contract as the GPU plugin's state) --------------------

    def _bootstrap_checkpoint(self) -> None:
        with self.lock.held(timeout=10.0):
            bootstrap_checkpoint(
                self.checkpoints, self.node_boot_id,
                on_discard=self._discard_claim_artifacts)

    def _discard_claim_artifacts(self, uid: str, pc: PreparedClaimCP) -> None:
        """Reboot unwinding for one discarded claim: its Ready status, CDI
        spec AND the node's CD label — the label lives in the API server
        and survives the reboot, so leaving it would wedge the node on a
        dead domain (any other CD's prepare then fails 'already labeled'
        forever). Ready is retracted first (reason ``Unpreparing``), before
        the reset checkpoint drops the record; the claim watcher of the new
        plugin prepares a claim that is still reserved again."""
        set_ready(self.cd_manager.client,
                  ClaimRef(uid=uid, name=pc.name, namespace=pc.namespace),
                  self.driver_name, self.pool_name, False, REASON_UNPREPARING)
        self.cdi.delete_claim_spec_file(uid)
        domain_id = pc.domain_id or self._domain_id_from_env(pc)
        if domain_id and not self.host_managed:
            self.cd_manager.remove_node_label(domain_id)

    def prepared_claims(self) -> dict[str, PreparedClaimCP]:
        with self.lock.held(timeout=10.0):
            return self.checkpoints.read().prepared_claims

    def prepared_claims_nolock(self) -> dict[str, PreparedClaimCP]:
        """Flock-free snapshot read (gauges, probes): atomic writes make an
        unlocked read consistent, at most one commit stale."""
        return self.checkpoints.read().prepared_claims

    # -- prepare --------------------------------------------------------------

    def prepare(self, claim: Obj) -> list[PreparedDeviceRef]:
        uid = claim_uid(claim)
        if not uid:
            raise PermanentError("claim has no uid")
        # Same trace stitch as the GPU plugin's DeviceState.prepare.
        with tracing.span_for_object(
                "prepare", claim,
                attributes={"driver": self.driver_name, "claim": uid}):
            with self._flights.claim(uid):
                return self._prepare_inflight(uid, claim)

    def _prepare_inflight(self, uid: str,
                          claim: Obj) -> list[PreparedDeviceRef]:
        results = self._own_results(claim)

        # Idempotent-replay fast path (no checkpoint write; the
        # registration transaction re-checks atomically).
        cur = self.checkpoints.read_cached().prepared_claims.get(uid)
        if cur is not None and cur.state == STATE_PREPARE_COMPLETED:
            logger.debug("prepare noop: claim %s already PrepareCompleted", uid)
            return self._refs_from_checkpoint(cur)

        domain_id = self._claim_domain_id(claim, results)

        # Registration transaction: the idempotency check, stale-aborted
        # rejection, overlap validation, and the PrepareStarted record are
        # one atomic checkpoint mutation (validate before mutate).
        def register(c: Checkpoint) -> Optional[PreparedClaimCP]:
            cur = c.prepared_claims.get(uid)
            if cur is not None and cur.state == STATE_PREPARE_COMPLETED:
                # Prepare may be invoked more than once per claim; actual
                # device preparation must happen at most once.
                return cur
            if not results:
                raise PermanentError(
                    f"claim {uid} has no allocation results for driver "
                    f"{self.driver_name}")
            if (cur is not None
                    and cur.state == STATE_PREPARE_ABORTED
                    and cur.results == results):
                # A retry of the exact claim version whose prepare was
                # rolled back by Unprepare (or drained): re-preparing would
                # resurrect state the kubelet already believes is gone
                # (device_state.go:206-208). Distinct type so the claim
                # watcher can resolve same-results reallocations
                # (docs/self-healing.md).
                raise StaleAbortedClaimError(
                    f"stale prepare for claim {uid}: prepare was already "
                    "aborted")
            self._validate_no_channel_overlap(c, uid, results)
            c.prepared_claims[uid] = PreparedClaimCP(
                state=STATE_PREPARE_STARTED,
                name=claim.get("metadata", {}).get("name", ""),
                namespace=claim.get("metadata", {}).get("namespace", ""),
                results=results,
                domain_id=domain_id,
            )
            return None

        completed_elsewhere = self.checkpoints.transact(register)
        if completed_elsewhere is not None:
            logger.debug("prepare noop: claim %s already PrepareCompleted", uid)
            return self._refs_from_checkpoint(completed_elsewhere)

        faultpoints.maybe_fail(FP_PREPARE)
        prepared = self._prepare_devices(claim, results)

        cdi_devices = [
            CDIDevice(
                name=self.cdi.claim_device_name(uid, pd.device),
                device_nodes=pd.device_nodes,
                env=pd.env,
                mounts=pd.mounts,
            )
            for pd in prepared
        ]
        self.cdi.create_claim_spec_file(uid, cdi_devices)

        def complete(c: Checkpoint) -> None:
            pc = c.prepared_claims.get(uid)
            if pc is None:
                # Retryable (same as the GPU plugin): the workqueue
                # replays the prepare, which re-registers from scratch.
                raise CheckpointError(
                    f"claim {uid} vanished from checkpoint mid-prepare")
            pc.state = STATE_PREPARE_COMPLETED
            pc.prepared_devices = [pd.to_dict() for pd in prepared]

        self.checkpoints.transact(complete)
        return [pd.to_ref(self.cdi.qualified_id(pd.cdi_device_name))
                for pd in prepared]

    def _own_results(self, claim: Obj) -> list[dict[str, Any]]:
        return [r for r in claim_allocation_results(claim)
                if r.get("driver") == self.driver_name]

    def _claim_domain_id(self, claim: Obj,
                         results: list[dict[str, Any]]) -> str:
        """Domain id from the claim's decoded channel/daemon configs — must
        be recorded before any side effect (node label) so Unprepare of a
        PrepareStarted claim can undo it."""
        for r in results:
            try:
                configs = self._configs_for(claim, r.get("request", ""))
            except PermanentError:
                continue  # malformed configs fail later with a better error
            for c in configs:
                if isinstance(c, (ComputeDomainChannelConfig,
                                  ComputeDomainDaemonConfig)):
                    return c.domain_id
        return ""

    def _validate_no_channel_overlap(self, cp: Checkpoint, uid: str,
                                     results: list[dict[str, Any]]) -> None:
        """A channel slot held by another live claim means a scheduler race
        or force-delete artifact (assertImexChannelNotAllocated,
        device_state.go:878). Daemon devices are per-CD singletons with the
        same exclusivity. Runs inside the registration transaction."""
        wanted = {r.get("device", "") for r in results}
        for other_uid, pc in cp.prepared_claims.items():
            if other_uid == uid or pc.state == STATE_PREPARE_ABORTED:
                continue
            held = {r.get("device", "") for r in pc.results}
            clash = wanted & held
            if clash:
                # Retryable — see OverlapError: the unprepare window's
                # transient flavor heals; real overlaps still surface
                # after the retry budget.
                raise OverlapError(
                    f"devices {sorted(clash)} already prepared for claim "
                    f"{other_uid}; refusing overlapping prepare")

    # -- config resolution + device prep --------------------------------------

    def _configs_for(self, claim: Obj, request: str) -> list[Any]:
        out = []
        for entry in claim_allocation_configs(claim):
            reqs = entry.get("requests") or []
            if reqs and request not in reqs:
                continue
            opaque = entry.get("opaque") or {}
            if opaque.get("driver") != self.driver_name:
                continue
            try:
                out.append(strict_decode(opaque.get("parameters") or {}))
            except ConfigError as e:
                raise PermanentError(
                    f"invalid opaque config for request {request!r}: {e}") from e
        return out

    def _prepare_devices(self, claim: Obj,
                         results: list[dict[str, Any]]) -> list[PreparedDevice]:
        uid = claim_uid(claim)
        ns = claim.get("metadata", {}).get("namespace", "")
        prepared: list[PreparedDevice] = []
        for r in results:
            name = r.get("device", "")
            device = self.allocatable.get(name)
            if device is None:
                raise PermanentError(
                    f"allocated device {name!r} is not an allocatable "
                    "ComputeDomain device on this node")
            configs = self._configs_for(claim, r.get("request", ""))
            if device.type == CHANNEL_TYPE:
                prepared.append(self._prepare_channel(uid, ns, r, device, configs))
            else:
                prepared.append(self._prepare_daemon(uid, ns, r, device, configs))
        return prepared

    def _channel_config(self, configs: list[Any],
                        device: AllocatableDevice) -> ComputeDomainChannelConfig:
        cfgs = [c for c in configs if isinstance(c, ComputeDomainChannelConfig)]
        if len(cfgs) != 1:
            raise PermanentError(
                f"channel device {device.name} needs exactly one "
                f"ComputeDomainChannelConfig (got {len(cfgs)})")
        for c in configs:
            if isinstance(c, ComputeDomainDaemonConfig):
                raise PermanentError(
                    f"ComputeDomainDaemonConfig cannot target channel device "
                    f"{device.name}")
        return cfgs[0]

    def _prepare_channel(self, uid: str, claim_ns: str, result: dict[str, Any],
                         device: AllocatableDevice,
                         configs: list[Any]) -> PreparedDevice:
        config = self._channel_config(configs, device)
        if self.host_managed:
            env = self._prepare_channel_host_managed(claim_ns, config)
        else:
            env = self._prepare_channel_driver_managed(claim_ns, config)
        # AllocationMode=All advertises the full channel range to the
        # workload (the all-channels injection analogue); these channels
        # are env-only, so the range is communicated, not device nodes.
        if config.allocation_mode == ALLOCATION_MODE_ALL:
            n = sum(1 for d in self.allocatable.values()
                    if d.type == CHANNEL_TYPE)
            env["COMPUTE_DOMAIN_CHANNELS"] = f"0-{n - 1}"
        else:
            env["COMPUTE_DOMAIN_CHANNELS"] = str(max(device.channel_id, 0))
        env["COMPUTE_DOMAIN_UUID"] = config.domain_id
        return PreparedDevice(
            device=device.name,
            requests=[result.get("request", "")],
            pool=self.pool_name,
            cdi_device_name=self.cdi.claim_device_name(uid, device.name),
            env=env,
        )

    def _prepare_channel_driver_managed(
            self, claim_ns: str,
            config: ComputeDomainChannelConfig) -> dict[str, str]:
        """The codependent flow (device_state.go:690-735): label the node
        FIRST (that attracts the controller's per-CD DaemonSet here), then
        assert readiness — retryable, so the 45 s workqueue spins while the
        daemon pod lands and reports Ready — then compute the worker env."""
        cd = self.cd_manager.require_compute_domain(config.domain_id)
        self.cd_manager.assert_namespace(cd, claim_ns)
        self.cd_manager.add_node_label(config.domain_id)
        self.cd_manager.assert_ready(cd)
        # Every node gets the rendezvous env, NVLink domain or not (the
        # reference's non-MNNVL branch, device_state.go:723-727, injects no
        # IMEX channel; ranks rendezvous over the network all the same).
        # worker_env re-reads the cliques itself; the CD object contributes
        # numNodes and, with the cliques gate off, its status.
        return self.cd_manager.worker_env(cd)

    def _prepare_channel_host_managed(
            self, claim_ns: str,
            config: ComputeDomainChannelConfig) -> dict[str, str]:
        cd = self.cd_manager.require_compute_domain(config.domain_id)
        self.cd_manager.assert_namespace(cd, claim_ns)
        return self.cd_manager.host_rendezvous_env()

    def _prepare_daemon(self, uid: str, claim_ns: str, result: dict[str, Any],
                        device: AllocatableDevice,
                        configs: list[Any]) -> PreparedDevice:
        if self.host_managed:
            # Daemon devices are never published in host-managed mode; a
            # daemon claim reaching Prepare is stale or hand-crafted
            # (device_state.go:735-746).
            raise PermanentError(
                "ComputeDomain daemon claims are not supported under "
                "host-managed rendezvous")
        for c in configs:
            if isinstance(c, ComputeDomainChannelConfig):
                # Symmetric with _channel_config: a conflicting channel
                # config on the daemon request is a misconfigured claim,
                # not something to silently ignore.
                raise PermanentError(
                    "ComputeDomainChannelConfig cannot target the daemon "
                    "device")
        cfgs = [c for c in configs if isinstance(c, ComputeDomainDaemonConfig)]
        if len(cfgs) != 1:
            raise PermanentError(
                f"daemon device needs exactly one ComputeDomainDaemonConfig "
                f"(got {len(cfgs)})")
        config = cfgs[0]
        cd = self.cd_manager.require_compute_domain(config.domain_id)
        self.cd_manager.assert_namespace(cd, claim_ns)
        settings = self.cd_manager.daemon_settings(config.domain_id)
        settings.prepare()
        env = {
            "COMPUTE_DOMAIN_UUID": config.domain_id,
            "COMPUTE_DOMAIN_NAME": cd.get("metadata", {}).get("name", ""),
            "COMPUTE_DOMAIN_NAMESPACE": claim_ns,
        }
        return PreparedDevice(
            device=device.name,
            requests=[result.get("request", "")],
            pool=self.pool_name,
            cdi_device_name=self.cdi.claim_device_name(uid, device.name),
            env=env,
            mounts=settings.mounts,
        )

    def _refs_from_checkpoint(self, pc: PreparedClaimCP) -> list[PreparedDeviceRef]:
        out = []
        for d in pc.prepared_devices:
            pd = PreparedDevice.from_dict(d)
            out.append(pd.to_ref(self.cdi.qualified_id(pd.cdi_device_name)))
        return out

    # -- unprepare -------------------------------------------------------------

    def unprepare(self, ref: ClaimRef) -> None:
        with self._flights.claim(ref.uid, unlink_on_exit=True):
            cp = self.checkpoints.read_cached()
            pc = cp.prepared_claims.get(ref.uid)
            if pc is None:
                logger.debug("unprepare noop: claim %s not in checkpoint", ref.uid)
                return
            if pc.state == STATE_PREPARE_ABORTED:
                logger.debug("unprepare noop: claim %s PrepareAborted", ref.uid)
                return
            self._unprepare_devices(pc)
            self.cdi.delete_claim_spec_file(ref.uid)
            if pc.state == STATE_PREPARE_COMPLETED:
                self.checkpoints.transact(
                    lambda c: c.prepared_claims.pop(ref.uid, None))
            else:
                # PrepareStarted: leave a tombstone so an in-flight stale
                # prepare retry for this claim version is rejected instead
                # of resurrecting state (markClaimPrepareAborted..., :430).
                def mark(c: Checkpoint) -> None:
                    entry = c.prepared_claims.get(ref.uid)
                    if entry is not None:
                        entry.state = STATE_PREPARE_ABORTED
                        entry.prepared_devices = []
                        entry.aborted_expiry = self.clock() + self.aborted_ttl
                self.checkpoints.transact(mark)
                if self.events is not None:
                    self.events.event_for_claim_ref(
                        ref, REASON_PREPARE_ABORTED,
                        "unprepare rolled back a mid-flight prepare; stale "
                        "retries of this claim version will be rejected",
                        TYPE_WARNING)

    def _unprepare_devices(self, pc: PreparedClaimCP) -> None:
        """Undo channel/daemon side effects using checkpointed results (the
        API object may be gone). Channel → drop this node's CD label (the
        DaemonSet then drains away); daemon → settings unprepare (directory
        retained for force-delete races)."""
        domain_id = pc.domain_id or self._domain_id_from_env(pc)
        if not domain_id:
            return
        for r in pc.results:
            device = self.allocatable.get(r.get("device", ""))
            if device is None:
                continue
            if device.type == CHANNEL_TYPE and not self.host_managed:
                self.cd_manager.remove_node_label(domain_id)
            elif device.type == DAEMON_TYPE and not self.host_managed:
                self.cd_manager.daemon_settings(domain_id).unprepare()

    @staticmethod
    def _domain_id_from_env(pc: PreparedClaimCP) -> str:
        """Fallback for checkpoints written before domain_id was recorded."""
        for d in pc.prepared_devices:
            uid = (d.get("env") or {}).get("COMPUTE_DOMAIN_UUID", "")
            if uid:
                return uid
        return ""

    # -- drain (self-healing remediation, docs/self-healing.md) ---------------

    def drain(self, ref: ClaimRef, reason: str = "",
              retract: Optional[Callable[[], object]] = None) -> bool:
        """Gracefully evict one prepared claim from this node during
        remediation: undo its channel/daemon side effects like
        :meth:`unprepare`, but ALWAYS leave a ``PrepareAborted`` tombstone
        (unprepare tombstones only mid-flight claims) so a stale prepare
        retry of the drained claim version is rejected while a re-allocated
        version overwrites it. Returns whether anything was drained.

        ``retract``: called under the claim's flight lock before any undo,
        when there is something to drain. The driver retracts the claim's
        Ready status there, so that no reader sees Ready for a claim whose
        record is no longer a completed prepare. A raise aborts the drain
        with nothing undone (the caller retries)."""
        with self._flights.claim(ref.uid):
            cp = self.checkpoints.read_cached()
            pc = cp.prepared_claims.get(ref.uid)
            if pc is None or pc.state == STATE_PREPARE_ABORTED:
                return False
            if retract is not None:
                retract()
            self._unprepare_devices(pc)
            self.cdi.delete_claim_spec_file(ref.uid)
            expiry = self.clock() + self.aborted_ttl

            def mark(c: Checkpoint) -> bool:
                entry = c.prepared_claims.get(ref.uid)
                if entry is None or entry.state == STATE_PREPARE_ABORTED:
                    return False
                entry.state = STATE_PREPARE_ABORTED
                entry.prepared_devices = []
                entry.aborted_expiry = expiry
                entry.drained = True
                return True

            drained = bool(self.checkpoints.transact(mark))
            if drained:
                logger.info("drained claim %s off this node%s", ref.uid,
                            f" ({reason})" if reason else "")
            return drained

    def resolve_drained(self, claim: Obj) -> bool:
        """Drop the drain tombstone of ``claim`` if the claim's current
        allocation is the one that was drained: the reallocator bound the
        claim again to the same devices on this node (after an uncordon,
        say). Returns whether a prepare of the current allocation is free
        of a tombstone now. A mid-flight rollback's tombstone is kept and
        keeps refusing its stale retry (the reference's rule, which
        :meth:`unprepare` keeps too); the GC expires it. Under the claim's
        flight lock, in one checkpoint transaction, so no drain or prepare
        of the claim lands in between."""
        uid = claim_uid(claim)
        results = self._own_results(claim)
        with self._flights.claim(uid):
            def drop(c: Checkpoint) -> bool:
                pc = c.prepared_claims.get(uid)
                if (pc is None or pc.state != STATE_PREPARE_ABORTED
                        or pc.results != results):
                    return True
                if not pc.drained:
                    return False
                del c.prepared_claims[uid]
                logger.info("claim %s re-allocated onto its drained "
                            "devices: drain tombstone dropped", uid)
                return True

            return bool(self.checkpoints.transact(drop))

    def while_prepared(self, uid: str, devices: list[str],
                       fn: Callable[[], None]) -> bool:
        """Run ``fn`` under the claim's flight lock if the checkpoint holds
        ``uid`` as a completed prepare of exactly ``devices``; returns
        whether it ran. A drain or an unprepare of the claim holds the same
        lock, so none lands between the check and ``fn``: the claim
        watcher publishes and restores Ready through here."""
        with self._flights.claim(uid):
            pc = self.checkpoints.read_cached().prepared_claims.get(uid)
            if (pc is None or pc.state != STATE_PREPARE_COMPLETED
                    or sorted(d.get("device", "") for d in pc.prepared_devices)
                    != sorted(devices)):
                return False
            fn()
            return True

    def adopt_boot_id(self, new_id: str) -> None:
        """Record a repair-simulated reboot (the node's boot id changed
        under a live plugin): later bootstraps compare against it."""
        if not new_id or new_id == self.node_boot_id:
            return

        def set_id(c: Checkpoint) -> None:
            c.node_boot_id = new_id

        self.checkpoints.transact(set_id)
        self.node_boot_id = new_id

    # -- aborted-entry GC (deleteExpiredPrepareAbortedClaims..., :448) --------

    def delete_expired_aborted(self, now: Optional[float] = None) -> list[str]:
        """Drop PrepareAborted tombstones whose TTL has passed; returns the
        expired claim UIDs. One atomic transaction: expiry is computed
        against the checkpoint the commit actually reads."""
        now = self.clock() if now is None else now

        def expired_in(claims: dict[str, PreparedClaimCP]) -> list[str]:
            return [
                uid for uid, pc in claims.items()
                if pc.state == STATE_PREPARE_ABORTED
                and (pc.aborted_expiry == 0.0 or now >= pc.aborted_expiry)
            ]

        # Read-only pre-check (a private disk parse — this GC runs
        # periodically and must not publish a checkpoint when there is
        # nothing to drop); the transaction recomputes atomically.
        if not expired_in(self.checkpoints.read().prepared_claims):
            return []

        def drop(c: Checkpoint) -> list[str]:
            expired = expired_in(c.prepared_claims)
            for uid in expired:
                c.prepared_claims.pop(uid, None)
            return expired

        expired = self.checkpoints.transact(drop)
        if expired:
            logger.info("expired %d PrepareAborted tombstones: %s",
                        len(expired), expired)
        return expired
