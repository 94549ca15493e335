"""The per-CD node daemon: local health → clique membership → readiness.

Copied from the JAX package's ``plugins/compute_domain_daemon/daemon.py``:
the analogue of the reference's ``cmd/compute-domain-daemon`` (``main.go:
212-347``, ``cdclique.go:277-500``) with the IMEX babysitting deleted. The
workload's ranks meet through torch.distributed's own TCP store and talk
over NCCL, so there is no broker process to exec/watchdog/SIGUSR1. What
survives is the rendezvous role:

1. verify the local GPUs are usable (the ``nvidia-imex-ctl -q`` readiness
   analogue — here an enumeration + health check),
2. publish ``{nodeName, hostname, address, worker index, clique id, GPU
   count}`` to the ComputeDomainClique object (stable index allocation,
   conflict-retried); the address of the rank-0 node's daemon becomes
   every worker's ``MASTER_ADDR``,
3. keep its entry's status current so the controller can aggregate the CD
   status, and withdraw on shutdown.
"""

from __future__ import annotations

import itertools
import logging
import threading
from typing import Optional

from k8s_dra_driver_tpu_torch.api.computedomain import (
    KIND_CLIQUE,
    STATUS_NOT_READY,
    STATUS_READY,
    DaemonInfo,
    clique_daemons,
    clique_name,
    new_clique,
)
from k8s_dra_driver_tpu_torch.gpulib.chip import HealthState
from k8s_dra_driver_tpu_torch.gpulib.device_lib import DeviceLib
from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    ConflictError,
    FakeClient,
    NotFoundError,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints
from k8s_dra_driver_tpu_torch.pkg.metrics import DaemonMetrics
from k8s_dra_driver_tpu_torch.pkg.workqueue import (
    ItemExponentialFailureRateLimiter,
    JitterRateLimiter,
)

logger = logging.getLogger(__name__)

#: Fault point: one whole sync_once reconcile round fails
#: (docs/fault-injection.md).
FP_DAEMON_SYNC = faultpoints.register(
    "cd.daemon.sync", "ComputeDomainDaemon.sync_once fails as a whole")


class ComputeDomainDaemon:
    def __init__(
        self,
        client: FakeClient,
        device_lib: DeviceLib,
        cd_uid: str,
        cd_name: str,
        node_name: str,
        namespace: str = "default",
        hostname: str = "",
        ip_address: str = "",
        pod_name: str = "",
        pod_namespace: str = "",
        metrics: Optional[DaemonMetrics] = None,
    ):
        """``pod_name`` (set from the downward-API POD_NAME when the daemon
        runs as a pod): watch our own Pod's Ready condition and fold it into
        the published status — the kubelet's view (all containers' readiness
        probes) is authoritative over our local self-assessment (the
        PodManager pattern, cmd/compute-domain-daemon/podmanager.go:35-150).
        Empty = no pod to watch (bare-process runs); local health alone
        decides."""
        self.client = client
        self.device_lib = device_lib
        self.cd_uid = cd_uid
        self.cd_name = cd_name
        self.node_name = node_name
        self.namespace = namespace
        self.hostname = hostname or node_name
        self.ip_address = ip_address
        self.pod_name = pod_name
        self.pod_namespace = pod_namespace or namespace
        self._pod_ready = True  # until a watched pod says otherwise
        self._pod_informer = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.node_info = device_lib.node_info()
        self.metrics = metrics or DaemonMetrics()
        self.sync_consecutive_failures = 0

    # -- readiness (the `check` subcommand analogue, main.go:435-459) --------

    def local_ready(self) -> bool:
        """All local GPUs enumerate, none is unhealthy (by the enumeration
        or by a fresh ``gpu_health`` read), and (when watching our own pod)
        the kubelet considers the pod Ready."""
        if not self._pod_ready:
            return False
        try:
            gpus = self.device_lib.enumerate_gpus()
            if not gpus:
                return False
            return all(
                g.health.state != HealthState.UNHEALTHY
                and self.device_lib.gpu_health(g).state
                != HealthState.UNHEALTHY for g in gpus)
        except Exception as e:  # noqa: BLE001
            logger.warning("CD daemon %s: enumeration failed: %s",
                           self.node_name, e)
            return False

    # -- own-pod readiness (podmanager.go:35-150) ----------------------------

    @staticmethod
    def _is_pod_ready(pod: dict) -> bool:
        for cond in (pod.get("status") or {}).get("conditions") or []:
            if cond.get("type") == "Ready":
                return cond.get("status") == "True"
        return False

    def _watch_own_pod(self) -> None:
        from k8s_dra_driver_tpu_torch.k8sclient.informer import Informer

        # Pessimistic until the watch reports otherwise: ALL state flows
        # through the informer thread (the initial list replays as an add),
        # so no out-of-band snapshot can overwrite a newer event.
        self._pod_ready = False

        def on_pod(pod: dict) -> None:
            ready = self._is_pod_ready(pod)
            if ready == self._pod_ready:
                return
            self._pod_ready = ready
            logger.info("CD daemon %s: own pod %s is now %s",
                        self.node_name, self.pod_name,
                        "Ready" if ready else "NotReady")
            try:
                self.sync_once()  # republish status immediately
            except Exception:  # noqa: BLE001 — the loop resyncs anyway
                logger.exception("CD daemon %s: pod-readiness resync failed",
                                 self.node_name)

        self._pod_informer = Informer(
            self.client, "Pod", self.pod_namespace,
            name=self.pod_name,  # fieldSelector analogue: our pod only
            on_add=on_pod,
            on_update=lambda old, new: on_pod(new),
            on_delete=lambda pod: on_pod({"metadata": pod["metadata"]}),
        ).start()
        self._pod_informer.wait_for_cache_sync()

    @property
    def clique_id(self) -> str:
        return self.node_info.domain_clique_id

    # -- clique membership ---------------------------------------------------

    def _ensure_clique(self):
        name = clique_name(self.cd_uid, self.clique_id)
        obj = self.client.try_get(KIND_CLIQUE, name, self.namespace)
        if obj is not None:
            return obj
        try:
            return self.client.create(new_clique(
                self.cd_uid, self.clique_id, self.namespace,
                owner_cd_name=self.cd_name))
        except AlreadyExistsError:
            return self.client.get(KIND_CLIQUE, name, self.namespace)

    def sync_once(self) -> DaemonInfo:
        """One reconcile: upsert our DaemonInfo with a stable index
        (syncDaemonInfoToClique + getNextAvailableIndex, cdclique.go:277-350).
        Conflict-retried against concurrent daemons."""
        faultpoints.maybe_fail(FP_DAEMON_SYNC)
        while True:
            # Recomputed EVERY round: sync_once runs concurrently on the
            # periodic loop and the pod-readiness watcher threads, and a
            # value captured before a ConflictError retry could overwrite
            # the other thread's fresher publish with stale readiness.
            ready = self.local_ready()
            clique = self._ensure_clique()
            daemons = clique_daemons(clique)
            mine: Optional[DaemonInfo] = next(
                (d for d in daemons if d.node_name == self.node_name), None)
            if mine is None:
                taken = {d.index for d in daemons}
                index = next(i for i in range(len(daemons) + 1)
                             if i not in taken)
                mine = DaemonInfo(node_name=self.node_name, index=index)
                daemons.append(mine)
            # In a multi-node NVLink domain the worker index is the node's
            # host index in the domain rather than arrival order — but it
            # NEVER publishes a duplicate: if another daemon already holds
            # our host index (two nodes claiming one slot),
            # fail HERE at the source — stay NotReady on a conflict-free
            # index and log loudly — instead of corrupting the clique and
            # leaving the consumer-side check (computedomain.worker_env) to
            # notice at channel-prepare time, far from the cause (the
            # stable-index contract, cdclique.go:277-350).
            if self.node_info.clique_hosts > 1:
                desired = self.node_info.host_index
                holder = next(
                    (d for d in daemons
                     if d.node_name != self.node_name and d.index == desired),
                    None)
                if holder is None:
                    mine.index = desired
                else:
                    ready = False
                    logger.error(
                        "CD daemon %s: worker index %d is already held by "
                        "node %s — duplicate host index; staying NotReady "
                        "until the conflict is resolved",
                        self.node_name, desired, holder.node_name)
                    if mine.index < self.node_info.clique_hosts:
                        # Park OUTSIDE the valid worker range
                        # [0, clique_hosts):
                        # staying on ANY low index (the duplicate or an
                        # arrival-order slot) would squat a legitimate
                        # host's index and cascade the misconfig onto a
                        # healthy node.
                        taken = {d.index for d in daemons if d is not mine}
                        mine.index = next(
                            i for i in itertools.count(
                                self.node_info.clique_hosts)
                            if i not in taken)
            mine.hostname = self.hostname
            mine.ip_address = self.ip_address
            mine.clique_id = self.clique_id
            mine.status = STATUS_READY if ready else STATUS_NOT_READY
            mine.coords = ""
            mine.topology = str(self.node_info.num_gpus)
            clique["daemons"] = [d.to_dict() for d in sorted(
                daemons, key=lambda d: d.index)]
            try:
                self.client.update(clique)
                return mine
            except ConflictError:
                continue  # concurrent daemon write: re-read and retry

    def withdraw(self) -> None:
        """Remove our entry (daemon pod terminating)."""
        name = clique_name(self.cd_uid, self.clique_id)
        while True:
            obj = self.client.try_get(KIND_CLIQUE, name, self.namespace)
            if obj is None:
                return
            daemons = [d for d in clique_daemons(obj)
                       if d.node_name != self.node_name]
            obj["daemons"] = [d.to_dict() for d in daemons]
            try:
                self.client.update(obj)
                return
            except ConflictError:
                continue
            except NotFoundError:
                return

    # -- loop ----------------------------------------------------------------

    def start(self, interval: float = 5.0) -> "ComputeDomainDaemon":
        if self.pod_name:
            self._watch_own_pod()
        self.sync_once()
        self._thread = threading.Thread(
            target=self._run, args=(interval,),
            name=f"cd-daemon-{self.node_name}", daemon=True)
        self._thread.start()
        return self

    def _run(self, interval: float) -> None:
        """Periodic resync with exponential backoff on a failure streak
        (the informer-reconnect discipline, jittered so per-CD daemons
        don't herd): a broken API server or dead local enumeration must
        not hammer sync_once at full cadence. One success resets both the
        backoff and the ``sync_consecutive_failures`` gauge."""
        limiter = JitterRateLimiter(ItemExponentialFailureRateLimiter(
            interval, max(interval, min(60.0, interval * 32))), 0.5)
        wait = interval
        while not self._stop.wait(wait):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — keep the daemon alive
                self.sync_consecutive_failures += 1
                wait = limiter.when("sync", 0.0)
                logger.exception(
                    "CD daemon %s sync failed (%d consecutive; next attempt "
                    "in %.2fs)", self.node_name,
                    self.sync_consecutive_failures, wait)
            else:
                self.sync_consecutive_failures = 0
                limiter.forget("sync")
                wait = interval
            self.metrics.sync_consecutive_failures.set(
                self.sync_consecutive_failures, node=self.node_name)

    def stop(self, withdraw: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._pod_informer is not None:
            self._pod_informer.stop()
        if withdraw:
            self.withdraw()
