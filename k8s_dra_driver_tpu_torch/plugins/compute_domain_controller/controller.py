"""ComputeDomain controller: CRD → DaemonSet + RCTs → status aggregation.

Copied from the JAX package's ``plugins/compute_domain_controller/
controller.py`` under the port's API group and driver names. The analogue
of the reference's controller (``cmd/compute-domain-controller/
computedomain.go:361-429`` driver-managed reconcile, ``daemonset.go:190``
per-CD DaemonSet, ``resourceclaimtemplate.go:280-411`` daemon + workload
RCTs, ``cdstatus.go:135-277`` status aggregation from cliques): one informer
feeds a rate-limited workqueue; each reconcile is idempotent.

As there: the daemon DaemonSet's node selector is the per-CD node label the
CD kubelet plugin applies when a workload channel claim lands on a node;
the workload RCT's opaque config carries ``domainID``; the status becomes
Ready when ``numNodes`` daemons report Ready, summed over all of the CD's
cliques (one per HGX node, or one per multi-node NVLink domain), with its
nodes listed in the workers' ``(cliqueID, index)`` order.

Active-active sharding (the JAX package's ``shard_gate``) waits with the
controller's ``sharding.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from k8s_dra_driver_tpu_torch.api.computedomain import (
    ALLOCATION_MODE_ALL,
    FINALIZER,
    KIND_CLIQUE,
    KIND_COMPUTE_DOMAIN,
    NODE_LABEL_CD,
    STATUS_NOT_READY,
    STATUS_READY,
    DaemonInfo,
    cd_allocation_mode,
    cd_channel_template_name,
    cd_num_nodes,
    clique_daemons,
)
from k8s_dra_driver_tpu_torch.api.configs import API_VERSION as CONFIG_API_VERSION
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient, Informer
from k8s_dra_driver_tpu_torch.k8sclient.client import (
    AlreadyExistsError,
    NotFoundError,
    Obj,
    new_object,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints, sanitizer, tracing
from k8s_dra_driver_tpu_torch.pkg.events import (
    REASON_DOMAIN_NOT_READY,
    REASON_DOMAIN_READY,
    TYPE_WARNING,
    EventRecorder,
)
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    HOST_MANAGED_RENDEZVOUS,
    FeatureGates,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.pkg.metrics import ControllerMetrics
from k8s_dra_driver_tpu_torch.pkg.workqueue import (
    WorkQueue,
    default_controller_rate_limiter,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.cleanup import (
    CleanupManager,
)

logger = logging.getLogger(__name__)

#: Fault point: a controller write-back (status patch / child upsert /
#: finalizer release) fails — the reconcile retries through its workqueue
#: (docs/fault-injection.md).
FP_CONTROLLER_PATCH = faultpoints.register(
    "cd.controller.patch",
    "ComputeDomain controller status/child write fails")

#: Fault point: one whole reconcile execution fails (error outcome, retried
#: through the workqueue) or — the main use — stalls under a ``latency``
#: schedule, modeling the API round-trips a real reconcile is made of. The
#: control-plane bench and the per-key-exclusivity tests hold reconciles
#: open with it (docs/fault-injection.md, docs/performance.md).
FP_RECONCILE = faultpoints.register(
    "cd.controller.reconcile",
    "one ComputeDomain reconcile execution fails/stalls")

#: Default reconcile worker-pool size (client-go controllers default to
#: multiple workers per controller; per-key exclusivity in pkg/workqueue
#: keeps one ComputeDomain from ever being reconciled twice at once).
DEFAULT_WORKERS = 4

CD_DRIVER_NAME = "compute-domain.nvidia.com"
DEVICE_CLASS_DAEMON = "compute-domain-daemon.nvidia.com"
DEVICE_CLASS_CHANNEL = "compute-domain-default-channel.nvidia.com"


def daemon_rct_name(cd_name: str) -> str:
    return f"{cd_name}-daemon"


#: Annotation carrying a hash of the last-RENDERED DaemonSet spec. The
#: field-scoped compare below tolerates server-added defaults but cannot
#: see a field the controller STOPPED rendering (it only walks desired
#: keys); the hash changes whenever the render output changes — including
#: removals — so upgrade drift converges too.
RENDERED_HASH_ANNOTATION = "resource.nvidia.com/rendered-hash"


def _rendered_hash(desired: dict) -> str:
    import hashlib
    import json
    return hashlib.sha256(
        json.dumps(desired, sort_keys=True).encode()).hexdigest()[:16]


def _rendered_fields_drifted(desired, existing) -> bool:
    """Drift = a field the controller RENDERS disagrees with the server
    copy. Exact dict equality would fight a defaulting apiserver forever
    (every reconcile would see server-added fields as drift), so the
    compare is scoped to rendered fields: dict keys present in ``desired``
    must match recursively, extra server keys are ignored; lists compare
    pairwise (a length change IS drift — k8s list merge semantics don't
    apply to the fields we own wholesale, like the containers array).
    Removed-field drift is covered by RENDERED_HASH_ANNOTATION, not by
    this compare."""
    if isinstance(desired, dict):
        if not isinstance(existing, dict):
            return True
        return any(_rendered_fields_drifted(v, existing.get(k))
                   for k, v in desired.items())
    if isinstance(desired, list):
        if not isinstance(existing, list) or len(desired) != len(existing):
            return True
        return any(_rendered_fields_drifted(d, e)
                   for d, e in zip(desired, existing))
    return desired != existing


class ComputeDomainController:
    def __init__(self, client: FakeClient, namespace: Optional[str] = None,
                 gates: Optional[FeatureGates] = None,
                 driver_namespace: Optional[str] = None,
                 metrics: Optional[ControllerMetrics] = None,
                 workers: int = DEFAULT_WORKERS):
        """``driver_namespace``: where driver-owned children (per-CD
        DaemonSet, daemon RCT, cliques) are created — the reference keeps
        them in the namespace the driver RUNS in while ComputeDomains live
        in user namespaces (controller.go:38-39, daemonset.go:208). None =
        children co-located with each CD (single-namespace deployments).

        ``workers``: reconcile worker-pool size. Per-key exclusivity in
        the workqueue guarantees one CD never reconciles on two workers at
        once; everything a reconcile shares ACROSS keys (the uid map, the
        clique index, metrics, the client) is mutex-guarded or internally
        thread-safe."""
        self.client = client
        self.namespace = namespace
        self.driver_namespace = driver_namespace
        self.gates = gates or new_feature_gates()
        self.metrics = metrics or ControllerMetrics()
        self.events = EventRecorder(client, "compute-domain-controller")
        self.workers = max(1, workers)
        self.queue = WorkQueue(default_controller_rate_limiter(),
                               name="cd-controller")
        self._informer: Optional[Informer] = None
        self._clique_informer: Optional[Informer] = None
        self._pod_informer: Optional[Informer] = None
        self._thread: Optional[threading.Thread] = None
        # uid → "ns/name" of known CDs (informer-fed): O(1) owner lookup
        # for clique events instead of an O(CDs) list per daemon heartbeat.
        # Mutated from two informer callback threads and read from the
        # queue thread — guarded by _cd_keys_mu rather than relying on the
        # GIL making dict ops atomic (the thread-discipline rule of
        # informer.py:58-61 applies to consumers too).
        self._cd_keys_mu = sanitizer.new_lock(
            "ComputeDomainController._cd_keys_mu")
        self._cd_keys: dict[str, str] = sanitizer.guarded_dict(
            self._cd_keys_mu, "ComputeDomainController._cd_keys")
        # owner CD uid → {clique name → clique object}, fed by the clique
        # informer: status aggregation reads its CD's cliques O(own) from
        # here instead of re-LISTing every clique in the namespace per
        # reconcile — O(CD²) across a fleet (the _daemon_pods_of cache
        # path, taken one step further with an owner index). Values are
        # the shared watch snapshots: read-only by contract.
        self._clique_index_mu = sanitizer.new_lock(
            "ComputeDomainController._clique_index_mu")
        self._clique_index: dict[str, dict[str, Obj]] = sanitizer.guarded_dict(
            self._clique_index_mu, "ComputeDomainController._clique_index")
        # Children live in the driver namespace AND user namespaces in the
        # multi-namespace layout — the sweep must see both.
        self.cleanup = CleanupManager(
            client, None if driver_namespace else namespace,
            metrics=self.metrics)

    @property
    def host_managed(self) -> bool:
        """Rendezvous mode is a CLUSTER deployment property (who owns the
        daemon lifecycle), not a per-CD choice — the reference derives it
        from controller config the same way (computedomain.go:97,274,352)."""
        return self.gates.enabled(HOST_MANAGED_RENDEZVOUS)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ComputeDomainController":
        # A WorkQueue's shut_down is permanent; a stop()→start() cycle
        # (leader election losing and re-acquiring the lease) needs a fresh
        # queue or the run loop exits immediately and reconciliation
        # silently never resumes.
        self.queue = WorkQueue(default_controller_rate_limiter(),
                               name="cd-controller")
        with self._clique_index_mu:
            self._clique_index.clear()  # a relisting informer re-feeds it
        self._informer = Informer(
            self.client, KIND_COMPUTE_DOMAIN, self.namespace,
            on_add=self._enqueue_cd,
            on_update=lambda old, new: self._enqueue_cd(new),
            # Teardown rides the finalizer path; the uid map (and the gauge
            # derived from it — a teardown reconcile runs BEFORE this delete
            # event lands, so the gauge must follow the map, not reconcile)
            # is pruned here.
            on_delete=self._on_cd_deleted,
        ).start()
        # Clique changes re-reconcile their owning CD (status aggregation).
        # Cliques live with the daemons — the DRIVER namespace in the
        # multi-namespace layout — so watch there, not the CD scope. Each
        # event also maintains the owner-uid clique index _cliques_of reads.
        self._clique_informer = Informer(
            self.client, KIND_CLIQUE,
            self.driver_namespace or self.namespace,
            on_add=self._on_clique_event,
            on_update=lambda old, new: self._on_clique_event(new),
            on_delete=lambda c: self._on_clique_event(c, deleted=True),
        ).start()
        # Daemon-pod informer: nodes whose daemon never forms a clique
        # (fabric fault, lone node) surface through their POD's Ready
        # condition instead — without this, such a node is invisible to
        # Ready aggregation (daemonsetpods.go:43, cdstatus.go:213-219).
        self._pod_informer = Informer(
            self.client, "Pod", self.driver_namespace or self.namespace,
            on_add=self._enqueue_daemon_pod_owner,
            on_update=lambda old, new: self._enqueue_daemon_pod_owner(new),
            on_delete=self._enqueue_daemon_pod_owner,
        ).start()
        self._informer.wait_for_cache_sync()
        self._clique_informer.wait_for_cache_sync()
        self._pod_informer.wait_for_cache_sync()
        self._thread = threading.Thread(
            target=self.queue.run, kwargs={"workers": self.workers},
            name="cd-controller", daemon=True)
        self._thread.start()
        self.cleanup.start()
        return self

    def stop(self) -> None:
        self.cleanup.stop()
        self.queue.shut_down()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._informer is not None:
            self._informer.stop()
        if self._clique_informer is not None:
            self._clique_informer.stop()
        if self._pod_informer is not None:
            self._pod_informer.stop()
        # Direct reconcile() calls after stop() (tests, one-shots) must
        # fall back to scoped lists, not a no-longer-maintained cache.
        self._informer = None
        self._clique_informer = None
        self._pod_informer = None

    # -- queue plumbing ------------------------------------------------------

    def _key(self, cd: Obj) -> str:
        m = cd["metadata"]
        return f"{m.get('namespace', '')}/{m['name']}"

    def _on_cd_deleted(self, cd: Obj) -> None:
        with self._cd_keys_mu:
            self._cd_keys.pop(cd["metadata"].get("uid", ""), None)
        self._update_cd_gauge()

    def _enqueue_cd(self, cd: Obj) -> None:
        uid = cd["metadata"].get("uid", "")
        if uid:
            with self._cd_keys_mu:
                self._cd_keys[uid] = self._key(cd)
        # Informer events are NOT rate limited (client-go's Add, not
        # AddRateLimited): per-key coalescing already bounds the work, and
        # pushing normal events through the failure limiter both inflates
        # per-key backoff state and lets the global bucket throttle a
        # burst of brand-new CDs. Retries (the _process_one failure path)
        # still go through the limiter.
        self.queue.enqueue(self._key(cd), self._key(cd), self._reconcile_key,
                           rate_limited=False)

    @staticmethod
    def _clique_owner_uid(clique: Obj) -> str:
        """Owning CD uid: ownerReferences when present, else the
        ``<cdUID>.<cliqueID>`` name prefix (cdclique.go:277)."""
        for ref in clique["metadata"].get("ownerReferences") or []:
            if ref.get("kind") == KIND_COMPUTE_DOMAIN and ref.get("uid"):
                return ref["uid"]
        return clique["metadata"]["name"].partition(".")[0]

    def _on_clique_event(self, clique: Obj, deleted: bool = False) -> None:
        """Maintain the owner-uid clique index, then re-reconcile the
        owner. The index stores the shared watch snapshot itself (read-only
        contract) — no copy, no list."""
        uid = self._clique_owner_uid(clique)
        name = clique["metadata"]["name"]
        if uid:
            with self._clique_index_mu:
                if deleted:
                    bucket = self._clique_index.get(uid)
                    if bucket is not None:
                        bucket.pop(name, None)
                        if not bucket:
                            del self._clique_index[uid]
                else:
                    self._clique_index.setdefault(uid, {})[name] = clique
        self._enqueue_clique_owner(clique)

    def _enqueue_clique_owner(self, clique: Obj) -> None:
        """Cliques live with the daemons (the DRIVER namespace in
        multi-namespace layouts), so the owning CD must be resolved by UID
        — assuming co-location would drop every clique event and Ready
        aggregation would never fire."""
        for ref in clique["metadata"].get("ownerReferences") or []:
            if ref.get("kind") != KIND_COMPUTE_DOMAIN:
                continue
            uid = ref.get("uid", "")
            with self._cd_keys_mu:
                key = self._cd_keys.get(uid)  # O(1), fed by the CD informer
            if key is None:
                # Informer lag or an unwatched CD: one scan, then cache.
                for cd in self.client.list(KIND_COMPUTE_DOMAIN,
                                           self.namespace):
                    if cd["metadata"].get("uid") == uid:
                        self._enqueue_cd(cd)
                        return
                # Fall back to name-in-clique-namespace (legacy co-location).
                ns = clique["metadata"].get("namespace", "")
                key = f"{ns}/{ref['name']}"
            self.queue.enqueue(key, key, self._reconcile_key,
                               rate_limited=False)

    def _enqueue_daemon_pod_owner(self, pod: Obj) -> None:
        """Daemon-pod events re-reconcile the owning CD so non-clique nodes
        feed status aggregation. Ownership is recovered from the pod's
        ``app: <ds-name>`` label: uid-stemmed in the driver namespace
        (``cd-<uid>-daemon``), CD-named co-located (``<cd>-daemon``)."""
        app = (pod["metadata"].get("labels") or {}).get("app", "")
        if not app.endswith("-daemon"):
            return
        stem = app[: -len("-daemon")]
        # The LAYOUT decides how the stem reads, not the stem's spelling —
        # a co-located CD legitimately named "cd-something" must not be
        # mis-parsed as a uid stem.
        if self.driver_namespace:
            with self._cd_keys_mu:
                key = self._cd_keys.get(stem[len("cd-"):]
                                        if stem.startswith("cd-") else "")
            if key is None:
                return  # CD gone; the orphan sweep owns this pod's fate
        else:
            key = f"{pod['metadata'].get('namespace', '')}/{stem}"
        self.queue.enqueue(key, key, self._reconcile_key,
                           rate_limited=False)

    def _reconcile_key(self, key: str) -> None:
        ns, _, name = key.partition("/")
        cd = self.client.try_get(KIND_COMPUTE_DOMAIN, name, ns)
        if cd is None:
            return
        self.reconcile(cd)

    # -- reconcile (exposed for deterministic tests) -------------------------

    def _update_cd_gauge(self) -> None:
        with self._cd_keys_mu:
            count = len(self._cd_keys)
        self.metrics.compute_domains.set(float(count))

    def reconcile(self, cd: Obj) -> None:
        t0 = time.monotonic()
        # Joins the trace of a CD created with a traceparent annotation
        # (docs/observability.md); untraced CDs cost one annotation read.
        with tracing.span_for_object(
                "cd.reconcile", cd,
                attributes={"cd": cd["metadata"].get("name", "")}):
            try:
                faultpoints.maybe_fail(FP_RECONCILE)
                outcome = self._reconcile_inner(cd)
            except Exception:
                self.metrics.reconciles_total.inc(outcome="error")
                raise
            finally:
                self.metrics.reconcile_duration_seconds.observe(
                    time.monotonic() - t0)
        self.metrics.reconciles_total.inc(outcome=outcome)
        self._update_cd_gauge()

    def _reconcile_inner(self, cd: Obj) -> str:
        if cd["metadata"].get("deletionTimestamp") is not None:
            self._teardown(cd)
            return "teardown"
        self.client.add_finalizer(
            KIND_COMPUTE_DOMAIN, cd["metadata"]["name"], FINALIZER,
            cd["metadata"].get("namespace", ""))
        # Don't wait for the periodic sweep (computedomain.go:405-406).
        self.cleanup.kick()
        if self.host_managed:
            # Host-managed rendezvous: the admin owns daemon lifecycle, so
            # the controller manages ONLY the workload RCT — no daemon RCT,
            # no DaemonSet (onAddOrUpdateHostManaged,
            # computedomain.go:429-470). Children created before a
            # driver-managed→host-managed flip are torn down here; the
            # orphan sweep won't (their CD is alive). A combined
            # driver-managed-co-located → host-managed+driver-namespace flip
            # leaves children under BOTH layouts (legacy names in the CD's
            # namespace AND uid-stemmed names in the driver namespace), so
            # sweep both unconditionally.
            self._delete_driver_managed_children(cd)
            if self.driver_namespace:
                self._delete_driver_managed_children(
                    cd, ns=cd["metadata"].get("namespace", ""),
                    legacy_names=True)
            self._ensure_workload_rct(cd)
            self._sync_status_host_managed(cd)
            return "success"
        if (self.driver_namespace
                and cd["metadata"].get("namespace", "")
                != self.driver_namespace):
            # Flag-flip cleanup (mirror of the host-managed flip above):
            # children created pre---driver-namespace live co-located with
            # the CD under legacy names; the sweep spares them (their owner
            # is alive), so reconcile must retire them or duplicate daemon
            # sets would compete over the same labeled nodes.
            self._delete_driver_managed_children(
                cd, reason="driver-namespace mode",
                ns=cd["metadata"].get("namespace", ""), legacy_names=True)
        self._ensure_daemonset(cd)
        self._ensure_daemon_rct(cd)
        self._ensure_workload_rct(cd)
        self._sync_status(cd)
        return "success"

    # -- children ------------------------------------------------------------

    def _children_ns(self, cd: Obj) -> str:
        """Namespace for driver-owned children of this CD."""
        return self.driver_namespace or cd["metadata"].get("namespace", "")

    def _daemon_child_stem(self, cd: Obj) -> str:
        """Base name for the per-CD DaemonSet + daemon RCT. In the shared
        driver namespace the CD's name alone would collide across user
        namespaces ('dom' in team-a vs team-b), so the name is uid-based
        there — the reference's computedomain-daemon-{UID}
        (daemonset.go:213). Co-located mode keeps the readable name."""
        if self.driver_namespace:
            return f"cd-{cd['metadata']['uid']}"
        return cd["metadata"]["name"]

    def _daemon_child_names(self, cd: Obj) -> tuple[str, str]:
        stem = self._daemon_child_stem(cd)
        return f"{stem}-daemon", daemon_rct_name(stem)

    def _delete_driver_managed_children(self, cd: Obj,
                                        reason: str = "host-managed mode",
                                        ns: Optional[str] = None,
                                        legacy_names: bool = False) -> None:
        if legacy_names:
            stem = cd["metadata"]["name"]
            children = (f"{stem}-daemon", daemon_rct_name(stem))
        else:
            children = self._daemon_child_names(cd)
        ns = self._children_ns(cd) if ns is None else ns
        for kind, child in (("DaemonSet", children[0]),
                            ("ResourceClaimTemplate", children[1])):
            try:
                self.client.delete(kind, child, ns)
                logger.info("%s: removed driver-managed %s %s/%s",
                            reason, kind, ns, child)
            except NotFoundError:
                pass

    def _render_daemonset_spec(self, cd: Obj) -> dict:
        """The desired per-CD DaemonSet spec. Probes exec the daemon's own
        ``check`` subcommand (templates/compute-domain-daemon.tmpl.yaml:79-86
        — startup gives slow rendezvous time to settle; liveness restarts a
        wedged daemon; readiness gates Ready aggregation)."""
        name, rct_name = self._daemon_child_names(cd)
        check_probe = {"exec": {"command": ["compute-domain-daemon", "check"]}}
        return {
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "nodeSelector": {NODE_LABEL_CD: cd["metadata"]["uid"]},
                    "containers": [{
                        "name": "compute-domain-daemon",
                        "command": ["compute-domain-daemon"],
                        # Downward API: the daemon watches its OWN pod's
                        # Ready condition (podmanager.go:49-51) — without
                        # POD_NAME the watcher never activates.
                        "env": [
                            {"name": "POD_NAME", "valueFrom": {"fieldRef": {
                                "fieldPath": "metadata.name"}}},
                            {"name": "POD_NAMESPACE", "valueFrom": {
                                "fieldRef": {
                                    "fieldPath": "metadata.namespace"}}},
                            {"name": "NODE_NAME", "valueFrom": {"fieldRef": {
                                "fieldPath": "spec.nodeName"}}},
                        ],
                        "resources": {"claims": [{"name": "daemon"}]},
                        "startupProbe": {
                            **check_probe, "periodSeconds": 1,
                            "failureThreshold": 60},
                        "livenessProbe": {
                            **check_probe, "periodSeconds": 10,
                            "failureThreshold": 6},
                        "readinessProbe": {
                            **check_probe, "periodSeconds": 5,
                            "failureThreshold": 1},
                    }],
                    "resourceClaims": [{
                        "name": "daemon",
                        "resourceClaimTemplateName": rct_name,
                    }],
                },
            },
        }

    def _ensure_daemonset(self, cd: Obj) -> Obj:
        """Per-CD DaemonSet selecting nodes the CD plugin labels
        (daemonset.go:190; the label is applied by the node plugin when a
        channel claim lands, computedomain.go:372-400). An existing
        DaemonSet is CONVERGED, not returned untouched: the desired spec is
        re-rendered and compared, so hand edits and stale revisions drift
        back (the re-render-and-update path, daemonset.go:190-260)."""
        name, _ = self._daemon_child_names(cd)
        ns = self._children_ns(cd)
        desired = self._render_daemonset_spec(cd)
        desired_hash = _rendered_hash(desired)
        existing = self.client.try_get("DaemonSet", name, ns)
        if existing is not None:
            anns = existing["metadata"].get("annotations") or {}
            if (anns.get(RENDERED_HASH_ANNOTATION) != desired_hash
                    or _rendered_fields_drifted(desired,
                                                existing.get("spec"))):
                logger.info("DaemonSet %s/%s drifted; converging", ns, name)
                existing["spec"] = desired
                existing["metadata"].setdefault("annotations", {})[
                    RENDERED_HASH_ANNOTATION] = desired_hash
                return self.client.update(existing)
            return existing
        ds = new_object("DaemonSet", name, ns, api_version="apps/v1",
                        spec=desired)
        ds["metadata"]["ownerReferences"] = [self._owner_ref(cd)]
        ds["metadata"]["annotations"] = {
            RENDERED_HASH_ANNOTATION: desired_hash}
        try:
            return self.client.create(ds)
        except AlreadyExistsError:
            return self.client.get("DaemonSet", name, ns)

    def _ensure_daemon_rct(self, cd: Obj) -> None:
        """Daemon RCT (resourceclaimtemplate.go:280-340). Driver-managed
        mode only — host-managed clusters have no controller-run daemons.
        Lives with the DaemonSet (driver namespace when configured): the
        daemon pods' claims instantiate from it in THEIR namespace."""
        ns = self._children_ns(cd)
        uid = cd["metadata"]["uid"]
        _, rct_name = self._daemon_child_names(cd)
        daemon_rct = new_object(
            "ResourceClaimTemplate", rct_name,
            ns, api_version="resource.k8s.io/v1",
            spec={"spec": {"devices": {
                "requests": [{"name": "daemon", "exactly": {
                    "deviceClassName": DEVICE_CLASS_DAEMON,
                    "allocationMode": "ExactCount", "count": 1}}],
                "config": [{"requests": ["daemon"], "opaque": {
                    "driver": CD_DRIVER_NAME,
                    "parameters": {
                        "apiVersion": CONFIG_API_VERSION,
                        "kind": "ComputeDomainDaemonConfig",
                        "domainID": uid}}}],
            }}})
        daemon_rct["metadata"]["ownerReferences"] = [self._owner_ref(cd)]
        try:
            self.client.create(daemon_rct)
        except AlreadyExistsError:
            pass

    def _ensure_workload_rct(self, cd: Obj) -> None:
        """User-named workload RCT with the opaque domainID config
        (resourceclaimtemplate.go:340-411)."""
        ns = cd["metadata"].get("namespace", "")
        uid = cd["metadata"]["uid"]
        mode = cd_allocation_mode(cd)
        workload_rct = new_object(
            "ResourceClaimTemplate", cd_channel_template_name(cd), ns,
            api_version="resource.k8s.io/v1",
            spec={"spec": {"devices": {
                "requests": [{"name": "channel", "exactly": {
                    "deviceClassName": DEVICE_CLASS_CHANNEL,
                    "allocationMode": (
                        "All" if mode == ALLOCATION_MODE_ALL else "ExactCount"),
                    "count": 1}}],
                "config": [{"requests": ["channel"], "opaque": {
                    "driver": CD_DRIVER_NAME,
                    "parameters": {
                        "apiVersion": CONFIG_API_VERSION,
                        "kind": "ComputeDomainChannelConfig",
                        "domainID": uid,
                        "allocationMode": mode}}}],
            }}})
        workload_rct["metadata"]["ownerReferences"] = [self._owner_ref(cd)]
        try:
            self.client.create(workload_rct)
        except AlreadyExistsError:
            pass

    @staticmethod
    def _owner_ref(cd: Obj) -> dict:
        return {"apiVersion": cd.get("apiVersion", ""),
                "kind": KIND_COMPUTE_DOMAIN,
                "name": cd["metadata"]["name"],
                "uid": cd["metadata"]["uid"]}

    # -- status aggregation (cdstatus.go:135-277) ----------------------------

    def _cliques_of(self, cd: Obj) -> list[Obj]:
        """Cliques live where the daemons run — the driver namespace when
        one is configured (cdclique.go:52,128). With the loop running,
        this is an O(own cliques) owner-uid index lookup off the clique
        informer (a per-reconcile LIST re-copies EVERY clique in the
        namespace — O(CD²) across a fleet of re-reconciling domains).
        Direct reconcile calls (tests, one-shots) fall back to the scoped
        list. Returned objects are shared watch snapshots: read-only."""
        uid = cd["metadata"]["uid"]
        if self._clique_informer is not None:
            with self._clique_index_mu:
                return list(self._clique_index.get(uid, {}).values())
        return self._list_cliques_of(cd)

    def _list_cliques_of(self, cd: Obj) -> list[Obj]:
        uid = cd["metadata"]["uid"]
        return [c for c in self.client.list(KIND_CLIQUE, self._children_ns(cd))
                if c["metadata"]["name"].startswith(f"{uid}.")]

    def _sync_status_host_managed(self, cd: Obj) -> None:
        """Host-managed Ready means only "admitted + workload RCT exists" —
        it says nothing about host rendezvous health, which the admin owns
        (computedomain.go:464-468)."""
        ns = cd["metadata"].get("namespace", "")
        rct = self.client.try_get(
            "ResourceClaimTemplate", cd_channel_template_name(cd), ns)
        new_status = {
            "status": STATUS_READY if rct is not None else STATUS_NOT_READY,
            "readyNodes": 0,
            "nodes": [],
        }
        fresh = self.client.try_get(
            KIND_COMPUTE_DOMAIN, cd["metadata"]["name"], ns)
        if fresh is None or (fresh.get("status") or {}) == new_status:
            return
        fresh["status"] = new_status
        faultpoints.maybe_fail(FP_CONTROLLER_PATCH)
        self.client.update_status(fresh)

    def _daemon_pods_of(self, cd: Obj) -> list[Obj]:
        # Serve from the pod informer's cache when the loop is running (in
        # driver-namespace mode that namespace holds EVERY CD's daemon
        # pods, and a rollout re-reconciles per pod event — an API list per
        # reconcile would be O(pods^2) across the fleet). Direct reconcile
        # calls (tests, one-shots) fall back to a scoped list.
        if self._pod_informer is not None:
            pods = self._pod_informer.cached_list()
        else:
            pods = self.client.list("Pod", self._children_ns(cd))
        ds_name, _ = self._daemon_child_names(cd)
        # Filter by namespace too, not just the app label: an unscoped
        # pod informer caches ALL namespaces, and two same-named CDs in
        # different namespaces share the '<cd>-daemon' ds_name — without
        # the namespace check each would count the other's daemon pods
        # (phantom nodes, inflated readyNodes). Matches the scoped
        # client.list fallback above.
        ns = self._children_ns(cd)
        return [p for p in pods
                if (p["metadata"].get("labels") or {}).get("app") == ds_name
                and p["metadata"].get("namespace") == ns]

    def _sync_status(self, cd: Obj) -> None:
        nodes = []
        ready = 0
        for clique in self._cliques_of(cd):
            for d in clique_daemons(clique):
                nodes.append(d.to_dict())
                if d.status == STATUS_READY:
                    ready += 1
        # Non-clique branch (cdstatus.go:213-219 + daemonsetpods.go:43): a
        # node whose daemon pod runs but never joins a clique (fabric fault,
        # lone node) still reports — its status is the POD's kubelet Ready
        # condition, the only health signal that exists without rendezvous.
        clique_nodes = {n.get("nodeName", "") for n in nodes}
        for pod in self._daemon_pods_of(cd):
            node_name = (pod.get("spec") or {}).get("nodeName", "")
            if not node_name or node_name in clique_nodes:
                continue
            clique_nodes.add(node_name)  # two pods on a node count once
            pod_ready = any(
                c.get("type") == "Ready" and c.get("status") == "True"
                for c in (pod.get("status") or {}).get("conditions") or [])
            nodes.append(DaemonInfo(
                node_name=node_name,
                status=STATUS_READY if pod_ready else STATUS_NOT_READY,
            ).to_dict())
            if pod_ready:
                ready += 1
        want = cd_num_nodes(cd)
        # The workers' order (computedomain.worker_env): by clique, then
        # index. Indices repeat across cliques — every HGX node is index 0
        # of its own — so the index alone would not order them.
        new_status = {
            "status": STATUS_READY if ready >= want else STATUS_NOT_READY,
            "readyNodes": ready,
            "nodes": sorted(nodes, key=lambda n: (n.get("cliqueID", ""),
                                                  n.get("index", 0))),
        }
        fresh = self.client.try_get(
            KIND_COMPUTE_DOMAIN, cd["metadata"]["name"],
            cd["metadata"].get("namespace", ""))
        if fresh is None or (fresh.get("status") or {}) == new_status:
            # No-op patches are SKIPPED, same as the host-managed branch:
            # an unconditional update_status bumps resourceVersion, which
            # re-triggers the CD informer, which re-queues this key — a
            # self-sustaining event storm with no state change behind it.
            return
        prev_ready = (fresh.get("status") or {}).get("status")
        fresh["status"] = new_status
        faultpoints.maybe_fail(FP_CONTROLLER_PATCH)
        self.client.update_status(fresh)
        # Readiness TRANSITIONS (not steady states) become Events — the
        # durable operator record of when/why a domain flipped. Recorded
        # only after the status write landed, so an Event never announces
        # a state the API does not show.
        if new_status["status"] == STATUS_READY and prev_ready != STATUS_READY:
            self.events.event(
                fresh, REASON_DOMAIN_READY,
                f"all {new_status['readyNodes']} nodes Ready")
        elif (new_status["status"] != STATUS_READY
              and prev_ready == STATUS_READY):
            self.events.event(
                fresh, REASON_DOMAIN_NOT_READY,
                f"only {new_status['readyNodes']}/{cd_num_nodes(cd)} nodes "
                "Ready", TYPE_WARNING)

    # -- teardown ------------------------------------------------------------

    def _teardown(self, cd: Obj) -> None:
        """Finalizer-ordered cleanup: children, node labels, then release
        the finalizer (controller cleanup manager semantics,
        cleanup.go:35 + node.go:41-167)."""
        name = cd["metadata"]["name"]
        ns = cd["metadata"].get("namespace", "")
        uid = cd["metadata"]["uid"]
        children_ns = self._children_ns(cd)
        ds_name, drct_name = self._daemon_child_names(cd)
        for kind, child, child_ns in (
            ("DaemonSet", ds_name, children_ns),
            ("ResourceClaimTemplate", drct_name, children_ns),
            ("ResourceClaimTemplate", cd_channel_template_name(cd), ns),
        ):
            try:
                self.client.delete(kind, child, child_ns)
            except NotFoundError:
                pass
        # Teardown lists cliques directly (not via the informer index): a
        # lagging cache missing one clique here would strand it until the
        # orphan sweep, and deletes must be exact.
        for clique in self._list_cliques_of(cd):
            try:
                self.client.delete(KIND_CLIQUE, clique["metadata"]["name"],
                                   children_ns)
            except NotFoundError:
                pass
        for node in self.client.list("Node"):
            labels = node["metadata"].get("labels") or {}
            if labels.get(NODE_LABEL_CD) == uid:
                faultpoints.maybe_fail(FP_CONTROLLER_PATCH)
                self.client.patch_labels(
                    "Node", node["metadata"]["name"], {NODE_LABEL_CD: None})
        faultpoints.maybe_fail(FP_CONTROLLER_PATCH)
        self.client.remove_finalizer(KIND_COMPUTE_DOMAIN, name, FINALIZER, ns)
