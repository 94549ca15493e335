"""The port's ComputeDomain controller, held against the JAX package's.

``TestAgainstJax`` reconciles the same ComputeDomains through both
controllers and compares what they write: the per-CD DaemonSet and the two
ResourceClaimTemplates (equal up to the API group and driver names, the
CD's uid and the rendered-hash value), and the CD's status and Events
through a sequence of clique changes (NotReady → Ready → NotReady). The
rest are the scenarios of ``tests/test_controller.py`` on the port:
host-managed reconcile, DaemonSet drift convergence, the multi-namespace
layout, daemon-pod status, the clique index, the orphan sweep and the
controller's metrics; and the lease election's rounds.
"""

import json

import pytest

from k8s_dra_driver_tpu.api import computedomain as jax_api
from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
from k8s_dra_driver_tpu.plugins.compute_domain_controller.controller import (
    ComputeDomainController as JaxController,
)
from k8s_dra_driver_tpu_torch.api import computedomain as api
from k8s_dra_driver_tpu_torch.api.computedomain import (
    FINALIZER,
    NODE_LABEL_CD,
    STATUS_READY,
    new_compute_domain,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import (
    ConflictError,
    new_object,
)
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    HOST_MANAGED_RENDEZVOUS,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.cleanup import (
    CleanupManager,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (
    ComputeDomainController,
    daemon_rct_name,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election import (
    LeaderElector,
)


@pytest.fixture()
def client():
    return FakeClient()


def make_cd(client, name="dom", ns="default", num_nodes=2):
    return client.create(new_compute_domain(name, ns, num_nodes=num_nodes))


class TestDriverManagedReconcile:
    def test_children_created_with_probes(self, client):
        ctrl = ComputeDomainController(client)
        cd = make_cd(client)
        ctrl.reconcile(cd)
        ds = client.get("DaemonSet", "dom-daemon", "default")
        ctr = ds["spec"]["template"]["spec"]["containers"][0]
        # Probes exec the daemon's own `check` subcommand
        # (compute-domain-daemon.tmpl.yaml:79-86).
        for probe in ("startupProbe", "livenessProbe", "readinessProbe"):
            assert ctr[probe]["exec"]["command"] == [
                "compute-domain-daemon", "check"], probe
        # Downward API feeds the daemon's own-pod readiness watcher.
        env_names = {e["name"] for e in ctr["env"]}
        assert {"POD_NAME", "POD_NAMESPACE", "NODE_NAME"} <= env_names
        assert client.try_get(
            "ResourceClaimTemplate", daemon_rct_name("dom"), "default")
        assert client.try_get("ResourceClaimTemplate", "dom-channel", "default")

    def test_daemonset_drift_converges(self, client):
        """A hand-edited DaemonSet is re-rendered back to the desired spec
        on the next reconcile (daemonset.go:190-260)."""
        ctrl = ComputeDomainController(client)
        cd = make_cd(client)
        ctrl.reconcile(cd)
        ds = client.get("DaemonSet", "dom-daemon", "default")
        ds["spec"]["template"]["spec"]["containers"][0]["command"] = ["evil"]
        del ds["spec"]["template"]["spec"]["containers"][0]["livenessProbe"]
        client.update(ds)

        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        ds = client.get("DaemonSet", "dom-daemon", "default")
        ctr = ds["spec"]["template"]["spec"]["containers"][0]
        assert ctr["command"] == ["compute-domain-daemon"]
        assert "livenessProbe" in ctr

    def test_server_defaulted_fields_are_not_drift(self, client):
        """A defaulting apiserver adds fields the controller never rendered
        (terminationGracePeriodSeconds, imagePullPolicy, …). Exact-equality
        drift detection would rewrite the DaemonSet every reconcile,
        forever; the compare is scoped to rendered fields instead."""
        ctrl = ComputeDomainController(client)
        ctrl.reconcile(make_cd(client))
        ds = client.get("DaemonSet", "dom-daemon", "default")
        pod = ds["spec"]["template"]["spec"]
        pod["terminationGracePeriodSeconds"] = 30          # server default
        pod["containers"][0]["imagePullPolicy"] = "IfNotPresent"
        client.update(ds)
        v1 = client.get("DaemonSet", "dom-daemon", "default")[
            "metadata"]["resourceVersion"]
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        v2 = client.get("DaemonSet", "dom-daemon", "default")[
            "metadata"]["resourceVersion"]
        assert v1 == v2  # defaults tolerated; no convergence fight

    def test_removed_rendered_field_converges_via_hash(self, client):
        """Upgrade drift the scoped compare can't see: the controller
        stops rendering a field. The rendered-hash annotation changes, so
        the stale field is still converged away."""
        ctrl = ComputeDomainController(client)
        ctrl.reconcile(make_cd(client))
        # Simulate state left by an OLDER controller that rendered an
        # extra field and stamped its own hash.
        ds = client.get("DaemonSet", "dom-daemon", "default")
        ds["spec"]["template"]["spec"]["hostNetwork"] = True  # obsolete
        ds["metadata"]["annotations"]["resource.nvidia.com/rendered-hash"] = \
            "old-revision-hash"
        client.update(ds)
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        ds = client.get("DaemonSet", "dom-daemon", "default")
        assert "hostNetwork" not in ds["spec"]["template"]["spec"]

    def test_unmodified_daemonset_not_rewritten(self, client):
        ctrl = ComputeDomainController(client)
        cd = make_cd(client)
        ctrl.reconcile(cd)
        v1 = client.get("DaemonSet", "dom-daemon", "default")[
            "metadata"]["resourceVersion"]
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        v2 = client.get("DaemonSet", "dom-daemon", "default")[
            "metadata"]["resourceVersion"]
        assert v1 == v2  # converged reconcile is a no-op write-wise

    def test_converged_reconcile_performs_zero_writes(self, client):
        """Event-storm guard: reconciling an already-converged CD must not
        write ANYTHING — every write is an informer event that re-queues
        the key, so a single no-op patch (status included) makes the loop
        self-sustaining (docs/performance.md, "Control plane")."""
        ctrl = ComputeDomainController(client)
        ctrl.reconcile(make_cd(client))
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        rv_before = client._rv
        for _ in range(3):
            ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        assert client._rv == rv_before, \
            "a converged reconcile still wrote to the API"


class TestDriverNamespace:
    """Multi-namespace layout (controller.go:38-39, daemonset.go:208):
    driver-owned children live in the driver's namespace while the CD and
    its workload RCT stay in the user's."""

    def test_children_split_across_namespaces(self, client):
        ctrl = ComputeDomainController(client, driver_namespace="gpu-dra")
        cd = client.create(new_compute_domain("dom", "team-a", num_nodes=2))
        ctrl.reconcile(cd)
        ds_name, rct_name = ctrl._daemon_child_names(cd)
        # Driver-owned children in the driver namespace, uid-based names
        # (computedomain-daemon-{UID} pattern, daemonset.go:213).
        assert cd["metadata"]["uid"] in ds_name
        assert client.try_get("DaemonSet", ds_name, "gpu-dra")
        assert client.try_get(
            "ResourceClaimTemplate", rct_name, "gpu-dra")
        assert client.try_get("DaemonSet", ds_name, "team-a") is None
        # Workload RCT with the user's CD.
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "team-a")
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "gpu-dra") is None

    def test_same_cd_name_in_two_namespaces_no_collision(self, client):
        """CD 'dom' in team-a and team-b must get DISTINCT children in the
        shared driver namespace — name-based children would flap between
        the two uids and teardown of one would kill the other."""
        ctrl = ComputeDomainController(client, driver_namespace="gpu-dra")
        cd_a = client.create(new_compute_domain("dom", "team-a", num_nodes=1))
        cd_b = client.create(new_compute_domain("dom", "team-b", num_nodes=1))
        ctrl.reconcile(cd_a)
        ctrl.reconcile(cd_b)
        ds_a, _ = ctrl._daemon_child_names(cd_a)
        ds_b, _ = ctrl._daemon_child_names(cd_b)
        assert ds_a != ds_b
        sel_a = client.get("DaemonSet", ds_a, "gpu-dra")["spec"]["template"][
            "spec"]["nodeSelector"]
        sel_b = client.get("DaemonSet", ds_b, "gpu-dra")["spec"]["template"][
            "spec"]["nodeSelector"]
        assert sel_a != sel_b  # each targets its own CD's labeled nodes
        # Re-reconciling A must not rewrite B's set (no drift flapping).
        v1 = client.get("DaemonSet", ds_b, "gpu-dra")[
            "metadata"]["resourceVersion"]
        ctrl.reconcile(client.get("ComputeDomain", "dom", "team-a"))
        assert client.get("DaemonSet", ds_b, "gpu-dra")[
            "metadata"]["resourceVersion"] == v1
        # Teardown of A leaves B intact.
        client.delete("ComputeDomain", "dom", "team-a")
        ctrl.reconcile(client.get("ComputeDomain", "dom", "team-a"))
        assert client.try_get("DaemonSet", ds_a, "gpu-dra") is None
        assert client.try_get("DaemonSet", ds_b, "gpu-dra") is not None

    def test_flag_flip_retires_colocated_children(self, client):
        """Enabling --driver-namespace on an existing deployment must retire
        the old co-located children, not leave duplicate daemon sets
        competing over the same labeled nodes."""
        ComputeDomainController(client).reconcile(
            client.create(new_compute_domain("dom", "team-a", num_nodes=1)))
        assert client.try_get("DaemonSet", "dom-daemon", "team-a")
        ctrl = ComputeDomainController(client, driver_namespace="gpu-dra")
        cd = client.get("ComputeDomain", "dom", "team-a")
        ctrl.reconcile(cd)
        assert client.try_get("DaemonSet", "dom-daemon", "team-a") is None
        assert client.try_get(
            "ResourceClaimTemplate", daemon_rct_name("dom"), "team-a") is None
        ds_name, _ = ctrl._daemon_child_names(cd)
        assert client.try_get("DaemonSet", ds_name, "gpu-dra")

    def test_status_aggregates_driver_namespace_cliques(self, client):
        from k8s_dra_driver_tpu_torch.api.computedomain import new_clique
        ctrl = ComputeDomainController(client, driver_namespace="gpu-dra")
        cd = client.create(new_compute_domain("dom", "team-a", num_nodes=1))
        ctrl.reconcile(cd)
        clique = new_clique(cd["metadata"]["uid"], "sliceX", "gpu-dra",
                            owner_cd_name="dom")
        clique["daemons"] = [{"nodeName": "n0", "index": 0,
                              "status": "Ready"}]
        client.create(clique)
        ctrl.reconcile(client.get("ComputeDomain", "dom", "team-a"))
        assert client.get("ComputeDomain", "dom", "team-a")[
            "status"]["status"] == STATUS_READY

    def test_non_clique_daemon_pods_feed_status(self, client):
        """A node whose daemon never forms a clique (fabric fault, lone
        node) must still appear in status — via its POD's kubelet Ready
        condition (cdstatus.go:213-219, daemonsetpods.go:43)."""
        ctrl = ComputeDomainController(client)
        cd = make_cd(client, num_nodes=2)
        ctrl.reconcile(cd)
        ds_name, _ = ctrl._daemon_child_names(cd)
        for node, ready in (("n0", "True"), ("n1", "False")):
            pod = new_object("Pod", f"{ds_name}-{node}", "default",
                             api_version="v1",
                             spec={"nodeName": node})
            pod["metadata"]["labels"] = {"app": ds_name}
            pod["status"] = {"conditions": [
                {"type": "Ready", "status": ready}]}
            client.create(pod)
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        status = client.get("ComputeDomain", "dom", "default")["status"]
        by_node = {n["nodeName"]: n["status"] for n in status["nodes"]}
        assert by_node == {"n0": STATUS_READY, "n1": "NotReady"}
        assert status["readyNodes"] == 1
        assert status["status"] == "NotReady"  # want 2, have 1

    def test_clique_nodes_not_double_counted_with_pods(self, client):
        """A node present in a clique AND running a daemon pod counts once,
        with the clique record (richer: index/coords) winning."""
        from k8s_dra_driver_tpu_torch.api.computedomain import new_clique
        ctrl = ComputeDomainController(client)
        cd = make_cd(client, num_nodes=1)
        ctrl.reconcile(cd)
        ds_name, _ = ctrl._daemon_child_names(cd)
        clique = new_clique(cd["metadata"]["uid"], "sliceX", "default",
                            owner_cd_name="dom")
        clique["daemons"] = [{"nodeName": "n0", "index": 0,
                              "status": "Ready"}]
        client.create(clique)
        pod = new_object("Pod", f"{ds_name}-n0", "default", api_version="v1",
                         spec={"nodeName": "n0"})
        pod["metadata"]["labels"] = {"app": ds_name}
        pod["status"] = {"conditions": [{"type": "Ready", "status": "False"}]}
        client.create(pod)
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        status = client.get("ComputeDomain", "dom", "default")["status"]
        assert len(status["nodes"]) == 1
        assert status["nodes"][0]["index"] == 0  # the clique record
        assert status["status"] == STATUS_READY

    def test_colocated_cd_named_cd_prefix_gets_pod_events(self, client):
        """Co-located layout, CD literally named 'cd-edge': pod events must
        resolve by ns/name, not be mis-parsed as a uid stem and dropped."""
        ctrl = ComputeDomainController(client)
        cd = client.create(new_compute_domain("cd-edge", "default",
                                              num_nodes=1))
        ctrl.reconcile(cd)
        ds_name, _ = ctrl._daemon_child_names(cd)
        pod = new_object("Pod", f"{ds_name}-n0", "default", api_version="v1",
                         spec={"nodeName": "n0"})
        pod["metadata"]["labels"] = {"app": ds_name}
        pod["status"] = {"conditions": [{"type": "Ready", "status": "True"}]}
        client.create(pod)
        enqueued = []
        ctrl.queue.enqueue = (  # capture instead of running the loop
            lambda key, item, fn, **kw: enqueued.append(key))
        ctrl._enqueue_daemon_pod_owner(pod)
        assert enqueued == ["default/cd-edge"]

    def test_live_loop_daemon_pod_event_triggers_aggregation(self, client):
        """A daemon-pod readiness flip alone (no clique ever) must reach
        CD status through the pod informer."""
        import time
        ctrl = ComputeDomainController(client)
        ctrl.cleanup.interval = 3600.0
        ctrl.start()
        try:
            cd = client.create(new_compute_domain("dom", "default",
                                                  num_nodes=1))
            ds_name, _ = ctrl._daemon_child_names(cd)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and client.try_get(
                    "DaemonSet", ds_name, "default") is None:
                time.sleep(0.02)
            pod = new_object("Pod", f"{ds_name}-n0", "default",
                             api_version="v1", spec={"nodeName": "n0"})
            pod["metadata"]["labels"] = {"app": ds_name}
            pod["status"] = {"conditions": [
                {"type": "Ready", "status": "True"}]}
            client.create(pod)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                status = (client.get("ComputeDomain", "dom", "default")
                          .get("status") or {})
                if status.get("status") == STATUS_READY:
                    break
                time.sleep(0.02)
            else:
                pytest.fail("daemon-pod event never reached CD status")
        finally:
            ctrl.stop()

    def test_live_loop_aggregates_with_scoped_namespaces(self, client):
        """--namespace=team-a --driver-namespace=gpu-dra: a clique event in
        the DRIVER namespace must re-reconcile the team-a CD through the
        informers (the co-location assumption would drop it and Ready would
        never fire)."""
        import time

        from k8s_dra_driver_tpu_torch.api.computedomain import new_clique
        ctrl = ComputeDomainController(
            client, namespace="team-a", driver_namespace="gpu-dra")
        ctrl.cleanup.interval = 3600.0
        ctrl.start()
        try:
            cd = client.create(
                new_compute_domain("dom", "team-a", num_nodes=1))
            ds_name, _ = ctrl._daemon_child_names(cd)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and client.try_get(
                    "DaemonSet", ds_name, "gpu-dra") is None:
                time.sleep(0.02)
            assert client.try_get("DaemonSet", ds_name, "gpu-dra")
            clique = new_clique(cd["metadata"]["uid"], "sliceX", "gpu-dra",
                                owner_cd_name="dom")
            clique["daemons"] = [{"nodeName": "n0", "index": 0,
                                  "status": "Ready"}]
            client.create(clique)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                status = (client.get("ComputeDomain", "dom", "team-a")
                          .get("status") or {}).get("status")
                if status == STATUS_READY:
                    break
                time.sleep(0.02)
            else:
                pytest.fail("clique event in driver ns never aggregated")
        finally:
            ctrl.stop()

    def test_sweep_covers_driver_namespace_orphans(self, client):
        """Orphaned children in the DRIVER namespace are swept even though
        CDs live elsewhere."""
        ctrl = ComputeDomainController(
            client, namespace="team-a", driver_namespace="gpu-dra")
        orphan = new_object("DaemonSet", "ghost-daemon", "gpu-dra",
                            api_version="apps/v1", spec={})
        orphan["metadata"]["ownerReferences"] = [{
            "kind": "ComputeDomain", "name": "ghost", "uid": "dead"}]
        client.create(orphan)
        removed = ctrl.cleanup.sweep_once()
        assert removed["children"] == 1
        assert client.try_get("DaemonSet", "ghost-daemon", "gpu-dra") is None

    def test_teardown_cleans_both_namespaces(self, client):
        ctrl = ComputeDomainController(client, driver_namespace="gpu-dra")
        cd = client.create(new_compute_domain("dom", "team-a", num_nodes=1))
        ctrl.reconcile(cd)
        client.delete("ComputeDomain", "dom", "team-a")
        ctrl.reconcile(client.get("ComputeDomain", "dom", "team-a"))
        assert client.try_get("ComputeDomain", "dom", "team-a") is None
        assert client.try_get("DaemonSet", "dom-daemon", "gpu-dra") is None
        assert client.try_get(
            "ResourceClaimTemplate", daemon_rct_name("dom"), "gpu-dra") is None
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "team-a") is None


class TestCliqueIndex:
    """Status aggregation reads cliques from an owner-uid index fed by the
    clique informer, not a per-reconcile LIST (docs/performance.md)."""

    def test_index_serves_cliques_and_prunes_on_delete(self, client):
        import time

        from k8s_dra_driver_tpu_torch.api.computedomain import new_clique
        ctrl = ComputeDomainController(client)
        ctrl.cleanup.interval = 3600.0
        ctrl.start()
        try:
            cd = make_cd(client, num_nodes=1)
            uid = cd["metadata"]["uid"]
            clique = new_clique(uid, "sliceX", "default", owner_cd_name="dom")
            clique["daemons"] = [{"nodeName": "n0", "index": 0,
                                  "status": "Ready"}]
            client.create(clique)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if (client.get("ComputeDomain", "dom", "default")
                        .get("status") or {}).get("status") == STATUS_READY:
                    break
                time.sleep(0.02)
            else:
                pytest.fail("clique never aggregated into Ready")
            # The aggregation path really was the index, and LISTs are not
            # needed while the loop runs.
            with ctrl._clique_index_mu:
                assert uid in ctrl._clique_index
            assert [c["metadata"]["name"] for c in ctrl._cliques_of(cd)] == \
                [clique["metadata"]["name"]]
            # Deleting the clique prunes the index and drops readiness.
            client.delete("ComputeDomainClique",
                          clique["metadata"]["name"], "default")
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                status = (client.get("ComputeDomain", "dom", "default")
                          .get("status") or {})
                with ctrl._clique_index_mu:
                    pruned = uid not in ctrl._clique_index
                if pruned and status.get("status") == "NotReady":
                    break
                time.sleep(0.02)
            else:
                pytest.fail("clique deletion never pruned index/status")
        finally:
            ctrl.stop()

    def test_direct_reconcile_falls_back_to_list(self, client):
        """Without the live loop (tests, one-shots) _cliques_of lists —
        the pre-index behavior, still exact."""
        from k8s_dra_driver_tpu_torch.api.computedomain import new_clique
        ctrl = ComputeDomainController(client)
        cd = make_cd(client, num_nodes=1)
        clique = new_clique(cd["metadata"]["uid"], "sliceX", "default",
                            owner_cd_name="dom")
        clique["daemons"] = [{"nodeName": "n0", "index": 0,
                              "status": "Ready"}]
        client.create(clique)
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        assert client.get("ComputeDomain", "dom", "default")[
            "status"]["status"] == STATUS_READY


class TestHostManagedReconcile:
    def test_only_workload_rct_created(self, client):
        """Host-managed: no daemon RCT, no DaemonSet, exactly the workload
        RCT (onAddOrUpdateHostManaged, computedomain.go:429-470)."""
        ctrl = ComputeDomainController(
            client, gates=new_feature_gates(f"{HOST_MANAGED_RENDEZVOUS}=true"))
        cd = make_cd(client)
        ctrl.reconcile(cd)
        assert client.try_get("DaemonSet", "dom-daemon", "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", daemon_rct_name("dom"), "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "default") is not None
        # Ready means only admitted + workload RCT exists.
        assert client.get("ComputeDomain", "dom", "default")[
            "status"]["status"] == STATUS_READY
        # Finalizer still owned by the controller.
        assert FINALIZER in client.get(
            "ComputeDomain", "dom", "default")["metadata"]["finalizers"]

    def test_mode_flip_removes_driver_managed_children(self, client):
        """Switching an existing cluster to host-managed must tear down the
        previously created DaemonSet + daemon RCT — the orphan sweep won't
        (their CD is alive)."""
        ComputeDomainController(client).reconcile(make_cd(client))
        assert client.try_get("DaemonSet", "dom-daemon", "default")
        ctrl = ComputeDomainController(
            client, gates=new_feature_gates(f"{HOST_MANAGED_RENDEZVOUS}=true"))
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        assert client.try_get("DaemonSet", "dom-daemon", "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", daemon_rct_name("dom"), "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "default") is not None

    def test_combined_mode_and_namespace_flip_removes_both_layouts(
            self, client):
        """driver-managed co-located → host-managed + driver-namespace in
        ONE flip: children exist under the LEGACY names in the CD's
        namespace, not the uid-stemmed names the host-managed branch's
        current-layout delete targets — both layouts must be swept (the
        orphan sweep spares them: their CD is alive)."""
        ComputeDomainController(client).reconcile(make_cd(client))
        assert client.try_get("DaemonSet", "dom-daemon", "default")
        ctrl = ComputeDomainController(
            client, driver_namespace="gpu-dra",
            gates=new_feature_gates(f"{HOST_MANAGED_RENDEZVOUS}=true"))
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        assert client.try_get("DaemonSet", "dom-daemon", "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", daemon_rct_name("dom"), "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "default") is not None

    def test_teardown(self, client):
        ctrl = ComputeDomainController(
            client, gates=new_feature_gates(f"{HOST_MANAGED_RENDEZVOUS}=true"))
        cd = make_cd(client)
        ctrl.reconcile(cd)
        client.delete("ComputeDomain", "dom", "default")  # sets deletion ts
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        assert client.try_get("ComputeDomain", "dom", "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "default") is None


class TestCleanupManager:
    def _orphan_setup(self, client):
        """A CD, its children, plus orphans referencing a vanished CD."""
        ctrl = ComputeDomainController(client)
        cd = make_cd(client)
        ctrl.reconcile(cd)
        dead_uid = "dead-cd-uid"
        orphan_ds = new_object(
            "DaemonSet", "ghost-daemon", "default", api_version="apps/v1",
            spec={})
        orphan_ds["metadata"]["ownerReferences"] = [{
            "kind": "ComputeDomain", "name": "ghost", "uid": dead_uid}]
        client.create(orphan_ds)
        orphan_rct = new_object(
            "ResourceClaimTemplate", "ghost-channel", "default",
            api_version="resource.k8s.io/v1", spec={})
        orphan_rct["metadata"]["ownerReferences"] = [{
            "kind": "ComputeDomain", "name": "ghost", "uid": dead_uid}]
        client.create(orphan_rct)
        client.create(new_object(
            "ComputeDomainClique", f"{dead_uid}.sliceX", "default",
            api_version="resource.nvidia.com/v1beta1", daemons=[]))
        client.create(new_object("Node", "host9"))
        client.patch_labels("Node", "host9", {NODE_LABEL_CD: dead_uid})
        return ctrl, cd, dead_uid

    def test_sweep_removes_only_orphans(self, client):
        ctrl, cd, _ = self._orphan_setup(client)
        removed = CleanupManager(client).sweep_once()
        assert removed == {"children": 2, "cliques": 1, "labels": 1}
        # Orphans gone.
        assert client.try_get("DaemonSet", "ghost-daemon", "default") is None
        assert client.try_get(
            "ResourceClaimTemplate", "ghost-channel", "default") is None
        assert (client.get("Node", "host9")["metadata"].get("labels") or {}
                ).get(NODE_LABEL_CD) is None
        # The live CD's children untouched.
        assert client.try_get("DaemonSet", "dom-daemon", "default")
        assert client.try_get(
            "ResourceClaimTemplate", "dom-channel", "default")
        # Idempotent.
        assert CleanupManager(client).sweep_once() == {
            "children": 0, "cliques": 0, "labels": 0}

    def test_stale_snapshot_does_not_reap_fresh_children(self, client):
        """TOCTOU guard: a CD created after the live-uid snapshot must not
        see its fresh children deleted — each delete re-checks the owner."""
        ctrl = ComputeDomainController(client)
        cd = make_cd(client)
        ctrl.reconcile(cd)
        mgr = CleanupManager(client)
        # Simulate the race: the snapshot predates the CD's creation.
        mgr._live_cd_uids = lambda: set()
        removed = mgr.sweep_once()
        assert removed == {"children": 0, "cliques": 0, "labels": 0}
        assert client.try_get("DaemonSet", "dom-daemon", "default")

    def test_live_labels_survive(self, client):
        ctrl = ComputeDomainController(client)
        cd = make_cd(client)
        ctrl.reconcile(cd)
        client.create(new_object("Node", "host0"))
        client.patch_labels(
            "Node", "host0", {NODE_LABEL_CD: cd["metadata"]["uid"]})
        assert CleanupManager(client).sweep_once()["labels"] == 0
        assert client.get("Node", "host0")["metadata"]["labels"][
            NODE_LABEL_CD] == cd["metadata"]["uid"]

    def test_reconcile_kicks_sweep(self, client):
        """Reconcile requests an immediate sweep instead of waiting out the
        10-minute period (computedomain.go:405-406)."""
        import time
        ctrl, _, dead_uid = self._orphan_setup(client)
        ctrl.cleanup.interval = 3600.0  # periodic path effectively off
        ctrl.cleanup.start()
        try:
            ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if client.try_get("DaemonSet", "ghost-daemon",
                                  "default") is None:
                    break
                time.sleep(0.02)
            else:
                pytest.fail("kicked sweep never removed the orphan")
        finally:
            ctrl.cleanup.stop()


class TestControllerMetrics:
    def test_reconcile_and_sweep_counters(self, client):
        ctrl = ComputeDomainController(client)
        cd = make_cd(client)
        ctrl.reconcile(cd)
        assert ctrl.metrics.reconciles_total.value(outcome="success") == 1
        # Orphan sweep counts by category.
        orphan = new_object("DaemonSet", "ghost", "default",
                            api_version="apps/v1", spec={})
        orphan["metadata"]["ownerReferences"] = [{
            "kind": "ComputeDomain", "name": "g", "uid": "dead"}]
        client.create(orphan)
        ctrl.cleanup.sweep_once()
        assert ctrl.metrics.orphans_swept_total.value(
            category="children") == 1
        # Teardown outcome recorded.
        client.delete("ComputeDomain", "dom", "default")
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        assert ctrl.metrics.reconciles_total.value(outcome="teardown") == 1
        text = ctrl.metrics.registry.expose_text()
        assert "gpu_dra_cd_reconciles_total" in text

    def test_cd_gauge_drops_after_delete_event(self, client):
        """The gauge follows the informer-fed uid map: after the DELETED
        event lands, it reads 0 even though no reconcile fires again."""
        import time as _t
        ctrl = ComputeDomainController(client)
        ctrl.cleanup.interval = 3600.0
        ctrl.start()
        try:
            make_cd(client)
            deadline = _t.monotonic() + 5.0
            while _t.monotonic() < deadline and \
                    ctrl.metrics.compute_domains.value() != 1.0:
                _t.sleep(0.02)
            assert ctrl.metrics.compute_domains.value() == 1.0
            client.delete("ComputeDomain", "dom", "default")
            deadline = _t.monotonic() + 5.0
            while _t.monotonic() < deadline and \
                    ctrl.metrics.compute_domains.value() != 0.0:
                _t.sleep(0.02)
            assert ctrl.metrics.compute_domains.value() == 0.0
        finally:
            ctrl.stop()


class TestDaemonPodNamespaceScoping:
    def test_same_named_cds_in_two_namespaces_do_not_cross_count(self, client):
        """With an UNSCOPED pod informer (co-located layout caches all
        namespaces), two same-named CDs share the '<cd>-daemon' app label
        — the cached-path filter must also match the namespace, or each
        CD counts the other's daemon pods (phantom nodes, inflated
        readyNodes; ADVICE r5)."""
        ctrl = ComputeDomainController(client)
        cd_a = client.create(new_compute_domain("dom", "team-a",
                                                num_nodes=1))
        cd_b = client.create(new_compute_domain("dom", "team-b",
                                                num_nodes=1))
        ctrl.reconcile(cd_a)
        ctrl.reconcile(cd_b)
        ds_name, _ = ctrl._daemon_child_names(cd_a)
        for ns, node in (("team-a", "na"), ("team-b", "nb")):
            pod = new_object("Pod", f"{ds_name}-{node}", ns,
                             api_version="v1", spec={"nodeName": node})
            pod["metadata"]["labels"] = {"app": ds_name}
            pod["status"] = {"conditions": [
                {"type": "Ready", "status": "True"}]}
            client.create(pod)

        class _AllNamespacesInformer:
            def cached_list(self_inner):
                return client.list("Pod")  # unscoped: both namespaces

        ctrl._pod_informer = _AllNamespacesInformer()
        pods_a = ctrl._daemon_pods_of(cd_a)
        assert [p["metadata"]["namespace"] for p in pods_a] == ["team-a"]
        ctrl.reconcile(client.get("ComputeDomain", "dom", "team-a"))
        status = client.get("ComputeDomain", "dom", "team-a")["status"]
        assert status["readyNodes"] == 1  # not 2: team-b's pod excluded
        assert [n["nodeName"] for n in status["nodes"]] == ["na"]


class TestLeaderElection:
    def test_single_candidate_acquires(self, client):
        started = []
        e = LeaderElector(client, "lease", "a",
                          on_started_leading=lambda: started.append(1))
        e.run_once()
        assert e.is_leader and started == [1] and e.epoch == 1

    def test_second_candidate_blocked_until_release(self, client):
        a = LeaderElector(client, "lease", "a")
        b = LeaderElector(client, "lease", "b")
        a.run_once()
        b.run_once()
        assert a.is_leader and not b.is_leader
        # Release-on-cancel: b acquires immediately, no TTL wait.
        a.stop()
        b.run_once()
        assert b.is_leader

    def test_transient_conflict_tolerated_until_renew_deadline(self, client):
        now, stopped = [1000.0], []
        e = LeaderElector(client, "lease", "a", lease_duration=15.0,
                          renew_deadline=10.0, clock=lambda: now[0],
                          on_stopped_leading=lambda: stopped.append(1))
        e.run_once()
        real_update, fail = client.update, [True]

        def flaky_update(obj):
            if fail[0]:
                raise ConflictError("transient")
            return real_update(obj)
        client.update = flaky_update
        now[0] += 2.0
        e.run_once()  # one failed renewal: still leader
        assert e.is_leader and stopped == []
        fail[0] = False
        now[0] += 2.0
        e.run_once()  # renewal recovers
        assert e.is_leader and stopped == []

    def test_api_outage_steps_down_after_renew_deadline(self, client):
        now, stopped = [1000.0], []
        e = LeaderElector(client, "lease", "a", lease_duration=15.0,
                          renew_deadline=10.0, clock=lambda: now[0],
                          on_stopped_leading=lambda: stopped.append(1))
        e.run_once()

        def outage(*a, **kw):
            raise OSError("api down")
        client.update = outage
        client.try_get = outage
        now[0] += 5.0
        e.run_once()  # inside the deadline: tolerate
        assert e.is_leader and stopped == []
        now[0] += 6.0  # 11 s since the last renewal > the 10 s deadline
        e.run_once()
        assert not e.is_leader and stopped == [1]

    def test_expired_lease_is_taken_over(self, client):
        now = [1000.0]
        a = LeaderElector(client, "lease", "a", lease_duration=15.0,
                          clock=lambda: now[0])
        b = LeaderElector(client, "lease", "b", lease_duration=15.0,
                          clock=lambda: now[0])
        a.run_once()
        now[0] += 20.0  # a's renewals stop; the lease expires
        b.run_once()
        assert b.is_leader
        a.run_once()
        assert not a.is_leader
        lease = client.get("Lease", "lease", "default")
        assert lease["spec"]["holderIdentity"] == "b"
        assert lease["spec"]["leaseTransitions"] == 2


class TestMultiCliqueStatus:
    def test_nodes_in_worker_order_across_cliques(self, client):
        """HGX H100 nodes are cliques of one: every daemon is index 0 of
        its own, so status lists nodes by (cliqueID, index), the order the
        workers' ranks follow, and counts each once."""
        ctrl = ComputeDomainController(client)
        cd = make_cd(client, num_nodes=3)
        uid = cd["metadata"]["uid"]
        for node, cid in (("n0", "cC"), ("n1", "cA"), ("n2", "cB")):
            clique = api.new_clique(uid, cid, "default", owner_cd_name="dom")
            clique["daemons"] = [{"nodeName": node, "cliqueID": cid,
                                  "index": 0, "status": "Ready"}]
            client.create(clique)
        ctrl.reconcile(client.get("ComputeDomain", "dom", "default"))
        status = client.get("ComputeDomain", "dom", "default")["status"]
        assert [n["nodeName"] for n in status["nodes"]] == ["n1", "n2", "n0"]
        assert status["readyNodes"] == 3 and status["status"] == STATUS_READY


def _normalize(obj, uid, jax):
    """An object as the other package would write it: driver names and API
    groups mapped to the port's, the CD's uid and the rendered hash
    blanked, server-assigned metadata dropped."""
    text = json.dumps(obj, sort_keys=True).replace(uid, "<uid>")
    if jax:
        text = (text.replace("resource.tpu.google.com", "resource.nvidia.com")
                .replace("tpu.google.com", "nvidia.com"))
    out = json.loads(text)
    meta = out["metadata"]
    for k in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        meta.pop(k, None)
    if "resource.nvidia.com/rendered-hash" in meta.get("annotations", {}):
        meta["annotations"]["resource.nvidia.com/rendered-hash"] = "<hash>"
    return out


class TestAgainstJax:
    """Both controllers reconcile the same ComputeDomains; what they write
    is equal up to the names of the two packages."""

    def _sides(self, **cd_kwargs):
        out = []
        for jax in (True, False):
            mod, cls = (jax_api, JaxController) if jax else (
                api, ComputeDomainController)
            c = (JaxClient if jax else FakeClient)()
            cd = c.create(mod.new_compute_domain("dom", **cd_kwargs))
            out.append((jax, mod, c, cls(c), cd))
        return out

    @pytest.mark.parametrize("kwargs", [
        {"num_nodes": 2},
        {"namespace": "team-a", "num_nodes": 4, "allocation_mode": "All",
         "channel_template_name": "chan"}], ids=["single", "all-channels"])
    def test_rendered_children_match(self, kwargs):
        rendered = []
        for jax, _, c, ctrl, cd in self._sides(**kwargs):
            ctrl.reconcile(cd)
            uid = cd["metadata"]["uid"]
            objs = {}
            for kind in ("DaemonSet", "ResourceClaimTemplate"):
                for o in c.list(kind):
                    objs[(kind, o["metadata"]["name"])] = _normalize(
                        o, uid, jax)
            fresh = c.get("ComputeDomain", "dom", cd["metadata"].get(
                "namespace", ""))
            objs["finalizers"] = [f.replace("tpu.google.com", "nvidia.com")
                                  for f in fresh["metadata"]["finalizers"]]
            rendered.append(objs)
        assert sorted(rendered[1], key=str) == sorted(rendered[0], key=str)
        assert rendered[1] == rendered[0]
        assert len([k for k in rendered[1] if k != "finalizers"]) == 3

    # Each step: the daemons of the CD's one clique, as (node, index,
    # status), before a reconcile.
    STEPS = [
        [],
        [("n0", 0, "Ready")],
        [("n0", 0, "Ready"), ("n1", 1, "NotReady")],
        [("n0", 0, "Ready"), ("n1", 1, "Ready")],
        [("n1", 1, "Ready")],
        [("n1", 1, "Ready"), ("n0", 0, "Ready")],
    ]

    def test_status_transitions_match(self):
        history = []
        for jax, mod, c, ctrl, cd in self._sides(num_nodes=2):
            uid = cd["metadata"]["uid"]
            clique = c.create(mod.new_clique(uid, "c.0", "default",
                                             owner_cd_name="dom"))
            seen = []
            for daemons in self.STEPS:
                clique = c.get("ComputeDomainClique", f"{uid}.c.0",
                               "default")
                clique["daemons"] = [mod.DaemonInfo(
                    node_name=n, clique_id="c.0", index=i,
                    status=st).to_dict() for n, i, st in daemons]
                c.update(clique)
                ctrl.reconcile(c.get("ComputeDomain", "dom", "default"))
                seen.append(c.get("ComputeDomain", "dom", "default")[
                    "status"])
            events = sorted((e.get("reason"), e.get("type"))
                            for e in c.list("Event"))
            history.append((seen, events))
        (jax_seen, jax_events), (port_seen, port_events) = history
        assert port_seen == jax_seen
        assert port_events == jax_events
        assert [s["status"] for s in port_seen] == [
            "NotReady", "NotReady", "NotReady", "Ready", "NotReady",
            "Ready"]
        assert ("DomainReady", "Normal") in port_events
        assert ("DomainNotReady", "Warning") in port_events

    def test_teardown_matches(self):
        left = []
        for jax, mod, c, ctrl, cd in self._sides(num_nodes=1):
            ctrl.reconcile(cd)
            uid = cd["metadata"]["uid"]
            c.create(mod.new_clique(uid, "c.0", "default",
                                    owner_cd_name="dom"))
            c.create(new_object("Node", "n0"))
            c.patch_labels("Node", "n0", {mod.NODE_LABEL_CD: uid})
            c.delete("ComputeDomain", "dom", "default")
            ctrl.reconcile(c.get("ComputeDomain", "dom", "default"))
            left.append(sorted(
                (k, o["metadata"]["name"]) for k in (
                    "ComputeDomain", "DaemonSet", "ResourceClaimTemplate",
                    "ComputeDomainClique") for o in c.list(k))
                + [c.get("Node", "n0")["metadata"].get("labels")])
        assert left[1] == left[0] == [{}]
