"""The quickstart specs on the GPU port: the JAX package's
``tests/test_scenarios.py::TestQuickstartSpecs`` (all nine cases, the
extended-resource ones included) and ``tests/test_vfio.py::
TestPassthroughDemoSpec`` on ``demo/specs/quickstart-gpu/``, through the
port's in-memory substrate: the GPU chart's DeviceClasses, two ``h100-8``
nodes in MIG mode with both kubelet plugins (``DynamicMIG``), the
controller, and ``tests/test_torch_scenarios.py``'s :func:`run_pod`.

``TestAgainstJax`` holds the port's ``synthesize_extended_claims`` against
the JAX allocator's on the same pods, ``google.com/tpu`` read as
``nvidia.com/gpu``: the same claim object (annotations, ownerReference,
requests), the same idempotence and replacement, the same errors."""

from pathlib import Path

import pytest
import yaml
from test_torch_scenarios import run_pod

from k8s_dra_driver_tpu_torch.api.computedomain import (
    NODE_LABEL_CD,
    STATUS_READY,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    FakeVfioKernel,
    MockDeviceLib,
    SysfsDeviceLib,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import AllocationError
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
from k8s_dra_driver_tpu_torch.pkg.featuregates import new_feature_gates
from k8s_dra_driver_tpu_torch.pkg.manifests import load_file
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller \
    import ComputeDomainController
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
    ComputeDomainDaemon,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    CD_DRIVER_NAME,
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.vfio import (
    VfioPciManager,
)

REPO = Path(__file__).resolve().parent.parent
SPECS = REPO / "demo" / "specs" / "quickstart-gpu"
CLASSES = REPO / "deployments" / "helm" / "gpu-dra-driver" / "templates" \
    / "deviceclasses.yaml"
GPU = "gpu.nvidia.com"


def load_spec(name: str) -> list[dict]:
    return [d for d in yaml.safe_load_all((SPECS / f"{name}.yaml")
                                          .read_text()) if d]


def apply_device_classes(client) -> None:
    """The chart's DeviceClasses are the allocation contract: the real
    manifest, read by the port's own loader."""
    for doc in load_file(CLASSES):
        client.create(doc)


def apply_spec(client, docs: list[dict]) -> None:
    for doc in docs:
        if doc["kind"] not in ("Pod", "Namespace"):
            client.create(doc)


def pods_of(docs):
    return [d for d in docs if d["kind"] == "Pod"]


def visible(env: dict) -> list[str]:
    return env["CUDA_VISIBLE_DEVICES"].split(",")


@pytest.fixture()
def cluster(tmp_path):
    """Two h100-8 nodes in MIG mode, each with both drivers (the GPU one
    under DynamicMIG), and the controller: the node stack the chart's
    kubelet-plugin DaemonSet runs."""
    client = FakeClient()
    apply_device_classes(client)
    drivers, gpu_drivers, cd_drivers = {}, [], []
    for host in (0, 1):
        node = f"host{host}"
        client.create(new_object("Node", node))
        gpu = GpuDriver(client, DriverConfig(
            node_name=node, state_dir=str(tmp_path / f"gpu-{host}"),
            cdi_root=str(tmp_path / f"cdi-gpu-{host}"),
            feature_gates=new_feature_gates("DynamicMIG=true"),
            env={}, retry_timeout=0.4,
        ), device_lib=MockDeviceLib("h100-8", host_index=host,
                                    mig=True)).start()
        cd = CdDriver(client, CdDriverConfig(
            node_name=node, state_dir=str(tmp_path / f"cd-{host}"),
            cdi_root=str(tmp_path / f"cdi-cd-{host}"),
            env={}, retry_timeout=0.4,
        ), device_lib=MockDeviceLib("h100-8", host_index=host)).start()
        drivers[(GPU, node)] = gpu
        drivers[(CD_DRIVER_NAME, node)] = cd
        gpu_drivers.append(gpu)
        cd_drivers.append(cd)
    controller = ComputeDomainController(client)
    yield client, drivers, controller, gpu_drivers
    for d in gpu_drivers + cd_drivers:
        d.stop()


def _mig_slices(client, claim) -> set:
    """The (GPU, memory slice) pairs the claim's MIG device holds, read
    from the published device's placement attributes."""
    (res,) = claim["status"]["allocation"]["devices"]["results"]
    for s in client.list("ResourceSlice"):
        for d in s["spec"].get("devices") or []:
            if s["spec"]["pool"]["name"] == res["pool"] and \
                    d["name"] == res["device"]:
                a = {k: next(iter(v.values()))
                     for k, v in d["attributes"].items()}
                return {(a["parentIndex"], i) for i in range(
                    a["placementStart"],
                    a["placementStart"] + a["placementSize"])}
    raise AssertionError(f"{res} not published")


class TestQuickstartSpecs:
    def test_gpu_test1_exclusive_gpus(self, cluster):
        client, drivers, *_ = cluster
        docs = load_spec("gpu-test1")
        apply_spec(client, docs)
        runs = [run_pod(client, pod, "host0", drivers)
                for pod in pods_of(docs)]
        assert all(r.ok for r in runs), [r.errors for r in runs]
        envs = [r.container_env(drivers) for r in runs]
        assert visible(envs[0]) != visible(envs[1])
        for e in envs:
            assert len(visible(e)) == 1 and visible(e)[0].startswith("GPU-")

    def test_gpu_test2_two_containers_one_claim(self, cluster):
        client, drivers, *_ = cluster
        docs = load_spec("gpu-test2")
        apply_spec(client, docs)
        pod = pods_of(docs)[0]
        assert len(pod["spec"]["containers"]) == 2
        run = run_pod(client, pod, "host0", drivers)
        assert run.ok, run.errors
        # One claim, one GPU; both containers name that claim, so both see
        # the same injection.
        assert len(run.claims) == 1
        assert {c["resources"]["claims"][0]["name"]
                for c in pod["spec"]["containers"]} == set(run.claims)
        assert len(visible(run.container_env(drivers))) == 1

    def test_gpu_test3_cross_pod_shared_claim(self, cluster):
        client, drivers, *_ = cluster
        docs = load_spec("gpu-test3")
        apply_spec(client, docs)
        runs = [run_pod(client, pod, "host0", drivers)
                for pod in pods_of(docs)]
        assert all(r.ok for r in runs)
        # The same global claim: one allocation, prepare idempotent.
        uids = {r.claims["shared-gpu"]["metadata"]["uid"] for r in runs}
        assert len(uids) == 1
        e0, e1 = [r.container_env(drivers) for r in runs]
        assert e0["CUDA_VISIBLE_DEVICES"] == e1["CUDA_VISIBLE_DEVICES"]

    def test_gpu_test4_mig_tenants(self, cluster):
        client, drivers, _, gpu_drivers = cluster
        docs = load_spec("gpu-test4")
        apply_spec(client, docs)
        runs = [run_pod(client, pod, "host0", drivers)
                for pod in pods_of(docs)]
        assert all(r.ok for r in runs), [r.errors for r in runs]
        envs = [r.container_env(drivers) for r in runs]
        # Two isolated 3g.40gb tenants: a MIG instance each, on disjoint
        # memory slices (four each).
        mig = [visible(e) for e in envs]
        assert all(len(m) == 1 and m[0].startswith("MIG-") for m in mig)
        assert mig[0] != mig[1]
        slices = [_mig_slices(client, r.claims["mig"]) for r in runs]
        assert all(len(s) == 4 for s in slices)
        assert not (slices[0] & slices[1]), "tenants overlap"
        assert len(gpu_drivers[0].device_lib.mig_devices()) == 2

    def test_gpu_test5_compute_domain_workers(self, cluster):
        client, drivers, controller, _ = cluster
        docs = load_spec("gpu-test5")
        apply_spec(client, docs)
        cd = client.get("ComputeDomain", "dom", "gpu-test5")
        controller.reconcile(cd)
        assert client.try_get(
            "ResourceClaimTemplate", "gpu-test5-channel", "gpu-test5")
        workers = pods_of(docs)
        # No daemons yet: worker-0's channel prepare is refused retryably,
        # and host0 gets the domain's label.
        run0 = run_pod(client, workers[0], "host0", drivers)
        err = run0.results["channel"].error
        assert err is not None and not is_permanent(err)
        assert client.get("Node", "host0")["metadata"]["labels"][
            NODE_LABEL_CD] == cd["metadata"]["uid"]
        # The per-domain DaemonSet's daemons Ready on both nodes.
        for host in (0, 1):
            ComputeDomainDaemon(
                client=client,
                device_lib=MockDeviceLib("h100-8", host_index=host),
                cd_uid=cd["metadata"]["uid"], cd_name="dom",
                node_name=f"host{host}", namespace="gpu-test5",
                hostname=f"host{host}").sync_once()
        controller.reconcile(client.get("ComputeDomain", "dom", "gpu-test5"))
        assert client.get("ComputeDomain", "dom", "gpu-test5")[
            "status"]["status"] == STATUS_READY
        # Both workers run: each its rank, the same rendezvous, and every
        # GPU of its node.
        runs = [run_pod(client, workers[i], f"host{i}", drivers)
                for i in (0, 1)]
        assert all(r.ok for r in runs), [
            {k: str(v.error) for k, v in r.results.items()} for r in runs]
        envs = [r.container_env(drivers) for r in runs]
        assert {e["NODE_RANK"] for e in envs} == {"0", "1"}
        assert {(e["MASTER_ADDR"], e["MASTER_PORT"]) for e in envs} \
            == {(envs[0]["MASTER_ADDR"], envs[0]["MASTER_PORT"])}
        for e in envs:
            assert e["NNODES"] == "2"
            assert len(visible(e)) == 8

    def test_gpu_test7_extended_resource(self, cluster):
        """No claim stanza anywhere: ``nvidia.com/gpu: 2`` in container
        limits, and the implicit-claim path (KEP-5004) synthesizes a claim
        against the chart's DeviceClass that advertises the name."""
        client, drivers, *_ = cluster
        docs = load_spec("gpu-test7")
        apply_spec(client, docs)
        pod = pods_of(docs)[0]
        assert not pod["spec"].get("resourceClaims")
        run = run_pod(client, pod, "host0", drivers)
        assert run.ok, run.errors
        claim = run.claims["extended-resources"]
        assert claim["metadata"]["name"] == "extres-pod-extended-resources"
        assert claim["metadata"]["annotations"][
            "resource.kubernetes.io/extended-resource-names"] == \
            "nvidia.com/gpu"
        assert len(visible(run.container_env(drivers))) == 2
        # Running the pod again is idempotent: the same implicit claim.
        run2 = run_pod(client, pod, "host0", drivers)
        assert run2.ok
        assert (run2.claims["extended-resources"]["metadata"]["uid"]
                == claim["metadata"]["uid"])

    def test_extended_resource_stale_claim_replaced(self, cluster):
        """The pod deleted and recreated (same name, new uid) before its
        implicit claim is collected: the stale claim, owned by the dead
        incarnation, is replaced, not reused."""
        client, drivers, *_ = cluster
        docs = load_spec("gpu-test7")
        apply_spec(client, docs)
        pod = pods_of(docs)[0]
        run = run_pod(client, pod, "host0", drivers)
        assert run.ok, run.errors
        old_uid = run.claims["extended-resources"]["metadata"]["uid"]
        drivers[(GPU, "host0")].unprepare_resource_claims(
            [ClaimRef(uid=old_uid, name="extres-pod-extended-resources",
                      namespace="gpu-test7")])
        Allocator(client).release(run.claims["extended-resources"])
        pod2 = dict(pod, metadata={**pod["metadata"], "uid": "reborn-uid"})
        run2 = run_pod(client, pod2, "host0", drivers)
        assert run2.ok, run2.errors
        fresh = run2.claims["extended-resources"]
        assert fresh["metadata"]["uid"] != old_uid
        assert fresh["metadata"]["ownerReferences"][0]["uid"] == "reborn-uid"

    def test_extended_resource_never_deletes_user_claim(self, cluster):
        """A user's claim that happens to be named
        '<pod>-extended-resources' is left alone: the implicit path fails
        loudly instead of destroying an object it does not own."""
        client, drivers, *_ = cluster
        docs = load_spec("gpu-test7")
        apply_spec(client, docs)
        pod = pods_of(docs)[0]
        user_claim = client.create(new_object(
            "ResourceClaim", "extres-pod-extended-resources", "gpu-test7",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "mine", "exactly": {
                "deviceClassName": GPU,
                "allocationMode": "ExactCount", "count": 1}}]}}))
        run = run_pod(client, pod, "host0", drivers)
        assert isinstance(run.errors["extended-resources"], AllocationError)
        survivor = client.get("ResourceClaim",
                              "extres-pod-extended-resources", "gpu-test7")
        assert survivor["metadata"]["uid"] == user_claim["metadata"]["uid"]

    def test_extended_resource_exhaustion_fails_cleanly(self, cluster):
        """More nvidia.com/gpu than the node publishes fails allocation
        instead of handing out a partial set."""
        client, drivers, *_ = cluster
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "greedy", "namespace": "default",
                         "uid": "greedy-uid"},
            "spec": {"containers": [{
                "name": "ctr",
                "resources": {"limits": {"nvidia.com/gpu": "9"}},  # > 8
            }]},
        }
        run = run_pod(client, pod, "host0", drivers)
        assert not run.ok
        assert "extended-resources" in run.errors
        assert not any(d.get("status", {}).get("allocation") for d in
                       client.list("ResourceClaim", "default"))


class TestPassthroughDemoSpec:
    def test_gpu_test6_end_to_end(self, tmp_path):
        """The shipped passthrough spec (gpu-test6) prepares over the
        materialized tree: the claim instantiated from its template, the
        GPU rebound to vfio-pci, the launcher's env naming its PCI
        address; unprepare hands the GPU back to nvidia."""
        dev_root, sysfs_root, proc_root = MockDeviceLib(
            "h100-8").materialize(tmp_path / "tree")
        mgr = VfioPciManager(sysfs_root, dev_root,
                             kernel=FakeVfioKernel(sysfs_root, dev_root))
        client = FakeClient()
        apply_device_classes(client)
        driver = GpuDriver(client, DriverConfig(
            node_name="node-a", state_dir=str(tmp_path / "state"),
            cdi_root=str(tmp_path / "cdi"),
            feature_gates=new_feature_gates("PassthroughSupport=true"),
            env={}, retry_timeout=0.5), device_lib=SysfsDeviceLib(
                dev_root=dev_root, sysfs_root=sysfs_root,
                proc_root=proc_root, env={}))
        driver.state._vfio = mgr
        driver.start()
        try:
            docs = load_spec("gpu-test6")
            rct = next(d for d in docs
                       if d["kind"] == "ResourceClaimTemplate")
            client.create(rct)
            pod = next(d for d in docs if d["kind"] == "Pod")
            rc = pod["spec"]["resourceClaims"][0]
            claim = client.create(new_object(
                "ResourceClaim", f"{pod['metadata']['name']}-{rc['name']}",
                rct["metadata"]["namespace"],
                api_version="resource.k8s.io/v1", spec=rct["spec"]["spec"]))
            allocated = Allocator(client).allocate(claim)
            uid = allocated["metadata"]["uid"]
            res = driver.prepare_resource_claims([allocated])[uid]
            assert res.error is None, res.error
            spec = driver.cdi.read_claim_spec(uid)
            env = dict(e.split("=", 1) for e in spec["containerEdits"]["env"])
            bdf = env["GPU_PASSTHROUGH_PCI_ADDRESSES"]
            assert mgr.current_driver(bdf) == "vfio-pci"
            assert env["CUDA_VISIBLE_DEVICES"] == "void"
            driver.unprepare_resource_claims([ClaimRef(
                uid=uid, name=claim["metadata"]["name"],
                namespace=claim["metadata"]["namespace"])])
            assert mgr.current_driver(bdf) == "nvidia"
        finally:
            driver.stop()


def _jax_pod(pod: dict) -> dict:
    """The same pod asking for TPUs: ``nvidia.com/gpu`` read as
    ``google.com/tpu``."""
    import json
    return json.loads(json.dumps(pod).replace("nvidia.com/gpu",
                                              "google.com/tpu"))


def _as_gpu(obj):
    """A JAX claim in the port's names (the reverse mapping)."""
    import json
    return json.loads(json.dumps(obj).replace("google.com/tpu",
                                              "nvidia.com/gpu")
                      .replace("tpu.google.com", GPU))


def _claim_view(claim: dict) -> dict:
    """What the synthesis decides: everything but the fields the API
    server stamps."""
    md = claim["metadata"]
    return {"apiVersion": claim["apiVersion"], "kind": claim["kind"],
            "spec": claim["spec"],
            "metadata": {k: md.get(k) for k in (
                "name", "namespace", "annotations", "ownerReferences")}}


def _pod(name="p", uid="u1", ns="ns", limits=None, requests=None,
         containers=1) -> dict:
    res = {}
    if limits is not None:
        res["limits"] = limits
    if requests is not None:
        res["requests"] = requests
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns, "uid": uid},
            "spec": {"containers": [{"name": f"c{i}", "resources": res}
                                    for i in range(containers)]}}


class TestAgainstJax:
    """The port's synthesis against the JAX allocator's, each over its own
    package's client and chart DeviceClasses."""

    @pytest.fixture()
    def both(self):
        from scenario_utils import apply_device_classes as jax_classes

        from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
        from k8s_dra_driver_tpu.kubeletplugin import Allocator as JaxAllocator
        port_client, jax_client = FakeClient(), JaxClient()
        apply_device_classes(port_client)
        jax_classes(jax_client)
        return ((port_client, Allocator(port_client)),
                (jax_client, JaxAllocator(jax_client)))

    def test_class_mapping(self, both):
        (_, port), (_, jax) = both
        assert port.extended_resource_classes() == {"nvidia.com/gpu": GPU}
        assert _as_gpu(jax.extended_resource_classes()) == \
            port.extended_resource_classes()

    @pytest.mark.parametrize("pod", [
        _pod(limits={"nvidia.com/gpu": 2}),
        _pod(limits={"nvidia.com/gpu": "2"}, requests={"nvidia.com/gpu": "2"}),
        _pod(requests={"nvidia.com/gpu": "1"}),
        _pod(limits={"nvidia.com/gpu": "1", "cpu": "4"}, containers=3),
        _pod(limits={"nvidia.com/gpu": "1k"}),
        _pod(limits={"cpu": "1", "memory": "1Gi"}),
        _pod(),
    ], ids=["int", "limits+requests", "requests-only", "three-containers",
            "suffix", "unmapped", "no-resources"])
    def test_same_claim(self, both, pod):
        (pc, port), (jc, jax) = both
        got = port.synthesize_extended_claims(pod)
        want = jax.synthesize_extended_claims(_jax_pod(pod))
        assert [_claim_view(c) for c in got] == \
            [_claim_view(_as_gpu(c)) for c in want]
        # Idempotent per pod uid: the same object back, nothing created.
        again = port.synthesize_extended_claims(pod)
        assert [c["metadata"]["uid"] for c in again] == \
            [c["metadata"]["uid"] for c in got]
        assert len(pc.list("ResourceClaim")) == len(jc.list(
            "ResourceClaim")) == len(got)

    def test_stale_incarnation_replaced_in_both(self, both):
        (pc, port), (jc, jax) = both
        old = _pod(limits={"nvidia.com/gpu": 1}, uid="old")
        new = _pod(limits={"nvidia.com/gpu": 3}, uid="new")
        for client, alloc, conv in ((pc, port, lambda p: p),
                                    (jc, jax, _jax_pod)):
            first = alloc.synthesize_extended_claims(conv(old))[0]
            second = alloc.synthesize_extended_claims(conv(new))[0]
            assert second["metadata"]["uid"] != first["metadata"]["uid"]
            assert second["metadata"]["ownerReferences"][0]["uid"] == "new"
            assert second["spec"]["devices"]["requests"][0]["exactly"][
                "count"] == 3
            assert len(client.list("ResourceClaim")) == 1

    @pytest.mark.parametrize("annotated, owner_kind", [
        (False, "Pod"), (True, "ReplicaSet"), (False, None)])
    def test_user_claim_collision_refused_in_both(self, both, annotated,
                                                  owner_kind):
        (pc, port), (jc, jax) = both
        from k8s_dra_driver_tpu.kubeletplugin.allocator import (
            AllocationError as JaxAllocationError,
        )
        pod = _pod(limits={"nvidia.com/gpu": 1})
        for client, alloc, conv, err in (
                (pc, port, lambda p: p, AllocationError),
                (jc, jax, _jax_pod, JaxAllocationError)):
            md = {"name": "p-extended-resources", "namespace": "ns"}
            if annotated:
                md["annotations"] = {
                    "resource.kubernetes.io/extended-resource-names": "x"}
            if owner_kind:
                md["ownerReferences"] = [{"kind": owner_kind, "uid": "u1",
                                          "name": "p"}]
            user = client.create({"apiVersion": "resource.k8s.io/v1",
                                  "kind": "ResourceClaim", "metadata": md,
                                  "spec": {"devices": {"requests": []}}})
            with pytest.raises(err, match="not an implicit claim"):
                alloc.synthesize_extended_claims(conv(pod))
            assert client.get("ResourceClaim", "p-extended-resources",
                              "ns")["metadata"]["uid"] == \
                user["metadata"]["uid"]

    def test_bad_quantity_raises_in_both(self, both):
        (_, port), (_, jax) = both
        from k8s_dra_driver_tpu.kubeletplugin.allocator import (
            AllocationError as JaxAllocationError,
        )
        pod = _pod(limits={"nvidia.com/gpu": "two"})
        with pytest.raises(AllocationError, match="invalid quantity"):
            port.synthesize_extended_claims(pod)
        with pytest.raises(JaxAllocationError, match="invalid quantity"):
            jax.synthesize_extended_claims(_jax_pod(pod))
