"""The scenario suite on the GPU port: the classes of the JAX package's
``tests/test_scenarios.py`` but its quickstart-spec class, which runs on
the GPU quickstart specs (``demo/specs/quickstart-gpu/``) in
``tests/test_torch_quickstart.py`` through this file's :func:`run_pod`.

Two ``h100-8`` nodes run both kubelet plugins (GPU and ComputeDomain) and a
ComputeDomain controller. The workloads are the JAX specs' objects in their
GPU form, built here: ``gpu-test1`` (two pods, one GPU each, from one
ResourceClaimTemplate) and ``gpu-test5`` (a ComputeDomain of two nodes, each
worker claiming a channel and all of its node's GPUs). Pods are "scheduled"
by :func:`run_pod` (a copy of the JAX suite's helper): claims instantiated
from templates (or named global claims), a pod's extended resources given
an implicit claim (KEP-5004), allocated node-pinned, prepared by the owning
driver.
Robustness (restart mid-prepare, checkpoint corruption, CD failover), the
claims-to-compute tie (per-GPU claims tiling a node, then the port's
data-parallel ResNet on gloo ranks), churn and the node fleet follow."""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import pytest

from k8s_dra_driver_tpu_torch.api.computedomain import (
    NODE_LABEL_CD,
    STATUS_NOT_READY,
    STATUS_READY,
    new_compute_domain,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller \
    import (
        DEVICE_CLASS_CHANNEL,
        DEVICE_CLASS_DAEMON,
        ComputeDomainController,
    )
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

GPU = "gpu.nvidia.com"
Obj = dict[str, Any]


def _device_classes(client) -> None:
    for name, kind in ((GPU, "gpu"), (DEVICE_CLASS_CHANNEL, "channel"),
                       (DEVICE_CLASS_DAEMON, "daemon")):
        client.create(new_object("DeviceClass", name, spec={"selectors": [{
            "cel": {"expression": f"device.attributes['type'] == '{kind}'"}}]}))


@pytest.fixture()
def cluster(tmp_path):
    """Two h100-8 nodes with both drivers each, and the controller — the
    node stack the kubelet plugin DaemonSet runs."""
    client = FakeClient()
    _device_classes(client)
    drivers = {}
    gpu_drivers = []
    cd_drivers = []
    for host in (0, 1):
        node = f"host{host}"
        client.create(new_object("Node", node))
        gpu = GpuDriver(client, DriverConfig(
            node_name=node,
            state_dir=str(tmp_path / f"gpu-{host}"),
            cdi_root=str(tmp_path / f"cdi-gpu-{host}"),
            env={}, retry_timeout=0.4,
        ), device_lib=MockDeviceLib("h100-8", host_index=host)).start()
        cd = CdDriver(client, CdDriverConfig(
            node_name=node,
            state_dir=str(tmp_path / f"cd-{host}"),
            cdi_root=str(tmp_path / f"cdi-cd-{host}"),
            env={}, retry_timeout=0.4,
        ), device_lib=MockDeviceLib("h100-8", host_index=host)).start()
        drivers[(GPU, node)] = gpu
        drivers[(CD_DRIVER_NAME, node)] = cd
        gpu_drivers.append(gpu)
        cd_drivers.append(cd)
    controller = ComputeDomainController(client)
    yield client, drivers, controller, gpu_drivers, cd_drivers, tmp_path
    for d in gpu_drivers + cd_drivers:
        d.stop()


def _template(ns: str, name: str, exactly: dict) -> Obj:
    return new_object("ResourceClaimTemplate", name, ns,
                      api_version="resource.k8s.io/v1",
                      spec={"spec": {"devices": {"requests": [{
                          "name": "gpu", "exactly": exactly}]}}})


def _pod(ns: str, name: str, claims: dict[str, str]) -> Obj:
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"namespace": ns, "name": name},
            "spec": {"containers": [{"name": "ctr"}],
                     "resourceClaims": [
                         {"name": ref, "resourceClaimTemplateName": rct}
                         for ref, rct in claims.items()]}}


def gpu_test1(client) -> list[Obj]:
    """Two pods, each claiming one GPU from the ``single-gpu`` template."""
    client.create(_template("gpu-test1", "single-gpu", {
        "deviceClassName": GPU, "allocationMode": "ExactCount",
        "count": 1}))
    return [_pod("gpu-test1", f"pod{i}", {"gpu": "single-gpu"})
            for i in (1, 2)]


def gpu_test5(client) -> list[Obj]:
    """A ComputeDomain ``dom`` of two nodes whose channel template is
    ``gpu-test5-channel``; two workers, each claiming a channel and every
    GPU of its node."""
    client.create(new_compute_domain(
        "dom", "gpu-test5", num_nodes=2,
        channel_template_name="gpu-test5-channel"))
    client.create(_template("gpu-test5", "all-host-gpus", {
        "deviceClassName": GPU, "allocationMode": "All"}))
    return [_pod("gpu-test5", f"worker-{i}", {
        "channel": "gpu-test5-channel", "gpus": "all-host-gpus"})
        for i in (0, 1)]


class PodRun:
    """One pod's outcome: its prepared claims, their prepare results and
    the env a container referencing every claim gets from CDI."""

    def __init__(self, pod: Obj, node: str):
        self.pod = pod
        self.node = node
        self.claims: dict[str, Obj] = {}
        self.results: dict[str, Any] = {}
        self.errors: dict[str, Exception] = {}

    @property
    def ok(self) -> bool:
        return not self.errors and all(
            r.error is None for r in self.results.values())

    def container_env(self, drivers: dict) -> dict[str, str]:
        env: dict[str, str] = {}
        for claim in self.claims.values():
            uid = claim["metadata"]["uid"]
            for res in (claim.get("status", {}).get("allocation", {})
                        .get("devices", {}).get("results", [])):
                driver = drivers.get((res["driver"], res["pool"]))
                spec = driver.cdi.read_claim_spec(uid) if driver else None
                if spec is None:
                    continue
                edits = [(spec.get("containerEdits") or {})]
                edits += [d["containerEdits"] for d in spec.get("devices", [])]
                for e in (x for ed in edits for x in ed.get("env", [])):
                    k, _, v = e.partition("=")
                    env[k] = v
        return env


def run_pod(client, pod: Obj, node: str, drivers: dict,
            allocator: Optional[Allocator] = None) -> PodRun:
    """'Schedule' a pod onto a node: instantiate its claims from their
    templates (a ``resourceClaimName`` names a global claim), give its
    extended resources an implicit claim, allocate them node-pinned and
    prepare each with the driver that owns its results."""
    alloc = allocator or Allocator(client)
    ns = pod["metadata"]["namespace"]
    run = PodRun(pod, node)
    names: list[tuple[str, str]] = []       # (reference, claim name)
    for rc in pod["spec"].get("resourceClaims", []):
        ref = rc["name"]
        if "resourceClaimTemplateName" in rc:
            name = f"{pod['metadata']['name']}-{ref}"
            if client.try_get("ResourceClaim", name, ns) is None:
                rct = client.get("ResourceClaimTemplate",
                                 rc["resourceClaimTemplateName"], ns)
                client.create({"apiVersion": "resource.k8s.io/v1",
                               "kind": "ResourceClaim",
                               "metadata": {"name": name, "namespace": ns},
                               "spec": rct["spec"]["spec"]})
        else:
            name = rc["resourceClaimName"]
        names.append((ref, name))
    # Extended resources (KEP-5004): container limits naming a resource a
    # DeviceClass advertises get an implicit claim, no claim stanza.
    try:
        for implicit in alloc.synthesize_extended_claims(pod):
            names.append(("extended-resources", implicit["metadata"]["name"]))
    except Exception as e:  # noqa: BLE001 — scenario asserts on it
        run.errors["extended-resources"] = e
    for ref, name in names:
        try:
            claim = alloc.allocate(client.get("ResourceClaim", name, ns),
                                   node=node)
        except Exception as e:  # noqa: BLE001 — scenario asserts on it
            run.errors[ref] = e
            continue
        run.claims[ref] = claim
        owners = {(r["driver"], r["pool"]) for r in
                  claim["status"]["allocation"]["devices"]["results"]}
        for owner in owners:
            res = drivers[owner].prepare_resource_claims([claim])
            run.results[ref] = res[claim["metadata"]["uid"]]
    return run


def _daemons(client, cd, ns):
    return [ComputeDomainDaemon(
        client=client, device_lib=MockDeviceLib("h100-8", host_index=host),
        cd_uid=cd["metadata"]["uid"], cd_name="dom",
        node_name=f"host{host}", namespace=ns, hostname=f"host{host}")
        for host in (0, 1)]


class TestRobustnessScenarios:
    def test_plugin_restart_mid_prepare(self, cluster):
        """A claim parked in PrepareStarted (a crash mid-prepare) is rolled
        back and re-prepared by the restarted plugin."""
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint \
            import (
                STATE_PREPARE_COMPLETED,
                STATE_PREPARE_STARTED,
                PreparedClaimCP,
            )
        client, drivers, _, gpu_drivers, _, tmp_path = cluster
        pods = gpu_test1(client)
        run = run_pod(client, pods[0], "host0", drivers)
        assert run.ok, run.errors
        claim = run.claims["gpu"]
        uid = claim["metadata"]["uid"]
        gpu_drivers[0].state.checkpoints.update(
            lambda c: c.prepared_claims.__setitem__(uid, PreparedClaimCP(
                state=STATE_PREPARE_STARTED,
                name=claim["metadata"]["name"],
                namespace=claim["metadata"]["namespace"],
                results=claim["status"]["allocation"]["devices"]["results"],
            )))
        restarted = GpuDriver(client, DriverConfig(
            node_name="host0",
            state_dir=str(tmp_path / "gpu-0"),
            cdi_root=str(tmp_path / "cdi-gpu-0"),
            env={}, retry_timeout=0.4,
        ), device_lib=MockDeviceLib("h100-8", host_index=0))
        res = restarted.prepare_resource_claims(
            [client.get("ResourceClaim", claim["metadata"]["name"],
                        claim["metadata"]["namespace"])])
        assert res[uid].error is None
        assert restarted.state.prepared_claims()[uid].state == \
            STATE_PREPARE_COMPLETED

    def test_checkpoint_corruption_is_permanent_and_diagnosed(self, cluster):
        client, drivers, _, gpu_drivers, _, tmp_path = cluster
        run = run_pod(client, gpu_test1(client)[0], "host0", drivers)
        assert run.ok
        cp_path = tmp_path / "gpu-0" / "checkpoint.json"
        cp_path.write_text(cp_path.read_text()[:-40] + "garbage")
        uid = run.claims["gpu"]["metadata"]["uid"]
        res = gpu_drivers[0].prepare_resource_claims(
            [client.get("ResourceClaim", run.claims["gpu"]["metadata"]["name"],
                        "gpu-test1")])
        err = res[uid].error
        assert err is not None and is_permanent(err)

    def test_cd_failover_daemon_withdraw_and_rejoin(self, cluster):
        """A daemon withdraws → the CD is NotReady and new channel prepares
        are refused retryably; it rejoins → Ready again, and the prepare
        succeeds with the domain's rendezvous env."""
        client, drivers, controller, _, _, _ = cluster
        pods = gpu_test5(client)
        cd = client.get("ComputeDomain", "dom", "gpu-test5")
        controller.reconcile(cd)
        assert client.try_get(
            "ResourceClaimTemplate", "gpu-test5-channel", "gpu-test5")
        # No daemon yet: the channel prepare is refused, the node labelled.
        first = run_pod(client, pods[0], "host0", drivers)
        err = first.results["channel"].error
        assert err is not None and not is_permanent(err)
        assert client.get("Node", "host0")["metadata"]["labels"][
            NODE_LABEL_CD] == cd["metadata"]["uid"]

        daemons = _daemons(client, cd, "gpu-test5")
        for d in daemons:
            d.sync_once()
        controller.reconcile(client.get("ComputeDomain", "dom", "gpu-test5"))
        assert client.get("ComputeDomain", "dom", "gpu-test5")[
            "status"]["status"] == STATUS_READY

        daemons[1].withdraw()
        controller.reconcile(client.get("ComputeDomain", "dom", "gpu-test5"))
        assert client.get("ComputeDomain", "dom", "gpu-test5")[
            "status"]["status"] == STATUS_NOT_READY
        run = run_pod(client, pods[0], "host0", drivers)
        err = run.results["channel"].error
        assert err is not None and not is_permanent(err)

        daemons[1].sync_once()
        controller.reconcile(client.get("ComputeDomain", "dom", "gpu-test5"))
        runs = [run_pod(client, pods[i], f"host{i}", drivers) for i in (0, 1)]
        assert all(r.ok for r in runs), [
            {k: str(v.error) for k, v in r.results.items()} for r in runs]
        envs = [r.container_env(drivers) for r in runs]
        assert [e["NNODES"] for e in envs] == ["2", "2"]
        assert sorted(e["NODE_RANK"] for e in envs) == ["0", "1"]
        for e in envs:
            assert len(e["CUDA_VISIBLE_DEVICES"].split(",")) == 8


class TestClaimsToComputeTie:
    """Eight per-GPU claims on one node cover every GPU, and the
    visibility they inject admits a data-parallel conv-net step over that
    many ranks (the port's ResNet on gloo ranks)."""

    def test_eight_per_gpu_claims_then_dp_resnet(self, cluster):
        from k8s_dra_driver_tpu_torch.compute.resnet import (
            resnet_params,
            resnet_params_to_numpy,
            run_data_parallel_resnet,
        )
        import torch

        client, drivers, *_ = cluster
        gpu0 = drivers[(GPU, "host0")]
        lib = MockDeviceLib("h100-8", host_index=0)
        index_of = {g.uuid: g.index for g in lib.enumerate_gpus()}
        visible = set()
        for i in range(8):
            claim = client.create(new_object(
                "ResourceClaim", f"gpu-{i}", "default",
                api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                    "deviceClassName": GPU,
                    "allocationMode": "ExactCount", "count": 1}}]}}))
            allocated = Allocator(client).allocate(claim, node="host0")
            uid = allocated["metadata"]["uid"]
            res = gpu0.prepare_resource_claims([allocated])[uid]
            assert res.error is None, res.error
            spec = gpu0.cdi.read_claim_spec(uid)
            env = dict(e.split("=", 1)
                       for d in spec["devices"]
                       for e in d["containerEdits"].get("env", []))
            env.update(dict(e.split("=", 1) for e in (
                spec.get("containerEdits") or {}).get("env", [])))
            visible |= {index_of[u]
                        for u in env["CUDA_VISIBLE_DEVICES"].split(",")}
        assert visible == set(range(8))

        n = len(visible)
        params = resnet_params_to_numpy(resnet_params(
            depth=2, channels=8, dtype=torch.float32))
        rng = np.random.default_rng(0)
        images = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
        labels = rng.integers(0, 10, size=n).astype(np.int64)
        out = run_data_parallel_resnet(params, images, labels, n,
                                       lr=5e-2, steps=3, device="cpu")
        assert out["batch_shards"] == [1] * n
        assert out["losses"][2] < out["losses"][0]


class TestStressScenarios:
    """Sustained concurrent claim churn with zero-leak assertions."""

    def test_sustained_churn_both_plugins_four_nodes(self, tmp_path):
        """Churn across 4 node stacks driving both kubelet plugins, with a
        latency distribution and a full leak audit (GPU_DRA_STRESS_SECONDS
        lengthens it)."""
        import os

        from k8s_dra_driver_tpu_torch.internal.stresslab import (
            run_claim_churn,
        )
        seconds = float(os.environ.get("GPU_DRA_STRESS_SECONDS", "4"))
        out = run_claim_churn(duration_s=seconds, tmpdir=str(tmp_path))
        assert out["error_count"] == 0, out["errors"]
        assert out["leaks"] == {}, out["leaks"]
        assert out["gpu_prepare"]["ops"] >= 4 * out["n_nodes"]
        assert out["cd_prepare"]["ops"] >= out["n_nodes"]
        assert out["gpu_prepare"]["p50_ms"] > 0
        assert out["cd_prepare"]["p50_ms"] > 0

    def test_concurrent_claim_churn_no_leaks(self, cluster):
        from k8s_dra_driver_tpu_torch.kubeletplugin import AllocationError

        client, drivers, *_ = cluster
        gpu0 = drivers[(GPU, "host0")]
        errors: list = []
        cycles = 12
        # One scheduler: allocation is serialized; the concurrency under
        # test is driver-side prepare/unprepare.
        alloc_lock = threading.Lock()

        def churn(worker: int) -> None:
            alloc = Allocator(client)
            for i in range(cycles):
                name = f"stress-{worker}-{i}"
                try:
                    claim = client.create(new_object(
                        "ResourceClaim", name, "default",
                        api_version="resource.k8s.io/v1",
                        spec={"devices": {"requests": [{
                            "name": "gpu", "exactly": {
                                "deviceClassName": GPU,
                                "allocationMode": "ExactCount",
                                "count": 1}}]}}))
                    try:
                        with alloc_lock:
                            allocated = alloc.allocate(claim, node="host0")
                    except AllocationError:
                        client.delete("ResourceClaim", name, "default")
                        continue
                    uid = allocated["metadata"]["uid"]
                    res = gpu0.prepare_resource_claims([allocated])[uid]
                    if res.error is not None:
                        errors.append((name, res.error))
                        continue
                    errs = gpu0.unprepare_resource_claims([ClaimRef(
                        uid=uid, name=name, namespace="default")])
                    if errs[uid] is not None:
                        errors.append((name, errs[uid]))
                    client.delete("ResourceClaim", name, "default")
                except Exception as e:  # noqa: BLE001
                    errors.append((name, e))

        threads = [threading.Thread(target=churn, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors[:5]
        assert gpu0.state.prepared_claims() == {}
        assert gpu0.cdi.list_claim_uids() == []
        leftover = [c for c in client.list("ResourceClaim")
                    if c["metadata"]["name"].startswith("stress-")]
        assert leftover == []


class TestNodeFleet:
    """Every node runs both kubelet plugins' informer stacks against one
    shared store; a claim wave converges with zero errors, and a stalled
    raw watcher is memory-bounded."""

    def test_fleet_converges_with_stalled_watcher_bounded(self):
        from k8s_dra_driver_tpu_torch.internal.stresslab import run_node_fleet
        out = run_node_fleet(n_nodes=40, ready_timeout_s=120.0)
        assert out["converged"], out
        assert out["error_count"] == 0, out["errors"]
        assert out["informers"] == 80
        assert out["prepares"] == 40  # every claim prepared exactly once
        assert out["stalled_watcher"]["bounded"], out["stalled_watcher"]
        assert out["watch_events_per_sec"] > 0
        assert out["list_p99_ms"] > 0
