"""The port's serving smoke (``internal/stresslab.run_serving_smoke``) on
the CPU, beside the JAX package's on the same ``tmp_path`` pattern.

One replica's serve session runs claim → allocation → the GPU plugin's
prepare through the claim watcher → CDI spec → ``bind_engine`` → first
decoded batch → drain → unprepare → delete, then the zero-residue audit
and the accounting identity. Both packages' smokes must report
``outcome == "ok"``; the port's must also be accounted, leak-free and
under 1e-4 isolation error (the JAX serving tests' bound).
"""

import pytest
import torch

from k8s_dra_driver_tpu.internal import stresslab as jax_stresslab
from k8s_dra_driver_tpu_torch.compute.serving import ServingMetrics
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.internal import stresslab
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)

ISOLATION_TOL = 1e-4


def test_port_and_jax_smokes_are_ok(tmp_path):
    ours = stresslab.run_serving_smoke(tmpdir=str(tmp_path / "port"),
                                       device="cpu")
    theirs = jax_stresslab.run_serving_smoke(tmpdir=str(tmp_path / "jax"))
    assert ours["outcome"] == theirs["outcome"] == "ok", (ours, theirs)
    assert ours["ok"] and theirs["ok"]
    assert ours["accounted"] and ours["leaks"] == []
    assert ours["kv_isolation_max_err"] < ISOLATION_TOL
    assert ours["completed"] > 0 and ours["decode_tokens"] > 0
    assert (ours["backend"], ours["device"], len(ours["gpus"])) == \
        ("mock", "cpu", 2)
    assert ours["ttfb_s"] is not None and ours["ttfb_s"] < 5.0


def test_smoke_in_its_own_temporary_directory():
    r = stresslab.run_serving_smoke(device="cpu")
    assert r["ok"] and r["leaks"] == [], r


def test_smoke_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stresslab.run_serving_smoke()


@pytest.fixture()
def node(tmp_path):
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER_NAME, spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    lib = MockDeviceLib("h100-8")
    driver = GpuDriver(client, DriverConfig(
        node_name="node-0", state_dir=str(tmp_path / "s"),
        cdi_root=str(tmp_path / "c"), env={}, retry_timeout=1.0),
        device_lib=lib).start()
    loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0",
                           namespace="default").start()
    yield client, driver, lib
    loop.stop()
    driver.stop()


def replica(client, driver, lib, **kw):
    args = dict(name="r", tenant="t", client=client,
                allocator=Allocator(client), node="node-0",
                metrics=ServingMetrics(),
                cdi_lookup=lambda _n, uid: driver.cdi.read_claim_spec(uid),
                serve_s=0.05, deadline_s=5.0, requests_per_burst=6,
                prompt_tokens=4, max_new_tokens=3, device="cpu",
                uuids={g.uuid: g.index for g in lib.enumerate_gpus()},
                engine_kwargs=dict(max_batch=4, kv_cap=16,
                                   modeled_chip_tok_s=1e6))
    args.update(kw)
    return stresslab.ServingReplica(**args)


def test_replica_binds_the_gpu_its_selector_names(node):
    client, driver, lib = node
    g = lib.enumerate_gpus()[5]
    rep = replica(client, driver, lib, selectors=(
        f"device.attributes['uuid'] == '{g.uuid}'",))
    rec = rep.serve_once()
    assert rec["outcome"] == "ok", rec
    assert rec["gpus"] == [5]
    assert rep.completed + rep.shed + rep.rejected == rep.submitted > 0
    assert client.list("ResourceClaim") == []
    assert driver.state.prepared_claims() == {}
    m = rep.metrics
    assert m.claim_attempts_total.value(tenant="t", outcome="ok") == 1
    assert m.first_batch_seconds.count(tenant="t") == 1


def test_failed_session_is_counted_and_cleaned_up(node):
    client, driver, lib = node
    rep = replica(client, driver, lib, gpus_per_claim=9)
    rec = rep.serve_once()
    assert rec["outcome"] == "error" and "AllocationError" in rec["error"]
    assert rep.errors == 1 and rep.ok == 0
    assert client.list("ResourceClaim") == []
    assert rep.metrics.claim_attempts_total.value(
        tenant="t", outcome="error") == 1
