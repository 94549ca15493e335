"""The port's allocator decides exactly as the JAX package's.

The same DeviceClass, ResourceSlice and ResourceClaim objects go into a
JAX ``FakeClient`` and a port ``FakeClient``; a seeded sequence of at least
50 claims (ExactCount 1–8, CEL selectors on string and int attributes,
counters drawn to exhaustion, releases and re-allocations) is applied to
both through each package's ``Allocator``. After every step the two must
agree exactly: the same (pool, device) placements, or an
``AllocationError`` with the same message. Two device sets: the JAX
package's ``v5e-8`` TPU mock with its KEP-4815 subslices and shared
counters, and the port's ``h100-8`` GPUs on two nodes, both strategies.
"""

import copy

import numpy as np
import pytest

from k8s_dra_driver_tpu.k8sclient import FakeClient as JaxClient
from k8s_dra_driver_tpu.kubeletplugin import allocator as jax_alloc
from k8s_dra_driver_tpu.pkg.featuregates import (
    DYNAMIC_SUBSLICE,
    new_feature_gates,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import (
    DriverConfig as TpuDriverConfig,
)
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import TpuDriver
from k8s_dra_driver_tpu.tpulib import MockDeviceLib as TpuMock
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib as GpuMock
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient as PortClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import allocator as port_alloc
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)

STRATEGIES = ("best-fit", "first-fit")


def _class(name, expr):
    return new_object("DeviceClass", name, spec={"selectors": [
        {"cel": {"expression": expr}}]})


def _plain(obj):
    """The object as a fresh create would carry it: no server fields."""
    o = copy.deepcopy(obj)
    m = o["metadata"]
    for k in ("uid", "resourceVersion", "creationTimestamp"):
        m.pop(k, None)
    o.pop("status", None)
    return o


def tpu_objects(tmp_path):
    """The JAX TPU plugin's published v5e-8 slice (8 chips + subslices
    over one counter per chip) and its two DeviceClasses."""
    client = JaxClient()
    TpuDriver(client, TpuDriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "tpu"),
        cdi_root=str(tmp_path / "tpu-cdi"), env={},
        feature_gates=new_feature_gates(f"{DYNAMIC_SUBSLICE}=true")),
        device_lib=TpuMock("v5e-8")).start()
    slices = [_plain(s) for s in client.list("ResourceSlice")]
    return slices + [
        _class("tpu.google.com", "device.attributes['type'] == 'tpu'"),
        _class("subslice.tpu.google.com",
               "device.attributes['type'] == 'subslice'")]


def gpu_objects(tmp_path):
    """The port GPU plugin's published h100-8 slices on two nodes and the
    gpu.nvidia.com DeviceClass."""
    client = PortClient()
    for node in ("node-a", "node-b"):
        GpuDriver(client, DriverConfig(
            node_name=node, state_dir=str(tmp_path / node),
            cdi_root=str(tmp_path / f"{node}-cdi"), env={}),
            device_lib=GpuMock("h100-8")).start()
    slices = [_plain(s) for s in client.list("ResourceSlice")]
    return slices + [_class("gpu.nvidia.com",
                            "device.attributes['type'] == 'gpu'")]


def tpu_request(rng):
    if rng.random() < 0.3:
        shape = ["2x2", "1x4", "1x2", "2x1"][rng.integers(4)]
        return "subslice.tpu.google.com", 1, [
            f"device.attributes['shape'] == '{shape}'"]
    sels = [
        [],
        [f"device.attributes['index'] >= {rng.integers(0, 6)}"],
        [f"device.attributes['index'] == {rng.integers(0, 8)} || "
         f"device.attributes['index'] == {rng.integers(0, 8)}"],
        ["device.attributes['chipType'] == 'v5e'"],
        [f"device.attributes['coords'] != '0,{rng.integers(0, 4)}'"],
        ["device.attributes['numaNode'] == 1"],
    ][rng.integers(6)]
    return "tpu.google.com", int(rng.integers(1, 9)), sels


def gpu_request(rng, uuids):
    sels = [
        [],
        [f"device.attributes['uuid'] == '{uuids[rng.integers(8)]}'"],
        [f"device.attributes['index'] < {rng.integers(1, 9)}"],
        [f"device.attributes['minor'] >= {rng.integers(0, 8)}",
         "device.attributes['productName'] == 'NVIDIA H100 80GB HBM3'"],
        [f"device.attributes['numaNode'] == {rng.integers(0, 2)}"],
        [f"device.attributes['uuid'] != '{uuids[rng.integers(8)]}' && "
         f"device.attributes['pciAddress'] > '0000:3a:00.0'"],
        ["device.attributes['cudaComputeCapability'] == '9.0.0'"],
    ][rng.integers(7)]
    return "gpu.nvidia.com", int(rng.integers(1, 9)), sels


def claim_obj(name, device_class, count, selectors):
    exactly = {"deviceClassName": device_class,
               "allocationMode": "ExactCount", "count": count}
    if selectors:
        exactly["selectors"] = [{"cel": {"expression": s}} for s in selectors]
    return new_object("ResourceClaim", name, "default",
                      api_version="resource.k8s.io/v1",
                      spec={"devices": {"requests": [
                          {"name": "req", "exactly": exactly}]}})


def outcome(allocator, client, name, error_type):
    try:
        got = allocator.allocate(client.get("ResourceClaim", name, "default"))
    except error_type as e:
        return ("error", str(e))
    return ("ok", sorted((r["pool"], r["device"]) for r in
                         got["status"]["allocation"]["devices"]["results"]))


def run_both(objects, make_request, strategy, seed, steps=60):
    """Drive the seeded sequence through both allocators; return the
    per-step outcomes of each side."""
    clients = (JaxClient(), PortClient())
    for client in clients:
        for o in objects:
            client.create(copy.deepcopy(o))
    allocators = (jax_alloc.Allocator(clients[0], strategy=strategy),
                  port_alloc.Allocator(clients[1], strategy=strategy))
    errors = (jax_alloc.AllocationError, port_alloc.AllocationError)
    rng = np.random.default_rng(seed)
    live, released, log = [], [], ([], [])
    n_claims = 0
    for step in range(steps):
        r = rng.random()
        if live and r < 0.25:
            name = live.pop(int(rng.integers(len(live))))
            for side, (a, c) in enumerate(zip(allocators, clients)):
                a.release(c.get("ResourceClaim", name, "default"))
                log[side].append(("released", name))
            released.append(name)
            continue
        if released and r < 0.35:
            name = released.pop(int(rng.integers(len(released))))
        else:
            name = f"c{n_claims}"
            n_claims += 1
            obj = claim_obj(name, *make_request(rng))
            for c in clients:
                c.create(copy.deepcopy(obj))
        results = [outcome(a, c, name, e)
                   for a, c, e in zip(allocators, clients, errors)]
        for side in (0, 1):
            log[side].append((name,) + results[side])
        if results[1][0] == "ok":
            live.append(name)
        else:
            released.append(name)
    return log, n_claims


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_tpu_slices_identical_decisions(tmp_path, strategy, seed):
    log, n_claims = run_both(tpu_objects(tmp_path), tpu_request, strategy,
                             seed)
    assert n_claims >= 30
    assert log[0] == log[1]
    kinds = {e[1] for e in log[1] if e[0] != "released"}
    assert kinds == {"ok", "error"}      # both sides hit exhaustion


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("seed", [0, 1])
def test_gpu_slices_identical_decisions(tmp_path, strategy, seed):
    uuids = [g.uuid for g in GpuMock("h100-8").enumerate_gpus()]
    log, n_claims = run_both(gpu_objects(tmp_path),
                             lambda rng: gpu_request(rng, uuids),
                             strategy, seed)
    assert n_claims >= 30
    assert log[0] == log[1]
    kinds = {e[1] for e in log[1] if e[0] != "released"}
    assert kinds == {"ok", "error"}


def test_at_least_fifty_claims_across_the_set(tmp_path):
    """The seeded set as a whole: ≥ 50 claims through both allocators on
    each device set, every ExactCount from 1 to 8 asked for."""
    uuids = [g.uuid for g in GpuMock("h100-8").enumerate_gpus()]
    total, counts = 0, set()
    for objects, make in ((tpu_objects(tmp_path / "t"), tpu_request),
                          (gpu_objects(tmp_path / "g"),
                           lambda rng: gpu_request(rng, uuids))):
        log, n = run_both(objects, make, "best-fit", seed=2, steps=80)
        assert log[0] == log[1]
        total += n
        rng = np.random.default_rng(2)
        counts |= {make(rng)[1] for _ in range(200)}
    assert total >= 50
    assert counts >= set(range(1, 9))


@pytest.mark.parametrize("expr,dev,want", [
    ("device.attributes['uuid'] == 'GPU-a'", {"uuid": "GPU-a"}, True),
    ("device.attributes['uuid'] == 'GPU-a'", {"uuid": "GPU-b"}, False),
    ("device.attributes['index'] >= 2 && device.attributes['index'] < 4",
     {"index": 3}, True),
    ("device.attributes['minor'] in [1, 5]", {"minor": 5}, True),
    ("device.capacity['memory'].compareTo(quantity('80Gi')) >= 0",
     {"capacity": {"memory": 81559 << 20}}, False),
    ("device.attributes['productName'].startsWith('NVIDIA H100')",
     {"productName": "NVIDIA H100 80GB HBM3"}, True),
])
def test_eval_selector_as_the_jax_package(expr, dev, want):
    cap = dev.pop("capacity", {})
    device = {"attributes": dict(dev), "capacity": dict(cap)}
    outs = []
    for mod in (jax_alloc, port_alloc):
        try:
            outs.append(mod.eval_selector(expr, copy.deepcopy(device)))
        except mod.AllocationError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]
    if not isinstance(outs[1], tuple):
        assert outs[1] is want
