"""The GPU port stands alone: no JAX, nothing of the JAX package, no YAML
or gRPC, no Triton or kernel build at import.

A subprocess blocks ``jax``, ``k8s_dra_driver_tpu``, ``yaml`` and ``grpc``
in ``sys.modules``, imports every module of the port (the device library,
the k8s client, the GPU and ComputeDomain kubelet plugins, the
ComputeDomain daemon and controller, the webhook, the serving harness, the
self-healing path, the binaries with their HTTP API server, the
observability plane with the controller's binary and the soak, and
controller sharding with the full claim-lifecycle tracer included, and
the MIG and VFIO modules; the modules of the last six slices are named and
must be among them; a MIG and a passthrough claim prepare and unprepare
in a child of their own with the same modules blocked;
the serving-scale, churn, fleet and chaos harnesses run small in a child
of their own with the same modules blocked;
the ``__main__`` modules, which run their binary when imported, are
source-scanned only) and
``chip_smoke.py``, serves a CPU engine to completion, runs
``entry(device="cpu")``, one ``flash_attention`` call on CPU tensors, the
serving smoke (``run_serving_smoke(device="cpu")``: claim → GPU plugin
→ CDI → engine) and the multi-device dry run on two gloo ranks
(``dryrun_multichip(2, device="cpu")``, its ComputeDomain flow on mock
nodes included); a source scan finds no import of JAX, the JAX package or
YAML anywhere in the port or the smoke script, and no module-level import
of Triton or gRPC.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "k8s_dra_driver_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "k8s_dra_driver_tpu", "yaml")
#: Imported only inside the function that needs them, never at import:
#: Triton (the kernels' launchers), gRPC and protobuf (the health server,
#: which a machine without them runs without).
LAZY = ("triton", "grpc", "google")

_CHILD = r"""
import pkgutil, sys, time
for name in ("jax", "jaxlib", "k8s_dra_driver_tpu", "yaml", "grpc"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, sys.argv[1])
import k8s_dra_driver_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
        if not m.name.endswith(".__main__")]
for m in mods:
    __import__(m)
import chip_smoke  # noqa: F401
assert "triton" not in sys.modules, "triton imported at import time"
from k8s_dra_driver_tpu_torch.compute import _build
assert _build._libs == {}, "kernel library loaded at import"
from k8s_dra_driver_tpu_torch.compute.serving import (
    DecodeRequest, ServingEngine, ServingMetrics)
eng = ServingEngine("iso", n_chips=1, metrics=ServingMetrics(), device="cpu",
                    modeled_chip_tok_s=1e9).start()
reqs = [DecodeRequest(rid=f"r{i}", tenant=f"t{i % 2}", prompt_tokens=5,
                      max_new_tokens=3) for i in range(6)]
for r in reqs:
    assert eng.submit(r)
deadline = time.monotonic() + 60
while eng.completed < len(reqs) and time.monotonic() < deadline:
    time.sleep(0.005)
s = eng.drain(timeout=5.0)
assert s["accounted"] and s["completed"] == len(reqs), s
assert eng.kv_isolation_max_err < 1e-4
import torch
from k8s_dra_driver_tpu_torch.compute.flashattention import flash_attention
from k8s_dra_driver_tpu_torch.entry import entry
fn, args = entry(device="cpu")
out = fn(*args)
assert out.shape == (8, 128, 512) and bool(torch.isfinite(out.float()).all())
q = torch.randn(1, 2, 64, 32)
att = flash_attention(q, q, q, causal=True)
assert att.shape == q.shape and flash_attention.launches == 0
assert _build._libs == {}, "kernel library loaded on the CPU path"
from k8s_dra_driver_tpu_torch.internal.stresslab import run_serving_smoke
r = run_serving_smoke(device="cpu")
assert r["ok"] and r["accounted"] and r["leaks"] == [], r
assert r["kv_isolation_max_err"] < 1e-4, r
assert _build._libs == {}, "kernel library loaded by the CPU serving smoke"
from k8s_dra_driver_tpu_torch.entry import dryrun_multichip
d = dryrun_multichip(2, device="cpu")
assert d["world"] == 2 and d["backend"] == "gloo", d
from k8s_dra_driver_tpu_torch.pkg import tracing
t = tracing.Tracer().enable()
with t.start_span("claim") as s:
    s.set_status("ok")
assert tracing.audit_traces(t.store.traces()) == []
print("MODULES", len(mods))
print("NAMES", ",".join(mods))
"""

#: Modules of the ComputeDomain slice the sweep must reach.
CD_MODULES = [
    "k8s_dra_driver_tpu_torch.api.computedomain",
    "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.cleanup",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin."
    "computedomain",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin."
    "device_state",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.devices",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.driver",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.cleanup",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon.daemon",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.cleanup",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election",
    "k8s_dra_driver_tpu_torch.plugins.webhook.admission",
]

#: Modules of the self-healing slice the sweep must reach.
SELFHEAL_MODULES = [
    "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health",
    "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck",
    "k8s_dra_driver_tpu_torch.kubeletplugin.remediation",
    "k8s_dra_driver_tpu_torch.pkg.nodelease",
    "k8s_dra_driver_tpu_torch.pkg.canary",
]


#: Modules of the binaries slice the sweep must reach.
BINARY_MODULES = [
    "k8s_dra_driver_tpu_torch.internal.info",
    "k8s_dra_driver_tpu_torch.internal.common",
    "k8s_dra_driver_tpu_torch.pkg.process",
    "k8s_dra_driver_tpu_torch.pkg.logging",
    "k8s_dra_driver_tpu_torch.pkg.flags",
    "k8s_dra_driver_tpu_torch.pkg.blackbox",
    "k8s_dra_driver_tpu_torch.k8sclient.wirecodec",
    "k8s_dra_driver_tpu_torch.k8sclient.httpapi",
    "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.main",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.main",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon.main",
    "k8s_dra_driver_tpu_torch.plugins.webhook.main",
]

#: Modules of the observability slice (and the controller's binary).
OBSERVABILITY_MODULES = [
    "k8s_dra_driver_tpu_torch.pkg.telemetry",
    "k8s_dra_driver_tpu_torch.pkg.slo",
    "k8s_dra_driver_tpu_torch.pkg.usage",
    "k8s_dra_driver_tpu_torch.pkg.blackbox",
    "k8s_dra_driver_tpu_torch.internal.stresslab",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.main",
]

#: Modules of the sharding and tracing slice.
SHARDING_MODULES = [
    "k8s_dra_driver_tpu_torch.pkg.shardmap",
    "k8s_dra_driver_tpu_torch.pkg.tracing",
    "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.sharding",
]

#: Modules of the MIG and VFIO slice.
MIG_MODULES = [
    "k8s_dra_driver_tpu_torch.gpulib.chip",
    "k8s_dra_driver_tpu_torch.gpulib.device_lib",
    "k8s_dra_driver_tpu_torch.api.configs",
    "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.partitions",
    "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.vfio",
    "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state",
]

#: The serving-scale, churn, fleet and chaos slice: its functions, each
#: imported and run small in a child with JAX blocked.
SCALE_FUNCTIONS = {
    "k8s_dra_driver_tpu_torch.internal.stresslab": (
        "run_serving_scale", "run_cd_fleet", "run_node_fleet",
        "run_cross_kind_writes", "run_claim_churn"),
    "k8s_dra_driver_tpu_torch.k8sclient.client": ("FakeClient",),
}

_SCALE_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "k8s_dra_driver_tpu", "yaml", "grpc"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
from k8s_dra_driver_tpu_torch.internal.stresslab import (
    run_cd_fleet, run_claim_churn, run_cross_kind_writes, run_node_fleet,
    run_serving_scale)
from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient
assert FakeClient(sharded=False).list("ConfigMap") == []
r = run_serving_scale(measure_rounds=1, arm_window_s=0.3, autoscale=False,
                      shards=1, device="cpu", serving_engine=dict(
                          max_batch=8, kv_cap=32, heads=2, head_dim=8,
                          modeled_chip_tok_s=2000.0, queue_cap=32))
assert r["error_count"] == 0 and r["leak_count"] == 0, r
assert r["accounting"]["ok"] and r["tokens"]["decode_steps"] > 0, r
assert run_cd_fleet(n_domains=2)["converged"]
assert run_node_fleet(n_nodes=4)["error_count"] == 0
assert run_cross_kind_writes(n_kinds=2, writes_per_kind=10)["sharded_s"] > 0
c = run_claim_churn(duration_s=0.3, n_nodes=1, workers_per_node=1)
assert c["error_count"] == 0 and c["leaks"] == {}, c
print("SCALE_OK")
"""

#: The binaries' ``python -m`` entry files: scanned, never imported.
MAIN_FILES = [PORT / "plugins" / name / "__main__.py" for name in (
    "gpu_kubelet_plugin", "compute_domain_kubelet_plugin",
    "compute_domain_daemon", "webhook", "compute_domain_controller")]


def _sources():
    """The port's Python sources (not its build outputs) and the smoke."""
    return sorted(p for p in PORT.rglob("*.py")
                  if p.relative_to(PORT).parts[0] != "build") \
        + [REPO / "chip_smoke.py"]


def test_port_imports_and_serves_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(REPO)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("MODULES", 1)[1].split()[0])
    assert n >= 51 + len(CD_MODULES) + 3, proc.stdout
    names = set(proc.stdout.split("NAMES", 1)[1].split()[0].split(","))
    want = (set(CD_MODULES) | set(SELFHEAL_MODULES) | set(BINARY_MODULES)
            | set(OBSERVABILITY_MODULES) | set(SHARDING_MODULES)
            | set(MIG_MODULES))
    assert want <= names, sorted(want - names)
    assert not any(n.endswith(".__main__") for n in names)


def test_this_slices_harnesses_run_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SCALE_CHILD, str(REPO)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "SCALE_OK" in proc.stdout


@pytest.mark.parametrize("module", sorted(SCALE_FUNCTIONS))
def test_this_slices_functions_are_scanned(module):
    """Each function of the slice is defined in a module the source scan
    reads."""
    path = PORT / Path(*module.split(".")[1:]).with_suffix(".py")
    assert path in _sources()
    defined = {n.name for n in ast.parse(path.read_text()).body
               if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert set(SCALE_FUNCTIONS[module]) <= defined


_MIG_CHILD = r"""
import sys, tempfile
for name in ("jax", "jaxlib", "k8s_dra_driver_tpu", "yaml", "grpc"):
    sys.modules[name] = None
sys.path.insert(0, sys.argv[1])
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    FakeVfioKernel, MockDeviceLib, SysfsDeviceLib)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg.featuregates import new_feature_gates
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig, GpuDriver, partitions)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.vfio import (
    VfioPciManager)
tmp = tempfile.mkdtemp()
dev, sysfs, proc = MockDeviceLib("h100-8").materialize(tmp + "/tree")
mig = MockDeviceLib("h100-8", mig=True)
for lib, gates, cls, key in (
        (mig, "DynamicMIG=true", partitions.DEVICE_CLASS_MIG, "mig"),
        (SysfsDeviceLib(dev_root=dev, sysfs_root=sysfs, proc_root=proc,
                        env={}), "PassthroughSupport=true",
         partitions.DEVICE_CLASS_GPU, "vfio")):
    client = FakeClient()
    client.create(new_object("DeviceClass", cls, spec={"selectors": [
        {"cel": {"expression": partitions.DEVICE_CLASS_SELECTORS[cls]}}]}))
    d = GpuDriver(client, DriverConfig(
        node_name="n", state_dir=f"{tmp}/{key}", cdi_root=f"{tmp}/{key}-cdi",
        env={}, retry_timeout=0.5, feature_gates=new_feature_gates(gates)),
        device_lib=lib)
    d.state._vfio = VfioPciManager(sysfs, dev, kernel=FakeVfioKernel(
        sysfs, dev))
    d.start()
    spec = {"devices": {"requests": [{"name": "g", "exactly": {
        "deviceClassName": cls, "allocationMode": "ExactCount",
        "count": 1}}]}}
    if key == "vfio":
        spec["devices"]["config"] = [{"opaque": {
            "driver": "gpu.nvidia.com", "parameters": {
                "apiVersion": "resource.nvidia.com/v1beta1",
                "kind": "VfioDeviceConfig"}}}]
    c = Allocator(client).allocate(client.create(new_object(
        "ResourceClaim", key, "default", api_version="resource.k8s.io/v1",
        spec=spec)))
    r = d.prepare_resource_claims([c])[c["metadata"]["uid"]]
    assert r.error is None, r.error
    assert d.unprepare_resource_claims([ClaimRef.from_claim(c)])[
        c["metadata"]["uid"]] is None
assert mig.mig_devices() == []
print("MIG_OK")
"""


def test_this_slices_mig_and_vfio_paths_run_with_jax_blocked():
    """A MIG claim prepared and unprepared on the mock, and a passthrough
    claim on a materialized tree, in a child with JAX blocked."""
    proc = subprocess.run([sys.executable, "-c", _MIG_CHILD, str(REPO)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MIG_OK" in proc.stdout


def test_every_main_file_is_scanned():
    assert set(MAIN_FILES) <= set(_sources())
    for path in MAIN_FILES:
        assert "raise SystemExit(main())" in path.read_text()


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_triton_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert all(n.split(".")[0] not in LAZY for n in names), \
                f"{path.name}:{node.lineno} imports {names} at import time"
