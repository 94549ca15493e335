"""A local "cluster" of real OS processes for the GPU port: the kind-cluster
analogue (the JAX package's ``demo/clusters/local/cluster.py``).

The topology is assembled from the port's own binaries on one machine, no
container runtime needed::

    webhook  ──  admission of every claim and template write
    api-server (httpapi)  ──  shared cluster state over HTTP
    compute-domain-controller (one, or two under leader election)
    per node:  gpu-kubelet-plugin  +  compute-domain-kubelet-plugin
    per (ComputeDomain, labelled node):  compute-domain-daemon

The runner plays the two roles that have no binary here:

- **scheduler** (:meth:`LocalCluster.schedule_pod`): claims instantiated
  from templates, allocated node-pinned and reserved
  (``status.reservedFor``) — each plugin's NodePrepareLoop then prepares
  them, as a kubelet's NodePrepareResources call would have; a pod's
  extended resources (``nvidia.com/gpu: N`` in container limits, KEP-5004)
  get an implicit claim first;
- **kubelet for DaemonSets** (:meth:`LocalCluster.sync_daemonsets`): the
  controller's per-ComputeDomain DaemonSets become daemon processes on the
  nodes that carry the domain's label.

Nodes run on ``h100-8`` mock profiles (``profile=""`` reads the machine's
own GPUs instead, through NVML). ``vfio=True`` serves a
materialized tree through the procfs backend with the kernel's bind/unbind
reaction emulated (``GPU_DRA_FAKE_VFIO_KERNEL``). The specs applied are
``demo/specs/quickstart-gpu/*.yaml`` and the GPU chart's DeviceClasses,
read with :mod:`k8s_dra_driver_tpu_torch.pkg.manifests` (no PyYAML).

Usage::

    python -m k8s_dra_driver_tpu_torch.internal.localcluster demo  # 8 phases
    python -m k8s_dra_driver_tpu_torch.internal.localcluster up    # park
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

from k8s_dra_driver_tpu_torch.api.computedomain import NODE_LABEL_CD
from k8s_dra_driver_tpu_torch.k8sclient.httpapi import HttpClient
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.pkg.manifests import load_file

REPO = Path(__file__).resolve().parents[2]
CHART = REPO / "deployments" / "helm" / "gpu-dra-driver"
SPECS = REPO / "demo" / "specs" / "quickstart-gpu"

PKG = "k8s_dra_driver_tpu_torch"
WEBHOOK_MODULE = f"{PKG}.plugins.webhook"
API_SERVER_MODULE = f"{PKG}.k8sclient.httpapi"
GPU_PLUGIN_MODULE = f"{PKG}.plugins.gpu_kubelet_plugin"
CD_PLUGIN_MODULE = f"{PKG}.plugins.compute_domain_kubelet_plugin"
CONTROLLER_MODULE = f"{PKG}.plugins.compute_domain_controller"
DAEMON_MODULE = f"{PKG}.plugins.compute_domain_daemon"

GPU_DRIVER = "gpu.nvidia.com"
IMPLICIT_REF = "extended-resources"   # schedule_pod's key for the implicit claim
#: The driver a materialized tree's GPUs are bound to before passthrough.
HOST_GPU_DRIVER = "nvidia"

Obj = dict[str, Any]


def _env_without_jax() -> dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    for name in ("JAX_PLATFORMS", "GPU_DRA_MOCK_PROFILE",
                 "GPU_DRA_DEVICE_BACKEND"):
        # The cluster says what each node reads; nothing inherited does.
        env.pop(name, None)
    return env


class LocalCluster:
    """``num_nodes`` node pairs (GPU + ComputeDomain kubelet plugin) on the
    ``profile`` mock (``""``: the machine's GPUs), ``controllers``
    controller replicas (0: none; 2 or more run leader election), the
    webhook in front of the API server. ``mig`` turns MIG mode on for the
    mock GPUs; ``feature_gates`` go to every plugin. A ``profile`` is a
    built-in layout or a JSON profile file; without one the GPU plugins
    read the machine's GPUs through NVML (``GPU_DRA_DEVICE_BACKEND=nvml``:
    where NVML does not load, the plugin exits instead of reading the GPUs
    another way)."""

    #: How long :meth:`up` waits for every node's GPU slice (seconds).
    UP_TIMEOUT_S = 90.0

    def __init__(self, workdir: str, num_nodes: int = 2,
                 profile: str = "h100-8", vfio: bool = False,
                 controllers: int = 1, mig: bool = False,
                 cd_plugins: bool = True, feature_gates: str = ""):
        self.workdir = Path(workdir)
        self.num_nodes = num_nodes
        self.profile = profile
        self.vfio = vfio
        self.mig = mig
        self.num_controllers = controllers
        self.with_cd_plugins = cd_plugins
        self.feature_gates = feature_gates
        self.controllers: dict[str, subprocess.Popen] = {}
        self.procs: list[subprocess.Popen] = []
        self.daemons: dict[tuple[str, str], subprocess.Popen] = {}
        self.gpu_plugins: dict[int, subprocess.Popen] = {}
        self.cd_plugins: dict[int, subprocess.Popen] = {}
        self._logs: list = []
        self.endpoint = ""
        self.webhook_endpoint = ""
        self.client: Optional[HttpClient] = None
        self.env = _env_without_jax()
        (self.workdir / "logs").mkdir(parents=True, exist_ok=True)

    # -- lifecycle ----------------------------------------------------------

    def up(self) -> None:
        # The webhook first (it has no dependencies): the API server reviews
        # every claim and template write through it. --port 0, and the
        # endpoint read from the child's own banner (a pre-picked "free"
        # port can be taken between probe and bind).
        wh = self._spawn_piped("webhook", WEBHOOK_MODULE,
                               "--host", "127.0.0.1", "--port", "0")
        self.webhook_endpoint = self._read_banner(wh, "serving on ", 60.0)
        if not self.webhook_endpoint:
            raise RuntimeError("webhook did not come up")
        self._drain(wh, self._log("webhook"))
        self._wait(self._webhook_ready, 30, "webhook /readyz")

        api = self._spawn_piped(
            "api-server", API_SERVER_MODULE, "--port", "0",
            "--admission-webhook", self.webhook_endpoint)
        self.endpoint = self._read_banner(api, "listening on", 60.0)
        if not self.endpoint:
            raise RuntimeError("api server did not come up")
        self._drain(api, self._log("api-server"))
        self.client = HttpClient(self.endpoint)
        print(f"[cluster] api server at {self.endpoint}", flush=True)

        for doc in load_file(CHART / "templates" / "deviceclasses.yaml"):
            if self.client.try_get(
                    "DeviceClass", doc["metadata"]["name"]) is None:
                self.client.create(doc)
        for i in range(self.num_nodes):
            self.client.create({"apiVersion": "v1", "kind": "Node",
                                "metadata": {"name": self.node(i)}})

        for c in range(self.num_controllers):
            self.spawn_controller(f"ctrl-{c}")
        for i in range(self.num_nodes):
            self.spawn_gpu_plugin(i)
            if self.with_cd_plugins:
                self.spawn_cd_plugin(i)
        self._wait(lambda: len(self.gpu_pools()) >= self.num_nodes,
                   self.UP_TIMEOUT_S, "GPU slices from all nodes")
        print(f"[cluster] {self.num_nodes} node(s) up, slices published",
              flush=True)

    def down(self) -> None:
        procs = [*self.daemons.values(), *self.procs]
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for f in self._logs:
            f.close()
        self._logs.clear()
        self.procs.clear()
        self.daemons.clear()
        self.gpu_plugins.clear()
        self.cd_plugins.clear()
        self.controllers.clear()

    def children(self) -> list[subprocess.Popen]:
        """Every process this cluster started that still runs."""
        return [p for p in (*self.daemons.values(), *self.procs)
                if p.poll() is None]

    @staticmethod
    def node(i: int) -> str:
        return f"node-{i}"

    def gpu_pools(self) -> set[str]:
        return {s["spec"]["pool"]["name"]
                for s in self.client.list("ResourceSlice")
                if s["spec"]["driver"] == GPU_DRIVER}

    # -- processes ----------------------------------------------------------

    def _log(self, name: str):
        f = open(self.workdir / "logs" / f"{name}.log", "a")
        self._logs.append(f)
        return f

    def log_text(self, name: str) -> str:
        path = self.workdir / "logs" / f"{name}.log"
        return path.read_text() if path.exists() else ""

    def _spawn(self, name: str, mod: str, *args: str,
               env: Optional[dict] = None) -> subprocess.Popen:
        p = subprocess.Popen(
            [sys.executable, "-m", mod, *args],
            stdout=self._log(name), stderr=subprocess.STDOUT,
            env=env or self.env, cwd=str(REPO))
        self.procs.append(p)
        return p

    def _spawn_piped(self, name: str, mod: str, *args: str
                     ) -> subprocess.Popen:
        p = subprocess.Popen(
            [sys.executable, "-m", mod, *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=self.env, cwd=str(REPO))
        self.procs.append(p)
        return p

    def _kill(self, p: subprocess.Popen) -> None:
        self.procs.remove(p)
        p.terminate()
        try:
            p.wait(timeout=15)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)

    def gpu_state_dir(self, i: int) -> Path:
        return self.workdir / self.node(i) / "gpu-state"

    def gpu_cdi_dir(self, i: int) -> Path:
        return self.workdir / self.node(i) / "gpu-cdi"

    def cd_state_dir(self, i: int) -> Path:
        return self.workdir / self.node(i) / "cd-state"

    def cd_cdi_dir(self, i: int) -> Path:
        return self.workdir / self.node(i) / "cd-cdi"

    def tree(self, i: int) -> Path:
        return self.workdir / self.node(i) / "tree"

    def _mock_args(self, i: int) -> list[str]:
        """The mock profile of node ``i``: the named layout at host ``i``,
        or (MIG mode) that layout written out as a JSON profile with
        ``"mig": true``."""
        if not self.mig:
            return ["--mock-profile", self.profile, "--host-index", str(i)]
        from k8s_dra_driver_tpu_torch.gpulib.device_lib import PROFILES
        path = self.workdir / self.node(i) / "profile-mig.json"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({**PROFILES[self.profile](i),
                                        "mig": True}))
        return ["--mock-profile", str(path), "--host-index", str(i)]

    def spawn_gpu_plugin(self, i: int) -> subprocess.Popen:
        """Start (or restart over the same state dir: the upgrade-in-place
        shape) node ``i``'s GPU kubelet plugin."""
        args = ["--node-name", self.node(i),
                "--state-dir", str(self.gpu_state_dir(i)),
                "--cdi-root", str(self.gpu_cdi_dir(i)),
                "--api-endpoint", self.endpoint,
                "--metrics-port", "-1", "--healthcheck-addr", "",
                "--profile-interval", "0"]
        env = dict(self.env)
        gates = self.feature_gates
        if self.vfio:
            tree = self.tree(i)
            if not tree.exists():
                from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
                    MockDeviceLib,
                )
                MockDeviceLib(self.profile, host_index=i).materialize(tree)
                print(f"[cluster] {self.node(i)}: materialized "
                      f"{self.profile} tree at {tree}", flush=True)
            env.update({"GPU_DRA_DEV_ROOT": str(tree / "dev"),
                        "GPU_DRA_SYSFS_ROOT": str(tree / "sys"),
                        "GPU_DRA_PROC_ROOT": str(tree / "proc"),
                        "GPU_DRA_DEVICE_BACKEND": "procfs",
                        "GPU_DRA_FAKE_VFIO_KERNEL": "1"})
        elif self.profile:
            args += self._mock_args(i)
        else:
            env["GPU_DRA_DEVICE_BACKEND"] = "nvml"
        if gates:
            args += ["--feature-gates", gates]
        p = self._spawn(f"gpu-plugin-{i}", GPU_PLUGIN_MODULE, *args, env=env)
        self.gpu_plugins[i] = p
        return p

    def kill_gpu_plugin(self, i: int) -> None:
        self._kill(self.gpu_plugins.pop(i))

    def spawn_cd_plugin(self, i: int) -> subprocess.Popen:
        """Start (or restart over the same state dir) node ``i``'s
        ComputeDomain kubelet plugin."""
        args = ["--node-name", self.node(i),
                "--state-dir", str(self.cd_state_dir(i)),
                "--cdi-root", str(self.cd_cdi_dir(i)),
                "--api-endpoint", self.endpoint,
                "--metrics-port", "-1", "--healthcheck-addr", "",
                "--profile-interval", "0"]
        if self.profile:
            args += ["--mock-profile", self.profile, "--host-index", str(i)]
        p = self._spawn(f"cd-plugin-{i}", CD_PLUGIN_MODULE, *args)
        self.cd_plugins[i] = p
        return p

    def kill_cd_plugin(self, i: int) -> None:
        self._kill(self.cd_plugins.pop(i))

    def spawn_controller(self, identity: str) -> subprocess.Popen:
        """One controller replica; with more than one, lease-based leader
        election (the chart's controller.leaderElect)."""
        args = ["--api-endpoint", self.endpoint, "--metrics-port", "-1",
                "--profile-interval", "0"]
        if self.num_controllers > 1:
            args += ["--leader-elect", "--identity", identity]
        p = self._spawn(f"controller-{identity}", CONTROLLER_MODULE, *args)
        self.controllers[identity] = p
        return p

    def kill_controller(self, identity: str, crash: bool = False) -> None:
        """``crash``: SIGKILL, so no shutdown handler releases the lease and
        the survivor must take over through its expiry (the path a leader's
        crash takes). Otherwise SIGTERM: a clean rollout."""
        p = self.controllers.pop(identity)
        if crash:
            self.procs.remove(p)
            p.kill()
            p.wait(timeout=10)
        else:
            self._kill(p)

    def lease_holder(self) -> str:
        lease = self.client.try_get(
            "Lease", "compute-domain-controller", "default")
        return ((lease or {}).get("spec") or {}).get("holderIdentity", "")

    def tree_pci_driver(self, i: int, bdf: str) -> str:
        """The driver ``bdf`` is bound to in node ``i``'s materialized tree
        (what the kernel would report)."""
        link = self.tree(i) / "sys" / "bus" / "pci" / "devices" / bdf / "driver"
        return os.path.basename(os.path.realpath(link)) if link.exists() else ""

    @staticmethod
    def _read_banner(proc, marker: str, timeout: float) -> str:
        """The child's startup banner, read against a monotonic deadline: a
        reader thread feeds lines into a queue (it stops at the marker, so
        the later :meth:`_drain` pump is the pipe's only reader), while this
        side polls the queue, the child's exit status and the clock. A
        child that wedges before printing fails fast instead of blocking on
        ``readline()``. The banner line's last word, or "" on expiry or the
        child's death."""
        lines: "queue.Queue[str]" = queue.Queue()

        def pump() -> None:
            for raw in proc.stdout:
                lines.put(raw)
                if marker in raw:
                    return

        threading.Thread(target=pump, daemon=True).start()
        deadline = time.monotonic() + timeout
        for _ in range(400):    # a bound on the lines read before the banner
            if time.monotonic() >= deadline:
                return ""
            try:
                line = lines.get(timeout=0.25)
            except queue.Empty:
                if proc.poll() is not None and lines.empty():
                    return ""
                continue
            if marker in line:
                return line.strip().rsplit(" ", 1)[-1]
        return ""

    @staticmethod
    def _drain(proc, sink=None) -> None:
        """Keep reading a piped child's output once its banner was read (an
        unread ~64 KB pipe would block the child's log writes), into
        ``sink`` when given."""

        def pump() -> None:
            for raw in proc.stdout:
                if sink is not None and not sink.closed:
                    sink.write(raw)
                    sink.flush()

        threading.Thread(target=pump, daemon=True).start()

    def _webhook_ready(self) -> bool:
        import urllib.request
        try:
            with urllib.request.urlopen(
                    f"{self.webhook_endpoint}/readyz", timeout=2) as r:
                return r.status == 200
        except OSError:
            return False

    @staticmethod
    def _wait(cond: Callable[[], bool], timeout: float, what: str) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.1)
        raise TimeoutError(f"timed out waiting for {what}")

    # -- the kubelet role for DaemonSets ------------------------------------

    def sync_daemonsets(self) -> None:
        """A daemon process for every (per-CD DaemonSet, node carrying that
        domain's label): what a kubelet does with the daemon pods."""
        nodes = {n["metadata"]["name"]: n for n in self.client.list("Node")}
        for ds in self.client.list("DaemonSet"):
            sel = (ds["spec"].get("template", {}).get("spec", {})
                   .get("nodeSelector") or {})
            cd_uid = sel.get(NODE_LABEL_CD)
            if not cd_uid:
                continue
            owner = next((r["name"] for r in
                          ds["metadata"].get("ownerReferences") or []
                          if r.get("kind") == "ComputeDomain"), "")
            ns = ds["metadata"].get("namespace", "")
            for name, node in nodes.items():
                labels = node["metadata"].get("labels") or {}
                if labels.get(NODE_LABEL_CD) != cd_uid:
                    continue
                key = (cd_uid, name)
                if key in self.daemons and self.daemons[key].poll() is None:
                    continue
                host_index = int(name.rsplit("-", 1)[-1])
                print(f"[cluster] starting daemon for CD {owner} on {name}",
                      flush=True)
                args = ["run", "--node-name", name,
                        "--cd-uid", cd_uid, "--cd-name", owner,
                        "--namespace", ns, "--hostname", name,
                        "--pod-ip", "127.0.0.1",
                        "--api-endpoint", self.endpoint,
                        "--sync-interval", "0.5"]
                if self.profile:
                    args += ["--mock-profile", self.profile,
                             "--host-index", str(host_index)]
                p = subprocess.Popen(
                    [sys.executable, "-m", DAEMON_MODULE, *args],
                    stdout=self._log(f"daemon-{owner}-{name}"),
                    stderr=subprocess.STDOUT, env=self.env, cwd=str(REPO))
                self.daemons[key] = p

    # -- the scheduler role --------------------------------------------------

    def schedule_pod(self, pod: Obj, node: str) -> dict[str, str]:
        """Instantiate, allocate and reserve the pod's claims on ``node``;
        {claim reference name: ResourceClaim name}, with the implicit
        extended-resource claim under ``"extended-resources"``."""
        ns = pod["metadata"].get("namespace", "")
        alloc = Allocator(self.client)
        pod_ref = [{"resource": "pods", "name": pod["metadata"]["name"]}]
        out: dict[str, str] = {}
        for rc in pod["spec"].get("resourceClaims", []):
            if "resourceClaimTemplateName" in rc:
                rct = self.client.get("ResourceClaimTemplate",
                                      rc["resourceClaimTemplateName"], ns)
                claim_name = f"{pod['metadata']['name']}-{rc['name']}"
                if self.client.try_get("ResourceClaim", claim_name,
                                       ns) is None:
                    self.client.create({
                        "apiVersion": "resource.k8s.io/v1",
                        "kind": "ResourceClaim",
                        "metadata": {"name": claim_name, "namespace": ns},
                        "spec": rct["spec"]["spec"]})
            else:
                claim_name = rc["resourceClaimName"]
            alloc.allocate(self.client.get("ResourceClaim", claim_name, ns),
                           reserved_for=pod_ref, node=node)
            out[rc["name"]] = claim_name
        # Extended resources (KEP-5004): container limits naming a mapped
        # resource get an implicit claim, with no claim stanza in the pod.
        for implicit in alloc.synthesize_extended_claims(pod):
            name = implicit["metadata"]["name"]
            alloc.allocate(self.client.get("ResourceClaim", name, ns),
                           reserved_for=pod_ref, node=node)
            out[IMPLICIT_REF] = name
        return out

    def claim_ready(self, name: str, ns: str) -> bool:
        claim = self.client.get("ResourceClaim", name, ns)
        return bool((claim.get("status") or {}).get("devices"))

    def claim_uid(self, name: str, ns: str) -> str:
        return self.client.get("ResourceClaim", name, ns)["metadata"]["uid"]

    def unreserve(self, name: str, ns: str) -> None:
        """Drop ``status.reservedFor`` (the pod is gone): each plugin's
        NodePrepareLoop unprepares, as the kubelet's NodeUnprepareResources
        call would have made it."""
        claim = self.client.get("ResourceClaim", name, ns)
        (claim.get("status") or {}).pop("reservedFor", None)
        self.client.update_status(claim)

    def retire_claim(self, name: str, ns: str, timeout: float) -> None:
        """A pod's completion, the runner playing kubelet and GC: unreserve,
        wait for the published devices to clear, then drop the allocation
        so the shared counters free up for the next phase."""
        self.unreserve(name, ns)
        self._wait(
            lambda: not (self.client.get("ResourceClaim", name, ns)
                         .get("status") or {}).get("devices"),
            timeout, f"{ns}/{name} unprepared after pod retirement")
        claim = self.client.get("ResourceClaim", name, ns)
        (claim.get("status") or {}).pop("allocation", None)
        self.client.update_status(claim)

    def _cdi_dirs(self, node: str) -> tuple[Path, Path]:
        nd = self.workdir / node
        return nd / "gpu-cdi", nd / "cd-cdi"

    def container_env(self, node: str,
                      claim_uids: Optional[list[str]] = None) -> dict:
        """What CDI injection gives a pod's containers: the union of the
        env of the CDI specs on ``node``, restricted to ``claim_uids`` (the
        files are per claim, ``<vendor>-<class>_<uid>.json``)."""
        env: dict[str, str] = {}
        for cdi_dir in self._cdi_dirs(node):
            for f in sorted(Path(cdi_dir).glob("*.json")):
                if claim_uids is not None and not any(
                        f.name.endswith(f"_{uid}.json") for uid in claim_uids):
                    continue
                spec = json.loads(f.read_text())
                edits = [spec.get("containerEdits") or {}]
                edits += [d.get("containerEdits") or {}
                          for d in spec.get("devices") or []]
                for e in edits:
                    for kv in e.get("env") or []:
                        k, _, v = kv.partition("=")
                        env[k] = v
        return env

    def claim_cdi_spec(self, node: str, claim_uid: str) -> Optional[dict]:
        for cdi_dir in self._cdi_dirs(node):
            for f in Path(cdi_dir).glob(f"*_{claim_uid}.json"):
                return json.loads(f.read_text())
        return None


def apply_spec(cluster: LocalCluster, name: str) -> list[Obj]:
    """Create a quickstart spec's objects but its Pods and Namespace (pods
    are scheduled by :meth:`LocalCluster.schedule_pod`)."""
    docs = load_file(SPECS / f"{name}.yaml")
    for doc in docs:
        if doc["kind"] not in ("Pod", "Namespace"):
            cluster.client.create(doc)
    print(f"[demo] applied {name}", flush=True)
    return docs


def pods(docs: list[Obj]) -> list[Obj]:
    return [d for d in docs if d["kind"] == "Pod"]


def _visible(env: dict) -> list[str]:
    return [x for x in env.get("CUDA_VISIBLE_DEVICES", "").split(",") if x]


def _phase_webhook_admission(cluster: LocalCluster) -> None:
    """Every claim write of the demo flows through the webhook process;
    the negative too: a typo'd opaque config is refused at CREATE, long
    before a node prepares it."""
    bad = {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": "typo", "namespace": "default"},
        "spec": {"devices": {
            "requests": [{"name": "gpu", "exactly": {
                "deviceClassName": GPU_DRIVER,
                "allocationMode": "ExactCount", "count": 1}}],
            "config": [{"requests": ["gpu"], "opaque": {
                "driver": GPU_DRIVER,
                "parameters": {
                    "apiVersion": "resource.nvidia.com/v1beta1",
                    "kind": "GpuConfig",
                    "envv": {"X": "1"}}}}],   # the typo'd field
        }},
    }
    try:
        cluster.client.create(bad)
    except Exception as e:  # noqa: BLE001 — the refusal is the pass
        if "unknown fields" not in str(e) and "envv" not in str(e):
            raise AssertionError(f"refused for another reason: {e}") from e
        print("[demo] webhook: typo'd config rejected at admission — PASS",
              flush=True)
        return
    raise AssertionError("typo'd opaque config was admitted")


def _free_node_gpus(cluster: LocalCluster, node: str, timeout: float) -> int:
    """Allocate every GPU of ``node`` to a probe claim, then release and
    delete it: the count it got (all of them only when every counter the
    previous claims drew is back)."""
    probe = "free-gpus-probe"
    cluster.client.create({
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": probe, "namespace": "default"},
        "spec": {"devices": {"requests": [{"name": "gpu", "exactly": {
            "deviceClassName": GPU_DRIVER, "allocationMode": "All"}}]}}})
    alloc = Allocator(cluster.client)
    try:
        claim = alloc.allocate(
            cluster.client.get("ResourceClaim", probe, "default"), node=node)
        got = len(claim["status"]["allocation"]["devices"]["results"])
        alloc.release(claim)
    finally:
        cluster.client.delete("ResourceClaim", probe, "default")
    return got


def _phase_gpu_test5(cluster: LocalCluster, timeout: float) -> None:
    """Two ComputeDomain workers on two nodes: the rendezvous env from real
    daemon processes, the domain Ready, the GPUs free again after the
    workers retire."""
    ns = "gpu-test5"
    docs = apply_spec(cluster, ns)
    cluster._wait(lambda: cluster.client.try_get(
        "ResourceClaimTemplate", "gpu-test5-channel", ns) is not None, 30,
        "the controller to render the channel template")
    workers = pods(docs)
    claims: dict[str, dict[str, str]] = {}
    for i, pod in enumerate(workers):
        claims[pod["metadata"]["name"]] = cluster.schedule_pod(
            pod, cluster.node(i))
    print("[demo] scheduled 2 worker pods (claims allocated+reserved)",
          flush=True)
    deadline = time.monotonic() + timeout
    ready = False
    while time.monotonic() < deadline and not ready:
        cluster.sync_daemonsets()
        ready = all(cluster.claim_ready(cn, ns)
                    for m in claims.values() for cn in m.values())
        time.sleep(0.2)
    if not ready:
        raise AssertionError("gpu-test5 claims never became Ready")

    ranks, masters = set(), set()
    for i, pod in enumerate(workers):
        uids = [cluster.claim_uid(cn, ns)
                for cn in claims[pod["metadata"]["name"]].values()]
        env = cluster.container_env(cluster.node(i), uids)
        assert env.get("NNODES") == "2", env
        assert len(_visible(env)) == 8, env
        ranks.add(env.get("NODE_RANK"))
        masters.add((env.get("MASTER_ADDR"), env.get("MASTER_PORT")))
        print(f"[demo] worker-{i}: NODE_RANK={env.get('NODE_RANK')} "
              f"NNODES={env['NNODES']} MASTER_ADDR={env.get('MASTER_ADDR')}"
              f" GPUs={len(_visible(env))}", flush=True)
    assert ranks == {"0", "1"}, ranks
    assert len(masters) == 1 and all(all(m) for m in masters), masters
    cd = cluster.client.get("ComputeDomain", "dom", ns)
    assert (cd.get("status") or {}).get("status") == "Ready", cd.get("status")
    print("[demo] gpu-test5: ComputeDomain Ready — PASS", flush=True)

    for m in claims.values():
        for cn in m.values():
            cluster.retire_claim(cn, ns, timeout)
    for i in range(2):
        got = _free_node_gpus(cluster, cluster.node(i), timeout)
        assert got == 8, f"{cluster.node(i)}: {got} of 8 GPUs free"
    print("[demo] gpu-test5: every GPU's counters free after unprepare — "
          "PASS", flush=True)


def _slice_device(cluster: LocalCluster, pool: str, name: str) -> Obj:
    for s in cluster.client.list("ResourceSlice"):
        if s["spec"]["driver"] == GPU_DRIVER and \
                s["spec"]["pool"]["name"] == pool:
            for d in s["spec"].get("devices") or []:
                if d["name"] == name:
                    return d
    raise AssertionError(f"{pool}/{name} is not published")


def _attr(dev: Obj, key: str) -> Any:
    return next(iter((dev.get("attributes") or {})[key].values()))


def _phase_gpu_test4(cluster: LocalCluster, timeout: float) -> None:
    """Two 3g.40gb MIG tenants on one node: each its own MIG instance, on
    disjoint memory slices."""
    ns = "gpu-test4"
    docs = apply_spec(cluster, ns)
    names = {}
    for pod in pods(docs):
        refs = cluster.schedule_pod(pod, cluster.node(0))
        names[pod["metadata"]["name"]] = refs["mig"]
    cluster._wait(lambda: all(cluster.claim_ready(c, ns)
                              for c in names.values()),
                  timeout, "gpu-test4 claims Ready")
    slices, visible = {}, {}
    for tenant, claim_name in names.items():
        claim = cluster.client.get("ResourceClaim", claim_name, ns)
        (res,) = claim["status"]["allocation"]["devices"]["results"]
        dev = _slice_device(cluster, res["pool"], res["device"])
        assert _attr(dev, "profile") == "3g.40gb", dev
        start, size = _attr(dev, "placementStart"), _attr(dev, "placementSize")
        slices[tenant] = {(_attr(dev, "parentIndex"), s)
                          for s in range(start, start + size)}
        env = cluster.container_env(cluster.node(0),
                                    [claim["metadata"]["uid"]])
        visible[tenant] = _visible(env)
        assert len(visible[tenant]) == 1 and \
            visible[tenant][0].startswith("MIG-"), env
    a, b = slices["tenant-a"], slices["tenant-b"]
    assert not (a & b), f"tenants share memory slices: {sorted(a & b)}"
    assert visible["tenant-a"] != visible["tenant-b"], visible
    print(f"[demo] gpu-test4: disjoint 3g.40gb tenants {sorted(a)} / "
          f"{sorted(b)} — PASS", flush=True)
    for claim_name in names.values():
        cluster.retire_claim(claim_name, ns, timeout)


def _phase_gpu_test7(cluster: LocalCluster, timeout: float) -> None:
    """Extended resources: no claim stanza; the scheduler role synthesizes
    the implicit claim from ``nvidia.com/gpu: 2`` against the chart's
    DeviceClass that advertises it, and the plugin prepares it."""
    ns = "gpu-test7"
    docs = apply_spec(cluster, ns)
    pod = pods(docs)[0]
    assert not pod["spec"].get("resourceClaims")
    refs = cluster.schedule_pod(pod, cluster.node(0))
    claim_name = refs[IMPLICIT_REF]
    uid = cluster.claim_uid(claim_name, ns)
    cluster._wait(lambda: cluster.claim_ready(claim_name, ns), timeout,
                  "implicit extended-resource claim Ready")
    env = cluster.container_env(cluster.node(0), [uid])
    assert len(_visible(env)) == 2, env
    print(f"[demo] gpu-test7: implicit claim {claim_name} -> GPUs "
          f"{env['CUDA_VISIBLE_DEVICES']} — PASS", flush=True)
    cluster.retire_claim(claim_name, ns, timeout)


def _phase_controller_failover(cluster: LocalCluster, timeout: float) -> None:
    """Two elected controller replicas; a SIGKILL of the leader must not
    strand a new ComputeDomain: the survivor takes the lease once it
    expires, and reconciles."""
    holder = cluster.lease_holder()
    assert holder in cluster.controllers, (holder, list(cluster.controllers))
    cluster.kill_controller(holder, crash=True)
    print(f"[demo] failover: crashed leader {holder} (SIGKILL)", flush=True)
    cluster.client.create({
        "apiVersion": "resource.nvidia.com/v1beta1",
        "kind": "ComputeDomain",
        "metadata": {"name": "failover-dom", "namespace": "default"},
        "spec": {"numNodes": 1, "channel": {
            "resourceClaimTemplate": {"name": "failover-channel"},
            "allocationMode": "Single"}}})
    # The lease lasts 15 s; room for the takeover and the reconcile.
    cluster._wait(lambda: cluster.client.try_get(
        "ResourceClaimTemplate", "failover-channel", "default") is not None,
        timeout + 30, "the survivor to reconcile the new ComputeDomain")
    survivor = cluster.lease_holder()
    assert survivor and survivor != holder, (holder, survivor)
    print(f"[demo] failover: {survivor} took over and reconciled — PASS",
          flush=True)


def _phase_gpu_test6(cluster: LocalCluster, timeout: float) -> None:
    """VFIO passthrough over the materialized tree: the GPU bound to
    vfio-pci at prepare, the VFIO nodes and void visibility in its CDI
    spec, its driver restored at unprepare."""
    ns = "gpu-test6"
    docs = apply_spec(cluster, ns)
    refs = cluster.schedule_pod(pods(docs)[0], cluster.node(0))
    claim_name = refs["gpu"]
    uid = cluster.claim_uid(claim_name, ns)
    cluster._wait(lambda: cluster.claim_ready(claim_name, ns), timeout,
                  "gpu-test6 claim Ready")
    env = cluster.container_env(cluster.node(0), [uid])
    bdf = env.get("GPU_PASSTHROUGH_PCI_ADDRESSES", "")
    assert bdf, env
    assert env.get("CUDA_VISIBLE_DEVICES") == "void", env
    assert env.get("GPU_PASSTHROUGH") == "1", env
    spec = cluster.claim_cdi_spec(cluster.node(0), uid)
    claim_nodes = [n["path"] for n in
                   (spec.get("containerEdits") or {}).get("deviceNodes") or []]
    assert claim_nodes == ["/dev/vfio/vfio"], claim_nodes
    dev_nodes = [n["path"] for d in spec.get("devices") or []
                 for n in (d.get("containerEdits") or {}).get(
                     "deviceNodes") or []]
    assert any(n.startswith("/dev/vfio/") and n != "/dev/vfio/vfio"
               for n in dev_nodes), dev_nodes
    assert cluster.tree_pci_driver(0, bdf) == "vfio-pci", \
        cluster.tree_pci_driver(0, bdf)
    print(f"[demo] gpu-test6: {bdf} vfio-bound, VFIO CDI injected",
          flush=True)
    cluster.unreserve(claim_name, ns)
    cluster._wait(lambda: cluster.claim_cdi_spec(cluster.node(0), uid)
                  is None, timeout, "gpu-test6 unprepare")
    cluster._wait(lambda: cluster.tree_pci_driver(0, bdf) == HOST_GPU_DRIVER,
                  10, f"the driver restored to {HOST_GPU_DRIVER}")
    print("[demo] gpu-test6: unprepare restored original driver — PASS",
          flush=True)


def _downgrade_checkpoint(path: Path, uid: str) -> list:
    """Rewrite a plugin's checkpoint as the V1-only file an older build
    would have left (its V1 shadow names ``uid``); the shadow's devices."""
    doc = json.loads(path.read_text())
    assert uid in doc["v1"] and doc["v1"][uid], doc.get("v1")
    path.write_text(json.dumps({"checksum": 0, "v1": doc["v1"]}))
    return doc["v1"][uid]


def _drop_devices_status(cluster: LocalCluster, name: str, ns: str) -> None:
    claim = cluster.client.get("ResourceClaim", name, ns)
    (claim.get("status") or {}).pop("devices", None)
    cluster.client.update_status(claim)


def _phase_updowngrade(cluster: LocalCluster, timeout: float) -> None:
    """The upstream test_gpu_updowngrade.bats over real processes: prepare
    a claim, downgrade the checkpoint to its V1 shadow, restart the plugin
    binary over it; the claim survives, unprepares cleanly, and the plugin
    serves the next pod."""
    ns = "gpu-test1"
    docs = apply_spec(cluster, ns)
    first, second = pods(docs)
    claim_name = cluster.schedule_pod(first, cluster.node(0))["gpu"]
    uid = cluster.claim_uid(claim_name, ns)
    cluster._wait(lambda: cluster.claim_ready(claim_name, ns), timeout,
                  "gpu-test1 claim Ready")
    cluster.kill_gpu_plugin(0)
    cp_path = cluster.gpu_state_dir(0) / "checkpoint.json"
    devices = _downgrade_checkpoint(cp_path, uid)
    print(f"[demo] updowngrade: V1 shadow carries {uid} -> {devices}",
          flush=True)
    _drop_devices_status(cluster, claim_name, ns)
    cluster.spawn_gpu_plugin(0)
    cluster._wait(lambda: cluster.claim_ready(claim_name, ns), timeout,
                  "the claim re-published after the V1-checkpoint restart")
    print("[demo] updowngrade: claim survived V1->V2 binary restart",
          flush=True)
    cluster.unreserve(claim_name, ns)
    cluster._wait(lambda: not cluster.claim_ready(claim_name, ns), timeout,
                  "the adopted claim unprepared")
    cluster._wait(lambda: cluster.claim_cdi_spec(cluster.node(0), uid)
                  is None, 10, "the adopted claim's CDI spec removed")
    assert uid not in json.loads(cp_path.read_text()).get("v1", {})
    refs = cluster.schedule_pod(second, cluster.node(0))
    cluster._wait(lambda: cluster.claim_ready(refs["gpu"], ns), timeout,
                  "the restarted plugin to serve the next pod")
    print("[demo] updowngrade: adopted claim unprepared cleanly — PASS",
          flush=True)


def _phase_cd_updowngrade(cluster: LocalCluster, timeout: float) -> None:
    """The upstream test_cd_updowngrade.bats: the same V1-checkpoint
    restart for the ComputeDomain plugin over a prepared channel claim of
    a one-node domain with a real daemon process."""
    ns = "default"
    cluster.client.create({
        "apiVersion": "resource.nvidia.com/v1beta1",
        "kind": "ComputeDomain",
        "metadata": {"name": "updn", "namespace": ns},
        "spec": {"numNodes": 1, "channel": {
            "resourceClaimTemplate": {"name": "updn-channel"},
            "allocationMode": "Single"}}})
    cluster._wait(lambda: cluster.client.try_get(
        "ResourceClaimTemplate", "updn-channel", ns) is not None, 30,
        "the controller to render the updn channel template")
    rct = cluster.client.get("ResourceClaimTemplate", "updn-channel", ns)
    cluster.client.create({
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": "updn-chan", "namespace": ns},
        "spec": rct["spec"]["spec"]})
    Allocator(cluster.client).allocate(
        cluster.client.get("ResourceClaim", "updn-chan", ns),
        reserved_for=[{"resource": "pods", "name": "updn-pod"}],
        node=cluster.node(0))
    # Prepare waits for the daemon's Ready; the kubelet role starts the
    # daemon once the node label lands.
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not cluster.claim_ready(
            "updn-chan", ns):
        cluster.sync_daemonsets()
        time.sleep(0.2)
    assert cluster.claim_ready("updn-chan", ns), "channel claim never Ready"
    uid = cluster.claim_uid("updn-chan", ns)
    cluster.kill_cd_plugin(0)
    cp_path = cluster.cd_state_dir(0) / "checkpoint.json"
    _downgrade_checkpoint(cp_path, uid)
    _drop_devices_status(cluster, "updn-chan", ns)
    cluster.spawn_cd_plugin(0)
    cluster._wait(lambda: cluster.claim_ready("updn-chan", ns), timeout,
                  "the channel claim re-published after the V1 restart")
    print("[demo] cd-updowngrade: channel claim survived V1->V2 restart",
          flush=True)
    cluster.unreserve("updn-chan", ns)
    cluster._wait(lambda: not cluster.claim_ready("updn-chan", ns), timeout,
                  "the adopted channel claim unprepared")
    assert uid not in json.loads(cp_path.read_text()).get("v1", {})
    print("[demo] cd-updowngrade: adopted channel claim unprepared — PASS",
          flush=True)


#: The demo's phases in order, each with the cluster it runs on.
PHASES = ("webhook", "gpu-test5", "gpu-test4", "gpu-test7", "failover",
          "gpu-test6", "updowngrade", "cd-updowngrade")


def run_demo(timeout: float = 120.0) -> dict[str, float]:
    """The quickstart matrix across real processes, in eight phases: the
    webhook's refusal, gpu-test5, gpu-test4 and gpu-test7 on two mock
    ``h100-8`` nodes in MIG mode under ``DynamicMIG``, a controller
    failover, then gpu-test6 (VFIO over a materialized tree) and the GPU
    and ComputeDomain plugins' V1-checkpoint up/downgrades on one node.
    Raises on the first failure; each phase's seconds."""
    seconds: dict[str, float] = {}

    def timed(name: str, fn, *args) -> None:
        t = time.monotonic()
        fn(*args)
        seconds[name] = round(time.monotonic() - t, 3)

    with tempfile.TemporaryDirectory(prefix="gpu-dra-local-") as wd:
        cluster = LocalCluster(wd, num_nodes=2, profile="h100-8",
                               controllers=2, mig=True,
                               feature_gates="DynamicMIG=true")
        try:
            timed("up", cluster.up)
            timed("webhook", _phase_webhook_admission, cluster)
            timed("gpu-test5", _phase_gpu_test5, cluster, timeout)
            timed("gpu-test4", _phase_gpu_test4, cluster, timeout)
            timed("gpu-test7", _phase_gpu_test7, cluster, timeout)
            timed("failover", _phase_controller_failover, cluster, timeout)
        finally:
            cluster.down()
    with tempfile.TemporaryDirectory(prefix="gpu-dra-vfio-") as wd:
        cluster = LocalCluster(wd, num_nodes=1, profile="h100-8", vfio=True,
                               feature_gates="PassthroughSupport=true")
        try:
            timed("up-vfio", cluster.up)
            timed("gpu-test6", _phase_gpu_test6, cluster, timeout)
            timed("updowngrade", _phase_updowngrade, cluster, timeout)
            timed("cd-updowngrade", _phase_cd_updowngrade, cluster, timeout)
        finally:
            cluster.down()
    print(f"[demo] phase seconds: {json.dumps(seconds)}", flush=True)
    print("[demo] ALL PHASES PASS", flush=True)
    return seconds


def _phase_gpu_test1(cluster: LocalCluster, timeout: float) -> None:
    """Two pods, one exclusive GPU each, from one template; both retired
    after."""
    ns = "gpu-test1"
    docs = apply_spec(cluster, ns)
    names = [cluster.schedule_pod(pod, cluster.node(0))["gpu"]
             for pod in pods(docs)]
    cluster._wait(lambda: all(cluster.claim_ready(n, ns) for n in names),
                  timeout, "gpu-test1 claims Ready")
    seen = [_visible(cluster.container_env(
        cluster.node(0), [cluster.claim_uid(n, ns)])) for n in names]
    assert all(len(v) == 1 for v in seen) and seen[0] != seen[1], seen
    print(f"[demo] gpu-test1: exclusive GPUs {seen[0][0]} / {seen[1][0]} "
          "— PASS", flush=True)
    for n in names:
        cluster.retire_claim(n, ns, timeout)


def run_quick(timeout: float = 30.0) -> dict[str, float]:
    """The short leg: one mock node (GPU plugin only, no controller) behind
    the webhook; the webhook's refusal, then gpu-test1. Each phase's
    seconds."""
    seconds: dict[str, float] = {}
    with tempfile.TemporaryDirectory(prefix="gpu-dra-quick-") as wd:
        cluster = LocalCluster(wd, num_nodes=1, profile="h100-8",
                               controllers=0, cd_plugins=False)
        try:
            for name, fn, args in (
                    ("up", cluster.up, ()),
                    ("webhook", _phase_webhook_admission, (cluster,)),
                    ("gpu-test1", _phase_gpu_test1, (cluster, timeout))):
                t = time.monotonic()
                fn(*args)
                seconds[name] = round(time.monotonic() - t, 3)
        finally:
            cluster.down()
    print(f"[demo] phase seconds: {json.dumps(seconds)}", flush=True)
    return seconds


def run_up(num_nodes: int = 2, profile: str = "h100-8") -> int:
    with tempfile.TemporaryDirectory(prefix="gpu-dra-local-") as wd:
        cluster = LocalCluster(wd, num_nodes=num_nodes, profile=profile)
        try:
            cluster.up()
            print("[cluster] up; Ctrl-C to tear down. "
                  f"Try: curl {cluster.endpoint}/apis/ResourceSlice",
                  flush=True)
            signal.sigwait({signal.SIGINT, signal.SIGTERM})
            return 0
        finally:
            cluster.down()


def main(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m k8s_dra_driver_tpu_torch.internal.localcluster",
        description="the GPU driver as a local cluster of real processes")
    p.add_argument("command", choices=["demo", "up"])
    p.add_argument("--timeout", type=float, default=120.0,
                   help="seconds each wait of the demo may take")
    p.add_argument("--nodes", type=int, default=2,
                   help="node pairs to start (up)")
    p.add_argument("--profile", default="h100-8",
                   help="mock GPU profile of the nodes (up); empty = the "
                        "machine's own GPUs")
    args = p.parse_args(argv)
    if args.command == "demo":
        run_demo(args.timeout)
        return 0
    return run_up(args.nodes, args.profile)


if __name__ == "__main__":
    raise SystemExit(main())
