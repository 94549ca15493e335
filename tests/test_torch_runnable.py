"""The port's binaries, held against the JAX package's.

Each binary prints its help and exits 0 without a GPU. The same argv and
environment (``TPU_DRA_*`` there, ``GPU_DRA_*`` here) resolve to the same
flags; the log formatters write the same text and JSON lines; each
package's gRPC health client reads the other package's health server.
Each ``run_*(args, block=False)`` assembles on ``--mock-profile h100-8``
against the port's ``ApiServer``, with the scenarios of
``tests/test_runnable.py::TestPluginAssembly``, the controller's included
(``--shards 1`` and the GPU plugin's ``--trace true`` among them); the
webhook server answers the admission corpus of ``tests/test_torch_webhook.py`` as the JAX one
does. Then the port's processes: the API server and the GPU plugin as OS
processes (the multi-process smoke and the ``-v 1`` / ``-v 0`` logging
contract of ``TestMultiProcessSmoke``), and ``chip_smoke.py``'s
``processes`` phase on a mock node. Every process a test starts is sent
SIGTERM, waited for with a deadline, killed if still alive, and must exit
0.
"""

import io
import json
import logging
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from k8s_dra_driver_tpu.pkg import logging as jax_logging
from k8s_dra_driver_tpu.plugins.compute_domain_controller import main as jax_controller_main
from k8s_dra_driver_tpu.plugins.compute_domain_daemon import main as jax_daemon_main
from k8s_dra_driver_tpu.plugins.compute_domain_kubelet_plugin import main as jax_cd_main
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import healthcheck as jax_health
from k8s_dra_driver_tpu.plugins.tpu_kubelet_plugin import main as jax_plugin_main
from k8s_dra_driver_tpu.plugins.webhook import main as jax_webhook_main
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    BACKEND_MOCK,
    MockDeviceLib,
)
from k8s_dra_driver_tpu_torch.internal import common, info
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.k8sclient.httpapi import ApiServer, HttpClient
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.pkg import blackbox, flags, process, sanitizer
from k8s_dra_driver_tpu_torch.pkg import logging as port_logging
from k8s_dra_driver_tpu_torch.pkg.process import ProcessHandle
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller import main as controller_main
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import main as daemon_main
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import main as cd_main
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import healthcheck
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import main as plugin_main
from k8s_dra_driver_tpu_torch.plugins.webhook import main as webhook_main

REPO = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
MODULES = ["k8s_dra_driver_tpu_torch.k8sclient.httpapi",
           "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin",
           "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin",
           "k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon",
           "k8s_dra_driver_tpu_torch.plugins.webhook",
           "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller"]
STOP_TIMEOUT = 20


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    for k in list(env):
        if k.startswith("GPU_DRA_") or k == "NODE_NAME":
            del env[k]
    return env


def _stop(proc):
    """SIGTERM, wait with a deadline, kill if still alive; the exit code."""
    if proc.poll() is None:
        proc.terminate()
    try:
        return proc.wait(timeout=STOP_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        return "killed"


@pytest.fixture()
def api():
    server = ApiServer().start()
    yield server, HttpClient(server.endpoint)
    server.stop()


def _sock(name):
    """A gRPC address on an abstract unix socket, unique to this process:
    no path, so no length limit whatever the temp dir."""
    return f"unix-abstract:gpu-dra-test-{os.getpid()}-{name}"


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    return cond()


# -- the binaries start without a GPU ---------------------------------------

@pytest.mark.parametrize("module", MODULES)
def test_help_exits_zero(module):
    proc = subprocess.run([sys.executable, "-m", module, "--help"],
                          capture_output=True, text=True, env=_env(),
                          cwd=REPO, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout


# -- flags: the same argv and env, the same resolved flags ------------------

#: binary → (JAX parser, port parser, argv, JAX env, port env)
FLAG_CASES = {
    "kubelet-plugin": (
        jax_plugin_main.build_parser, plugin_main.build_parser,
        ["--node-name", "n1", "--gc-interval", "30", "-v", "2",
         "--state-dir", "/s", "--healthcheck-addr", ""],
        {"TPU_DRA_MOCK_PROFILE": "p", "TPU_DRA_METRICS_PORT": "9400",
         "TPU_DRA_FEATURE_GATES": "DeviceHealthCheck=false",
         "TPU_DRA_LOCK_PROFILE": "on", "TPU_DRA_PROFILE_INTERVAL": "0.5",
         "TPU_DRA_NODE_LEASE_DURATION": "3", "TPU_DRA_LOG_FORMAT": "json",
         "TPU_DRA_API_ENDPOINT": "http://x:1", "CDI_ROOT": "/c"},
        {"GPU_DRA_MOCK_PROFILE": "p", "GPU_DRA_METRICS_PORT": "9400",
         "GPU_DRA_FEATURE_GATES": "DeviceHealthCheck=false",
         "GPU_DRA_LOCK_PROFILE": "on", "GPU_DRA_PROFILE_INTERVAL": "0.5",
         "GPU_DRA_NODE_LEASE_DURATION": "3", "GPU_DRA_LOG_FORMAT": "json",
         "GPU_DRA_API_ENDPOINT": "http://x:1", "CDI_ROOT": "/c"}),
    "cd-plugin": (
        jax_cd_main.build_parser, cd_main.build_parser,
        ["--channel-count", "4", "--driver-namespace", "drv",
         "--state-dir", "/s", "--healthcheck-addr", "unix:///h"],
        {"NODE_NAME": "env-node", "TPU_DRA_GC_INTERVAL": "7",
         "TPU_DRA_TRACE": "true"},
        {"NODE_NAME": "env-node", "GPU_DRA_GC_INTERVAL": "7",
         "GPU_DRA_TRACE": "true"}),
    "daemon-run": (
        jax_daemon_main.build_parser, daemon_main.build_parser,
        ["run", "--node-name", "n", "--cd-uid", "u", "--sync-interval", "1"],
        {"COMPUTE_DOMAIN_NAME": "cd", "POD_IP": "10.0.0.1",
         "TPU_DRA_METRICS_PORT": "0"},
        {"COMPUTE_DOMAIN_NAME": "cd", "POD_IP": "10.0.0.1",
         "GPU_DRA_METRICS_PORT": "0"}),
    "daemon-check": (
        jax_daemon_main.build_parser, daemon_main.build_parser,
        ["check", "--node-name", "n", "--mock-profile", "m"], {}, {}),
    "webhook": (
        jax_webhook_main.build_parser, webhook_main.build_parser,
        ["--port", "0"],
        {"TPU_DRA_WEBHOOK_TLS_CERT": "c", "TPU_DRA_WEBHOOK_TLS_KEY": "k"},
        {"GPU_DRA_WEBHOOK_TLS_CERT": "c", "GPU_DRA_WEBHOOK_TLS_KEY": "k"}),
    "controller": (
        jax_controller_main.build_parser, controller_main.build_parser,
        ["--fleet-scrape-targets", "node-0=h:1,h:2", "--canary-interval",
         "0.5", "--leader-elect", "--incident-dir", "/i"],
        {"TPU_DRA_FLEET_SCRAPE_INTERVAL": "0.2", "TPU_DRA_DEFRAG": "off",
         "TPU_DRA_USAGE_METERING": "false", "TPU_DRA_SHARDS": "0",
         "TPU_DRA_INCIDENT_RETENTION": "4", "POD_NAMESPACE": "ns"},
        {"GPU_DRA_FLEET_SCRAPE_INTERVAL": "0.2", "GPU_DRA_DEFRAG": "off",
         "GPU_DRA_USAGE_METERING": "false", "GPU_DRA_SHARDS": "0",
         "GPU_DRA_INCIDENT_RETENTION": "4", "POD_NAMESPACE": "ns"}),
}

#: Defaults that name each package's own driver and paths, and the mock
#: node index (JAX's TPU worker id 0, the port's unset node 0).
PACKAGE_DEFAULTS = {"state_dir", "healthcheck_addr", "host_index",
                    "incident_dir"}


def _resolve(parser_fn, argv, env, monkeypatch):
    for k in list(os.environ):
        if k.startswith(("TPU_DRA_", "GPU_DRA_")) or k in (
                "NODE_NAME", "CDI_ROOT", "POD_IP", "COMPUTE_DOMAIN_NAME",
                "TPU_WORKER_ID", "POD_NAMESPACE"):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return vars(parser_fn().parse_args(argv))


@pytest.mark.parametrize("binary", sorted(FLAG_CASES))
def test_same_argv_and_env_resolve_the_same(binary, monkeypatch):
    jax_parser, port_parser, argv, jax_env, port_env = FLAG_CASES[binary]
    with monkeypatch.context() as m:
        want = _resolve(jax_parser, argv, jax_env, m)
    with monkeypatch.context() as m:
        got = _resolve(port_parser, argv, port_env, m)
    assert set(got) == set(want)
    for k in set(want) - PACKAGE_DEFAULTS:
        assert got[k] == want[k], k
    for k in PACKAGE_DEFAULTS & set(want):
        if k in argv or f"--{k.replace('_', '-')}" in argv:
            assert got[k] == want[k], k


def test_package_defaults_name_the_gpu_driver(monkeypatch):
    for k in ("NODE_NAME", "GPU_DRA_STATE_DIR", "GPU_DRA_HEALTHCHECK_ADDR"):
        monkeypatch.delenv(k, raising=False)
    args = plugin_main.build_parser().parse_args(["--node-name", "n"])
    assert args.state_dir == "/var/lib/gpu-dra-driver/gpu.nvidia.com"
    assert args.healthcheck_addr.startswith("unix://")
    assert args.healthcheck_addr.endswith("gpu-dra-health.sock")
    assert args.host_index is None
    cd = cd_main.build_parser().parse_args(["--node-name", "n"])
    assert cd.state_dir == \
        "/var/lib/gpu-dra-driver/compute-domain.nvidia.com"


def test_node_name_required_without_env(monkeypatch):
    monkeypatch.delenv("NODE_NAME", raising=False)
    with pytest.raises(SystemExit):
        plugin_main.build_parser().parse_args([])


@pytest.mark.parametrize("bad", [
    ["--gc-interval", "0"], ["--health-poll-interval", "0"],
    ["--remediation-poll-interval", "-1"], ["--node-lease-duration", "-1"],
    ["--profile-interval", "-0.5"]])
def test_validate_rejects_what_jax_rejects(bad):
    argv = ["--node-name", "n", *bad]
    with pytest.raises(SystemExit):
        jax_plugin_main.validate_flags(
            jax_plugin_main.build_parser().parse_args(argv))
    with pytest.raises(SystemExit):
        plugin_main.validate_flags(plugin_main.build_parser().parse_args(argv))


def test_bad_feature_gates_and_refused_features_exit_cleanly():
    for gates, what in (("Nope=true", "unknown feature gate"),
                        ("DynamicMIG=true", "not supported")):
        args = plugin_main.build_parser().parse_args(
            ["--node-name", "n", "--feature-gates", gates])
        with pytest.raises(SystemExit, match=what):
            flags.parse_feature_gates(args)


def test_trace_true_starts_the_plugin_with_the_tracer_on(tmp_path, api):
    """``--trace true`` enables the process's tracer at assembly: the
    plugin starts and its ``/debug/traces`` reports ``enabled: true``."""
    from k8s_dra_driver_tpu_torch.pkg import tracing

    server, _ = api
    handle = plugin_main.run_plugin(_plugin_args(
        server, tmp_path, "--trace", "true", "--healthcheck-addr", "",
        "--metrics-port", "0"), block=False)
    try:
        base = f"http://127.0.0.1:{handle.servers[0].port}"
        snap = json.loads(urllib.request.urlopen(
            f"{base}/debug/traces").read())
        assert snap["enabled"] is True
        assert snap["capacity"] == tracing.DEFAULT_CAPACITY
    finally:
        handle.stop()
        tracing._reset_for_tests()


def test_health_server_without_grpc_exits_naming_the_flag(api, tmp_path,
                                                          monkeypatch):
    server, _ = api
    monkeypatch.setitem(sys.modules, "grpc", None)   # import grpc fails
    args = plugin_main.build_parser().parse_args([
        "--node-name", "n", "--api-endpoint", server.endpoint,
        "--mock-profile", "h100-8", "--state-dir", str(tmp_path / "s"),
        "--cdi-root", str(tmp_path / "c"),
        "--healthcheck-addr", _sock("no-grpc")])
    threads = set(threading.enumerate())
    with pytest.raises(SystemExit, match="--healthcheck-addr"):
        plugin_main.run_plugin(args, block=False)
    assert set(threading.enumerate()) <= threads
    args.healthcheck_addr = ""
    with pytest.raises(SystemExit, match="--healthcheck-addr"):
        cd_main.run_plugin(cd_main.build_parser().parse_args([
            "--node-name", "n", "--mock-profile", "h100-8",
            "--healthcheck-addr", "unix:///nowhere"]), block=False)


def test_device_lib_choice(monkeypatch):
    args = plugin_main.build_parser().parse_args(
        ["--node-name", "n", "--mock-profile", "dgx-h100-256",
         "--host-index", "3"])
    lib = flags.build_device_lib(args)
    assert lib.backend == BACKEND_MOCK and lib.host_index == 3
    assert len(lib.enumerate_gpus()) == 8
    # No mock: NVML where the host has it, else procfs (this machine);
    # the binaries and locate_gpu take the same library.
    from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
    args = plugin_main.build_parser().parse_args(["--node-name", "n"])
    monkeypatch.delenv(dl.ENV_MOCK_PROFILE, raising=False)
    monkeypatch.setattr(dl, "find_nvml", lambda env=None, root=None: None)
    assert flags.build_device_lib(args).backend == dl.BACKEND_PROCFS
    assert dl.new_device_lib().backend == dl.BACKEND_PROCFS
    monkeypatch.setattr(dl, "find_nvml",
                        lambda env=None, root=None: "libnvidia-ml.so.1")
    assert flags.build_device_lib(args).backend == dl.BACKEND_NVML
    assert dl.new_device_lib().backend == dl.BACKEND_NVML
    # The mock profile's env mirror reaches the same function.
    monkeypatch.setenv(dl.ENV_MOCK_PROFILE, "h100-8")
    assert dl.new_device_lib().backend == BACKEND_MOCK


# -- logging: the same lines ------------------------------------------------

def _record(msg="prepared %s", args=("claim-1",), exc=False):
    exc_info = None
    if exc:
        try:
            raise ValueError("boom")
        except ValueError:
            exc_info = sys.exc_info()
    r = logging.LogRecord("k8s.x", logging.WARNING, __file__, 7, msg, args,
                          exc_info)
    r.created, r.msecs = 1700000000.123456, 123.456
    return r


@pytest.mark.parametrize("exc", [False, True], ids=["plain", "exception"])
@pytest.mark.parametrize("component", ["", "gpu-kubelet-plugin"])
@pytest.mark.parametrize("kind", ["JSONFormatter", "TextFormatter"])
def test_formatters_write_jax_lines(kind, component, exc):
    want = getattr(jax_logging, kind)(component).format(_record(exc=exc))
    got = getattr(port_logging, kind)(component).format(_record(exc=exc))
    assert got == want
    if kind == "JSONFormatter":
        doc = json.loads(got)
        assert doc["level"] == "warning" and doc["message"] == \
            "prepared claim-1" and "trace_id" not in doc


def test_setup_logging_replaces_its_handler_and_checks_names():
    root = logging.getLogger()
    before, level = list(root.handlers), root.level
    try:
        buf = io.StringIO()
        port_logging.setup_logging("c", "debug", "json", stream=buf)
        h = port_logging.setup_logging("c", "info", "json", stream=buf)
        mine = [x for x in root.handlers if x not in before]
        assert mine == [h] and root.level == logging.INFO
        logging.getLogger("t").info("hello")
        assert json.loads(buf.getvalue())["message"] == "hello"
        for bad in (lambda: port_logging.setup_logging(fmt="xml"),
                    lambda: port_logging.parse_level("loud")):
            with pytest.raises(ValueError):
                bad()
        assert port_logging.parse_level(" Debug ") == \
            jax_logging.parse_level(" Debug ") == logging.DEBUG
    finally:
        for x in list(root.handlers):
            if x not in before:
                root.removeHandler(x)
        root.setLevel(level)


# -- the gRPC health service, each way --------------------------------------

def test_health_check_each_way():
    port_sock, jax_sock = _sock("port"), _sock("jax")
    status = [healthcheck.STATUS_SERVING]
    port_server = healthcheck.HealthcheckServer(lambda: status[0],
                                                port_sock).start()
    jax_ok = [True]
    jax_server = jax_health.HealthcheckServer(lambda: jax_ok[0],
                                              jax_sock).start()
    try:
        assert jax_health.check_health(port_sock) == \
            healthcheck.check_health(port_sock) == healthcheck.STATUS_SERVING
        assert healthcheck.check_health(jax_sock) == \
            jax_health.STATUS_SERVING
        status[0], jax_ok[0] = healthcheck.STATUS_NOT_SERVING, False
        assert jax_health.check_health(port_sock) == \
            healthcheck.STATUS_NOT_SERVING
        assert healthcheck.check_health(jax_sock) == \
            jax_health.STATUS_NOT_SERVING
        status[0] = None                     # a probe that raises
        assert healthcheck.check_health(port_sock) == \
            healthcheck.STATUS_NOT_SERVING
    finally:
        port_server.stop()
        jax_server.stop()


# -- each binary assembled in-process (TestPluginAssembly) ------------------

def _plugin_args(server, tmp_path, *extra):
    return plugin_main.build_parser().parse_args([
        "--node-name", "proc-node", "--api-endpoint", server.endpoint,
        "--mock-profile", "h100-8", "--state-dir", str(tmp_path / "state"),
        "--cdi-root", str(tmp_path / "cdi"), *extra])


def test_gpu_plugin_run(tmp_path, api):
    """run_plugin assembles the driver and its servers against an HTTP
    endpoint: the slice appears, /metrics and every /debug endpoint
    serve, gRPC health reads SERVING; stop() ends every thread."""
    server, client = api
    sock = _sock("run")
    threads = set(threading.enumerate())
    handle = plugin_main.run_plugin(
        _plugin_args(server, tmp_path, "--healthcheck-addr", sock),
        block=False)
    try:
        slices = client.list("ResourceSlice")
        assert len(slices) == 1
        assert slices[0]["spec"]["nodeName"] == "proc-node"
        assert len(slices[0]["spec"]["devices"]) == 8
        base = f"http://127.0.0.1:{handle.servers[0].port}"
        body = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "gpu_dra_requests_total" in body
        assert "gpu_dra_node_lease_renewals_total" in body or \
            "gpu_dra_node" in body
        listed = json.loads(urllib.request.urlopen(f"{base}/debug").read())
        assert listed["endpoints"] == sorted(
            f"/debug/{k}" for k in common.standard_debug_handlers())
        for ep in listed["endpoints"]:
            json.loads(urllib.request.urlopen(base + ep).read())
        lease = json.loads(urllib.request.urlopen(
            f"{base}/debug/nodelease").read())
        assert [h["node"] for h in lease["heartbeats"]] == ["proc-node"]
        assert healthcheck.check_health(sock) == healthcheck.STATUS_SERVING
        assert handle.monitor is not None and handle.profiler is not None
    finally:
        handle.stop()

    def left():   # the API server's handlers serve this test's client
        return sorted(t.name for t in set(threading.enumerate()) - threads
                      if "process_request_thread" not in t.name)
    assert _wait(lambda: not left(), 10), left()


def test_gpu_plugin_prepares_a_claim_and_gates_health(tmp_path, api):
    """The kubelet-role loop prepares an allocated claim into a CDI spec;
    with DeviceHealthCheck off there is no monitor and no drainer."""
    server, client = api
    client.create(new_object("DeviceClass", "gpu.nvidia.com", spec={
        "selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    handle = plugin_main.run_plugin(_plugin_args(
        server, tmp_path, "--healthcheck-addr", "", "--metrics-port", "-1",
        "--feature-gates", "DeviceHealthCheck=false",
        "--profile-interval", "0"), block=False)
    try:
        assert handle.monitor is None and handle.profiler is None
        assert handle.servers == []
        claim = client.create(new_object(
            "ResourceClaim", "c", "default", api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": "gpu.nvidia.com",
                "allocationMode": "ExactCount", "count": 2}}]}}))
        Allocator(client).allocate(claim, reserved_for=[
            {"resource": "pods", "name": "p"}], node="proc-node")
        uid = claim["metadata"]["uid"]
        assert _wait(lambda: handle.driver.cdi.read_claim_spec(uid))
        spec = handle.driver.cdi.read_claim_spec(uid)
        env = [e for d in spec["devices"]
               for e in d["containerEdits"].get("env", [])] + \
            spec.get("containerEdits", {}).get("env", [])
        assert any(e.startswith("CUDA_VISIBLE_DEVICES=GPU-") for e in env)
    finally:
        handle.stop()


def test_controller_run(api):
    """Controller main shares the run_*(args, block=) contract."""
    server, _client = api
    args = controller_main.build_parser().parse_args([
        "--api-endpoint", server.endpoint, "--metrics-port", "-1"])
    handle = controller_main.run_controller(args, block=False)
    try:
        assert handle.driver is not None
        assert handle.binary == "compute-domain-controller"
        assert handle.meter is not None          # usage metering: default on
        assert handle.telemetry is None          # no scrape targets
        assert handle.reallocator is not None
    finally:
        handle.stop()


def test_controller_with_one_shard_starts_and_stops(api):
    """``--shards 1`` as an OS process: the replica takes the one shard
    lease (its first sync round comes one retry period after start), and
    on SIGTERM empties it and exits 0."""
    server, client = api

    def holder():
        lease = client.try_get("Lease", "controller-shard-0", "default")
        return (lease or {}).get("spec", {}).get("holderIdentity")

    proc = subprocess.Popen(
        [sys.executable, "-m", MODULES[-1], "--api-endpoint",
         server.endpoint, "--metrics-port", "-1", "--shards", "1",
         "--identity", "solo"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
        env=_env())
    try:
        assert _wait(lambda: holder() == "solo"), holder()
        proc.terminate()
        assert proc.wait(timeout=STOP_TIMEOUT) == 0
        assert holder() == ""
    finally:
        assert _stop(proc) == 0


def test_controller_watches_a_plugin(tmp_path, api):
    """The controller's observability plane over a GPU plugin's /metrics:
    the plugin scraped as up, a gpu_dra_fleet_* mirror of its families,
    the default SLOs plus allocation_admission and canary_availability
    none firing, a canary probe of the node, the served claim metered in
    GPU-seconds, and no incident; stop() ends every thread."""
    server, client = api
    client.create(new_object("DeviceClass", "gpu.nvidia.com", spec={
        "selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object("Node", "proc-node"))
    threads = set(threading.enumerate())
    plugin = plugin_main.run_plugin(_plugin_args(
        server, tmp_path, "--healthcheck-addr", "", "--metrics-port", "0"),
        block=False)
    ctl = None
    try:
        port = plugin.servers[0].port
        ctl = controller_main.run_controller(
            controller_main.build_parser().parse_args([
                "--api-endpoint", server.endpoint, "--metrics-port", "0",
                "--fleet-scrape-targets",
                f"proc-node=127.0.0.1:{port}",
                "--fleet-scrape-interval", "0.1",
                "--canary-interval", "0.2",
                "--incident-dir", str(tmp_path / "inc")]), block=False)
        base = f"http://127.0.0.1:{ctl.servers[0].port}"

        def get(path):
            return json.loads(urllib.request.urlopen(base + path).read())

        def up():
            fleet = get("/debug/fleet")
            node = [t for t in fleet["targets"] if t["name"] == "proc-node"]
            return node and not node[0]["stale"] and \
                node[0]["scrapes"] > node[0]["failures"]
        assert _wait(up), get("/debug/fleet")
        claim = client.create(new_object(
            "ResourceClaim", "served", "default",
            api_version="resource.k8s.io/v1",
            spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": "gpu.nvidia.com",
                "allocationMode": "ExactCount", "count": 2}}]}}))
        Allocator(client).allocate(claim, reserved_for=[
            {"resource": "pods", "name": "p"}], node="proc-node")

        def billed():
            return any(r.get("gpus") == 2 for u in get("/debug/usage")
                       for r in u.get("live", []))
        assert _wait(billed), get("/debug/usage")
        assert _wait(lambda: any(
            st["probes"] - st["failures"] >= 1
            for p in get("/debug/canary")
            for st in p["nodes"].values())), get("/debug/canary")
        metrics = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "gpu_dra_fleet_requests_total" in metrics
        assert "gpu_dra_fleet_canary_probes_total" in metrics
        # The process's registries also list earlier tests' live planes:
        # the controller's are the engine with its SLO set and the
        # recorder on its incident dir.
        mine = [e for e in get("/debug/slo")
                if {x["name"] for x in e["slos"]} == {
                    "claim_ready_latency", "prepare_errors",
                    "remediation_recovery", "allocation_admission",
                    "canary_availability"}]
        assert mine and all(e["firing"] == {} for e in mine), mine
        incidents = [r for r in get("/debug/incidents")
                     if r["dir"] == str(tmp_path / "inc" / "incidents")]
        assert [r["bundles"] for r in incidents] == [[]]
    finally:
        if ctl is not None:
            ctl.stop()
        plugin.stop()

    def left():   # the API server's handlers serve this test's client
        return sorted(t.name for t in set(threading.enumerate()) - threads
                      if "process_request_thread" not in t.name)
    assert _wait(lambda: not left(), 10), left()


def test_cd_plugin_run(tmp_path, api):
    server, client = api
    client.create(new_object("Node", "proc-node"))
    args = cd_main.build_parser().parse_args([
        "--node-name", "proc-node", "--api-endpoint", server.endpoint,
        "--mock-profile", "h100-8", "--state-dir", str(tmp_path / "state"),
        "--cdi-root", str(tmp_path / "cdi"), "--healthcheck-addr", ""])
    handle = cd_main.run_plugin(args, block=False)
    try:
        slices = [s for s in client.list("ResourceSlice")
                  if s["spec"]["driver"] == "compute-domain.nvidia.com"]
        assert len(slices) == 1
        assert {d["name"] for d in slices[0]["spec"]["devices"]} == \
            {"channel-0", "daemon"}
        assert handle.binary == "compute-domain-kubelet-plugin"
    finally:
        handle.stop()


def test_daemon_run_publishes_and_withdraws(api):
    server, client = api
    args = daemon_main.build_parser().parse_args([
        "run", "--node-name", "proc-node", "--api-endpoint",
        server.endpoint, "--mock-profile", "h100-8", "--cd-uid", "cd-uid-1",
        "--cd-name", "cd", "--metrics-port", "0"])
    handle = daemon_main.run_daemon(args, block=False)
    try:
        assert _wait(lambda: client.list("ComputeDomainClique"), 5), \
            "daemon never published its clique entry"
    finally:
        handle.stop()
    infos = [i for c in client.list("ComputeDomainClique")
             for i in c.get("daemons", [])]
    assert all(i.get("nodeName") != "proc-node" for i in infos)


def test_daemon_refuses_without_identity_and_check_probes():
    args = daemon_main.build_parser().parse_args(
        ["run", "--node-name", "n", "--mock-profile", "h100-8"])
    with pytest.raises(SystemExit, match="COMPUTE_DOMAIN_UUID"):
        daemon_main.run_daemon(args, block=False)
    args = daemon_main.build_parser().parse_args(
        ["check", "--node-name", "n", "--mock-profile", "h100-8"])
    assert daemon_main.run_check(args) == 0
    assert daemon_main.main([]) == 2


def test_process_handle_stops_in_reverse_order():
    order = []
    h = ProcessHandle("b", driver="d")
    for i in range(3):
        h.on_stop(lambda i=i: order.append(i))
    h.stop()
    assert order == [2, 1, 0] and h.driver == "d"


# -- the webhook server, as JAX's answers -----------------------------------

def _post(endpoint, review):
    req = urllib.request.Request(
        endpoint + "/validate-resource-claim-parameters",
        data=json.dumps(review).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def test_webhook_servers_answer_the_same():
    from test_torch_webhook import CORPUS, JAX, PORT, _as_port

    jax_server = jax_webhook_main.WebhookServer(port=0).start()
    port_server = webhook_main.WebhookServer(port=0).start()
    try:
        for case, review in sorted(CORPUS.items()):
            want = _post(jax_server.endpoint, review(JAX))["response"]
            got = _post(port_server.endpoint, review(PORT))["response"]
            assert got["uid"] == want["uid"], case
            assert got["allowed"] == want["allowed"], case
            if not want["allowed"]:
                assert got["status"]["reason"] == want["status"]["reason"]
                assert _as_port(got["status"]["message"]) == \
                    _as_port(want["status"]["message"]), case
        with urllib.request.urlopen(port_server.endpoint + "/readyz") as r:
            assert r.read() == b"ok"
    finally:
        jax_server.stop()
        port_server.stop()


@pytest.mark.parametrize("headers,body,code", [
    ({"Content-Type": "text/plain"}, b"{}", 415),
    ({"Content-Type": "application/json"}, b"not json", 400)])
def test_webhook_refuses_what_jax_refuses(headers, body, code):
    codes = []
    for mod in (jax_webhook_main, webhook_main):
        server = mod.WebhookServer(port=0).start()
        try:
            req = urllib.request.Request(
                server.endpoint + "/validate-resource-claim-parameters",
                data=body, method="POST", headers=headers)
            try:
                urllib.request.urlopen(req, timeout=10)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
        finally:
            server.stop()
    assert codes == [code, code]


def test_api_server_admission_gate_through_the_port_webhook():
    """``tests/test_runnable.py::test_admission_webhook_gate`` on the port:
    claim writes are reviewed by the webhook server; a denial or an
    unreachable webhook rejects them, other kinds pass."""
    wh = webhook_main.WebhookServer(port=0).start()
    server = ApiServer(admission_webhook=wh.endpoint).start()
    client = HttpClient(server.endpoint)
    try:
        def claim(name, params):
            return {"apiVersion": "resource.k8s.io/v1",
                    "kind": "ResourceClaim",
                    "metadata": {"name": name, "namespace": "default"},
                    "spec": {"devices": {
                        "requests": [{"name": "gpu", "exactly": {
                            "deviceClassName": "gpu.nvidia.com",
                            "allocationMode": "ExactCount", "count": 1}}],
                        "config": [{"requests": ["gpu"], "opaque": {
                            "driver": "gpu.nvidia.com",
                            "parameters": params}}]}}}
        ok = {"apiVersion": "resource.nvidia.com/v1beta1",
              "kind": "GpuConfig"}
        bad = {**ok, "envv": {"X": "1"}}
        created = client.create(claim("good", ok))
        with pytest.raises(Exception, match="unknown fields"):
            client.create(claim("typo", bad))
        assert client.try_get("ResourceClaim", "typo", "default") is None
        created["spec"]["devices"]["config"][0]["opaque"]["parameters"] = bad
        with pytest.raises(Exception, match="unknown fields"):
            client.update(created)
        client.create(new_object("ConfigMap", "cm", "default"))
        wh.stop()
        with pytest.raises(Exception, match="unreachable"):
            client.create(claim("orphan", ok))
        client.create(new_object("ConfigMap", "cm2", "default"))
    finally:
        server.stop()


# -- runtime pieces ----------------------------------------------------------

def test_debug_handler_set_is_jaxs():
    from k8s_dra_driver_tpu.internal import common as jax_common

    from k8s_dra_driver_tpu_torch.pkg.blackbox import (
        incidents_debug_snapshot,
    )
    from k8s_dra_driver_tpu_torch.pkg.slo import slo_debug_snapshot
    from k8s_dra_driver_tpu_torch.pkg.usage import usage_debug_snapshot

    handlers = common.standard_debug_handlers()
    assert set(handlers) == set(jax_common.standard_debug_handlers())
    assert handlers["slo"] is slo_debug_snapshot
    assert handlers["incidents"] is incidents_debug_snapshot
    assert handlers["usage"] is usage_debug_snapshot
    # A process that assembles none of them serves empty lists (a fresh
    # one: earlier tests' engines and meters may still be alive here).
    proc = subprocess.run(
        [sys.executable, "-c",
         "from k8s_dra_driver_tpu_torch.internal.common import "
         "standard_debug_handlers as h; d = h(); "
         "print([d[n]() for n in ('slo', 'incidents', 'usage')])"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[[], [], []]"
    assert handlers["traces"]() == {
        "enabled": False, "capacity": 8192, "stored_spans": 0,
        "dropped_spans": 0, "traces": 0, "spans": []}


def test_stack_dump_and_version(tmp_path):
    path = tmp_path / "stacks.txt"
    text = common.dump_stacks(str(path))
    assert path.read_text() == text and "MainThread" in text
    assert info.version_string().startswith(info.VERSION + "+")


def test_lock_profiling_records_contention():
    sanitizer.reset_lock_contention()
    sanitizer.set_lock_profiling(True)
    try:
        lock = sanitizer.new_lock("T._mu")
        assert isinstance(lock, sanitizer.ContentionLock)
        lock.acquire()
        t = threading.Thread(target=lambda: (lock.acquire(), lock.release()))
        t.start()
        time.sleep(0.05)
        lock.release()
        t.join(timeout=5)
        rows = sanitizer.lock_contention_snapshot()
        assert [r["lock"] for r in rows] == ["T._mu"] and rows[0]["waits"] == 1
        prof = blackbox.ContinuousProfiler(base_interval_s=0.01).start()
        assert _wait(lambda: prof.snapshot()["samples"]["base"] >= 2, 5)
        snap = prof.snapshot()
        prof.stop()
        assert snap["lock_contention"][0]["lock"] == "T._mu"
        assert any(s["stack"] for s in snap["stacks"])
        assert prof in list(blackbox._live_profilers)
    finally:
        sanitizer.set_lock_profiling(False)
        sanitizer.reset_lock_contention()
    assert not isinstance(sanitizer.new_lock("plain"),
                          sanitizer.ContentionLock)


# -- the port's processes -----------------------------------------------------

def _spawn_api_server():
    """The port's API server as an OS process: (proc, endpoint)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s_dra_driver_tpu_torch.k8sclient.httpapi",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=REPO)
    try:
        endpoint = None
        for _ in range(10):  # skip log lines before the banner
            line = proc.stdout.readline()
            if "listening on" in line:
                endpoint = line.strip().rsplit(" ", 1)[-1]
                break
        assert endpoint, "api server banner not seen"
    except BaseException:
        _stop(proc)
        raise
    return proc, endpoint


def _plugin_argv(node, endpoint, tmp_path, stem, *extra):
    return [sys.executable, "-m",
            "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin",
            "--node-name", node, "--api-endpoint", endpoint,
            "--mock-profile", "h100-8",
            "--state-dir", str(tmp_path / f"{stem}-state"),
            "--cdi-root", str(tmp_path / f"{stem}-cdi"),
            "--metrics-port", "-1", *extra]


def test_apiserver_and_plugin_processes(tmp_path):
    """The API server and the GPU plugin as OS processes; this test, a
    third process, reads the published slice over HTTP and the plugin's
    gRPC health, and both exit 0 on SIGTERM."""
    api_proc, endpoint = _spawn_api_server()
    rcs = {}
    try:
        sock = _sock("process")
        log = tmp_path / "plugin.log"
        with open(log, "w") as log_f:
            plugin = subprocess.Popen(
                _plugin_argv("smoke-node", endpoint, tmp_path, "smoke",
                             "--healthcheck-addr", sock),
                stdout=log_f, stderr=subprocess.STDOUT, env=_env(), cwd=REPO)
        try:
            client = HttpClient(endpoint)
            assert _wait(lambda: client.list("ResourceSlice")), \
                "plugin never published a ResourceSlice"
            slices = client.list("ResourceSlice")
            assert slices[0]["spec"]["nodeName"] == "smoke-node"
            assert len(slices[0]["spec"]["devices"]) == 8
            # Assembled and waiting for its signal (it handles SIGTERM
            # from then on).
            assert _wait(lambda: "running on node" in log.read_text())
            assert healthcheck.check_health(sock) == \
                healthcheck.STATUS_SERVING
        finally:
            rcs["plugin"] = _stop(plugin)
    finally:
        rcs["api"] = _stop(api_proc)
    assert rcs == {"plugin": 0, "api": 0}


def test_sigterm_at_the_ready_line_stops_cleanly(tmp_path):
    """``block_until_signaled`` installs the stop handlers before it logs
    the ready line: a SIGTERM sent the moment that line appears stops the
    plugin with exit code 0 (were the line logged first, the signal could
    take the default action and kill the process, -15)."""
    api_proc, endpoint = _spawn_api_server()
    try:
        log = tmp_path / "plugin.log"
        with open(log, "w") as log_f:
            proc = subprocess.Popen(
                _plugin_argv("early-node", endpoint, tmp_path, "early",
                             "--healthcheck-addr", ""),
                stdout=log_f, stderr=subprocess.STDOUT, env=_env(), cwd=REPO)
        try:
            deadline = time.time() + 60
            while ("running on node" not in log.read_text()
                   and proc.poll() is None and time.time() < deadline):
                time.sleep(0.001)
            proc.send_signal(15)
            rc = proc.wait(timeout=STOP_TIMEOUT)
        finally:
            _stop(proc)
        assert rc == 0, log.read_text()[-2000:]
        assert "gpu-kubelet-plugin stopped" in log.read_text()
    finally:
        assert _stop(api_proc) == 0


def test_block_until_signaled_installs_handlers_before_the_ready_line(
        monkeypatch):
    """The order the test above depends on, checked in process: the
    SIGTERM and SIGINT handlers are in place when ``ready`` is logged."""
    import signal

    seen = {}

    def ready(msg, *args):
        if "line" in seen:      # handle.stop() logs "unit stopped"
            return
        seen["handlers"] = (signal.getsignal(signal.SIGTERM),
                            signal.getsignal(signal.SIGINT))
        seen["line"] = msg % args
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    old = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    stopped = []
    handle = ProcessHandle("unit")
    handle.on_stop(lambda: stopped.append(True))
    monkeypatch.setattr(process.logger, "info", ready)
    try:
        process.block_until_signaled(handle, "unit running")
    finally:
        signal.signal(signal.SIGTERM, old[0])
        signal.signal(signal.SIGINT, old[1])
    assert seen["line"] == "unit running" and stopped == [True]
    assert all(callable(h) and h not in old for h in seen["handlers"])


def test_logging_contract(tmp_path):
    """A plugin process at verbosity 1 logs its startup config and DEBUG
    lines of the claim path; at verbosity 0 no DEBUG line."""
    api_proc, endpoint = _spawn_api_server()
    logs, rcs = {}, {}
    try:
        client = HttpClient(endpoint)
        client.create(new_object(
            "DeviceClass", "gpu.nvidia.com",
            spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        for verbosity in (1, 0):
            node = f"log-node-{verbosity}"
            log_path = tmp_path / f"plugin-v{verbosity}.log"
            with open(log_path, "w") as log_f:
                proc = subprocess.Popen(
                    _plugin_argv(node, endpoint, tmp_path,
                                 f"log{verbosity}", "--healthcheck-addr", "",
                                 "-v", str(verbosity)),
                    stdout=log_f, stderr=subprocess.STDOUT, env=_env(),
                    cwd=REPO)
            try:
                name = f"log-claim-{verbosity}"
                assert _wait(lambda: [
                    s for s in client.list("ResourceSlice")
                    if s["spec"].get("nodeName") == node])
                claim = client.create(new_object(
                    "ResourceClaim", name, "default",
                    api_version="resource.k8s.io/v1",
                    spec={"devices": {"requests": [{
                        "name": "gpu", "exactly": {
                            "deviceClassName": "gpu.nvidia.com",
                            "allocationMode": "ExactCount", "count": 1}}]}}))
                Allocator(client).allocate(
                    claim, reserved_for=[{"resource": "pods", "name": "p"}],
                    node=node)
                assert _wait(lambda: (client.get(
                    "ResourceClaim", name, "default").get("status")
                    or {}).get("devices")), "claim never prepared"
                assert _wait(lambda: "running on node" in
                             log_path.read_text())
            finally:
                rcs[verbosity] = _stop(proc)
            logs[verbosity] = log_path.read_text()
    finally:
        rcs["api"] = _stop(api_proc)
    assert rcs == {1: 0, 0: 0, "api": 0}
    assert "starting with configuration:" in logs[1]
    assert "node_name='log-node-1'" in logs[1]
    assert " DEBUG " in logs[1]
    assert "ResourceSlices" in logs[1]
    assert "gpu-kubelet-plugin " in logs[1]      # the component prefix
    assert "starting with configuration:" in logs[0]
    assert " DEBUG " not in logs[0]


def test_the_smokes_processes_phase_on_a_mock_node(tmp_path, monkeypatch,
                                                   capsys):
    """``chip_smoke.phase_processes`` as the card runs it, on the
    ``h100-8`` mock with a small CPU engine: every process exits 0 on
    SIGTERM, nothing is left, and the smoke has no child afterwards."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    gpu = MockDeviceLib("h100-8").enumerate_gpus()[0]
    out = chip_smoke.phase_processes(
        "mock", 0, gpu, device_args=("--mock-profile", "h100-8"), width={
            "max_batch": 4, "heads": 2, "head_dim": 8, "kv_cap": 64,
            "prompts": (8, 40), "new_tokens": 4, "device": "cpu",
            "uuids": {gpu.uuid: 0}})
    assert out["launches"] == 0 and out["decode_steps"] > 0  # plain on CPU
    assert 0 < out["plugin_start_ms"] <= out["plugin_ready_ms"]
    assert 0 < out["allocate_ms"] < out["claim_ready_ms"] < out["ttfb_ms"]
    text = capsys.readouterr().out
    assert "residue=[]" in text and "daemon_withdrawn=True" in text
    assert chip_smoke.child_processes() == []
