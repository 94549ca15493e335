"""The port's multi-device dry run, and the rank machinery under it.

``dryrun_multichip(n, device="cpu")`` runs step 1, the control plane (the
GPU plugin's all-GPU claims and the ComputeDomain flow with its four
phases) on two mock nodes, then the JAX dry run's steps 2-6 on n gloo
ranks (at 2 and 4; each step checks itself within 2e-5 and raises
otherwise), with the dp x tp mesh the JAX ``make_mesh`` picks for n
devices. Step 1 also runs on its own at 2 and 4 nodes of both mock
layouts, beside the JAX package's step 1. The default device is the card, with no fallback to the
CPU. ``_dist.run_ranks`` raises a rank's failure with its traceback,
terminates ranks that pass their deadline, starts ranks from a prepared
channel claim's rendezvous env (one node of two ranks, or two nodes of one
rank each), fails loudly on a taken port, and a program that ran ranks
leaves no process behind when it exits.
"""

import os
import socket
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from k8s_dra_driver_tpu.compute import sharded as jax_sharded
from k8s_dra_driver_tpu_torch.api.computedomain import new_compute_domain
from k8s_dra_driver_tpu_torch.api.configs import API_VERSION
from k8s_dra_driver_tpu_torch.cdi.spec import claim_spec_env
from k8s_dra_driver_tpu_torch.compute import _dist, collectives, ringattention
from k8s_dra_driver_tpu_torch.entry import (
    CHANNEL_CLASS,
    dryrun_multichip,
    expected_node_ranks,
    mock_cd_flow,
    mock_cluster_rendezvous,
)
from k8s_dra_driver_tpu_torch.gpulib import MockDeviceLib
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
    ComputeDomainDaemon,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    CD_DRIVER_NAME,
    CdDriver,
    CdDriverConfig,
)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def run(request):
    n = request.param
    return n, dryrun_multichip(n, device="cpu")


def test_dryrun_runs_on_gloo_ranks(run):
    n, r = run
    assert r["world"] == n and r["backend"] == "gloo" and r["device"] == "cpu"


def test_dryrun_mesh_matches_jax(run):
    n, r = run
    assert r["mesh"] == dict(jax_sharded.make_mesh(jax.devices()[:n]).shape)


def test_dryrun_checks(run):
    n, r = run
    assert r["loss"] > 0
    assert r["allreduce"] == sum(range(n))
    for k in ("ring_max_abs_err", "moe_max_abs_err", "pipeline_max_abs_err"):
        # The rank raised had any element passed 2e-5 + 2e-5 |ref|.
        assert 0.0 <= r[k] < float("inf"), (k, r[k])
    assert r["moe"]["dp"] * r["moe"]["ep"] == n
    assert r["moe"]["loss"] == r["moe"]["loss"]
    assert r["pipeline_loss"] == r["pipeline_loss"]


def test_dryrun_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def test_cuda_ranks_never_fall_back_to_the_cpu():
    want = RuntimeError if not torch.cuda.is_available() else ValueError
    with pytest.raises(want):
        _dist.run_ranks(collectives._rank_psum,
                        torch.cuda.device_count() + 1, 4, 1)


def test_rank_failure_raises_with_its_traceback():
    q = np.zeros((1, 1, 3, 4), np.float32)
    with pytest.raises(RuntimeError, match="(?s)failed on rank.*Traceback"
                       ".*not divisible by sp=2"):
        _dist.run_ranks(ringattention._rank_ring, 2, q, q, q, False,
                        "float32", device="cpu")


def test_deadline_terminates_ranks():
    # 500 all-reduces of 16 MiB take seconds; the deadline is one.
    with pytest.raises(TimeoutError, match="deadline"):
        _dist.run_ranks(collectives._rank_psum, 2, 1 << 22, 500,
                        device="cpu", timeout=1.0)


def test_a_program_that_ran_ranks_leaves_no_process():
    # The fork server outlives an unstopped program while it unloads torch;
    # the port stops it (and the resource tracker) when the program exits.
    code = (
        "import multiprocessing.forkserver as fs, multiprocessing."
        "resource_tracker as rt\n"
        "from k8s_dra_driver_tpu_torch.compute import _dist, collectives\n"
        "_dist.run_ranks(collectives._rank_psum, 2, 4, 1, device='cpu')\n"
        "print(fs._forkserver._forkserver_pid, rt._resource_tracker._pid)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    pids = [int(p) for p in out.stdout.split() if p != "None"]
    assert pids, out.stdout
    assert [p for p in pids if os.path.exists(f"/proc/{p}")] == []


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),          # overlapping streams
    ([(5.0, 6.0), (0.0, 1.0), (0.5, 0.75)], 2.0),
])
def test_busy_time_is_the_union_of_spans(spans, want):
    assert _dist._union(spans) == want


@pytest.mark.parametrize("hosts", [2, 4])
@pytest.mark.parametrize("profile", ["h100-8", "dgx-h100-256"])
def test_step1_on_mock_nodes(profile, hosts):
    env = mock_cluster_rendezvous(hosts, profile)
    for h in range(hosts):
        assert env[h]["CUDA_VISIBLE_DEVICES"].split(",") == [
            g.uuid for g in MockDeviceLib(profile, host_index=h)
            .enumerate_gpus()]
    chan = mock_cd_flow(hosts, profile)
    ranks = expected_node_ranks(hosts, profile)
    assert [int(chan[h]["NODE_RANK"]) for h in range(hosts)] == ranks
    assert {chan[h]["MASTER_ADDR"] for h in range(hosts)} == {
        f"host{ranks.index(0)}"}
    assert {chan[h]["NNODES"] for h in range(hosts)} == {str(hosts)}


def test_jax_step1_passes_beside_the_ports():
    # The reference's own step 1 on its two v5e-16 hosts, for the record
    # that both flows hold the same four phases.
    assert len(jax_entry._mock_cluster_rendezvous(2, "v5e-16")) == 2
    jax_entry._mock_cd_flow(2, "v5e-16")
    assert len(mock_cd_flow(2, "dgx-h100-256")) == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def channel_envs(tmp, nodes: int, port: int) -> list[dict]:
    """A ComputeDomain of ``nodes`` mock nodes whose daemons report
    127.0.0.1, and each node's prepared channel claim's env."""
    client = FakeClient()
    for h in range(nodes):
        client.create(new_object("Node", f"host{h}"))
    client.create(new_object("DeviceClass", CHANNEL_CLASS, spec={
        "selectors": [{"cel": {"expression":
                               "device.attributes['type'] == 'channel'"}}]}))
    cd = client.create(new_compute_domain("cd", num_nodes=nodes))
    uid = cd["metadata"]["uid"]
    envs = []
    for h in range(nodes):
        lib = MockDeviceLib("dgx-h100-256", host_index=h)
        driver = CdDriver(client, CdDriverConfig(
            node_name=f"host{h}", state_dir=f"{tmp}/s{h}",
            cdi_root=f"{tmp}/c{h}", env={}, retry_timeout=2.0,
            master_port=port), device_lib=lib).start()
        ComputeDomainDaemon(client=client, device_lib=lib, cd_uid=uid,
                            cd_name="cd", node_name=f"host{h}",
                            ip_address="127.0.0.1").sync_once()
        drivers_claim = Allocator(client).allocate(client.create(new_object(
            "ResourceClaim", f"chan{h}", "default",
            api_version="resource.k8s.io/v1", spec={"devices": {
                "requests": [{"name": "channel", "exactly": {
                    "deviceClassName": CHANNEL_CLASS, "count": 1,
                    "selectors": [{"cel": {"expression":
                        f"device.attributes['hostIndex'] == {h}"}}]}}],
                "config": [{"requests": ["channel"], "opaque": {
                    "driver": CD_DRIVER_NAME, "parameters": {
                        "apiVersion": API_VERSION,
                        "kind": "ComputeDomainChannelConfig",
                        "domainID": uid}}}]}})))
        envs.append((driver, drivers_claim))
    out = []
    for driver, claim in envs:
        claim_uid = claim["metadata"]["uid"]
        res = driver.prepare_resource_claims([claim])[claim_uid]
        assert res.error is None, res.error
        out.append(claim_spec_env(driver.cdi.read_claim_spec(claim_uid)))
    return out


def test_dryrun_ranks_start_from_a_channel_claim():
    # One node, two local ranks: world NNODES * 2 at tcp://127.0.0.1:port.
    with tempfile.TemporaryDirectory() as tmp:
        (env,) = channel_envs(tmp, 1, _free_port())
    assert (env["MASTER_ADDR"], env["NNODES"], env["NODE_RANK"]) == (
        "127.0.0.1", "1", "0")
    r = dryrun_multichip(2, device="cpu", rendezvous=env)
    assert r["world"] == 2 and r["allreduce"] == 1.0


def test_two_nodes_of_one_rank_meet_at_the_claims_rendezvous():
    # Each node starts its own share (NODE_RANK * 1 + 0) of a world of 2;
    # the all-reduce checks that the two ranks are 0 and 1.
    with tempfile.TemporaryDirectory() as tmp:
        envs = channel_envs(tmp, 2, _free_port())
    assert [e["NODE_RANK"] for e in envs] == ["0", "1"]
    results, errors = {}, []

    def node(h):
        try:
            results[h] = _dist.run_ranks(
                collectives._rank_psum, 1, 4, 1, device="cpu",
                timeout=60.0, rendezvous=envs[h])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=node, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not errors, errors
    assert sorted(results) == [0, 1]
    assert all(r[0]["device"] == "cpu" for r in results.values())


def test_a_taken_port_fails_loudly():
    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        port = held.getsockname()[1]
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "NNODES": "1", "NODE_RANK": "0"}
        with pytest.raises(RuntimeError, match="failed on rank 0 of 1"):
            _dist.run_ranks(collectives._rank_psum, 1, 4, 1, device="cpu",
                            timeout=30.0, rendezvous=env)


@pytest.mark.parametrize("env,match", [
    ({"MASTER_ADDR": "h", "MASTER_PORT": "1", "NNODES": "2"}, "lacks"),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "x", "NNODES": "2",
      "NODE_RANK": "0"}, "not numeric"),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "70000", "NNODES": "2",
      "NODE_RANK": "0"}, "out of range"),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "29500", "NNODES": "2",
      "NODE_RANK": "2"}, "out of range"),
])
def test_malformed_rendezvous_env_raises(env, match):
    with pytest.raises(ValueError, match=match):
        _dist.rendezvous_from_env(env, 2)


def test_rendezvous_places_a_nodes_ranks():
    env = {"MASTER_ADDR": "10.1.2.3", "MASTER_PORT": "29500",
           "NNODES": "4", "NODE_RANK": "2"}
    assert _dist.rendezvous_from_env(env, 8) == (
        "tcp://10.1.2.3:29500", 16, 32)
