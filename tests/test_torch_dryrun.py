"""The port's multi-device dry run, and the rank machinery under it.

``dryrun_multichip(n, device="cpu")`` runs the JAX dry run's steps 2-6 on
n gloo ranks (at 2 and 4; each step checks itself within 2e-5 and raises
otherwise), with the dp x tp mesh the JAX ``make_mesh`` picks for n
devices. The default device is the card, with no fallback to the CPU.
``_dist.run_ranks`` raises a rank's failure with its traceback, and
terminates ranks that pass their deadline, and a program that ran ranks
leaves no process behind when it exits.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.compute import sharded as jax_sharded
from k8s_dra_driver_tpu_torch.compute import _dist, collectives, ringattention
from k8s_dra_driver_tpu_torch.entry import dryrun_multichip


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
