"""The harness on the CPU at a tiny size: a cell added only as files and
manifest entries is found and run; each fault of the timed path and the
lower-precision control come out not correct. The card-only parts (the
device trace, the kernels) are the card tests' and the chip's."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import check
from perfbench.harness import run_cell
from perfbench.manifest import Bench

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 3_000_000_077


def run(root, cell, mock_gpu, trace=False, **kw):
    lib, uuid = mock_gpu
    return run_cell(Bench(root), cell, SEED, 1.0, trace, time.monotonic(),
                    device_lib=lib, gpu_uuid=uuid, device="cpu",
                    uuids={uuid: 0}, grace_s=10.0, **kw)


@pytest.mark.parametrize("cell", ["tiny-backlog", "tiny-poisson"])
def test_an_added_cell_is_found_and_run(tiny_root, mock_gpu, cell):
    r = run(tiny_root, cell, mock_gpu)
    assert r["correct"], r["checks"]
    e2e = {m["name"] for m in Bench(tiny_root).metrics(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(r["metrics"]) == e2e
    assert r["attempted"] > 0 and r["failed"] <= r["attempted"]
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    assert list(r["checks"]) == list(check.NUMBERS)
    assert r["device"]["count"] == 1


def test_a_traced_run_reports_the_host_side_per_layer_metrics(
        tiny_root, mock_gpu):
    r = run(tiny_root, "tiny-backlog", mock_gpu, trace=True)
    assert r["correct"], r["checks"]
    # The device metrics need the card's trace: none on the CPU.
    assert set(r["metrics"]) == {"claim_ready_ms", "step_ms.backlog"}
    assert "breakdown" not in r


def _step_unchanged(engine):
    engine.step = lambda: 0


def _half_batch(engine):
    inner = engine.attend

    def attend(q, k, v, lens, *a, **kw):
        out = inner(q, k, v, lens, *a, **kw)
        half = out.shape[0] // 2
        out[half:] = out[:half].mean(dim=0, keepdim=True)
        return out
    engine.attend = attend


def _token_altered(engine):
    inner = engine.attend
    done = []

    def attend(q, k, v, lens, *a, **kw):
        out = inner(q, k, v, lens, *a, **kw)
        decoding = (q.abs().amax(dim=(1, 2, 3)) > 0).nonzero().flatten()
        if not done and len(decoding):
            out[int(decoding[0])] += 0.25
            done.append(True)
        return out
    engine.attend = attend


@pytest.mark.parametrize("cell", ["tiny-backlog", "tiny-poisson"])
@pytest.mark.parametrize("fault,fails", [
    (_step_unchanged, "unanswered"),
    (_half_batch, "rows_err"),
    (_token_altered, "rows_err"),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, mock_gpu, cell,
                                            fault, fails):
    r = run(tiny_root, cell, mock_gpu, fault=fault)
    assert not r["correct"]
    c = r["checks"][fails]
    assert not isinstance(c["value"], (int, float)) or \
        c["value"] > c["limit"], r["checks"]


@pytest.mark.parametrize("cell", ["tiny-backlog", "tiny-poisson"])
def test_the_tf32_control_is_not_correct(tiny_root, mock_gpu, cell):
    r = run(tiny_root, cell, mock_gpu, control="tf32")
    assert not r["correct"]
    c = r["checks"]["attn_err"]
    assert c["value"] > c["limit"], r["checks"]
    # Sound runs of the same cell read far under the limit.
    ok = run(tiny_root, cell, mock_gpu)["checks"]["attn_err"]
    assert ok["value"] < c["limit"] / 10


def test_without_a_card_the_command_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "ouro-backlog", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env=env, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_port_the_command_fails(tmp_path):
    # A checkout of only BENCHMARK.json and the benchmark's own files.
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        "ouro-backlog", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_checks_hold_every_number_to_its_limit():
    ok, checks = check.verdict({"unanswered": 0, "unaccounted": 0,
                                "rows_err": 1e-7, "attn_err": 2e-7},
                               {"rows_err": 1e-5, "attn_err": 1e-4})
    assert ok and checks["attn_err"] == {"value": 2e-7, "limit": 1e-4}
    bad, checks = check.verdict({"unanswered": 0, "unaccounted": 0,
                                 "rows_err": float("inf"), "attn_err": 0.0},
                                {"rows_err": 1e-5, "attn_err": 1e-4})
    assert not bad and checks["rows_err"]["value"] == "inf"
    assert not check.verdict({"unanswered": 1, "unaccounted": 0,
                              "rows_err": 0.0, "attn_err": 0.0},
                             {"rows_err": 1e-5, "attn_err": 1e-4})[0]


def test_the_kernel_check_fails_a_wrong_softmax():
    def scaled(q, k, v, lens):
        from perfbench import reference
        return reference.decode_attention(q * 1.01, k, v, lens)
    lens = torch.tensor([5, 64, 1, 33], dtype=torch.int32)
    from perfbench import reference
    ok = check.kernel_error(reference.decode_attention, (4, 2, 64, 8),
                            torch.float32, torch.device("cpu"), lens, 7)
    bad = check.kernel_error(scaled, (4, 2, 64, 8), torch.float32,
                             torch.device("cpu"), lens, 7)
    assert ok == 0.0 and bad > 1e-3


def test_tf32_rounding_by_hand():
    from perfbench.reference import round_tf32
    ulp = 2.0 ** -10             # TF32's 10 bits of mantissa at 1.0
    x = torch.tensor([1 + ulp / 2, 1 + 1.5 * ulp, 1 + 0.75 * ulp,
                      -(1 + 0.25 * ulp), float("inf"), float("nan")])
    before = x.clone()
    y = round_tf32(x)
    # Ties to even, nearest otherwise; infinities and NaNs kept.
    assert y[:5].tolist() == [1.0, 1 + 2 * ulp, 1 + ulp, -1.0,
                              float("inf")]
    assert torch.isnan(y[5])
    assert torch.equal(x[:5], before[:5])     # the input is left alone
