"""Test settings of the benchmark's CPU tests.

Run from the root of the repository: ``python -m pytest perfbench/tests``.
Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where torch sees no CUDA device; on the card
``python -m pytest perfbench/tests -m card`` runs them.
"""

import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture()
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda", 0)


#: A configuration and traffic small enough for the CPU: the engine's
#: plain decode path, 4 slots of 64 positions, 2 heads of 8.
TINY_ENGINE = {"max_batch": 4, "kv_cap": 64, "tokens_per_chip_step": 64,
               "modeled_chip_tok_s": 1e9, "queue_cap": 64}
TINY_MIXES = {
    "tiny-backlog": {"kind": "backlog", "queued_min": 4, "tenants": 4,
                     "prompt": {"dist": "lognormal", "median": 16,
                                "sigma": 0.8, "min": 4, "max": 40},
                     "output": {"dist": "uniform", "min": 2, "max": 8},
                     "block": 16},
    "tiny-poisson": {"kind": "poisson", "rate_per_s": 100.0, "tenants": 4,
                     "prompt": {"dist": "lognormal", "median": 16,
                                "sigma": 0.8, "min": 4, "max": 40},
                     "output": {"dist": "lognormal", "median": 4,
                                "sigma": 0.7, "min": 2, "max": 16},
                     "block": 16},
}


#: Readers of an open loop's tails, from each request's due time; a
#: request refused or unanswered when the harness stopped waiting counts
#: with the time to that moment.
TINY_READERS = {
    "ttft_p95_ms": """from perfbench.stats import percentile


def read(run):
    return percentile([((s.req.first_token_t if s.req.first_token_t
                         is not None and not s.rejected else run.grace_end)
                        - s.due_t) * 1e3 for s in run.window_sent], 95)
""",
    "tpot_p95_ms": """from perfbench.stats import percentile


def read(run):
    return percentile([
        (s.req.done_t - s.req.first_token_t) / (s.req.generated - 1) * 1e3
        for s in run.sent
        if s.completed and run.t0 <= s.req.done_t < run.t_end
        and s.req.generated > 1], 95)
""",
}


def add_tiny_cells(root: str) -> None:
    """Add, as files and manifest entries only, a tiny configuration and
    two tiny cells (a backlog and an open loop) to the checkout at
    ``root``: the backlog twin reports the real cell's metrics, the open
    loop two tail metrics whose readers are added as files."""
    import json
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "perfbench/configs/ouro-2.6b-attn.json")) as f:
        cfg = json.load(f)
    cfg.update({"num_attention_heads": 2, "num_key_value_heads": 2,
                "head_dim": 8, "engine": dict(TINY_ENGINE)})
    with open(os.path.join(root, "perfbench/configs/tiny.json"), "w") as f:
        json.dump(cfg, f)
    for name, mix in TINY_MIXES.items():
        with open(os.path.join(root, f"perfbench/traffic/{name}.json"),
                  "w") as f:
            json.dump(mix, f)
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for tiny in TINY_MIXES:
        bench["workloads"].append({"name": tiny, "config": "tiny",
                                   "traffic": tiny, "chips": 1,
                                   "why": "a CPU twin of ouro-backlog"})
    # The backlog cell's metrics; the open loop reports setup_s and its
    # tails, and none of the backlog's per-layer metrics.
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ouro-backlog" in m.get("workloads", ()):
            m["workloads"].append("tiny-backlog")
    # The open loop's tails, as a later change would add them: an entry
    # and a reader file each.
    for name, code in TINY_READERS.items():
        bench["end_to_end"].append({
            "name": name, "unit": "ms", "better": "lower", "bound": 0.25,
            "source": "host_clock", "workloads": ["tiny-poisson"]})
        with open(os.path.join(root, f"perfbench/metrics/{name}.py"),
                  "w") as f:
            f.write(code)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture()
def tiny_root(tmp_path):
    """A copy of the benchmark's files with the tiny cells added."""
    root = tmp_path / "checkout"
    (root / "perfbench").mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "perfbench", sub),
                        root / "perfbench" / sub)
    add_tiny_cells(str(root))
    return root


@pytest.fixture()
def mock_gpu():
    """A mock node's device library and the UUID of its first GPU."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    lib = MockDeviceLib("h100-8")
    return lib, lib.enumerate_gpus()[0].uuid
