"""The serving dataplane at scale: the port's ``run_serving_scale`` held to
the JAX harness's bars on the CPU, and against the JAX harness itself.

Both run at the JAX serving bench's quick settings (one measured round of
1.0 s arms, 0.5 s autoscale phases; ``bench.py``'s serving section) with
the JAX harness's engines (32 slots over a 64-token cache, device time
modeled at 500 tokens/s a device). The bars are the bench's, unchanged:
``SERVING_SCALING_BAR`` (4 replicas decode at least 2.5x one) and
``SERVING_TTFB_BOUND_S`` (TTFB p99 within 1.5 s); with them no error
session, no residue, the accounting identity, KV isolation under 1e-4, and
both legs (autoscale through faults, sharded controllers) ok."""

from __future__ import annotations

import pytest
import torch

import chip_smoke
from k8s_dra_driver_tpu.internal import stresslab as jax_stresslab
from k8s_dra_driver_tpu_torch.internal.stresslab import run_serving_scale

#: the JAX serving bench's quick settings
QUICK = dict(measure_rounds=1, arm_window_s=1.0, autoscale_phase_s=0.5)
#: the JAX bench's bars (``bench.py``: SERVING_SCALING_BAR,
#: SERVING_TTFB_BOUND_S)
SCALING_BAR, TTFB_BOUND_S = 2.5, 1.5


@pytest.fixture(scope="module")
def port_scale():
    return run_serving_scale(device="cpu", **QUICK)


@pytest.fixture(scope="module")
def jax_scale():
    return jax_stresslab.run_serving_scale(**QUICK)


def _oracle(r: dict) -> list:
    """What fails the harness's oracle (empty when it holds)."""
    checks = {
        "scaling": r["scaling_x"] >= SCALING_BAR,
        "ttfb": (r["ttfb"]["ok"] and r["ttfb"]["count"] > 0
                 and r["ttfb"]["p99_s"] <= TTFB_BOUND_S),
        "errors": r["error_count"] == 0 and r["error_sessions"] == 0,
        "leaks": r["leak_count"] == 0,
        "accounting": (r["accounting"]["ok"]
                       and r["accounting"]["submitted"] > 0),
        "kv_isolation": r["kv_isolation_max_err"] < 1e-4,
        "autoscale": r["autoscale"]["ok"],
        "shard": r["shard"]["ok"],
    }
    return [k for k, ok in checks.items() if not ok]


def test_the_port_meets_the_jax_bars_on_the_cpu(port_scale):
    assert _oracle(port_scale) == [], port_scale
    assert port_scale["ok_sessions"] == port_scale["sessions"] > 0
    assert port_scale["tokens"]["decode_steps"] > 0
    assert port_scale["tokens"]["warmup_launches"] == 0   # plain on CPU


def test_the_autoscale_leg_serves_through_both_faults(port_scale):
    auto = port_scale["autoscale"]
    assert auto["phases"] == 4
    assert auto["events"] == ["gpu_vanish", "daemon_restart"]
    assert auto["recovered"] == {"tenant-a": True, "tenant-b": True}
    assert auto["fault_window_errors"] == 0
    assert all(t["ok"] > 0 for t in auto["tenants"].values())


def test_the_shard_leg_pins_the_meter_to_the_leader(port_scale):
    shard = port_scale["shard"]
    assert shard["settled"] and shard["leader_pinned"]
    assert len(shard["leaders"]) == 1
    assert shard["singleton_starts"] == shard["leaders"]
    assert shard["ledger_violations"] == []
    assert shard["churn_ok"] > 0 and shard["churn_errors"] == 0


def test_the_card_is_the_default_and_refused_without_one(monkeypatch):
    """``device=None`` is the card: without one it raises at once, and
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_serving_scale(**QUICK)


#: the JAX harness's keys and the port's: the one renamed key
RENAMED = {"chips_per_claim": "gpus_per_claim"}


def _keys(d, path=""):
    """Every key path of a nested dict, JAX names mapped to the port's;
    the dicts keyed by data (tenants, rounds) count as leaves."""
    out = set()
    for k, v in d.items():
        k = RENAMED.get(k, k)
        out.add(path + k)
        if isinstance(v, dict) and k not in ("tenants", "recovered",
                                             "per_round"):
            out |= _keys(v, path + k + ".")
    return out


class TestAgainstJax:
    def test_jax_meets_the_same_oracle(self, jax_scale):
        assert _oracle(jax_scale) == [], jax_scale

    def test_both_return_the_same_keys(self, port_scale, jax_scale):
        """The port's ``tokens`` adds the decode steps and the warm-up's
        kernel launches (what the smoke holds the kernel's launches to);
        every other key is the JAX harness's."""
        extra = {"tokens.decode_steps", "tokens.warmup_launches"}
        assert _keys(port_scale) - extra == _keys(jax_scale)
        assert extra <= _keys(port_scale)

    def test_counts_that_do_not_depend_on_timing(self, port_scale,
                                                 jax_scale):
        for key in ("rounds", "arm_window_s", "replicas_hi", "leak_count",
                    "error_count", "error_sessions"):
            assert port_scale[key] == jax_scale[key], key
        assert port_scale["gpus_per_claim"] == jax_scale["chips_per_claim"]
        assert ({k: len(v) for k, v in port_scale["per_round"].items()}
                == {k: len(v) for k, v in jax_scale["per_round"].items()})
        pa, ja = port_scale["autoscale"], jax_scale["autoscale"]
        assert pa["phases"] == ja["phases"]
        assert ([e.replace("gpu", "chip") for e in pa["events"]]
                == ja["events"])
        assert pa["recovered"] == ja["recovered"]
        assert pa["fault_window_errors"] == ja["fault_window_errors"] == 0
        ps, js = port_scale["shard"], jax_scale["shard"]
        for key in ("shards", "settled", "leader_pinned",
                    "ledger_violations", "ok"):
            assert ps[key] == js[key], key
        assert len(ps["leaders"]) == len(js["leaders"]) == 1
        assert port_scale["accounting"]["ok"] == jax_scale["accounting"]["ok"]


def test_the_smokes_scale_phase_on_the_cpu(capsys):
    """``chip_smoke.phase_scale`` as the card runs it, with small CPU
    engines (2 heads of 8, a 64-token cache) at the quick settings: every
    hard check holds, and the CPU engines launch no kernel."""
    out = chip_smoke.phase_scale(
        "mock", device="cpu",
        engine={"heads": 2, "head_dim": 8, "kv_cap": 64}, **QUICK)
    assert out["launches"] == 0 and out["decode_steps"] > 0
    text = capsys.readouterr().out
    for key in ("tokens_s_lo=", "tokens_s_hi=", "scaling_x=",
                "ttfb_p99_ms=", "recovered=", "leader_pinned=True",
                "leak_count=0", "kernel_launches=0", "wall_s="):
        assert key in text, key
