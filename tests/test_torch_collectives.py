"""The port's all-reduce bench and NVSwitch model, beside the JAX package's.

The cases of ``tests/test_compute.py``'s ``TestCollectives``: the wire-byte
formula (equal to the JAX function's), the measured bench over N gloo
ranks at N = 2 and 4 (it verifies its own sum, as the JAX bench on N
virtual devices does) and its refusal of one device, the line rate of an
H100 NVSwitch node (18 links x 25 GB/s one way), the ring model reaching
90% of it at 256 MiB and not at 4 KiB, labelled as modeled, its
sensitivity sweep, and the model fit (equal to the JAX fit on the same
rows).
"""

import json

import jax
import numpy as np
import pytest

from k8s_dra_driver_tpu.compute import collectives as jax_coll
from k8s_dra_driver_tpu_torch.compute import collectives
from k8s_dra_driver_tpu_torch.gpulib.chip import GpuType
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib

H100 = GpuType.H100_SXM_80GB.spec


def test_wire_bytes_formula_matches_jax():
    # Classic 2S(d-1)/d: 8 devices, 1 MiB shards -> 1.75 MiB per device.
    assert collectives.allreduce_wire_bytes(1 << 20, 8) == \
        2 * (1 << 20) * 7 / 8
    assert collectives.allreduce_wire_bytes(1 << 20, 1) == 0.0
    for s, d in ((4096, 2), (1 << 20, 3), (1 << 28, 8)):
        assert collectives.allreduce_wire_bytes(s, d) == \
            jax_coll.allreduce_wire_bytes(s, d)


@pytest.mark.parametrize("n", [2, 4])
def test_psum_bench_measures_and_verifies(n):
    out = collectives.psum_bench(shard_elems=1 << 14, reps=2, n_devices=n,
                                 device="cpu")
    want = jax_coll.psum_bench(shard_elems=1 << 14, reps=2,
                               devices=jax.devices()[:n])
    assert out["kind"] == "measured" and out["platform"] == "cpu"
    assert out["n_devices"] == want["n_devices"] == n
    assert out["bus_gbps"] > 0 and out["seconds"] > 0
    assert out["wire_bytes_per_device"] == want["wire_bytes_per_device"] \
        == 2 * (1 << 16) * (n - 1) / n


def test_psum_bench_rejects_single_device():
    with pytest.raises(ValueError, match=">=2 devices"):
        collectives.psum_bench(n_devices=1, device="cpu")
    with pytest.raises(ValueError, match=">=2 devices"):
        collectives.psum_bench(device="cpu")


def test_line_rate_h100_node():
    rate = collectives.nvlink_line_rate(H100, 8)
    assert rate["nvlink_links"] == 18 and rate["per_link_gbps"] == 25.0
    # 18 links x 25 GB/s one way = 450 GB/s, half the 900 GB/s both ways.
    assert rate["per_gpu_egress_gbps"] == 450.0
    assert rate["bisection_gbps"] == 4 * 450.0
    assert rate["num_gpus"] == 8 and rate["fabric"] == "nvswitch"


def test_modeled_allreduce_hits_target_at_large_message():
    info = MockDeviceLib("h100-8").node_info()
    model = collectives.modeled_allreduce(256 << 20, info.gpu_type.spec,
                                          info.num_gpus)
    assert model["kind"] == "modeled"
    assert model["pct_of_line_rate"] >= 0.90
    # Small messages are latency-bound and must NOT hit the target: the
    # model has to depend on message size.
    small = collectives.modeled_allreduce(4 << 10, H100, 8)
    assert small["pct_of_line_rate"] < 0.90
    # t = 2 (d - 1) hop + wire / egress, by hand.
    wire = 2 * (256 << 20) * 7 / 8
    assert model["modeled_seconds"] == pytest.approx(14e-6 + wire / 450e9)


def test_sensitivity_sweep_shape_and_monotonicity():
    rows = collectives.sensitivity_sweep()
    assert len(rows) == 1 * 4 * 4  # profiles x hops x shards
    assert all(r["kind"] == "modeled" for r in rows)
    assert all(0.0 < r["pct_of_line_rate"] <= 1.0 for r in rows)
    by_key = {(r["profile"], r["hop_latency_us"], r["shard_mib"]): r
              for r in rows}
    assert (by_key[("h100-8", 1.0, 1024.0)]["pct_of_line_rate"]
            > by_key[("h100-8", 1.0, 1.0)]["pct_of_line_rate"])
    assert (by_key[("h100-8", 0.5, 16.0)]["pct_of_line_rate"]
            > by_key[("h100-8", 5.0, 16.0)]["pct_of_line_rate"])


def _model_rows(hop, bw, shard):
    rows = []
    for n in range(2, 9):
        wire = collectives.allreduce_wire_bytes(shard, n)
        rows.append({"n_devices": n, "wire_bytes_per_device": wire,
                     "seconds": 2 * (n - 1) * hop + wire / bw})
    return rows


def test_model_fit_recovers_exact_parameters():
    fit = collectives.fit_model_to_measurements(
        _model_rows(2e-6, 50e9, 64 << 20))
    assert abs(fit["hop_latency_eff_us"] - 2.0) < 1e-6
    assert abs(fit["bus_bandwidth_eff_gbps"] - 50.0) < 1e-6
    assert fit["max_rel_residual"] < 1e-9


def test_model_fit_latency_dominated_degrades_gracefully():
    rows = [{"n_devices": n,
             "wire_bytes_per_device": collectives.allreduce_wire_bytes(
                 1 << 10, n),
             "seconds": 2 * (n - 1) * 1e-3 - n * 1e-7}
            for n in range(2, 9)]
    fit = collectives.fit_model_to_measurements(rows)
    assert fit["latency_dominated"] is True
    assert fit["bus_bandwidth_eff_gbps"] is None
    assert fit["hop_latency_eff_us"] > 0


@pytest.mark.parametrize("hop,bw", [(2e-6, 50e9), (1e-3, 1e15)])
def test_model_fit_matches_jax(hop, bw):
    rows = _model_rows(hop, bw, 1 << 12)
    rows[3]["seconds"] *= 1.01
    got = collectives.fit_model_to_measurements(rows)
    want = jax_coll.fit_model_to_measurements(rows)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], float):
            assert got[k] == pytest.approx(want[k], rel=1e-9), k
        else:
            assert got[k] == want[k], k


def test_main_prints_one_measurement(capsys):
    assert collectives.main(["--device", "cpu", "--n-devices", "2",
                             "--shard-elems", "1024", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["kind"] == "measured" and out["n_devices"] == 2
    assert np.isfinite(out["bus_gbps"])
