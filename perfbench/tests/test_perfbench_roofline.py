"""Bytes, operations, least time, the trace reduction and the statistics,
on hand-worked shapes; and each cell's slab sizes."""

import json
import os
import statistics

import pytest

from perfbench import roofline, stats
from perfbench.roofline import Call, DeviceOp

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


def test_decode_bytes_and_flops_by_hand():
    # Two slots of lengths 1 and 3, 2 heads, one query row, d = dv = 4,
    # f32: K and V rows 4 keys * 2 heads * (16 + 16) B = 256; q and out
    # 2 slots * 2 heads * (4 + 4) * 4 B = 128; lengths 8.
    assert roofline.decode_bytes([1, 3], 2, 1, 4, 4, 4, 4, 4) == 392
    # 2 * h * ql * keys * (d + dv) = 2 * 2 * 1 * 4 * 8.
    assert roofline.decode_flops([1, 3], 2, 1, 4, 4) == 128


def test_least_time_takes_the_longer_bound():
    assert roofline.least_seconds(3.35e12, 1.0, H100, "float32") == \
        pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 67e12, H100, "float32") == \
        pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 989.4e12, H100, "bfloat16") == \
        pytest.approx(1.0)
    assert roofline.peaks("a CPU") is None


def test_a_serve_step_is_bound_by_bytes():
    # One ouro-backlog step: 64 slots at 5,440 tokens, 16 heads of 128.
    lens = [5440] * 64
    nbytes = roofline.decode_bytes(lens, 16, 1, 128, 128, 4, 4, 4)
    flops = roofline.decode_flops(lens, 16, 1, 128, 128)
    assert nbytes == pytest.approx(64 * 5440 * 16 * 1024, rel=1e-3)
    assert flops / nbytes == pytest.approx(0.5, rel=1e-3)
    assert roofline.least_seconds(nbytes, flops, H100, "float32") == \
        pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("config,slab_bytes", [
    ("ouro-2.6b-attn", 68_719_476_736),
])
def test_each_cells_slabs(config, slab_bytes):
    with open(os.path.join(HERE, "configs", f"{config}.json")) as f:
        c = json.load(f)
    e = c["engine"]
    k_and_v = 2 * e["max_batch"] * c["num_attention_heads"] * e["kv_cap"] \
        * c["head_dim"] * 4
    assert k_and_v == slab_bytes
    assert c["num_attention_heads"] == c.get("num_key_value_heads", 16) == 16


def test_union_of_intervals():
    assert roofline.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert roofline.union_us([]) == 0


def test_summary_of_a_trace():
    ops = [DeviceOp("Memcpy HtoD", 0, 10),
           DeviceOp("void decode_ring_kernel<float, 1, 32, 1>(x)", 15, 75),
           DeviceOp("Memcpy DtoH", 80, 85),
           DeviceOp("Memcpy HtoD", 100, 110),
           DeviceOp("void decode_ring_kernel<float, 1, 32, 1>(x)", 115, 175),
           DeviceOp("Memcpy DtoH", 180, 185),
           DeviceOp("void decode_ring_kernel<float, 1, 32, 1>(x)", 195, 260)]
    calls = [Call(12, 30e-6), Call(112, 40e-6), Call(190, 50e-6)]
    s = roofline.summarize(ops, calls, 5, 200)
    assert s.window_us == 195
    # Busy inside [5, 200]: 5 + 60 + 5 + 10 + 60 + 5 + 5.
    assert s.busy_us == 150
    # The third call's kernel runs past the window: left out.
    assert s.attn_calls == 2
    assert s.attn_us == 120 and s.attn_least_s == pytest.approx(70e-6)
    names = dict(s.device_ops)
    assert names["decode_ring_kernel<float, 1, 32, 1>"] == \
        pytest.approx(125e-6)
    gaps = dict(s.idle_gaps)
    assert gaps["Memcpy DtoH -> Memcpy HtoD"] == pytest.approx(15e-6)
    assert gaps["Memcpy HtoD -> decode_ring_kernel<float, 1, 32, 1>"] == \
        pytest.approx(10e-6)


def test_percentile_interpolates_like_numpy():
    import numpy as np
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6]
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([], 95) is None
    assert stats.percentile([1.0, float("inf")], 95) == float("inf")


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.5, 9.8, 10.2, 10.1, 9.9]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)
    assert stats.spread([1.0]) is None
