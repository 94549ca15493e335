"""The port's ring attention held against the JAX package's.

The JAX ring runs on a mesh of N virtual CPU devices (``tests/conftest.py``)
and the port's on N gloo ranks, at N = 2 and 4, on the same numpy inputs:
the cases of ``tests/test_compute.py``'s ``TestRingAttention`` (f32 within
rtol = atol = 2e-5 of the JAX ring and of ``reference_attention``, causal
included; the sequence actually sharded; bf16 inputs within 3e-2). Also the
online-softmax block against the JAX block, in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from k8s_dra_driver_tpu.compute import ringattention as jax_ring
from k8s_dra_driver_tpu_torch.compute import ringattention

F32_TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(key, shape):
    return [np.asarray(a) for a in (jax.random.normal(k, shape, jnp.float32)
                                    for k in jax.random.split(key, 3))]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def run(request):
    n = request.param
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    out = {"n": n}
    for causal, key, shape in ((False, 0, (2, 4, 16 * n, 32)),
                               (True, 3, (2, 2, 16 * n, 32))):
        q, k, v = _qkv(jax.random.PRNGKey(key), shape)
        out[causal] = {
            "jax": np.asarray(jax_ring.make_ring_attention(
                mesh, causal=causal)(q, k, v)),
            "ref": np.asarray(jax_ring.reference_attention(
                q, k, v, causal=causal)),
            "port": ringattention.run_ring_attention(
                q, k, v, n, causal=causal, device="cpu")}
    qb = jax.random.normal(jax.random.PRNGKey(2),
                           (1, 2, 8 * n, 16)).astype(jnp.bfloat16)
    qn = np.asarray(qb, np.float32)          # bf16 values, exactly
    out["bf16"] = {
        "jax": np.asarray(jax_ring.make_ring_attention(mesh)(qb, qb, qb),
                          np.float32),
        "ref": np.asarray(jax_ring.reference_attention(qb, qb, qb),
                          np.float32),
        "port": ringattention.run_ring_attention(qn, qn, qn, n,
                                                 dtype="bfloat16",
                                                 device="cpu")}
    return out


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_jax_ring(run, causal):
    r = run[causal]
    assert not np.isnan(r["port"]["out"]).any()
    np.testing.assert_allclose(r["port"]["out"], r["jax"], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_reference(run, causal):
    r = run[causal]
    np.testing.assert_allclose(r["port"]["out"], r["ref"], rtol=F32_TOL,
                               atol=F32_TOL)


def test_sequence_is_actually_sharded(run):
    n = run["n"]
    blocks = run[False]["port"]["blocks"]
    # Each rank holds exactly its sequence block.
    assert blocks == [(2, 4, 16, 32)] * n


def test_bf16_inputs(run):
    r = run["bf16"]
    assert r["port"]["dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(r["port"]["out"], r["jax"], rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(r["port"]["out"], r["ref"], rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_online_block_matches_jax(masked):
    rng = np.random.default_rng(int(masked))
    q, k, v = (rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
               for _ in range(3))
    acc = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
    m = rng.standard_normal((2, 2, 8)).astype(np.float32)
    l = rng.random((2, 2, 8)).astype(np.float32) + 1.0
    mask = np.tril(np.ones((8, 8), bool)) if masked else None
    want = jax_ring._online_block(
        *(jnp.asarray(a) for a in (q, k, v, acc, m, l)), 0.25,
        mask=None if mask is None else jnp.asarray(mask))
    got = ringattention._online_block(
        *(torch.from_numpy(a) for a in (q, k, v, acc, m, l)), 0.25,
        mask=None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL)


def test_seq_not_divisible_raises():
    q = np.zeros((1, 1, 6, 4), np.float32)
    with pytest.raises(RuntimeError, match="not divisible by sp=4"):
        ringattention.run_ring_attention(q, q, q, 4, device="cpu")
