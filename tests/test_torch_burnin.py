"""The GPU port's burn-in block and entry point held against the JAX package.

The JAX block's weights are carried across through numpy
(``params_from_numpy``) and the same seeded input goes through both
``burnin_step``s, at a small width and at ``entry()``'s width, within the
bf16 tolerance of ``tests/test_compute.py`` (3e-2). Also: the port's own
weights and entry, and the matmul bench's result on the CPU.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.compute import burnin as jax_burnin
from k8s_dra_driver_tpu_torch.compute import burnin
from k8s_dra_driver_tpu_torch.entry import entry

BF16_TOL = 3e-2


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)


def _carry(jax_params):
    return burnin.params_from_numpy(
        {name: np.asarray(w) for name, w in jax_params.items()},
        device="cpu")


@pytest.mark.parametrize("d_model,d_ff,shape", [
    (128, 256, (2, 16, 128)),
    (512, 2048, (8, 128, 512)),     # entry()'s width
])
def test_burnin_step_matches_jax(d_model, d_ff, shape):
    jp = jax_burnin.transformer_block_params(d_model, d_ff)
    jx, tx = _x(shape, d_model)
    ref = np.asarray(jax_burnin.burnin_step(jp, jx).astype(jnp.float32))
    out = burnin.burnin_step(_carry(jp), tx)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == shape
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_rmsnorm_matches_jax():
    jx, tx = _x((4, 8, 64), 1)
    ref = np.asarray(jax_burnin._rmsnorm(jx).astype(jnp.float32))
    out = burnin._rmsnorm(tx)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_params_from_numpy_carries_bf16_exactly():
    jp = jax_burnin.transformer_block_params(64, 128)
    tp = _carry(jp)
    assert sorted(tp) == sorted(jp)
    for name, w in jp.items():
        assert tp[name].dtype == torch.bfloat16
        assert np.array_equal(tp[name].float().numpy(),
                              np.asarray(w, np.float32)), name


def test_params_shape_dtype_and_seed():
    a = burnin.transformer_block_params(64, 128, device="cpu")
    b = burnin.transformer_block_params(
        64, 128, generator=torch.Generator().manual_seed(0), device="cpu")
    c = burnin.transformer_block_params(
        64, 128, generator=torch.Generator().manual_seed(1), device="cpu")
    assert {n: tuple(w.shape) for n, w in a.items()} == {
        "wq": (64, 64), "wk": (64, 64), "wv": (64, 64), "wo": (64, 64),
        "w1": (64, 128), "w2": (128, 64)}
    assert all(w.dtype == torch.bfloat16 for w in a.values())
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wq"], c["wq"])
    # Drawn as N(0, 0.02^2), as the JAX block's weights are.
    assert abs(float(a["w1"].float().std()) - 0.02) < 2e-3


def test_burnin_step_is_deterministic():
    params = burnin.transformer_block_params(64, 128, device="cpu")
    _, x = _x((2, 8, 64), 2)
    out = burnin.burnin_step(params, x)
    assert torch.equal(out, burnin.burnin_step(params, x))
    assert torch.isfinite(out.float()).all()


def test_entry_runs_on_the_cpu():
    fn, (params, x) = entry(device="cpu")
    assert fn is burnin.burnin_step
    assert tuple(x.shape) == (8, 128, 512) and x.dtype == torch.bfloat16
    assert tuple(params["w1"].shape) == (512, 2048)
    out = fn(params, x)
    assert tuple(out.shape) == (8, 128, 512)
    assert out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    _, (params2, x2) = entry(device="cpu")
    assert torch.equal(x, x2) and torch.equal(params["wq"], params2["wq"])


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        burnin.transformer_block_params(64, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        burnin.matmul_flops_bench(dim=64, n_iters=2)


def test_matmul_flops_bench_on_the_cpu():
    out = burnin.matmul_flops_bench(dim=256, n_iters=4, device="cpu")
    assert sorted(out) == ["dim", "iters", "seconds", "tflops"]
    assert out["dim"] == 256.0 and out["iters"] == 4.0
    assert all(math.isfinite(v) and v > 0 for v in out.values())
    assert out["tflops"] == pytest.approx(
        2.0 * 256 ** 3 * 4 / out["seconds"] / 1e12)
