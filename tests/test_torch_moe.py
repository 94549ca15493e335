"""The port's expert-parallel MoE held against the JAX package's.

The JAX layer runs on a (dp, ep) mesh of N virtual CPU devices
(``tests/conftest.py``) and the port's on N gloo ranks, at N = 2 and 4 with
ep = 2, from the same weights (the JAX ``moe_params``, carried as numpy)
and the same inputs: the forward within rtol = atol = 2e-5 of the JAX
layer and of its dense reference, the loss after one SGD step within
2e-5, every updated weight within 1e-5, the experts actually sharded, and
five steps that learn (the cases of ``tests/test_compute.py``'s
``TestExpertParallel``). The gates are a top-1 argmax, so the chosen
experts are compared exactly and the smallest top-1 margin of the inputs
is reported.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from k8s_dra_driver_tpu.compute import moe as jax_moe
from k8s_dra_driver_tpu_torch.compute import moe

F32_TOL = 2e-5
PARAM_TOL = 1e-5
EP, N_EXPERTS, D_MODEL, D_FF = 2, 8, 16, 32
STEPS, LR = 5, 0.05


def _inputs():
    p = jax_moe.moe_params(jax.random.PRNGKey(0), n_experts=N_EXPERTS,
                           d_model=D_MODEL, d_ff=D_FF)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 6, D_MODEL))
    y = jax.random.normal(jax.random.PRNGKey(2), (4, 6, D_MODEL))
    return p, x, y


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def run(request):
    n = request.param
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(n // EP, EP),
                ("dp", "ep"))
    p, x, y = _inputs()
    ffn, shard = jax_moe.make_moe_ffn(mesh)
    step, shard2 = jax_moe.make_moe_train_step(mesh, lr=LR)
    sp = shard2(p)
    jax_losses, jax_first = [], None
    for _ in range(STEPS):
        sp, loss = step(sp, x, y)
        jax_losses.append(float(loss))
        if jax_first is None:
            jax_first = {k: np.asarray(v) for k, v in sp.items()}
    port = moe.run_moe({k: np.asarray(v) for k, v in p.items()},
                       np.asarray(x), np.asarray(y), n, EP, lr=LR,
                       steps=STEPS, device="cpu")
    return {"n": n, "jax_out": np.asarray(ffn(shard(p), x)),
            "jax_ref": np.asarray(jax_moe.moe_ffn_reference(p, x)),
            "jax_losses": jax_losses, "jax_first": jax_first, "port": port}


def test_matches_jax_layer(run):
    np.testing.assert_allclose(run["port"]["out"], run["jax_out"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_matches_dense_reference(run):
    np.testing.assert_allclose(run["port"]["out"], run["jax_ref"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_experts_actually_sharded(run):
    # 8 experts over ep=2: each rank holds 4 experts' weights.
    shapes = run["port"]["shard_shapes"]
    assert shapes["w1"] == (N_EXPERTS // EP, D_MODEL, D_FF)
    assert shapes["w2"] == (N_EXPERTS // EP, D_FF, D_MODEL)
    assert shapes["wg"] == (D_MODEL, N_EXPERTS)


def test_loss_matches_jax(run):
    np.testing.assert_allclose(run["port"]["losses"][0],
                               run["jax_losses"][0], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", ["wg", "w1", "w2"])
def test_updated_params_match_jax(run, name):
    np.testing.assert_allclose(run["port"]["params"][0][name],
                               run["jax_first"][name], rtol=PARAM_TOL,
                               atol=PARAM_TOL)


def test_trains(run):
    losses = run["port"]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_chosen_experts_match_jax(record_property):
    p, x, _ = _inputs()
    logits = np.einsum("bsd,de->bse", np.asarray(x, np.float64),
                       np.asarray(p["wg"], np.float64))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    record_property("min_top1_logit_margin", margin)
    want = np.asarray(jax_moe._gates(x, p["wg"]))
    got = moe._gates(torch.from_numpy(np.array(x)),
                     torch.from_numpy(np.array(p["wg"]))).numpy()
    assert np.array_equal(got.argmax(-1), want.argmax(-1)), \
        f"chosen experts differ; smallest top-1 logit margin {margin}"
    assert np.array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_reference_matches_jax():
    p, x, _ = _inputs()
    got = moe.moe_ffn_reference(
        moe.moe_params_from_numpy({k: np.asarray(v) for k, v in p.items()}),
        torch.from_numpy(np.array(x)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_moe.moe_ffn_reference(p, x)),
                               rtol=F32_TOL, atol=F32_TOL)


def test_indivisible_layout_rejected():
    x = np.zeros((3, 6, D_MODEL), np.float32)
    with pytest.raises(ValueError, match="ep=3"):
        moe.run_moe({}, x, x, 4, 3, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        moe.run_moe({}, x, x, 4, 2, device="cpu")
