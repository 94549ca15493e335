"""The port's data-parallel conv net held against the JAX package's.

The JAX step runs on a ``dp`` mesh of N virtual CPU devices
(``tests/conftest.py``) and the port's on N gloo ranks, at N = 2 and 4,
from the same bf16 weights (the JAX ``resnet_params``, HWIO convs carried
to OIHW) and the same batch (the JAX ``make_batch``, NHWC carried to NCHW):
the logits, the loss after one step and every updated weight within the
bf16 tolerance 3e-2, the batch one shard per rank, and five steps that
learn (the cases of ``tests/test_compute.py``'s
``TestDataParallelResnet``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from k8s_dra_driver_tpu.compute import resnet as jax_resnet
from k8s_dra_driver_tpu_torch.compute import resnet

BF16_TOL = 3e-2
STEPS, LR = 5, 5e-2


def _np(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def run(request):
    n = request.param
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    params = jax_resnet.resnet_params(depth=2, channels=8)
    start = _np(params)
    step, make_batch = jax_resnet.data_parallel_resnet_step(mesh, lr=LR)
    images, labels = make_batch(per_chip=2, size=8)
    logits = np.asarray(jax_resnet.resnet_forward(params, images))
    jax_losses, jax_first = [], None
    for _ in range(STEPS):
        params, loss = step(params, images, labels)
        jax_losses.append(float(loss))
        if jax_first is None:
            jax_first = _np(params)
    port = resnet.run_data_parallel_resnet(
        start, np.asarray(images), np.asarray(labels), n, lr=LR,
        steps=STEPS, device="cpu")
    return {"n": n, "logits": logits, "jax_losses": jax_losses,
            "jax_first": jax_first, "port": port}


def test_batch_is_sharded_per_rank(run):
    assert run["port"]["batch_shards"] == [2] * run["n"]


def test_logits_match_jax(run):
    np.testing.assert_allclose(run["port"]["logits"], run["logits"],
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_loss_matches_jax(run):
    np.testing.assert_allclose(run["port"]["losses"][0],
                               run["jax_losses"][0], rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("leaf", ["stem", "blocks", "head"])
def test_updated_params_match_jax(run, leaf):
    got, want = run["port"]["params"][0][leaf], run["jax_first"][leaf]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=BF16_TOL, atol=BF16_TOL)


def test_step_runs_and_learns(run):
    losses = run["port"]["losses"]
    assert all(l == l for l in losses)     # no NaNs
    assert losses[-1] < losses[0], losses  # it learns


def test_forward_shapes():
    params = resnet.resnet_params(depth=2, channels=8, num_classes=10)
    logits = resnet.resnet_forward(params, torch.randn(4, 3, 8, 8))
    assert tuple(logits.shape) == (4, 10)
    assert logits.dtype == torch.float32


def test_params_carry_bf16_both_ways():
    jp = jax_resnet.resnet_params(depth=2, channels=8)
    tp = resnet.resnet_params_from_numpy(_np(jp))
    assert tp["stem"].dtype == torch.bfloat16
    assert tuple(tp["stem"].shape) == (8, 3, 3, 3)           # OIHW
    back = resnet.resnet_params_to_numpy(tp)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(_np(jp))):
        np.testing.assert_array_equal(g, w)


def test_forward_matches_jax_in_one_process():
    jp = jax_resnet.resnet_params(depth=2, channels=8)
    x = np.random.default_rng(0).standard_normal((3, 8, 8, 3)).astype(
        np.float32)
    want = np.asarray(jax_resnet.resnet_forward(jp, jnp.asarray(x)))
    got = resnet.resnet_forward(resnet.resnet_params_from_numpy(_np(jp)),
                                torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_batch_divisibility_enforced():
    with pytest.raises(ValueError, match="divisible"):
        resnet.run_data_parallel_resnet({}, np.zeros((5, 8, 8, 3)),
                                        np.zeros(5), 2, device="cpu")
