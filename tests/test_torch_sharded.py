"""The port's dp x tp training step held against the JAX package's.

The JAX step runs on a mesh of N virtual CPU devices (``tests/conftest.py``)
and the port's on N gloo ranks, at N = 2 and 4, from the same weights
(the JAX ``train_state``, carried as numpy) and the same batch (the JAX
``make_batch``): the loss after one step within rtol = atol = 2e-5 and
every updated parameter within 1e-5, at the JAX learning-step test's
``lr = 0.5``. One spawn per N runs five steps; the cases of
``tests/test_compute.py``'s ``TestShardedStep`` read its result.

Also the collective gradient contract: ``_dist.reduce_from`` (Megatron's
``g``) and ``_dist.copy_to`` (``f``) give the gradients ``jax.grad`` gives
through ``lax.psum`` under ``shard_map``, not the world size times them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from k8s_dra_driver_tpu.compute import sharded as jax_sharded
from k8s_dra_driver_tpu.compute._compat import shard_map
from k8s_dra_driver_tpu_torch.compute import _dist, sharded

F32_TOL = 2e-5
PARAM_TOL = 1e-5
NAMES = ("embed", "w1", "w2", "out")
STEPS, LR = 5, 0.5


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def run(request):
    n = request.param
    mesh = jax_sharded.make_mesh(jax.devices()[:n])
    params = jax_sharded.train_state(mesh)
    start = {k: np.asarray(v) for k, v in params.items()}
    step, make_batch = jax_sharded.sharded_train_step(mesh, lr=LR)
    tokens, targets = make_batch(batch=8, seq=8)
    jax_losses, jax_first = [], None
    for _ in range(STEPS):
        params, loss = step(params, tokens, targets)
        jax_losses.append(float(loss))
        if jax_first is None:
            jax_first = {k: np.asarray(v) for k, v in params.items()}
    port = sharded.run_sharded_train_step(
        start, np.asarray(tokens), np.asarray(targets), n, lr=LR,
        steps=STEPS, device="cpu")
    return {"n": n, "mesh": dict(mesh.shape), "jax_losses": jax_losses,
            "jax_first": jax_first, "port": port}


def test_mesh_matches_jax(run):
    assert run["port"]["mesh"] == run["mesh"]


def test_loss_matches_jax(run):
    np.testing.assert_allclose(run["port"]["losses"][0],
                               run["jax_losses"][0], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_updated_params_match_jax(run, name):
    np.testing.assert_allclose(run["port"]["params"][0][name],
                               run["jax_first"][name], rtol=PARAM_TOL,
                               atol=PARAM_TOL)


def test_train_step_runs_and_learns(run):
    losses = run["port"]["losses"]
    assert len(losses) == STEPS
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]  # memorizing one batch reduces loss


def test_params_actually_sharded(run):
    tp = run["mesh"]["tp"]
    shapes = run["port"]["shard_shapes"]
    # Column-parallel w1, row-parallel w2: each rank holds 1/tp of d_ff.
    assert shapes["w1"] == (256, 1024 // tp)
    assert shapes["w2"] == (1024 // tp, 256)
    assert shapes["embed"] == (512, 256) and shapes["out"] == (256, 512)


def test_dp_replicas_agree(run):
    assert run["port"]["replicas_equal"]


def test_balanced_mesh_shapes_match_jax():
    for n in range(1, 17):
        assert sharded._balanced_2d(n) == jax_sharded._balanced_2d(n)


def test_mesh_shape_rejected():
    tokens = np.zeros((8, 8), np.int64)
    with pytest.raises(ValueError, match="3x2"):
        sharded.run_sharded_train_step({}, tokens, tokens, 4, shape=(3, 2),
                                       device="cpu")


def test_batch_divisibility_enforced():
    tokens = np.zeros((6, 8), np.int64)
    with pytest.raises(ValueError, match="divisible"):
        sharded.run_sharded_train_step({}, tokens, tokens, 4, shape=(4, 1),
                                       device="cpu")


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 5))
    import torch
    got = sharded.softmax_xent(torch.from_numpy(logits),
                               torch.from_numpy(targets))
    want = jax_sharded.softmax_xent(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def transposes(request):
    n = request.param
    rng = np.random.default_rng(n)
    xs = rng.standard_normal((n, 6)).astype(np.float32)
    c = rng.standard_normal(6).astype(np.float32)
    z = rng.standard_normal(6).astype(np.float32)
    ws = rng.standard_normal((n, 6)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:n]), ("i",))

    def g_loss(x):
        y = shard_map(lambda s: jax.lax.psum(2 * s, "i"), mesh=mesh,
                      in_specs=P("i"), out_specs=P())(x)
        return jnp.sum(y * c)

    def f_loss(z):
        out = shard_map(lambda zz, w: zz * w, mesh=mesh,
                        in_specs=(P(), P("i")), out_specs=P("i"))(
            z[None], jnp.asarray(ws))
        return jnp.sum(out)

    return {"n": n, "c": c, "ws": ws,
            "jax_dx": np.asarray(jax.grad(g_loss)(jnp.asarray(xs))),
            "jax_dz": np.asarray(jax.grad(f_loss)(jnp.asarray(z))),
            "port": _dist.transposes(xs, c, z, ws, device="cpu")}


def test_reduce_from_gradient_is_psum_transpose(transposes):
    """psum's transpose takes the cotangent unchanged: d/dx of
    sum(psum(2x) * c) is 2c on every rank, not world x 2c."""
    n, c = transposes["n"], transposes["c"]
    np.testing.assert_allclose(transposes["jax_dx"],
                               np.broadcast_to(2 * c, (n, 6)), rtol=1e-6)
    for r, out in enumerate(transposes["port"]):
        np.testing.assert_allclose(out["dx"], transposes["jax_dx"][r],
                                   rtol=1e-6, atol=1e-6)
        assert not np.allclose(out["dx"], n * transposes["jax_dx"][r])


def test_copy_to_gradient_sums_over_ranks(transposes):
    """A replicated input used by every shard gets the sum of the shards'
    cotangents, on every rank."""
    for out in transposes["port"]:
        np.testing.assert_allclose(out["dz"], transposes["jax_dz"],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(transposes["jax_dz"],
                               transposes["ws"].sum(axis=0), rtol=1e-6,
                               atol=1e-6)
