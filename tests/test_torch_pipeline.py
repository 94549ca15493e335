"""The port's GPipe pipeline held against the JAX package's.

The JAX pipeline runs on a ``pp`` mesh of N virtual CPU devices
(``tests/conftest.py``) and the port's on N gloo ranks, one stage each, at
N = 2 and 4, from the same stage weights (the JAX ``pipeline_params``,
carried as numpy) and microbatches: the forward within rtol = atol = 2e-5
of the JAX pipeline and of the sequential reference, the loss after one
SGD step within 2e-5 and every updated weight within 1e-5 (the backward is
``ppermute``'s transpose), the stages actually sharded, five steps that
learn, and fewer microbatches than stages (the cases of
``tests/test_compute.py``'s ``TestPipelineParallel``). A stage count other
than ``pp`` fails in the ranks and raises here.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from k8s_dra_driver_tpu.compute import pipeline as jax_pipeline
from k8s_dra_driver_tpu_torch.compute import pipeline

F32_TOL = 2e-5
PARAM_TOL = 1e-5
D_MODEL, N_MICRO = 8, 6
STEPS, LR = 5, 0.05


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"n{n}")
def run(request):
    n = request.param
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))
    p = jax_pipeline.pipeline_params(jax.random.PRNGKey(3), n_stages=n,
                                     d_model=D_MODEL)
    xs = jax.random.normal(jax.random.PRNGKey(4), (N_MICRO, 3, D_MODEL))
    ys = jax.random.normal(jax.random.PRNGKey(5), (N_MICRO, 3, D_MODEL))
    fwd, shard = jax_pipeline.make_pipeline_fn(mesh, n_micro=N_MICRO)
    step, shard2 = jax_pipeline.make_pipeline_train_step(
        mesh, n_micro=N_MICRO, lr=LR)
    sp = shard2(p)
    jax_losses, jax_first = [], None
    for _ in range(STEPS):
        sp, loss = step(sp, xs, ys)
        jax_losses.append(float(loss))
        if jax_first is None:
            jax_first = _np(sp)
    port = pipeline.run_pipeline(_np(p), np.asarray(xs), n,
                                 ys=np.asarray(ys), lr=LR, steps=STEPS,
                                 device="cpu")
    return {"n": n, "jax_out": np.asarray(fwd(shard(p), xs)),
            "jax_ref": np.asarray(jax_pipeline.pipeline_reference(p, xs)),
            "jax_losses": jax_losses, "jax_first": jax_first, "port": port}


def test_matches_jax_pipeline(run):
    np.testing.assert_allclose(run["port"]["out"], run["jax_out"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_matches_sequential_reference(run):
    np.testing.assert_allclose(run["port"]["out"], run["jax_ref"],
                               rtol=F32_TOL, atol=F32_TOL)


def test_every_rank_holds_the_output(run):
    assert run["port"]["outs_equal"]


def test_stages_actually_sharded(run):
    # Each rank holds ONE stage's weights.
    assert run["port"]["shard_shapes"] == {"w1": (1, D_MODEL, D_MODEL),
                                           "w2": (1, D_MODEL, D_MODEL)}


def test_loss_matches_jax(run):
    np.testing.assert_allclose(run["port"]["losses"][0],
                               run["jax_losses"][0], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("name", ["w1", "w2"])
def test_updated_params_match_jax(run, name):
    np.testing.assert_allclose(run["port"]["params"][0][name],
                               run["jax_first"][name], rtol=PARAM_TOL,
                               atol=PARAM_TOL)


def test_trains_through_the_pipeline(run):
    losses = run["port"]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("n,n_micro", [(2, 1), (4, 2)])
def test_fewer_microbatches_than_stages(n, n_micro):
    """The schedule stays correct (if bubble-heavy) when n_micro < pp."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("pp",))
    p = jax_pipeline.pipeline_params(jax.random.PRNGKey(0), n_stages=n,
                                     d_model=D_MODEL)
    xs = jax.random.normal(jax.random.PRNGKey(1), (n_micro, 3, D_MODEL))
    fwd, shard = jax_pipeline.make_pipeline_fn(mesh, n_micro=n_micro)
    port = pipeline.run_pipeline(_np(p), np.asarray(xs), n, device="cpu")
    np.testing.assert_allclose(port["out"], np.asarray(fwd(shard(p), xs)),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(
        port["out"], np.asarray(jax_pipeline.pipeline_reference(p, xs)),
        rtol=F32_TOL, atol=F32_TOL)


def test_reference_matches_jax():
    p = jax_pipeline.pipeline_params(jax.random.PRNGKey(6), n_stages=3,
                                     d_model=D_MODEL)
    xs = jax.random.normal(jax.random.PRNGKey(7), (2, 3, D_MODEL))
    got = pipeline.pipeline_reference(
        pipeline.pipeline_params_from_numpy(_np(p)),
        torch.from_numpy(np.array(xs)))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_pipeline.pipeline_reference(p, xs)),
        rtol=F32_TOL, atol=F32_TOL)


def test_stage_count_must_equal_pp():
    p = jax_pipeline.pipeline_params(jax.random.PRNGKey(0), n_stages=3,
                                     d_model=D_MODEL)
    xs = np.zeros((2, 3, D_MODEL), np.float32)
    with pytest.raises(RuntimeError, match="3 stages for pp=2"):
        pipeline.run_pipeline(_np(p), xs, 2, device="cpu")
