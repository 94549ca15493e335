"""Pipeline parallelism (pp): the GPipe microbatch schedule, on
``torch.distributed``.

The JAX package's ``compute/pipeline.py``: stages sharded over a ``pp``
mesh axis, rank ``i`` holding stage ``i``'s weights only. At schedule step
``t`` every rank runs its stage on the activation it holds (stage 0 on
microbatch ``t``), the last stage banks microbatch ``t - (pp - 1)``, and
the activations move one hop down the ring (``_dist.ppermute_next``).
After ``n_micro + pp - 1`` steps every microbatch has passed every stage
(the last step's output goes nowhere, so it is not sent); one sum over
``pp`` (``_dist.reduce_from``) gives every rank the last stage's outputs.

The backward is ``ppermute``'s transpose: ``ppermute_next`` moves each
cotangent one hop back. Every rank builds the same graph, selecting by
``torch.where`` as the JAX body does (stage 0's feed over the ring's
activation, the last stage's banked outputs over zeros), so that every
rank's backward reaches the ring's exchanges, in the same order.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from k8s_dra_driver_tpu_torch.compute import _dist

_NAMES = ("w1", "w2")


def pipeline_params(n_stages: int, d_model: int,
                    generator: Optional[torch.Generator] = None,
                    device: Union[str, torch.device] = "cpu"
                    ) -> dict[str, torch.Tensor]:
    """Per-stage residual MLP weights ``w1``/``w2`` [n_stages, D, D], f32,
    N(0, 1/D), from ``generator`` (a CPU generator, seed 0 when None),
    stacked on the leading stage axis (the axis sharded over ``pp``)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    scale = d_model ** -0.5
    return {k: (torch.randn((n_stages, d_model, d_model), generator=generator)
                * scale).to(device) for k in _NAMES}


def pipeline_params_from_numpy(params: dict, device: Union[str, torch.device]
                               = "cpu") -> dict[str, torch.Tensor]:
    """The JAX ``pipeline_params``, held as numpy arrays, as f32 tensors."""
    return {k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
            for k in _NAMES}


def _stage(w1: torch.Tensor, w2: torch.Tensor, x: torch.Tensor
           ) -> torch.Tensor:
    """One residual MLP stage: x + relu(x W1) W2."""
    return x + torch.relu(x @ w1) @ w2


def pipeline_reference(params: dict[str, torch.Tensor], x: torch.Tensor
                       ) -> torch.Tensor:
    """Sequential application of every stage: the numerics oracle."""
    for i in range(params["w1"].shape[0]):
        x = _stage(params["w1"][i], params["w2"][i], x)
    return x


def make_pipeline_fn(mesh, n_micro: int, pp_axis: str = "pp"):
    """(fwd, shard_params). ``shard_params(params)`` is this rank's stage,
    [1, D, D] per weight; the stack must hold exactly ``pp`` stages.
    ``fwd(local, xs)`` maps the whole microbatch stack [n_micro, mb, D]
    (the same on every rank) through every stage to [n_micro, mb, D], the
    same on every rank. Any ``n_micro`` >= 1 works; ``n_micro`` >= ``pp``
    keeps the bubble to ``pp - 1`` of ``n_micro + pp - 1`` steps."""
    group = mesh.get_group(pp_axis)
    pp = dist.get_world_size(group)
    stage = dist.get_rank(group)
    dev = _dist.mesh_device(mesh)

    def shard_params(params):
        if params["w1"].shape[0] != pp:
            raise ValueError(f"{params['w1'].shape[0]} stages for pp={pp}: "
                             "each rank holds one stage")
        return {k: params[k][stage:stage + 1].contiguous().to(dev)
                for k in _NAMES}

    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == pp - 1, device=dev)
    steps = n_micro + pp - 1

    def fwd(params, xs):
        w1, w2 = params["w1"][0], params["w2"][0]
        held = torch.zeros_like(xs[0])
        outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
        for t in range(steps):
            # Stage 0 feeds microbatch t (clamped: the steps past the last
            # feed only drain the pipe); the others run what arrived.
            inp = torch.where(first, xs[min(t, n_micro - 1)], held)
            out = _stage(w1, w2, inp)
            done = t - (pp - 1)
            if done >= 0:
                outs[done] = torch.where(last, out, outs[done])
            if t < steps - 1:
                held = _dist.ppermute_next(out, group)
        banked = torch.where(last, torch.stack(outs), 0.0)
        return _dist.reduce_from(banked, group)

    return fwd, shard_params


def make_pipeline_train_step(mesh, n_micro: int, lr: float = 1e-2,
                             pp_axis: str = "pp"):
    """(step, shard_params): one SGD step through the pipeline against MSE
    to targets. ``step(local, xs, ys)`` returns this rank's updated stage
    and the loss, the same on every rank."""
    fwd, shard_params = make_pipeline_fn(mesh, n_micro, pp_axis)

    def step(params, xs, ys):
        live = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = torch.mean((fwd(live, xs) - ys) ** 2)
        grads = torch.autograd.grad(loss, list(live.values()))
        with torch.no_grad():
            new = {k: p - lr * g for (k, p), g in zip(params.items(), grads)}
        return new, loss.detach()

    return step, shard_params


def _rank_pipeline(rank: int, world: int, device: torch.device, params: dict,
                   xs, ys, n_micro: int, lr: float, steps: int
                   ) -> dict[str, Any]:
    mesh = _dist.make_device_mesh((world,), ("pp",))
    xt = torch.from_numpy(np.array(xs, np.float32)).to(device)
    fwd, shard_params = make_pipeline_fn(mesh, n_micro)
    local = shard_params(pipeline_params_from_numpy(params))
    out = {"out": _dist.to_numpy(fwd(local, xt)),
           "shard_shapes": {k: tuple(v.shape) for k, v in local.items()},
           "history": []}
    if ys is not None:
        yt = torch.from_numpy(np.array(ys, np.float32)).to(device)
        step, _ = make_pipeline_train_step(mesh, n_micro, lr)
        for _ in range(steps):
            local, loss = step(local, xt, yt)
            out["history"].append((float(loss), {
                k: _dist.to_numpy(v) for k, v in local.items()}))
    return out


def run_pipeline(params: dict, xs, n_devices: int, ys=None,
                 lr: float = 1e-2, steps: int = 1,
                 device: Union[str, torch.device, None] = None
                 ) -> dict[str, Any]:
    """The GPipe pipeline over ``n_devices`` ranks, one stage each (the
    card's GPUs unless ``device="cpu"``), from the full numpy stage stack
    (``pipeline_params``' names) and microbatches ``xs`` [n_micro, mb, D].
    Returns ``out`` (rank 0's forward, the whole stack), ``outs_equal``
    (every rank's forward equal to it), ``shard_shapes``, and, when
    targets ``ys`` are given, ``losses`` and ``params`` (the full stack
    after each of ``steps`` SGD steps)."""
    ranks = _dist.run_ranks(_rank_pipeline, n_devices, params, xs, ys,
                            len(xs), lr, steps, device=device)
    out = {"out": ranks[0]["out"],
           "outs_equal": all(np.array_equal(r["out"], ranks[0]["out"])
                             for r in ranks),
           "shard_shapes": ranks[0]["shard_shapes"]}
    if ys is not None:
        out["losses"] = [h[0] for h in ranks[0]["history"]]
        out["params"] = [{k: np.concatenate([r["history"][i][1][k]
                                             for r in ranks])
                          for k in _NAMES} for i in range(steps)]
    return out
