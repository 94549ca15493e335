"""Expert-parallel (ep) Mixture-of-Experts FFN, on ``torch.distributed``.

The JAX package's ``compute/moe.py``: experts sharded over an ``ep`` mesh
axis (each rank holds ``E/ep`` experts' weights), tokens split over
``dp``, and GShard's dense dispatch:

- top-1 gating gives each token a weight vector over the experts (zero
  except the chosen one), computed alike on every ep rank from the
  replicated gate weights;
- each rank contracts all its tokens against its own experts only;
- one sum over ``ep`` (``_dist.reduce_from``) combines the partial
  outputs exactly, since each token's expert lives on exactly one rank.

There is no all-to-all: every rank touches every token of its dp shard,
for static shapes and no routing exchange. The gate weights enter through
``_dist.copy_to`` over ``ep``, so that their gradient sums what every
rank's experts contribute; every gradient is then averaged over ``dp``.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from k8s_dra_driver_tpu_torch.compute import _dist

_NAMES = ("wg", "w1", "w2")


def moe_params(n_experts: int, d_model: int, d_ff: int,
               generator: Optional[torch.Generator] = None,
               device: Union[str, torch.device] = "cpu"
               ) -> dict[str, torch.Tensor]:
    """Gate ``wg`` [d_model, E], experts ``w1`` [E, d_model, d_ff] and
    ``w2`` [E, d_ff, d_model], f32, N(0, 1) scaled by 1/sqrt(fan-in), from
    ``generator`` (a CPU generator, seed 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    scale = d_model ** -0.5
    params = {
        "wg": torch.randn((d_model, n_experts), generator=generator) * scale,
        "w1": torch.randn((n_experts, d_model, d_ff), generator=generator)
        * scale,
        "w2": torch.randn((n_experts, d_ff, d_model), generator=generator)
        * d_ff ** -0.5,
    }
    return {k: v.to(device) for k, v in params.items()}


def moe_params_from_numpy(params: dict, device: Union[str, torch.device]
                          = "cpu") -> dict[str, torch.Tensor]:
    """The JAX ``moe_params``, held as numpy arrays, as f32 tensors."""
    return {k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
            for k in _NAMES}


def _gates(x: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """Top-1 gate weights, [B, S, E]: the softmax probability at the
    argmax expert, zero elsewhere."""
    probs = torch.softmax(torch.einsum("bsd,de->bse", x, wg), dim=-1)
    onehot = torch.nn.functional.one_hot(probs.argmax(dim=-1),
                                         wg.shape[-1]).to(probs.dtype)
    return probs * onehot


def moe_ffn_reference(params: dict[str, torch.Tensor], x: torch.Tensor
                      ) -> torch.Tensor:
    """Unsharded dense-dispatch MoE: the numerics oracle."""
    g = _gates(x, params["wg"])                                  # [B,S,E]
    h = torch.relu(torch.einsum("bsd,edf->bsef", x, params["w1"]))
    y = torch.einsum("bsef,efd->bsed", h, params["w2"])          # [B,S,E,D]
    return torch.einsum("bsed,bse->bsd", y, g)


def make_moe_ffn(mesh, dp_axis: str = "dp", ep_axis: str = "ep"):
    """(ffn, shard_params). ``shard_params(params)`` is this rank's slice:
    ``wg`` whole, ``w1``/``w2`` its ``E/ep`` experts. ``ffn(local, x)``
    maps this rank's dp shard of the tokens, [B/dp, S, D], to its output,
    the same on every ep rank."""
    ep_group = mesh.get_group(ep_axis)
    ep = dist.get_world_size(ep_group)
    ep_rank = dist.get_rank(ep_group)
    dev = _dist.mesh_device(mesh)

    def shard_params(params):
        n = params["w1"].shape[0]
        if n % ep:
            raise ValueError(f"{n} experts not divisible by ep={ep}")
        e = slice(ep_rank * n // ep, (ep_rank + 1) * n // ep)
        return {"wg": params["wg"].to(dev),
                "w1": params["w1"][e].contiguous().to(dev),
                "w2": params["w2"][e].contiguous().to(dev)}

    def ffn(params, x):
        n_local = params["w1"].shape[0]
        e0 = ep_rank * n_local
        g = _gates(x, _dist.copy_to(params["wg"], ep_group))     # full [.., E]
        g_local = g[..., e0:e0 + n_local]
        h = torch.relu(torch.einsum("bsd,edf->bsef", x, params["w1"]))
        y = torch.einsum("bsef,efd->bsed", h, params["w2"])
        return _dist.reduce_from(torch.einsum("bsed,bse->bsd", y, g_local),
                                 ep_group)

    return ffn, shard_params


def make_moe_train_step(mesh, lr: float = 1e-2, dp_axis: str = "dp",
                        ep_axis: str = "ep"):
    """(step, shard_params): one SGD step of the MoE layer against MSE to
    targets. ``step(local, x, y)`` takes this rank's slice and dp shard and
    returns the updated slice and the loss over the global batch."""
    ffn, shard_params = make_moe_ffn(mesh, dp_axis, ep_axis)
    dp_group = mesh.get_group(dp_axis)
    dp = dist.get_world_size(dp_group)

    def step(params, x, y):
        live = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = torch.mean((ffn(live, x) - y) ** 2)
        grads = torch.autograd.grad(loss, list(live.values()))
        _dist.all_mean_(grads, dp_group)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=dp_group)
        with torch.no_grad():
            new = {k: p - lr * g for (k, p), g in zip(params.items(), grads)}
        return new, loss / dp

    return step, shard_params


def _rank_moe(rank: int, world: int, device: torch.device, params: dict, x,
              y, ep: int, lr: float, steps: int) -> dict[str, Any]:
    dp = world // ep
    mesh = _dist.make_device_mesh((dp, ep), ("dp", "ep"))
    dp_rank, ep_rank = mesh.get_local_rank("dp"), mesh.get_local_rank("ep")
    rows = slice(dp_rank * len(x) // dp, (dp_rank + 1) * len(x) // dp)
    xl = torch.from_numpy(np.array(x, np.float32)[rows]).to(device)
    full = moe_params_from_numpy(params)
    ffn, shard_params = make_moe_ffn(mesh)
    local = shard_params(full)
    out = {"dp_rank": dp_rank, "ep_rank": ep_rank,
           "out": _dist.to_numpy(ffn(local, xl)),
           "shard_shapes": {k: tuple(v.shape) for k, v in local.items()},
           "history": []}
    yl = torch.from_numpy(np.array(y, np.float32)[rows]).to(device)
    step, _ = make_moe_train_step(mesh, lr)
    for _ in range(steps):
        local, loss = step(local, xl, yl)
        out["history"].append((float(loss), {
            k: _dist.to_numpy(v) for k, v in local.items()}))
    return out


def run_moe(params: dict, x, y, n_devices: int, ep: int,
            lr: float = 1e-2, steps: int = 1,
            device: Union[str, torch.device, None] = None) -> dict[str, Any]:
    """The expert-parallel MoE on ``n_devices`` ranks as a (n/ep, ep) mesh
    (the card's GPUs unless ``device="cpu"``), from the full numpy weights
    (``moe_params``' names), the global input ``x`` [B, S, D] and targets
    ``y``. Returns ``out`` (the first forward, whole), ``shard_shapes``,
    ``losses`` and ``params`` (the full weights after each of ``steps``
    SGD steps against MSE to ``y``, from dp rank 0's ep ranks)."""
    if n_devices % ep:
        raise ValueError(f"ep={ep} does not divide {n_devices} devices")
    if len(x) % (n_devices // ep):
        raise ValueError(f"batch {len(x)} not divisible by "
                         f"dp={n_devices // ep}")
    ranks = _dist.run_ranks(_rank_moe, n_devices, params, x, y, ep, lr,
                            steps, device=device)
    lead = sorted((r for r in ranks if r["ep_rank"] == 0),
                  key=lambda r: r["dp_rank"])
    first = sorted((r for r in ranks if r["dp_rank"] == 0),
                   key=lambda r: r["ep_rank"])
    return {"out": np.concatenate([r["out"] for r in lead], axis=0),
            "shard_shapes": ranks[0]["shard_shapes"],
            "losses": [h[0] for h in ranks[0]["history"]],
            "params": [{
                "wg": first[0]["history"][i][1]["wg"],
                "w1": np.concatenate([r["history"][i][1]["w1"]
                                      for r in first]),
                "w2": np.concatenate([r["history"][i][1]["w2"]
                                      for r in first]),
            } for i in range(steps)]}
