"""Multi-GPU sharded training step (dp x tp mesh), on ``torch.distributed``.

The JAX package's ``compute/sharded.py`` jits the step over a ``Mesh`` with
``NamedSharding`` annotations and lets XLA insert the collectives. Here
each rank holds its shards and the collectives are explicit:

- ``w1`` is column-parallel and ``w2`` row-parallel over ``tp`` (the
  Megatron layout, one reduction per forward): ``reduce_from`` (``g``)
  sums ``h @ w2`` over ``tp`` and ``copy_to`` (``f``) makes the gradient
  of the replicated activation entering ``x @ w1`` whole;
- the batch is split over ``dp``, and each gradient is averaged over
  ``dp`` (the loss is the mean over the global batch);
- SGD updates in f32 and stores back in each parameter's dtype.

Functions here run inside a rank (see ``_dist.run_ranks``);
``run_sharded_train_step`` starts the ranks from full numpy weights and a
global batch, as the JAX step takes global arrays, and returns full numpy
results.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from k8s_dra_driver_tpu_torch.compute import _dist

_NAMES = ("embed", "w1", "w2", "out")


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor
                 ) -> torch.Tensor:
    """Mean cross-entropy; logits promoted to f32 for a stable log-softmax.
    ``targets``: integer class ids shaped like logits minus the last axis."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


@torch.no_grad()
def sgd_tree_update(params: dict, grads: dict, lr: float) -> dict:
    """Mixed-precision SGD: update in f32, store back in each parameter's
    dtype (bf16 weights do not accumulate rounding across steps)."""
    return {k: (p.float() - lr * grads[k].float()).to(p.dtype)
            for k, p in params.items()}


def _balanced_2d(n: int) -> tuple[int, int]:
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def _check_shape(shape: tuple[int, int], n: int) -> None:
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape[0]}x{shape[1]} != {n} devices")


def _check_batch(batch: int, dp: int) -> None:
    if batch % dp != 0:
        raise ValueError(f"batch {batch} not divisible by dp={dp}")


def make_mesh(shape: Optional[tuple[int, int]] = None):
    """A (dp, tp) ``DeviceMesh`` over every rank of the world. Where the
    ranks' GPUs are not all alike in their links, callers pass ``shape`` to
    put ``tp`` on the best-connected neighbours; the default is the
    most-balanced 2D factorization."""
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else _balanced_2d(n)
    _check_shape(shape, n)
    return _dist.make_device_mesh(shape, ("dp", "tp"))


def _tp_cols(mesh, d_ff: int) -> slice:
    tp = mesh.size(mesh.mesh_dim_names.index("tp"))
    r = mesh.get_local_rank("tp")
    if d_ff % tp:
        raise ValueError(f"d_ff {d_ff} not divisible by tp={tp}")
    w = d_ff // tp
    return slice(r * w, (r + 1) * w)


def _shard(mesh, full: dict, device: torch.device) -> dict[str, torch.Tensor]:
    cols = _tp_cols(mesh, full["w1"].shape[1])
    return {
        "embed": full["embed"].to(device),
        "w1": full["w1"][:, cols].contiguous().to(device),
        "w2": full["w2"][cols, :].contiguous().to(device),
        "out": full["out"].to(device),
    }


def train_state(mesh, d_model: int = 256, d_ff: int = 1024,
                vocab: int = 512) -> dict[str, torch.Tensor]:
    """This rank's shards, on its device, of a 2-layer MLP LM head: ``w1``
    [d_model, d_ff/tp] (column-sharded), ``w2`` [d_ff/tp, d_model]
    (row-sharded), ``embed`` and ``out`` whole. The full weights are
    N(0, 0.02^2) from a CPU generator seeded 0, the same on every rank."""
    gen = torch.Generator().manual_seed(0)
    full = {"embed": torch.randn((vocab, d_model), generator=gen) * 0.02,
            "w1": torch.randn((d_model, d_ff), generator=gen) * 0.02,
            "w2": torch.randn((d_ff, d_model), generator=gen) * 0.02,
            "out": torch.randn((d_model, vocab), generator=gen) * 0.02}
    return _shard(mesh, full, _dist.mesh_device(mesh))


def train_state_from_numpy(mesh, params: dict, device: torch.device
                           ) -> dict[str, torch.Tensor]:
    """The JAX ``train_state``'s full weights, held as numpy arrays, as this
    rank's shards on ``device``."""
    full = {k: torch.from_numpy(np.array(params[k], np.float32))
            for k in _NAMES}
    return _shard(mesh, full, device)


def _forward(params: dict[str, torch.Tensor], tokens: torch.Tensor,
             tp_group) -> torch.Tensor:
    x = params["embed"][tokens]                       # [b, s, d]
    h = F.gelu(_dist.copy_to(x, tp_group) @ params["w1"],
               approximate="tanh")                    # [b, s, ff/tp]
    x = x + _dist.reduce_from(h @ params["w2"], tp_group)
    return x @ params["out"]                          # [b, s, vocab]


def _loss(params, tokens, targets, tp_group) -> torch.Tensor:
    return softmax_xent(_forward(params, tokens, tp_group), targets)


def sharded_train_step(mesh, lr: float = 1e-2):
    """(step, make_batch). ``step(params, tokens, targets)`` takes this
    rank's shards and its dp shard of the batch, and returns the updated
    shards and the loss over the global batch. ``make_batch(batch, seq,
    vocab)`` draws the global batch from a CPU generator seeded 7 and
    returns this rank's dp shard."""
    dp_group, tp_group = mesh.get_group("dp"), mesh.get_group("tp")
    dp = mesh.size(mesh.mesh_dim_names.index("dp"))
    dp_rank = mesh.get_local_rank("dp")

    def step(params, tokens, targets):
        live = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = _loss(live, tokens, targets, tp_group)
        grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
        _dist.all_mean_(list(grads.values()), dp_group)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=dp_group)
        return sgd_tree_update(params, grads, lr), loss / dp

    def make_batch(batch: int = 8, seq: int = 16, vocab: int = 512):
        _check_batch(batch, dp)
        gen = torch.Generator().manual_seed(7)
        tokens = torch.randint(0, vocab, (batch, seq), generator=gen)
        targets = torch.randint(0, vocab, (batch, seq), generator=gen)
        rows = slice(dp_rank * batch // dp, (dp_rank + 1) * batch // dp)
        dev = _dist.mesh_device(mesh)
        return tokens[rows].to(dev), targets[rows].to(dev)

    return step, make_batch


def _rank_train(rank: int, world: int, device: torch.device, params: dict,
                tokens, targets, shape, lr: float, steps: int,
                time_reps: int) -> dict[str, Any]:
    mesh = make_mesh(shape)
    dp = mesh.size(0)
    dp_rank, tp_rank = mesh.get_local_rank("dp"), mesh.get_local_rank("tp")
    per = len(tokens) // dp
    rows = slice(dp_rank * per, (dp_rank + 1) * per)
    tok = torch.from_numpy(np.array(tokens)[rows]).long().to(device)
    tgt = torch.from_numpy(np.array(targets)[rows]).long().to(device)
    local = train_state_from_numpy(mesh, params, device)
    step, _ = sharded_train_step(mesh, lr)
    history = []
    for _ in range(steps):
        local, loss = step(local, tok, tgt)
        history.append((float(loss), {k: _dist.to_numpy(v)
                                      for k, v in local.items()}))
    out = {"dp_rank": dp_rank, "tp_rank": tp_rank, "history": history,
           "mesh": {"dp": mesh.size(0), "tp": mesh.size(1)}}
    if time_reps:
        out["timing"] = _dist.step_timing(lambda: step(local, tok, tgt),
                                          device, reps=time_reps)
    return out


def run_sharded_train_step(params: dict, tokens, targets, n_devices: int,
                           shape: Optional[tuple[int, int]] = None,
                           lr: float = 1e-2, steps: int = 1,
                           device: Union[str, torch.device, None] = None,
                           time_reps: int = 0) -> dict[str, Any]:
    """``steps`` SGD steps of ``sharded_train_step`` on ``n_devices`` ranks
    (the card's GPUs unless ``device="cpu"``) from the full numpy weights
    ``params`` (the JAX ``train_state``'s names) and a global integer batch.

    Returns ``losses`` (one per step), ``params`` (the full weights after
    each step, assembled from the shards of dp rank 0), ``replicas_equal``
    (every dp replica's shards equal to dp rank 0's after every step),
    ``mesh``, ``shard_shapes`` and, when ``time_reps`` > 0, ``timing``:
    rank 0's ``_dist.step_timing`` of further steps, ``time_reps`` each."""
    shape = tuple(shape) if shape is not None else _balanced_2d(n_devices)
    _check_shape(shape, n_devices)
    _check_batch(len(tokens), shape[0])
    ranks = _dist.run_ranks(_rank_train, n_devices, params, tokens, targets,
                            shape, lr, steps, time_reps, device=device)
    first = [r for r in ranks if r["dp_rank"] == 0]
    first.sort(key=lambda r: r["tp_rank"])
    full = []
    for i in range(steps):
        shards = [r["history"][i][1] for r in first]
        full.append({
            "embed": shards[0]["embed"], "out": shards[0]["out"],
            "w1": np.concatenate([s["w1"] for s in shards], axis=1),
            "w2": np.concatenate([s["w2"] for s in shards], axis=0)})
    replicas_equal = all(
        np.array_equal(r["history"][i][1][k], first[r["tp_rank"]]
                       ["history"][i][1][k])
        for r in ranks for i in range(steps) for k in _NAMES)
    out = {"losses": [h[0] for h in ranks[0]["history"]], "params": full,
           "replicas_equal": replicas_equal, "mesh": ranks[0]["mesh"],
           "shard_shapes": {k: tuple(v.shape) for k, v in
                            ranks[0]["history"][0][1].items()}}
    if time_reps:
        out["timing"] = ranks[0]["timing"]
    return out
