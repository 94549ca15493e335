"""Data-parallel conv-net step across per-GPU claims, on ``torch.distributed``.

The JAX package's ``compute/resnet.py`` (its BASELINE config 3, "per-chip
claims, pmap ResNet-50 across the chips"): a compact residual conv stack
(3x3 convs, a learned per-channel scale in place of batch norm, skip
connections, global average pool, linear head) in bf16, run data-parallel
with the batch split over a ``dp`` mesh of every rank and the gradients
averaged over it. The port keeps torch's layouts: images NCHW, conv weights
OIHW (``resnet_params_from_numpy`` transposes the JAX package's HWIO). The
convolutions are ``torch.nn.functional.conv2d`` (cuDNN on the card), as
the JAX block leaves them to XLA; no kernel of the port runs here.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from k8s_dra_driver_tpu_torch.compute import _dist
from k8s_dra_driver_tpu_torch.compute.sharded import (
    sgd_tree_update,
    softmax_xent,
)


def resnet_block_params(generator: torch.Generator, channels: int = 32,
                        dtype: torch.dtype = torch.bfloat16
                        ) -> dict[str, torch.Tensor]:
    """One residual unit: two 3x3 convs [C, C, 3, 3] N(0, 1/(9C)) and a
    per-channel scale ``gamma`` of ones, in ``dtype``."""
    scale = 1.0 / (9 * channels) ** 0.5
    return {
        "conv1": (torch.randn((channels, channels, 3, 3), generator=generator)
                  * scale).to(dtype),
        "conv2": (torch.randn((channels, channels, 3, 3), generator=generator)
                  * scale).to(dtype),
        "gamma": torch.ones((channels,), dtype=dtype),
    }


def resnet_params(depth: int = 4, channels: int = 32, num_classes: int = 10,
                  dtype: torch.dtype = torch.bfloat16,
                  generator: Optional[torch.Generator] = None,
                  device: Union[str, torch.device] = "cpu") -> dict[str, Any]:
    """Stem conv [C, 3, 3, 3], ``depth`` residual blocks and a head
    [C, num_classes], from ``generator`` (a CPU generator, seed 0 when
    None), on ``device``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = {
        "stem": (torch.randn((channels, 3, 3, 3), generator=generator)
                 / 27 ** 0.5).to(dtype),
        "blocks": [resnet_block_params(generator, channels, dtype)
                   for _ in range(depth)],
        "head": (torch.randn((channels, num_classes), generator=generator)
                 / channels ** 0.5).to(dtype),
    }
    return _to(params, device)


def _to(params: dict, device) -> dict[str, Any]:
    return {"stem": params["stem"].to(device),
            "blocks": [{k: v.to(device) for k, v in b.items()}
                       for b in params["blocks"]],
            "head": params["head"].to(device)}


def resnet_params_from_numpy(params: dict, device: Union[str, torch.device]
                             = "cpu", dtype: torch.dtype = torch.bfloat16
                             ) -> dict[str, Any]:
    """The JAX ``resnet_params``, held as numpy arrays (HWIO convs), as
    the port's tensors (OIHW convs) in ``dtype`` on ``device``. bf16 goes
    through f32, which holds it exactly."""
    def conv(w):
        return torch.from_numpy(np.array(w, np.float32)).permute(
            3, 2, 0, 1).contiguous().to(dtype)

    def vec(w):
        return torch.from_numpy(np.array(w, np.float32)).to(dtype)

    return _to({"stem": conv(params["stem"]),
                "blocks": [{"conv1": conv(b["conv1"]),
                            "conv2": conv(b["conv2"]),
                            "gamma": vec(b["gamma"])}
                           for b in params["blocks"]],
                "head": vec(params["head"])}, device)


def resnet_params_to_numpy(params: dict) -> dict[str, Any]:
    """The inverse of ``resnet_params_from_numpy``: f32 numpy arrays in the
    JAX package's layout (HWIO convs)."""
    def conv(w):
        return _dist.to_numpy(w.permute(2, 3, 1, 0))

    return {"stem": conv(params["stem"]),
            "blocks": [{"conv1": conv(b["conv1"]), "conv2": conv(b["conv2"]),
                        "gamma": _dist.to_numpy(b["gamma"])}
                       for b in params["blocks"]],
            "head": _dist.to_numpy(params["head"])}


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, w, padding="same")


def resnet_forward(params: dict[str, Any], images: torch.Tensor
                   ) -> torch.Tensor:
    """[b, 3, h, w] -> [b, num_classes] f32 logits."""
    x = torch.relu(_conv(images.to(params["stem"].dtype), params["stem"]))
    for blk in params["blocks"]:
        h = torch.relu(_conv(x, blk["conv1"]))
        h = _conv(h, blk["conv2"]) * blk["gamma"][:, None, None]
        x = torch.relu(x + h)
    pooled = x.mean(dim=(2, 3))                      # global average pool
    return (pooled @ params["head"]).float()


def _flat(params: dict) -> list[torch.Tensor]:
    return [params["stem"]] + [b[k] for b in params["blocks"]
                               for k in ("conv1", "conv2", "gamma")] \
        + [params["head"]]


def _unflat(params: dict, leaves: list) -> dict[str, Any]:
    it = iter(leaves)
    stem = next(it)
    blocks = [{k: next(it) for k in ("conv1", "conv2", "gamma")}
              for _ in params["blocks"]]
    return {"stem": stem, "blocks": blocks, "head": next(it)}


def data_parallel_resnet_step(mesh, lr: float = 1e-2):
    """(step, make_batch) with the batch split over every rank of the 1D
    ``dp`` mesh. ``step(params, images, labels)`` takes the replicated
    weights and this rank's shard of the batch, averages the gradients
    over ``dp`` (summed in f32), updates in f32 and returns the weights in
    their dtype and the loss over the global batch. ``make_batch(per_chip,
    size, num_classes)`` draws the global batch (``per_chip`` images per
    rank, NCHW f32, from a CPU generator seeded 5) and returns this rank's
    shard."""
    group = mesh.get_group("dp")
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dev = _dist.mesh_device(mesh)

    def step(params, images, labels):
        leaves = [p.detach().requires_grad_(True) for p in _flat(params)]
        live = _unflat(params, leaves)
        loss = softmax_xent(resnet_forward(live, images), labels)
        grads = list(torch.autograd.grad(loss, leaves))
        _dist.all_mean_(grads, group)
        flat = dict(enumerate(_flat(params)))
        new = sgd_tree_update(flat, dict(enumerate(grads)), lr)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        return _unflat(params, [new[i] for i in range(len(new))]), loss / n

    def make_batch(per_chip: int = 2, size: int = 16, num_classes: int = 10):
        gen = torch.Generator().manual_seed(5)
        images = torch.randn((per_chip * n, 3, size, size), generator=gen)
        labels = torch.randint(0, num_classes, (per_chip * n,),
                               generator=gen)
        rows = slice(r * per_chip, (r + 1) * per_chip)
        return images[rows].to(dev), labels[rows].to(dev)

    return step, make_batch


def _rank_resnet(rank: int, world: int, device: torch.device, params: dict,
                 images, labels, lr: float, steps: int, time_reps: int
                 ) -> dict[str, Any]:
    mesh = _dist.make_device_mesh((world,), ("dp",))
    per = len(images) // world
    rows = slice(rank * per, (rank + 1) * per)
    # The JAX batch is NHWC; the port's is NCHW.
    x = torch.from_numpy(np.array(images, np.float32)[rows]).permute(
        0, 3, 1, 2).contiguous().to(device)
    y = torch.from_numpy(np.array(labels)[rows]).long().to(device)
    local = resnet_params_from_numpy(params, device)
    step, _ = data_parallel_resnet_step(mesh, lr)
    out = {"logits": _dist.to_numpy(resnet_forward(local, x)),
           "batch_shard": per, "history": []}
    for _ in range(steps):
        local, loss = step(local, x, y)
        out["history"].append((float(loss), resnet_params_to_numpy(local)))
    if time_reps:
        out["timing"] = _dist.step_timing(lambda: step(local, x, y), device,
                                          reps=time_reps)
    return out


def run_data_parallel_resnet(params: dict, images, labels, n_devices: int,
                             lr: float = 1e-2, steps: int = 1,
                             device: Union[str, torch.device, None] = None,
                             time_reps: int = 0) -> dict[str, Any]:
    """``steps`` data-parallel SGD steps on ``n_devices`` ranks (the card's
    GPUs unless ``device="cpu"``) from the JAX package's numpy weights
    (``resnet_params`` layout) and a global NHWC f32 batch with integer
    labels. Returns ``logits`` (the first forward, whole batch),
    ``batch_shards`` (images per rank), ``losses``, ``params`` (after each
    step, in the JAX layout, f32 numpy holding bf16 values), and, when
    ``time_reps`` > 0, ``timing`` (rank 0's ``_dist.step_timing`` of
    further steps)."""
    if len(images) % n_devices:
        raise ValueError(f"batch {len(images)} not divisible by "
                         f"dp={n_devices}")
    ranks = _dist.run_ranks(_rank_resnet, n_devices, params, images, labels,
                            lr, steps, time_reps, device=device)
    out = {"logits": np.concatenate([r["logits"] for r in ranks]),
           "batch_shards": [r["batch_shard"] for r in ranks],
           "losses": [h[0] for h in ranks[0]["history"]],
           "params": [h[1] for h in ranks[0]["history"]]}
    if time_reps:
        out["timing"] = ranks[0]["timing"]
    return out
