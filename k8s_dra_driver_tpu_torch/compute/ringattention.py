"""Exact attention, unsharded and as a ring over a sequence-parallel group.

``reference_attention`` is the JAX package's function of the same name
(``compute/ringattention.py``): f32 scores scaled by 1/sqrt(d), an optional
causal mask (key j hidden from query row i when j > i), softmax, and the
output in q's dtype. In the port it is also the plain version of the
flash-attention kernel: the CPU path of ``flash_attention`` and the
kernel's oracle on the card.

Ring attention shards the sequence over the ``sp`` ranks of a mesh: every
rank holds one block of q, k and v, the K/V blocks travel one hop around
the ring per step (``_dist.ppermute_next``, a ``batch_isend_irecv`` pair),
and each rank folds every block into its queries' attention with an online
softmax (running max and denominator, scores and accumulator in f32). The
rotation starts from the resident block, so step 0 is the self block and
every row's running max is finite before a fully masked block arrives;
after ``n - 1`` rotations the last block is folded in without rotating it
onward. Under ``causal``, the block from an earlier rank passes whole, one
from a later rank is skipped, and the self block gets the triangle. The
block arithmetic is plain torch (``einsum``), as the JAX ring's is
``jnp.einsum``: no kernel of the port runs here.
"""

from __future__ import annotations

import time
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from k8s_dra_driver_tpu_torch.compute import _dist


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """[b, h, S, d] x [b, h, S, d] x [b, h, S, dv] -> [b, h, S, dv] in q's
    dtype, with the [S, S] scores materialized in f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(scores.shape[-2:], dtype=torch.bool,
                          device=scores.device).tril()
        scores.masked_fill_(~keep, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _online_block(q, k_blk, v_blk, acc, m, l, scale,
                  mask: Optional[torch.Tensor] = None):
    """One online-softmax accumulation step for a K/V block.

    q: [b, h, sq, d]; k_blk/v_blk: [b, h, sk, d]; acc: [b, h, sq, d];
    m, l: [b, h, sq] running max / denominator. ``mask``: optional
    [sq, sk] bool, True = attend."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k_blk) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                    v_blk)
    return acc_new, m_new, l_new


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, group, causal: bool = False
                           ) -> torch.Tensor:
    """This rank's query block's exact attention against the whole
    sequence, the K/V blocks arriving around ``group``'s ring. q, k, v:
    this rank's [b, h, S/n, d] blocks, block ``r`` on group rank ``r``.

    The K/V block at ring step ``i`` comes from group rank ``(r - i) mod
    n``: under ``causal`` an earlier rank's block passes unmasked, a later
    rank's is fully masked (skipped: it adds nothing), and the self block
    (step 0) gets the triangular mask."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    block = q.shape[2]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qf = q.float()
    tri = torch.ones((block, block), dtype=torch.bool,
                     device=q.device).tril()
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)

    def fold(step, k_blk, v_blk, acc, m, l):
        src = (rank - step) % n
        if causal and src > rank:
            return acc, m, l
        mask = tri if causal and src == rank else None
        return _online_block(qf, k_blk.float(), v_blk.float(), acc, m, l,
                             scale, mask)

    for i in range(n - 1):
        acc, m, l = fold(i, k, v, acc, m, l)
        k = _dist.ppermute_next(k, group)
        v = _dist.ppermute_next(v, group)
    acc, m, l = fold(n - 1, k, v, acc, m, l)
    return (acc / l[..., None]).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = False):
    """``fn(q, k, v)``: exact attention with the sequence sharded over
    ``axis_name`` of ``mesh``. ``fn`` takes and returns this rank's
    sequence block ([b, h, S/n, d]); ``seq_block`` cuts it from a whole
    tensor."""
    group = mesh.get_group(axis_name)

    def fn(q, k, v):
        return ring_attention_sharded(q, k, v, group, causal=causal)

    return fn


def seq_block(x, mesh, axis_name: str = "sp"):
    """This rank's block of ``x``'s sequence axis (axis 2)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    r = mesh.get_local_rank(axis_name)
    s = x.shape[2]
    if s % n:
        raise ValueError(f"sequence {s} not divisible by {axis_name}={n}")
    return x[:, :, r * s // n:(r + 1) * s // n]


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rank_ring(rank: int, world: int, device: torch.device, q, k, v,
               causal: bool, dtype: str) -> dict[str, Any]:
    mesh = _dist.make_device_mesh((world,), ("sp",))
    q, k, v = (seq_block(torch.from_numpy(np.array(a, np.float32)), mesh)
               .to(device, _DTYPES[dtype]) for a in (q, k, v))
    out = make_ring_attention(mesh, causal=causal)(q, k, v)
    return {"out": _dist.to_numpy(out), "dtype": str(out.dtype)}


def run_ring_attention(q, k, v, n_devices: int, causal: bool = False,
                       dtype: str = "float32",
                       device: Union[str, torch.device, None] = None
                       ) -> dict[str, Any]:
    """Ring attention of whole numpy q, k, v ([b, h, S, d]), cast to
    ``dtype`` ("float32" or "bfloat16"), over ``n_devices`` ranks (the
    card's GPUs unless ``device="cpu"``). Returns ``out`` (the whole
    output as f32 numpy), ``blocks`` (each rank's output block shape) and
    ``dtype`` (the output's)."""
    ranks = _dist.run_ranks(_rank_ring, n_devices, q, k, v, causal, dtype,
                            device=device)
    return {"out": np.concatenate([r["out"] for r in ranks], axis=2),
            "blocks": [tuple(r["out"].shape) for r in ranks],
            "dtype": ranks[0]["dtype"]}


def _peak_bytes(fn, device: torch.device) -> Optional[int]:
    """Device memory one ``fn()`` allocates beyond what was allocated
    before it, at its peak; None on the CPU (not measured)."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base


def _rank_crossover(rank: int, world: int, device: torch.device,
                    seqs: Sequence[int], b: int, h: int, d: int, reps: int,
                    full_exec_max_seq: int) -> list[dict]:
    mesh = _dist.make_device_mesh((world,), ("sp",))
    ring = make_ring_attention(mesh)
    rows = []
    for seq in seqs:
        gen = torch.Generator().manual_seed(0)
        shape = (b, h, seq, d)
        q, k, v = (torch.randn(shape, generator=gen) for _ in range(3))
        ql, kl, vl = (seq_block(x, mesh).to(device) for x in (q, k, v))
        row = {"seq": seq, "shape": list(shape), "n_devices": world,
               "ring_ms": _dist.time_ms(lambda: ring(ql, kl, vl), device,
                                        reps=reps),
               "ring_peak_bytes": _peak_bytes(lambda: ring(ql, kl, vl),
                                              device)}
        if seq <= full_exec_max_seq:
            qd, kd, vd = (x.to(device) for x in (q, k, v))
            ref = reference_attention(qd, kd, vd)
            row["full_ms"] = _dist.time_ms(
                lambda: reference_attention(qd, kd, vd), device, reps=reps)
            row["full_peak_bytes"] = _peak_bytes(
                lambda: reference_attention(qd, kd, vd), device)
            row["speedup_vs_full"] = row["full_ms"] / row["ring_ms"]
            err = (ring(ql, kl, vl) - seq_block(ref, mesh)).abs().max()
            dist.all_reduce(err, op=dist.ReduceOp.MAX)
            row["max_abs_err"] = float(err)
            del qd, kd, vd, ref
        rows.append(row)
    return rows


def ring_crossover_bench(seqs: Sequence[int], n_devices: Optional[int] = None,
                         b: int = 1, h: int = 4, d: int = 64, reps: int = 3,
                         full_exec_max_seq: int = 4096,
                         device: Union[str, torch.device, None] = None
                         ) -> list[dict]:
    """Ring attention against full attention per sequence length: time
    (``ring_ms``, ``full_ms``: ``_dist.time_ms`` over ``reps`` calls) and
    the device memory one call allocates at its peak beyond its inputs
    (``*_peak_bytes``; None on the CPU), on ``n_devices`` ranks (every GPU
    of the card's machine unless ``device="cpu"``, then 1 unless given).
    Full attention runs up to ``full_exec_max_seq``, and there the ring's
    output is held against it (``max_abs_err``, the largest over ranks).
    Inputs: f32 N(0, 1) [b, h, seq, d] from a CPU generator seeded 0."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if device is None
                     or torch.device(device).type == "cuda" else 1)
    return _dist.run_ranks(_rank_crossover, n_devices, list(seqs), b, h, d,
                           reps, full_exec_max_seq, device=device)[0]


def _main(argv: "list[str] | None" = None) -> int:
    """CLI for the crossover bench: one JSON list of rows."""
    import argparse
    import json

    p = argparse.ArgumentParser(prog="ring-attention-bench")
    p.add_argument("--seqs", default="1024,2048,4096,8192")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--full-exec-max-seq", type=int, default=4096)
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="'cpu' for gloo ranks; default every GPU")
    args = p.parse_args(argv)
    t0 = time.monotonic()
    rows = ring_crossover_bench(
        [int(s) for s in args.seqs.split(",")], n_devices=args.n_devices,
        reps=args.reps, full_exec_max_seq=args.full_exec_max_seq,
        device=args.device)
    print(json.dumps({"rows": rows, "seconds": time.monotonic() - t0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
