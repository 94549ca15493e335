"""The port's entry points: the burn-in step, and the multi-device dry run.

``entry()`` mirrors the JAX package's ``__graft_entry__.entry``: the
healthcheck workload (one bf16 pre-LN block at d_model 512, d_ff 2048) and
an input ``x`` of [8, 128, 512] bf16, both made from fixed seeds, on the
current CUDA device unless ``device`` says otherwise.

``dryrun_multichip(n_devices)`` mirrors ``__graft_entry__.dryrun_multichip``
on ``n_devices`` ranks: NCCL over the machine's GPUs, or gloo ranks with
``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Union

import torch
import torch.distributed as dist

from k8s_dra_driver_tpu_torch.compute import _dist
from k8s_dra_driver_tpu_torch.compute._device import _resolve_device
from k8s_dra_driver_tpu_torch.compute.burnin import (
    burnin_step,
    transformer_block_params,
)
from k8s_dra_driver_tpu_torch.compute.moe import (
    make_moe_ffn,
    make_moe_train_step,
    moe_ffn_reference,
    moe_params,
)
from k8s_dra_driver_tpu_torch.compute.pipeline import (
    make_pipeline_fn,
    make_pipeline_train_step,
    pipeline_params,
    pipeline_reference,
)
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    make_ring_attention,
    reference_attention,
    seq_block,
)
from k8s_dra_driver_tpu_torch.compute.sharded import (
    make_mesh,
    sharded_train_step,
    train_state,
)

#: The dry run's tolerance (the JAX dry run's and its tests' f32 limit).
DRYRUN_TOL = 2e-5


def entry(device: Union[str, torch.device, None] = None
          ) -> tuple[Callable, tuple]:
    """(fn, example_args): ``fn(*example_args)`` runs one burn-in step."""
    dev = _resolve_device(device)
    params = transformer_block_params(d_model=512, d_ff=2048, device=dev)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 128, 512), generator=gen).to(torch.bfloat16).to(dev)
    return burnin_step, (params, x)


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    err = (got.float() - want.float()).abs()
    if not bool((err <= DRYRUN_TOL + DRYRUN_TOL * want.float().abs()).all()):
        raise AssertionError(f"{what}: max |error| {float(err.max())} over "
                             f"rtol = atol = {DRYRUN_TOL}")
    return float(err.max())


def _rank_dryrun(rank: int, world: int, device: torch.device
                 ) -> dict[str, Any]:
    out: dict[str, Any] = {"world": world, "backend": dist.get_backend(),
                           "device": str(device)}

    # 2. Data plane: the sharded train step over a dp x tp mesh.
    mesh = make_mesh()
    params = train_state(mesh)
    step, make_batch = sharded_train_step(mesh)
    tokens, targets = make_batch(batch=2 * mesh.size(0), seq=16)
    _, loss = step(params, tokens, targets)
    loss = float(loss)
    if not (loss == loss and loss > 0):
        raise AssertionError(f"bad loss {loss}")
    out["mesh"] = {"dp": mesh.size(0), "tp": mesh.size(1)}
    out["loss"] = loss

    # 3. An explicit collective over the whole world: sum of the ranks.
    x = torch.tensor([float(rank)], device=device)
    dist.all_reduce(x)
    if float(x) != float(sum(range(world))):
        raise AssertionError(f"all-reduce wrong: {float(x)}")
    out["allreduce"] = float(x)

    # 4. Long context: ring attention over an sp ring of every rank,
    #    against the unsharded reference.
    sp_mesh = _dist.make_device_mesh((world,), ("sp",))
    gen = torch.Generator().manual_seed(11)
    kq = torch.randn((1, 2, 8 * world, 16), generator=gen).to(device)
    blk = seq_block(kq, sp_mesh)
    ring = make_ring_attention(sp_mesh)(blk, blk, blk)
    out["ring_max_abs_err"] = _close(
        ring, seq_block(reference_attention(kq, kq, kq), sp_mesh), "ring")

    # 5. Expert parallelism: the largest ep of (4, 2) dividing the world
    #    (1 otherwise), dp the rest; the batch sized from dp.
    ep = max((d for d in (4, 2) if world % d == 0), default=1)
    dp = world // ep
    moe_mesh = _dist.make_device_mesh((dp, ep), ("dp", "ep"))
    dp_rank = moe_mesh.get_local_rank("dp")
    gen = torch.Generator().manual_seed(12)
    mp = moe_params(2 * ep, 16, 32, generator=gen)
    xe = torch.randn((2 * dp, 4, 16), generator=gen)
    ye = torch.randn((2 * dp, 4, 16), generator=gen)
    rows = slice(2 * dp_rank, 2 * dp_rank + 2)
    ffn, moe_shard = make_moe_ffn(moe_mesh)
    out["moe_max_abs_err"] = _close(
        ffn(moe_shard(mp), xe[rows].to(device)),
        moe_ffn_reference(mp, xe)[rows].to(device), "moe")
    moe_step, _ = make_moe_train_step(moe_mesh)
    _, moe_loss = moe_step(moe_shard(mp), xe[rows].to(device),
                           ye[rows].to(device))
    if float(moe_loss) != float(moe_loss):
        raise AssertionError("moe loss is NaN")
    out["moe"] = {"dp": dp, "ep": ep, "loss": float(moe_loss)}

    # 6. Pipeline parallelism: one stage per rank, GPipe over a pp ring.
    pp_mesh = _dist.make_device_mesh((world,), ("pp",))
    gen = torch.Generator().manual_seed(15)
    ppar = pipeline_params(world, 8, generator=gen)
    xs = torch.randn((world, 2, 8), generator=gen)
    ys = torch.randn((world, 2, 8), generator=gen)
    fwd, pp_shard = make_pipeline_fn(pp_mesh, n_micro=world)
    out["pipeline_max_abs_err"] = _close(
        fwd(pp_shard(ppar), xs.to(device)),
        pipeline_reference(ppar, xs).to(device), "pipeline")
    pp_step, _ = make_pipeline_train_step(pp_mesh, n_micro=world)
    _, pp_loss = pp_step(pp_shard(ppar), xs.to(device), ys.to(device))
    if float(pp_loss) != float(pp_loss):
        raise AssertionError("pipeline loss is NaN")
    out["pipeline_loss"] = float(pp_loss)
    return out


def dryrun_multichip(n_devices: int,
                     device: Union[str, torch.device, None] = None
                     ) -> dict[str, Any]:
    """Validate the multi-device compute plane end to end on ``n_devices``
    ranks (one per GPU unless ``device="cpu"``, then gloo ranks), as the
    JAX dry run's steps 2-6 do on its virtual devices: (2) one sharded
    train step over a balanced dp x tp mesh; (3) an all-reduce of every
    rank's index; (4) ring attention over an sp ring of every rank against
    the unsharded reference; (5) the MoE FFN over a dp x ep mesh against
    its dense reference, and one train step; (6) the GPipe pipeline, one
    stage per rank, against sequential stages, and one train step. Each
    check within rtol = atol = 2e-5; any failure raises.

    Step 1 of the JAX dry run, the mock allocation, rendezvous and
    ComputeDomain flow, waits for the port's ComputeDomain plugins (its
    rendezvous env is ``MASTER_ADDR``/``WORLD_SIZE``/``RANK`` where the TPU
    package's is ``TPU_WORKER_*``).

    Returns rank 0's summary: world size, backend, device, the mesh
    shapes, losses and the largest errors."""
    return _dist.run_ranks(_rank_dryrun, n_devices, device=device)[0]
