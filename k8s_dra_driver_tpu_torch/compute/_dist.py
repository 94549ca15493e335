"""Ranks, meshes and collectives with JAX's semantics, on torch.distributed.

JAX runs a multi-device program in one process: ``shard_map`` and ``jit``
over a ``Mesh`` give every device its shard, and XLA inserts the
collectives. The port runs one process per device instead:

- ``run_ranks(fn, n, *args, device=...)`` starts ``n`` ranks, calls
  ``fn(rank, world, device, *args)`` in each and returns their results. On
  the CPU the ranks are gloo processes; on the card, one NCCL rank per GPU.
  Ranks are fresh processes forked from a server process that has
  imported torch and this package (and nothing of the caller's state).
  Each run rendezvouses through a fresh ``file://`` path in a temporary
  directory (no fixed TCP port), or, given a ComputeDomain channel claim's
  env (``MASTER_ADDR``, ``MASTER_PORT``, ``NNODES``, ``NODE_RANK``),
  through ``tcp://MASTER_ADDR:MASTER_PORT`` as this node's share of the
  domain's ranks. Each run has a deadline, after which its ranks are
  terminated and the call raises. ``stop_rank_server()`` stops the
  server and waits for it; it also runs when the program exits, so a
  program that ran ranks leaves no process behind.
- ``make_device_mesh(shape, names)`` is a named ``DeviceMesh`` over the
  world, row-major like ``Mesh(np.array(devices).reshape(shape), names)``.
- ``reduce_from`` and ``copy_to`` are Megatron's ``g`` and ``f``: the two
  ways a sum over a group transposes. ``reduce_from`` sums in the forward
  and passes the cotangent unchanged, as the transpose of JAX's ``psum``
  does under ``shard_map``; ``copy_to`` is the identity in the forward and
  sums the cotangent, as JAX does for a replicated input used by every
  shard. (``torch.distributed.nn.functional.all_reduce`` sums in both
  directions, which multiplies a replicated cotangent by the group size.)
- ``ppermute_next`` moves a tensor one hop up a ring, as ``lax.ppermute``
  with ``[(i, (i + 1) % n)]``; its backward moves the cotangent one hop
  back.

Results cross the process boundary as pickles, so rank functions return
numpy arrays and Python scalars.
"""

from __future__ import annotations

import atexit
import math
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Seconds a run of ranks may take before they are terminated.
DEFAULT_TIMEOUT_S = 120.0


def _rank_main(local_rank: int, rank: int, world: int, device_type: str,
               init: str, timeout_s: float, results, work: str) -> None:
    torch.set_num_threads(1)
    try:
        with open(work, "rb") as f:
            fn, args = pickle.load(f)
        if device_type == "cuda":
            torch.cuda.set_device(local_rank)
            # f32 stays f32 on the card, as on the CPU and in JAX.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            device = torch.device("cuda", local_rank)
        else:
            device = torch.device("cpu")
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", init_method=init,
            world_size=world, rank=rank,
            timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((local_rank, True, out))
    except Exception:  # noqa: BLE001 — the parent raises it, with this trace
        results.put((local_rank, False, traceback.format_exc()))


#: The variables of a ComputeDomain channel claim that place a node's ranks.
RENDEZVOUS_KEYS = ("MASTER_ADDR", "MASTER_PORT", "NNODES", "NODE_RANK")


def rendezvous_from_env(env: dict[str, str], local_count: int
                        ) -> tuple[str, int, int]:
    """``(init_method, first global rank, world size)`` for ``local_count``
    ranks on the node that ``env`` (a channel claim's rendezvous variables)
    describes: ``tcp://MASTER_ADDR:MASTER_PORT``, ranks from
    ``NODE_RANK * local_count`` on, of ``NNODES * local_count``. Missing
    or malformed variables raise ValueError."""
    missing = [k for k in RENDEZVOUS_KEYS if not env.get(k)]
    if missing:
        raise ValueError(f"rendezvous env lacks {missing}")
    try:
        port, nnodes, node_rank = (int(env[k]) for k in RENDEZVOUS_KEYS[1:])
    except ValueError:
        raise ValueError(f"rendezvous env is not numeric where it must be: "
                         f"{ {k: env[k] for k in RENDEZVOUS_KEYS} }") from None
    if not (0 < port < 65536 and nnodes >= 1 and 0 <= node_rank < nnodes):
        raise ValueError(f"rendezvous env out of range: "
                         f"{ {k: env[k] for k in RENDEZVOUS_KEYS} }")
    return (f"tcp://{env['MASTER_ADDR']}:{port}", node_rank * local_count,
            nnodes * local_count)


def run_ranks(fn: Callable, n: int, *args: Any,
              device: Union[str, torch.device, None] = None,
              timeout: float = DEFAULT_TIMEOUT_S,
              rendezvous: Optional[dict[str, str]] = None) -> list:
    """``[fn(r, world, device_r, *args) for r in this node's ranks]``, each
    in its own rank of one process group. ``fn`` must be importable by name
    (a module-level function of the port), and its arguments and result
    picklable.

    ``device=None`` is the card: NCCL, local rank ``r`` on ``cuda:r``; more
    ranks than GPUs raises. ``device="cpu"`` is gloo. Each rank runs with
    one intra-op thread. A rank that raises, or a run that outlasts
    ``timeout`` seconds, terminates every rank and raises here.

    Without ``rendezvous`` the ``n`` ranks are the whole world (ranks
    ``0..n-1``) and meet at a fresh ``file://`` path. With a channel
    claim's env they are this node's share of ``NNODES * n`` ranks, global
    ranks ``NODE_RANK * n + r``, meeting at ``tcp://MASTER_ADDR:
    MASTER_PORT``; a port that is taken fails the run (nothing retries
    elsewhere). Returns the results of this node's ranks, by local rank."""
    device_type = torch.device("cuda" if device is None else device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks need {n} GPUs, have "
                             f"{torch.cuda.device_count()}")
    elif device_type != "cpu":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    first, world = 0, n
    if rendezvous is not None:
        init, first, world = rendezvous_from_env(rendezvous, n)
    # A fork server that has imported torch once starts each rank in
    # milliseconds, where a spawned rank imports torch anew (seconds). It
    # never initializes CUDA, so its children may.
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed", __name__])
    results = ctx.Queue()
    out: dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        if rendezvous is None:
            init = "file://" + os.path.join(tmp, "rendezvous")
        # The function and its arguments go through a file: a start whose
        # arguments overflow the pipe would wait for the child's imports,
        # and the ranks would start one after another.
        work = os.path.join(tmp, "work.pickle")
        with open(work, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, first + r, world, device_type, init,
                                   timeout, results, work))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{fn.__qualname__} on {n} {device_type} ranks "
                        f"passed its {timeout:.0f} s deadline; ranks "
                        f"{sorted(set(range(n)) - set(out))} had not "
                        "finished")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"{fn.__qualname__}: rank {dead[0]} exited with "
                            f"code {procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(
                        f"{fn.__qualname__} failed on rank {first + rank} of "
                        f"{world}:\n{payload}")
                out[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10 if len(out) == n else 0)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [out[r] for r in range(n)]


def stop_rank_server() -> None:
    """Stop the fork server that starts the ranks, and the resource tracker
    it shares, and wait until both have exited. Unstopped, they outlive the
    program by the time the server takes to unload torch. The next
    ``run_ranks`` starts them anew."""
    multiprocessing.forkserver._forkserver._stop()
    multiprocessing.resource_tracker._resource_tracker._stop()


atexit.register(stop_rank_server)


def make_device_mesh(shape: Sequence[int], names: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over every rank of the
    world, rank-major as JAX's ``Mesh(devices.reshape(shape), names)``, on
    the ranks' GPUs under NCCL and on the CPU under gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = tuple(int(s) for s in shape), tuple(names)
    world = dist.get_world_size()
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} names {names}")
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {'x'.join(map(str, shape))} != "
                         f"{world} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


class _ReduceFrom(torch.autograd.Function):
    """Megatron's ``g``: all-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _CopyTo(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.group)
        return dx, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``; the cotangent passes unchanged. JAX's
    ``lax.psum`` with a replicated (``P()``) result."""
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its cotangent is summed over ``group``. Put it where
    a replicated tensor enters work that each rank of ``group`` does on its
    own shard, so that the tensor's gradient is whole."""
    return _CopyTo.apply(x, group)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """The tensor of group rank ``r - step`` (mod n), for every rank ``r``."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    x = x.contiguous()
    y = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, y,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return y


class _PpermuteNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, dy):
        return _shift(dy, ctx.group, -1), None


def ppermute_next(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank ``r`` of ``group`` sends ``x`` to ``r + 1`` and returns
    what ``r - 1`` sent (mod the group's size). A group of one returns
    ``x``. Every rank must call it, and, under autograd, every rank's
    backward must reach it in the same order (the same graph on every
    rank does that)."""
    if dist.get_world_size(group) == 1:
        return x
    return _PpermuteNext.apply(x, group)


def _rank_transposes(rank: int, world: int, device: torch.device, xs, c, z,
                     ws) -> dict:
    group = dist.group.WORLD
    x = torch.from_numpy(xs[rank]).requires_grad_(True)
    (reduce_from(2 * x, group) * torch.from_numpy(c)).sum().backward()
    zt = torch.from_numpy(z).requires_grad_(True)
    (copy_to(zt, group) * torch.from_numpy(ws[rank])).sum().backward()
    return {"dx": x.grad.numpy(), "dz": zt.grad.numpy()}


def transposes(xs, c, z, ws, device: Union[str, torch.device, None] = None
               ) -> list[dict]:
    """The two transposes on ``len(xs)`` ranks, as rank gradients: ``dx``
    of ``sum(reduce_from(2 * xs[r]) * c)`` (JAX: ``2 * c`` on every rank)
    and ``dz`` of ``sum(copy_to(z) * ws[r])`` (JAX: ``sum(ws)`` on every
    rank). f32 numpy in and out."""
    return run_ranks(_rank_transposes, len(xs), xs, c, z, ws, device=device)


def all_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over ``group``, in place, summed in
    f32 whatever its dtype. (Collectives take contiguous tensors only; a
    gradient may come back with any strides.)"""
    n = dist.get_world_size(group)
    for t in tensors:
        f = t.detach().to(torch.float32, memory_format=torch.contiguous_format,
                          copy=True)
        dist.all_reduce(f, group=group)
        t.copy_(f / n)


def to_numpy(t: torch.Tensor):
    """A detached CPU numpy copy; bf16 goes through f32, which holds it."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def time_ms(fn: Callable[[], Any], device: torch.device, reps: int = 10,
            warmup: int = 2, group=None) -> float:
    """Time of one ``fn()`` in ms: after ``warmup`` calls, ``reps``
    back-to-back calls over the count. On the card between one pair of CUDA
    events; on the CPU on the host clock, with a barrier of ``group`` (the
    world unless given) on each side, so the slowest rank sets the time."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dist.barrier(group=group)
    return (time.perf_counter() - t0) * 1e3 / reps


def _union(spans: Sequence[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def step_timing(fn: Callable[[], Any], device: torch.device,
                reps: int = 20) -> dict:
    """``ms``: ``time_ms(fn)`` over ``reps`` calls. On the card also, per
    call, from ``reps`` more under ``torch.profiler``: ``window_ms`` (host
    clock over those calls, synchronized), ``busy_ms`` (the time in which
    at least one traced kernel or copy ran, any stream), ``ops`` (their
    count) and ``nccl_ms`` (the summed durations of NCCL's kernels, which
    include their wait for the other ranks). ``1 - busy_ms / window_ms``
    is the card's idle share."""
    out: dict[str, Any] = {"ms": time_ms(fn, device, reps=reps)}
    if device.type != "cuda":
        return out
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _union([(e.time_range.start, e.time_range.end) for e in ops])
    nccl = sum(e.time_range.elapsed_us() for e in ops
               if "nccl" in e.name.lower())
    out.update(window_ms=window * 1e3 / reps, busy_ms=busy / 1e3 / reps,
               ops=len(ops) / reps, nccl_ms=nccl / 1e3 / reps)
    return out


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
