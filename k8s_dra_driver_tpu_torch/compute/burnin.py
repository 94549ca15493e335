"""Single-device burn-in workloads: the healthcheck block and a matmul bench.

The JAX package's ``compute/burnin.py`` in PyTorch. ``burnin_step`` is one
pre-LN attention + MLP block in bf16: a device that runs it has working
memory, tensor cores and vector units. Its matmuls are ``torch.matmul``, as
the JAX block leaves them to XLA; no kernel of the port runs here. The bf16
rounding points are the JAX block's: logits in bf16 divided by sqrt(d)
rounded to bf16, softmax in f32 cast back to bf16, the norm in f32 with a
bf16 result, GELU in its tanh form (``jax.nn.gelu``'s default).

``matmul_flops_bench`` times a chain of dependent [dim x dim] matmuls and
fences each timed run with a host readback of an f32 sum that depends on
every matmul.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from k8s_dra_driver_tpu_torch.compute._device import _resolve_device

_NAMES = ("wq", "wk", "wv", "wo", "w1", "w2")


def transformer_block_params(
        d_model: int = 512, d_ff: int = 2048,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device, None] = None,
) -> dict[str, torch.Tensor]:
    """Pre-LN block weights, N(0, 0.02^2) drawn in f32 and stored in bf16,
    on ``device`` (the current CUDA device unless it says otherwise).
    ``generator`` is a CPU generator (seed 0 when None)."""
    dev = _resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    shapes = {"wq": (d_model, d_model), "wk": (d_model, d_model),
              "wv": (d_model, d_model), "wo": (d_model, d_model),
              "w1": (d_model, d_ff), "w2": (d_ff, d_model)}
    return {name: (torch.randn(shapes[name], generator=generator) * 0.02)
            .to(torch.bfloat16).to(dev) for name in _NAMES}


def params_from_numpy(params: dict, device: Union[str, torch.device, None]
                      = None) -> dict[str, torch.Tensor]:
    """The JAX block's weights, held as numpy arrays, as the port's bf16
    tensors on ``device``. bf16 goes through f32, which holds it exactly."""
    dev = _resolve_device(device)
    return {name: torch.from_numpy(np.asarray(params[name], np.float32))
            .to(torch.bfloat16).to(dev) for name in _NAMES}


def _rmsnorm(x: torch.Tensor) -> torch.Tensor:
    # Norm math in f32 for stability, output back in x's dtype.
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + 1e-6)
    return (xf * scale).to(x.dtype)


def transformer_block(params: dict[str, torch.Tensor],
                      x: torch.Tensor) -> torch.Tensor:
    """One pre-LN attention + MLP block. ``x``: [batch, seq, d_model] bf16."""
    h = _rmsnorm(x)
    q = h @ params["wq"]
    k = h @ params["wk"]
    v = h @ params["wv"]
    # sqrt(d_head) rounded to q's dtype (22.625 at 512 in bf16), computed on
    # the host so that the step has no host-to-device copy.
    root = torch.tensor(float(q.shape[-1])).sqrt().to(q.dtype).item()
    logits = torch.einsum("bsd,btd->bst", q, k) / root
    attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    x = x + (attn @ v) @ params["wo"]
    h = _rmsnorm(x)
    return x + F.gelu(h @ params["w1"], approximate="tanh") @ params["w2"]


def burnin_step(params: dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """The healthcheck workload: one block forward."""
    return transformer_block(params, x)


def matmul_flops_bench(dim: int = 4096, n_iters: int = 32,
                       dtype: torch.dtype = torch.bfloat16,
                       device: Union[str, torch.device, None] = None,
                       reps: int = 3) -> dict[str, float]:
    """Time a chain of ``n_iters`` dependent [dim x dim] matmuls on
    ``device``; returns the best of ``reps`` timed runs as seconds and
    TFLOP/s, with ``dim`` and ``iters``.

    ``b`` is scaled by 1/sqrt(dim) so that the chain's magnitude stays O(1)
    (an unscaled bf16 chain overflows within a few hops). Each run ends in
    a host readback of the f32 sum of the result, which depends on every
    matmul: the fence. A first untimed run warms up and checks for NaN."""
    dev = _resolve_device(device)
    gen = torch.Generator(device=dev)
    a = torch.randn((dim, dim), generator=gen.manual_seed(1), device=dev
                    ).to(dtype)
    b = (torch.randn((dim, dim), generator=gen.manual_seed(2), device=dev)
         / dim ** 0.5).to(dtype)

    def chain_sum() -> float:
        out = a
        for _ in range(n_iters):
            out = out @ b
        return float(out.float().sum())

    s = chain_sum()
    if s != s:
        raise RuntimeError("matmul bench produced NaN")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        chain_sum()
        best = min(best, time.perf_counter() - t0)
    flops = 2.0 * dim * dim * dim * n_iters
    return {
        "seconds": best,
        "tflops": flops / best / 1e12,
        "dim": float(dim),
        "iters": float(n_iters),
    }
