#!/usr/bin/env python3
"""Drive the GPU port's main paths once on one NVIDIA card, and check them.

Run from the root of a checkout, on a machine with one CUDA device and the
CUDA toolkit: ``python3 chip_smoke.py``. The kernels are built from
``k8s_dra_driver_tpu_torch/csrc`` into ``k8s_dra_driver_tpu_torch/build``.
One line per phase:

1. device  the card's name and power limit (nvidia-smi); TF32 matmuls off
2. build   nvcc of every kernel source, all started together, with seconds;
           per kernel ptxas's registers, shared memory and spills, and its
           SASS count of warpgroup MMAs (HGMMA) and TMA loads (UTMALDG):
           every bf16 flash kernel must have both
3. check   the decode kernel against its plain PyTorch version on the card
           at the smoke's width (b=32, h=32, d=128, cap=4096, ragged
           lengths): f32 within 1e-4, bf16 within 2e-2, a poisoned cache
           tail changes the output by less than 1e-5, and a block_k that
           does not divide the cache raises ValueError; then a small engine
           on the card against the same engine on the CPU, step for step
4. timing  the decode kernel, its plain version and one library call, at
           the engine's shape, beside the least time the card could take
5. serve   a claim's CDI spec naming device 0, read back and bound to an
           engine at one attention layer of Llama-2-7B (32 heads of 128,
           a 4096-token cache, 32 slots) that serves 48 requests from 4
           tenants through the decode kernel
6. flash   the flash-attention kernel against its plain version
           (``reference_attention``) on the card at the compute bench's
           width [4, 8, 2048, 128], causal off and on: bf16 within
           4e-3 + 1e-2 |ref| and f32 within 2e-5 + 2e-5 |ref| (the JAX
           tests' f32 criterion) at every element; every compiled variant at
           small shapes, at S = 1 to 320 across the kernels' tile edges;
           block arguments that change nothing; causal row 0 equal to v's
           row 0; an indivisible S raising ValueError without a launch
7. bench   the compute bench's flash rows (the JAX bench's headline shape
           and its sweep, seq 512-8192 at b*seq = 8192, h = 8, d = 128, bf16,
           causal off and on): kernel, plain and library times beside the
           least time the card could take, and each row's kernel output held
           against its plain output within the bf16 limit above; then, at
           the headline, the kernel's and the library's device time per call
           from torch.profiler as a cross-check of the event times
8. burnin  ``entry()`` on the card against the same step on the CPU with
           the same weights, then the bf16 matmul chain (dim 8192, 256
           matmuls) in TFLOP/s

Kernel times are CUDA-event times of a run of back-to-back calls over the
count (``cuda_ms``). Each main path (serve, bench, burnin) runs with every
kernel's launch count set to 0 just before it and read just after. Then one
JSON line with every kernel's numbers, and the last line ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero before that line;
without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import zlib
from dataclasses import replace

import numpy as np
import torch

from k8s_dra_driver_tpu_torch.cdi.spec import CDIHandler, claim_edits_for
from k8s_dra_driver_tpu_torch.compute import _build
from k8s_dra_driver_tpu_torch.compute.burnin import matmul_flops_bench
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    decode_attention_reference,
    flash_attention,
    flash_attention_decode,
)
from k8s_dra_driver_tpu_torch.compute.ringattention import (
    reference_attention,
)
from k8s_dra_driver_tpu_torch.compute.serving import (
    DecodeRequest,
    ServingEngine,
    ServingMetrics,
    bind_engine,
    tenant_vector,
)
from k8s_dra_driver_tpu_torch.entry import entry

# The smoke's width: one attention layer of Llama-2-7B's published config
# (hidden 4096 = 32 heads x head_dim 128, max_position_embeddings 4096),
# with 32 sequences in flight.
BATCH, HEADS, HEAD_DIM, KV_CAP = 32, 32, 128, 4096
# H100 SXM published peaks: HBM bandwidth, f32 outside the tensor cores, and
# dense bf16 on the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989.4e12
# The compute bench's flash-attention headline shape [b, h, S, d], and its
# sweep: seq 512-8192 at a constant b * seq = 8192 tokens, h = 8, d = 128.
FLASH_SHAPE = (4, 8, 2048, 128)
FLASH_SWEEP_SEQS = (512, 1024, 2048, 4096, 8192)
# Sequence lengths of the flash check's small variants (tile edges).
FLASH_EDGE_SEQS = (1, 64, 100, 129, 192, 256, 320)
TENANTS = ("tenant-a", "tenant-b", "tenant-c", "tenant-d")

F32_TOL = 1e-4      # the JAX package's own decode-attention tolerance
BF16_TOL = 2e-2     # bf16 rounding of p and of the output differs by place
POISON_TOL = 1e-5
# (atol, rtol) of the flash kernel against its plain version. f32: the JAX
# package's flash-attention tolerance, as its tests apply it. bf16: the
# kernel and the plain version each round their f32 result to bf16 and may
# land one bf16 step apart (up to 2^-7 = 7.8e-3 of the value: rtol), and
# the kernel rounds each softmax weight to bf16 before P V (up to 2^-9 of
# the weight, which moves an output near zero by a few 1e-3: atol). A
# softmax scale 1% off, or one K tile left out, exceeds it.
FLASH_F32_TOL = (2e-5, 2e-5)
FLASH_BF16_TOL = (4e-3, 1e-2)
BURNIN_TOL = 3e-2
# cuda_ms's calls per timing: warm-up calls, then timed calls.
WARMUP_CALLS, TIMED_CALLS = 3, 30


def line(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, runs: int = TIMED_CALLS, warmup: int = WARMUP_CALLS
            ) -> float:
    """Device time of one call: after ``warmup`` calls and a synchronize,
    ``runs`` back-to-back calls between one pair of CUDA events, over the
    count. The host's time per call hides behind the device's unless it is
    the longer of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


KERNELS = {"decode_attention": flash_attention_decode,
           "flash_attention": flash_attention}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def compare(out: torch.Tensor, ref: torch.Tensor, atol: float,
            rtol: float | None = None) -> tuple:
    """(max |out - ref|, max |out - ref| / (atol + rtol |ref|)): the second
    is at most 1 where ``np.testing.assert_allclose(out, ref, rtol, atol)``
    passes. ``rtol`` defaults to ``atol``."""
    rtol = atol if rtol is None else rtol
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    over = (diff / (atol + rtol * ref.abs())).max().item()
    return diff.max().item(), over


def phase_device() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line("device", name=json.dumps(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print(card, flush=True)
    return card


def kernel_name(mangled: str, names: list) -> str:
    """``flash_bf16_kernel<128>`` from a mangled name, given the names of
    the source's kernels."""
    for name in names:
        i = mangled.find(name)
        if i >= 0:
            rest = mangled[i + len(name):]
            args = (re.findall(r"Li(\d+)E", rest.split("Ev", 1)[0])
                    if rest.startswith("I") else [])
            return f"{name}<{','.join(args)}>" if args else name
    return mangled


def phase_build() -> None:
    """Builds every kernel source; prints, for each kernel, ptxas's
    registers, static shared memory and spills, and how many of its SASS
    instructions are warpgroup MMAs (HGMMA) and TMA loads (UTMALDG). Every
    bf16 flash kernel must have both."""
    t0 = time.monotonic()
    built = _build.build_all(force=True)
    require(bool(built), "no kernel source was built")
    for name, (s, log) in sorted(built.items()):
        src = (_build.CSRC / f"{name}.cu").read_text()
        names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                           r"\s*)?(\w+)\s*\(", src)
        sass = {}
        for fn in _build.disassemble(name).split("Function : ")[1:]:
            sass[fn.split(None, 1)[0]] = (len(re.findall(r"\bHGMMA\.", fn)),
                                          len(re.findall(r"\bUTMALDG\.", fn)))
        chunks = log.split("Compiling entry function '")[1:]
        line("build", source=f"{name}.cu", seconds=f"{s:.2f}",
             kernels=len(chunks))
        for warning in re.findall(r".*warning.*", log, re.IGNORECASE):
            line("build", source=f"{name}.cu",
                 warning=json.dumps(warning.strip()))
        for chunk in chunks:
            mangled = chunk.split("'", 1)[0]
            kernel = kernel_name(mangled, names)
            regs = re.search(r"Used (\d+) registers", chunk)
            # A kernel with only dynamic shared memory reports no bytes.
            smem = re.search(r"(\d+) bytes smem", chunk)
            spills = sum(int(n) for n in
                         re.findall(r"(\d+) bytes spill", chunk))
            hgmma, utmaldg = sass.get(mangled, (0, 0))
            line("build", kernel=kernel,
                 registers=regs.group(1) if regs else "?",
                 static_smem_bytes=smem.group(1) if smem else 0,
                 spill_bytes=spills, sass_HGMMA=hgmma, sass_UTMALDG=utmaldg)
            if kernel.startswith("flash_bf16_kernel"):
                require(hgmma > 0 and utmaldg > 0,
                        f"{kernel} has no wgmma or no TMA load in its SASS")
    line("build", total_seconds=f"{time.monotonic() - t0:.2f}")


def smoke_lengths(rng: np.random.Generator) -> np.ndarray:
    """Ragged lengths: 1, one not aligned to a kernel tile, the full cache,
    and the rest uniform."""
    lens = rng.integers(1, KV_CAP + 1, size=BATCH).astype(np.int32)
    lens[:3] = (1, 1000, KV_CAP)
    return lens


def smoke_inputs(rng: np.random.Generator) -> tuple:
    """Seeded K/V caches at the smoke's width on the card, and lengths."""
    dev = torch.device("cuda", 0)
    lens = torch.from_numpy(smoke_lengths(rng)).to(dev)
    shape = (BATCH, HEADS, KV_CAP, HEAD_DIM)
    k = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
    return k, v, lens


def phase_check(rng: np.random.Generator, k, v, lens) -> float:
    """The checks at full width; returns the largest f32 error."""
    dev = k.device
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    worst_f32 = 0.0
    for ql in (1, 4):
        q = torch.from_numpy(rng.standard_normal(
            (BATCH, HEADS, ql, HEAD_DIM), np.float32)).to(dev)
        out = flash_attention_decode(q, k, v, lens)
        ref = decode_attention_reference(q, k, v, lens)
        torch.cuda.synchronize()
        require(out.shape == ref.shape and out.dtype == torch.float32,
                f"f32 output {out.shape} {out.dtype}")
        require(bool(torch.isfinite(out).all()), "f32 output not finite")
        e32 = (out - ref).abs().max().item()
        qb = q.to(torch.bfloat16)
        outb = flash_attention_decode(qb, kb, vb, lens)
        refb = decode_attention_reference(qb, kb, vb, lens)
        e16 = (outb.float() - refb.float()).abs().max().item()
        require(outb.dtype == torch.bfloat16, f"bf16 output {outb.dtype}")
        # Poison every key beyond each length: a masked read would swamp it.
        kp, vp = k.clone(), v.clone()
        for i, n in enumerate(lens.tolist()):
            kp[i, :, n:, :] = 1e6
            vp[i, :, n:, :] = -1e6
        ep = (flash_attention_decode(q, kp, vp, lens) - out).abs().max().item()
        del kp, vp
        line("check", kernel="decode_attention", ql=ql, f32_max_abs_err=e32,
             bf16_max_abs_err=e16, poisoned_tail_max_abs_diff=ep)
        require(e32 < F32_TOL, f"f32 error {e32} >= {F32_TOL} at ql={ql}")
        require(e16 < BF16_TOL, f"bf16 error {e16} >= {BF16_TOL} at ql={ql}")
        require(ep < POISON_TOL, f"poisoned tail moved the output by {ep}")
        worst_f32 = max(worst_f32, e32)
    # Every compiled variant at a small shape: each q_len (the kernel is
    # built for 1, 2, 4 and 8 rows), 16-byte and scalar loads (d = 66 is
    # not a multiple of a 16-byte vector), d up to 256, both dtypes.
    small = np.array([1, 45, 300], np.int32)
    worst = 0.0
    for ql in range(1, 9):
        for d in (66, 128, 256):
            args = [torch.from_numpy(a).to(dev) for a in (
                rng.standard_normal((3, 2, ql, d), np.float32),
                rng.standard_normal((3, 2, 300, d), np.float32),
                rng.standard_normal((3, 2, 300, d), np.float32), small)]
            for dtype, tol in ((torch.float32, F32_TOL),
                               (torch.bfloat16, BF16_TOL)):
                a = [t.to(dtype) for t in args[:3]] + args[3:]
                err = (flash_attention_decode(*a, block_k=300).float()
                       - decode_attention_reference(*a).float()
                       ).abs().max().item()
                require(err < tol, f"{dtype} ql={ql} d={d}: error {err}")
                worst = max(worst, err / tol)
    line("check", kernel="decode_attention", variants="ql 1-8 x d 66/128/256"
         " x f32/bf16", worst_err_over_tol=worst)
    before = flash_attention_decode.launches
    try:
        flash_attention_decode(q, k, v, lens, block_k=1000)
    except ValueError as e:
        line("check", block_k_error=json.dumps(str(e)))
    else:
        raise SystemExit("chip_smoke: FAILED: block_k=1000 did not raise")
    require(flash_attention_decode.launches == before,
            "a refused call launched the kernel")
    torch.cuda.synchronize()
    return worst_f32


def engine_parity() -> None:
    """A small engine on the card against the same engine on the CPU (the
    plain attend), driven step by step through one seeded stream."""
    rng = np.random.default_rng(3)
    reqs = [(f"r{i}", TENANTS[i % 4], int(rng.integers(3, 40)),
             int(rng.integers(1, 12))) for i in range(24)]
    runs = []
    for device in ("cuda:0", "cpu"):
        eng = ServingEngine("parity", n_chips=1, metrics=ServingMetrics(),
                            max_batch=6, kv_cap=64, heads=4, head_dim=32,
                            tokens_per_chip_step=24, modeled_chip_tok_s=1e9,
                            device=device)
        rs = [DecodeRequest(rid=r, tenant=t, prompt_tokens=p,
                            max_new_tokens=n) for r, t, p, n in reqs]
        for r in rs:
            eng.submit(r)
        while eng.completed < len(rs):
            require(eng.steps < 1000, f"{device} engine did not converge")
            eng.step()
        runs.append((eng, rs))
    (gpu, gpu_reqs), (cpu, cpu_reqs) = runs
    require(list(gpu.step_log) == list(cpu.step_log),
            "GPU and CPU engines' step logs differ")
    err = max(float(np.abs(a.last_output - b.last_output).max())
              for a, b in zip(gpu_reqs, cpu_reqs))
    line("check", engine_parity_steps=gpu.steps,
         last_output_max_abs_diff=err,
         kv_isolation_max_err=gpu.kv_isolation_max_err)
    require(err < 1e-5, f"GPU engine's outputs differ from the CPU's by {err}")
    require(gpu.kv_isolation_max_err < F32_TOL, "GPU engine mixed tenants")


def phase_timing(rng: np.random.Generator, k, v, lens) -> dict:
    """The kernel at the engine's shape (ql = 1, f32, ragged lengths)."""
    dev = k.device
    lens_np = lens.cpu().numpy()
    q = torch.from_numpy(rng.standard_normal(
        (BATCH, HEADS, 1, HEAD_DIM), np.float32)).to(dev)
    mask = (torch.arange(KV_CAP, device=dev)[None, None, None, :]
            < lens[:, None, None, None])
    ms = cuda_ms(lambda: flash_attention_decode(q, k, v, lens))
    plain_ms = cuda_ms(lambda: decode_attention_reference(q, k, v, lens))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    # Least time: each valid K/V row read once, q read and out written once;
    # 4*d flops per valid key per head (q.k and p.v), in f32.
    keys = int(np.minimum(lens_np, KV_CAP).sum()) * HEADS
    nbytes = keys * HEAD_DIM * 4 * 2 + 2 * q.numel() * 4 + lens.numel() * 4
    flops = keys * 4 * HEAD_DIM
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    flops_ms = flops / F32_FLOP_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    line("timing", kernel="decode_attention", kernel_ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, library="scaled_dot_product_attention",
         bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
         bound_basis="H100 SXM 3.35 TB/s HBM, 67 TFLOP/s f32",
         hbm_share=bound_ms / ms)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def randn(gen: torch.Generator, shape: tuple, dtype: torch.dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def phase_flash_check(seed: int) -> float:
    """The flash kernel against ``reference_attention`` on the card; returns
    the largest bf16 error at the bench's width."""
    gen = torch.Generator(device="cuda:0").manual_seed(seed)
    b, h, s, d = FLASH_SHAPE
    worst_bf16 = 0.0
    for dtype, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                       (torch.float32, FLASH_F32_TOL)):
        q, k, v = (randn(gen, FLASH_SHAPE, dtype) for _ in range(3))
        for causal in (False, True):
            out = flash_attention(q, k, v, causal=causal)
            ref = reference_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            require(out.shape == ref.shape and out.dtype == dtype,
                    f"flash output {tuple(out.shape)} {out.dtype}")
            require(bool(torch.isfinite(out).all()), "flash output not finite")
            err, over = compare(out, ref, *tol)
            line("flash", shape=json.dumps(list(FLASH_SHAPE)),
                 dtype=str(dtype)[6:], causal=causal, max_abs_err=err,
                 max_abs_ref=ref.float().abs().max().item(),
                 atol_rtol=json.dumps(tol), err_over_limit=over)
            require(over <= 1, f"flash {dtype} causal={causal}: error {err}, "
                               f"{over} of the limit (atol, rtol) = {tol}")
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
        del q, k, v, out, ref
    # Every compiled variant at small shapes: the kernel is built for head
    # dims up to 64, 128 and 256 (the larger of d and dv), in both dtypes.
    # The bf16 kernel takes 128 query rows a tile and 176 keys a tile (64
    # at 256): S = 1 and 64 are less than one tile, 64 is one 64-key tile,
    # 100, 129, 192, 256 and 320 leave a ragged last tile, and under causal
    # the 256 bucket's 128 query rows cross two 64-key tiles on the
    # diagonal. The f32 kernel's tiles are 32 wide.
    alt_dv = {32: 256, 64: 128, 128: 64, 256: 32}
    worst = 0.0
    for d in (32, 64, 128, 256):
        for dv in (d, alt_dv[d]):
            for s_small in FLASH_EDGE_SEQS:
                for dtype, tol in ((torch.float32, FLASH_F32_TOL),
                                   (torch.bfloat16, FLASH_BF16_TOL)):
                    q, k = (randn(gen, (2, 3, s_small, d), dtype)
                            for _ in range(2))
                    v = randn(gen, (2, 3, s_small, dv), dtype)
                    for causal in (False, True):
                        out = flash_attention(q, k, v, block_q=s_small,
                                              block_k=s_small, causal=causal)
                        ref = reference_attention(q, k, v, causal=causal)
                        err, over = compare(out, ref, *tol)
                        require(over <= 1, f"flash {dtype} d={d} dv={dv} "
                                           f"S={s_small} causal={causal}: "
                                           f"error {err}, {over} of the "
                                           f"limit")
                        worst = max(worst, over)
    line("flash", variants="d 32/64/128/256 x dv = d or not x S "
         + "/".join(map(str, FLASH_EDGE_SEQS)) + " x f32/bf16 x causal",
         worst_err_over_limit=worst)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (randn(gen, (2, 3, 256, 64), dtype) for _ in range(3))
        outs = [flash_attention(q, k, v, block_q=bq, block_k=bk, causal=True)
                for bq, bk in ((64, 128), (128, 64), (256, 256))]
        require(all(torch.equal(outs[0], o) for o in outs[1:]),
                f"{dtype}: causal output depends on the block arguments")
        out = flash_attention(q, q, q, causal=True)
        row0 = (out[:, :, 0] - q[:, :, 0]).abs().max().item()
        require(bool(torch.isfinite(out).all()) and torch.allclose(
            out[:, :, 0].float(), q[:, :, 0].float(), rtol=1e-5, atol=0),
            f"{dtype}: causal row 0 is not v's row 0 ({row0})")
        line("flash", dtype=str(dtype)[6:], blocks_identical=True,
             causal_row0_max_abs_diff=row0)
    before = flash_attention.launches
    q = randn(gen, (1, 1, 192, 32), torch.bfloat16)
    try:
        flash_attention(q, q, q, block_q=128, block_k=128)
    except ValueError as e:
        line("flash", indivisible_error=json.dumps(str(e)))
    else:
        raise SystemExit("chip_smoke: FAILED: S=192 with blocks of 128 did "
                         "not raise")
    require(flash_attention.launches == before,
            "a refused flash call launched the kernel")
    torch.cuda.synchronize()
    return worst_bf16


def flash_bench_row(gen: torch.Generator, b: int, h: int, s: int, d: int,
                    causal: bool) -> dict:
    """The kernel, its plain version and the library call at one shape; the
    last output of the timed kernel calls is held against the last of the
    plain version's."""
    q, k, v = (randn(gen, (b, h, s, d), torch.bfloat16) for _ in range(3))
    last = {}

    def kernel() -> None:
        last["out"] = flash_attention(q, k, v, causal=causal)

    def plain() -> None:
        last["ref"] = reference_attention(q, k, v, causal=causal)

    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    # Causal attends half the positions: half the useful flops. Bytes: q,
    # k, v read once and the output written once, in bf16.
    flops = 4 * b * h * s * s * d // (2 if causal else 1)
    nbytes = 4 * b * h * s * d * 2
    flops_ms = flops / BF16_FLOP_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    row = {"shape": [b, h, s, d], "causal": causal, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
           "tflops": flops / ms / 1e9, "library_tflops": flops / library_ms
           / 1e9, "bound_share": bound_ms / ms}
    err, over = compare(last["out"], last["ref"], *FLASH_BF16_TOL)
    line("bench", kernel="flash_attention", max_abs_err=err,
         err_over_limit=over, **{k: json.dumps(v) if isinstance(v, list)
                                 else v for k, v in row.items()})
    require(over <= 1, f"flash bench row {row['shape']} causal={causal}: "
                       f"error {err}, {over} of the limit")
    return row


def phase_flash_bench(seed: int) -> dict:
    """The compute bench's flash rows through the port's flash_attention:
    the headline shape, then the sweep. Its own main path: the counts are
    zeroed before it and read after it."""
    gen = torch.Generator(device="cuda:0").manual_seed(seed)
    reset_launches()
    head = flash_bench_row(gen, *FLASH_SHAPE, causal=False)
    rows = [flash_bench_row(gen, max(1, 8192 // s), 8, s, 128, causal)
            for s in FLASH_SWEEP_SEQS for causal in (False, True)]
    counts = launches()
    line("bench", launches=json.dumps(counts), sweep_rows=len(rows),
         bound_basis="H100 SXM 989.4 TFLOP/s dense bf16, 3.35 TB/s HBM")
    # Every timed row's calls went through the kernel, and nothing else did.
    calls = (1 + len(rows)) * (WARMUP_CALLS + TIMED_CALLS)
    require(counts == {"flash_attention": calls, "decode_attention": 0},
            f"the compute bench's launches: {counts}, expected {calls} of "
            f"flash_attention")
    # Cross-check of the headline's event times (after the counts are read):
    # the device time per call that torch.profiler traced.
    q, k, v = (randn(gen, FLASH_SHAPE, torch.bfloat16) for _ in range(3))
    busy_ms, _ = device_busy(lambda: flash_attention(q, k, v))
    lib_busy_ms, _ = device_busy(
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    line("bench", kernel="flash_attention",
         shape=json.dumps(list(FLASH_SHAPE)), event_ms=head["ms"],
         device_busy_ms=busy_ms or "not measured",
         library_event_ms=head["library_ms"],
         library_device_busy_ms=lib_busy_ms or "not measured")
    del q, k, v
    torch.cuda.empty_cache()
    return {**head, "launches": counts["flash_attention"], "rows": rows,
            "device_busy_ms": busy_ms, "library_device_busy_ms": lib_busy_ms}


def device_busy(fn, calls: int = 20) -> tuple:
    """(device ms per call, device operations per call): the summed
    durations of the kernels and copies that ``torch.profiler`` traced on
    the card over ``calls`` calls. (0.0, 0.0) when it traced none."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    return busy_us / 1e3 / calls, len(ops) / calls


def phase_burnin() -> None:
    """``entry()`` on the card against the same step on the CPU, then the
    bf16 matmul chain. No kernel of the port runs here (the JAX block's
    matmuls and softmax are XLA's, the port's torch's)."""
    reset_launches()
    fn, (params, x) = entry()
    require(x.is_cuda and all(w.is_cuda for w in params.values()),
            "entry() did not place its arguments on the card")
    out = fn(params, x)
    torch.cuda.synchronize()
    counts = launches()
    require(out.shape == (8, 128, 512) and out.dtype == torch.bfloat16,
            f"burn-in output {tuple(out.shape)} {out.dtype}")
    require(bool(torch.isfinite(out.float()).all()), "burn-in not finite")
    cpu = fn({n: w.cpu() for n, w in params.items()}, x.cpu())
    err, over = compare(out.cpu(), cpu, BURNIN_TOL)
    step_ms = cuda_ms(lambda: fn(params, x))
    busy_ms, kernels = device_busy(lambda: fn(params, x))
    line("burnin", shape=json.dumps(list(out.shape)), dtype="bfloat16",
         gpu_vs_cpu_max_abs_err=err, tol=BURNIN_TOL, err_over_limit=over,
         step_ms=step_ms,
         device_busy_ms=busy_ms if kernels else "not measured",
         device_ops_per_step=kernels,
         idle_share=1 - busy_ms / step_ms if kernels else "not measured",
         launches=json.dumps(counts))
    require(over <= 1, f"burn-in on the card differs from the CPU by {err}")
    mm = matmul_flops_bench(dim=8192, n_iters=256)
    line("burnin", matmul_dim=int(mm["dim"]), matmul_iters=int(mm["iters"]),
         seconds=mm["seconds"], tflops=mm["tflops"],
         peak_share=mm["tflops"] * 1e12 / BF16_FLOP_S,
         peak_basis="H100 SXM 989.4 TFLOP/s dense bf16")
    require(math.isfinite(mm["tflops"]) and mm["tflops"] > 0,
            f"matmul bench gave {mm['tflops']} TFLOP/s")


def phase_serve(seed: int) -> dict:
    require(len({zlib.crc32(t.encode()) % 16 for t in TENANTS})
            == len(TENANTS), "tenants share an isolation-oracle bucket")
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as cdi_root:
        cdi = CDIHandler(cdi_root)
        uid = "smoke-claim-0"
        devices, claim_edits = claim_edits_for([0], [0])
        devices = [replace(d, name=cdi.claim_device_name(uid, d.name))
                   for d in devices]
        ids = cdi.create_claim_spec_file(uid, devices,
                                         claim_edits=claim_edits)
        spec = cdi.read_claim_spec(uid)
        engine = bind_engine(
            spec, "smoke", metrics=ServingMetrics(), max_batch=BATCH,
            kv_cap=KV_CAP, heads=HEADS, head_dim=HEAD_DIM,
            tokens_per_chip_step=2048, queue_cap=64,
            modeled_chip_tok_s=1e9)
        cdi.delete_claim_spec_file(uid)
    line("serve", cdi_ids=json.dumps(ids), device=str(engine.device),
         n_chips=engine.n_chips,
         kv_slab_gb=2 * engine._K.numel() * 4 / 1e9)
    require(engine.device == torch.device("cuda", 0),
            f"engine bound to {engine.device}")

    step_ms: list[float] = []
    inner = engine.step

    def timed_step() -> int:
        t0 = time.perf_counter()
        spent = inner()
        if spent:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return spent

    engine.step = timed_step
    rng = np.random.default_rng(seed)
    prompts = rng.integers(512, 3073, size=48)
    reqs = [DecodeRequest(rid=f"r{i}", tenant=TENANTS[i % 4],
                          prompt_tokens=int(p), max_new_tokens=64)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    engine.start()
    for r in reqs:
        require(engine.submit(r), f"request {r.rid} rejected")
    deadline = t0 + 600
    while engine.completed < len(reqs) and time.monotonic() < deadline:
        require(engine._thread.is_alive(), "the engine thread died")
        time.sleep(0.005)
    wall = time.monotonic() - t0
    summary = engine.drain(timeout=60)
    counts = launches()
    n_launches = counts["decode_attention"]
    decode_steps = sum(1 for e in engine.step_log if e["decode_tokens"])
    mem_gb = torch.cuda.memory_allocated() / 1e9
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    line("serve", submitted=summary["submitted"],
         completed=summary["completed"], shed=summary["shed"],
         rejected=summary["rejected"], accounted=summary["accounted"],
         steps=engine.steps, decode_steps=decode_steps,
         kernel_launches=json.dumps(counts), wall_s=wall,
         decode_tok_s=summary["decode_tokens"] / wall,
         prefill_tok_s=summary["prefill_tokens"] / wall,
         step_ms_p50=float(np.percentile(step_ms, 50)),
         step_ms_p99=float(np.percentile(step_ms, 99)),
         step_samples=len(step_ms),
         kv_isolation_max_err=engine.kv_isolation_max_err,
         mem_allocated_gb=mem_gb, mem_peak_gb=peak_gb)
    require(summary["completed"] == summary["submitted"] == len(reqs),
            f"completed {summary['completed']} of {summary['submitted']}")
    require(summary["accounted"], "accounting identity broken")
    require(engine.kv_isolation_max_err < F32_TOL,
            f"kv_isolation_max_err {engine.kv_isolation_max_err}")
    require(n_launches == decode_steps > 0,
            f"{n_launches} kernel launches for {decode_steps} decode steps")
    for r in reqs:
        vec = tenant_vector(r.tenant, HEAD_DIM)
        require(r.last_output is not None
                and r.last_output.shape == (HEADS, HEAD_DIM)
                and bool(np.isfinite(r.last_output).all())
                and float(np.abs(r.last_output - vec).max()) < F32_TOL,
                f"request {r.rid} decoded a wrong row")
    return {"launches": n_launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    phase_device()
    phase_build()
    rng = np.random.default_rng(args.seed)
    k, v, lens = smoke_inputs(rng)
    max_abs_err = phase_check(rng, k, v, lens)
    timing = phase_timing(rng, k, v, lens)
    del k, v, lens
    torch.cuda.empty_cache()
    engine_parity()
    served = phase_serve(args.seed)
    flash_err = phase_flash_check(args.seed)
    flash = phase_flash_bench(args.seed)
    phase_burnin()
    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/csrc/decode_attention.cu",
        "replaces": "k8s_dra_driver_tpu/compute/flashattention.py:125",
        "launches": served["launches"], "max_abs_err": max_abs_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/csrc/flash_attention.cu",
        "replaces": "k8s_dra_driver_tpu/compute/flashattention.py:36",
        "launches": flash["launches"], "max_abs_err": flash_err,
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
    }]
    require(all(math.isfinite(v) for k in kernels for v in
                (k["ms"], k["plain_ms"], k["bound_ms"], k["library_ms"])),
            "non-finite time")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
