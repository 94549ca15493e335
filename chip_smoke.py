#!/usr/bin/env python3
"""Drive the GPU port's main paths once on one NVIDIA card, and check them.

Run from the root of a checkout, on a machine with one CUDA device and the
CUDA toolkit: ``python3 chip_smoke.py``. The kernels are built from
``k8s_dra_driver_tpu_torch/csrc`` into ``k8s_dra_driver_tpu_torch/build``.
One line per phase:

1. device  the card's name and power limit (nvidia-smi); TF32 matmuls off
   enumerate  the GPU device library on the machine's own roots (the
           default backend, and NVML where libnvidia-ml.so.1 is present):
           every GPU with uuid, minor, PCI address and device id, memory and
           backend; the card torch uses must be found, with its UUID,
           memory within 1% of torch's and its /dev/nvidia<minor> node
2. build   nvcc of every kernel source, all started together, with seconds;
           per kernel ptxas's registers, shared memory and spills, and its
           SASS count of warpgroup MMAs (HGMMA) and TMA loads (UTMALDG):
           every bf16 flash kernel must have both
3. check   the decode kernel against its plain PyTorch version on the card
           at the smoke's width (b=32, h=32, d=128, cap=4096, ragged
           lengths): f32 within 1e-4, bf16 within 2e-2, a poisoned cache
           tail changes the output by less than 1e-5, and a block_k that
           does not divide the cache raises ValueError; every compiled
           variant at small shapes, with v's head dim unlike k's and 16 or
           20 query rows (launched 8 rows at a time); then a small engine
           on the card against the same engine on the CPU, step for step
4. timing  the decode kernel, its plain version and one library call, at
           the engine's shape, beside the least time the card could take
5. serve   the claim path: a ResourceClaim for that card (CEL on its UUID)
           allocated, prepared by the GPU kubelet plugin through the claim
           watcher into a CDI spec naming it, read back and bound to an
           engine at one attention layer of Llama-2-7B (32 heads of 128,
           a 4096-token cache, 32 slots) that serves 48 requests from 4
           tenants through the decode kernel; then drained, unreserved,
           unprepared and deleted with nothing left behind (claim_ready_ms,
           ttfb_ms: claim create to Ready, to the first decoded batch)
   servesmoke  the port's run_serving_smoke() on the card: ok, accounted,
           no leaks, isolation error under 1e-4; then the decode kernel
           against its plain version at that session's shapes (q [8, 2,
           ql, 8] for ql 1-8, a 32-token cache, random K/V, ragged
           lengths): f32 within 1e-4, bf16 within 2e-2
6. flash   the flash-attention kernel against its plain version
           (``reference_attention``) on the card at the compute bench's
           width [4, 8, 2048, 128], causal off and on: bf16 within
           4e-3 + 1e-2 |ref| and f32 within 2e-5 + 2e-5 |ref| (the JAX
           tests' f32 criterion) at every element; every compiled variant at
           small shapes, at S = 1 to 320 across the kernels' tile edges;
           head dims 8, 40 and 24 that the wrapper zero-pads to multiples of
           16, within the same limits;
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
9. selfheal  a GPU fault under a served claim, healed: the GPU plugin on
           the device library that found the card, with its health monitor
           (holding NVML's event session: its status is printed), the
           claim watcher, the drain controller, the reallocator, a node
           lease and the lifecycle controller, and a canary prober. A
           claim for the card serves 16 requests through the decode kernel
           at the serve phase's width; the ``gpulib.gpu.unhealthy`` fault
           point taints the card and the claim is drained (the probe
           NOT_SERVING), a canary probe fails in admission, the repair
           lets the card rejoin, the claim is Ready again on it and a new
           engine serves 16 more; canary probes pass on the free and the
           repaired card; prints detect_ms, drain_ms, rejoin_ms, outage_ms
           and ttfb_after_ms, and requires no residue and no thread left
10. computedomain  a ComputeDomain of this node: the CD kubelet plugin on
           the device library that found the card, the controller's live
           loop reconciling a CD of numNodes 1, and one daemon reporting the
           card's health and the address 127.0.0.1. A channel claim from
           the controller's template is refused (retryably, the node
           labelled) while the CD is not Ready and prepares once it is;
           prints cd_ready_ms (CD created to Ready) and channel_ready_ms
           (claim created to prepared) with the card, and the claim's
           rendezvous env (MASTER_ADDR, MASTER_PORT, NNODES, NODE_RANK)
   multigpu  the multi-GPU compute plane, one NCCL rank per card: the dry
           run ``dryrun_multichip(device_count)`` (its step 1 on mock
           nodes), its ranks started from that claim's env at world
           NNODES x device_count; the sharded dp x tp step at
           ``train_state``'s widths (d_model 256, d_ff 1024, vocab 512,
           8 x 16 tokens) on the card against the same step on 4 gloo ranks
           (dp 2 x tp 2) from the same numpy weights and batch: loss within
           2e-5, every updated weight within 1e-5; the MoE layer (ep 1 on
           the card, dp 2 x ep 2 on the CPU) and the pipeline (pp 1 against
           ``pipeline_reference``) at the dry run's widths, f32 within 2e-5;
           the data-parallel ResNet at ``resnet_params``' defaults (depth 4,
           32 channels, 16 x 16 images, bf16; dp 1 against dp 2) within
           3e-2; the two training steps' ``cuda_ms`` with the profiler's
           device-busy ms, operations and NCCL ms per step; ring attention
           at the ring bench's rows (b 1, h 4, d 64, seq 1024-8192, f32,
           sp 1) within 2e-5 of ``reference_attention``, with both times
           and peak memory; ``psum_bench`` refusing one GPU, and the
           modeled all-reduce of an ``h100-8`` node at 256 MiB. No kernel
           of the port is on this path, and its ranks are processes of
           their own. After it the channel claim is unprepared and deleted,
           the CD torn down, the daemon's and the controller's threads
           stopped, and nothing of them may be left
11. leftovers  the ranks' fork server stopped and waited for; no child
           process of the script may be left

Kernel times are CUDA-event times of a run of back-to-back calls over the
count (``cuda_ms``). Each main path of a kernel (serve, servesmoke, bench,
burnin, and each of selfheal's two batches) runs
with every kernel's launch count set to 0 just before it and read just
after. Then one
JSON line with every kernel's numbers, and the last line ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero before that line;
without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from k8s_dra_driver_tpu_torch.cdi.spec import claim_spec_env
from k8s_dra_driver_tpu_torch.compute import _build, _dist
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
    visible_device_entries,
)
from k8s_dra_driver_tpu_torch.compute import (
    collectives,
    moe,
    pipeline,
    resnet,
    ringattention,
    sharded,
)
from k8s_dra_driver_tpu_torch.api.computedomain import (
    NODE_LABEL_CD,
    STATUS_READY,
    cd_status,
    clique_daemons,
    new_compute_domain,
)
from k8s_dra_driver_tpu_torch.entry import (
    CHANNEL_CLASS,
    dryrun_multichip,
    entry,
)
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    BACKEND_NVML,
    BACKEND_PROCFS,
    MockDeviceLib,
    find_nvml,
    host_device_libs,
    locate_gpu,
)
from k8s_dra_driver_tpu_torch.internal.stresslab import (
    SERVING_SMOKE_ENGINE,
    run_serving_smoke,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ClaimReallocator,
    DrainController,
    SimulatedRepair,
    parse_gpu_index,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import bootid, faultpoints
from k8s_dra_driver_tpu_torch.pkg.canary import (
    CanaryProber,
    driver_probe_hooks,
)
from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
from k8s_dra_driver_tpu_torch.pkg.metrics import RemediationMetrics
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    NodeLeaseHeartbeat,
    NodeLifecycleController,
    fence_cleanup_for,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller import (
    ComputeDomainController,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
    ComputeDomainDaemon,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
    MASTER_PORT,
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health import (
    TAINT_KEY_XID,
    attach_health_monitor,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck import (
    STATUS_NOT_SERVING,
    STATUS_SERVING,
    driver_probe,
)

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
# The multi-GPU plane's limits, the JAX tests' and its port tests': f32
# outputs and losses, f32 weights after one SGD step, bf16 (the ResNet).
MULTI_F32_TOL, MULTI_PARAM_TOL, MULTI_BF16_TOL = 2e-5, 1e-5, 3e-2
# The ring bench's rows (the JAX bench's b, h, d and sequences).
RING_SEQS = (1024, 2048, 4096, 8192)
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


def torch_uuid(index: int) -> str:
    """``GPU-<uuid>`` of torch's device ``index``."""
    u = str(torch.cuda.get_device_properties(index).uuid)
    return u if u.upper().startswith("GPU-") else f"GPU-{u}"


def phase_enumerate() -> dict:
    """The device library on the machine's own roots. Every GPU that each
    backend ``locate_gpu`` tries finds is printed (the default backend,
    and NVML where ``libnvidia-ml.so.1`` is present); then ``locate_gpu``
    must find the card torch uses (``cuda:0``) by its UUID, with memory
    within 1% of torch's total and its ``/dev/nvidia<minor>`` node.
    Returns that GPU and the library that found it."""
    want = torch_uuid(0)
    total = torch.cuda.get_device_properties(0).total_memory
    line("enumerate", torch_uuid=want, torch_total_memory=total,
         nvml=json.dumps(find_nvml() or ""))
    for lib in host_device_libs():
        gpus = lib.enumerate_gpus()
        line("enumerate", backend=lib.backend, gpus=len(gpus))
        for g in gpus:
            line("enumerate", backend=lib.backend, index=g.index, uuid=g.uuid,
                 minor=g.minor, pci_address=g.pci_address or "not reported",
                 pci_device_id=(f"0x{g.pci_device_id:04x}"
                                if g.pci_device_id else "not reported"),
                 product=json.dumps(g.product_name),
                 memory_bytes=g.memory_bytes, numa_node=g.numa_node,
                 driver_version=g.driver_version)
    lib, gpu = locate_gpu(want)
    share = abs(gpu.memory_bytes - total) / total
    node = f"/dev/nvidia{gpu.minor}"
    line("enumerate", used_backend=lib.backend, uuid=gpu.uuid,
         minor=gpu.minor, pci_device_id=(f"0x{gpu.pci_device_id:04x}"
                                         if gpu.pci_device_id
                                         else "not reported"),
         memory_vs_torch=share, device_node=node)
    require(gpu.uuid.lower() == want.lower(),
            f"locate_gpu returned {gpu.uuid}, not {want}")
    require(share < 0.01, f"memory {gpu.memory_bytes} is {share:.2%} off "
                          f"torch's {total}")
    require(os.path.exists(node), f"{node} does not exist")
    return {"lib": lib, "gpu": gpu}


def kernel_name(mangled: str, names: list) -> str:
    """``flash_bf16_kernel<128>`` from a mangled name, given the names of
    the source's kernels."""
    for name in names:
        i = mangled.find(name)
        if i >= 0:
            rest = mangled[i + len(name):]
            args = (re.findall(r"L[ib](\d+)E", rest.split("Ev", 1)[0])
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
    # The shapes beyond one launch that the JAX function takes: v's head dim
    # unlike k's, and more than 8 query rows, which the wrapper launches in
    # groups of 8 (ql 16: two launches; ql 20: three, the last of 4 rows).
    worst = 0.0
    for ql, d, dv in ((1, 64, 128), (4, 128, 64), (2, 66, 130), (16, 128, 128),
                      (20, 64, 32)):
        args = [torch.from_numpy(a).to(dev) for a in (
            rng.standard_normal((3, 2, ql, d), np.float32),
            rng.standard_normal((3, 2, 300, d), np.float32),
            rng.standard_normal((3, 2, 300, dv), np.float32), small)]
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            a = [t.to(dtype) for t in args[:3]] + args[3:]
            before = flash_attention_decode.launches
            out = flash_attention_decode(*a, block_k=300)
            groups = flash_attention_decode.launches - before
            ref = decode_attention_reference(*a)
            require(out.shape == ref.shape == (3, 2, ql, dv),
                    f"ql={ql} d={d} dv={dv}: output {tuple(out.shape)}")
            err = (out.float() - ref.float()).abs().max().item()
            require(err < tol, f"{dtype} ql={ql} d={d} dv={dv}: error {err}")
            require(groups == -(-ql // 8), f"ql={ql}: {groups} launches")
            worst = max(worst, err / tol)
    line("check", kernel="decode_attention",
         variants="dv != d and ql 16/20 (launches of 8 rows) x f32/bf16",
         worst_err_over_tol=worst)
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
    # Head dims that are not multiples of 16, which the wrapper zero-pads
    # to the next (8 -> 16, 40 -> 48, 24 -> 32) with the scale of the true d.
    worst = 0.0
    for d, dv in ((40, 40), (8, 8), (40, 24)):
        for s_small in (64, 129):
            for dtype, tol in ((torch.float32, FLASH_F32_TOL),
                               (torch.bfloat16, FLASH_BF16_TOL)):
                q, k = (randn(gen, (2, 3, s_small, d), dtype)
                        for _ in range(2))
                v = randn(gen, (2, 3, s_small, dv), dtype)
                for causal in (False, True):
                    out = flash_attention(q, k, v, block_q=s_small,
                                          block_k=s_small, causal=causal)
                    ref = reference_attention(q, k, v, causal=causal)
                    require(out.shape == ref.shape and out.is_contiguous(),
                            f"flash d={d} dv={dv}: {tuple(out.shape)}")
                    err, over = compare(out, ref, *tol)
                    require(over <= 1, f"flash {dtype} d={d} dv={dv} "
                                       f"S={s_small} causal={causal}: "
                                       f"error {err}, {over} of the limit")
                    worst = max(worst, over)
    line("flash", variants="padded head dims d/dv 40/40, 8/8, 40/24 x S "
         "64/129 x f32/bf16 x causal", worst_err_over_limit=worst)
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


def _claim_ready(client, name: str) -> bool:
    """Whether the claim's status carries the GPU driver's Ready entry."""
    c = client.try_get("ResourceClaim", name, "default") or {}
    return any(d.get("driver") == DRIVER_NAME and any(
        k.get("type") == "Ready" and k.get("status") == "True"
        for k in d.get("conditions") or [])
        for d in (c.get("status") or {}).get("devices") or [])


def _wait(cond, what: str, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        require(time.monotonic() < deadline, f"{what} within {timeout} s")
        time.sleep(0.001)


def phase_serve(seed: int, lib, gpu) -> dict:
    """The claim path into the engine: a FakeClient with the gpu.nvidia.com
    DeviceClass, the GPU kubelet plugin on the device library that found
    the card, and the claim watcher. A ResourceClaim for the card torch uses
    (a CEL selector on its UUID) is allocated, prepared and read back as a
    CDI spec, and ``bind_engine`` binds the engine to the GPU the spec
    names. Then one attention layer of Llama-2-7B serves 48 requests from 4
    tenants through the decode kernel, and the claim is drained, unreserved,
    unprepared and deleted, leaving nothing behind."""
    require(len({zlib.crc32(t.encode()) % 16 for t in TENANTS})
            == len(TENANTS), "tenants share an isolation-oracle bucket")
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        client = FakeClient()
        client.create(new_object(
            "DeviceClass", DRIVER_NAME, spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        client.create(new_object("Node", "node-0"))
        driver = GpuDriver(client, DriverConfig(
            node_name="node-0", state_dir=f"{tmp}/state",
            cdi_root=f"{tmp}/cdi", env={}, retry_timeout=5.0),
            device_lib=lib).start()
        loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0",
                               namespace="default").start()
        try:
            served = _serve_claim(seed, client, driver, gpu)
        finally:
            loop.stop()
            driver.stop()
        residue = ([c["metadata"]["name"]
                    for c in client.list("ResourceClaim")]
                   + sorted(driver.state.prepared_claims_nolock())
                   + driver.cdi.list_claim_uids()
                   + sorted(p.name for p in driver.cdi.cdi_root.iterdir()))
    line("serve", residue=json.dumps(residue))
    require(not residue, f"left behind: {residue}")
    return served


def tenant_requests(rng: np.random.Generator, n: int, prefix: str,
                    prompts: tuple = (512, 3072), new_tokens: int = 64
                    ) -> list:
    """``n`` requests from the 4 tenants in turn, prompts uniform in
    ``prompts`` (inclusive), ``new_tokens`` each."""
    lengths = rng.integers(prompts[0], prompts[1] + 1, size=n)
    return [DecodeRequest(rid=f"{prefix}{i}", tenant=TENANTS[i % 4],
                          prompt_tokens=int(p), max_new_tokens=new_tokens)
            for i, p in enumerate(lengths)]


def serve_requests(engine, reqs: list, what: str,
                   timeout: float = 600) -> float:
    """Start ``engine`` with every kernel's launch count at 0, submit
    ``reqs`` and wait until all have completed; the engine keeps running.
    Returns the seconds from the start to the last completion."""
    reset_launches()
    t1 = time.monotonic()
    engine.start()
    for r in reqs:
        require(engine.submit(r), f"{what}: request {r.rid} rejected")
    deadline = t1 + timeout
    while engine.completed < len(reqs) and time.monotonic() < deadline:
        require(engine._thread.is_alive(), f"{what}: the engine thread died")
        time.sleep(0.005)
    return time.monotonic() - t1


def finish_engine(engine) -> dict:
    """Drain ``engine`` and read the launch counts of its run: its
    summary, the counts and its decode steps."""
    summary = engine.drain(timeout=60)
    return {"summary": summary, "counts": launches(),
            "decode_steps": sum(1 for e in engine.step_log
                                if e["decode_tokens"])}


def check_served(engine, done: dict, reqs: list, what: str) -> None:
    """The serve checks: every request completed, the accounting identity,
    ``kv_isolation_max_err`` under F32_TOL, decode kernel launches equal
    to decode steps (none on a CPU engine: the plain version runs there),
    and every request's last output row its tenant's vector."""
    summary, counts = done["summary"], done["counts"]
    n_launches, decode_steps = counts["decode_attention"], done["decode_steps"]
    require(summary["completed"] == summary["submitted"] == len(reqs),
            f"{what}: completed {summary['completed']} of "
            f"{summary['submitted']}")
    require(summary["accounted"], f"{what}: accounting identity broken")
    require(engine.kv_isolation_max_err < F32_TOL,
            f"{what}: kv_isolation_max_err {engine.kv_isolation_max_err}")
    want = decode_steps if engine.device.type == "cuda" else 0
    require(n_launches == want and decode_steps > 0,
            f"{what}: {n_launches} kernel launches for {decode_steps} "
            "decode steps")
    for r in reqs:
        vec = tenant_vector(r.tenant, engine.head_dim)
        require(r.last_output is not None
                and r.last_output.shape == (engine.heads, engine.head_dim)
                and bool(np.isfinite(r.last_output).all())
                and float(np.abs(r.last_output - vec).max()) < F32_TOL,
                f"{what}: request {r.rid} decoded a wrong row")


def _serve_claim(seed: int, client, driver, gpu) -> dict:
    name = "smoke-claim"
    t0 = time.monotonic()
    claim = client.create(new_object(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{"name": "gpu", "exactly": {
            "deviceClassName": DRIVER_NAME, "allocationMode": "ExactCount",
            "count": 1, "selectors": [{"cel": {"expression":
                f"device.attributes['uuid'] == '{gpu.uuid}'"}}]}}]}}))
    claim = Allocator(client).allocate(
        claim, reserved_for=[{"resource": "pods", "name": "smoke-pod"}],
        node="node-0")
    uid = claim["metadata"]["uid"]
    _wait(lambda: _claim_ready(client, name), "claim Ready")
    claim_ready_ms = (time.monotonic() - t0) * 1e3
    spec = driver.cdi.read_claim_spec(uid)
    entries = visible_device_entries(spec)
    engine = bind_engine(
        spec, "smoke", metrics=ServingMetrics(), max_batch=BATCH,
        kv_cap=KV_CAP, heads=HEADS, head_dim=HEAD_DIM,
        tokens_per_chip_step=2048, queue_cap=64, modeled_chip_tok_s=1e9)
    results = claim["status"]["allocation"]["devices"]["results"]
    line("serve", claim=name, device=results[0]["device"],
         cuda_visible_devices=json.dumps(entries),
         engine_device=str(engine.device), n_chips=engine.n_chips,
         kv_slab_gb=2 * engine._K.numel() * 4 / 1e9,
         claim_ready_ms=claim_ready_ms)
    require(entries == [gpu.uuid], f"the spec names {entries}, not "
                                   f"{gpu.uuid}")
    require(engine.device == torch.device("cuda", 0),
            f"engine bound to {engine.device}, not the spec's GPU cuda:0")

    step_ms: list[float] = []
    inner = engine.step

    def timed_step() -> int:
        t = time.perf_counter()
        spent = inner()
        if spent:
            step_ms.append((time.perf_counter() - t) * 1e3)
        return spent

    engine.step = timed_step
    rng = np.random.default_rng(seed)
    reqs = tenant_requests(rng, 48, "r")
    torch.cuda.reset_peak_memory_stats()
    wall = serve_requests(engine, reqs, "serve")
    done = finish_engine(engine)
    summary, counts = done["summary"], done["counts"]
    n_launches = counts["decode_attention"]
    mem_gb = torch.cuda.memory_allocated() / 1e9
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ttfb_ms = (engine.first_batch_t - t0) * 1e3
    line("serve", submitted=summary["submitted"],
         completed=summary["completed"], shed=summary["shed"],
         rejected=summary["rejected"], accounted=summary["accounted"],
         steps=engine.steps, decode_steps=done["decode_steps"],
         kernel_launches=json.dumps(counts), wall_s=wall,
         decode_tok_s=summary["decode_tokens"] / wall,
         prefill_tok_s=summary["prefill_tokens"] / wall,
         step_ms_p50=float(np.percentile(step_ms, 50)),
         step_ms_p99=float(np.percentile(step_ms, 99)),
         step_samples=len(step_ms),
         kv_isolation_max_err=engine.kv_isolation_max_err,
         mem_allocated_gb=mem_gb, mem_peak_gb=peak_gb,
         claim_ready_ms=claim_ready_ms, ttfb_ms=ttfb_ms)
    check_served(engine, done, reqs, "serve")
    del engine
    torch.cuda.empty_cache()

    # Teardown: unreserve, wait for the claim watcher to unprepare, delete.
    c = client.get("ResourceClaim", name, "default")
    c["status"].pop("reservedFor", None)
    client.update_status(c)
    _wait(lambda: not any(
        d.get("driver") == DRIVER_NAME for d in (client.get(
            "ResourceClaim", name, "default").get("status") or {}).get(
            "devices") or []), "claim unprepared")
    client.delete("ResourceClaim", name, "default")
    return {"launches": n_launches, "claim_ready_ms": claim_ready_ms,
            "ttfb_ms": ttfb_ms}


#: The selfheal phase's engine: the serve phase's width (one attention
#: layer of Llama-2-7B, 32 slots, a 4096-token cache), and its traffic:
#: 16 requests a batch, prompts of 512-3072 tokens, 64 new tokens each.
#: ``device`` None binds the engine to the GPU the claim's CDI spec names.
SELFHEAL_WIDTH = {"max_batch": BATCH, "heads": HEADS, "head_dim": HEAD_DIM,
                  "kv_cap": KV_CAP, "prompts": (512, 3072), "new_tokens": 64,
                  "requests": 16, "device": None, "uuids": None}
#: The selfheal phase's loops: the health monitor's and the drain
#: controller's polls, the reallocator's retry, the node lease (its
#: duration and renewal) and the lifecycle controller's poll, in seconds.
SELFHEAL_POLL_S, SELFHEAL_LEASE_S, SELFHEAL_RENEW_S = 0.05, 2.0, 0.25


def _slice_taints(client, device: str) -> list:
    """The taint keys the published ResourceSlice carries on ``device``."""
    return [t.get("key") for s in client.list("ResourceSlice")
            for d in (s.get("spec") or {}).get("devices") or []
            if d.get("name") == device for t in d.get("taints") or []]


def _canary_line(tag: str, res: dict) -> None:
    line("selfheal", canary=tag, outcome=res["outcome"],
         failed_phase=res["phase"] or "none", leaks=json.dumps(res["leaks"]),
         **{f"{k}_ms": round(v * 1e3, 3) for k, v in res["phases"].items()},
         error=json.dumps(res["error"][:120]))


def phase_selfheal(card: str, seed: int, lib, gpu,
                   width: dict | None = None) -> dict:
    """The self-healing path around the claim the serve phase prepares,
    on the device library that found the card: the GPU kubelet plugin
    with its health monitor (holding the library's NVML event session),
    the claim watcher, the drain controller, the claim reallocator, a node
    lease with the lifecycle controller, and a canary prober on node-0.

    A canary probe passes while the card is free; a claim for the card by
    UUID is prepared and engine A serves batch A. Then the
    ``gpulib.gpu.unhealthy`` fault point is armed: the monitor taints the
    card ``gpu.nvidia.com/xid`` (``detect_ms``), the drain controller
    tombstones the claim, deletes its CDI spec and marks it for
    reallocation (``drain_ms``) while the probe reads NOT_SERVING, and
    the phase, playing the pod, drains engine A and frees its slab. A
    canary probe now fails in admission, the only GPU being tainted. The
    repair is then let through (it disarms the fault point and flips the
    node's boot id): the taints are cleared in one republish
    (``rejoin_ms``, from the repair; ``held_ms`` is the phase's own hold
    before it), the reallocator binds the claim to the same GPU and the
    claim watcher prepares it again (``reready_ms`` from the rejoin,
    ``outage_ms`` from the fault); engine B is bound from the new spec and serves batch
    B (``ttfb_after_ms``: fault to its first decoded batch). The claim is
    torn down, a last canary probe passes, and nothing may be left: no
    claim, checkpoint entry, tombstone or CDI spec, no thread the phase
    started. ``width`` overrides :data:`SELFHEAL_WIDTH` (a CPU engine in
    the tests)."""
    w = {**SELFHEAL_WIDTH, **(width or {})}
    on_card = w["device"] is None
    if on_card:
        require(lib.backend in (BACKEND_NVML, BACKEND_PROCFS),
                f"selfheal on the {lib.backend} library, not the one that "
                "found the card")
    device = gpu.canonical_name
    rng = np.random.default_rng(seed + 7)
    threads_before = set(threading.enumerate())
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    fault = faultpoints.FaultPlan("gpulib.gpu.unhealthy=every:1")
    repair_ok = threading.Event()
    stops: list = []
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        boot = f"{tmp}/boot_id"
        with open(boot, "w") as f:
            f.write("selfheal-boot-0\n")
        env = {bootid.ENV_ALT_BOOT_ID_PATH: boot}
        client = FakeClient()
        client.create(new_object(
            "DeviceClass", DRIVER_NAME, spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        client.create(new_object("Node", "node-0"))
        driver = GpuDriver(client, DriverConfig(
            node_name="node-0", state_dir=f"{tmp}/state",
            cdi_root=f"{tmp}/cdi", env=env, retry_timeout=5.0),
            device_lib=lib).start()
        stops.append(driver.stop)

        def heal(dev: str) -> None:
            if faultpoints.active_plan() is fault:
                faultpoints.deactivate()
            lib.set_healthy(parse_gpu_index(dev))

        simulated = SimulatedRepair(heal=heal, env=env)

        def repair(dev: str):
            # Held until the phase has probed the tainted card.
            return simulated(dev) if repair_ok.is_set() else None

        try:
            require(driver.device_lib is lib and any(
                g.uuid == gpu.uuid for g in driver.state.gpus),
                "the plugin does not run on the library that found the card")
            monitor = attach_health_monitor(driver,
                                            poll_interval=SELFHEAL_POLL_S)
            stops.append(monitor.stop)
            hb = NodeLeaseHeartbeat(
                client, "node-0", state_dir=f"{tmp}/state",
                lease_duration=SELFHEAL_LEASE_S,
                renew_interval=SELFHEAL_RENEW_S,
                fence_cleanup=fence_cleanup_for(driver, client),
                identity="gpu-kubelet-plugin", env=env).start()
            stops.append(hb.stop)
            loop = NodePrepareLoop(
                client, driver, DRIVER_NAME, "node-0", namespace="default",
                retry_delay=SELFHEAL_POLL_S,
                fence=lambda: hb.fenced or hb.suspect).start()
            stops.append(loop.stop)
            remediation = RemediationMetrics()
            drainer = DrainController(client, driver, repair=repair,
                                      poll_interval=SELFHEAL_POLL_S,
                                      metrics=remediation).start()
            stops.append(drainer.stop)
            alloc = Allocator(client)
            # 60 s of retries: the claim waits out the held repair.
            realloc = ClaimReallocator(
                client, retry_delay=SELFHEAL_POLL_S, attempt_budget=1200,
                metrics=remediation, allocator=alloc).start()
            stops.append(realloc.stop)
            lifecycle = NodeLifecycleController(
                client, poll_interval=SELFHEAL_RENEW_S).start()
            stops.append(lifecycle.stop)
            verify, residue = driver_probe_hooks(lambda _node: driver)
            prober = CanaryProber(client, alloc, nodes=["node-0"],
                                  probe_deadline_s=10.0, verify=verify,
                                  residue=residue)

            def probe() -> int:
                return driver_probe(driver, drainer, fenced=lambda: hb.fenced)

            line("selfheal", card=json.dumps(card), backend=lib.backend,
                 nvml_events=json.dumps(monitor.nvml_events))
            if lib.backend == BACKEND_NVML:
                require(monitor.events_session is not None,
                        "no NVML event session on the nvml backend")
            require(probe() == STATUS_SERVING, "the plugin is not SERVING")
            canary = [prober.probe_node("node-0")]
            _canary_line("free", canary[0])
            require(canary[0]["outcome"] == "ok",
                    f"canary on the free card: {canary[0]}")

            # Claim A and batch A, as the serve phase.
            name = "selfheal-claim"
            claim = client.create(new_object(
                "ResourceClaim", name, "default",
                api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                    "deviceClassName": DRIVER_NAME,
                    "allocationMode": "ExactCount", "count": 1,
                    "selectors": [{"cel": {"expression":
                        f"device.attributes['uuid'] == '{gpu.uuid}'"}}]}}]}}))
            uid = claim["metadata"]["uid"]
            alloc.allocate(claim, reserved_for=[
                {"resource": "pods", "name": "selfheal-pod"}], node="node-0")
            _wait(lambda: _claim_ready(client, name), "claim A Ready")

            def bind(tag: str):
                spec = driver.cdi.read_claim_spec(uid)
                entries = visible_device_entries(spec)
                require(entries == [gpu.uuid],
                        f"engine {tag}: the spec names {entries}")
                return bind_engine(
                    spec, f"selfheal-{tag}", device=w["device"],
                    uuids=w["uuids"], metrics=ServingMetrics(),
                    max_batch=w["max_batch"], kv_cap=w["kv_cap"],
                    heads=w["heads"], head_dim=w["head_dim"],
                    tokens_per_chip_step=2048, queue_cap=64,
                    modeled_chip_tok_s=1e9)

            engine = bind("a")
            reqs_a = tenant_requests(rng, w["requests"], "a", w["prompts"],
                                     w["new_tokens"])
            serve_requests(engine, reqs_a, "selfheal batch A")

            # The fault. The drain's own state is read the moment it
            # returns, before the claim is marked and released.
            drained: dict = {}
            inner_drain = driver.drain_claim

            def observed_drain(ref, reason=""):
                ok = inner_drain(ref, reason=reason)
                if ok and ref.uid == uid and not drained:
                    pc = driver.state.prepared_claims_nolock().get(uid)
                    drained.update(
                        tombstone=(pc is not None
                                   and pc.state == STATE_PREPARE_ABORTED),
                        spec_gone=driver.cdi.read_claim_spec(uid) is None)
                return ok

            driver.drain_claim = observed_drain
            t_arm = time.monotonic()
            faultpoints.activate(fault)
            _wait(lambda: TAINT_KEY_XID in _slice_taints(client, device),
                  "the xid taint on the published slice")
            out["detect_ms"] = (time.monotonic() - t_arm) * 1e3
            _wait(lambda: drained and ANN_DRAIN in (client.get(
                "ResourceClaim", name, "default")["metadata"].get(
                "annotations") or {}), "the claim drained and marked")
            t_drained = time.monotonic()
            out["drain_ms"] = (t_drained - t_arm) * 1e3
            serving_mid = probe()
            done_a = finish_engine(engine)    # the pod leaves the bad GPU
            check_served(engine, done_a, reqs_a, "selfheal batch A")
            del engine
            if on_card:
                torch.cuda.empty_cache()
            line("selfheal", fault="gpulib.gpu.unhealthy", device=device,
                 detect_ms=out["detect_ms"], drain_ms=out["drain_ms"],
                 tombstone=drained["tombstone"],
                 cdi_spec_gone=drained["spec_gone"],
                 probe_while_draining=serving_mid,
                 batch_a_launches=json.dumps(done_a["counts"]),
                 batch_a_decode_steps=done_a["decode_steps"])
            require(drained["tombstone"] and drained["spec_gone"],
                    f"drain left {drained}")
            require(serving_mid == STATUS_NOT_SERVING,
                    f"the probe read {serving_mid} while draining")

            canary.append(prober.probe_node("node-0"))
            _canary_line("tainted", canary[1])
            require(canary[1]["outcome"] == "failed"
                    and canary[1]["phase"] == "admission"
                    and not canary[1]["leaks"]
                    and TAINT_KEY_XID in _slice_taints(client, device),
                    f"canary on the tainted card: {canary[1]}")

            # Repair, rejoin, reallocation to the same GPU, batch B.
            t_rep = time.monotonic()
            out["held_ms"] = (t_rep - t_drained) * 1e3
            repair_ok.set()
            _wait(lambda: not _slice_taints(client, device),
                  "the health taints cleared")
            t_rejoined = time.monotonic()
            out["rejoin_ms"] = (t_rejoined - t_rep) * 1e3

            def ready_again() -> bool:
                c = client.get("ResourceClaim", name, "default")
                res = ((c.get("status") or {}).get("allocation") or {}).get(
                    "devices", {}).get("results") or []
                return (_claim_ready(client, name)
                        and [r["device"] for r in res] == [device]
                        and ANN_DRAIN not in (c["metadata"].get(
                            "annotations") or {}))

            _wait(ready_again, "the claim Ready again on the same GPU")
            t_ready = time.monotonic()
            out["reready_ms"] = (t_ready - t_rejoined) * 1e3
            out["outage_ms"] = (t_ready - t_arm) * 1e3
            engine = bind("b")
            reqs_b = tenant_requests(rng, w["requests"], "b", w["prompts"],
                                     w["new_tokens"])
            serve_requests(engine, reqs_b, "selfheal batch B")
            out["ttfb_after_ms"] = (engine.first_batch_t - t_arm) * 1e3
            done_b = finish_engine(engine)
            check_served(engine, done_b, reqs_b, "selfheal batch B")
            del engine
            if on_card:
                torch.cuda.empty_cache()

            # Teardown of the claim, the last probe, and the final reads.
            c = client.get("ResourceClaim", name, "default")
            c["status"].pop("reservedFor", None)
            client.update_status(c)
            _wait(lambda: not any(
                d.get("driver") == DRIVER_NAME for d in (client.get(
                    "ResourceClaim", name, "default").get("status")
                    or {}).get("devices") or []), "claim unprepared")
            client.delete("ResourceClaim", name, "default")
            canary.append(prober.probe_node("node-0"))
            _canary_line("repaired", canary[2])
            require(canary[2]["outcome"] == "ok",
                    f"canary on the repaired card: {canary[2]}")
            serving_end = probe()
            out.update(
                repairs=len(simulated.repaired_devices()),
                boot_adopted=driver.state.node_boot_id == bootid.read_boot_id(
                    env) != "selfheal-boot-0",
                reallocated=realloc.reallocated, failed=realloc.failed,
                drains=int(remediation.drains_total.value(
                    driver=DRIVER_NAME)),
                recoveries=len(drainer.recoveries),
                cordons=len(lifecycle.cordons),
                lease_renewals=hb.renewals,
                launches_a=done_a["counts"]["decode_attention"],
                decode_steps_a=done_a["decode_steps"],
                launches_b=done_b["counts"]["decode_attention"],
                decode_steps_b=done_b["decode_steps"],
                nvml_events=monitor.nvml_events,
                nvml_delivered=getattr(monitor.events_session, "delivered",
                                       "no session"))
        finally:
            if faultpoints.active_plan() is fault:
                faultpoints.deactivate()
            for stop in reversed(stops):
                stop()
        require(serving_end == STATUS_SERVING,
                f"the probe read {serving_end} at the end")
        require(out["cordons"] == 0, "the lifecycle controller declared "
                                     "node-0 lost")
        require(out["repairs"] == 1 and out["boot_adopted"],
                f"repairs {out['repairs']}, boot adopted "
                f"{out['boot_adopted']}")
        require(out["reallocated"] == 1 and out["failed"] == 0,
                f"reallocated {out['reallocated']}, failed {out['failed']}")
        expired = driver.state.delete_expired_aborted(
            now=time.time() + driver.state.aborted_ttl + 1)
        residue = ([c["metadata"]["name"]
                    for c in client.list("ResourceClaim")]
                   + sorted(driver.state.prepared_claims_nolock())
                   + driver.cdi.list_claim_uids()
                   + sorted(p.name for p in driver.cdi.cdi_root.iterdir()))
    deadline = time.monotonic() + 10
    while True:
        left = sorted(t.name for t in threading.enumerate()
                      if t not in threads_before and t.is_alive())
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    line("selfheal", detect_ms=out["detect_ms"], drain_ms=out["drain_ms"],
         held_ms=out["held_ms"], rejoin_ms=out["rejoin_ms"],
         reready_ms=out["reready_ms"], outage_ms=out["outage_ms"],
         ttfb_after_ms=out["ttfb_after_ms"],
         kernel_launches=out["launches_a"] + out["launches_b"],
         decode_steps=out["decode_steps_a"] + out["decode_steps_b"],
         drains=out["drains"], reallocated=out["reallocated"],
         recoveries=out["recoveries"], cordons=out["cordons"],
         lease_renewals=out["lease_renewals"],
         nvml_events=json.dumps(out["nvml_events"]),
         nvml_events_delivered=out["nvml_delivered"],
         tombstones_expired=len(expired), residue=json.dumps(residue),
         threads_left=json.dumps(left))
    require(not residue, f"selfheal left behind: {residue}")
    require(not left, f"selfheal left threads running: {left}")
    return out


def servesmoke_check(rng: np.random.Generator) -> float:
    """The decode kernel against its plain version at the serving smoke's
    shapes (``SERVING_SMOKE_ENGINE``: q [8, 2, ql, 8], K/V [8, 2, 32, 8]),
    random K/V and ragged lengths (1, the full cache, the rest uniform),
    ql 1-8, f32 within F32_TOL and bf16 within BF16_TOL. The smoke's own
    caches hold one constant vector per slot, which any softmax weighting
    reproduces; these inputs do not. Returns the largest error over its
    tolerance."""
    dev = torch.device("cuda", 0)
    e = SERVING_SMOKE_ENGINE
    b, h, d, cap = e["max_batch"], e["heads"], e["head_dim"], e["kv_cap"]
    lens = rng.integers(1, cap + 1, size=b).astype(np.int32)
    lens[:2] = (1, cap)
    worst = 0.0
    for ql in range(1, 9):
        args = [torch.from_numpy(a).to(dev) for a in (
            rng.standard_normal((b, h, ql, d), np.float32),
            rng.standard_normal((b, h, cap, d), np.float32),
            rng.standard_normal((b, h, cap, d), np.float32), lens)]
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            a = [t.to(dtype) for t in args[:3]] + args[3:]
            out = flash_attention_decode(*a)
            ref = decode_attention_reference(*a)
            require(out.shape == ref.shape and out.dtype == dtype
                    and bool(torch.isfinite(out).all()),
                    f"servesmoke shape {dtype} ql={ql}: output "
                    f"{out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            require(err < tol, f"servesmoke shape {dtype} ql={ql}: "
                               f"error {err} >= {tol}")
            worst = max(worst, err / tol)
    torch.cuda.synchronize()
    line("servesmoke", kernel="decode_attention",
         shape=json.dumps([b, h, "1-8", d]), kv_cap=cap,
         lengths=json.dumps(lens.tolist()), dtypes="f32/bf16",
         worst_err_over_tol=worst)
    return worst


def phase_servesmoke(rng: np.random.Generator) -> None:
    """``run_serving_smoke()`` on the card: one replica's serve session
    from a ResourceClaim to the first decoded batch, drained and torn down,
    with the accounting identity and a zero-residue audit. Its own path:
    the counts are zeroed before it and read after it. Then the decode
    kernel is held against its plain version at the session's shapes
    (``servesmoke_check``), outside the counted run."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    reset_launches()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        r = run_serving_smoke(tmpdir=tmp)
    counts = launches()
    line("servesmoke", ok=r["ok"], outcome=r["outcome"], backend=r["backend"],
         device=r["device"], ttfb_s=r["ttfb_s"], completed=r["completed"],
         shed=r["shed"], rejected=r["rejected"], accounted=r["accounted"],
         leaks=json.dumps(r["leaks"]),
         kv_isolation_max_err=r["kv_isolation_max_err"],
         kernel_launches=json.dumps(counts), error=json.dumps(r["error"]))
    require(r["ok"] and r["accounted"] and r["leaks"] == [],
            f"serving smoke: {r}")
    require(r["kv_isolation_max_err"] < F32_TOL,
            f"serving smoke kv_isolation_max_err {r['kv_isolation_max_err']}")
    require(r["device"] == "cuda:0", f"serving smoke on {r['device']}")
    require(counts["decode_attention"] > 0,
            "the serving smoke launched no decode kernel")
    servesmoke_check(rng)


def _worst(got: dict, want: dict, tol: float, what: str) -> float:
    """The largest of max |got - want| / (tol + tol |want|) over the keys
    of two dicts of numpy arrays (nested lists and dicts too); at most 1
    where ``np.testing.assert_allclose(got, want, tol, tol)`` passes."""
    if isinstance(want, dict):
        return max(_worst(got[k], want[k], tol, f"{what}.{k}") for k in want)
    if isinstance(want, list):
        return max(_worst(g, w, tol, what) for g, w in zip(got, want))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    require(got.shape == want.shape, f"{what}: shape {got.shape} vs "
                                     f"{want.shape}")
    require(bool(np.isfinite(got).all()), f"{what}: not finite")
    return float((np.abs(got - want) / (tol + tol * np.abs(want))).max())


def timing_fields(t: dict) -> dict:
    """A step's ``_dist.step_timing`` as the phase prints it: the event
    time per step, and from the profiled steps the host window, the time
    the card ran anything, operations and NCCL kernel time per step, and
    the card's idle share of the window."""
    return {"cuda_ms": t["ms"], "profiled_window_ms": t["window_ms"],
            "device_busy_ms": t["busy_ms"], "device_ops_per_step": t["ops"],
            "nccl_kernel_ms": t["nccl_ms"],
            "idle_share": 1 - t["busy_ms"] / t["window_ms"]}


def phase_computedomain(card: str, lib, tmp: str):
    """A ComputeDomain of this one node: the CD kubelet plugin on the
    device library that found the card, the controller's live loop, and one
    daemon on the node reporting the card's health and the address
    127.0.0.1. A channel claim is refused (retryably) while the CD is not
    Ready, and prepares once the daemon has made it Ready; its env is the
    rendezvous ``phase_multigpu``'s dry run starts from. Returns that env
    and a teardown that unprepares and deletes the claim, deletes the CD,
    stops the daemon's loop and the controller's threads, and requires that
    nothing is left."""
    client = FakeClient()
    client.create(new_object("Node", "node-0"))
    client.create(new_object("DeviceClass", CHANNEL_CLASS, spec={
        "selectors": [{"cel": {"expression":
                               "device.attributes['type'] == 'channel'"}}]}))
    controller = ComputeDomainController(client).start()
    daemon = None
    driver = CdDriver(client, CdDriverConfig(
        node_name="node-0", state_dir=f"{tmp}/cd-state",
        cdi_root=f"{tmp}/cd-cdi", env={}, retry_timeout=0.05),
        device_lib=lib).start()
    try:
        t_cd = time.monotonic()
        cd = client.create(new_compute_domain("smoke-cd", num_nodes=1))
        uid = cd["metadata"]["uid"]
        _wait(lambda: client.try_get("ResourceClaimTemplate",
                                     "smoke-cd-channel", "default")
              is not None, "the controller's channel template")
        template = client.get("ResourceClaimTemplate", "smoke-cd-channel",
                              "default")
        t_claim = time.monotonic()
        claim = Allocator(client).allocate(client.create(new_object(
            "ResourceClaim", "smoke-channel", "default",
            api_version="resource.k8s.io/v1",
            spec=template["spec"]["spec"])), node="node-0")
        claim_uid = claim["metadata"]["uid"]
        refused = driver.prepare_resource_claims([claim])[claim_uid].error
        refused_ms = (time.monotonic() - t_claim) * 1e3
        labels = client.get("Node", "node-0")["metadata"].get("labels", {})
        line("computedomain", refused=json.dumps(str(refused)),
             refused_ms=refused_ms, node_label=labels.get(NODE_LABEL_CD))
        require(refused is not None and not is_permanent(refused),
                f"prepare before Ready gave {refused!r}, not a retryable "
                "refusal")
        require(labels.get(NODE_LABEL_CD) == uid,
                "the refused prepare did not label the node")

        t_daemon = time.monotonic()
        daemon = ComputeDomainDaemon(
            client=client, device_lib=lib, cd_uid=uid, cd_name="smoke-cd",
            node_name="node-0", hostname=socket.gethostname(),
            ip_address="127.0.0.1").start(interval=0.5)
        _wait(lambda: cd_status(client.get("ComputeDomain", "smoke-cd",
                                           "default")) == STATUS_READY,
              "the ComputeDomain Ready")
        t_ready = time.monotonic()
        driver.config.retry_timeout = 10.0
        result = driver.prepare_resource_claims([claim])[claim_uid]
        t_prepared = time.monotonic()
        require(result.error is None, f"channel prepare: {result.error!r}")
        env = claim_spec_env(driver.cdi.read_claim_spec(claim_uid))
        entry = clique_daemons(client.list("ComputeDomainClique")[0])[0]
        line("computedomain", card=json.dumps(card), backend=lib.backend,
             clique=entry.clique_id, daemon_status=entry.status,
             daemon_gpus=entry.topology, daemon_address=entry.ip_address,
             cd_ready_ms=(t_ready - t_cd) * 1e3,
             daemon_to_ready_ms=(t_ready - t_daemon) * 1e3,
             prepare_ms=(t_prepared - t_ready) * 1e3,
             channel_ready_ms=(t_prepared - t_claim) * 1e3,
             env=json.dumps({k: env[k] for k in _dist.RENDEZVOUS_KEYS}))
        require(entry.status == STATUS_READY
                and entry.topology == str(torch.cuda.device_count()),
                f"daemon entry {entry}")
        require(env["MASTER_ADDR"] == "127.0.0.1"
                and env["MASTER_PORT"] == str(MASTER_PORT)
                and env["NNODES"] == "1" and env["NODE_RANK"] == "0",
                f"channel env {env}")
    except BaseException:
        if daemon is not None:
            daemon.stop()
        controller.stop()
        driver.stop()
        raise

    def teardown() -> None:
        # The workload's claim goes first (its unprepare unlabels the
        # node), then the daemon leaves its clique, as the DaemonSet's pod
        # would, and the CD's deletion tears down what the controller made.
        errs = driver.unprepare_resource_claims([ClaimRef(
            uid=claim_uid, name="smoke-channel", namespace="default")])
        client.delete("ResourceClaim", "smoke-channel", "default")
        daemon.stop()
        client.delete("ComputeDomain", "smoke-cd", "default")
        _wait(lambda: client.try_get("ComputeDomain", "smoke-cd", "default")
              is None, "the ComputeDomain's teardown")
        controller.stop()
        driver.stop(unpublish=True)
        residue = ([f"{k}/{o['metadata']['name']}" for k in (
            "ResourceClaim", "ComputeDomain", "ComputeDomainClique",
            "DaemonSet", "ResourceClaimTemplate", "ResourceSlice")
            for o in client.list(k)]
            + [f"{u}: {e}" for u, e in errs.items() if e is not None]
            + sorted(driver.state.prepared_claims_nolock())
            + driver.cdi.list_claim_uids()
            + [k for k in client.get("Node", "node-0")["metadata"].get(
                "labels") or {} if k == NODE_LABEL_CD])
        line("computedomain", teardown="done", residue=json.dumps(residue))
        require(not residue, f"left behind: {residue}")

    return env, teardown


def phase_multigpu(card: str, seed: int, rendezvous: dict) -> None:
    """The multi-GPU compute plane on the machine's GPUs, one NCCL rank
    each, held against the same code on gloo ranks on the CPU (and against
    the plain references). The dry run's ranks start from ``rendezvous``,
    the env of the channel claim ``phase_computedomain`` prepared, at world
    NNODES x the GPU count; every other function here starts its own ranks.
    With one GPU, every part runs at world 1 and ``psum_bench`` must refuse
    it; with more, the parts run at the GPU count (the MoE at ep 2) and the
    all-reduce's bus bandwidth is measured at 16 and 256 MiB a GPU."""
    world = torch.cuda.device_count()
    t0 = time.monotonic()
    d = dryrun_multichip(world, rendezvous=rendezvous)
    line("multigpu", part="dryrun", card=json.dumps(card), world=d["world"],
         backend=d["backend"], rendezvous=json.dumps(
             _dist.rendezvous_from_env(rendezvous, world)[0]),
         device=d["device"], mesh=json.dumps(d["mesh"]),
         moe=json.dumps(d["moe"]), loss=d["loss"],
         ring_max_abs_err=d["ring_max_abs_err"],
         moe_max_abs_err=d["moe_max_abs_err"],
         pipeline_max_abs_err=d["pipeline_max_abs_err"],
         seconds=f"{time.monotonic() - t0:.2f}")
    require(d["world"] == int(rendezvous["NNODES"]) * world
            and d["backend"] == "nccl",
            f"dry run on {d['world']} {d['backend']} ranks")

    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    # The sharded step at train_state's widths.
    params = {"embed": normal(512, 256, scale=0.02),
              "w1": normal(256, 1024, scale=0.02),
              "w2": normal(1024, 256, scale=0.02),
              "out": normal(256, 512, scale=0.02)}
    tokens, targets = (rng.integers(0, 512, (8, 16)) for _ in range(2))
    gpu = sharded.run_sharded_train_step(params, tokens, targets, world,
                                         time_reps=TIMED_CALLS)
    cpu = sharded.run_sharded_train_step(params, tokens, targets, 4,
                                         device="cpu")
    loss_over = _worst(gpu["losses"], cpu["losses"], MULTI_F32_TOL, "loss")
    param_over = _worst(gpu["params"], cpu["params"], MULTI_PARAM_TOL,
                        "params")
    line("multigpu", part="sharded", card=json.dumps(card),
         card_mesh=json.dumps(gpu["mesh"]), cpu_mesh=json.dumps(cpu["mesh"]),
         card_loss=gpu["losses"][0], cpu_loss=cpu["losses"][0],
         loss_over_tol=loss_over, params_over_tol=param_over,
         **timing_fields(gpu["timing"]))
    require(cpu["mesh"] == {"dp": 2, "tp": 2}, f"CPU mesh {cpu['mesh']}")
    require(loss_over <= 1 and param_over <= 1,
            "the card's sharded step differs from the CPU's")

    # MoE at the dry run's widths: 4 experts, d_model 16, d_ff 32.
    mp = {"wg": normal(16, 4, scale=0.25), "w1": normal(4, 16, 32,
                                                        scale=0.25),
          "w2": normal(4, 32, 16, scale=32 ** -0.5)}
    x, y = normal(4, 4, 16), normal(4, 4, 16)
    card_ep = 2 if world % 2 == 0 else 1
    gpu = moe.run_moe(mp, x, y, world, card_ep)
    cpu = moe.run_moe(mp, x, y, 4, 2, device="cpu")
    ref = moe.moe_ffn_reference(moe.moe_params_from_numpy(mp),
                                torch.from_numpy(x)).numpy()
    over = max(_worst(gpu["out"], cpu["out"], MULTI_F32_TOL, "moe out"),
               _worst(gpu["out"], ref, MULTI_F32_TOL, "moe ref"),
               _worst(gpu["losses"], cpu["losses"], MULTI_F32_TOL, "loss"))
    param_over = _worst(gpu["params"], cpu["params"], MULTI_PARAM_TOL,
                        "moe params")
    line("multigpu", part="moe", card_ep=card_ep,
         card_dp=world // card_ep, cpu_ep=2, cpu_dp=2,
         card_loss=gpu["losses"][0], cpu_loss=cpu["losses"][0],
         out_over_tol=over, params_over_tol=param_over)
    require(over <= 1 and param_over <= 1,
            "the card's MoE differs from the CPU's or the reference")

    # The pipeline at the dry run's widths, one stage per GPU, against the
    # reference and the same stages on gloo ranks.
    pp = {"w1": normal(world, 8, 8, scale=8 ** -0.5),
          "w2": normal(world, 8, 8, scale=8 ** -0.5)}
    xs, ys = normal(world, 2, 8), normal(world, 2, 8)
    gpu = pipeline.run_pipeline(pp, xs, world, ys=ys)
    cpu = pipeline.run_pipeline(pp, xs, world, ys=ys, device="cpu")
    ref = pipeline.pipeline_reference(
        pipeline.pipeline_params_from_numpy(pp), torch.from_numpy(xs)).numpy()
    over = max(_worst(gpu["out"], ref, MULTI_F32_TOL, "pipeline ref"),
               _worst(gpu["losses"], cpu["losses"], MULTI_F32_TOL, "loss"))
    param_over = _worst(gpu["params"], cpu["params"], MULTI_PARAM_TOL,
                        "pipeline params")
    line("multigpu", part="pipeline", pp=world, card_loss=gpu["losses"][0],
         out_over_tol=over, params_over_tol=param_over)
    require(over <= 1 and param_over <= 1,
            "the card's pipeline differs from the reference or the CPU")

    # The data-parallel ResNet at resnet_params' defaults, bf16.
    rp = resnet.resnet_params_to_numpy(resnet.resnet_params(
        generator=torch.Generator().manual_seed(seed)))
    images = normal(4 * world, 16, 16, 3)
    labels = rng.integers(0, 10, 4 * world)
    gpu = resnet.run_data_parallel_resnet(rp, images, labels, world,
                                          time_reps=TIMED_CALLS)
    cpu = resnet.run_data_parallel_resnet(rp, images, labels, 2,
                                          device="cpu")
    over = max(_worst(gpu["logits"], cpu["logits"], MULTI_BF16_TOL, "logits"),
               _worst(gpu["losses"], cpu["losses"], MULTI_BF16_TOL, "loss"),
               _worst(gpu["params"], cpu["params"], MULTI_BF16_TOL,
                      "resnet params"))
    line("multigpu", part="resnet", card=json.dumps(card), card_dp=world,
         cpu_dp=2, card_loss=gpu["losses"][0], cpu_loss=cpu["losses"][0],
         over_tol=over, **timing_fields(gpu["timing"]))
    require(over <= 1, "the card's ResNet step differs from the CPU's")

    # Ring attention at the ring bench's rows, held against the reference
    # at every row.
    rows = ringattention.ring_crossover_bench(
        RING_SEQS, n_devices=world, reps=10,
        full_exec_max_seq=max(RING_SEQS))
    for r in rows:
        line("multigpu", part="ring", card=json.dumps(card), seq=r["seq"],
             shape=json.dumps(r["shape"]), sp=r["n_devices"],
             ring_cuda_ms=r["ring_ms"], full_cuda_ms=r["full_ms"],
             ring_peak_bytes=r["ring_peak_bytes"],
             full_peak_bytes=r["full_peak_bytes"],
             max_abs_err=r["max_abs_err"])
        require(r["max_abs_err"] <= MULTI_F32_TOL,
                f"ring attention at seq {r['seq']}: error "
                f"{r['max_abs_err']}")
    require([r["seq"] for r in rows] == list(RING_SEQS), "ring rows")

    # The all-reduce bench needs two GPUs; the model is labelled as one.
    if world < 2:
        try:
            collectives.psum_bench(n_devices=world)
        except ValueError as e:
            line("multigpu", part="psum", refused=json.dumps(str(e)))
        else:
            raise SystemExit(f"chip_smoke: FAILED: psum_bench ran on "
                             f"{world} GPU")
        print(f"busbw: not measured ({world} GPU)", flush=True)
    else:
        for elems in (1 << 22, 1 << 26):
            b = collectives.psum_bench(shard_elems=elems, n_devices=world)
            line("multigpu", part="psum", card=json.dumps(card),
                 kind=b["kind"], n_devices=b["n_devices"],
                 shard_mib=b["shard_bytes"] / (1 << 20),
                 seconds=b["seconds"], bus_gbps=b["bus_gbps"])
    info = MockDeviceLib("h100-8").node_info()
    for n_gpus in sorted({info.num_gpus} | ({world} if world > 1 else set())):
        m = collectives.modeled_allreduce(256 << 20, info.gpu_type.spec,
                                          n_gpus)
        line("multigpu", part="allreduce_model", kind=m["kind"],
             gpu=json.dumps(m["gpu"]), n_gpus=n_gpus, shard_mib=256,
             per_gpu_egress_gbps=m["per_gpu_egress_gbps"],
             modeled_bus_gbps=m["modeled_bus_gbps"],
             pct_of_line_rate=m["pct_of_line_rate"],
             hop_latency_us=m["hop_latency_s"] * 1e6)
    line("multigpu", card=json.dumps(card),
         seconds=f"{time.monotonic() - t0:.2f}")


def child_processes() -> list[str]:
    """``pid command`` of every process whose parent is this one."""
    me, found = str(os.getpid()), []
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except (OSError, ValueError):
            continue
        # The command, in parentheses, may hold spaces; the fields after it
        # are the state and the parent's pid.
        name, fields = stat[stat.find("(") + 1:stat.rfind(")")], \
            stat[stat.rfind(")") + 2:].split()
        if fields[1] == me:
            found.append(f"{pid} {name} ({fields[0]})")
    return found


def phase_leftovers() -> None:
    """Stop the ranks' fork server and require that no child is left."""
    _dist.stop_rank_server()
    left = child_processes()
    require(not left, f"processes left running: {left}")
    line("leftovers", children=0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    card = phase_device()
    found = phase_enumerate()
    phase_build()
    rng = np.random.default_rng(args.seed)
    k, v, lens = smoke_inputs(rng)
    max_abs_err = phase_check(rng, k, v, lens)
    timing = phase_timing(rng, k, v, lens)
    del k, v, lens
    torch.cuda.empty_cache()
    engine_parity()
    served = phase_serve(args.seed, found["lib"], found["gpu"])
    phase_servesmoke(rng)
    flash_err = phase_flash_check(args.seed)
    flash = phase_flash_bench(args.seed)
    phase_burnin()
    phase_selfheal(card, args.seed, found["lib"], found["gpu"])
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        rendezvous, cd_teardown = phase_computedomain(card, found["lib"], tmp)
        try:
            phase_multigpu(card, args.seed, rendezvous)
        finally:
            cd_teardown()
    phase_leftovers()
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
