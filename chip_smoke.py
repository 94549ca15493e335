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
           SASS count of warpgroup MMAs (HGMMA), TMA loads (UTMALDG) and
           bulk copies (UBLKCP): every bf16 and f16 flash kernel and every
           wide kernel (decode and flash, at head dims over 256) must have
           the first two, every tuned decode ring kernel and every
           any-dtype decode kernel the third, and every TF32
           tensor-core kernel (the f32 and mixed decode kernels, 3xTF32,
           and the any-dtype flash kernels) TMA loads and HGMMAs all of the
           TF32 form, with no spill
3. check   the decode kernel against its plain PyTorch version on the card
           at the smoke's width (b=32, h=32, d=128, cap=4096, ragged
           lengths): f32 within 1e-4, bf16 and f16 within 2e-2, a poisoned
           cache tail (+-6e4 in f16, which holds no 1e6) changes the output
           by less than 1e-5, and a block_k that does not divide the cache
           raises ValueError; every compiled variant at small shapes in
           f32, bf16 and f16, with v's head dim unlike k's and 16 or 20
           query rows (the ring kernel launched 8 rows at a time, the
           any-dtype kernel once), each with its masked tail poisoned;
           head dims 257-1024
           (576/512, 64/640) and q, k and v in different dtypes, each within
           its narrowest input's limit: bf16 and f16 up to 576/512 on the
           wide kernel, f32 there on the f32 tensor-core kernel and the
           rest (K and V apart, wider heads) on the any-dtype decode
           kernel, one launch a call within the flash limit too; the
           any-dtype kernel at 8 sequences of lengths 1, its tile's and a
           split's edges and the cache (2,048 keys, split), at 1,024/1,024
           in bf16 and f32, K and V apart, 66/130 and a cache view off a 16-
           byte boundary (its variant that copies the 16-byte chunks around
           each tile), one launch a call and a poisoned tail moving
           nothing; the f32 kernel at absorbed MLA's layout at 128 query
           rows and 1, lengths 1, 31-33, 63-65, a split's edges and the
           cache, within 1e-4 and 2e-5 + 2e-5 |ref|, one launch a call,
           and a poisoned tail that moves its output by less than 1e-5;
           the wide kernel at DeepSeek-V3's
           absorbed-MLA layout (128 query rows, 576/512, the smoke's cache)
           in bf16 and f16 at lengths 1, 31, 32, 33, a split's edge and the
           cache, one launch a call, and with a poisoned tail (+-1e6,
           +-6e4 in f16) that moves its output by less than 1e-5; then a
           small engine on the card against the same engine on the CPU,
           step for step; the tuned decode's ring kernel in bf16 and f16 at
           d = dv = 128 (1 and 5 query rows), 64, 256, 128/64 and 64/256,
           and in f32 (two chunks a lane) at 256/256, 192/192, 256/128 (2
           rows) and 128/256, nine sequences of lengths 1, 2, its tile's
           edges (T - 1, T, T + 1), a split's edges (+-1) and the cache, the
           cache split across blocks: within its dtype's decode limit and
           the flash limit, one launch a call, and a poisoned tail that
           moves the output by less than 1e-5; q in a dtype apart from
           the one K and V share (an f32 q over a bf16 and an f16 cache, a
           bf16 q over an f32 one) at the
           serve shape on the ring kernel and at absorbed MLA's layout (128
           and 1 rows, lengths at the tiles' and a split's edges) on the
           mixed tensor-core kernel, one launch a call, within 2e-2 and the
           flash limit, a poisoned tail moving nothing, and, at one key
           tile, nearer to the kernel's semantics than to an unrounded p or
           a TF32-rounded f32 query
4. timing  the decode kernel, its plain version and one library call, at
           the engine's shape, beside the least time the card could take
5. serve   the claim path: a ResourceClaim for that card (CEL on its UUID)
           allocated, prepared by the GPU kubelet plugin through the claim
           watcher into a CDI spec naming it, read back and bound to an
           engine at one attention layer of Llama-2-7B (32 heads of 128,
           a 4096-token cache, 32 slots) that serves 48 requests from 4
           tenants through the decode kernel; then a second engine from the
           same spec at Gemma-2-9B's attention width (16 heads of 256, a
           4096-token f32 cache, 32 slots) serves 16 requests from 2 tenants
           under the same checks, and the kernel is held to its plain
           version at its shape; then the claim is drained, unreserved,
           unprepared and deleted with nothing left behind (claim_ready_ms,
           ttfb_ms: claim create to Ready, to the first decoded batch)
   servesmoke  the port's run_serving_smoke() on the card: ok, accounted,
           no leaks, isolation error under 1e-4; then the decode kernel
           against its plain version at that session's shapes (q [8, 2,
           ql, 8] for ql 1-8, a 32-token cache, random K/V, ragged
           lengths): f32 within 1e-4, bf16 within 2e-2
6. flash   the flash-attention kernel against its plain version
           (``reference_attention``) on the card at the compute bench's
           width [4, 8, 2048, 128], causal off and on: bf16 and f16 within
           4e-3 + 1e-2 |ref| and f32 within 2e-5 + 2e-5 |ref| (the JAX
           tests' f32 criterion) at every element; every compiled variant at
           small shapes in all three dtypes, at S = 1 to 320 across the
           kernels' tile edges; head dims 8, 40 and 24 that the wrapper
           zero-pads to multiples of 16, within the same limits; head dims
           257-1024 (576/512, 64/640) and q, k and v in different dtypes,
           each within its narrowest input's limit (bf16 and f16 up to
           576/512 on the wide kernel, the rest on the any-dtype
           tensor-core kernel, at S = 1, 33, 64, 65, 129 and 320, causal
           off and on,
           one launch a call, and at S = 64 with an f32 q and K over a
           16-bit V nearer to p rounded to V's dtype than not); the
           wide kernel at 576/512 in bf16 and f16 at S = 1, 63, 64, 65, 129
           and 320 (its 64-row and 32-key tiles' edges), causal off and on;
           f32 on the any-dtype kernel (3xTF32) at the headline and at
           128/128, 256/256 and 576/512 at those S (its 64-row and 64-key
           tiles' edges), causal off and on, within the f32 limit, one
           launch a call; q's dtype apart from K's and V's on the same
           kernel at the headline in each such class and at those head dims
           and S, within the bf16 limit, one
           launch a call, and, at S = 64, nearer to the kernel's semantics
           than to an unrounded p or a TF32-rounded f32 query (what the
           bf16 limit cannot see);
           block arguments that change nothing; causal row 0 equal to v's
           row 0; an indivisible S raising ValueError without a launch
7. bench   the compute bench's flash rows (the JAX bench's headline shape
           and its sweep, seq 512-8192 at b*seq = 8192, h = 8, d = 128, bf16,
           causal off and on): kernel, plain and library times beside the
           least time the card could take, and each row's kernel output held
           against its plain output within the bf16 limit above; then, at
           the headline, the kernel's and the library's device time per call
           from torch.profiler as a cross-check of the event times
   wide    the inputs the kernels took last, at full width, each call a
           line with kernel, plain and library ms, launches, the bound and
           the CUDA kernels torch.profiler traced in three calls (the port's
           own kernels only; the library's names where it runs at d > 256):
           DeepSeek-V3's absorbed-MLA decode in bf16 (q [32, 1, 128, 576]
           against a latent cache k [32, 1, 4096, 576], v [.., 512], ragged
           lengths; the wide kernel and its merge, one launch a call), flash
           attention at 576/512 ([1, 16, 2048], bf16, causal off and on; the
           wide kernel), the f16 flash headline and the f16 and bf16 decode
           serve shapes (the ring kernel alone, one split), each held
           against its plain version
   f32     f32 on the tensor cores (3xTF32) the same way: absorbed-MLA
           decode in f32 (the f32 decode kernel and its merge, one launch a
           call), the f32 flash headline and flash at 576/512, causal off
           and on (the any-dtype flash kernel);
           bounds at 3 TF32 products per f32 one (494.7 TFLOP/s) with the
           f32 SIMT bound (67 TFLOP/s) beside, shares against the first
   mixed   an f32 query over a bf16 cache the same way (no library call
           takes mixed dtypes): the decode serve shape on the ring kernel,
           absorbed-MLA decode on the mixed tensor-core kernel and its
           merge, the flash headline causal off and on (the any-dtype flash
           kernel); bounds at each
           product's own rate (S 2 TF32 products a multiply-add, P V at the
           bf16 rate), the TF32 products issued (P V 1) beside
   any     the any-dtype kernels the same way: K and V in different
           dtypes (an f32 q and K over a bf16 V) at the decode serve shape
           and the flash headline (causal off and on; no library call takes
           them), and bf16 at 1,024/1,024 (decode q [32, 4, 1, 1024] against
           the smoke's cache, flash [1, 8, 2048]) beside the library call;
           bounds: bytes, or each product at its operands' rate (16-bit at
           the bf16 rate), the TF32 products the kernel issues beside
   perwarp_rows  the calls a per-warp decode kernel used to take, the same
           way, beside the library call: f32 at 16 heads of 256 against the
           smoke's cache and lengths (R1) and at 4 sequences of the whole
           cache (R2) on the ring kernel's two-chunk form, bf16 at d = 66
           (R3) and the bf16 serve shape on K and V views off a 16-byte
           boundary (R4) on the any-dtype kernel; bound bytes at 3.35 TB/s
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
   processes  the port's binaries as OS processes, as a node runs them:
           the API server (``python -m ...k8sclient.httpapi``) and the GPU
           kubelet plugin on the machine's own device library (NVML), with
           its metrics, debug and (where ``grpc`` imports) gRPC health
           servers; over HTTP the DeviceClass, the Node and a claim for the
           card by UUID, which the plugin process prepares into a CDI spec
           that an engine binds to and serves 16 requests from (the
           selfheal batch) through the decode kernel; the prepare and the
           unprepare counted on its /metrics; every process exits 0 on
           SIGTERM and nothing is left (plugin_start_ms: spawn to the slice
           naming the card; claim_ready_ms and ttfb_ms over the wire;
           stop_ms). Then the webhook process against the in-process admit
           function on an admission corpus, and the ComputeDomain plugin
           (channel-0 and daemon published), ``daemon check`` (exit 0) and
           ``daemon run`` (its clique entry published and withdrawn) as
           processes on the same node. Beside the plugin the ComputeDomain
           controller runs as two sharded processes (--shards 4, ctl-a and
           ctl-b) that scrape its /metrics; the four shard Leases split
           between them, and the holder of shard 0 alone probes the node
           with canaries and meters the claim: the plugin up with a
           ``gpu_dra_fleet_*`` mirror, the SLOs listed and none firing before
           the claim, a canary probe ok (its CDI spec naming one of the
           node's GPUs), probes refused while the claim holds the card
           counted as such; the leader is sent SIGTERM under the claim and
           the other takes every shard with fresh singletons (handoff_ms),
           and bills the claim within 5% of its Ready-to-deleted span; exit
           0 on SIGTERM, no canary residue (controller_start_ms,
           first_scrape_ms, canary_ok, canary_refused, usage_gpu_s beside
           host_span_s, stop_ms). The plugin runs with --trace true: the
           claim's trace (the smoke's root span merged with the process's
           /debug/traces) passes the audit with node_prepare,
           checkpoint.transact and cdi.write, its phase breakdown is
           printed, and the prepare histogram's exemplar names it
   soak    ``run_serving_soak`` on the card with the JAX leg's defaults:
           two mock ``h100-8`` nodes, node 0 killed at 2 s, two tenant
           replicas cycling 0.35 s sessions whose engines (one attention
           layer of Llama-2-7B: 32 heads of 128, a 4096-token cache, 8
           slots) share the card; the soak's oracle whole (the claim_ready
           page fired on the loss and cleared after the rejoin, a resolved
           incident bundle, GPU-seconds conserved, green sessions after the
           rejoin, the accounting identity, isolation error under 1e-4) and
           the replicas' decode launches equal to their decode steps; then
           the decode kernel against its plain version at the engines'
           shape
   scale   ``run_serving_scale`` on the card with the JAX harness's
           defaults: tenant replicas claiming two GPUs of a mock ``h100-8``
           node each, measured at 1 and 4 replicas in interleaved arms,
           then the autoscale leg through a GPU-vanish flap and a restart
           of a node's prepare loop, then two shard-gated controllers
           under a churning replica; engines at the serve phase's width
           (32 slots, 32 heads of 128, a 4096-token cache: the shape the
           check phase holds the kernel to) share the card. Prints tokens/s
           at 1 and 4 replicas and their ratio (not held: one card), TTFB
           p50/p99, sessions, the legs' events and leaders, and the claims
           the restarted loop adopted from its checkpoint and unprepared
           (released or deleted while no loop ran); holds no error
           or leak, the accounting identity, isolation error under 1e-4,
           both legs ok, TTFB p99 within 1.5 s, and the replicas' decode
           launches equal to their decode steps
   mig     MIG partitions and VFIO passthrough in the GPU kubelet plugin:
           NVML's answer to the card's MIG mode (current and pending, or
           the NVML error), required off, and the plugin on that library
           with DynamicMIG on publishing the card whole and no MIG device;
           then a mock ``h100-8`` node in MIG mode with DynamicMIG on: its
           208 placements published, every device name a DNS label of at
           most 63 characters, two tenant claims for 3g.40gb given GPU
           0's two halves, a 4g.40gb and a whole-GPU claim there refused, each claim's CDI spec naming its own MIG-<uuid> and
           nvidia-caps nodes; an engine per claim at the serve phase's
           width bound through its spec (the mock's MIG UUIDs mapped onto
           the card), within its profile's memory, decoding 8 requests
           through the decode kernel under the serve checks, launches equal
           to the two engines' decode steps; the kernel against its plain
           version at that shape; nothing left after unprepare, and the
           4g.40gb claim then prepared, one 1g.10gb+me claim prepared on
           GPU 1 and a second one there refused (the GPU's one media
           counter); VFIO only on a materialized mock tree with the
           kernel's rebinding emulated, never on the card's /sys, its
           published names DNS labels too (claim_ready_ms, ttfb_ms,
           decode_tok_s)
   alloc   ``run_allocator_scale()`` at the port's defaults (6 mock
           ``h100-8`` nodes in MIG mode, 10,000 claims of 1-8 memory
           slices, target_util 0.8, then the defrag leg): both arms'
           trimmed allocations/s and p50/p99 allocation latency, whole-GPU
           admission rates and their ratio, fragmentation and the defrag
           line; holds zero errors, leaks and overcommit, the fragmentation
           gauge, the admission alert, every defrag probe unblocked within
           the eviction bound with no stuck victim, and an admission ratio
           of at least 1.5 (throughput is printed, not held: host only)
   wire    ``run_wire_path()`` (160 cycles): claim→ready over HTTP in the
           baseline and the optimized arm (p50/p90/p99, segments,
           p99_over_p50), copies per event, the coalesced status batches,
           the LIST memo's hits, the backpressure counts and the top of
           the contention before-picture; holds zero errors, leaks and
           overcommit, copies_halved and backpressure_counted. Then the
           served claim: a store at its defaults behind an in-process API
           server, the GPU plugin on the device library that found the
           card with its claim watcher, and the harness's contenders on
           the same store (3 status writers over 6 claims each, a
           reallocator, a fragmentation_report reader and a never-read
           watch of queue 4); a claim for the card by UUID created over
           HTTP, allocated, prepared and seen Ready on an HTTP watch; an
           engine at the serve phase's width bound from its CDI spec serves
           the selfheal batch through the decode kernel, launches equal to
           decode steps; unreserved, unprepared and deleted over HTTP with
           nothing left and the stalled watch cut off and counted
           (claim_ready_http_ms, ttfb_ms, status_batches, status_batched,
           dropped); then the decode kernel against its plain version at
           the engine's shape
   overhead  ``run_fleetwatch()``, ``run_blackbox_overhead()`` and
           ``run_canary_overhead()`` at their defaults on mock ``h100-8``
           nodes: detection and clear delays, false positives, the three
           overhead percentages (printed, not held: a shared host), probe
           and meter failures; holds the page fired and cleared within
           their bounds, no false positive, both injected fault points
           fired, no error or leak in any leg and no probe leaked
   crash   the crash explorer: ``run_crashlab()`` over its seven scenarios
           on mock ``h100-8`` nodes, twice (sites per scenario, torn
           variants, wall time; 0 oracle violations, coverage_ok, no
           uncrashed capable point, equal verdict logs). Then one claim for
           the card prepared by the GPU plugin on the device library that
           found the card, crashed at every site of its prepare as crashlab
           enumerates them and recovered (replay idempotent, spec present,
           nothing left after unprepare, every discarded plugin stopped);
           after the sweep the claim prepared again on the plugin recovered
           from the last site, and an engine at the serve phase's width
           bound from its CDI spec serves the selfheal batch through the
           decode kernel, launches equal to decode steps; then the kernel
           against its plain version at the engine's shape; no claim,
           checkpoint entry, CDI spec or thread left
   race    the race detector: ``run_race_smoke()`` (every planted positive
           on seeds 1-3, 0 false positives, a race-free, error-free and
           leak-free claim churn in race mode, the fuzzer deterministic);
           then, with ``GPU_DRA_SANITIZE=race`` and the detector on before
           the stack is built and under a seeded schedule fuzzer, the GPU
           plugin on the card's library with its claim watcher makes a
           claim for the card Ready, an engine bound from its CDI spec
           serves the selfheal batch through the decode kernel, and the
           claim is released and unprepared: no race report, no sanitizer
           violation, launches equal to decode steps, nothing left, the
           environment restored; then the kernel against its plain version
           at the engine's shape
   proto   the protocol model checker: ``run_proto_smoke()`` (7 of 7
           planted violations detected, each counterexample 1-minimal and
           replayed identically, the real elector and fence-ack models
           clean with their state counts, deterministic)
   cluster the port as a local cluster of real processes: first the
           ``localcluster demo`` child's eight phases on mock nodes, each
           phase's seconds; then one node whose GPU plugin process reads
           the card through NVML behind the webhook, ``gpu-test2.yaml``
           applied unchanged, its claim prepared by the process, both
           containers' CUDA_VISIBLE_DEVICES the card's UUID, an engine at
           the serve phase's width bound from the claim's CDI spec serving
           the selfheal batch through the decode kernel (launches equal to
           decode steps), the pod retired with nothing left; prints
           cluster_up_ms, claim_ready_ms and first_batch_ms; then the
           kernel against its plain version at the engine's shape
   gates   the feature gates a plugin process starts with: on mock nodes
           behind one API server, the GPU and ComputeDomain plugin binaries
           refusing DeviceMetadata without PassthroughSupport (exit
           non-zero within seconds, ``invalid --feature-gates`` naming
           PassthroughSupport, no slice), CrashOnNVLinkFabricErrors
           refusing a node whose GPUs share a minor that the lenient
           plugin publishes, and gpu-test6's VFIO claim carrying the
           tree's pciAddress and iommuGroup as metadata on its status read
           over HTTP with DeviceMetadata on, none with it off; then a
           plugin process on the card through NVML under DeviceMetadata,
           PassthroughSupport and CrashOnNVLinkFabricErrors publishing the
           card by UUID, a whole-GPU claim over HTTP Ready with no
           metadata, an engine at the serve phase's width bound from its
           CDI spec serving the selfheal batch through the decode kernel
           (launches equal to decode steps), nothing left; prints
           claim_ready_ms and ttfb_ms; then the kernel against its plain
           version at the engine's shape
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
burnin, each of selfheal's two batches, the processes batch, the soak,
the scale harness, the mig tenants, the wire phase's claim, the crash
and race phases' claims, the cluster phase's pod and the gates phase's
claim) runs with every kernel's launch count set to 0
just before it and read just after. Then one
JSON line with every kernel's numbers, and the last line ``{"ok": true,
"device": {...}}``. Any failure raises and exits non-zero before that line;
without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import logging
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch

from k8s_dra_driver_tpu_torch.cdi.spec import CDIHandler, claim_spec_env
from k8s_dra_driver_tpu_torch.compute import _build, _dist
from k8s_dra_driver_tpu_torch.compute.burnin import matmul_flops_bench
from k8s_dra_driver_tpu_torch.compute import flashattention
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    decode_attention_reference,
    f32_decode_splits,
    flash_attention,
    flash_attention_decode,
    padded_head_dims,
    stream_decode_pad,
    stream_decode_plan,
    tuned_kernel_takes,
    tuned_decode_splits,
    tuned_decode_tile,
    wide_decode_splits,
    wide_kernel_takes,
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
from k8s_dra_driver_tpu_torch.api.configs import API_VERSION
from k8s_dra_driver_tpu_torch.gpulib.chip import mig_device_name
from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
    BACKEND_NVML,
    BACKEND_PROCFS,
    FakeVfioKernel,
    MockDeviceLib,
    SysfsDeviceLib,
    find_nvml,
    locate_gpu,
    new_device_lib,
)
from k8s_dra_driver_tpu_torch.internal.racecorpus import run_race_smoke
from k8s_dra_driver_tpu_torch.internal.stresslab import (
    SERVING_SMOKE_ENGINE,
    WireContenders,
    run_allocator_scale,
    run_blackbox_overhead,
    run_canary_overhead,
    run_fleetwatch,
    run_serving_scale,
    run_serving_smoke,
    run_serving_soak,
    run_wire_path,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.k8sclient.httpapi import (
    ApiServer,
    HttpClient,
    HttpWatch,
)
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import AllocationError
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ANN_DRAIN,
    ClaimReallocator,
    DrainController,
    SimulatedRepair,
    mutate_claim_with_retry,
    parse_gpu_index,
)
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg import (
    bootid,
    crashlab,
    faultpoints,
    protolab,
    racelab,
    sanitizer,
    tracing,
)
from k8s_dra_driver_tpu_torch.pkg.canary import (
    CanaryProber,
    driver_probe_hooks,
)
from k8s_dra_driver_tpu_torch.pkg.errors import is_permanent
from k8s_dra_driver_tpu_torch.pkg.featuregates import new_feature_gates
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
    CD_DRIVER_NAME,
    MASTER_PORT,
    PREPARE_ABORTED_TTL,
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import partitions
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_ABORTED,
    STATE_PREPARE_COMPLETED,
    Checkpoint,
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
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.vfio import (
    VfioPciManager,
)
from k8s_dra_driver_tpu_torch.plugins.webhook.admission import review_response

# The smoke's width: one attention layer of Llama-2-7B's published config
# (hidden 4096 = 32 heads x head_dim 128, max_position_embeddings 4096),
# with 32 sequences in flight.
BATCH, HEADS, HEAD_DIM, KV_CAP = 32, 32, 128, 4096
# H100 SXM published peaks: HBM bandwidth, f32 outside the tensor cores, and
# dense bf16 on the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
BF16_FLOP_S = 989.4e12
# Dense TF32 on the tensor cores; the f32 route spends 3 TF32 products on
# each f32 one (3xTF32).
TF32_FLOP_S = 494.7e12


def attention_flops_ms(s_macs: int, pv_macs: int, dtypes: str) -> float:
    """The least time of attention's two products on the tensor cores:
    S = Q Kᵀ (``s_macs`` multiply-adds) and P V (``pv_macs``), each at its
    operands' own rate. Two 16-bit operands: the 16-bit rate. An f32
    operand: the TF32 products that keep f32's precision (2 beside a 16-bit
    operand, 3 beside an f32 one) at the TF32 rate. P takes V's dtype (p is
    rounded to it). ``dtypes`` is "q/k/v", e.g. "float32/float32/bfloat16".
    """
    q32, k32, v32 = (t == "float32" for t in dtypes.split("/"))

    def product_ms(macs: int, a32: bool, b32: bool) -> float:
        if not (a32 or b32):
            return 2 * macs / BF16_FLOP_S * 1e3
        return 2 * macs * (1 + a32 + b32) / TF32_FLOP_S * 1e3

    return product_ms(s_macs, q32, k32) + product_ms(pv_macs, v32, v32)
# The compute bench's flash-attention headline shape [b, h, S, d], and its
# sweep: seq 512-8192 at a constant b * seq = 8192 tokens, h = 8, d = 128.
FLASH_SHAPE = (4, 8, 2048, 128)
FLASH_SWEEP_SEQS = (512, 1024, 2048, 4096, 8192)
# The wide leg: DeepSeek-V3's absorbed-MLA decode (its config.json:
# num_attention_heads 128, kv_lora_rank 512 + qk_rope_head_dim 64 = 576 key
# columns, 512 value columns; the 128 query heads of one token folded into
# the query rows of the one latent KV head), at the smoke's 32 sequences and
# 4096-token cache; and flash attention at those head dims, [b, h, S].
MLA_ROWS, MLA_D, MLA_DV = 128, 576, 512
WIDE_FLASH_SHAPE = (1, 16, 2048)
# Sequence lengths of the flash check's small variants (tile edges), and of
# its wide checks (the wide kernel's 64-row query and 32-key tiles).
FLASH_EDGE_SEQS = (1, 64, 100, 129, 192, 256, 320)
WIDE_FLASH_SEQS = (1, 63, 64, 65, 129, 320)
# The f32 route's head-dim buckets (4/4, 8/8 and 18/8 panels of 32
# columns) checked at WIDE_FLASH_SEQS, which are its 64-row and 64-key
# tiles' edges too.
F32_FLASH_DIMS = ((128, 128), (256, 256), (MLA_D, MLA_DV))
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
# f16 and a mix of dtypes take the bf16 limits wherever any of q, k and v
# is 16-bit: f16 rounds p and the output finer than bf16, and q.k is exact
# f32 in every mix.
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# q, k and v in different dtypes: K and V sharing one (the mixed routes'
# classes: an f32 q over a 16-bit cache, a 16-bit q over an f32 one, a bf16
# q over an f16 one), then K and V apart (the any-dtype kernels').
MIXED_DTYPES = ((torch.float32, torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.float16, torch.float16),
                (torch.bfloat16, torch.float16, torch.float16),
                (torch.bfloat16, torch.float32, torch.float32),
                (torch.float32, torch.float32, torch.bfloat16))
# The mixed routes' classes at full width: an f32 q over a bf16 and over an
# f16 cache, a bf16 q over an f32 one.
MIXED_FULL = ((torch.float32, torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.float16, torch.float16),
              (torch.bfloat16, torch.float32, torch.float32))
# Head dims (d, dv) past the tuned kernels: past them by one,
# 320, 512, DeepSeek-V3's absorbed-MLA decode (keys kv_lora_rank 512 +
# qk_rope_head_dim 64, values 512), 1024, and dv over 256 beside a narrow d.
GENERAL_DIMS = ((257, 257), (320, 320), (512, 512), (576, 512), (1024, 1024),
                (64, 640))
# The masked-tail poison: f16 holds no 1e6 (its largest value is 65504).
POISON, F16_POISON = 1e6, 6e4
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


def decode_tol(*dtypes) -> float:
    """The decode limit of a call with these input dtypes: f32's where all
    are f32, else bf16's."""
    return F32_TOL if set(dtypes) == {torch.float32} else BF16_TOL


def flash_tol(*dtypes) -> tuple:
    """The flash (atol, rtol) of a call with these input dtypes."""
    return (FLASH_F32_TOL if set(dtypes) == {torch.float32}
            else FLASH_BF16_TOL)


def dtype_names(*dtypes) -> str:
    return "/".join(str(t)[6:] for t in dtypes)


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
    """The device library on the machine's own roots. Every GPU that the
    host's library (``new_device_lib``: NVML where ``libnvidia-ml.so.1``
    is present, else procfs) finds is printed; then ``locate_gpu`` must
    find the card torch uses (``cuda:0``) by its UUID, with memory
    within 1% of torch's total and its ``/dev/nvidia<minor>`` node.
    Returns that GPU and the library that found it."""
    want = torch_uuid(0)
    total = torch.cuda.get_device_properties(0).total_memory
    line("enumerate", torch_uuid=want, torch_total_memory=total,
         nvml=json.dumps(find_nvml() or ""))
    lib = new_device_lib()
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


# The 16-bit element types a kernel template may take, as the build report
# names them.
_TYPE_ARGS = {"__nv_bfloat16": "bf16", "__half": "f16"}


def kernel_name(mangled: str, names: list) -> str:
    """``flash_bf16_kernel<128>`` or ``wide_flash_kernel<bf16>`` from a
    mangled name, given the names of the source's kernels."""
    for name in sorted(names, key=len, reverse=True):
        i = mangled.find(name)
        if i >= 0:
            rest = mangled[i + len(name):]
            args = ([m.group(1) or _TYPE_ARGS[m.group(2)] for m in re.finditer(
                r"L[ib](\d+)E|\d+(__nv_bfloat16|__half)",
                rest.split("Ev", 1)[0])] if rest.startswith("I") else [])
            return f"{name}<{','.join(args)}>" if args else name
    return mangled


def phase_build() -> None:
    """Builds every kernel source; prints, for each kernel, ptxas's
    registers, static shared memory and spills, and how many of its SASS
    instructions are warpgroup MMAs (HGMMA), TMA loads (UTMALDG) and 1-D
    bulk copies (UBLKCP). Every bf16 and f16 flash kernel and every wide
    decode and flash kernel must have the first two, and every tuned decode
    ring kernel and every any-dtype decode kernel the bulk copy its K and V
    tiles arrive by; every f32 and mixed decode kernel and every any-dtype
    flash kernel TF32 wgmmas only, TMA loads and no spill."""
    t0 = time.monotonic()
    built = _build.build_all(force=True)
    require(bool(built), "no kernel source was built")
    # Every library's SASS at once (cuobjdump a process each).
    with concurrent.futures.ThreadPoolExecutor(len(built)) as pool:
        listings = dict(zip(built, pool.map(_build.disassemble, built)))
    # Kernels are defined in the sources and in the headers they include.
    headers = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cuh")))
    for name, (s, log) in sorted(built.items()):
        src = (_build.CSRC / f"{name}.cu").read_text() + headers
        names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                           r"\s*)?(\w+)\s*\(", src)
        sass = {}
        for fn in listings[name].split("Function : ")[1:]:
            sass[fn.split(None, 1)[0]] = (len(re.findall(r"\bHGMMA\.", fn)),
                                          len(re.findall(r"\bUTMALDG\.", fn)),
                                          len(re.findall(r"\bUBLKCP\.", fn)),
                                          len(re.findall(r"\bHGMMA\.\S*TF32",
                                                         fn)))
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
            hgmma, utmaldg, ublkcp, tf32 = sass.get(mangled, (0, 0, 0, 0))
            line("build", kernel=kernel,
                 registers=regs.group(1) if regs else "?",
                 static_smem_bytes=smem.group(1) if smem else 0,
                 spill_bytes=spills, sass_HGMMA=hgmma, sass_UTMALDG=utmaldg,
                 sass_UBLKCP=ublkcp, sass_HGMMA_TF32=tf32)
            if kernel.startswith(("flash_bf16_kernel", "flash_f16_kernel",
                                  "wide_flash_kernel", "wide_decode_kernel")):
                require(hgmma > 0 and utmaldg > 0,
                        f"{kernel} has no wgmma or no TMA load in its SASS")
            if kernel.startswith("decode_ring_kernel"):
                require(ublkcp > 0, f"{kernel} has no bulk copy in its SASS")
            if kernel.startswith("stream_decode_kernel"):
                # Both variants: tiles as they are, or the 16-byte chunks
                # around them.
                require(ublkcp > 0, f"{kernel} has no bulk copy in its SASS")
            if kernel.startswith(("f32tc_decode_kernel",
                                  "cluster_flash_kernel")):
                require(tf32 > 0 and tf32 == hgmma and utmaldg > 0
                        and spills == 0 and regs is not None,
                        f"{kernel}: {tf32} TF32 wgmmas of {hgmma}, "
                        f"{utmaldg} TMA loads, {spills} bytes spilled")
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
        qh, kh, vh = q.half(), k.half(), v.half()
        outh = flash_attention_decode(qh, kh, vh, lens)
        eh = (outh.float() - decode_attention_reference(qh, kh, vh, lens)
              .float()).abs().max().item()
        require(outh.dtype == torch.float16, f"f16 output {outh.dtype}")
        # Poison every key beyond each length: a masked read would swamp it.
        eps = []
        for qq, kk, vv, oo, poison in ((q, k, v, out, POISON),
                                       (qh, kh, vh, outh, F16_POISON)):
            kp, vp = kk.clone(), vv.clone()
            for i, n in enumerate(lens.tolist()):
                kp[i, :, n:, :] = poison
                vp[i, :, n:, :] = -poison
            eps.append((flash_attention_decode(qq, kp, vp, lens).float()
                        - oo.float()).abs().max().item())
            del kp, vp
        ep, eph = eps
        del qh, kh, vh
        line("check", kernel="decode_attention", ql=ql, f32_max_abs_err=e32,
             bf16_max_abs_err=e16, f16_max_abs_err=eh,
             poisoned_tail_max_abs_diff=ep,
             f16_poisoned_tail_max_abs_diff=eph)
        require(e32 < F32_TOL, f"f32 error {e32} >= {F32_TOL} at ql={ql}")
        require(e16 < BF16_TOL, f"bf16 error {e16} >= {BF16_TOL} at ql={ql}")
        require(eh < BF16_TOL, f"f16 error {eh} >= {BF16_TOL} at ql={ql}")
        require(ep < POISON_TOL, f"poisoned tail moved the output by {ep}")
        require(eph < POISON_TOL,
                f"poisoned f16 tail moved the output by {eph}")
        worst_f32 = max(worst_f32, e32)
    # Every compiled variant at a small shape: each q_len (the ring kernel
    # is built for 1, 2, 4 and 8 rows), the ring kernel (d = 128, and 256:
    # two 16-byte chunks a lane in f32), the any-dtype kernel's element
    # reads (d = 66 is not a whole number of 16-byte chunks), every dtype.
    small = np.array([1, 45, 300], np.int32)
    worst, moved = 0.0, 0.0
    for ql in range(1, 9):
        for d in (66, 128, 256):
            args = [torch.from_numpy(a).to(dev) for a in (
                rng.standard_normal((3, 2, ql, d), np.float32),
                rng.standard_normal((3, 2, 300, d), np.float32),
                rng.standard_normal((3, 2, 300, d), np.float32), small)]
            for dtype in DTYPES:
                tol = decode_tol(dtype)
                a = [t.to(dtype) for t in args[:3]] + args[3:]
                out = flash_attention_decode(*a, block_k=300)
                err = (out.float() - decode_attention_reference(*a).float()
                       ).abs().max().item()
                require(err < tol, f"{dtype} ql={ql} d={d}: error {err}")
                worst = max(worst, err / tol)
                moved = max(moved, poisoned_shift(a, out))
    require(moved < POISON_TOL,
            f"ql 1-8 variants: a poisoned tail moved the output by {moved}")
    line("check", kernel="decode_attention", variants="ql 1-8 x d 66/128/256"
         " x f32/bf16/f16", worst_err_over_tol=worst,
         poisoned_tail_max_abs_diff=moved)
    # The shapes beyond one launch that the JAX function takes: v's head dim
    # unlike k's, and more than 8 query rows, which the wrapper gives the
    # ring kernel in groups of 8 (ql 16: two launches; ql 20: three, the
    # last of 4 rows); 66/130 takes the any-dtype kernel, one launch.
    worst, moved = 0.0, 0.0
    for ql, d, dv in ((1, 64, 128), (4, 128, 64), (2, 66, 130), (16, 128, 128),
                      (20, 64, 32)):
        args = [torch.from_numpy(a).to(dev) for a in (
            rng.standard_normal((3, 2, ql, d), np.float32),
            rng.standard_normal((3, 2, 300, d), np.float32),
            rng.standard_normal((3, 2, 300, dv), np.float32), small)]
        for dtype in DTYPES:
            tol = decode_tol(dtype)
            a = [t.to(dtype) for t in args[:3]] + args[3:]
            before = flash_attention_decode.launches
            out = flash_attention_decode(*a, block_k=300)
            groups = flash_attention_decode.launches - before
            ref = decode_attention_reference(*a)
            require(out.shape == ref.shape == (3, 2, ql, dv),
                    f"ql={ql} d={d} dv={dv}: output {tuple(out.shape)}")
            err = (out.float() - ref.float()).abs().max().item()
            require(err < tol, f"{dtype} ql={ql} d={d} dv={dv}: error {err}")
            want = -(-ql // 8) if decode_route(*a[:3]) == "tuned" else 1
            require(groups == want, f"ql={ql} d={d} dv={dv}: {groups} "
                                    f"launches, not {want}")
            worst = max(worst, err / tol)
            moved = max(moved, poisoned_shift(a, out))
    require(moved < POISON_TOL,
            f"dv != d variants: a poisoned tail moved the output by {moved}")
    line("check", kernel="decode_attention",
         variants="dv != d and ql 16/20 (launches of 8 rows) x f32/bf16/f16",
         worst_err_over_tol=worst, poisoned_tail_max_abs_diff=moved)
    general_dims_check(rng)
    wide_decode_check(rng)
    f32_decode_check(rng)
    tuned_decode_check(rng)
    mixed_decode_check(rng)
    stream_decode_check(rng)
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


def poisoned_shift(a: list, out: torch.Tensor) -> float:
    """How far ``flash_attention_decode`` moves from ``out`` when every key
    of ``a`` (q, k, v, lengths) past its sequence's length is poisoned:
    +-POISON in K and -+ in V (+-F16_POISON in f16)."""
    q, k, v, lens = a
    kp, vp = poisoned(k, v, lens.tolist())
    return (flash_attention_decode(q, kp, vp, lens, block_k=k.shape[2])
            .float() - out.float()).abs().max().item()


def general_dims_check(rng: np.random.Generator) -> float:
    """The decode kernels beyond the tuned ones at small shapes (3
    sequences of lengths 1, 45 and 300, 2 heads). Returns the worst error's
    share of its limit."""
    dev = torch.device("cuda", 0)
    small = np.array([1, 45, 300], np.int32)
    # Every head dim of GENERAL_DIMS in each dtype and in each MIXED_DTYPES
    # mix, and the mixes at tuned head dims (128/128, and 66/130, whose rows
    # the ring kernel does not take), each held to its narrowest input's
    # limit: one launch a call where the wide, the f32, the mixed or the
    # any-dtype kernel takes it (bf16 and f16 up to 576/512; f32; q's dtype
    # apart from K's and V's shared one up to 576/512; everything else),
    # held to the flash limit too, which a 1% scale or a dropped split
    # exceeds and the decode limit alone may not; the ring kernel's (a mixed
    # call at d, dv <= 256 on rows of whole 16-byte chunks) one launch per 8
    # query rows.
    cases = [(ql, d, dv, ts) for d, dv in GENERAL_DIMS for ql in (1, 8, 10)
             for ts in [(t,) * 3 for t in DTYPES] + list(MIXED_DTYPES)]
    cases += [(ql, d, dv, ts) for ts in MIXED_DTYPES
              for d, dv in ((128, 128), (66, 130)) for ql in (1, 4)]
    worst, one_over = 0.0, 0.0
    calls = {"wide": 0, "f32": 0, "mixed": 0, "ring_mixed": 0, "stream": 0}
    for ql, d, dv, ts in cases:
        a = [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, t) for shape, t in (((3, 2, ql, d), ts[0]),
                                     ((3, 2, 300, d), ts[1]),
                                     ((3, 2, 300, dv), ts[2]))]
        a.append(torch.from_numpy(small).to(dev))
        route = decode_route(*a[:3])
        calls[route] += route != "tuned"
        before = flash_attention_decode.launches
        out = flash_attention_decode(*a, block_k=300)
        groups = flash_attention_decode.launches - before
        ref = decode_attention_reference(*a)
        what = f"{dtype_names(*ts)} ql={ql} d={d} dv={dv} ({route})"
        require(out.shape == ref.shape == (3, 2, ql, dv)
                and out.dtype == ts[0], f"{what}: output {tuple(out.shape)} "
                                        f"{out.dtype}")
        err = (out.float() - ref.float()).abs().max().item()
        require(err < decode_tol(*ts), f"{what}: error {err}")
        want = -(-ql // 8) if route in ("tuned", "ring_mixed") else 1
        require(groups == want, f"{what}: {groups} launches, not {want}")
        if want == 1:
            over = compare(out, ref, *flash_tol(*ts))[1]
            require(over <= 1, f"{what}: {over} of the flash limit")
            one_over = max(one_over, over)
        worst = max(worst, err / decode_tol(*ts))
    line("check", kernel="decode_attention", variants=json.dumps(
        "d/dv " + ", ".join(f"{d}/{dv}" for d, dv in GENERAL_DIMS)
        + " x ql 1/8/10 x f32/bf16/f16 and q/k/v "
        + ", ".join(dtype_names(*ts) for ts in MIXED_DTYPES)
        + "; those mixes x d/dv 128/128, 66/130 x ql 1/4"), calls=len(cases),
        **{f"{route}_calls": n for route, n in calls.items()},
        worst_err_over_tol=worst,
        one_launch_worst_err_over_flash_limit=one_over)
    require(calls["stream"] > 0, "no call reached the any-dtype kernel")
    return worst


def decode_route(q, k, v) -> str:
    """Which decode kernel the wrapper gives these inputs
    (``flashattention.decode_route``): ``tuned``, ``ring_mixed`` (the ring
    kernel under a q of another dtype), ``wide``, ``f32``, ``mixed`` or
    ``stream`` (the any-dtype kernel)."""
    route = flashattention.decode_route(q, k, v)
    if route == "tuned" and q.dtype != k.dtype:
        return "ring_mixed"
    return route


# The any-dtype decode kernel's edge cases (``stream_decode_check``): q, k
# and v dtypes, head dims d and dv, query rows, and whether the cache is a
# view one element off a 16-byte boundary (the element variant, which
# copies the 16-byte chunks around each tile, as are rows that are not
# whole 16-byte chunks: 66/130, 66, an odd d in f32).
STREAM_CHECKS = (
    ((torch.bfloat16,) * 3, 1024, 1024, 1, False),
    ((torch.float32,) * 3, 1024, 1024, 1, False),
    ((torch.float32, torch.float32, torch.bfloat16), 128, 128, 1, False),
    ((torch.float32, torch.float32, torch.float16), 64, 640, 10, False),
    ((torch.bfloat16, torch.float16, torch.float16), 66, 130, 1, False),
    ((torch.float32, torch.bfloat16, torch.bfloat16), 128, 128, 1, True),
    ((torch.bfloat16,) * 3, 66, 66, 1, False),
    ((torch.float16,) * 3, 128, 128, 3, True),
    ((torch.float32,) * 3, 65, 65, 2, False),
)


def stream_decode_check(rng: np.random.Generator) -> float:
    """The any-dtype decode kernel at each of STREAM_CHECKS, 8 sequences of
    one head against a cache of 2,048 keys split across blocks
    (``stream_decode_plan``): lengths 1, the tile's edges (T - 1, T, T +
    1), a split's edges and the cache. Each call one launch (the kernel and
    its merge) within its narrowest input's decode and flash limits; then
    every key past each length is poisoned (+-POISON in K, -+ in V,
    +-F16_POISON in f16), which must move the output by less than
    POISON_TOL. Returns the worst error's share of the flash limit."""
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, cap = 8, 2048
    worst, fields = 0.0, {}
    for ts, d, dv, ql, offset in STREAM_CHECKS:
        q = torch.from_numpy(rng.standard_normal((n, 1, ql, d), np.float32)
                             ).to(dev, ts[0])
        k, v = (torch.from_numpy(rng.standard_normal(
            (n, 1, cap, w), np.float32)).to(dev, t)
            for w, t in ((d, ts[1]), (dv, ts[2])))
        def placed(t):
            # With `offset`, the same cache as a view that starts one
            # element in (its poisoned copy too: the same variant).
            if not offset:
                return t
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
            flat[1:] = t.reshape(-1)
            view = flat[1:].view(t.shape)
            require(view.data_ptr() % 16 != 0, "the view is aligned")
            return view

        k = placed(k)
        # The wrapper's plan: its tile and splits, whose edges the lengths
        # hit (stage buffers 16 bytes longer for a view off 16 bytes).
        rows, tile, splits, split_keys = stream_decode_plan(
            n, 1, ql, cap, d, dv, ts[1].itemsize, ts[2].itemsize, sms,
            stream_decode_pad(k, v, d, dv))
        require(splits > 1, f"stream check {d}/{dv}: one split")
        lens_np = np.array(sorted({1, max(1, tile - 1), tile, tile + 1,
                                   split_keys - 1, split_keys,
                                   split_keys + 1, cap}), np.int32)[:n]
        lens_np = np.pad(lens_np, (0, n - len(lens_np)), constant_values=cap)
        lens = torch.from_numpy(lens_np).to(dev)
        what = (f"stream decode {dtype_names(*ts)} d={d} dv={dv} ql={ql}"
                + (" (view off 16 bytes)" if offset else ""))
        route = decode_route(q, k, v)
        require(route == "stream", f"{what}: routed to {route}")
        before = flash_attention_decode.launches
        out = flash_attention_decode(q, k, v, lens)
        calls = flash_attention_decode.launches - before
        ref = decode_attention_reference(q, k, v, lens)
        require(out.shape == ref.shape and out.dtype == ts[0]
                and bool(torch.isfinite(out).all()) and calls == 1,
                f"{what}: output {tuple(out.shape)} {out.dtype}, "
                f"{calls} launches")
        err = (out.float() - ref.float()).abs().max().item()
        over = compare(out, ref, *flash_tol(*ts))[1]
        require(err < decode_tol(*ts) and over <= 1,
                f"{what}: error {err}, {over} of the flash limit")
        kp, vp = k.clone(), v.clone()
        for i, m in enumerate(lens_np.tolist()):
            kp[i, :, m:] = F16_POISON if k.dtype == torch.float16 else POISON
            vp[i, :, m:] = -(F16_POISON if v.dtype == torch.float16
                             else POISON)
        moved = (flash_attention_decode(q, placed(kp), vp, lens).float()
                 - out.float()).abs().max().item()
        require(moved < POISON_TOL, f"{what}: the poisoned tail moved the "
                                    f"output by {moved}")
        key = f"{dtype_names(*ts).replace('/', '_')}_{d}_{dv}" + (
            "_offset" if offset else "")
        fields[key] = json.dumps({"rows": rows, "tile": tile,
                                  "splits": splits, "split_keys": split_keys,
                                  "err_over_flash_limit": over,
                                  "poisoned_tail_max_abs_diff": moved})
        worst = max(worst, over)
        del q, k, v, kp, vp, out, ref
    line("check", kernel="decode_attention", route="stream", seqs=n,
         cap=cap, **fields, worst_err_over_flash_limit=worst)
    return worst


def wide_decode_check(rng: np.random.Generator) -> float:
    """The wide decode kernel at DeepSeek-V3's absorbed-MLA layout (128
    query rows against one latent head, 576/512, the smoke's cache) in bf16
    and f16: one sequence at each of the lengths 1, 31, 32 and 33 (a key
    tile's edges), the first split's last key and the one after it, and
    the whole cache. Each call is one launch within BF16_TOL of its plain
    version and within the flash limit FLASH_BF16_TOL (atol, rtol); then
    every key past each length is poisoned (+-POISON in K, -+ in V;
    +-F16_POISON in f16), which must move the output by less than
    POISON_TOL. Returns the worst error's share of the flash limit."""
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 7
    split_keys = wide_decode_splits(n, 1, MLA_ROWS, KV_CAP, sms)[1]
    lens_np = np.array([1, 31, 32, 33, split_keys, split_keys + 1, KV_CAP],
                       np.int32)
    lens = torch.from_numpy(lens_np).to(dev)
    shapes = ((n, 1, MLA_ROWS, MLA_D), (n, 1, KV_CAP, MLA_D),
              (n, 1, KV_CAP, MLA_DV))
    base = [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
            for shape in shapes]
    worst, fields = 0.0, {}
    for dtype, poison in ((torch.bfloat16, POISON),
                          (torch.float16, F16_POISON)):
        q, k, v = (t.to(dtype) for t in base)
        before = flash_attention_decode.launches
        out = flash_attention_decode(q, k, v, lens)
        calls = flash_attention_decode.launches - before
        ref = decode_attention_reference(q, k, v, lens)
        what = f"wide decode {dtype_names(dtype)} absorbed MLA"
        require(out.shape == ref.shape and out.dtype == dtype
                and bool(torch.isfinite(out).all()),
                f"{what}: output {tuple(out.shape)} {out.dtype}")
        require(calls == 1, f"{what}: {calls} launches, not 1")
        err, over = compare(out, ref, *FLASH_BF16_TOL)
        require(err < BF16_TOL, f"{what}: error {err} >= {BF16_TOL}")
        require(over <= 1, f"{what}: {over} of the flash limit")
        kp, vp = k.clone(), v.clone()
        for i, m in enumerate(lens_np.tolist()):
            kp[i, :, m:] = poison
            vp[i, :, m:] = -poison
        moved = (flash_attention_decode(q, kp, vp, lens).float()
                 - out.float()).abs().max().item()
        require(moved < POISON_TOL, f"{what}: the poisoned tail moved the "
                                    f"output by {moved}")
        name = dtype_names(dtype)
        fields[f"{name}_max_abs_err"] = err
        fields[f"{name}_err_over_flash_limit"] = over
        fields[f"{name}_poisoned_tail_max_abs_diff"] = moved
        worst = max(worst, over)
        del q, k, v, kp, vp, out, ref
    line("check", kernel="decode_attention", route="wide",
         layout=json.dumps([list(t) for t in shapes]),
         lens=json.dumps(lens_np.tolist()), split_keys=split_keys,
         launches_per_call=1, **fields,
         flash_atol_rtol=json.dumps(FLASH_BF16_TOL))
    torch.cuda.empty_cache()
    return worst


def f32_decode_check(rng: np.random.Generator) -> float:
    """The f32 decode kernel (3xTF32) at DeepSeek-V3's absorbed-MLA layout
    (576/512, the smoke's cache) at 128 query rows and 1: one sequence at
    each of the lengths 1, 31, 32, 33, 63, 64 and 65 (the wide and the f32
    kernels' key tiles' edges), the first split's last key and the keys
    either side, and the whole cache. Each call is one launch within F32_TOL
    of its plain version and within the flash limit FLASH_F32_TOL (atol,
    rtol); then every key past each length is poisoned (+-POISON in K, -+
    in V), which must move the output by less than POISON_TOL. Returns the
    worst error's share of the flash limit."""
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 11
    worst, fields = 0.0, {}
    for ql in (MLA_ROWS, 1):
        split_keys = f32_decode_splits(n, 1, ql, KV_CAP, MLA_DV, sms)[1]
        lens_np = np.array([1, 31, 32, 33, 63, 64, 65, split_keys - 1,
                            split_keys, split_keys + 1, KV_CAP], np.int32)
        lens = torch.from_numpy(lens_np).to(dev)
        shapes = ((n, 1, ql, MLA_D), (n, 1, KV_CAP, MLA_D),
                  (n, 1, KV_CAP, MLA_DV))
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev) for shape in shapes)
        before = flash_attention_decode.launches
        out = flash_attention_decode(q, k, v, lens)
        calls = flash_attention_decode.launches - before
        ref = decode_attention_reference(q, k, v, lens)
        what = f"f32 decode absorbed MLA ql={ql}"
        require(out.shape == ref.shape and out.dtype == torch.float32
                and bool(torch.isfinite(out).all()),
                f"{what}: output {tuple(out.shape)} {out.dtype}")
        require(calls == 1, f"{what}: {calls} launches, not 1")
        err, over = compare(out, ref, *FLASH_F32_TOL)
        require(err < F32_TOL, f"{what}: error {err} >= {F32_TOL}")
        require(over <= 1, f"{what}: {over} of the flash limit")
        kp, vp = k.clone(), v.clone()
        for i, m in enumerate(lens_np.tolist()):
            kp[i, :, m:] = POISON
            vp[i, :, m:] = -POISON
        moved = (flash_attention_decode(q, kp, vp, lens)
                 - out).abs().max().item()
        require(moved < POISON_TOL, f"{what}: the poisoned tail moved the "
                                    f"output by {moved}")
        fields[f"ql{ql}_split_keys"] = split_keys
        fields[f"ql{ql}_max_abs_err"] = err
        fields[f"ql{ql}_err_over_flash_limit"] = over
        fields[f"ql{ql}_poisoned_tail_max_abs_diff"] = moved
        worst = max(worst, over)
        del q, k, v, kp, vp, out, ref
    line("check", kernel="decode_attention", route="f32",
         layout=json.dumps([[n, 1, "ql", MLA_D], [n, 1, KV_CAP, MLA_D],
                            [n, 1, KV_CAP, MLA_DV]]),
         lens="1,31,32,33,63,64,65,split-1,split,split+1,cap",
         launches_per_call=1, **fields,
         flash_atol_rtol=json.dumps(FLASH_F32_TOL))
    torch.cuda.empty_cache()
    return worst


def poisoned(k: torch.Tensor, v: torch.Tensor, lens: list) -> tuple:
    """Copies of a cache with every key past each sequence's length set to
    +-POISON (+-F16_POISON in f16, which holds no 1e6): a masked key that
    is read swamps the output."""
    kp, vp = k.clone(), v.clone()
    for t, sign in ((kp, 1), (vp, -1)):
        poison = F16_POISON if t.dtype == torch.float16 else POISON
        for i, n in enumerate(lens):
            t[i, :, n:] = sign * poison
    return kp, vp


def mixed_decode_check(rng: np.random.Generator) -> float:
    """Decode whose q's dtype differs from the one K and V share, in each
    MIXED_FULL class: at the serve shape (q [32, 32, 1, 128] against the
    smoke's cache width and lengths) on the ring kernel, one launch a call;
    at DeepSeek-V3's absorbed-MLA layout (576/512, the smoke's cache) at 128
    query rows and 1 on the mixed tensor-core kernel, one launch a call,
    one sequence at each of the lengths 1, 31, 32, 33, 63, 64, 65, the first
    split's last key and the keys either side, and the cache. Each call
    within its narrowest input's limit (BF16_TOL) and the flash limit
    FLASH_BF16_TOL (atol, rtol); then the tail past each length poisoned,
    which must move the output by less than POISON_TOL. Then, on the mixed
    tensor-core kernel with an f32 q over a bf16 and an f16 cache of one
    key tile, what the bf16 limit cannot see (``nearest_semantics``).
    Returns the worst error's share of the flash limit."""
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    serve_lens = smoke_lengths(rng)
    n = 11
    cases = [("serve", 1, HEAD_DIM, HEAD_DIM, serve_lens)]
    for ql in (MLA_ROWS, 1):
        split_keys = f32_decode_splits(n, 1, ql, KV_CAP, MLA_DV, sms)[1]
        cases.append((f"mla_ql{ql}", ql, MLA_D, MLA_DV, np.array(
            [1, 31, 32, 33, 63, 64, 65, split_keys - 1, split_keys,
             split_keys + 1, KV_CAP], np.int32)))
    worst, rows = 0.0, []
    for name, ql, d, dv, lens_np in cases:
        b = len(lens_np)
        h = HEADS if name == "serve" else 1
        lens = torch.from_numpy(lens_np).to(dev)
        for ts in MIXED_FULL:
            q = randn(gen, (b, h, ql, d), ts[0])
            k = randn(gen, (b, h, KV_CAP, d), ts[1])
            v = randn(gen, (b, h, KV_CAP, dv), ts[2])
            what = f"mixed decode {dtype_names(*ts)} {name}"
            route = ("ring" if tuned_kernel_takes("decode_attention", q, k,
                                                  v, d, dv) else "mixed")
            require(route == ("ring" if name == "serve" else "mixed"),
                    f"{what}: routed to the {route} kernel")
            before = flash_attention_decode.launches
            out = flash_attention_decode(q, k, v, lens)
            calls = flash_attention_decode.launches - before
            ref = decode_attention_reference(q, k, v, lens)
            require(out.shape == ref.shape and out.dtype == ts[0]
                    and bool(torch.isfinite(out).all()),
                    f"{what}: output {tuple(out.shape)} {out.dtype}")
            require(calls == 1, f"{what}: {calls} launches, not 1")
            err, over = compare(out, ref, *FLASH_BF16_TOL)
            require(err < decode_tol(*ts), f"{what}: error {err}")
            require(over <= 1, f"{what}: {over} of the flash limit")
            kp, vp = poisoned(k, v, lens_np.tolist())
            moved = (flash_attention_decode(q, kp, vp, lens).float()
                     - out.float()).abs().max().item()
            require(moved < POISON_TOL, f"{what}: the poisoned tail moved "
                                        f"the output by {moved}")
            rows.append([name, dtype_names(*ts), route, err, over, moved])
            worst = max(worst, over)
            del q, k, v, kp, vp, out, ref
        torch.cuda.empty_cache()
    line("check", kernel="decode_attention", route="mixed",
         rows=json.dumps(rows, separators=(",", ":")),
         row_fields=json.dumps(["case", "dtypes", "route", "max_abs_err",
                                "err_over_flash_limit",
                                "poisoned_tail_max_abs_diff"]),
         serve=json.dumps([BATCH, HEADS, 1, HEAD_DIM]),
         mla=json.dumps([n, 1, "ql", MLA_D, MLA_DV]),
         mla_lens="1,31,32,33,63,64,65,split-1,split,split+1,cap",
         launches_per_call=1, worst_err_over_flash_limit=worst,
         flash_atol_rtol=json.dumps(FLASH_BF16_TOL))
    # What the bf16 limit cannot see, on the mixed tensor-core decode at
    # absorbed MLA's layout with one key tile (a 64-key cache, every
    # sequence full: one split, p rounded against the row's final max).
    fields = {}
    full = torch.full((16,), 64, dtype=torch.int32, device=dev)
    for ts in MIXED_FULL[:2]:
        q = randn(gen, (16, 1, MLA_ROWS, MLA_D), ts[0])
        k = randn(gen, (16, 1, 64, MLA_D), ts[1])
        v = randn(gen, (16, 1, 64, MLA_DV), ts[2])
        require(decode_route(q, k, v) == "mixed",
                f"mixed decode {dtype_names(*ts)} at one key tile: routed "
                f"to {decode_route(q, k, v)}")
        fields.update(nearest_semantics(
            flash_attention_decode(q, k, v, full), q, k, v, "mixed decode"))
        del q, k, v
    line("check", kernel="decode_attention", route="mixed",
         check="rounded p and the f32 query's lo part: summed squared "
         "difference to the kernel's semantics over that to each "
         "alternative (< 0.5)", shape=json.dumps([16, 1, MLA_ROWS, MLA_D,
                                                  MLA_DV, 64]), **fields)
    return worst


# The tuned decode's ring kernel: (query rows, d, dv) of its checks, and
# their sequences (one per length, one head, so that the cache is split).
RING_DECODE_DIMS = ((1, 128, 128), (5, 128, 128), (1, 64, 64),
                    (1, 256, 256), (2, 128, 64), (1, 64, 256))
#: Its f32 rows of 33-64 16-byte chunks (two chunks a lane, 16-key tiles).
RING_F32_DIMS = ((1, 256, 256), (1, 192, 192), (2, 256, 128), (1, 128, 256))
RING_DECODE_SEQS = 9


def tuned_decode_check(rng: np.random.Generator) -> float:
    """The tuned decode's ring kernel in bf16 and f16 at RING_DECODE_DIMS
    and in f32 at RING_F32_DIMS against the smoke's cache:
    RING_DECODE_SEQS sequences of one head (a grid of 9 blocks, so the
    cache is split across blocks and merged), of lengths 1, 2, its tile's
    edges (T - 1, T, T + 1: 15, 16, 17 in f32 at 129-256), a split's
    (split_keys - 1, split_keys, split_keys + 1) and the whole cache. Each
    call is one launch within its dtype's decode limit of its plain version
    and within the flash limit (FLASH_BF16_TOL, FLASH_F32_TOL in f32:
    atol, rtol), which a softmax scale 1% off exceeds where the decode
    limit alone may not; then every key past each length is poisoned
    (+-POISON in K, -+ in V; +-F16_POISON in f16), which must move the
    output by less than POISON_TOL. Returns the worst error's share of the
    flash limit."""
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, rows = 0.0, []
    sixteen = ((torch.bfloat16, POISON, FLASH_BF16_TOL),
               (torch.float16, F16_POISON, FLASH_BF16_TOL))
    f32 = ((torch.float32, POISON, FLASH_F32_TOL),)
    for (ql, d, dv), forms in ([(dims, sixteen) for dims in RING_DECODE_DIMS]
                               + [(dims, f32) for dims in RING_F32_DIMS]):
        base = [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev) for shape in ((RING_DECODE_SEQS, 1, ql, d),
                               (RING_DECODE_SEQS, 1, KV_CAP, d),
                               (RING_DECODE_SEQS, 1, KV_CAP, dv))]
        for dtype, poison, flash_tol_d in forms:
            tile = tuned_decode_tile(dtype, d, dv)
            splits, split_keys = tuned_decode_splits(
                RING_DECODE_SEQS, 1, KV_CAP, tile, sms)
            what = f"ring decode {dtype_names(dtype)} ql={ql} d={d} dv={dv}"
            require(tile > 0 and splits > 1,
                    f"{what}: tile {tile}, {splits} splits")
            lens_np = np.array([1, 2, tile - 1, tile, tile + 1,
                                split_keys - 1, split_keys, split_keys + 1,
                                KV_CAP], np.int32)
            lens = torch.from_numpy(lens_np).to(dev)
            q, k, v = (t.to(dtype) for t in base)
            require(decode_route(q, k, v) == "tuned",
                    f"{what}: routed to {decode_route(q, k, v)}")
            before = flash_attention_decode.launches
            out = flash_attention_decode(q, k, v, lens)
            calls = flash_attention_decode.launches - before
            ref = decode_attention_reference(q, k, v, lens)
            require(out.shape == ref.shape and out.dtype == dtype
                    and bool(torch.isfinite(out).all()),
                    f"{what}: output {tuple(out.shape)} {out.dtype}")
            require(calls == 1, f"{what}: {calls} launches, not 1")
            err, over = compare(out, ref, *flash_tol_d)
            require(err < decode_tol(dtype), f"{what}: error {err}")
            require(over <= 1, f"{what}: {over} of the flash limit")
            kp, vp = k.clone(), v.clone()
            for i, m in enumerate(lens_np.tolist()):
                kp[i, :, m:] = poison
                vp[i, :, m:] = -poison
            moved = (flash_attention_decode(q, kp, vp, lens).float()
                     - out.float()).abs().max().item()
            require(moved < POISON_TOL, f"{what}: the poisoned tail moved "
                                        f"the output by {moved}")
            rows.append([dtype_names(dtype), ql, d, dv, tile, splits,
                         split_keys, err, over, moved])
            worst = max(worst, over)
            del q, k, v, kp, vp, out, ref
        del base
    line("check", kernel="decode_attention", route="ring",
         seqs=RING_DECODE_SEQS, cap=KV_CAP, launches_per_call=1,
         rows=json.dumps(rows, separators=(",", ":")),
         row_fields=json.dumps(["dtype", "ql", "d", "dv", "tile", "splits",
                                "split_keys", "max_abs_err",
                                "err_over_flash_limit",
                                "poisoned_tail_max_abs_diff"]),
         worst_err_over_flash_limit=worst,
         flash_atol_rtol=json.dumps(FLASH_BF16_TOL),
         f32_flash_atol_rtol=json.dumps(FLASH_F32_TOL))
    torch.cuda.empty_cache()
    return worst


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
                       (torch.float32, FLASH_F32_TOL),
                       (torch.float16, FLASH_BF16_TOL)):
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
    # dims up to 64, 128 and 256 (the larger of d and dv), in every dtype.
    # The bf16 kernel takes 128 query rows a tile and 176 keys a tile (64
    # at 256): S = 1 and 64 are less than one tile, 64 is one 64-key tile,
    # 100, 129, 192, 256 and 320 leave a ragged last tile, and under causal
    # the 256 bucket's 128 query rows cross two 64-key tiles on the
    # diagonal. f32 takes the any-dtype kernel: 64 query rows and 64 keys a
    # tile, one CTA a 256-column slice of dv up to d = 128, clusters past it.
    alt_dv = {32: 256, 64: 128, 128: 64, 256: 32}
    worst = 0.0
    for d in (32, 64, 128, 256):
        for dv in (d, alt_dv[d]):
            for s_small in FLASH_EDGE_SEQS:
                for dtype in DTYPES:
                    tol = flash_tol(dtype)
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
         + "/".join(map(str, FLASH_EDGE_SEQS)) + " x f32/bf16/f16 x causal",
         worst_err_over_limit=worst)
    # Head dims that are not multiples of 16, which the wrapper zero-pads
    # to the next (8 -> 16, 40 -> 48, 24 -> 32) with the scale of the true d.
    worst = 0.0
    for d, dv in ((40, 40), (8, 8), (40, 24)):
        for s_small in (64, 129):
            for dtype in DTYPES:
                tol = flash_tol(dtype)
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
         "64/129 x f32/bf16/f16 x causal", worst_err_over_limit=worst)
    cluster_flash_check(gen)
    wide_flash_check(gen)
    f32_flash_check(gen)
    mixed_flash_check(gen)
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


def wide_flash_check(gen: torch.Generator) -> float:
    """The wide flash kernel at 576/512 in bf16 and f16 at S =
    WIDE_FLASH_SEQS (its 64-row query tiles' and 32-key tiles' edges),
    causal off and on: each call one launch within FLASH_BF16_TOL of
    ``reference_attention``. Returns the worst error's share of it."""
    worst = 0.0
    for s_small in WIDE_FLASH_SEQS:
        for dtype in (torch.bfloat16, torch.float16):
            q, k = (randn(gen, (2, 3, s_small, MLA_D), dtype)
                    for _ in range(2))
            v = randn(gen, (2, 3, s_small, MLA_DV), dtype)
            for causal in (False, True):
                before = flash_attention.launches
                out = flash_attention(q, k, v, block_q=s_small,
                                      block_k=s_small, causal=causal)
                calls = flash_attention.launches - before
                ref = reference_attention(q, k, v, causal=causal)
                what = (f"wide flash {dtype_names(dtype)} S={s_small} "
                        f"causal={causal}")
                require(out.shape == ref.shape and out.dtype == dtype
                        and calls == 1, f"{what}: {tuple(out.shape)} "
                                        f"{out.dtype}, {calls} launches")
                err, over = compare(out, ref, *FLASH_BF16_TOL)
                require(over <= 1, f"{what}: error {err}, {over} of the "
                                   f"limit")
                worst = max(worst, over)
    line("flash", route="wide", variants=json.dumps(
        f"d/dv {MLA_D}/{MLA_DV} x S "
        + "/".join(map(str, WIDE_FLASH_SEQS)) + " x bf16/f16 x causal"),
        calls=4 * len(WIDE_FLASH_SEQS), worst_err_over_limit=worst)
    return worst


def f32_flash_check(gen: torch.Generator) -> float:
    """f32 flash on the any-dtype kernel (3xTF32) at the compute bench's
    headline [4, 8, 2048, 128] and at each of F32_FLASH_DIMS at S =
    WIDE_FLASH_SEQS (the 64-row query tiles' and 64-key tiles' edges),
    causal off and on: each call one launch within FLASH_F32_TOL of
    ``reference_attention``. Returns the worst error's share of it."""
    worst = 0.0
    cases = [(FLASH_SHAPE, FLASH_SHAPE[3], causal) for causal in (False, True)]
    cases += [((2, 3, s_small, d), dv, causal) for d, dv in F32_FLASH_DIMS
              for s_small in WIDE_FLASH_SEQS for causal in (False, True)]
    for shape, dv, causal in cases:
        q, k = (randn(gen, shape, torch.float32) for _ in range(2))
        v = randn(gen, shape[:3] + (dv,), torch.float32)
        require(flash_route(q, k, v) == "cluster",
                f"f32 flash {list(shape)} dv={dv}: not the any-dtype kernel")
        s_small = shape[2]
        before = flash_attention.launches
        out = flash_attention(q, k, v, block_q=s_small, block_k=s_small,
                              causal=causal)
        calls = flash_attention.launches - before
        ref = reference_attention(q, k, v, causal=causal)
        what = (f"f32 flash {list(shape)} dv={dv} causal={causal}")
        require(out.shape == ref.shape and out.dtype == torch.float32
                and calls == 1 and bool(torch.isfinite(out).all()),
                f"{what}: {tuple(out.shape)} {out.dtype}, {calls} launches")
        err, over = compare(out, ref, *FLASH_F32_TOL)
        require(over <= 1, f"{what}: error {err}, {over} of the limit")
        worst = max(worst, over)
    line("flash", route="f32", kernel="cluster", variants=json.dumps(
        f"{list(FLASH_SHAPE)} x causal; d/dv "
        + ", ".join(f"{d}/{dv}" for d, dv in F32_FLASH_DIMS) + " x S "
        + "/".join(map(str, WIDE_FLASH_SEQS)) + " x causal"),
        calls=len(cases), worst_err_over_limit=worst,
        atol_rtol=json.dumps(FLASH_F32_TOL))
    return worst


# S for the flash checks of the any-dtype kernel: less than a row tile,
# one tile and a row, a tile, a tile and one, two and one, five.
CLUSTER_FLASH_SEQS = (1, 33, 64, 65, 129, 320)


def flash_route(q, k, v) -> str:
    """Which flash kernel the wrapper gives these inputs: ``tuned``,
    ``wide`` or ``cluster`` (the any-dtype kernel)."""
    dp, dvp = padded_head_dims(q.shape[3], v.shape[3])
    if tuned_kernel_takes("flash_attention", q, k, v, dp, dvp):
        return "tuned"
    if wide_kernel_takes(q, k, v, dp, dvp):
        return "wide"
    return "cluster"


def cluster_flash_check(gen: torch.Generator) -> float:
    """The flash kernels past the tuned ones at small shapes ([2, 3, S, d],
    S = CLUSTER_FLASH_SEQS, causal off and on): every head dim of
    GENERAL_DIMS in each dtype and in each MIXED_DTYPES mix, and the mixes
    at 64/64 and 40/24; each call one launch within its narrowest input's
    limit (the wide or the any-dtype kernel, by ``flash_route``).
    Then what the bf16 limit cannot see, on the any-dtype kernel at S = 64
    (one key tile: p is rounded against the row's final max) with an f32 q
    and K over a bf16 and an f16 V, [8, 4, 64] at 128/128 and [2, 2, 64] at
    1,024/1,024: the kernel's output is nearer (summed squared difference
    under half) to ``rounded_p_attention`` than to the plain version, whose
    p is not rounded. Returns the worst error's share of the limit."""
    cases = [(s_small, d, dv, ts) for d, dv in GENERAL_DIMS
             for ts in [(t,) * 3 for t in DTYPES] + list(MIXED_DTYPES)
             for s_small in CLUSTER_FLASH_SEQS]
    cases += [(s_small, d, dv, ts) for ts in MIXED_DTYPES
              for d, dv in ((64, 64), (40, 24)) for s_small in (64, 129)]
    worst = 0.0
    routes = {}
    for s_small, d, dv, ts in cases:
        q, k, v = (randn(gen, (2, 3, s_small, dim), t) for dim, t in
                   ((d, ts[0]), (d, ts[1]), (dv, ts[2])))
        route = flash_route(q, k, v)
        routes[route] = routes.get(route, 0) + 2
        for causal in (False, True):
            before = flash_attention.launches
            out = flash_attention(q, k, v, block_q=s_small, block_k=s_small,
                                  causal=causal)
            calls = flash_attention.launches - before
            ref = reference_attention(q, k, v, causal=causal)
            what = (f"flash {dtype_names(*ts)} d={d} dv={dv} S={s_small} "
                    f"causal={causal} ({route})")
            require(out.shape == ref.shape and out.dtype == ts[0]
                    and calls == 1 and bool(torch.isfinite(out).all()),
                    f"{what}: {tuple(out.shape)} {out.dtype}, "
                    f"{calls} launches")
            err, over = compare(out, ref, *flash_tol(*ts))
            require(over <= 1, f"{what}: error {err}, {over} of the limit")
            worst = max(worst, over)
        del q, k, v, out, ref
    line("flash", route="cluster", variants=json.dumps(
        "d/dv " + ", ".join(f"{d}/{dv}" for d, dv in GENERAL_DIMS)
        + " x f32/bf16/f16 and q/k/v "
        + ", ".join(dtype_names(*ts) for ts in MIXED_DTYPES)
        + " x S " + "/".join(map(str, CLUSTER_FLASH_SEQS))
        + "; those mixes x d/dv 64/64, 40/24 x S 64/129; x causal"),
        calls=2 * len(cases), routes=json.dumps(routes),
        worst_err_over_limit=worst)
    require(routes.get("cluster", 0) > 0,
            "no flash call reached the any-dtype kernel")
    fields = {}
    for shape in ((8, 4, 64, 128), (2, 2, 64, 1024)):
        for vt in (torch.bfloat16, torch.float16):
            q, k = (randn(gen, shape, torch.float32) for _ in range(2))
            v = randn(gen, shape, vt)
            require(flash_route(q, k, v) == "cluster",
                    f"{list(shape)} {vt} is not the any-dtype kernel's")
            out = flash_attention(q, k, v).float()
            sq = lambda ref: ((out - ref.float()) ** 2).sum().item()
            share = sq(rounded_p_attention(q, k, v)) / sq(
                reference_attention(q, k, v))
            name = (f"{dtype_names(torch.float32, torch.float32, vt)}"
                    f"_{shape[3]}").replace("/", "_")
            fields[f"{name}_vs_unrounded_p"] = share
            require(share < 0.5, f"any-dtype flash {name}: p is not rounded "
                                 f"to V's dtype ({share})")
            del q, k, v, out
    line("flash", route="cluster", check="rounded p: summed squared "
         "difference to the kernel's semantics over that to the plain "
         "version (< 0.5)", **fields)
    return worst


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: PTX's cvt.rna.tf32.f32), as f32: an f32 query's hi part."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1fff).view(torch.float32)


def rounded_p_attention(q, k, v) -> torch.Tensor:
    """Attention of one key tile (S <= 64, no mask) as the mixed kernel
    computes it: scores q.k in f32, p = exp(s - the row's max) rounded to
    V's dtype before P V, the denominator the sum of the unrounded p, the
    output in f32."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e.to(v.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / e.sum(
        -1, keepdim=True)


def mixed_flash_check(gen: torch.Generator) -> float:
    """Flash whose q's dtype is apart from K's and V's shared one, on the
    any-dtype kernel: at the compute bench's headline [4, 8, 2048, 128] in
    each MIXED_FULL class and at each of F32_FLASH_DIMS (128/128, 256/256,
    576/512) at S = WIDE_FLASH_SEQS in the first, causal off and on, each
    call one launch within FLASH_BF16_TOL of ``reference_attention``. Then
    what that limit cannot see, at S = 64 (one key tile, so the kernel
    rounds each p against the row's final max) and an f32 q over a bf16
    and an f16 cache, [16, 16, 64, 128] (``nearest_semantics``). Returns
    the worst error's share of the flash limit."""
    worst = 0.0
    cases = [(FLASH_SHAPE, FLASH_SHAPE[3], causal, ts) for ts in MIXED_FULL
             for causal in (False, True)]
    cases += [((2, 3, s_small, d), dv, causal, MIXED_FULL[0])
              for d, dv in F32_FLASH_DIMS for s_small in WIDE_FLASH_SEQS
              for causal in (False, True)]
    for shape, dv, causal, ts in cases:
        q, k = (randn(gen, shape, t) for t in ts[:2])
        v = randn(gen, shape[:3] + (dv,), ts[2])
        s_small = shape[2]
        what = (f"mixed flash {dtype_names(*ts)} {list(shape)} dv={dv} "
                f"causal={causal}")
        require(flash_route(q, k, v) == "cluster",
                f"{what}: not the any-dtype kernel")
        before = flash_attention.launches
        out = flash_attention(q, k, v, block_q=s_small, block_k=s_small,
                              causal=causal)
        calls = flash_attention.launches - before
        ref = reference_attention(q, k, v, causal=causal)
        require(out.shape == ref.shape and out.dtype == ts[0]
                and calls == 1 and bool(torch.isfinite(out).all()),
                f"{what}: {tuple(out.shape)} {out.dtype}, {calls} launches")
        err, over = compare(out, ref, *FLASH_BF16_TOL)
        require(over <= 1, f"{what}: error {err}, {over} of the limit")
        worst = max(worst, over)
        del q, k, v, out, ref
    line("flash", route="mixed", kernel="cluster", variants=json.dumps(
        f"{list(FLASH_SHAPE)} x " + ", ".join(dtype_names(*ts)
                                             for ts in MIXED_FULL)
        + f" x causal; {dtype_names(*MIXED_FULL[0])} d/dv "
        + ", ".join(f"{d}/{dv}" for d, dv in F32_FLASH_DIMS) + " x S "
        + "/".join(map(str, WIDE_FLASH_SEQS)) + " x causal"),
        calls=len(cases), worst_err_over_limit=worst,
        atol_rtol=json.dumps(FLASH_BF16_TOL))
    fields = {}
    for ts in MIXED_FULL[:2]:
        q = randn(gen, (16, 16, 64, HEAD_DIM), ts[0])
        k, v = (randn(gen, (16, 16, 64, HEAD_DIM), t) for t in ts[1:])
        fields.update(nearest_semantics(
            flash_attention(q, k, v), q, k, v, "mixed flash"))
        del q, k, v
    line("flash", route="mixed", check="rounded p and the f32 query's lo "
         "part: summed squared difference to the kernel's semantics over "
         "that to each alternative (< 0.5)", shape="[16, 16, 64, 128]",
         **fields)
    return worst


def nearest_semantics(out, q, k, v, what: str) -> dict:
    """What the bf16 limit cannot see in an output ``out`` of one key tile
    (no mask; the kernel rounds each p against the row's final max) with
    an f32 q over a 16-bit K and V: it is nearer (summed squared difference
    under half) to ``rounded_p_attention`` than to the plain version, whose
    p is not rounded (so p is rounded to V's dtype), and than to
    ``rounded_p_attention`` of the query rounded to TF32 (so the f32
    query's lo part entered S). Returns both shares by name."""
    out = out.float()
    sq = lambda ref: ((out - ref.float()) ** 2).sum().item()  # noqa: E731
    nearest = sq(rounded_p_attention(q, k, v))
    p_share = nearest / sq(reference_attention(q, k, v))
    q_lo_share = nearest / sq(rounded_p_attention(tf32_round(q), k, v))
    names = dtype_names(q.dtype, k.dtype, v.dtype)
    require(p_share < 0.5, f"{what} {names}: p is not rounded to V's dtype "
                           f"({p_share})")
    require(q_lo_share < 0.5, f"{what} {names}: the query's lo part is "
                              f"missing ({q_lo_share})")
    name = names.replace("/", "_")
    return {f"{name}_vs_unrounded_p": p_share,
            f"{name}_vs_tf32_query": q_lo_share}


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


def traced_kernels(fn, tries: int = 8, calls: int = 3,
                   pad_s: float = 0.005) -> tuple:
    """(names, traces): the names of the CUDA kernels and copies that
    torch.profiler traced in ``calls`` calls of ``fn`` (after one untraced
    call), and how many traces that took. The calls sit ``pad_s`` of idle
    host time inside each end of the capture window, and the device is
    drained before the window closes: the profiler keeps only device
    activity whose time stamps fall inside the window and that its
    activity buffers have delivered by then, and a window as short as one
    call has come back empty three times running. An empty trace is taken
    again, up to ``tries`` times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    names = []
    for traces in range(1, tries + 1):
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(pad_s)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad_s)
        names = sorted({e.name for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            break
    return names, traces


def wide_row(leg: str, counter, kernel, plain, library, nbytes: int,
             flops: int, tol: tuple, own, phase: str = "wide",
             f32: bool = False, flops_ms: float | None = None,
             tf32_flops: int | None = None, **shape) -> dict:
    """One line of the wide (or f32, mixed or any-dtype) leg: the kernel's,
    plain version's and library call's ms (``library`` None where no one
    call computes the function: its ms is then None), the bound (bytes at
    3.35 TB/s or operations at the 16-bit tensor-core rate, whichever is
    longer; with ``f32``, operations as 3 TF32 products each, and beside it
    the bound at the f32 SIMT rate; with ``flops_ms``, that time of the
    operations, from ``attention_flops_ms``; with ``tf32_flops``, beside it
    the bound at the TF32 products the kernel issues), the last timed
    kernel output against the last plain output within ``tol`` (atol,
    rtol), and the CUDA kernels traced in three calls of each
    (``traced_kernels``): the port's calls must run only kernels whose
    names hold ``own`` (a name, or a tuple of names each kernel may hold
    one of), and launch once. Returns the row's numbers and the kernel's
    launches."""
    own = (own,) if isinstance(own, str) else tuple(own)
    last = {}
    before = counter.launches
    ms = cuda_ms(lambda: last.__setitem__("out", kernel()))
    per_call = (counter.launches - before) / (WARMUP_CALLS + TIMED_CALLS)
    plain_ms = cuda_ms(lambda: last.__setitem__("ref", plain()))
    library_ms = cuda_ms(library) if library else None
    err, over = compare(last["out"], last["ref"], *tol)
    ours, traces = traced_kernels(kernel)
    theirs = traced_kernels(library)[0] if library else []
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    if flops_ms is None:
        flops_ms = (3 * flops / TF32_FLOP_S if f32
                    else flops / BF16_FLOP_S) * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    simt = ({"simt_bound_ms": max(bytes_ms, flops / F32_FLOP_S * 1e3)}
            if f32 else {})
    if tf32_flops is not None:
        simt["tf32_bound_ms"] = max(bytes_ms,
                                    tf32_flops / TF32_FLOP_S * 1e3)
    line(phase, leg=leg, **{k: json.dumps(v) if isinstance(v, (list, tuple))
                            else v for k, v in shape.items()},
         ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
         bound_by="bytes" if bytes_ms >= flops_ms else "operations",
         **simt, bound_share=bound_ms / ms, launches_per_call=per_call,
         max_abs_err=err, atol_rtol=json.dumps(tol), err_over_limit=over,
         kernels=json.dumps(ours), traces=traces,
         library_kernels=json.dumps(theirs))
    require(over <= 1, f"{phase} {leg}: error {err}, {over} of the limit")
    require(ours and all(any(o in name for o in own) for name in ours),
            f"{phase} {leg}: the port's call ran {ours}, not only {own}")
    require(per_call == 1, f"{phase} {leg}: {per_call} launches a call")
    return {"launches": counter.launches - before, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            **simt}


def phase_wide(seed: int) -> dict:
    """The inputs both kernels took last, at full width (``wide_row`` per
    call): DeepSeek-V3's absorbed-MLA decode in bf16 and flash attention at
    576/512 in bf16 (causal off and on) on the wide kernels, the f16 flash
    headline, and the f16 and bf16 decode serve shapes on the tuned ones
    (the decode ring kernel alone: one split, no merge). Its own main path:
    the counts are zeroed before it and must equal the rows' launches after
    it. Returns the launches by route (``decode_attention`` and
    ``flash_attention``: the tuned kernels; ``*_wide``: the wide ones) and
    the MLA, non-causal flash and f16 decode rows (``mla_decode``,
    ``flash_576_512``, ``decode_f16_serve``)."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16, f16 = torch.bfloat16, torch.float16
    lens = torch.from_numpy(smoke_lengths(np.random.default_rng(seed))).to(
        dev)
    keys = int(lens.clamp(max=KV_CAP).sum())
    mask = (torch.arange(KV_CAP, device=dev)[None, None, None, :]
            < lens[:, None, None, None])
    reset_launches()
    routes = {"decode_attention": 0, "decode_attention_wide": 0,
              "flash_attention": 0, "flash_attention_wide": 0}

    # Absorbed MLA: 128 rows of 576 against one latent head, one launch.
    q = randn(gen, (BATCH, 1, MLA_ROWS, MLA_D), bf16)
    k = randn(gen, (BATCH, 1, KV_CAP, MLA_D), bf16)
    v = randn(gen, (BATCH, 1, KV_CAP, MLA_DV), bf16)
    mla = wide_row(
        "mla_decode", flash_attention_decode,
        lambda: flash_attention_decode(q, k, v, lens),
        lambda: decode_attention_reference(q, k, v, lens),
        lambda: sdpa(q, k, v, attn_mask=mask),
        nbytes=(keys * (MLA_D + MLA_DV) + q.numel()
                + BATCH * MLA_ROWS * MLA_DV) * 2 + lens.numel() * 4,
        flops=2 * keys * MLA_ROWS * (MLA_D + MLA_DV), tol=(BF16_TOL, 0.0),
        own="wide_decode", q=list(q.shape), k=list(k.shape),
        v=list(v.shape), dtype="bfloat16", mean_len=keys / BATCH)
    routes["decode_attention_wide"] += mla["launches"]
    del q, k, v

    # Flash attention at the same head dims: the wide kernel.
    b, h, s = WIDE_FLASH_SHAPE
    q, k = (randn(gen, (b, h, s, MLA_D), bf16) for _ in range(2))
    v = randn(gen, (b, h, s, MLA_DV), bf16)
    flash_rows = []
    for causal in (False, True):
        flash_rows.append(wide_row(
            "flash_576_512", flash_attention,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: reference_attention(q, k, v, causal=causal),
            lambda: sdpa(q, k, v, is_causal=causal),
            nbytes=b * h * s * (2 * MLA_D + 2 * MLA_DV) * 2,
            flops=2 * b * h * s * s * (MLA_D + MLA_DV) // (2 if causal
                                                           else 1),
            tol=FLASH_BF16_TOL, own="wide_flash",
            shape=[b, h, s], d=MLA_D, dv=MLA_DV, dtype="bfloat16",
            causal=causal))
        routes["flash_attention_wide"] += flash_rows[-1]["launches"]
    del q, k, v

    # The f16 flash headline on the wgmma path.
    b, h, s, d = FLASH_SHAPE
    q, k, v = (randn(gen, FLASH_SHAPE, f16) for _ in range(3))
    routes["flash_attention"] += wide_row(
        "flash_f16_headline", flash_attention,
        lambda: flash_attention(q, k, v),
        lambda: reference_attention(q, k, v), lambda: sdpa(q, k, v),
        nbytes=4 * b * h * s * d * 2, flops=4 * b * h * s * s * d,
        tol=FLASH_BF16_TOL, own="flash_f16_kernel",
        shape=list(FLASH_SHAPE), dtype="float16", causal=False)["launches"]
    del q, k, v

    # The decode kernel at the serve shape in f16 and bf16: the ring kernel,
    # one split (1,024 blocks fill the SMs), so no merge in the trace.
    serve_rows = {}
    for leg, name, dtype in (("decode_f16_serve", "float16", f16),
                             ("decode_bf16_serve", "bfloat16", bf16)):
        q = randn(gen, (BATCH, HEADS, 1, HEAD_DIM), dtype)
        k, v = (randn(gen, (BATCH, HEADS, KV_CAP, HEAD_DIM), dtype)
                for _ in range(2))
        serve_rows[leg] = wide_row(
            leg, flash_attention_decode,
            lambda: flash_attention_decode(q, k, v, lens),
            lambda: decode_attention_reference(q, k, v, lens),
            lambda: sdpa(q, k, v, attn_mask=mask),
            nbytes=(keys * HEADS * HEAD_DIM * 2 + 2 * q.numel()) * 2
            + lens.numel() * 4, flops=4 * keys * HEADS * HEAD_DIM,
            tol=(BF16_TOL, 0.0), own="decode_ring_kernel",
            q=list(q.shape), k=list(k.shape), dtype=name)
        routes["decode_attention"] += serve_rows[leg]["launches"]
        del q, k, v
    torch.cuda.synchronize()
    counts = launches()
    line("wide", launches=json.dumps(counts), routes=json.dumps(routes),
         bound_basis="H100 SXM 3.35 TB/s HBM, 989.4 TFLOP/s dense bf16/f16")
    want = {name: routes[name] + routes[f"{name}_wide"]
            for name in ("decode_attention", "flash_attention")}
    require(counts == want, f"the wide leg's launches: {counts}, its rows "
                            f"counted {want}")
    torch.cuda.empty_cache()
    return {**routes, "mla_decode": mla, "flash_576_512": flash_rows[0],
            **serve_rows}


def phase_f32(seed: int) -> dict:
    """f32 on the tensor cores (3xTF32) at full width (``wide_row`` per
    call, bounds at 3 TF32 products per f32 one with the f32 SIMT bound
    beside): DeepSeek-V3's absorbed-MLA decode in f32 (the f32 decode
    kernel and its merge, one launch a call), the f32 flash headline
    [4, 8, 2048, 128] and flash attention at 576/512 ([1, 16, 2048]), each
    causal off and on (the any-dtype flash kernel). Its own main path: the
    counts are zeroed before it and must equal the rows' launches after
    it. Returns the launches by kernel and the rows by leg."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32 = torch.float32
    lens = torch.from_numpy(smoke_lengths(np.random.default_rng(seed))).to(
        dev)
    keys = int(lens.clamp(max=KV_CAP).sum())
    mask = (torch.arange(KV_CAP, device=dev)[None, None, None, :]
            < lens[:, None, None, None])
    reset_launches()
    rows = {}

    q = randn(gen, (BATCH, 1, MLA_ROWS, MLA_D), f32)
    k = randn(gen, (BATCH, 1, KV_CAP, MLA_D), f32)
    v = randn(gen, (BATCH, 1, KV_CAP, MLA_DV), f32)
    rows["mla_decode_f32"] = wide_row(
        "mla_decode_f32", flash_attention_decode,
        lambda: flash_attention_decode(q, k, v, lens),
        lambda: decode_attention_reference(q, k, v, lens),
        lambda: sdpa(q, k, v, attn_mask=mask),
        nbytes=(keys * (MLA_D + MLA_DV) + q.numel()
                + BATCH * MLA_ROWS * MLA_DV) * 4 + lens.numel() * 4,
        flops=2 * keys * MLA_ROWS * (MLA_D + MLA_DV), tol=FLASH_F32_TOL,
        own=("f32tc_decode", "wide_decode_merge"), phase="f32", f32=True,
        q=list(q.shape), k=list(k.shape), v=list(v.shape), dtype="float32",
        mean_len=keys / BATCH)
    del q, k, v

    b, h, s, d = FLASH_SHAPE
    q, k, v = (randn(gen, FLASH_SHAPE, f32) for _ in range(3))
    for causal in (False, True):
        leg = "flash_f32_headline" + ("_causal" if causal else "")
        rows[leg] = wide_row(
            leg, flash_attention,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: reference_attention(q, k, v, causal=causal),
            lambda: sdpa(q, k, v, is_causal=causal),
            nbytes=4 * b * h * s * d * 4,
            flops=4 * b * h * s * s * d // (2 if causal else 1),
            tol=FLASH_F32_TOL, own="cluster_flash", phase="f32", f32=True,
            shape=list(FLASH_SHAPE), dtype="float32", causal=causal)
    del q, k, v

    b, h, s = WIDE_FLASH_SHAPE
    q, k = (randn(gen, (b, h, s, MLA_D), f32) for _ in range(2))
    v = randn(gen, (b, h, s, MLA_DV), f32)
    for causal in (False, True):
        leg = "flash_f32_576_512" + ("_causal" if causal else "")
        rows[leg] = wide_row(
            leg, flash_attention,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: reference_attention(q, k, v, causal=causal),
            lambda: sdpa(q, k, v, is_causal=causal),
            nbytes=b * h * s * (2 * MLA_D + 2 * MLA_DV) * 4,
            flops=2 * b * h * s * s * (MLA_D + MLA_DV) // (2 if causal
                                                           else 1),
            tol=FLASH_F32_TOL, own="cluster_flash", phase="f32", f32=True,
            shape=[b, h, s], d=MLA_D, dv=MLA_DV, dtype="float32",
            causal=causal)
    del q, k, v
    torch.cuda.synchronize()
    counts = launches()
    want = {"decode_attention": rows["mla_decode_f32"]["launches"],
            "flash_attention": sum(r["launches"] for leg, r in rows.items()
                                   if leg.startswith("flash"))}
    line("f32", launches=json.dumps(counts),
         bound_basis="H100 SXM 3.35 TB/s HBM, 3 TF32 products per f32 "
                     "product at 494.7 TFLOP/s dense TF32 (simt_bound_ms: "
                     "67 TFLOP/s f32)")
    require(counts == want, f"the f32 leg's launches: {counts}, its rows "
                            f"counted {want}")
    torch.cuda.empty_cache()
    return {"decode_attention_f32tc": counts["decode_attention"],
            "flash_attention_f32": counts["flash_attention"], **rows}


def phase_mixed(seed: int) -> dict:
    """Mixed dtypes (an f32 q over a bf16 cache) at full width (``wide_row``
    per call, no library call: none takes q, k and v in different dtypes):
    the decode serve shape on the ring kernel (bound: bytes), DeepSeek-V3's
    absorbed-MLA decode on the mixed tensor-core kernel and its merge, and
    the flash headline [4, 8, 2048, 128] on the any-dtype flash kernel,
    causal off and on (bounds: bytes, or each product at its operands' rate,
    ``attention_flops_ms``: S 2 TF32 products a multiply-add at 494.7
    TFLOP/s, P V at the bf16 rate). Its own main path: the counts are
    zeroed before it and must equal the rows' launches after it. Returns
    the launches by kernel and the rows by leg."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32, bf16 = torch.float32, torch.bfloat16
    lens = torch.from_numpy(smoke_lengths(np.random.default_rng(seed))).to(
        dev)
    keys = int(lens.clamp(max=KV_CAP).sum())
    reset_launches()
    rows = {}

    q = randn(gen, (BATCH, HEADS, 1, HEAD_DIM), f32)
    k, v = (randn(gen, (BATCH, HEADS, KV_CAP, HEAD_DIM), bf16)
            for _ in range(2))
    rows["decode_serve_f32q_bf16kv"] = wide_row(
        "decode_serve_f32q_bf16kv", flash_attention_decode,
        lambda: flash_attention_decode(q, k, v, lens),
        lambda: decode_attention_reference(q, k, v, lens), None,
        nbytes=keys * HEADS * HEAD_DIM * 2 * 2 + 2 * q.numel() * 4
        + lens.numel() * 4, flops=4 * keys * HEADS * HEAD_DIM,
        tol=(BF16_TOL, 0.0), own="decode_ring_kernel", phase="mixed",
        q=list(q.shape), k=list(k.shape), dtypes="float32/bfloat16/bfloat16")
    del q, k, v

    q = randn(gen, (BATCH, 1, MLA_ROWS, MLA_D), f32)
    k = randn(gen, (BATCH, 1, KV_CAP, MLA_D), bf16)
    v = randn(gen, (BATCH, 1, KV_CAP, MLA_DV), bf16)
    rows["mla_decode_f32q_bf16kv"] = wide_row(
        "mla_decode_f32q_bf16kv", flash_attention_decode,
        lambda: flash_attention_decode(q, k, v, lens),
        lambda: decode_attention_reference(q, k, v, lens), None,
        nbytes=keys * (MLA_D + MLA_DV) * 2
        + (q.numel() + BATCH * MLA_ROWS * MLA_DV) * 4 + lens.numel() * 4,
        flops=2 * keys * MLA_ROWS * (MLA_D + MLA_DV),
        flops_ms=attention_flops_ms(keys * MLA_ROWS * MLA_D,
                                    keys * MLA_ROWS * MLA_DV,
                                    "float32/bfloat16/bfloat16"),
        tf32_flops=2 * keys * MLA_ROWS * (2 * MLA_D + MLA_DV),
        tol=FLASH_BF16_TOL, own=("f32tc_decode", "wide_decode_merge"),
        phase="mixed", q=list(q.shape), k=list(k.shape), v=list(v.shape),
        dtypes="float32/bfloat16/bfloat16", mean_len=keys / BATCH)
    del q, k, v

    b, h, s, d = FLASH_SHAPE
    q = randn(gen, FLASH_SHAPE, f32)
    k, v = (randn(gen, FLASH_SHAPE, bf16) for _ in range(2))
    for causal in (False, True):
        leg = "flash_f32q_bf16kv_headline" + ("_causal" if causal else "")
        half = 2 if causal else 1
        rows[leg] = wide_row(
            leg, flash_attention,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: reference_attention(q, k, v, causal=causal), None,
            nbytes=b * h * s * d * (4 + 2 + 2 + 4),
            flops=4 * b * h * s * s * d // half,
            flops_ms=attention_flops_ms(
                b * h * s * s * d // half, b * h * s * s * d // half,
                "float32/bfloat16/bfloat16"),
            tf32_flops=2 * b * h * s * s * (2 * d + d) // half,
            tol=FLASH_BF16_TOL, own="cluster_flash", phase="mixed",
            shape=list(FLASH_SHAPE), dtypes="float32/bfloat16/bfloat16",
            causal=causal)
    del q, k, v
    torch.cuda.synchronize()
    counts = launches()
    ring = rows["decode_serve_f32q_bf16kv"]["launches"]
    tc = rows["mla_decode_f32q_bf16kv"]["launches"]
    flash = sum(r["launches"] for leg, r in rows.items()
                if leg.startswith("flash"))
    line("mixed", launches=json.dumps(counts), ring_launches=ring,
         tensor_core_decode_launches=tc,
         bound_basis="H100 SXM 3.35 TB/s HBM; each product at its "
                     "operands' rate: S (f32 q, bf16 K) 2 TF32 products at "
                     "494.7 TFLOP/s, P V (p rounded to bf16) at 989.4 "
                     "(tf32_bound_ms: P V 1 TF32 product, as issued)")
    require(counts == {"decode_attention": ring + tc,
                       "flash_attention": flash},
            f"the mixed leg's launches: {counts}, its rows counted "
            f"{ring + tc} decode and {flash} flash")
    torch.cuda.empty_cache()
    return {"decode_attention_mixed_ring": ring,
            "decode_attention_mixed": tc, "flash_attention_mixed": flash,
            **rows}


def phase_any(seed: int) -> dict:
    """The any-dtype kernels at full width (``wide_row`` per call): K and V
    in different dtypes, an f32 q and K over a bf16 V, at the decode serve
    shape and the flash headline [4, 8, 2048, 128] (causal off and on; no
    library call takes the mix), and bf16 at 1,024/1,024 (decode q [32, 4,
    1, 1024] against the smoke's cache and lengths, flash [1, 8, 2048]),
    beside the library call. Bounds: bytes at 3.35 TB/s, or each product
    at its operands' rate (``attention_flops_ms``), beside the bound at the
    TF32 products the kernel issues. Its own main path: the counts are
    zeroed before it and must equal the rows' launches after it. Returns
    the launches by kernel and the rows by leg."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32, bf16 = torch.float32, torch.bfloat16
    lens = torch.from_numpy(smoke_lengths(np.random.default_rng(seed))).to(
        dev)
    keys = int(lens.clamp(max=KV_CAP).sum())
    reset_launches()
    rows = {}
    own_decode = ("stream_decode_kernel", "wide_decode_merge")

    q, k = (randn(gen, (BATCH, HEADS, n, HEAD_DIM), f32)
            for n in (1, KV_CAP))
    v = randn(gen, (BATCH, HEADS, KV_CAP, HEAD_DIM), bf16)
    rows["decode_serve_f32qk_bf16v"] = wide_row(
        "decode_serve_f32qk_bf16v", flash_attention_decode,
        lambda: flash_attention_decode(q, k, v, lens),
        lambda: decode_attention_reference(q, k, v, lens), None,
        nbytes=keys * HEADS * HEAD_DIM * (4 + 2) + 2 * q.numel() * 4
        + lens.numel() * 4, flops=4 * keys * HEADS * HEAD_DIM,
        tol=FLASH_BF16_TOL, own=own_decode, phase="any",
        q=list(q.shape), k=list(k.shape), dtypes="float32/float32/bfloat16")
    del q, k, v

    heads, d = 4, 1024
    q = randn(gen, (BATCH, heads, 1, d), bf16)
    k, v = (randn(gen, (BATCH, heads, KV_CAP, d), bf16) for _ in range(2))
    mask = (torch.arange(KV_CAP, device=dev)[None, None, None, :]
            < lens[:, None, None, None])
    rows["decode_1024_1024_bf16"] = wide_row(
        "decode_1024_1024_bf16", flash_attention_decode,
        lambda: flash_attention_decode(q, k, v, lens),
        lambda: decode_attention_reference(q, k, v, lens),
        lambda: sdpa(q, k, v, attn_mask=mask),
        nbytes=keys * heads * d * 2 * 2 + 2 * q.numel() * 2
        + lens.numel() * 4, flops=4 * keys * heads * d,
        tol=FLASH_BF16_TOL, own=own_decode, phase="any", q=list(q.shape),
        k=list(k.shape), dtypes="bfloat16", mean_len=keys / BATCH)
    del q, k, v, mask

    b, h, s, d = FLASH_SHAPE
    q, k = (randn(gen, FLASH_SHAPE, f32) for _ in range(2))
    v = randn(gen, FLASH_SHAPE, bf16)
    for causal in (False, True):
        leg = "flash_f32qk_bf16v_headline" + ("_causal" if causal else "")
        half = 2 if causal else 1
        rows[leg] = wide_row(
            leg, flash_attention,
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: reference_attention(q, k, v, causal=causal), None,
            nbytes=b * h * s * d * (4 + 4 + 2 + 4),
            flops=4 * b * h * s * s * d // half,
            flops_ms=attention_flops_ms(
                b * h * s * s * d // half, b * h * s * s * d // half,
                "float32/float32/bfloat16"),
            tf32_flops=2 * b * h * s * s * (3 * d + d) // half,
            tol=FLASH_BF16_TOL, own="cluster_flash", phase="any",
            shape=list(FLASH_SHAPE), dtypes="float32/float32/bfloat16",
            causal=causal)
    del q, k, v

    shape = (1, 8, 2048, 1024)
    q, k, v = (randn(gen, shape, bf16) for _ in range(3))
    b, h, s, d = shape
    rows["flash_1024_1024_bf16"] = wide_row(
        "flash_1024_1024_bf16", flash_attention,
        lambda: flash_attention(q, k, v),
        lambda: reference_attention(q, k, v), lambda: sdpa(q, k, v),
        nbytes=4 * b * h * s * d * 2, flops=4 * b * h * s * s * d,
        tf32_flops=4 * b * h * s * s * d, tol=FLASH_BF16_TOL,
        own="cluster_flash", phase="any", shape=list(shape),
        dtypes="bfloat16", causal=False)
    del q, k, v
    torch.cuda.synchronize()
    counts = launches()
    decode = sum(r["launches"] for leg, r in rows.items()
                 if leg.startswith("decode"))
    flash = sum(r["launches"] for leg, r in rows.items()
                if leg.startswith("flash"))
    line("any", launches=json.dumps(counts),
         bound_basis="H100 SXM 3.35 TB/s HBM; each product at its "
                     "operands' rate: 16-bit by 16-bit (P V under a 16-bit "
                     "V: p is rounded to it) at 989.4 TFLOP/s, one with f32 "
                     "operands 1 + [f32 a] + [f32 b] TF32 products at 494.7 "
                     "(tf32_bound_ms: the TF32 products the kernel issues)")
    require(counts == {"decode_attention": decode,
                       "flash_attention": flash},
            f"the any-dtype leg's launches: {counts}, its rows counted "
            f"{decode} decode and {flash} flash")
    torch.cuda.empty_cache()
    return {"decode_attention_stream": decode,
            "flash_attention_cluster": flash, **rows}


#: The calls a per-warp decode kernel used to take (``phase_perwarp``):
#: (name, dtype, (b, h, d, dv), lengths, K and V as views one element past
#: a 16-byte boundary). R1: f32 at Gemma-2-9B's 16 heads x 256 (the f32
#: serve shape's cache bytes); R2: the same at 4 sequences of the whole
#: cache (64 caches on 132 SMs); R3: bf16 at d = 66 (a 132-byte row, not
#: whole 16-byte chunks); R4: the bf16 serve shape on views off 16 bytes.
PERWARP_ROWS = (
    ("r1_f32_hd256", torch.float32, (BATCH, 16, 256, 256), "smoke", False),
    ("r2_f32_hd256_few", torch.float32, (4, 16, 256, 256), "full", False),
    ("r3_bf16_d66", torch.bfloat16, (BATCH, HEADS, 66, 66), "smoke", False),
    ("r4_bf16_off16", torch.bfloat16, (BATCH, HEADS, HEAD_DIM, HEAD_DIM),
     "smoke", True),
)


def perwarp_inputs(gen: torch.Generator, row: tuple,
                   smoke_lens: torch.Tensor) -> tuple:
    """q [b, h, 1, d], K and V [b, h, KV_CAP, d / dv] (views one element
    past a 16-byte boundary where the row says so) drawn from ``gen``, and
    the lengths: the smoke's (``smoke_lens``) or the whole cache."""
    _, dtype, (b, h, d, dv), lengths, offset = row
    dev = gen.device

    def cache(width: int) -> torch.Tensor:
        t = randn(gen, (b, h, KV_CAP, width), dtype)
        if not offset:
            return t
        flat = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    q = randn(gen, (b, h, 1, d), dtype)
    k, v = cache(d), cache(dv)
    lens = (smoke_lens[:b].contiguous() if lengths == "smoke" else
            torch.full((b,), KV_CAP, dtype=torch.int32, device=dev))
    return q, k, v, lens


def phase_perwarp(seed: int) -> dict:
    """PERWARP_ROWS at full width (``wide_row`` per call): the kernel's,
    plain version's and library call's (``scaled_dot_product_attention``
    with the boolean length mask; on 16-byte-aligned copies of R4's views,
    on which its kernel faults) ms, the bound (each valid K and V row
    read once, q read and out written once, at 3.35 TB/s; operations at
    f32's 67 TFLOP/s, the longer), and the kernels traced: R1 and R2 on the
    ring kernel (two 16-byte chunks a lane; R2's cache split and merged),
    R3 and R4 on the any-dtype kernel, which copies the 16-byte chunks
    around each tile. Its own main path: the counts are zeroed before it
    and must equal the rows' launches after it. Returns the rows by name
    and their launches."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    smoke = torch.from_numpy(smoke_lengths(np.random.default_rng(seed))).to(
        dev)
    reset_launches()
    rows = {}
    for row in PERWARP_ROWS:
        name, dtype = row[:2]
        q, k, v, lens = perwarp_inputs(gen, row, smoke)
        b, h, _, d = q.shape
        dv = v.shape[3]
        route = decode_route(q, k, v)
        want = "stream" if name.startswith(("r3", "r4")) else "tuned"
        require(route == want, f"perwarp_rows {name}: routed to {route}")
        # dv = 66 is not whole float4s: the wrapper copies out's first dv
        # columns from the kernel's output (rows rounded up to 4).
        own = (("decode_ring_kernel" if route == "tuned"
                else "stream_decode_kernel"), "wide_decode_merge") + (
            ("direct_copy_kernel",) if dv % 4 else ())
        mask = (torch.arange(KV_CAP, device=dev)[None, None, None, :]
                < lens[:, None, None, None])
        keys = int(lens.clamp(max=KV_CAP).sum()) * h
        size = dtype.itemsize
        flops = 2 * keys * (d + dv)
        # The library's kernel faults (misaligned address) on views off a
        # 16-byte boundary: it takes aligned copies of the same values.
        lk, lv = (k.clone(), v.clone()) if k.data_ptr() % 16 else (k, v)
        rows[name] = wide_row(
            name, flash_attention_decode,
            lambda: flash_attention_decode(q, k, v, lens),
            lambda: decode_attention_reference(q, k, v, lens),
            lambda: sdpa(q, lk, lv, attn_mask=mask),
            nbytes=keys * (d + dv) * size + q.numel() * size
            + b * h * dv * size + lens.numel() * 4, flops=flops,
            flops_ms=flops / F32_FLOP_S * 1e3,
            tol=FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL,
            own=own, phase="perwarp_rows", route=route, q=list(q.shape),
            k=list(k.shape), dtypes=dtype_names(dtype),
            view_off_16_bytes=bool(k.data_ptr() % 16),
            mean_len=int(lens.clamp(max=KV_CAP).sum()) / b)
        del q, k, v, lk, lv, lens, mask
        torch.cuda.empty_cache()
    counts = launches()
    total = sum(r["launches"] for r in rows.values())
    line("perwarp_rows", launches=json.dumps(counts),
         bound_basis="H100 SXM 3.35 TB/s HBM, 67 TFLOP/s f32")
    require(counts == {"decode_attention": total, "flash_attention": 0},
            f"the perwarp_rows leg's launches: {counts}, its rows counted "
            f"{total}")
    return {"launches": total, **rows}


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


def _claim_ready(client, name: str, namespace: str = "default") -> bool:
    """Whether the claim's status carries the GPU driver's Ready entry."""
    c = client.try_get("ResourceClaim", name, namespace) or {}
    return any(d.get("driver") == DRIVER_NAME and any(
        k.get("type") == "Ready" and k.get("status") == "True"
        for k in d.get("conditions") or [])
        for d in (c.get("status") or {}).get("devices") or [])


def plugin_residue(client, driver) -> list:
    """What a GPU plugin's claims left: ResourceClaims in ``client``, the
    plugin's checkpoint entries and CDI claim specs, and any file in its
    CDI root."""
    return ([c["metadata"]["name"] for c in client.list("ResourceClaim")]
            + sorted(driver.state.prepared_claims_nolock())
            + driver.cdi.list_claim_uids()
            + sorted(p.name for p in driver.cdi.cdi_root.iterdir()))


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
        residue = plugin_residue(client, driver)
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
            "decode_steps": engine.decode_steps}


def check_served(engine, done: dict, reqs: list, what: str) -> None:
    """The serve checks: every request completed, the accounting identity,
    ``kv_isolation_max_err`` under F32_TOL, decode kernel launches equal
    to decode steps (none on a CPU engine: the plain version runs there),
    and every request's last output row its tenant's vector."""
    check_outputs(engine, done["summary"], reqs, what)
    n_launches = done["counts"]["decode_attention"]
    decode_steps = done["decode_steps"]
    want = decode_steps if engine.device.type == "cuda" else 0
    require(n_launches == want and decode_steps > 0,
            f"{what}: {n_launches} kernel launches for {decode_steps} "
            "decode steps")


def check_outputs(engine, summary: dict, reqs: list, what: str) -> None:
    """The serve checks but the launch count: every request completed,
    the accounting identity, ``kv_isolation_max_err`` under F32_TOL, and
    every request's last output row its tenant's vector."""
    require(summary["completed"] == summary["submitted"] == len(reqs),
            f"{what}: completed {summary['completed']} of "
            f"{summary['submitted']}")
    require(summary["accounted"], f"{what}: accounting identity broken")
    require(engine.kv_isolation_max_err < F32_TOL,
            f"{what}: kv_isolation_max_err {engine.kv_isolation_max_err}")
    for r in reqs:
        vec = tenant_vector(r.tenant, engine.head_dim)
        require(r.last_output is not None
                and r.last_output.shape == (engine.heads, engine.head_dim)
                and bool(np.isfinite(r.last_output).all())
                and float(np.abs(r.last_output - vec).max()) < F32_TOL,
                f"{what}: request {r.rid} decoded a wrong row")


def _card_claim(client, name: str, gpu) -> dict:
    """A ResourceClaim for the card by UUID, created (not allocated)."""
    return client.create(new_object(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{"name": "gpu", "exactly": {
            "deviceClassName": DRIVER_NAME, "allocationMode": "ExactCount",
            "count": 1, "selectors": [{"cel": {"expression":
                f"device.attributes['uuid'] == '{gpu.uuid}'"}}]}}]}}))


def _serve_spec(spec: dict, name: str, w: dict, seed: int, gpu) -> dict:
    """An engine ``name`` at ``w`` bound from a claim's CDI spec that names
    the card serves ``w["requests"]`` requests under the serve checks
    (decode launches equal decode steps on the card); its counts and the
    first batch's time."""
    entries = visible_device_entries(spec)
    require(entries == [gpu.uuid], f"{name}: the spec names {entries}")
    engine = bind_engine(
        spec, name, device=w["device"], uuids=w["uuids"],
        metrics=ServingMetrics(), max_batch=w["max_batch"],
        kv_cap=w["kv_cap"], heads=w["heads"], head_dim=w["head_dim"],
        tokens_per_chip_step=2048, queue_cap=64, modeled_chip_tok_s=1e9)
    reqs = tenant_requests(np.random.default_rng(seed), w["requests"], name,
                           w["prompts"], w["new_tokens"])
    serve_requests(engine, reqs, name)
    done = finish_engine(engine)
    check_served(engine, done, reqs, name)
    on_card = engine.device.type == "cuda"
    first_batch_t = engine.first_batch_t
    del engine
    if on_card:
        torch.cuda.empty_cache()
    return {"decode_steps": done["decode_steps"],
            "launches": done["counts"]["decode_attention"],
            "first_batch_t": first_batch_t}


def _serve_claim(seed: int, client, driver, gpu) -> dict:
    name = "smoke-claim"
    t0 = time.monotonic()
    claim = _card_claim(client, name, gpu)
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
    hd256 = _serve_hd256(seed, spec, gpu)

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
            "ttfb_ms": ttfb_ms, "hd256_launches": hd256["launches"],
            "hd256_max_abs_err": hd256["max_abs_err"]}


#: The serve phase's second engine: the attention width of Gemma-2-9B
#: (16 heads of head_dim 256, its published config.json), 32 slots and a
#: 4096-token f32 cache (4.3 GB of slabs), bound from the same claim; its
#: traffic: 16 requests from 2 tenants, prompts of 512-3072 tokens, 32 new
#: tokens each. Its f32 rows of 1 KiB take the ring kernel's two-chunk
#: form.
HD256_WIDTH = {"max_batch": BATCH, "heads": 16, "head_dim": 256,
               "kv_cap": KV_CAP, "requests": 16, "tenants": 2,
               "prompts": (512, 3072), "new_tokens": 32}


def _serve_hd256(seed: int, spec: dict, gpu) -> dict:
    """An engine at HD256_WIDTH bound to the claim's CDI spec serves its
    traffic under every serve check (``check_served``: completed ==
    submitted, the accounting identity, ``kv_isolation_max_err``, decode
    launches == decode steps, each last row its tenant's), then the kernel
    is held to its plain version at the engine's shape (``soak_check``).
    Returns the engine's decode launches and that error."""
    w = HD256_WIDTH
    engine = bind_engine(
        spec, "smoke-hd256", metrics=ServingMetrics(),
        max_batch=w["max_batch"], kv_cap=w["kv_cap"], heads=w["heads"],
        head_dim=w["head_dim"], tokens_per_chip_step=2048, queue_cap=64,
        modeled_chip_tok_s=1e9)
    require(engine.device == torch.device("cuda", 0),
            f"hd256 engine bound to {engine.device}")
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(w["prompts"][0], w["prompts"][1] + 1,
                           size=w["requests"])
    reqs = [DecodeRequest(rid=f"g{i}", tenant=TENANTS[i % w["tenants"]],
                          prompt_tokens=int(p),
                          max_new_tokens=w["new_tokens"])
            for i, p in enumerate(lengths)]
    wall = serve_requests(engine, reqs, "serve hd256")
    done = finish_engine(engine)
    summary = done["summary"]
    line("serve", engine="hd256", heads=w["heads"], head_dim=w["head_dim"],
         max_batch=w["max_batch"], kv_cap=w["kv_cap"],
         kv_slab_gb=2 * engine._K.numel() * 4 / 1e9,
         submitted=summary["submitted"], completed=summary["completed"],
         accounted=summary["accounted"], decode_steps=done["decode_steps"],
         kernel_launches=json.dumps(done["counts"]), wall_s=wall,
         decode_tok_s=summary["decode_tokens"] / wall,
         kv_isolation_max_err=engine.kv_isolation_max_err)
    check_served(engine, done, reqs, "serve hd256")
    del engine
    torch.cuda.empty_cache()
    err = soak_check(np.random.default_rng(seed + 2), w, phase="serve")
    torch.cuda.empty_cache()
    return {"launches": done["counts"]["decode_attention"],
            "max_abs_err": err}


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
        residue = plugin_residue(client, driver)
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


#: The node-side binaries and the API server, each run as
#: ``python -m <module>`` from the checkout's root.
API_SERVER_MODULE = "k8s_dra_driver_tpu_torch.k8sclient.httpapi"
GPU_PLUGIN_MODULE = "k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin"
CD_PLUGIN_MODULE = "k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin"
CD_DAEMON_MODULE = "k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon"
WEBHOOK_MODULE = "k8s_dra_driver_tpu_torch.plugins.webhook"
CONTROLLER_MODULE = "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller"
#: The served claim's namespace in the processes phase: a tenant of its
#: own, so the usage meter's bill for it is its namespace's total.
PROCESSES_TENANT = "serve-tenant"
#: The SLOs the controller's engine evaluates: the default set plus the
#: two opt-in objectives its main adds with fleet telemetry on.
CONTROLLER_SLOS = {"claim_ready_latency", "prepare_errors",
                   "remediation_recovery", "allocation_admission",
                   "canary_availability"}
#: The controller's replicas in the processes phase, active-active over
#: this many lease-claimed shards (``--shards``); the replica holding
#: shard 0 runs the singletons (canary, usage meter, recorder).
CONTROLLER_IDS = ("ctl-a", "ctl-b")
CONTROLLER_SHARDS = 4
#: The controller started first: its shard scan starts at shard 0, so it
#: keeps shard 0 (and the singletons) at a fair share of 2.
CONTROLLER_LEADER = "ctl-b"
#: The spans of the plugin process a claim's trace must hold.
CLAIM_TRACE_SPANS = {"node_prepare", "checkpoint.transact", "cdi.write"}
ROOT = os.path.dirname(os.path.abspath(__file__))
#: Seconds a process has to exit after SIGTERM before it is killed (and
#: the phase fails).
STOP_TIMEOUT_S = 20.0

_ADMISSION_GROUP = "resource.nvidia.com/v1beta1"
_DOMAIN_ID = "0f0f0f0f-0000-4000-8000-000000000001"


def _admission_review(resource: str, configs: list) -> dict:
    spec = {"devices": {"requests": [{"name": "gpu", "exactly": {
        "deviceClassName": DRIVER_NAME}}], "config": configs}}
    if resource == "resourceclaimtemplates":
        spec = {"spec": spec}
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": f"uid-{resource}-{len(configs)}",
                        "resource": {"group": "resource.k8s.io",
                                     "version": "v1", "resource": resource},
                        "object": {"spec": spec}}}


def _opaque(driver: str, kind: str, **fields) -> dict:
    return {"opaque": {"driver": driver, "parameters": {
        "apiVersion": _ADMISSION_GROUP, "kind": kind, **fields}}}


#: AdmissionReviews the webhook process answers, from the corpus of the
#: port's webhook tests: valid and invalid opaque configs of both drivers.
ADMISSION_CORPUS = {
    "no-configs": _admission_review("resourceclaims", []),
    "device-env": _admission_review("resourceclaims", [
        _opaque(DRIVER_NAME, "GpuConfig", env={"FOO": "1"})]),
    "device-unknown-field": _admission_review("resourceclaims", [
        _opaque(DRIVER_NAME, "GpuConfig", bogusField=1)]),
    "channel-single": _admission_review("resourceclaims", [
        _opaque("compute-domain.nvidia.com", "ComputeDomainChannelConfig",
                domainID=_DOMAIN_ID, allocationMode="Single")]),
    "channel-bad-mode": _admission_review("resourceclaims", [
        _opaque("compute-domain.nvidia.com", "ComputeDomainChannelConfig",
                domainID=_DOMAIN_ID, allocationMode="Some")]),
    "daemon-bad-domain": _admission_review("resourceclaimtemplates", [
        _opaque("compute-domain.nvidia.com", "ComputeDomainDaemonConfig",
                domainID="not-a-uuid")]),
}


class Processes:
    """The OS processes a phase starts: each ``python -m`` a module of the
    port from the checkout's root, its output in a log file. ``stop``
    sends SIGTERM, waits, kills a process still alive after
    ``STOP_TIMEOUT_S`` and requires exit code 0; ``close`` ends whatever
    is still running (a phase that failed midway leaves no process)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.procs: list = []

    def spawn(self, name: str, module: str, *args: str
              ) -> subprocess.Popen:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (ROOT, env.get("PYTHONPATH", "")) if p)
        path = os.path.join(self.log_dir, f"{name}.log")
        with open(path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", module, *args], stdout=log,
                stderr=subprocess.STDOUT, cwd=ROOT, env=env)
        proc.name, proc.log_path = name, path
        self.procs.append(proc)
        return proc

    def log_tail(self, proc, n: int = 2000) -> str:
        with open(proc.log_path) as f:
            return f.read()[-n:]

    def alive(self, proc) -> bool:
        require(proc.poll() is None, f"{proc.name} exited {proc.returncode}:"
                                     f" {self.log_tail(proc)}")
        return True

    def wait_log(self, proc, pattern: str, timeout: float = 60.0) -> str:
        """The first group of ``pattern``'s first match in the process's
        log, waiting for it while the process runs."""
        deadline = time.monotonic() + timeout
        while True:
            with open(proc.log_path) as f:
                m = re.search(pattern, f.read())
            if m:
                return m.group(1)
            self.alive(proc)
            require(time.monotonic() < deadline,
                    f"{proc.name}: no {pattern!r} within {timeout} s: "
                    f"{self.log_tail(proc)}")
            time.sleep(0.01)

    def wait_until(self, proc, cond, what: str,
                   timeout: float = 60.0) -> None:
        """``_wait`` that also fails at once if ``proc`` exits."""
        _wait(lambda: self.alive(proc) and cond(), what, timeout)

    def stop(self, proc) -> float:
        """SIGTERM, then ms until the process exited with code 0. The
        caller has seen the process's ready line first: its stop handlers
        are installed only then, and a SIGTERM before it kills the process
        (-15)."""
        t = time.monotonic()
        proc.terminate()
        return self.reap(proc, t)

    def reap(self, proc, t: float) -> float:
        """Wait for a process sent SIGTERM at ``t`` (monotonic): ms from
        ``t`` until it exited with code 0."""
        try:
            rc = proc.wait(timeout=max(0.0, t + STOP_TIMEOUT_S
                                       - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
            require(False, f"{proc.name} still running {STOP_TIMEOUT_S} s "
                           "after SIGTERM (killed)")
        ms = (time.monotonic() - t) * 1e3
        require(rc == 0, f"{proc.name} exited {rc} after SIGTERM: "
                         f"{self.log_tail(proc)}")
        return ms

    def run(self, name: str, module: str, *args: str,
            timeout: float = 60.0) -> tuple:
        """Run a command to its end: (exit code, its output)."""
        proc = self.spawn(name, module, *args)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
            raise SystemExit(f"chip_smoke: FAILED: {name} ran past "
                             f"{timeout} s")
        return rc, self.log_tail(proc)

    def close(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=STOP_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10)


#: The GPU plugin's log lines that give a claim one more Prepare request
#: (an idempotent republish, or a retry armed after a failure) or one more
#: Unprepare request (a retry).
_REPEAT_LINES = {
    "prepare": (r"claim (\S+) prepared but its status entry is missing",
                r"node prepare of claim (\S+) failed",
                r"status publish of claim (\S+) failed"),
    "unprepare": (r"node unprepare of claim (\S+) failed",
                  r"unprepare of deleted claim (\S+) failed",
                  r"status clear of claim (\S+) failed"),
}


def prepare_record(log: str) -> dict:
    """The GPU plugin's own record of its Prepare and Unprepare requests,
    read from its log: ``requests``, each (operation, [(claim UID,
    outcome), ...]) in the log's order, and ``repeats``, per operation the
    count by claim of the log lines that explain a repeated request
    (:data:`_REPEAT_LINES`)."""
    requests = [(op, [tuple(t.split("=", 1)) for t in body.split()
                      if "=" in t])
                for op, body in re.findall(
                    r" (prepare|unprepare) request: (.*?)(?: trace=\S+)?$",
                    log, re.M)]
    repeats = {op: collections.Counter(
        uid for pat in pats for uid in re.findall(pat, log))
        for op, pats in _REPEAT_LINES.items()}
    return {"requests": requests, "repeats": repeats}


def prepare_record_problems(record: dict, counted: dict) -> list:
    """What is wrong with a plugin's request record (:func:`prepare_record`)
    against its request counters (``counted``: operation → the value of
    ``gpu_dra_requests_total``): every counted request is logged; every
    unprepare follows a prepare of its claim; every claim with an ok
    prepare has an ok unprepare after its last ok prepare; and each request
    beyond one per claim and operation is matched by a logged republish or
    retry of that claim."""
    problems = []
    for op, n in counted.items():
        logged = sum(o == op for o, _ in record["requests"])
        if logged != n:
            problems.append(f"{n} {op} requests counted, {logged} logged")
    last: dict = {}
    per_claim: collections.Counter = collections.Counter()
    for op, claims in record["requests"]:
        for uid, outcome in claims:
            per_claim[op, uid] += 1
            if op == "unprepare" and uid not in last:
                problems.append(f"unprepare of {uid} before any prepare")
            if outcome == "ok" or uid not in last:
                last[uid] = (op, outcome)
    for uid, (op, outcome) in sorted(last.items()):
        if (op, outcome) == ("prepare", "ok"):
            problems.append(f"claim {uid} prepared and never unprepared")
    for (op, uid), n in sorted(per_claim.items()):
        if n - 1 > record["repeats"][op][uid]:
            problems.append(f"{n} {op} requests for {uid}, "
                            f"{record['repeats'][op][uid]} logged "
                            "republish or retry")
    return problems


def _slice_uuids(client, driver: str, node: str) -> list:
    """The ``uuid`` attributes of the devices ``driver`` publishes on
    ``node``."""
    return [(d.get("attributes") or {}).get("uuid", {}).get("string")
            for s in client.list("ResourceSlice")
            if s["spec"].get("driver") == driver
            and s["spec"].get("nodeName") == node
            for d in s["spec"].get("devices") or []]


def _metric(text: str, name: str, **labels) -> float:
    """The value of one sample of a Prometheus text exposition (0 when
    absent)."""
    want = "{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}"
    for row in text.splitlines():
        if row.startswith(name + want + " "):
            return float(row.split()[-1])
    return 0.0


def _http_get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as resp:  # noqa: S310
        require(resp.status == 200, f"GET {url}: {resp.status}")
        return resp.read()


class SpecWatch:
    """Polls a CDI root for claim specs other than ``skip``'s, every
    2 ms in a thread: the GPUs each one makes visible
    (``CUDA_VISIBLE_DEVICES``), by claim uid. A canary probe's spec lives
    from its prepare to its unprepare, tens of milliseconds."""

    def __init__(self, cdi_root: str):
        self.handler = CDIHandler(cdi_root)
        self.skip: set = set()
        self.seen: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="spec-watch")

    def _run(self) -> None:
        while not self._stop.wait(0.002):
            try:
                uids = self.handler.list_claim_uids()
            except OSError:
                continue
            for uid in uids:
                if uid in self.seen or uid in self.skip:
                    continue
                try:
                    spec = self.handler.read_claim_spec(uid)
                except (OSError, ValueError):
                    continue
                if spec is not None:
                    self.seen[uid] = visible_device_entries(spec)

    def start(self) -> "SpecWatch":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _canary_rows(doc: list) -> list:
    """Every probe in a controller's ``/debug/canary`` history."""
    return [h for p in doc for st in p["nodes"].values()
            for h in st["history"]]


def _newest_probe(doc: list) -> float:
    """When the newest probe in a ``/debug/canary`` history started (0 when
    there is none). The history keeps the last 32 probes a node, so a new
    probe shows as a newer start, not as a longer history."""
    return max((h["at"] for h in _canary_rows(doc)), default=0.0)


def _shard_holders(client) -> list:
    """The holder of each controller shard's Lease ('' when free)."""
    return [((client.try_get("Lease", f"controller-shard-{i}", "default")
              or {}).get("spec") or {}).get("holderIdentity", "")
            for i in range(CONTROLLER_SHARDS)]


def _family_total(text: str, prefix: str) -> float:
    """The sum of every sample of the families named ``prefix*`` in a
    Prometheus text exposition (0 when there is none)."""
    return sum(float(row.split()[-1]) for row in text.splitlines()
               if row.startswith(prefix))


def _claim_trace(base: str, tracer, root) -> tuple:
    """The claim's whole trace: the spans this process recorded under the
    root's trace id (the root and the allocation) merged with those the
    plugin process recorded (read from its ``/debug/traces``), once these
    include :data:`CLAIM_TRACE_SPANS` and the merged trace passes
    ``audit_traces`` (a span the process still has open would orphan its
    ended children for a moment). Returns the merged trace with what the
    merge took to come out clean: the number of reads of
    ``/debug/traces``, the ms they spanned, and the audit's problem count
    on the first read."""
    local = [s for s in tracer.store.spans()
             if s["trace_id"] == root.trace_id]
    t0 = time.monotonic()
    deadline = t0 + 10.0
    polls, first_problems = 0, None
    while True:
        snap = json.loads(_http_get(base + "/debug/traces"))
        require(snap["enabled"], "the plugin's tracer is off")
        spans = sorted([*local, *(
            s for s in snap["spans"] if s["trace_id"] == root.trace_id)],
            key=lambda s: (s["start"], s["span_id"]))
        merged = {root.trace_id: spans}
        problems = tracing.audit_traces(merged,
                                        dropped=snap["dropped_spans"])
        names = {s["name"] for s in spans}
        polls += 1
        if first_problems is None:
            first_problems = len(problems)
        if CLAIM_TRACE_SPANS <= names and not problems:
            return (merged, polls, (time.monotonic() - t0) * 1e3,
                    first_problems)
        require(time.monotonic() < deadline,
                f"the claim's trace: spans {sorted(names)}, "
                f"problems {problems}")
        time.sleep(0.01)


def phase_processes(card: str, seed: int, gpu, device_args: tuple = (),
                    width: dict | None = None) -> dict:
    """The port's binaries as OS processes, as a node runs them: the API
    server (``k8sclient.httpapi``), then the GPU kubelet plugin on the
    machine's own device library (``device_args`` adds ``--mock-profile``
    on a machine without the card, as the tests run it). Over HTTP the
    phase creates the DeviceClass and the Node and waits for the plugin's
    ResourceSlice to name the card's UUID (``plugin_start_ms``: spawn to
    slice); a claim for that UUID is allocated over HTTP and the plugin
    process prepares it (``claim_ready_ms``). The engine is bound to the CDI
    spec the plugin wrote and serves 16 requests through the decode kernel
    (``ttfb_ms``, ``decode_tok_s``). The plugin's ``/metrics`` counts the
    prepare, its ``/debug`` endpoints answer, and its gRPC health service
    reads SERVING where ``grpc`` imports. The claim is unreserved,
    unprepared by the plugin and deleted, the
    plugin stops on SIGTERM with exit code 0 (``stop_ms``), and no claim,
    checkpoint entry or CDI spec is left. Then the webhook process answers
    an admission corpus as the in-process ``review_response`` does, the
    ComputeDomain plugin publishes ``channel-0`` and ``daemon``, ``daemon
    check`` exits 0, and ``daemon run`` publishes its clique entry and
    withdraws it on SIGTERM. Every process exits 0 on SIGTERM. The engine
    and its batch are the selfheal phase's (:data:`SELFHEAL_WIDTH`, which
    ``width`` overrides).

    The plugin runs with ``--trace true``. The claim carries the
    traceparent of a root span ``claim`` that the smoke starts before it
    creates the claim and ends ``ok`` at Ready; merged with the spans the
    plugin process recorded under that trace id (its ``/debug/traces``),
    the trace must pass ``audit_traces`` and hold ``node_prepare``,
    ``checkpoint.transact`` and ``cdi.write``; its ``phase_breakdown`` is
    printed (``watch_delivery``, each span's ms, ``total``), and the
    plugin's prepare-duration histogram carries an exemplar naming it.

    Two controller processes (``python -m ...compute_domain_controller
    --shards 4``, identities ``ctl-a`` and ``ctl-b``) run beside the
    plugin, each scraping its ``/metrics`` every 0.2 s. ``ctl-b`` starts
    first and takes all four ``controller-shard-*`` Leases; once ``ctl-a``
    has joined, the Leases must split between them with shard 0 on
    ``ctl-b`` (:data:`CONTROLLER_LEADER`), whose shedding order keeps it.
    The holder of shard 0 (the leader) runs the canary (a probe every
    0.5 s), the usage meter and the flight recorder
    (``controller_start_ms``: each spawn to its ``running`` line, the
    larger; ``first_scrape_ms``: the first spawn to both scraping the
    plugin up; ``shards_split_ms``: the first spawn to the split). Before the claim: a canary probe
    succeeded (its CDI spec, read from the plugin's CDI root, names one of
    the node's GPUs), each ``/debug/slo`` lists the default SLOs with
    ``allocation_admission`` and ``canary_availability`` and none firing,
    and the leader's ``/debug/incidents`` holds no bundle (the follower
    has no recorder). The claim is allocated right after a probe, retried
    while a probe holds the card, and held until a probe has run during
    it: on a node of one GPU such a probe is refused in admission
    (``canary_refused``), and the ``canary_availability`` SLO may then
    fire, with its incident bundle — no other SLO may, and no probe may
    fail otherwise. Only the leader's ``/metrics`` counts canary and usage
    samples. While the claim is held the leader gets SIGTERM: the
    follower must hold shard 0 (``handoff_ms``, from the SIGTERM) and then
    every shard, start fresh usage-meter, canary and recorder incarnations,
    and hold the claim open again from its usage-since stamp; the leader
    exits 0. The follower's ``/metrics`` mirrors the plugin's families as
    ``gpu_dra_fleet_*``; its ``/debug/usage`` bills the claim's tenant
    within 5% of the claim's Ready-to-deleted span on the host's clock
    (``usage_gpu_s``, ``host_span_s``); it exits 0 on SIGTERM
    (``controller_stop_ms``), and no canary claim, checkpoint entry or CDI
    spec is left. The plugin's log records each Prepare and Unprepare
    request by claim (:func:`prepare_record`): it must hold every request
    that ``gpu_dra_requests_total`` counted, every claim it prepared (the
    served one and each probe past admission) unprepared after, and each
    request beyond one per claim matched by a logged republish or retry of
    that claim (the claim watcher republishes through an idempotent
    prepare when a racing status writer dropped its Ready entry)."""
    w = {**SELFHEAL_WIDTH, **(width or {})}
    try:
        import grpc  # noqa: F401
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck \
            import check_health
        has_grpc = True
    except ImportError:
        has_grpc = False
    line("processes", card=json.dumps(card), grpc=has_grpc,
         health_server="on" if has_grpc else "off (--healthcheck-addr '')")
    rng = np.random.default_rng(seed + 8)
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        procs = Processes(tmp)
        try:
            api = procs.spawn("api-server", API_SERVER_MODULE, "--port", "0")
            endpoint = procs.wait_log(api, r"api server listening on (\S+)")
            client = HttpClient(endpoint)
            # An abstract unix socket: no path, so no length limit.
            health = (f"unix-abstract:gpu-dra-smoke-health-{os.getpid()}"
                      if has_grpc else "")
            t_spawn = time.monotonic()
            plugin = procs.spawn(
                "gpu-kubelet-plugin", GPU_PLUGIN_MODULE,
                "--node-name", "node-0", "--api-endpoint", endpoint,
                "--state-dir", f"{tmp}/state", "--cdi-root", f"{tmp}/cdi",
                "--metrics-port", "0", "--healthcheck-addr", health,
                "--trace", "true", *device_args)
            client.create(new_object(
                "DeviceClass", DRIVER_NAME, spec={"selectors": [{"cel": {
                    "expression": "device.attributes['type'] == 'gpu'"}}]}))
            client.create(new_object("Node", "node-0"))
            procs.wait_until(plugin, lambda: gpu.uuid in _slice_uuids(
                client, DRIVER_NAME, "node-0"), "the plugin's slice naming "
                "the card")
            out["plugin_start_ms"] = (time.monotonic() - t_spawn) * 1e3
            published = _slice_uuids(client, DRIVER_NAME, "node-0")
            # Every component started (the claim loop last).
            procs.wait_log(plugin, r"(running on node node-0)")
            out["plugin_ready_ms"] = (time.monotonic() - t_spawn) * 1e3
            metrics_port = procs.wait_log(
                plugin, r"metrics on http://127\.0\.0\.1:(\d+)/metrics")
            base = f"http://127.0.0.1:{metrics_port}"
            line("processes", api_server=endpoint, plugin_pid=plugin.pid,
                 devices_published=len(published),
                 plugin_start_ms=out["plugin_start_ms"],
                 plugin_ready_ms=out["plugin_ready_ms"])
            require(len(published) > 0 and gpu.uuid in published,
                    f"the plugin published {published}, not {gpu.uuid}")

            # Two sharded controllers watching the plugin: each scrapes it
            # (fleet telemetry, the SLO engine); the one holding shard 0
            # runs the canary, the usage meter and the recorder.
            specs = SpecWatch(f"{tmp}/cdi").start()
            t_ctl = time.monotonic()
            ctls: dict = {}
            start_ms = []
            # The leader starts alone and takes every shard; the other
            # joins after. An over-share replica sheds its shards in the
            # reverse of its scan order, and the leader's scan starts at
            # shard 0 (crc32 of its identity), so it never sheds shard 0
            # down to a fair share of 2: the singletons stay on it while
            # the phase runs, whatever the timing of the rebalance.
            for ident in (CONTROLLER_LEADER, *(
                    i for i in CONTROLLER_IDS if i != CONTROLLER_LEADER)):
                t_spawn = time.monotonic()
                ctls[ident] = procs.spawn(
                    ident, CONTROLLER_MODULE, "--api-endpoint", endpoint,
                    "--metrics-port", "0", "--fleet-scrape-targets",
                    f"node-0=127.0.0.1:{metrics_port}",
                    "--fleet-scrape-interval", "0.2",
                    "--canary-interval", "0.5",
                    "--incident-dir", f"{tmp}/incidents-{ident}",
                    "--shards", str(CONTROLLER_SHARDS), "--identity", ident)
                procs.wait_log(ctls[ident],
                               r"(compute-domain-controller running)")
                start_ms.append((time.monotonic() - t_spawn) * 1e3)
                if ident == CONTROLLER_LEADER:
                    procs.wait_until(ctls[ident], lambda: _shard_holders(
                        client) == [CONTROLLER_LEADER] * CONTROLLER_SHARDS,
                        "the first controller holding every shard")
            out["controller_start_ms"] = max(start_ms)
            ctl_base = {ident: "http://127.0.0.1:" + procs.wait_log(
                ctl, r"metrics on http://127\.0\.0\.1:(\d+)/metrics")
                for ident, ctl in ctls.items()}

            def ctl_get(ident: str, path: str):
                return json.loads(_http_get(ctl_base[ident] + path))

            def plugin_up(ident: str) -> bool:
                rows = [t for t in ctl_get(ident, "/debug/fleet")["targets"]
                        if t["name"] == "node-0"]
                return bool(rows) and not rows[0]["stale"] and \
                    rows[0]["scrapes"] > rows[0]["failures"]

            for ident, ctl in ctls.items():
                procs.wait_until(ctl, lambda i=ident: plugin_up(i),
                                 f"{ident}'s first scrape of the plugin")
            out["first_scrape_ms"] = (time.monotonic() - t_ctl) * 1e3
            # The shards split between the replicas (each syncs every 2 s;
            # an over-share replica sheds one shard per rebalance window).
            _wait(lambda: all(procs.alive(c) for c in ctls.values())
                  and set(_shard_holders(client)) == set(CONTROLLER_IDS),
                  "the shards split between the controllers")
            out["shards_split_ms"] = (time.monotonic() - t_ctl) * 1e3
            split = _shard_holders(client)
            leader = split[0]
            require(leader == CONTROLLER_LEADER, f"shard holders {split}")
            follower = next(i for i in CONTROLLER_IDS if i != leader)
            procs.wait_until(ctls[leader], lambda: any(
                h["outcome"] == "ok"
                for h in _canary_rows(ctl_get(leader, "/debug/canary"))),
                "a canary probe of the node")
            slo = {i: ctl_get(i, "/debug/slo") for i in CONTROLLER_IDS}
            incidents = {i: ctl_get(i, "/debug/incidents")
                         for i in CONTROLLER_IDS}
            names = {i: {x["name"] for e in slo[i] for x in e["slos"]}
                     for i in CONTROLLER_IDS}
            line("processes", controllers=json.dumps(
                {i: c.pid for i, c in ctls.items()}),
                 controller_start_ms=out["controller_start_ms"],
                 first_scrape_ms=out["first_scrape_ms"],
                 shards_split_ms=out["shards_split_ms"],
                 shard_holders=json.dumps(split), leader=leader,
                 slos=json.dumps(sorted(names[leader])),
                 firing=json.dumps([e["firing"] for i in CONTROLLER_IDS
                                    for e in slo[i]]),
                 incident_bundles=sum(len(r["bundles"]) for i in
                                      CONTROLLER_IDS for r in incidents[i]))
            for i in CONTROLLER_IDS:
                require(len(slo[i]) == 1 and CONTROLLER_SLOS <= names[i],
                        f"{i}'s /debug/slo lists {sorted(names[i])}")
                require(slo[i][0]["firing"] == {}, f"SLOs firing: {slo}")
            # The recorder is the leader's alone.
            require(len(incidents[leader]) == 1
                    and not incidents[leader][0]["bundles"]
                    and incidents[follower] == [],
                    f"/debug/incidents: {incidents}")

            # A claim for the card over HTTP, prepared by the process,
            # allocated right after a canary probe (the card is free), and
            # traced: the smoke's root span, stamped on the claim, is the
            # parent of this process's allocation span and of the plugin
            # process's spans.
            name, ns = "proc-claim", PROCESSES_TENANT
            newest = _newest_probe(ctl_get(leader, "/debug/canary"))
            procs.wait_until(ctls[leader], lambda: _newest_probe(
                ctl_get(leader, "/debug/canary")) > newest,
                "a canary probe")
            tracer = tracing.default_tracer().enable()
            t0 = time.monotonic()
            hold_from = time.time()
            root = tracer.start_span("claim", new_root=True, activate=False,
                                     attributes={"claim": name})
            claim = client.create(tracer.inject(root, new_object(
                "ResourceClaim", name, ns,
                api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{"name": "gpu", "exactly": {
                    "deviceClassName": DRIVER_NAME,
                    "allocationMode": "ExactCount", "count": 1,
                    "selectors": [{"cel": {"expression":
                        f"device.attributes['uuid'] == '{gpu.uuid}'"}}]}}]}})))
            attempts = 0
            while True:    # a probe in flight holds the card: retry
                attempts += 1
                try:
                    Allocator(client).allocate(claim, reserved_for=[
                        {"resource": "pods", "name": "proc-pod"}],
                        node="node-0")
                    break
                except AllocationError as e:
                    require(attempts < 500, f"allocation refused: {e}")
                    time.sleep(0.01)
            out["allocate_ms"] = (time.monotonic() - t0) * 1e3
            uid = claim["metadata"]["uid"]
            procs.wait_until(plugin, lambda: _claim_ready(client, name, ns),
                             "claim Ready over the wire")
            t_ready = time.monotonic()
            root.set_status("ok")
            root.end()
            out["claim_ready_ms"] = (t_ready - t0) * 1e3
            trace, trace_polls, trace_wait_ms, first_problems = \
                _claim_trace(base, tracer, root)
            spans = trace[root.trace_id]
            breakdown = tracing.phase_breakdown(trace)
            out["breakdown"] = {k: v["p50_ms"] for k, v in breakdown.items()}
            exemplar = re.search(
                r"# EXEMPLAR gpu_dra_request_duration_seconds_bucket\{"
                r'[^}]*operation="prepare"[^}]*\} trace_id=(\w+) ',
                _http_get(f"{base}/metrics").decode())
            line("processes", trace_id=root.trace_id, trace_spans=len(spans),
                 trace_polls=trace_polls, trace_wait_ms=trace_wait_ms,
                 first_read_problems=first_problems,
                 span_names=json.dumps(sorted(
                     {s["name"] for s in spans})),
                 prepare_exemplar=exemplar.group(1) if exemplar else None)
            line("processes", breakdown_ms=json.dumps(
                {k: {"ms": v["p50_ms"], "count": v["count"]}
                 for k, v in breakdown.items()}))
            require({"watch_delivery", "total"} <= set(breakdown),
                    f"the claim's breakdown: {sorted(breakdown)}")
            require(exemplar is not None
                    and exemplar.group(1) == root.trace_id,
                    "the prepare histogram's exemplar names "
                    f"{exemplar and exemplar.group(1)}, not {root.trace_id}")
            spec = CDIHandler(f"{tmp}/cdi").read_claim_spec(uid)
            require(spec is not None, "no CDI spec from the plugin process")
            entries = visible_device_entries(spec)
            require(entries == [gpu.uuid],
                    f"the plugin's spec names {entries}, not {gpu.uuid}")
            engine = bind_engine(
                spec, "processes", device=w["device"], uuids=w["uuids"],
                metrics=ServingMetrics(), max_batch=w["max_batch"],
                kv_cap=w["kv_cap"], heads=w["heads"],
                head_dim=w["head_dim"], tokens_per_chip_step=2048,
                queue_cap=64, modeled_chip_tok_s=1e9)
            out["bind_ms"] = (time.monotonic() - t_ready) * 1e3
            reqs = tenant_requests(rng, w["requests"], "p", w["prompts"],
                                   w["new_tokens"])
            wall = serve_requests(engine, reqs, "processes")
            out["ttfb_ms"] = (engine.first_batch_t - t0) * 1e3
            done = finish_engine(engine)
            summary = done["summary"]
            out["decode_tok_s"] = summary["decode_tokens"] / wall
            out["launches"] = done["counts"]["decode_attention"]
            out["decode_steps"] = done["decode_steps"]
            line("processes", claim=name, cuda_visible_devices=json.dumps(
                entries), engine_device=str(engine.device),
                allocate_ms=out["allocate_ms"], allocate_attempts=attempts,
                claim_ready_ms=out["claim_ready_ms"], bind_ms=out["bind_ms"],
                ttfb_ms=out["ttfb_ms"],
                decode_tok_s=out["decode_tok_s"],
                completed=summary["completed"],
                decode_steps=out["decode_steps"],
                kernel_launches=json.dumps(done["counts"]))
            check_served(engine, done, reqs, "processes")
            del engine
            if w["device"] is None:
                torch.cuda.empty_cache()

            # The plugin's metrics, debug endpoints and health service.
            text = _http_get(f"{base}/metrics").decode()
            prepares = _metric(text, "gpu_dra_requests_total",
                               driver=DRIVER_NAME, operation="prepare")
            debug = {}
            for ep in ("informers", "workqueue", "inflight", "nodelease",
                       "profile"):
                debug[ep] = json.loads(_http_get(f"{base}/debug/{ep}"))
            heartbeats = [h["node"] for h in debug["nodelease"]["heartbeats"]]
            samples = sum(sum(p["samples"].values())
                          for p in debug["profile"])
            serving = check_health(health) if has_grpc else "not served"
            line("processes", prepare_requests=prepares,
                 debug=json.dumps({k: len(v) for k, v in debug.items()}),
                 lease_heartbeats=json.dumps(heartbeats),
                 profile_samples=samples, health=serving)
            # The canary's probes are prepared by the same plugin.
            require(prepares >= 1, f"prepare counter {prepares}")
            require(heartbeats == ["node-0"] and debug["informers"]
                    and len(debug["profile"]) == 1,
                    f"debug endpoints: {debug}")
            require(not has_grpc or serving == STATUS_SERVING,
                    f"health check read {serving}")

            # The tenant holds the claim until a canary probe has run
            # during it, and the meter bills it on the card. Only the
            # leader counts canary and usage samples.
            live = [r for u in ctl_get(leader, "/debug/usage")
                    for r in u["live"] if r["namespace"] == ns]
            require([(r["name"], r["gpus"]) for r in live] == [(name, 1)],
                    f"the usage meter's live claims: {live}")
            newest = _newest_probe(ctl_get(leader, "/debug/canary"))
            procs.wait_until(ctls[leader], lambda: _newest_probe(
                ctl_get(leader, "/debug/canary")) > newest,
                "a canary probe during the claim")
            counted = {}
            for i in CONTROLLER_IDS:
                t = _http_get(ctl_base[i] + "/metrics").decode()
                counted[i] = (_family_total(t, "gpu_dra_canary_"),
                              _family_total(t, "gpu_dra_usage_"))
            line("processes", canary_usage_samples=json.dumps(counted))
            require(min(counted[leader]) > 0
                    and counted[follower] == (0.0, 0.0),
                    f"canary and usage samples by replica: {counted}")

            # SIGTERM the leader while the claim is held: it releases its
            # shards, and the follower takes all of them and starts fresh
            # singletons, whose meter rebuilds the claim's open interval
            # from its usage-since stamp.
            rows = _canary_rows(ctl_get(leader, "/debug/canary"))
            slo_seen = [ctl_get(leader, "/debug/slo")]
            bundles = [b for r in ctl_get(leader, "/debug/incidents")
                       for b in r["bundles"]]
            t_term = time.monotonic()
            ctls[leader].terminate()
            successor = ctls[follower]
            procs.wait_until(successor, lambda: _shard_holders(client)[0]
                             == follower, "the follower holding shard 0")
            out["handoff_ms"] = (time.monotonic() - t_term) * 1e3
            procs.wait_until(successor, lambda: _shard_holders(client)
                             == [follower] * CONTROLLER_SHARDS,
                             "the follower holding every shard")
            out["all_shards_ms"] = (time.monotonic() - t_term) * 1e3
            out["leader_stop_ms"] = procs.reap(ctls[leader], t_term)
            for single in ("usage-meter", "canary-prober", "flight-recorder"):
                procs.wait_log(successor, rf"started singleton ({single}) "
                               r"\(incarnation 1\)")
            procs.wait_until(successor, lambda: [
                (r["name"], r["gpus"])
                for u in ctl_get(follower, "/debug/usage")
                for r in u["live"] if r["namespace"] == ns] == [(name, 1)],
                "the successor's meter holding the claim open")
            line("processes", handoff_ms=out["handoff_ms"],
                 all_shards_ms=out["all_shards_ms"],
                 leader_stop_ms=out["leader_stop_ms"],
                 leader_exit=ctls[leader].returncode,
                 shard_holders=json.dumps(_shard_holders(client)))

            # Teardown: unreserve, the process unprepares, delete.
            c = client.get("ResourceClaim", name, ns)
            c["status"].pop("reservedFor", None)
            client.update_status(c)
            procs.wait_until(plugin, lambda: not any(
                d.get("driver") == DRIVER_NAME for d in (client.get(
                    "ResourceClaim", name, ns).get("status")
                    or {}).get("devices") or []), "claim unprepared")
            client.delete("ResourceClaim", name, ns)
            host_span_s = time.monotonic() - t_ready
            hold_to = time.time()

            # The successor's bill, mirror, probes and SLOs; then SIGTERM.
            procs.wait_until(successor, lambda: not [
                r for u in ctl_get(follower, "/debug/usage")
                for r in u["live"] if r["namespace"] == ns],
                "the meter closing the claim")
            usage = ctl_get(follower, "/debug/usage")
            usage_gpu_s = sum(u["tenants"].get(ns, 0.0) for u in usage)
            ctl_metrics = _http_get(ctl_base[follower] + "/metrics").decode()
            mirrored = _metric(ctl_metrics, "gpu_dra_fleet_requests_total",
                               driver=DRIVER_NAME, operation="prepare")
            spec_ids = {u: v for u, v in specs.seen.items() if u != uid}
            rows += _canary_rows(ctl_get(follower, "/debug/canary"))
            ok = [h for h in rows if h["outcome"] == "ok"]
            refused = [h for h in rows if h["outcome"] == "failed"
                       and h["phase"] == "admission"
                       and h["at"] < hold_to
                       and h["at"] + h["duration_s"] > hold_from]
            other = [h for h in rows if h["outcome"] != "ok"
                     and h not in refused]
            slo_seen.append(ctl_get(follower, "/debug/slo"))
            firing = sorted({k.split("/")[0] for sl in slo_seen
                             for e in sl for k in e["firing"]})
            bundles += [b for r in ctl_get(follower, "/debug/incidents")
                        for b in r["bundles"]]
            out["controller_stop_ms"] = procs.stop(successor)
            specs.stop()
            # Every claim the plugin prepared (the served one and each
            # probe past admission) it has unprepared: read per claim from
            # the plugin's own log, every counted request in it.
            text = _http_get(f"{base}/metrics").decode()
            prepares, unprepares = (
                _metric(text, "gpu_dra_requests_total", driver=DRIVER_NAME,
                        operation=op) for op in ("prepare", "unprepare"))
            with open(plugin.log_path) as f:
                record = prepare_record(f.read())
            prepared = {u for op, claims in record["requests"]
                        for u, outcome in claims
                        if op == "prepare" and outcome == "ok"}
            repeated = {op: sum(r.values())
                        for op, r in record["repeats"].items()}
            out.update(canary_ok=len(ok), canary_refused=len(refused),
                       usage_gpu_s=usage_gpu_s, host_span_s=host_span_s)
            line("processes", usage_gpu_s=usage_gpu_s,
                 host_span_s=host_span_s,
                 usage_over_span=usage_gpu_s / host_span_s,
                 fleet_prepare_requests=mirrored,
                 canary_ok=len(ok), canary_refused=len(refused),
                 canary_other=len(other),
                 canary_specs=json.dumps(sorted(
                     {e for v in spec_ids.values() for e in v})),
                 firing=json.dumps(firing),
                 incident_bundles=json.dumps(
                     [(b["slo"], b["status"]) for b in bundles]),
                 controller_stop_ms=out["controller_stop_ms"],
                 controller_exits=json.dumps(
                     {i: c.returncode for i, c in ctls.items()}))
            require(abs(usage_gpu_s - host_span_s) <= 0.05 * host_span_s,
                    f"usage bill {usage_gpu_s} GPU-s against a span of "
                    f"{host_span_s} s")
            require(mirrored >= 1, "no gpu_dra_fleet_* mirror of the "
                                   "plugin's request counter")
            require(ok and not other, f"canary probes: {rows}")
            require(spec_ids and all(
                len(v) == 1 and v[0] in published
                for v in spec_ids.values()),
                f"canary CDI specs make visible {spec_ids}")
            # A refused probe is unavailability by the SLO's own definition:
            # only canary_availability may burn for it.
            allowed = {"canary_availability"} if refused else set()
            require(set(firing) <= allowed, f"SLOs firing: {firing}")
            require({b["slo"] for b in bundles} <= allowed,
                    f"incident bundles: {bundles}")
            problems = prepare_record_problems(
                record, {"prepare": prepares, "unprepare": unprepares})
            require(not problems, f"the plugin's request record: {problems}")
            require(uid in prepared and len(prepared) >= 1 + len(ok),
                    f"{len(prepared)} claims prepared for 1 claim and "
                    f"{len(ok)} probes")
            claims_left = [o["metadata"]["name"]
                           for o in client.list("ResourceClaim")]
            out["stop_ms"] = procs.stop(plugin)
            with open(f"{tmp}/state/checkpoint.json") as f:
                entries_left = sorted(
                    Checkpoint.unmarshal(f.read()).prepared_claims)
            specs_left = sorted(os.listdir(f"{tmp}/cdi"))
            line("processes", prepare_requests=prepares,
                 unprepare_requests=unprepares, claims_prepared=len(prepared),
                 republish_or_retry=json.dumps(repeated),
                 stop_ms=out["stop_ms"], plugin_exit=plugin.returncode,
                 residue=json.dumps(claims_left + entries_left + specs_left))
            require(not (claims_left or entries_left or specs_left),
                    f"left behind: {claims_left + entries_left + specs_left}")

            # The webhook process against the in-process admit function.
            hook = procs.spawn("webhook", WEBHOOK_MODULE, "--port", "0")
            hook_ep = procs.wait_log(hook, r"webhook server on (http://\S+)")
            agree = 0
            for case, review in ADMISSION_CORPUS.items():
                req = urllib.request.Request(
                    hook_ep + "/validate-resource-claim-parameters",
                    data=json.dumps(review).encode(), method="POST",
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as resp:  # noqa: S310
                    got = json.loads(resp.read())
                require(got == review_response(review),
                        f"webhook process on {case}: {got}")
                agree += 1
            allowed = sum(review_response(r)["response"]["allowed"]
                          for r in ADMISSION_CORPUS.values())
            procs.wait_log(hook, r"(serving on http://\S+)")
            out["webhook_stop_ms"] = procs.stop(hook)
            line("processes", webhook=hook_ep, reviews=agree,
                 allowed=allowed, denied=agree - allowed,
                 webhook_stop_ms=out["webhook_stop_ms"])
            require(0 < allowed < agree, "the corpus needs both answers")

            # The ComputeDomain plugin and daemon on the same node.
            cd_plugin = procs.spawn(
                "cd-kubelet-plugin", CD_PLUGIN_MODULE,
                "--node-name", "node-0", "--api-endpoint", endpoint,
                "--state-dir", f"{tmp}/cd-state", "--cdi-root",
                f"{tmp}/cd-cdi", "--metrics-port", "-1",
                "--healthcheck-addr", "", *device_args)

            def cd_devices() -> list:
                return sorted(d["name"] for s in client.list("ResourceSlice")
                              if s["spec"].get("driver") == CD_DRIVER_NAME
                              for d in s["spec"].get("devices") or [])

            procs.wait_until(cd_plugin, cd_devices, "the CD plugin's slice")
            cd_published = cd_devices()
            rc, said = procs.run("cd-daemon-check", CD_DAEMON_MODULE, "check",
                                 "--node-name", "node-0", *device_args)
            require(rc == 0 and "READY" in said,
                    f"daemon check exited {rc}: {said}")
            daemon = procs.spawn(
                "cd-daemon", CD_DAEMON_MODULE, "run", "--node-name",
                "node-0", "--api-endpoint", endpoint, "--cd-uid",
                "proc-cd-uid", "--cd-name", "proc-cd", "--pod-ip",
                "127.0.0.1", "--sync-interval", "0.5", *device_args)

            def daemon_nodes() -> list:
                return [d.node_name for c in client.list(
                    "ComputeDomainClique") for d in clique_daemons(c)]

            procs.wait_until(daemon, lambda: "node-0" in daemon_nodes(),
                             "the daemon's clique entry")
            procs.wait_log(daemon, r"(running for ComputeDomain proc-cd-uid)")
            daemon_stop_ms = procs.stop(daemon)
            withdrawn = "node-0" not in daemon_nodes()
            procs.wait_log(cd_plugin, r"(running on node node-0)")
            cd_stop_ms = procs.stop(cd_plugin)
            line("processes", cd_devices=json.dumps(cd_published),
                 daemon_check=rc, daemon_withdrawn=withdrawn,
                 daemon_stop_ms=daemon_stop_ms, cd_plugin_stop_ms=cd_stop_ms)
            require(cd_published == ["channel-0", "daemon"],
                    f"the CD plugin published {cd_published}")
            require(withdrawn, "the daemon left its clique entry")
            out["api_stop_ms"] = procs.stop(api)
        finally:
            # The default tracer is process-global: leave it as found,
            # off and without this phase's spans.
            tracing.disable()
            tracing.default_tracer().store.clear()
            procs.close()
        exits = {p.name: p.returncode for p in procs.procs}
    left = child_processes()
    line("processes", exits=json.dumps(exits), api_stop_ms=out["api_stop_ms"],
         children_left=json.dumps(left))
    require(all(rc == 0 for rc in exits.values()), f"exit codes {exits}")
    require(not left, f"processes left running: {left}")
    return out


#: The soak's replica engines: one attention layer of Llama-2-7B (the serve
#: phase's heads, head dim and cache) in the JAX leg's 8 slots, queue of
#: 64 and 16-token step budget; no modeled device sleep (the card decodes).
SOAK_ENGINE = {"max_batch": 8, "heads": HEADS, "head_dim": HEAD_DIM,
               "kv_cap": KV_CAP, "tokens_per_chip_step": 16,
               "modeled_chip_tok_s": 1e9, "queue_cap": 64}


def soak_check(rng: np.random.Generator, e: dict, phase: str = "soak",
               emit: bool = True) -> float:
    """The decode kernel against its plain version at engines' shape ``e``
    (the soak's: q [8, 32, 1, 128] against a [8, 32, 4096, 128] cache),
    random K/V (drawn on the card from a generator seeded by ``rng``) and
    ragged lengths (1, the full cache, the rest uniform), f32 within
    F32_TOL. Prints a ``phase`` line unless ``emit`` is off. Returns the
    error."""
    dev = torch.device("cuda", 0)
    b, h, d, cap = e["max_batch"], e["heads"], e["head_dim"], e["kv_cap"]
    lens = rng.integers(1, cap + 1, size=b).astype(np.int32)
    lens[:2] = (1, cap)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    q, k, v = (randn(gen, shape, torch.float32)
               for shape in ((b, h, 1, d), (b, h, cap, d), (b, h, cap, d)))
    lt = torch.from_numpy(lens).to(dev)
    out = flash_attention_decode(q, k, v, lt)
    ref = decode_attention_reference(q, k, v, lt)
    err = (out - ref).abs().max().item()
    require(out.shape == ref.shape and bool(torch.isfinite(out).all())
            and err < F32_TOL, f"{phase} shape: error {err}")
    if emit:
        line(phase, kernel="decode_attention",
             shape=json.dumps([b, h, 1, d]), kv_cap=cap,
             lengths=json.dumps(lens.tolist()), dtype="f32",
             max_abs_err=err)
    return err


def phase_soak(card: str, rng: np.random.Generator, device=None,
               engine: dict | None = None) -> dict:
    """``run_serving_soak`` with the JAX leg's defaults (8 s, 2 mock
    ``h100-8`` nodes, node 0 killed at 2.0 s, 1.2 s leases, 2 replicas,
    0.35 s sessions, 0.6 s deadline, seed 0) and its traffic (bursts of 8
    requests, 4-token prompts, 4 new tokens), the replicas' engines on the
    card (every mock GPU's UUID mapped onto it) at :data:`SOAK_ENGINE`'s
    width (``engine`` overrides it, ``device`` moves it). Its own path:
    the counts are zeroed before it and read after it. The soak's oracle
    must hold whole — no error, leak or stuck claim; the ``claim_ready``
    page fired during the node loss and cleared after the repair; a
    resolved incident bundle; GPU-seconds conserved across the kill; green
    sessions after the rejoin; every replica's ``completed + shed +
    rejected == submitted``; ``kv_isolation_max_err`` under F32_TOL — and
    the replicas' decode-kernel launches must equal their decode steps
    (none on a CPU engine). Prints the page's delay after the kill and its
    clear after the rejoin, the sessions per replica, the replicas'
    first-batch p50, decode tok/s (decode tokens over the soak's run) and
    the phase's wall time; then the kernel against its plain version at
    the engines' shape (``soak_check``), outside the counted run."""
    e = {**SOAK_ENGINE, **(engine or {})}
    t0 = time.monotonic()
    reset_launches()
    r = run_serving_soak(device=device, serving_engine=e)
    n = launches()["decode_attention"]
    wall = time.monotonic() - t0
    sv = r["serving"]
    replica_launches = n - sv["warmup_launches"]
    on_card = sv["device"].startswith("cuda")
    for rep_name, rep in sorted(sv["per_replica"].items()):
        line("soak", replica=rep_name, node=rep["node"],
             sessions=rep["sessions"], ok=rep["ok"], errors=rep["errors"],
             first_batch_p50_ms=rep["ttfb_p50_s"] * 1e3,
             decode_tokens=rep["decode_tokens"],
             decode_steps=rep["decode_steps"], accounted=rep["accounted"])
    line("soak", card=json.dumps(card), device=sv["device"],
         engine=json.dumps(e), seconds=r["duration_s"],
         detection_s=r["node_failure"]["detections_s"].get("node_kill"),
         page_after_kill_s=sv["detection_delay_s"],
         rejoin_after_kill_s=sv["rejoin_after_kill_s"],
         clear_after_rejoin_s=sv["clear_after_rejoin_s"],
         sessions=sv["sessions"], ok_sessions=sv["ok_sessions"],
         error_sessions=sv["error_sessions"],
         first_batch_p50_ms=sv["ttfb_p50_s"] * 1e3,
         first_batch_p99_ms=sv["ttfb_p99_s"] * 1e3,
         decode_tok_s=sv["decode_tokens"] / r["duration_s"],
         bundles=sv["bundles"], conservation=json.dumps(sv["conservation"]),
         accounting=json.dumps(sv["accounting"]),
         kv_isolation_max_err=sv["kv_isolation_max_err"],
         decode_steps=sv["decode_steps"], warmup_launches=sv[
             "warmup_launches"], kernel_launches=n, wall_s=wall)
    require(r["error_count"] == 0, f"soak errors: {r['errors']}")
    require(not r["leaks"] and r["outcomes"]["stuck"] == 0,
            f"soak leaks {r['leaks']}, outcomes {r['outcomes']}")
    require(sv["fired_page"] and sv["cleared"]
            and sv["clear_after_rejoin_s"] is not None,
            f"claim_ready page fired {sv['fired_page']}, cleared "
            f"{sv['cleared']} after the rejoin {sv['clear_after_rejoin_s']}")
    require(sv["pre_kill_pages"] == 0 and sv["fault_free_failures"] == 0,
            f"pages before the kill {sv['pre_kill_pages']}, failures off "
            f"the kill path {sv['fault_free_failures']}")
    require(sv["bundle_captured"], "no resolved claim_ready bundle")
    require(sv["conservation_ok"], f"usage: {sv['conservation']}")
    require(sv["green_after_rejoin"], "no green session after the rejoin")
    require(sv["accounting"]["ok"] and all(
        rep["accounted"] for rep in sv["per_replica"].values()),
        f"accounting: {sv['accounting']}")
    require(sv["kv_isolation_max_err"] < F32_TOL,
            f"kv_isolation_max_err {sv['kv_isolation_max_err']}")
    require(sv["decode_steps"] > 0 and replica_launches == (
        sv["decode_steps"] if on_card else 0),
        f"{replica_launches} replica launches for {sv['decode_steps']} "
        "decode steps")
    max_abs_err = soak_check(rng, e) if on_card else None
    return {"launches": n, "decode_steps": sv["decode_steps"],
            "max_abs_err": max_abs_err, "wall_s": wall}


#: The scale phase's replica engines: one attention layer of Llama-2-7B at
#: the serve phase's width (32 slots, 32 heads x 128, a 4096-token cache),
#: the JAX harness's queue of 128 and 16-token step budget a GPU; no
#: modeled device sleep (the card decodes).
SCALE_ENGINE = {"max_batch": BATCH, "heads": HEADS, "head_dim": HEAD_DIM,
                "kv_cap": KV_CAP, "tokens_per_chip_step": 16,
                "modeled_chip_tok_s": 1e9, "queue_cap": 128}


#: the claim watcher's lines for a claim its loop adopted from the
#: checkpoint at start and then unprepared: released, or deleted, while no
#: loop ran (the scale harness restarts node 0's loop mid-traffic)
ADOPTED_RELEASED = "released while no loop ran"
ADOPTED_GONE = "prepared before this loop started is gone"


class _LogCount(logging.Handler):
    """Counts the log records whose message holds each of ``needles``."""

    def __init__(self, *needles: str):
        super().__init__(logging.INFO)
        self.needles = needles
        self.counts: collections.Counter = collections.Counter()

    def emit(self, record: logging.LogRecord) -> None:
        msg = record.getMessage()
        for n in self.needles:
            if n in msg:
                self.counts[n] += 1


def phase_scale(card: str, device=None, engine: dict | None = None,
                **harness) -> dict:
    """``run_serving_scale`` at the JAX harness's defaults (2 measured
    rounds of 1.5 s arms at 1 and 4 replicas, the four-phase autoscale leg
    of 0.8 s phases through a GPU-vanish flap and a prepare-loop restart,
    the two-shard controller leg; 2 mock ``h100-8`` nodes, 2 GPUs a claim;
    ``harness`` overrides them), the engines on the card at
    :data:`SCALE_ENGINE`'s width (``engine`` overrides it, ``device`` moves
    it). Its own path: the counts are zeroed before it and read after it.
    Also printed: how many claims node 0's restarted claim watcher adopted
    from its checkpoint and unprepared (released or deleted while no loop
    ran). Hard: no error session and no leak, the accounting identity,
    ``kv_isolation_max_err`` under F32_TOL, the autoscale and shard legs
    ok, TTFB p99 within the JAX harness's 1.5 s, and the replicas'
    decode-kernel launches equal to their decode steps (none on a CPU
    engine). The scaling ratio is printed, not held: the replicas share one
    card with real device time. On the card the engines' decode shape, q
    [32, 32, ql, 128] against a [32, 32, 4096, 128] cache, is the one
    ``phase_check`` holds the kernel to at full width."""
    e = {**SCALE_ENGINE, **(engine or {})}
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    if on_card:
        require((e["max_batch"], e["heads"], e["head_dim"], e["kv_cap"])
                == (BATCH, HEADS, HEAD_DIM, KV_CAP),
                f"scale engines {e} are not at phase_check's shape")
        torch.cuda.reset_peak_memory_stats(0)
    watcher = logging.getLogger(
        "k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher")
    adopted = _LogCount(ADOPTED_RELEASED, ADOPTED_GONE)
    level = watcher.level
    watcher.setLevel(logging.INFO)
    watcher.addHandler(adopted)
    t0 = time.monotonic()
    reset_launches()
    try:
        r = run_serving_scale(device=device, serving_engine=e, **harness)
    finally:
        watcher.removeHandler(adopted)
        watcher.setLevel(level)
    n = launches()["decode_attention"]
    wall = time.monotonic() - t0
    tokens, auto, shard = r["tokens"], r["autoscale"], r["shard"]
    replica_launches = n - tokens["warmup_launches"]
    line("scale", card=json.dumps(card), engine=json.dumps(e),
         rounds=r["rounds"], arm_window_s=r["arm_window_s"],
         replicas_hi=r["replicas_hi"], gpus_per_claim=r["gpus_per_claim"],
         tokens_s_lo=r["tokens_s_lo"], tokens_s_hi=r["tokens_s_hi"],
         scaling_x=r["scaling_x"], per_round=json.dumps(r["per_round"]))
    line("scale", ttfb_count=r["ttfb"]["count"],
         ttfb_p50_ms=r["ttfb"]["p50_s"] * 1e3,
         ttfb_p99_ms=r["ttfb"]["p99_s"] * 1e3,
         ttfb_bound_ms=r["ttfb"]["bound_s"] * 1e3, sessions=r["sessions"],
         ok_sessions=r["ok_sessions"], error_sessions=r["error_sessions"],
         accounting=json.dumps(r["accounting"]),
         kv_isolation_max_err=r["kv_isolation_max_err"])
    line("scale", autoscale_events=json.dumps(auto["events"]),
         autoscale_tenants=json.dumps(auto["tenants"]),
         recovered=json.dumps(auto["recovered"]),
         fault_window_errors=auto["fault_window_errors"],
         shard_leaders=json.dumps(shard["leaders"]),
         leader_pinned=shard["leader_pinned"],
         ledger_violations=len(shard["ledger_violations"]),
         churn_sessions=shard["churn_sessions"], churn_ok=shard["churn_ok"])
    line("scale", adopted_released=adopted.counts[ADOPTED_RELEASED],
         adopted_gone=adopted.counts[ADOPTED_GONE],
         leak_count=r["leak_count"], errors=json.dumps(r["errors"]),
         decode_tokens=tokens["decode"], decode_steps=tokens["decode_steps"],
         warmup_launches=tokens["warmup_launches"], kernel_launches=n,
         peak_memory_gb=(torch.cuda.max_memory_allocated(0) / 1e9
                         if on_card else "not measured (CPU)"),
         wall_s=wall)
    require(r["error_count"] == 0 and r["error_sessions"] == 0,
            f"scale errors: {r['errors']}")
    require(r["leak_count"] == 0, f"scale leaks: {r['leaks']}")
    require(r["accounting"]["ok"], f"accounting: {r['accounting']}")
    require(r["kv_isolation_max_err"] < F32_TOL,
            f"kv_isolation_max_err {r['kv_isolation_max_err']}")
    require(auto["ok"], f"autoscale leg: {auto}")
    require(shard["ok"], f"shard leg: {shard}")
    require(r["ttfb"]["ok"], f"TTFB p99 {r['ttfb']['p99_s']} s over "
                             f"{r['ttfb']['bound_s']} s")
    require(tokens["decode_steps"] > 0 and replica_launches == (
        tokens["decode_steps"] if on_card else 0),
        f"{replica_launches} replica launches for {tokens['decode_steps']} "
        "decode steps")
    return {"launches": n, "decode_steps": tokens["decode_steps"],
            "scaling_x": r["scaling_x"], "wall_s": wall}


#: The mig phase's tenants: two claims for a 3g.40gb partition each of one
#: mock GPU in MIG mode; each engine at the serve phase's width (one
#: attention layer of Llama-2-7B, 32 slots, a 4096-token cache: 4.29 GB of
#: f32 K+V) serving 8 requests, prompts of 512-3072 tokens, 32 new tokens
#: each. ``device`` None binds each engine through its claim's CDI spec,
#: the mock's MIG UUIDs mapped onto the card.
MIG_PROFILE = "3g.40gb"
MIG_WIDTH = {"max_batch": BATCH, "heads": HEADS, "head_dim": HEAD_DIM,
             "kv_cap": KV_CAP, "prompts": (512, 3072), "new_tokens": 32,
             "requests": 8, "device": None}


def _mig_claim(client, name: str, device_class: str, selectors: list,
               config: dict | None = None) -> dict:
    exactly = {"deviceClassName": device_class,
               "allocationMode": "ExactCount", "count": 1,
               "selectors": [{"cel": {"expression": e}} for e in selectors]}
    spec = {"devices": {"requests": [{"name": "gpu", "exactly": exactly}]}}
    if config is not None:
        spec["devices"]["config"] = [{"requests": ["gpu"], "opaque": {
            "driver": DRIVER_NAME, "parameters": config}}]
    return client.create(new_object(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec=spec))


def _release_claims(client, names: list) -> None:
    """Unreserve each claim, wait for the claim watcher to unprepare it,
    delete it."""
    for name in names:
        c = client.get("ResourceClaim", name, "default")
        c["status"].pop("reservedFor", None)
        client.update_status(c)
    for name in names:
        _wait(lambda: not any(
            d.get("driver") == DRIVER_NAME for d in (client.get(
                "ResourceClaim", name, "default").get("status") or {}).get(
                "devices") or []), f"{name} unprepared")
        client.delete("ResourceClaim", name, "default")


class _NoVfioOnTheHost:
    """While entered, a VfioPciManager on the machine's own ``/sys`` raises
    instead of being built: rebinding the card would end the run."""

    def __enter__(self):
        self.orig = VfioPciManager.__init__
        self.roots: list = []
        orig = self.orig

        def guarded(mgr, sysfs_root="/sys", *args, **kwargs):
            require(os.path.realpath(sysfs_root) != "/sys",
                    "a VfioPciManager on the real /sys")
            self.roots.append(str(sysfs_root))
            orig(mgr, sysfs_root, *args, **kwargs)
        VfioPciManager.__init__ = guarded
        return self

    def __exit__(self, *exc):
        VfioPciManager.__init__ = self.orig


def phase_mig(card: str, seed: int, lib, gpu, width: dict | None = None
              ) -> dict:
    """MIG partitions and VFIO passthrough in the GPU kubelet plugin.

    NVML's answer: the card's MIG mode, current and pending, or the NVML
    error (a virtualized card cannot enter MIG mode); required off or a
    named error, and the plugin on that library with DynamicMIG on must
    publish each of its GPUs whole and no MIG device. The partition path,
    on a mock ``h100-8`` node in MIG mode with DynamicMIG on: all 208
    placements published (26 devices a GPU with the whole one), every
    device name a DNS label; two
    tenant claims for 3g.40gb on GPU 0 get its two halves, a 4g.40gb
    claim and a whole-GPU claim there are refused; each claim's CDI spec
    names its own ``MIG-<uuid>`` and ``nvidia-caps`` nodes, and the
    engine bound through it (the mock's MIG UUIDs mapped onto the card)
    holds no more bytes than its profile's memory capacity and decodes
    through the decode kernel under the serve checks, launches equal to
    the two engines' decode steps (its own path: the counts zeroed
    before, read after); the kernel against its plain version at the
    engines' shape outside it. After unprepare no MIG instance, claim,
    checkpoint entry, CDI spec or caps node is left, and the 4g.40gb
    claim then allocates and prepares; then one 1g.10gb+me claim on GPU 1
    is prepared into a media-extensions instance and a second one there
    is refused by the GPU's media counter. VFIO on a materialized mock
    tree only, with FakeVfioKernel: prepare binds, the restore record is
    in the checkpoint, unprepare restores, and the names published beside
    the vfio-bound GPU are DNS labels; no VfioPciManager is ever built on
    the machine's /sys. Prints one ``mig`` line."""
    w = {**MIG_WIDTH, **(width or {})}
    t_phase = time.monotonic()
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    mig_gates = new_feature_gates("DynamicMIG=true")
    out: dict = {"card": card}
    split: dict = {}               # ms per part of the phase
    mark = [time.monotonic()]

    def lap(what: str) -> None:
        now = time.monotonic()
        split[what] = (now - mark[0]) * 1e3
        mark[0] = now

    with _NoVfioOnTheHost() as guard, \
            tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # NVML's answer, and the real backend with DynamicMIG on.
        answers = getattr(lib, "mig_modes", {})
        answer = answers.get(gpu.uuid, f"not read ({lib.backend} backend)")
        out["nvml_mig"] = answer
        require(lib.backend == BACKEND_NVML and not gpu.mig_enabled
                and not answer.startswith("current=enabled"),
                f"the card's MIG mode: {answer} ({lib.backend})")
        require(answer.startswith("current=disabled")
                or re.fullmatch(r".+ \(code \d+\)", answer) is not None,
                f"NVML's MIG answer {answer!r} is neither disabled nor an "
                "NVML error")
        real = GpuDriver(FakeClient(), DriverConfig(
            node_name="node-0", state_dir=f"{tmp}/real-state",
            cdi_root=f"{tmp}/real-cdi", env={}, feature_gates=mig_gates),
            device_lib=lib)
        published = [d.name for pool in
                     real.generate_driver_resources().pools.values()
                     for sl in pool.slices for d in sl.devices]
        require(published == [g.canonical_name for g in real.state.gpus]
                and gpu.canonical_name in published,
                f"the card's library with DynamicMIG published {published}")
        require(real.state._vfio is None, "a VFIO manager on the card")
        out["real_published"] = published
        lap("nvml")

        # The partition path on a mock node in MIG mode.
        mock = MockDeviceLib("h100-8", mig=True)
        dev_root = mock.materialize(f"{tmp}/tree")[0]
        client = FakeClient()
        for cls, expr in partitions.DEVICE_CLASS_SELECTORS.items():
            client.create(new_object("DeviceClass", cls, spec={
                "selectors": [{"cel": {"expression": expr}}]}))
        client.create(new_object("Node", "node-0"))
        driver = GpuDriver(client, DriverConfig(
            node_name="node-0", state_dir=f"{tmp}/state",
            cdi_root=f"{tmp}/cdi", env={}, retry_timeout=5.0,
            feature_gates=mig_gates), device_lib=mock).start()
        loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0",
                               namespace="default").start()
        lap("node")
        try:
            out.update(_mig_tenants(seed, client, driver, mock, dev_root, w,
                                    lap))
        finally:
            loop.stop()
            driver.stop()
        residue = ([c["metadata"]["name"]
                    for c in client.list("ResourceClaim")]
                   + sorted(driver.state.prepared_claims_nolock())
                   + driver.cdi.list_claim_uids()
                   + [m.uuid for m in mock.mig_devices()]
                   + sorted(os.listdir(os.path.join(dev_root,
                                                    "nvidia-caps"))))
        out["residue"] = residue
        out["vfio"] = _mig_vfio_leg(f"{tmp}/vfio")
        out["vfio_managers"] = len(guard.roots)
        lap("vfio")
    out["split_ms"] = split
    out["wall_s"] = time.monotonic() - t_phase
    line("mig", **{k: json.dumps(v) if isinstance(v, (list, dict)) else v
                   for k, v in out.items()})
    require(not residue, f"mig: left behind {residue}")
    return out


def _mig_tenants(seed: int, client, driver, mock, dev_root: str,
                 w: dict, lap) -> dict:
    """The tenants' claims, engines and teardown on the mock node; ``lap``
    times each part."""
    spec = client.list("ResourceSlice")[0]["spec"]
    devices = {d["name"]: d for d in spec["devices"]}
    n_mig = sum(1 for d in devices.values()
                if d["attributes"]["type"] == {"string": "mig"})
    require(len(devices) == 8 * 26 and n_mig == 8 * 25
            and len(spec["sharedCounters"][0]["counters"]) == 8 * 8 + 8,
            f"published {len(devices)} devices, {n_mig} MIG")
    not_labels = [n for n in devices if not is_dns_label(n)]
    require(not not_labels, f"mig: device names not DNS labels: "
                            f"{not_labels[:4]}")
    on0 = ["device.attributes['parentIndex'] == 0"]
    alloc = Allocator(client)
    names, ready_ms, t0s = ("tenant-mig-a", "tenant-mig-b"), [], []
    for name in names:
        t0 = time.monotonic()
        t0s.append(t0)
        alloc.allocate(_mig_claim(
            client, name, partitions.DEVICE_CLASS_MIG,
            [f"device.attributes['profile'] == '{MIG_PROFILE}'", *on0]),
            reserved_for=[{"resource": "pods", "name": f"{name}-pod"}],
            node="node-0")
        _wait(lambda: _claim_ready(client, name), f"{name} Ready")
        ready_ms.append((time.monotonic() - t0) * 1e3)
    claims = [client.get("ResourceClaim", n, "default") for n in names]
    got = sorted(c["status"]["allocation"]["devices"]["results"][0]["device"]
                 for c in claims)
    require(got == [mig_device_name(0, MIG_PROFILE, 0, 4),
                    mig_device_name(0, MIG_PROFILE, 4, 4)],
            f"tenants got {got}")
    refused = []
    for name, cls, sels in (
            ("over-4g", partitions.DEVICE_CLASS_MIG,
             ["device.attributes['profile'] == '4g.40gb'", *on0]),
            ("over-whole", partitions.DEVICE_CLASS_GPU,
             ["device.attributes['index'] == 0"])):
        _mig_claim(client, name, cls, sels)
        try:
            alloc.allocate(client.get("ResourceClaim", name, "default"))
        except AllocationError:
            refused.append(name)
    require(refused == ["over-4g", "over-whole"], f"refused only {refused}")

    specs = [driver.cdi.read_claim_spec(c["metadata"]["uid"])
             for c in claims]
    migs = {m.uuid: m for m in mock.mig_devices()}
    visible = [visible_device_entries(s) for s in specs]
    require(len(migs) == 2 and sorted(v[0] for v in visible) == sorted(migs)
            and all(len(v) == 1 for v in visible),
            f"the specs name {visible}, the node has {sorted(migs)}")
    for s, (uuid,) in zip(specs, visible):
        nodes = [n["path"] for d in s["devices"]
                 for n in d["containerEdits"]["deviceNodes"]]
        caps = migs[uuid].caps_paths
        require(nodes[0] == "/dev/nvidia0" and nodes[-2:] == caps
                and all(os.path.exists(os.path.join(dev_root, p[5:]))
                        for p in caps), f"{uuid}: nodes {nodes}")
    capacity = devices[got[0]]["capacity"]["memory"]["value"]
    lap("claims")

    engines, reqs, engine_bytes = [], [], []
    rng = np.random.default_rng(seed)
    on_card = w["device"] is None or torch.device(w["device"]).type == "cuda"
    for name, s in zip(names, specs):
        before = torch.cuda.memory_allocated(0) if on_card else 0
        eng = bind_engine(
            s, name, device=w["device"], uuids={u: 0 for u in migs},
            metrics=ServingMetrics(), max_batch=w["max_batch"],
            kv_cap=w["kv_cap"], heads=w["heads"], head_dim=w["head_dim"],
            tokens_per_chip_step=2048, queue_cap=64, modeled_chip_tok_s=1e9)
        engine_bytes.append(
            torch.cuda.memory_allocated(0) - before if on_card else
            sum(t.numel() * t.element_size()
                for t in (eng._K, eng._V, eng._lens)))
        require(engine_bytes[-1] <= capacity,
                f"{name}: {engine_bytes[-1]} bytes over the profile's "
                f"{capacity}")
        engines.append(eng)
        reqs.append(tenant_requests(rng, w["requests"], f"{name}-",
                                    w["prompts"], w["new_tokens"]))
    lap("engines")
    reset_launches()
    t1 = time.monotonic()
    for eng, rs in zip(engines, reqs):
        eng.start()
        for r in rs:
            require(eng.submit(r), f"{eng.name}: request {r.rid} rejected")
    deadline = t1 + 600
    while any(e.completed < len(rs) for e, rs in zip(engines, reqs)):
        require(time.monotonic() < deadline
                and all(e._thread.is_alive() for e in engines),
                "mig engines stalled")
        time.sleep(0.005)
    wall = time.monotonic() - t1
    summaries = [e.drain(timeout=60) for e in engines]
    n = launches()["decode_attention"]
    steps = sum(e.decode_steps for e in engines)
    for eng, summary, rs in zip(engines, summaries, reqs):
        check_outputs(eng, summary, rs, eng.name)
    require(steps > 0 and n == (steps if on_card else 0),
            f"mig: {n} kernel launches for {steps} decode steps")
    iso = max(e.kv_isolation_max_err for e in engines)
    lap("serve")
    out = {"devices_published": len(devices), "tenants": got,
           "refused": refused, "mig_uuids": len(migs),
           "profile_memory_bytes": capacity, "engine_bytes": engine_bytes,
           "claim_ready_ms": ready_ms,
           "ttfb_ms": [(e.first_batch_t - t0) * 1e3
                       for e, t0 in zip(engines, t0s)],
           "decode_tok_s": sum(s["decode_tokens"] for s in summaries) / wall,
           "decode_steps": steps, "kernel_launches": n,
           "kv_isolation_max_err": iso,
           "max_abs_err": (soak_check(rng, w, "mig", emit=False)
                           if on_card else None)}
    del engines
    if on_card:
        torch.cuda.empty_cache()
    lap("check")

    _release_claims(client, list(names))
    require(mock.mig_devices() == [] and not os.listdir(
        os.path.join(dev_root, "nvidia-caps")), "MIG instances left")
    client.delete("ResourceClaim", "over-whole", "default")
    c = client.get("ResourceClaim", "over-4g", "default")
    alloc.allocate(c, reserved_for=[{"resource": "pods", "name": "p4g"}],
                   node="node-0")
    _wait(lambda: _claim_ready(client, "over-4g"), "4g.40gb Ready")
    (m,) = mock.mig_devices()
    require((m.profile, m.start) == ("4g.40gb", 0), f"4g.40gb got {m}")
    out["after_4g"] = m.profile
    _release_claims(client, ["over-4g"])
    out["media"] = _mig_media(client, alloc, mock)
    lap("teardown")
    return out


#: The media-extensions profile: one instance a GPU.
MIG_MEDIA_PROFILE = "1g.10gb+me"


def _mig_media(client, alloc, mock) -> dict:
    """One 1g.10gb+me claim on GPU 1 prepared into a media-extensions
    instance; a second one there refused by the GPU's media counter; the
    first released with no instance left."""
    on1 = [f"device.attributes['profile'] == '{MIG_MEDIA_PROFILE}'",
           "device.attributes['parentIndex'] == 1"]
    claim = alloc.allocate(
        _mig_claim(client, "media-a", partitions.DEVICE_CLASS_MIG, on1),
        reserved_for=[{"resource": "pods", "name": "media-pod"}],
        node="node-0")
    _wait(lambda: _claim_ready(client, "media-a"), "1g.10gb+me Ready")
    device = claim["status"]["allocation"]["devices"]["results"][0]["device"]
    (m,) = mock.mig_devices()
    require((m.profile, m.parent_index) == (MIG_MEDIA_PROFILE, 1)
            and device == mig_device_name(1, MIG_MEDIA_PROFILE, m.start, 1),
            f"1g.10gb+me got {device}, instance {m}")
    _mig_claim(client, "media-b", partitions.DEVICE_CLASS_MIG, on1)
    try:
        alloc.allocate(client.get("ResourceClaim", "media-b", "default"))
        refused = False
    except AllocationError:
        refused = True
    require(refused, "a second 1g.10gb+me claim on GPU 1 was allocated")
    client.delete("ResourceClaim", "media-b", "default")
    _release_claims(client, ["media-a"])
    require(mock.mig_devices() == [], "the 1g.10gb+me instance left")
    return {"device": device, "twin_refused": refused}


def is_dns_label(name: str) -> bool:
    """An RFC 1123 label, the form of a DRA device name."""
    return len(name) <= 63 and re.fullmatch(
        r"[a-z0-9]([-a-z0-9]*[a-z0-9])?", name) is not None


def _mig_vfio_leg(root: str) -> dict:
    """VFIO passthrough of one mock GPU on a materialized tree, the
    kernel's rebinding emulated: prepare binds it with its restore record
    in the checkpoint, unprepare restores the nvidia driver."""
    dev, sysfs, proc = MockDeviceLib("h100-8").materialize(root)
    mgr = VfioPciManager(sysfs, dev, kernel=FakeVfioKernel(sysfs, dev))
    client = FakeClient()
    client.create(new_object("DeviceClass", partitions.DEVICE_CLASS_GPU,
                             spec={"selectors": [{"cel": {"expression":
                                 partitions.DEVICE_CLASS_SELECTORS[
                                     partitions.DEVICE_CLASS_GPU]}}]}))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-v", state_dir=f"{root}/state",
        cdi_root=f"{root}/cdi", env={}, retry_timeout=2.0,
        feature_gates=new_feature_gates("PassthroughSupport=true")),
        device_lib=SysfsDeviceLib(dev_root=dev, sysfs_root=sysfs,
                                  proc_root=proc, env={}))
    driver.state._vfio = mgr
    driver.start()
    claim = Allocator(client).allocate(_mig_claim(
        client, "vm", partitions.DEVICE_CLASS_GPU,
        ["device.attributes['index'] == 2"],
        {"apiVersion": API_VERSION, "kind": "VfioDeviceConfig"}))
    uid = claim["metadata"]["uid"]
    res = driver.prepare_resource_claims([claim])[uid]
    require(res.error is None, f"vfio prepare: {res.error}")
    env = claim_spec_env(driver.cdi.read_claim_spec(uid))
    bdf = env["GPU_PASSTHROUGH_PCI_ADDRESSES"]
    # An admin's vfio-pci bind of another GPU: published as a vfio-gpu.
    other = next(g.pci_address for g in driver.state.gpus
                 if g.pci_address != bdf)
    mgr.configure(other)
    shutil.rmtree(os.path.join(proc, "driver", "nvidia", "gpus", other))
    driver.republish()
    names = [d["name"] for s in client.list("ResourceSlice")
             for d in s["spec"]["devices"]]
    require(any(n.startswith("vfio-gpu-") for n in names)
            and all(is_dns_label(n) for n in names),
            f"vfio: published names {names}")
    bound = mgr.current_driver(bdf)
    ledger = dict(driver.state.prepared_claims()[uid].vfio_restore)
    require(bound == "vfio-pci" and ledger == {bdf: "nvidia"}
            and env["CUDA_VISIBLE_DEVICES"] == "void",
            f"vfio: bound {bound}, ledger {ledger}, env {env}")
    errs = driver.unprepare_resource_claims([ClaimRef.from_claim(claim)])
    restored = mgr.current_driver(bdf)
    require(errs[uid] is None and restored == "nvidia"
            and driver.state.prepared_claims() == {},
            f"vfio unprepare: {errs[uid]}, {restored}")
    driver.stop()
    return {"bdf": bdf, "bound": bound, "ledger": ledger,
            "restored": restored, "names": len(names)}


def phase_alloc(card: str, **kwargs) -> dict:
    """``run_allocator_scale()`` at the port's defaults (6 ``h100-8`` nodes
    in MIG mode, 10,000 claims, ``target_util`` 0.8; ``kwargs`` override
    them): both arms' trimmed throughput and allocation latency, both
    whole-GPU admission rates and their ratio, fragmentation, and the
    defrag leg. Holds zero errors, leaks and overcommit in both arms, the
    fragmentation gauge exported, the admission alert fired, every defrag
    probe unblocked within the eviction bound with no stuck victim, and
    ``admission_ratio >= 1.5``. Throughput is printed, not held: the phase
    runs on the host only. Prints one ``alloc`` line."""
    t0 = time.monotonic()
    r = run_allocator_scale(**kwargs)
    seconds = time.monotonic() - t0
    ff, bf, d = r["first_fit"], r["best_fit"], r["defrag"]
    line("alloc", card=json.dumps(card), nodes=r["n_nodes"],
         claims=r["n_claims"], total_slices=r["total_slices"],
         target_util=r["target_util"],
         ff_allocs_per_sec_trimmed=ff["allocs_per_sec_trimmed"],
         bf_allocs_per_sec_trimmed=bf["allocs_per_sec_trimmed"],
         ff_alloc_p50_us=ff["alloc_p50_us"], ff_alloc_p99_us=ff["alloc_p99_us"],
         bf_alloc_p50_us=bf["alloc_p50_us"], bf_alloc_p99_us=bf["alloc_p99_us"],
         throughput_ratio=r["throughput_ratio"],
         ff_admission=ff["large_admission_rate"],
         bf_admission=bf["large_admission_rate"],
         admission_ratio=r["admission_ratio"],
         fragmentation_mean=bf["fragmentation_mean"],
         defrag=json.dumps({"probes": d["probes"],
                            "unblocked": d["unblocked"],
                            "planned": d["planner"]["planned"],
                            "preempted": d["planner"]["preempted"],
                            "skipped": d["planner"]["skipped"],
                            "reallocated": d["reallocated"],
                            "seconds": d["seconds"]}),
         errors=r["error_count"], leaks=json.dumps(r["leaks"]),
         seconds=seconds)
    require(r["error_count"] == 0, f"alloc: errors {r['errors']}")
    require(not r["leaks"], f"alloc: leaks {r['leaks']}")
    for arm in (ff, bf):
        require(arm["overlap_audit"]["overcommitted"] == 0,
                f"alloc {arm['strategy']}: overcommitted counters "
                f"{arm['overlap_audit']['overcommitted_samples']}")
        require(arm["fragmentation_gauge_exported"],
                f"alloc {arm['strategy']}: no fragmentation gauge")
    require(d["alert_fired"], "alloc: the admission alert never fired")
    require(d["unblocked"] == d["probes"] > 0,
            f"alloc: {d['unblocked']} of {d['probes']} probes unblocked")
    require(d["eviction_bound_held"] and not d["stuck_victims"],
            f"alloc: eviction bound {d['eviction_bound_held']}, stuck "
            f"{d['stuck_victims']}")
    require(r["admission_ratio"] >= 1.5,
            f"alloc: admission ratio {r['admission_ratio']} < 1.5")
    return {**r, "seconds": seconds}


#: The wire phase's served claim: the selfheal batch (16 requests, prompts
#: of 512-3072 tokens, 64 new tokens) at the serve phase's width.
WIRE_WIDTH = dict(SELFHEAL_WIDTH)


def phase_wire(card: str, seed: int, lib, gpu, width: dict | None = None,
               cycles: int = 160) -> dict:
    """The wire path. First ``run_wire_path(cycles)`` (its default 160):
    both arms' claim→ready over HTTP, the segments, the wire-path counters
    and the top of the contention before-picture; holds zero errors, leaks
    and overcommit, ``copies_halved`` and ``backpressure_counted``.

    Then the served claim, on its own path: a ``FakeClient()`` at the
    store's defaults behind an in-process ``ApiServer``, the GPU kubelet
    plugin on ``lib`` with its claim watcher, and ``WireContenders`` on
    the same store (3 status writers over 6 claims each, a reallocator,
    the ``fragmentation_report`` reader and a never-read ``max_queue=4``
    watch). A claim for the card by UUID is created over HTTP, allocated
    and prepared, and seen Ready on an ``HttpWatch``; its CDI spec binds an
    engine at ``width`` that serves its batch under the serve checks,
    decode launches equal to decode steps. Then unreserve, unprepare and
    delete over HTTP; no claim, checkpoint entry or CDI spec may be left,
    and the stalled watch must have been cut off and counted. The decode
    kernel is then held against its plain version at the engine's shape
    (on the card). Prints ``wire`` lines."""
    w = {**WIRE_WIDTH, **(width or {})}
    t_phase = time.monotonic()
    r = run_wire_path(cycles=cycles)
    harness_s = time.monotonic() - t_phase
    base, opt = r["baseline"], r["optimized"]
    top = [f"{row['lock']}:{row['waits']}:{row['wait_total_s']}"
           for row in r["contention_before"][:3]]
    line("wire", cycles=r["cycles"],
         base_ready=json.dumps(base["claim_ready_http"]),
         opt_ready=json.dumps(opt["claim_ready_http"]),
         opt_segments_p50_ms=json.dumps(
             {k: v["p50_ms"] for k, v in opt["segments"].items()}),
         base_segments_p50_ms=json.dumps(
             {k: v["p50_ms"] for k, v in base["segments"].items()}),
         p99_over_p50=r["p99_over_p50"],
         base_copies_per_event=base["copies_per_event"],
         opt_copies_per_event=opt["copies_per_event"],
         status_batches=opt["wire_path"]["status_batches"],
         status_batched=opt["wire_path"]["status_batched"],
         mean_batch=(opt["wire_path"]["status_batched"]
                     / max(1, opt["wire_path"]["status_batches"])),
         memo_hits=opt["wire_path"]["wire_cache_hits"],
         disconnects=json.dumps([a["wire_path"]["overflow_disconnects"]
                                 for a in (base, opt)]),
         dropped=json.dumps([a["wire_path"]["dropped_events"]
                             for a in (base, opt)]),
         contention_top=json.dumps(top),
         encoder_fallbacks=json.dumps(r["encoder_fallbacks"]),
         errors=r["error_count"], seconds=harness_s)
    require(r["error_count"] == 0, f"wire: errors {r['errors']}")
    for a in (base, opt):
        require(not a["leaked_claims"] and
                a["overcommit"]["overcommitted"] == 0,
                f"wire: leaked {a['leaked_claims']}, overcommit "
                f"{a['overcommit']}")
    require(r["copies_halved"], "wire: copies per event not halved")
    require(r["backpressure_counted"], "wire: backpressure not counted")

    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        client = FakeClient()
        client.create(new_object(
            "DeviceClass", DRIVER_NAME, spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        client.create(new_object("Node", "node-0"))
        server = ApiServer(client).start()
        driver = GpuDriver(client, DriverConfig(
            node_name="node-0", state_dir=f"{tmp}/state",
            cdi_root=f"{tmp}/cdi", env={}, retry_timeout=5.0),
            device_lib=lib).start()
        loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0",
                               namespace="default").start()
        alloc = Allocator(client)
        contenders = WireContenders(client, alloc, "serve")
        watch = HttpWatch(server.endpoint, "ResourceClaim", "default")
        try:
            served = _wire_claim(seed, client, driver, gpu, alloc,
                                 HttpClient(server.endpoint), watch, w)
        finally:
            watch.stop()
            contender_errors = contenders.stop()
            loop.stop()
            driver.stop()
            server.stop()
        for c in client.list("ResourceClaim"):
            if c["metadata"]["name"].startswith("wp-load-"):
                client.delete("ResourceClaim", c["metadata"]["name"],
                              "default")
        snap = client.wire_path_snapshot()
        residue = plugin_residue(client, driver)
    on_card = w["device"] is None or torch.device(w["device"]).type == "cuda"
    err = (soak_check(np.random.default_rng(seed), w, "wire", emit=False)
           if on_card else None)
    out = {**served, "overflow_disconnects": snap["overflow_disconnects"],
           "stalled_dropped": contenders.stalled.dropped,
           "contender_errors": contender_errors, "residue": residue,
           "max_abs_err": err, "harness": r,
           "seconds": time.monotonic() - t_phase}
    line("wire", claim="wire-claim",
         claim_ready_http_ms=served["claim_ready_http_ms"],
         ttfb_ms=served["ttfb_ms"], status_batches=served["status_batches"],
         status_batched=served["status_batched"],
         decode_steps=served["decode_steps"],
         kernel_launches=served["launches"],
         overflow_disconnects=out["overflow_disconnects"],
         dropped=out["stalled_dropped"],
         contender_errors=json.dumps(contender_errors[:3]),
         kernel_max_abs_err=err, residue=json.dumps(residue),
         seconds=out["seconds"])
    require(not contender_errors, f"wire: contenders {contender_errors}")
    require(out["overflow_disconnects"] >= 1 and out["stalled_dropped"] >= 1,
            "wire: the stalled watch was not cut off and counted")
    require(not residue, f"wire: left behind {residue}")
    return out


def _wire_claim(seed: int, client, driver, gpu, alloc, hc, watch,
                w: dict) -> dict:
    """The wire phase's claim: created over HTTP, allocated, Ready seen on
    the HTTP watch, bound and served, then released over HTTP."""
    name = "wire-claim"
    before = client.wire_path_snapshot()
    t0 = time.monotonic()
    claim = _card_claim(hc, name, gpu)
    uid = claim["metadata"]["uid"]
    alloc.allocate(claim, reserved_for=[
        {"resource": "pods", "name": "wire-pod"}], node="node-0")
    deadline = t0 + 30.0
    while True:
        require(time.monotonic() < deadline, "wire claim Ready on the watch")
        ev = watch.next(timeout=1.0)
        if (ev is not None and ev.object["metadata"].get("name") == name
                and any(d.get("driver") == DRIVER_NAME and any(
                    k.get("type") == "Ready" and k.get("status") == "True"
                    for k in d.get("conditions") or [])
                    for d in (ev.object.get("status") or {}).get("devices")
                    or [])):
            break
    claim_ready_ms = (time.monotonic() - t0) * 1e3
    watch.stop()
    served = _serve_spec(driver.cdi.read_claim_spec(uid), "wire", w, seed,
                         gpu)
    ttfb_ms = (served["first_batch_t"] - t0) * 1e3
    c = hc.get("ResourceClaim", name, "default")
    c["status"].pop("reservedFor", None)
    hc.update_status(c)
    _wait(lambda: not any(
        d.get("driver") == DRIVER_NAME for d in (hc.get(
            "ResourceClaim", name, "default").get("status") or {}).get(
            "devices") or []), "wire claim unprepared")
    hc.delete("ResourceClaim", name, "default")
    after = client.wire_path_snapshot()
    return {"claim_ready_http_ms": claim_ready_ms, "ttfb_ms": ttfb_ms,
            "status_batches": after["status_batches"]
            - before["status_batches"],
            "status_batched": after["status_batched"]
            - before["status_batched"],
            "decode_steps": served["decode_steps"],
            "launches": served["launches"]}


def phase_overhead(card: str, fleetwatch: dict | None = None,
                   blackbox: dict | None = None,
                   canary: dict | None = None) -> dict:
    """The observability overhead legs at their defaults (each dict
    overrides its harness's arguments): ``run_fleetwatch()``,
    ``run_blackbox_overhead()`` and ``run_canary_overhead()`` on mock
    ``h100-8`` nodes. Holds the fleetwatch oracles (page fired within
    ``detect_bound_s`` and cleared within ``clear_bound_s``, no false
    positive, both injected points fired: ``devicestate.prepare`` failing
    prepares and ``telemetry.scrape`` failing scrapes), ``error_count`` 0
    and no leak in every leg, and no probe leaked. The overhead
    percentages are timing on a shared host: printed, not held. Prints
    one ``overhead`` line."""
    t0 = time.monotonic()
    fw = run_fleetwatch(**(fleetwatch or {}))
    bb = run_blackbox_overhead(**(blackbox or {}))
    cn = run_canary_overhead(**(canary or {}))
    seconds = time.monotonic() - t0
    line("overhead", card=json.dumps(card), fired_page=fw["fired_page"],
         detection_delay_s=fw["detection_delay_s"],
         clear_delay_s=fw["clear_delay_s"],
         false_positives=fw["false_positives"],
         prepare_fault_failures=fw["prepare_fault_failures"],
         scrapes=json.dumps(fw["scrapes"]),
         fleetwatch_overhead_pct=fw["overhead"]["overhead_pct"],
         blackbox_overhead_pct=bb["overhead_pct"],
         canary_overhead_pct=cn["overhead_pct"],
         profiler_samples=json.dumps(bb["profiler_samples"]),
         probes=cn["probes"], probe_failures=cn["probe_failures"],
         probe_leaked=cn["probe_leaked"],
         meter_observe_failures=cn["meter_observe_failures"],
         errors=json.dumps([fw["error_count"], bb["error_count"],
                            cn["error_count"]]),
         leaks=json.dumps(fw["leaks"]), seconds=seconds)
    require(fw["fired_page"] and fw["detection_delay_s"] is not None
            and fw["detection_delay_s"] <= fw["detect_bound_s"],
            f"overhead: page fired {fw['fired_page']} after "
            f"{fw['detection_delay_s']} s")
    require(fw["cleared"] and fw["clear_delay_s"] <= fw["clear_bound_s"],
            f"overhead: cleared {fw['cleared']} after {fw['clear_delay_s']}")
    require(fw["false_positives"] == 0,
            f"overhead: false positives {fw['false_positive_samples']}")
    require(fw["prepare_fault_failures"] > 0 and fw["scrapes"]["error"] > 0,
            "overhead: an injected fault point never fired")
    for leg in (fw, bb, cn):
        require(leg["error_count"] == 0, f"overhead: errors {leg['errors']}")
    require(not fw["leaks"], f"overhead: leaks {fw['leaks']}")
    require(cn["probe_leaked"] == 0, "overhead: a canary probe leaked")
    return {"fleetwatch": fw, "blackbox": bb, "canary": cn,
            "seconds": seconds}


#: The crash and race phases' engine: the selfheal width (one attention
#: layer of Llama-2-7B, 32 slots, a 4096-token cache) and its batch of 16.
CHECK_WIDTH = dict(SELFHEAL_WIDTH)


class CardPrepareScenario(crashlab.PrepareScenario):
    """crashlab's prepare scenario with one claim for the card (the machine
    has one GPU), prepared by ``GpuDriver`` on ``lib``: ``setup`` swaps
    ``env["new_driver"]`` for a factory over that library, which keeps
    every driver it builds in ``drivers`` so that the caller can stop the
    ones a crash discarded."""

    name = "card_prepare"
    torn = False

    def __init__(self, lib, gpu):
        self.lib, self.gpu = lib, gpu
        self.drivers: list = []

    def setup(self, env: crashlab.CrashEnv) -> None:
        def new_driver() -> GpuDriver:
            drv = GpuDriver(env["client"], env["cfg"],
                            device_lib=self.lib).start()
            self.drivers.append(drv)
            env["driver"] = drv
            return drv

        env["new_driver"] = new_driver
        new_driver()
        env["claims"] = [crashlab._allocate(
            env, _card_claim(env["client"], "crash-claim", self.gpu))]

    def stop_drivers(self) -> None:
        for drv in self.drivers:
            drv.stop()
        self.drivers.clear()


def phase_crash(card: str, seed: int, lib, gpu,
                width: dict | None = None) -> dict:
    """The crash explorer. Host leg: ``run_crashlab()`` over the full
    corpus on the ``h100-8`` mock, twice; holds
    0 oracle violations, ``coverage_ok``, no uncrashed capable point and
    equal verdict logs. Card leg: one claim for the card prepared by the
    GPU plugin on ``lib`` (:class:`CardPrepareScenario`), crashed at every
    site of its prepare as crashlab enumerates them and recovered, the
    oracle whole at each (replay idempotent, spec present, nothing left
    after unprepare), every discarded driver stopped. Then the last site
    crashed and recovered once more, the claim prepared again on the
    recovered plugin, and an engine at ``width`` bound from its CDI spec
    serves a batch through the decode kernel under the serve checks; the
    kernel against its plain version at the engine's shape (on the card);
    no claim, checkpoint entry, CDI spec or driver thread left. Prints
    ``crash`` lines."""
    w = {**CHECK_WIDTH, **(width or {})}
    on_card = w["device"] is None
    if on_card:
        require(lib.backend in (BACKEND_NVML, BACKEND_PROCFS),
                f"crash on the {lib.backend} library, not the one that "
                "found the card")
    t0 = time.monotonic()
    # Every crashed stack logs its recovery; the verdicts carry what counts.
    prev_disable = logging.root.manager.disable
    logging.disable(logging.CRITICAL)
    try:
        runs = [crashlab.run_crashlab(seed=seed) for _ in range(2)]
    finally:
        logging.disable(prev_disable)
    r = runs[0]
    line("crash", leg="host", scenarios=len(r["scenarios"]),
         sites=json.dumps({n: v["sites"]
                           for n, v in r["per_scenario"].items()}),
         sites_explored=r["sites_explored"], torn=r["torn_explored"],
         violations=len(r["oracle_violations"]),
         uncrashed=json.dumps(r["uncrashed_capable_points"]),
         coverage_ok=r["coverage_ok"],
         deterministic=runs[0]["verdict_log"] == runs[1]["verdict_log"],
         wall_s=json.dumps([x["wall_s"] for x in runs]))
    require(not r["oracle_violations"],
            f"crash: violations {r['oracle_violations'][:3]}")
    require(r["coverage_ok"] and not r["uncrashed_capable_points"],
            f"crash: coverage {r['sites_skipped']} skipped, uncrashed "
            f"{r['uncrashed_capable_points']}")
    require(runs[0]["verdict_log"] == runs[1]["verdict_log"],
            "crash: two runs of one seed gave different verdict logs")

    threads_before = set(threading.enumerate())
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    scenario = CardPrepareScenario(lib, gpu)
    t_card = time.monotonic()
    logging.disable(logging.CRITICAL)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        try:
            sites = crashlab.enumerate_sites(scenario, base_dir=tmp)
            scenario.stop_drivers()
            verdicts = []
            for point, hit in sites:
                verdicts.append(crashlab.explore_site(
                    scenario, point, hit, seed, base_dir=tmp))
                scenario.stop_drivers()
            bad = [v for v in verdicts if not v["crashed"] or v["problems"]]
            sweep_s = time.monotonic() - t_card
            line("crash", leg="card", card=json.dumps(card),
                 sites=len(sites),
                 points=json.dumps(dict(collections.Counter(
                     p for p, _ in sites))),
                 violations=len(bad), sweep_s=sweep_s)
            require(sites, "crash: the card's prepare hit no crash site")
            require(not bad, f"crash: the card's prepare {bad[:2]}")
            served = _crash_and_serve(scenario, sites[-1], seed, gpu, w,
                                      f"{tmp}/last")
        finally:
            scenario.stop_drivers()
            logging.disable(prev_disable)
    deadline = time.monotonic() + 10
    while True:
        left = sorted(t.name for t in threading.enumerate()
                      if t not in threads_before and t.is_alive())
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    err = (soak_check(np.random.default_rng(seed), w, "crash", emit=False)
           if on_card else None)
    out = {**served, "host": r, "card_sites": len(sites),
           "max_abs_err": err, "threads_left": left,
           "seconds": time.monotonic() - t0}
    line("crash", leg="serve", last_site=json.dumps(list(sites[-1])),
         claim_ready_ms=served["claim_ready_ms"], ttfb_ms=served["ttfb_ms"],
         decode_steps=served["decode_steps"],
         kernel_launches=served["launches"], kernel_max_abs_err=err,
         residue=json.dumps(served["residue"]),
         threads_left=json.dumps(left), seconds=out["seconds"])
    require(not served["residue"], f"crash: left behind {served['residue']}")
    require(not left, f"crash: left threads running: {left}")
    return out


def _crash_and_serve(scenario: CardPrepareScenario, site: tuple, seed: int,
                     gpu, w: dict, root: str) -> dict:
    """Crash the card's prepare at ``site``, recover and hold the oracle,
    then prepare the claim once more on the recovered plugin and serve
    from its CDI spec; unprepare, delete, and read what is left."""
    os.makedirs(root)
    env = crashlab._gpu_env(root)
    scenario.setup(env)
    crashed = False
    with faultpoints.injected(plan=faultpoints.FaultPlan(seed=seed).add(
            site[0], f"crash-nth:{site[1]}")):
        try:
            scenario.run(env)
        except faultpoints.FaultCrash:
            crashed = True
    require(crashed, f"crash: site {site} did not crash")
    scenario.recover(env)
    problems: list = []
    scenario.oracle(env, problems)
    require(not problems, f"crash: recovery at {site}: {problems}")
    drv, claim = env["driver"], env["claims"][0]
    uid = claim["metadata"]["uid"]
    t0 = time.monotonic()
    res = drv.prepare_resource_claims([claim])[uid]
    require(res.error is None, f"crash: prepare after recovery {res.error!r}")
    claim_ready_ms = (time.monotonic() - t0) * 1e3
    served = _serve_spec(drv.cdi.read_claim_spec(uid), "crash", w, seed, gpu)
    err = drv.unprepare_resource_claims([crashlab._ref(claim)])[uid]
    require(err is None, f"crash: unprepare {err!r}")
    env["client"].delete("ResourceClaim", claim["metadata"]["name"],
                         "default")
    residue = plugin_residue(env["client"], drv)
    return {"claim_ready_ms": claim_ready_ms,
            "ttfb_ms": (served["first_batch_t"] - t0) * 1e3,
            "decode_steps": served["decode_steps"],
            "launches": served["launches"], "residue": residue}


def phase_race(card: str, seed: int, lib, gpu, width: dict | None = None,
               seeds: tuple = (1, 2, 3), churn_s: float = 0.8) -> dict:
    """The race detector. First ``run_race_smoke(seeds, churn_s)``: every
    planted positive detected on every seed, 0 false positives, a claim
    churn in race mode with 0 races, errors and leaks, the fuzzer
    deterministic. Then the card's claim served in race mode
    (``GPU_DRA_SANITIZE=race``, the detector on before the stack is
    built, all of it inside ``racelab.fuzz(seed)``): a FakeClient, the GPU
    plugin on ``lib`` with its claim watcher, a claim for the card by UUID
    made Ready, an engine at ``width`` bound from its CDI spec serving a
    batch through the decode kernel, then the claim unreserved, unprepared
    and deleted. Holds no race report, no sanitizer violation, launches
    equal to decode steps and no residue; the environment and the
    detector are restored. The kernel against its plain version at the
    engine's shape (on the card). Prints ``race`` lines."""
    w = {**CHECK_WIDTH, **(width or {})}
    on_card = w["device"] is None
    if on_card:
        require(lib.backend in (BACKEND_NVML, BACKEND_PROCFS),
                f"race on the {lib.backend} library, not the one that "
                "found the card")
    t0 = time.monotonic()
    r = run_race_smoke(seeds=seeds, churn_s=churn_s)
    line("race", leg="smoke", seeds=json.dumps(r["seeds"]),
         positives=json.dumps([
             f"{s['corpus']['positives_detected']}/"
             f"{s['corpus']['positives_total']}" for s in r["per_seed"]]),
         false_positives=r["false_positives"],
         churn_races=r["churn_races"], churn_errors=r["churn_errors"],
         churn_leaks=r["churn_leaks"],
         churn_cells=json.dumps([s["churn"]["cells"]
                                 for s in r["per_seed"]]),
         deterministic=r["deterministic"],
         seconds=time.monotonic() - t0)
    require(r["all_positives_detected"] and r["false_positives"] == 0,
            f"race: corpus {[s['corpus'] for s in r['per_seed']]}")
    require(r["churn_races"] == 0 and r["churn_errors"] == 0
            and not r["churn_leaks"],
            f"race: churn races {r['churn_races']}, errors "
            f"{r['churn_errors']}, leaks {r['churn_leaks']}")
    require(r["deterministic"], "race: the fuzzer's log is not seed-pure")

    prev_env = os.environ.get(sanitizer.ENV_SANITIZE)
    was_active = racelab.active()
    os.environ[sanitizer.ENV_SANITIZE] = "race"
    racelab.enable()
    sanitizer.reset()
    racelab.reset()
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    t_card = time.monotonic()
    try:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp, \
                racelab.fuzz(seed=seed) as fz:
            served = _race_claim(seed, lib, gpu, w, tmp)
        reports, violations = racelab.reports(), sanitizer.violations()
        summary = racelab.report_summary()
    finally:
        racelab.reset()
        sanitizer.reset()
        if not was_active:
            racelab.disable()
        if prev_env is None:
            os.environ.pop(sanitizer.ENV_SANITIZE, None)
        else:
            os.environ[sanitizer.ENV_SANITIZE] = prev_env
    err = (soak_check(np.random.default_rng(seed), w, "race", emit=False)
           if on_card else None)
    out = {**served, "smoke": r, "reports": reports, "violations": violations,
           "cells": summary["cells"], "fuzz_decisions": len(fz.log()),
           "max_abs_err": err, "seconds": time.monotonic() - t0}
    line("race", leg="card", card=json.dumps(card),
         claim_ready_ms=served["claim_ready_ms"], ttfb_ms=served["ttfb_ms"],
         decode_steps=served["decode_steps"],
         kernel_launches=served["launches"], kernel_max_abs_err=err,
         races=len(reports), violations=len(violations),
         cells=summary["cells"], cells_dropped=summary["cells_dropped"],
         fuzz_decisions=out["fuzz_decisions"],
         residue=json.dumps(served["residue"]),
         card_s=time.monotonic() - t_card)
    require(not reports, f"race: data races {reports[:2]}")
    require(not violations, f"race: sanitizer violations {violations[:2]}")
    require(summary["cells"] > 0, "race: the detector tracked no cell")
    require(not served["residue"], f"race: left behind {served['residue']}")
    return out


def _race_claim(seed: int, lib, gpu, w: dict, tmp: str) -> dict:
    """The race phase's stack, built in race mode: a claim for the card
    made Ready by the claim watcher, served, released and unprepared."""
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER_NAME, spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object("Node", "node-0"))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-0", state_dir=f"{tmp}/state", cdi_root=f"{tmp}/cdi",
        env={}, retry_timeout=5.0), device_lib=lib).start()
    require(isinstance(driver.state.checkpoints._commit_mu,
                       sanitizer.TrackedLock),
            "race: the plugin's locks were built untracked")
    loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0",
                           namespace="default").start()
    name = "race-claim"
    try:
        t0 = time.monotonic()
        claim = Allocator(client).allocate(
            _card_claim(client, name, gpu),
            reserved_for=[{"resource": "pods", "name": "race-pod"}],
            node="node-0")
        uid = claim["metadata"]["uid"]
        _wait(lambda: _claim_ready(client, name), "race claim Ready")
        claim_ready_ms = (time.monotonic() - t0) * 1e3
        served = _serve_spec(driver.cdi.read_claim_spec(uid), "race", w,
                             seed, gpu)
        c = client.get("ResourceClaim", name, "default")
        c["status"].pop("reservedFor", None)
        client.update_status(c)
        _wait(lambda: not any(
            d.get("driver") == DRIVER_NAME for d in (client.get(
                "ResourceClaim", name, "default").get("status") or {}).get(
                "devices") or []), "race claim unprepared")
        client.delete("ResourceClaim", name, "default")
    finally:
        loop.stop()
        driver.stop()
    residue = plugin_residue(client, driver)
    return {"claim_ready_ms": claim_ready_ms,
            "ttfb_ms": (served["first_batch_t"] - t0) * 1e3,
            "decode_steps": served["decode_steps"],
            "launches": served["launches"], "residue": residue}


def phase_proto(card: str, seed: int = 0) -> dict:
    """The protocol model checker: ``run_proto_smoke(seed)``. Holds every
    planted violation detected (7 of 7), each counterexample 1-minimal and
    replayed identically, the real elector and fence-ack models clean with
    full coverage, and the double run deterministic. Prints one ``proto``
    line with the smoke's models' state counts."""
    r = protolab.run_proto_smoke(seed=seed)
    line("proto", card=json.dumps(card),
         planted=f"{r['planted_detected']}/{r['planted_total']}",
         all_minimal=r["all_minimal"],
         all_replay_identical=r["all_replay_identical"],
         violations=len(r["violations"]), coverage_ok=r["coverage_ok"],
         states=json.dumps(r["states"]), deterministic=r["deterministic"],
         wall_s=r["wall_s"])
    require(r["planted_total"] == len(protolab.PLANTED_VIOLATIONS)
            and r["planted_detected"] == r["planted_total"],
            f"proto: detected {r['planted_detected']} of "
            f"{r['planted_total']}")
    require(r["all_minimal"] and r["all_replay_identical"],
            "proto: a counterexample is not minimal or did not replay")
    require(not r["violations"] and r["coverage_ok"],
            f"proto: real models {r['violations']}, coverage "
            f"{r['coverage_ok']}")
    require(r["deterministic"], "proto: two runs gave different verdicts")
    return r


#: The cluster phase's host leg: the local process cluster's demo as a
#: child, its waits' limit, and the child's own limit (seconds).
CLUSTER_DEMO_TIMEOUT_S, CLUSTER_DEMO_LIMIT_S = 90, 300
#: The card leg's spec, applied unchanged, and its pod's claim.
CLUSTER_SPEC, CLUSTER_CLAIM_REF = "gpu-test2", "shared-gpu"


def phase_cluster(card: str, seed: int, gpu, width: dict | None = None,
                  profile: str = "", host_leg: bool = True) -> dict:
    """The GPU port as a local cluster of real processes
    (``internal/localcluster.py``), in two legs.

    Host leg: ``python -m k8s_dra_driver_tpu_torch.internal.localcluster
    demo`` as a child, every phase on mock ``h100-8`` nodes (the webhook's
    refusal, gpu-test5, gpu-test4, gpu-test7, the controller failover,
    gpu-test6 over a materialized tree, the GPU and ComputeDomain plugins'
    V1-checkpoint up/downgrades); each phase's seconds printed.

    Card leg: a one-node cluster (webhook, API server, GPU plugin process)
    whose plugin reads the machine's GPUs through NVML
    (``GPU_DRA_DEVICE_BACKEND=nvml``: no NVML, no plugin) and must publish
    the card by UUID. ``gpu-test2.yaml`` applied unchanged: its pod's claim
    is prepared by the plugin process (its request record), both
    containers' ``CUDA_VISIBLE_DEVICES`` are the card's UUID, and an engine
    at ``width`` (the serve phase's) bound from the claim's CDI spec serves
    the selfheal batch under the serve checks, decode launches equal to
    decode steps. The pod retired: no claim, checkpoint entry, CDI spec or
    child process left. Then the kernel against its plain version at the
    engine's shape. ``profile`` (tests) names a mock profile file in place
    of the machine's GPUs."""
    from k8s_dra_driver_tpu_torch.internal import localcluster as lc
    w = {**SELFHEAL_WIDTH, **(width or {})}
    on_card = w["device"] is None
    out: dict = {}
    if host_leg:
        t0 = time.monotonic()
        r = subprocess.run(
            [sys.executable, "-m", lc.__name__, "demo", "--timeout",
             str(CLUSTER_DEMO_TIMEOUT_S)], capture_output=True, text=True,
            timeout=CLUSTER_DEMO_LIMIT_S, cwd=ROOT)
        require(r.returncode == 0 and "[demo] ALL PHASES PASS" in r.stdout,
                f"cluster: the demo failed (rc {r.returncode}):\n"
                f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        seconds = json.loads(r.stdout.split("[demo] phase seconds: ", 1)[1]
                             .splitlines()[0])
        require(set(lc.PHASES) <= set(seconds),
                f"cluster: phases {sorted(seconds)}")
        out["host_s"] = time.monotonic() - t0
        out["phase_s"] = seconds
        line("cluster", leg="host", phases_passed=len(lc.PHASES),
             phase_s=json.dumps(seconds), host_s=out["host_s"])

    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    ns = CLUSTER_SPEC
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        cluster = lc.LocalCluster(tmp, num_nodes=1, profile=profile,
                                  controllers=0, cd_plugins=False)
        try:
            t0 = time.monotonic()
            cluster.up()
            up_ms = (time.monotonic() - t0) * 1e3
            uuids = _slice_uuids(cluster.client, DRIVER_NAME,
                                 cluster.node(0))
            require(gpu.uuid in uuids, f"cluster: the plugin process "
                                       f"published {uuids}, not {gpu.uuid}")
            docs = lc.apply_spec(cluster, ns)
            (pod,) = lc.pods(docs)
            t1 = time.monotonic()
            name = cluster.schedule_pod(pod, cluster.node(0))[
                CLUSTER_CLAIM_REF]
            lc.LocalCluster._wait(lambda: cluster.claim_ready(name, ns), 60,
                                  "cluster: the gpu-test2 claim Ready")
            claim_ready_ms = (time.monotonic() - t1) * 1e3
            uid = cluster.claim_uid(name, ns)
            log = cluster.log_text("gpu-plugin-0")
            require(f"prepare request: {uid}=ok" in log,
                    "cluster: the plugin process logged no prepare of the "
                    "claim")
            per_ctr = {}
            for ctr in pod["spec"]["containers"]:
                refs = [c["name"] for c in ctr["resources"]["claims"]]
                require(refs == [CLUSTER_CLAIM_REF],
                        f"cluster: {ctr['name']} names {refs}")
                per_ctr[ctr["name"]] = cluster.container_env(
                    cluster.node(0), [uid]).get("CUDA_VISIBLE_DEVICES")
            require(len(per_ctr) == 2 and set(per_ctr.values())
                    == {gpu.uuid}, f"cluster: containers see {per_ctr}")
            spec = cluster.claim_cdi_spec(cluster.node(0), uid)
            served = _serve_spec(spec, "cluster", w, seed, gpu)
            first_batch_ms = (served["first_batch_t"] - t1) * 1e3

            cluster.unreserve(name, ns)
            lc.LocalCluster._wait(
                lambda: not cluster.claim_ready(name, ns)
                and cluster.claim_cdi_spec(cluster.node(0), uid) is None,
                30, "cluster: the claim unprepared")
            cluster.client.delete("ResourceClaim", name, ns)
            cp = json.loads((cluster.gpu_state_dir(0) / "checkpoint.json")
                            .read_text())
            residue = sorted(
                [f"claim:{c['metadata']['name']}" for c in
                 cluster.client.list("ResourceClaim", ns)]
                + [f"checkpoint:{u}" for u in cp["v2"]["preparedClaims"]]
                + [f"cdi:{f.name}" for f in
                   cluster.gpu_cdi_dir(0).glob("*.json")
                   if uid in f.name])
        finally:
            cluster.down()
        left = [p.args for p in cluster.children()]
    err = (soak_check(np.random.default_rng(seed), w, "cluster", emit=False)
           if on_card else None)
    out.update(served, up_ms=up_ms, claim_ready_ms=claim_ready_ms,
               first_batch_ms=first_batch_ms, residue=residue,
               children=left, max_abs_err=err)
    line("cluster", leg="card", card=json.dumps(card), spec=ns,
         backend=BACKEND_NVML if not profile else "mock",
         cuda_visible_devices=json.dumps(per_ctr), cluster_up_ms=up_ms,
         claim_ready_ms=claim_ready_ms, first_batch_ms=first_batch_ms,
         decode_steps=served["decode_steps"],
         kernel_launches=served["launches"], kernel_max_abs_err=err,
         residue=json.dumps(residue), children=len(left))
    require(not residue, f"cluster: left behind {residue}")
    require(not left, f"cluster: processes left {left}")
    return out


#: The gates phase's card leg: the plugin process's gates, the three that
#: gate what it publishes and prepares with their dependency met.
GATES_CARD = ("DeviceMetadata=true,PassthroughSupport=true,"
              "CrashOnNVLinkFabricErrors=true")
#: How long a plugin process refused at assembly may take to exit (s).
GATES_EXIT_S = 30.0


def _plugin_args(cluster, node: str, *extra: str) -> list:
    """A kubelet plugin process's flags on ``node`` of ``cluster``, its
    state and CDI dirs its own."""
    root = cluster.workdir / node
    return ["--node-name", node, "--state-dir", str(root / "state"),
            "--cdi-root", str(root / "cdi"),
            "--api-endpoint", cluster.endpoint, "--metrics-port", "-1",
            "--healthcheck-addr", "", "--profile-interval", "0", *extra]


def _refused_start(cluster, name: str, module: str, node: str, *extra: str,
                   want: tuple) -> float:
    """Start a plugin process that must refuse to serve: it exits non-zero
    within ``GATES_EXIT_S`` with every string of ``want`` in its log, and
    no ResourceSlice names ``node``. Ms from spawn to exit."""
    t0 = time.monotonic()
    proc = cluster._spawn(name, module, *_plugin_args(cluster, node, *extra))
    try:
        rc = proc.wait(timeout=GATES_EXIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        raise SystemExit(f"chip_smoke: FAILED: gates: {name} still serving "
                         f"after {GATES_EXIT_S} s")
    ms = (time.monotonic() - t0) * 1e3
    log = cluster.log_text(name)
    require(rc != 0 and all(w in log for w in want),
            f"gates: {name} exited {rc}, log {log[-600:]}")
    sliced = [s["metadata"]["name"] for s in cluster.client.list(
        "ResourceSlice") if s["spec"].get("nodeName") == node]
    require(not sliced, f"gates: {name} published {sliced}")
    return ms


def _gates_host_leg(tmp: str) -> dict:
    """The gates on mock nodes behind one API server: the dependency
    refused by both plugin binaries, the strict fabric gate refusing a node
    whose GPUs disagree and the lenient plugin publishing it, and a VFIO
    claim's metadata on its status with DeviceMetadata on and none with
    it off."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import PROFILES
    from k8s_dra_driver_tpu_torch.internal import localcluster as lc
    out: dict = {}
    cluster = lc.LocalCluster(
        tmp, num_nodes=1, profile="h100-8", vfio=True, controllers=0,
        cd_plugins=False, feature_gates="PassthroughSupport=true,"
                                        "DeviceMetadata=true")
    try:
        cluster.up()
        bad = ("invalid --feature-gates", "DeviceMetadata",
               "PassthroughSupport")
        out["bad_gpu_exit_ms"] = _refused_start(
            cluster, "gpu-bad-gates", GPU_PLUGIN_MODULE, "node-bad",
            "--mock-profile", "h100-8", "--feature-gates",
            "DeviceMetadata=true", want=bad)
        out["bad_cd_exit_ms"] = _refused_start(
            cluster, "cd-bad-gates", CD_PLUGIN_MODULE, "node-bad",
            "--mock-profile", "h100-8", "--feature-gates",
            "DeviceMetadata=true", want=bad)
        # A node whose GPU 1 reports GPU 0's minor.
        broken = PROFILES["h100-8"](0)
        broken["gpus"][1]["minor"] = broken["gpus"][0]["minor"]
        path = cluster.workdir / "broken-fabric.json"
        path.write_text(json.dumps(broken))
        out["strict_exit_ms"] = _refused_start(
            cluster, "gpu-strict", GPU_PLUGIN_MODULE, "node-strict",
            "--mock-profile", str(path), "--feature-gates",
            "CrashOnNVLinkFabricErrors=true",
            want=("GPU fabric inconsistency (strict mode)",))
        cluster.client.create({"apiVersion": "v1", "kind": "Node",
                               "metadata": {"name": "node-lenient"}})
        lenient = cluster._spawn("gpu-lenient", GPU_PLUGIN_MODULE,
                                 *_plugin_args(cluster, "node-lenient",
                                               "--mock-profile", str(path)))
        _wait(lambda: lenient.poll() is None and any(
            s["spec"].get("nodeName") == "node-lenient"
            for s in cluster.client.list("ResourceSlice")),
            "gates: the lenient plugin's slice", 60)
        require("lenient fabric mode" in cluster.log_text("gpu-lenient"),
                "gates: the lenient plugin logged no fabric problem")
        cluster._kill(lenient)
        out["lenient_published"] = True
        (pod,) = lc.pods(lc.apply_spec(cluster, "gpu-test6"))
        out["vfio_metadata"] = _gates_vfio(cluster, pod, cluster.feature_gates)
        cluster.kill_gpu_plugin(0)
        cluster.feature_gates = "PassthroughSupport=true"
        cluster.spawn_gpu_plugin(0)
        out["vfio_without"] = _gates_vfio(cluster, pod, cluster.feature_gates)
        require(out["vfio_without"] is None,
                "gates: metadata with DeviceMetadata off")
    finally:
        cluster.down()
    out["children"] = [p.args for p in cluster.children()]
    require(not out["children"], f"gates: processes left {out['children']}")
    return out


def _gates_vfio(cluster, pod: dict, gates: str):
    """gpu-test6's ``pod``: its VFIO claim prepared by node 0's plugin
    process under ``gates``, read back over HTTP: its status entry's
    metadata (required to be the tree's PCI address and IOMMU group where
    there is one), then the pod retired, the claim deleted and the GPU
    back on its driver."""
    from k8s_dra_driver_tpu_torch.internal import localcluster as lc
    ns = pod["metadata"]["namespace"]
    name = cluster.schedule_pod(pod, cluster.node(0))["gpu"]
    _wait(lambda: cluster.claim_ready(name, ns), f"gates: {ns} Ready ({gates})",
          60)
    uid = cluster.claim_uid(name, ns)
    (dev,) = cluster.client.get("ResourceClaim", name, ns)["status"]["devices"]
    bdf = cluster.container_env(cluster.node(0), [uid])[
        "GPU_PASSTHROUGH_PCI_ADDRESSES"]
    md = dev.get("metadata")
    if md is not None:
        group = os.path.basename(os.path.realpath(
            cluster.tree(0) / "sys" / "bus" / "pci" / "devices" / bdf
            / "iommu_group"))
        attrs = md.get("attributes") or {}
        require(attrs.get("pciAddress") == bdf
                and attrs.get("iommuGroup") == group,
                f"gates: metadata {md}, the tree's {bdf} in group {group}")
    cluster.retire_claim(name, ns, 30)
    cluster.client.delete("ResourceClaim", name, ns)
    _wait(lambda: cluster.tree_pci_driver(0, bdf) == lc.HOST_GPU_DRIVER,
          f"gates: {bdf} back on its driver")
    return md


def phase_gates(card: str, seed: int, gpu, width: dict | None = None,
                profile: str = "", host_leg: bool = True) -> dict:
    """The feature gates a plugin process is started with, in two legs.

    Host leg (mock nodes behind one API server and webhook): the GPU and
    the ComputeDomain plugin binaries with ``DeviceMetadata=true`` alone
    exit non-zero within seconds with an ``invalid --feature-gates``
    message naming PassthroughSupport and publish no slice; a GPU plugin on
    a mock node whose GPUs disagree (two share a minor) exits under
    ``CrashOnNVLinkFabricErrors=true`` and publishes the node without it;
    gpu-test6's VFIO claim on a materialized tree with the kernel's
    rebinding emulated carries, under ``PassthroughSupport=true,
    DeviceMetadata=true``, the tree's PCI address and IOMMU group as
    ``metadata.attributes`` on its status read over HTTP, and no metadata
    once the plugin restarts without DeviceMetadata.

    Card leg: a one-node cluster whose GPU plugin process reads the
    machine's GPUs through NVML (``GPU_DRA_DEVICE_BACKEND=nvml``) under
    ``GATES_CARD``: the strict fabric check passes on the card, which is
    published by UUID; a whole-GPU claim for it created over HTTP is Ready
    with no metadata (it is not VFIO), and an engine at ``width`` (the
    serve phase's) bound from its CDI spec serves the selfheal batch under
    the serve checks, decode launches equal to decode steps; then no
    claim, checkpoint entry, CDI spec or child process is left, and the
    kernel is held against its plain version at the engine's shape.
    ``profile`` (tests) names a mock profile file in place of the
    machine's GPUs. Prints one ``gates`` line a leg."""
    from k8s_dra_driver_tpu_torch.internal import localcluster as lc
    w = {**SELFHEAL_WIDTH, **(width or {})}
    on_card = w["device"] is None
    build_dir = _build.BUILD_DIR
    build_dir.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        if host_leg:
            t0 = time.monotonic()
            host = _gates_host_leg(f"{tmp}/host")
            host["host_s"] = time.monotonic() - t0
            out["host"] = host
            line("gates", leg="host", **{
                k: json.dumps(v) if isinstance(v, (list, dict)) else v
                for k, v in host.items()})
        cluster = lc.LocalCluster(f"{tmp}/card", num_nodes=1,
                                  profile=profile, controllers=0,
                                  cd_plugins=False, feature_gates=GATES_CARD)
        try:
            cluster.up()
            uuids = _slice_uuids(cluster.client, DRIVER_NAME,
                                 cluster.node(0))
            require(gpu.uuid in uuids, f"gates: the strict plugin process "
                                       f"published {uuids}, not {gpu.uuid}")
            name = "gates-claim"
            t0 = time.monotonic()
            claim = Allocator(cluster.client).allocate(
                _card_claim(cluster.client, name, gpu),
                reserved_for=[{"resource": "pods", "name": "gates-pod"}],
                node=cluster.node(0))
            uid = claim["metadata"]["uid"]
            _wait(lambda: _claim_ready(cluster.client, name),
                  "gates: the claim Ready", 60)
            claim_ready_ms = (time.monotonic() - t0) * 1e3
            (dev,) = cluster.client.get("ResourceClaim", name,
                                        "default")["status"]["devices"]
            require("metadata" not in dev,
                    f"gates: a whole GPU's status carries {dev}")
            spec = cluster.claim_cdi_spec(cluster.node(0), uid)
            served = _serve_spec(spec, "gates", w, seed, gpu)
            ttfb_ms = (served["first_batch_t"] - t0) * 1e3
            cluster.unreserve(name, "default")
            # The entry goes after the node-side unprepare; Ready goes
            # before it.
            _wait(lambda: not cluster.claim_ready(name, "default")
                  and cluster.claim_cdi_spec(cluster.node(0), uid) is None,
                  "gates: the claim unprepared")
            cluster.client.delete("ResourceClaim", name, "default")
            cp = json.loads((cluster.gpu_state_dir(0) / "checkpoint.json")
                            .read_text())
            residue = sorted(
                [f"claim:{c['metadata']['name']}" for c in
                 cluster.client.list("ResourceClaim")]
                + [f"checkpoint:{u}" for u in cp["v2"]["preparedClaims"]]
                + [f"cdi:{f.name}" for f in
                   cluster.gpu_cdi_dir(0).glob("*.json")])
        finally:
            cluster.down()
        left = [p.args for p in cluster.children()]
    err = (soak_check(np.random.default_rng(seed), w, "gates", emit=False)
           if on_card else None)
    out.update(served, claim_ready_ms=claim_ready_ms, ttfb_ms=ttfb_ms,
               residue=residue, children=left, max_abs_err=err)
    line("gates", leg="card", card=json.dumps(card), gates=GATES_CARD,
         backend=BACKEND_NVML if not profile else "mock",
         claim_ready_ms=claim_ready_ms, ttfb_ms=ttfb_ms,
         decode_steps=served["decode_steps"],
         kernel_launches=served["launches"], kernel_max_abs_err=err,
         residue=json.dumps(residue), children=len(left))
    require(not residue, f"gates: left behind {residue}")
    require(not left, f"gates: processes left {left}")
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
    and a teardown that unprepares and deletes the claim, drains a second
    claim of the CD and drains and binds again a third (``_cd_drain_leg``),
    deletes the CD, stops the daemon's loop and the controller's threads,
    and requires that nothing is left."""
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
        _cd_drain_leg(client, driver, template)
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


def _cd_ready_conditions(client, name: str) -> list:
    """The Ready conditions of the CD driver's status entries of claim
    ``name``."""
    claim = client.try_get("ResourceClaim", name, "default") or {}
    return [c for d in (claim.get("status") or {}).get("devices") or []
            if d.get("driver") == CD_DRIVER_NAME
            for c in d.get("conditions") or [] if c.get("type") == "Ready"]


def _cd_drain_leg(client, driver, template: dict) -> None:
    """A second channel claim of the CD, reserved for a pod and prepared by
    a claim watcher on the CD driver, is drained as the node cordon's
    companion drain drains it. The status must read ``Ready: False``,
    reason ``Drained``, when the tombstone commits, and the node label must
    be gone; then the claim is deleted and its tombstone expired through the
    GC's own path, ``_cd_rejoin_leg`` runs on the same watcher, and the
    watcher is stopped."""
    name = "smoke-channel-drain"
    loop = NodePrepareLoop(client, driver, CD_DRIVER_NAME, driver.pool_name,
                           namespace="default", retry_delay=0.1).start()
    try:
        t0 = time.monotonic()
        claim = Allocator(client).allocate(client.create(new_object(
            "ResourceClaim", name, "default",
            api_version="resource.k8s.io/v1",
            spec=template["spec"]["spec"])),
            reserved_for=[{"resource": "pods", "name": "smoke-cd-pod"}],
            node="node-0")
        _wait(lambda: {"type": "Ready", "status": "True"}
              in _cd_ready_conditions(client, name), f"{name} Ready")
        ready_ms = (time.monotonic() - t0) * 1e3
        at_tombstone: list = []
        transact = driver.state.checkpoints.transact

        def watched(mutate):
            at_tombstone.append(_cd_ready_conditions(client, name))
            return transact(mutate)

        driver.state.checkpoints.transact = watched
        t1 = time.monotonic()
        try:
            drained = driver.drain_claim(ClaimRef(
                uid=claim["metadata"]["uid"], name=name,
                namespace="default"), reason="node node-0 cordoned")
        finally:
            del driver.state.checkpoints.transact
        drain_ms = (time.monotonic() - t1) * 1e3
        cond = at_tombstone[0][0] if at_tombstone and at_tombstone[0] else {}
        label = client.get("Node", "node-0")["metadata"].get(
            "labels", {}).get(NODE_LABEL_CD)
        line("computedomain", leg="drain", claim=name, ready_ms=ready_ms,
             drain_ms=drain_ms, ready_at_tombstone=cond.get("status"),
             reason_at_tombstone=cond.get("reason"), node_label=label)
        require(drained, f"{name}: nothing drained")
        require(len(at_tombstone) == 1 and at_tombstone[0] == [
            {"type": "Ready", "status": "False", "reason": "Drained"}],
            f"{name}: the status read {at_tombstone} when the tombstone "
            "committed")
        require(label is None, f"{name}: the node is still labelled")
        client.delete("ResourceClaim", name, "default")
        require(driver.state.delete_expired_aborted(
            now=time.time() + PREPARE_ABORTED_TTL + 1.0)
            == [claim["metadata"]["uid"]], f"{name}: its tombstone did not "
            "expire")
        _cd_rejoin_leg(client, driver, template)
    finally:
        loop.stop()


#: how soon a channel claim bound again to the device it was drained off
#: must be Ready again (its drain tombstone's TTL is PREPARE_ABORTED_TTL).
CD_REREADY_S = 5.0


def _cd_rejoin_leg(client, driver, template: dict) -> None:
    """Part of ``_cd_drain_leg``, on its claim watcher: a third channel
    claim of the CD, Ready, is drained as the node cordon's drain drains it
    and annotated for reallocation as that drain annotates it. The
    reallocator binds it again to the same device of node-0, and the claim
    watcher drops the drain's tombstone and prepares it again: Ready must
    be back within ``CD_REREADY_S``, not after the tombstone's TTL, on a
    completed prepare of that device, with the node's CD label back. Then
    the claim is deleted and nothing of it may be left."""
    name = "smoke-channel-rejoin"
    ready = {"type": "Ready", "status": "True"}
    claim = Allocator(client).allocate(client.create(new_object(
        "ResourceClaim", name, "default",
        api_version="resource.k8s.io/v1",
        spec=template["spec"]["spec"])),
        reserved_for=[{"resource": "pods", "name": "smoke-cd-rejoin-pod"}],
        node="node-0")
    uid = claim["metadata"]["uid"]

    def devices(obj) -> list:
        return [r.get("device") for r in
                obj["status"]["allocation"]["devices"]["results"]]

    device = devices(claim)
    _wait(lambda: ready in _cd_ready_conditions(client, name),
          f"{name} Ready")
    require(driver.drain_claim(ClaimRef(uid=uid, name=name,
                                        namespace="default"),
                               reason="node node-0 cordoned"),
            f"{name}: nothing drained")
    note = json.dumps({"node": "node-0", "device": "node:node-0",
                       "reason": "node cordoned", "at": time.time()})

    def annotate(obj: dict) -> bool:
        obj["metadata"].setdefault("annotations", {})[ANN_DRAIN] = note
        return True

    require(mutate_claim_with_retry(client, name, "default", annotate,
                                    uid=uid), f"{name}: not annotated")
    realloc = ClaimReallocator(client, retry_delay=0.05,
                               metrics=RemediationMetrics())
    t0 = time.monotonic()
    realloc.start()
    try:
        deadline = t0 + 6 * CD_REREADY_S
        while (ready not in _cd_ready_conditions(client, name)
               and time.monotonic() < deadline):
            time.sleep(0.001)
        reready_ms = (time.monotonic() - t0) * 1e3
    finally:
        realloc.stop()
    pc = driver.state.prepared_claims_nolock().get(uid)
    state = pc.state if pc is not None else None
    label = client.get("Node", "node-0")["metadata"].get(
        "labels", {}).get(NODE_LABEL_CD)
    rebound = devices(client.get("ResourceClaim", name, "default"))
    client.delete("ResourceClaim", name, "default")
    _wait(lambda: uid not in driver.state.prepared_claims_nolock()
          and uid not in driver.cdi.list_claim_uids(),
          f"{name}: its unprepare after the delete")
    residue = [k for k in client.get("Node", "node-0")["metadata"].get(
        "labels") or {} if k == NODE_LABEL_CD]
    line("computedomain", leg="rejoin", claim=name, device=rebound[0],
         reready_ms=reready_ms, state=state, node_label=label,
         residue=json.dumps(residue))
    require(rebound == device, f"{name}: bound again to {rebound}, not "
            f"{device}")
    require(reready_ms < CD_REREADY_S * 1e3, f"{name}: Ready again after "
            f"{reready_ms:.0f} ms, not within {CD_REREADY_S} s")
    require(state == STATE_PREPARE_COMPLETED,
            f"{name}: its record is {state}")
    require(label == client.get("ComputeDomain", "smoke-cd", "default")[
        "metadata"]["uid"], f"{name}: the node's CD label is {label}")
    require(not residue, f"{name}: left behind {residue}")


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
    wide = phase_wide(args.seed)
    f32 = phase_f32(args.seed)
    mixed = phase_mixed(args.seed)
    anyd = phase_any(args.seed)
    perwarp = phase_perwarp(args.seed)
    phase_burnin()
    phase_selfheal(card, args.seed, found["lib"], found["gpu"])
    processes = phase_processes(card, args.seed, found["gpu"])
    soak = phase_soak(card, rng)
    scale = phase_scale(card)
    mig = phase_mig(card, args.seed, found["lib"], found["gpu"])
    phase_alloc(card)
    wire = phase_wire(card, args.seed, found["lib"], found["gpu"])
    phase_overhead(card)
    crash = phase_crash(card, args.seed, found["lib"], found["gpu"])
    race = phase_race(card, args.seed, found["lib"], found["gpu"])
    phase_proto(card, args.seed)
    cluster = phase_cluster(card, args.seed, found["gpu"])
    gates = phase_gates(card, args.seed, found["gpu"])
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
        "launches": (served["launches"] + processes["launches"]
                     + soak["launches"] + scale["launches"]
                     + mig["kernel_launches"] + wire["launches"]
                     + crash["launches"] + race["launches"]
                     + cluster["launches"] + gates["launches"]),
        "max_abs_err": max(max_abs_err, served["hd256_max_abs_err"],
                           soak["max_abs_err"],
                           mig["max_abs_err"], wire["max_abs_err"],
                           crash["max_abs_err"], race["max_abs_err"],
                           cluster["max_abs_err"], gates["max_abs_err"]),
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }] + [{
        # The ring kernel's two-chunk form (f32 rows of 129-256): launched
        # by the serve phase's head-dim-256 engine; timed at perwarp_rows'
        # R1, that engine's shape at 4096 keys.
        "name": "decode_attention_f32_hd256", "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/csrc/decode_attention.cu",
        "replaces": "k8s_dra_driver_tpu/compute/flashattention.py:125",
        "launches": served["hd256_launches"],
        **{key: perwarp["r1_f32_hd256"][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    }] + [{
        # The tuned decode at 16 bits: the wide leg's serve-shape rows.
        "name": f"decode_attention_{name}", "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/csrc/decode_attention.cu",
        "replaces": "k8s_dra_driver_tpu/compute/flashattention.py:125",
        **{key: wide[f"decode_{name}_serve"][key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
    } for name in ("f16", "bf16")] + [{
        "name": "flash_attention", "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/csrc/flash_attention.cu",
        "replaces": "k8s_dra_driver_tpu/compute/flashattention.py:36",
        "launches": flash["launches"] + wide["flash_attention"],
        "max_abs_err": flash_err,
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
    }] + [{
        "name": name, "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/csrc/wide_attention.cuh",
        "replaces": f"k8s_dra_driver_tpu/compute/flashattention.py:{line_no}",
        "launches": wide[name],
        **{key: wide[row][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, line_no, row in (
        ("decode_attention_wide", 125, "mla_decode"),
        ("flash_attention_wide", 36, "flash_576_512"))] + [{
        # f32: the decode kernel of the TF32 body, flash on the any-dtype
        # kernel.
        "name": name, "route": "cuda",
        "source": f"k8s_dra_driver_tpu_torch/csrc/{source}",
        "replaces": f"k8s_dra_driver_tpu/compute/flashattention.py:{line_no}",
        "launches": f32[name],
        **{key: f32[row][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, source, line_no, row in (
        ("decode_attention_f32tc", "f32tc_attention.cuh", 125,
         "mla_decode_f32"),
        ("flash_attention_f32", "cluster_flash.cuh", 36,
         "flash_f32_headline"))] + [{
        # Mixed dtypes (no library call takes them: library_ms null).
        "name": name, "route": "cuda",
        "source": f"k8s_dra_driver_tpu_torch/csrc/{source}",
        "replaces": f"k8s_dra_driver_tpu/compute/flashattention.py:{line_no}",
        "launches": mixed[name],
        **{key: mixed[row][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, source, line_no, row in (
        ("decode_attention_mixed_ring", "decode_attention.cu", 125,
         "decode_serve_f32q_bf16kv"),
        ("decode_attention_mixed", "mixed_decode.cu", 125,
         "mla_decode_f32q_bf16kv"),
        ("flash_attention_mixed", "cluster_flash.cuh", 36,
         "flash_f32q_bf16kv_headline"))] + [{
        # The any-dtype kernels: their bf16 rows at 1,024/1,024, where one
        # library call computes the function.
        "name": name, "route": "cuda",
        "source": f"k8s_dra_driver_tpu_torch/csrc/{source}",
        "replaces": f"k8s_dra_driver_tpu/compute/flashattention.py:{line_no}",
        "launches": anyd[name],
        **{key: anyd[row][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, source, line_no, row in (
        ("decode_attention_stream", "stream_decode.cu", 125,
         "decode_1024_1024_bf16"),
        ("flash_attention_cluster", "cluster_flash.cuh", 36,
         "flash_1024_1024_bf16"))]
    require(all(math.isfinite(v) for k in kernels for v in
                (k["ms"], k["plain_ms"], k["bound_ms"], k["library_ms"])
                if v is not None), "non-finite time")
    require(all(k["launches"] > 0 for k in kernels),
            "a kernel launched no time on its main path: "
            + ", ".join(k["name"] for k in kernels if k["launches"] <= 0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
