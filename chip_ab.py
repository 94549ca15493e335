#!/usr/bin/env python3
"""Compare versions of the flash-attention kernel on one card, run the
kernel's mutation controls, and compare the serve phase of two trees.

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_ab.py versions OTHER.cu [OTHER.cu ...]
    python3 chip_ab.py controls [NAME ...]
    python3 chip_ab.py serve OTHER_TREE [--rounds N]
    python3 chip_ab.py serve-scale OTHER_TREE [--rounds N]
    python3 chip_ab.py decode OTHER_TREE [--rounds N]
    python3 chip_ab.py wire [--writers 3,6,12,16] [--cycles N]
    python3 chip_ab.py flash32 OTHER_TREE [--rounds N]
    python3 chip_ab.py f32 OTHER_TREE [--rounds N]
    python3 chip_ab.py mixed OTHER_TREE [--rounds N]
    python3 chip_ab.py host OTHER_TREE [--rounds N]
    python3 chip_ab.py decode-keys [OTHER_TREE] [--rounds N]
    python3 chip_ab.py wide-parts
    python3 chip_ab.py ring-variants
    python3 chip_ab.py general [OTHER_TREE] [--rounds N]
    python3 chip_ab.py f32-splits
    python3 chip_ab.py cluster-parts
    python3 chip_ab.py stream-splits
    python3 chip_ab.py stream-parts
    python3 chip_ab.py tc-flash OTHER_TREE [--rounds N]
    python3 chip_ab.py perwarp [OTHER_TREE] [--rounds N]

``versions`` copies the port (``chip_smoke.py`` and
``k8s_dra_driver_tpu_torch/``) once per source under ``--work``, puts the
given ``csrc/flash_attention.cu`` in each copy (the tree's own source is the
last version), and runs ``chip_smoke``'s bench phase in each copy, in turn,
in its own process: the versions in order, then in reverse (A, B, B, A for
one other source), so that every version is timed by the same Python code
and the same timing method. It prints each turn's bench rows, then one
JSON line of every turn with the card's name and power limit.

``controls`` makes broken copies of the tree's kernels and runs
``chip_smoke``'s checks in each; every copy must fail them. Two break the
tuned flash kernel, each run through the flash check: its softmax scale
times 1.01, and the last key tile of the non-causal walk dropped. Two
break the wide kernels' shared body (``wide_attention.cuh``), each run
through the wide decode checks (the head dims the wide kernel takes in
the decode check, and the absorbed-MLA layout) and the wide flash check,
both of which must reject it: the softmax scale times 1.01, and the last
key tile (flash) and the last split of the cache (decode) dropped. Two
break the tuned decode's ring kernel (``decode_attention.cu``), each run
through its check (``tuned_decode_check``): the softmax scale times 1.01,
and the last tile of every split dropped. Three break the f32 and mixed
decode body (``f32tc_attention.cuh``), each run through the f32 decode
checks (the f32 head dims of the decode check's general dims, and the
absorbed-MLA layout): one TF32 product where there were three (hi.lo and
lo.hi dropped, in S and in P V: the checks must see plain TF32's error),
the softmax scale times 1.01, and the last key tile of each split and the
last split of the cache dropped. Three break the same body where it takes
q's dtype apart from the cache's (the mixed decode): the last key tile and
split dropped; an f32 query's lo product not issued, and p not rounded to
V's dtype, both under the narrowest input's limit: all three through the
mixed decode check, whose nearest-semantics checks must reject the last
two. The any-dtype flash body (``cluster_flash.cuh``), which takes the f32
and mixed flash calls, has the same four: one TF32 product where there
were three and the last key tile dropped, through the f32 flash check; an
f32 query's lo product not issued and p not rounded to V's dtype, through
the mixed flash check's nearest-semantics checks. The ring controls run
through the mixed decode check too (it takes a q of another dtype). Names
given after ``controls`` run those controls alone. It exits non-zero if a
control passes a check it must fail.

``serve`` runs ``chip_smoke``'s serve phase (48 requests from 4 tenants at
one Llama-2-7B attention layer) in OTHER_TREE (a directory holding another
checkout's ``chip_smoke.py`` and ``k8s_dra_driver_tpu_torch/``, e.g. from
``git archive``) and in this tree, each turn in its own process, in the
order other, this, this, other, ``--rounds`` times; both trees' serve
phases start from a ResourceClaim on the GPU that ``phase_enumerate``
finds. It prints each turn's serve line, then one JSON line
of every turn's decode tokens/s and step p50/p99 with the card's name and
power limit. ``serve-scale`` runs the serve phase and then the scale phase
(``run_serving_scale`` at the smoke's width) in each turn, and adds the
scale phase's tokens/s at one and four replicas and its TTFB to the JSON.

``decode`` does the same with ``chip_smoke``'s build and timing phases:
each turn builds its tree's kernels (printing each decode kernel's
registers) and times its decode kernel at the smoke's width, beside the
plain version and the library call (f32, the engine's), then at the same
shape in f16 and bf16 (kernel and library); the JSON line holds every
turn's times and decode kernels' registers.

``wire`` runs ``run_wire_path`` (the host's HTTP claim path, baseline arm
against the optimized one) once per ``--writers`` count of status
writers, each in its own process, and prints per arm the claim→ready p50
and p99, the status writes committed and their mean coalesced batch, then
one JSON line of every turn with the card's name and power limit. It asks
whether the status group commit pays at a denser writer load than the
harness's default of 3.

``flash32`` does what ``decode`` does with f32 flash attention: each turn
times ``flash_attention`` in f32 at FLASH32_SHAPES, causal off and on,
with ``chip_smoke.cuda_ms``, and holds each output against
``reference_attention`` (the limit's share, 2e-5 + 2e-5 |ref|). Against
a tree from before the general flash kernel, it compares that kernel with
the f32 one it replaced.

``f32`` does the same with the f32 rows (code that runs in any tree): the
f32 flash headline [4, 8, 2048, 128], causal off and on, and absorbed-MLA
decode in f32 (q [32, 1, 128, 576] against the smoke's latent cache and
lengths), each timed with ``chip_smoke.cuda_ms`` and held against its
plain version (the f32 flash limit's share), with the decode's launches a
call. Against a tree from before the f32 route, it times the general SIMT
kernels that route replaced.

``mixed`` does the same with MIXED_AB (code that runs in any tree): an
f32 query over a bf16 cache at the decode serve shape, at absorbed MLA and
at the flash headline (causal off and on), the calls the ring and mixed
kernels took from the general kernels, beside the same decode shapes with
a bf16 query; ms, launches a call and the flash limit's share of each.

``host`` does the same with HOST_AB: the bf16 absorbed-MLA decode and the
bf16 serve-shape decode, each call's event ms beside its device ms
(torch.profiler) and the host's us a call, and the MLA call's Python time
under cProfile: whether a short row's event time is the device's or the
host's.

``decode-keys`` times one decode call with every sequence at the full
4096-token cache (32 sequences, one head) for each of DECODE_KEY_CASES:
the tuned and general kernels at 8 query rows and 1 (one launch), the
wide kernel at absorbed MLA's 128 rows and at 1; and prints the time per
key of the call and the device's busy time per call (torch.profiler):
what bounds a kernel whose grid is b * h blocks when b * h is small. With
OTHER_TREE it runs there and here in turns (other, this, this, other).

``wide-parts`` splits the wide kernels' time: it times absorbed-MLA decode
and flash attention at 576/512 (the smoke's wide rows, causal off and on)
in this tree and in copies of it whose wide body (``wide_attention.cuh``)
leaves out one part or walks it differently (WIDE_PARTS), each in its own
process, and in this tree at other split counts of the MLA decode
(``WIDE_BLOCKS_PER_SM``). A copy that leaves a part out computes a wrong
result: it is timed, never checked.

``ring-variants`` builds copies of the tree whose tuned decode ring kernel
(``decode_attention.cu``) holds 8 query rows in other ways (RING_VARIANTS:
q in registers instead of shared memory, 1 key a step instead of 2, the
step loop unrolled, one block an SM instead of two), each in its own
process, and prints each
copy's registers and spills at 8 rows and the device time (torch.profiler)
of the decode-keys tuned cases (1 and 8 rows at 32 one-head caches) and
of the bf16 serve shape. The copies are timed, not checked.

``f32-splits`` times absorbed-MLA decode in f32 (the smoke's latent cache
and lengths, 128 query rows and 1) on the f32 kernel at each
F32_BLOCKS_PER_SM of F32_SPLITS_SWEEP, the blocks an SM its split count
aims for, with the split count each gives: what sizes that constant.

``cluster-parts`` times the any-dtype flash kernel in copies of the tree
whose body (``cluster_flash.cuh``) leaves one part out (CLUSTER_PARTS: the
exchange of partial scores between a cluster's CTAs, the split warps'
pass) or holds fewer stages or more P V groups in flight, and as it is
with one CTA a cluster: where its time goes. The copies that leave a part
out compute wrong results: they are timed, never checked.

``tc-flash`` does what ``f32`` does with TC_FLASH_ROWS (code that runs in
any tree): flash with an f32 operand and flash in a mix of the two 16-bit
dtypes, the calls that a tree before the one TF32 flash body sent to the
f32 and mixed routes (``f32tc_attention.cuh``) and this tree sends to the
any-dtype kernel: f32 at [4, 8, 2048] with 128/128 and 256/256 and at
[1, 16, 2048] with 576/512, every q/cache class at the headline, an f32 q
over bf16 K and V and a bf16 q over f32 ones at 576/512, causal off and
on; ms and the error's share of the flash limit of each, and at 576/512
also ms at one CTA a cluster (``cluster_flash_plan`` of one CTA, which
changes nothing in a tree whose f32 and mixed calls take another kernel).

``stream-splits`` times the any-dtype decode kernel at each STREAM_WAVES of
STREAM_WAVES_SWEEP, the blocks a slot its split count aims for, with the
tile that fits two blocks an SM and the one that fits one: what sizes
those constants. ``stream-parts`` times it in copies whose tiles leave out
the S phase, the softmax, P V, or all three (STREAM_PARTS): where its time
goes, at the wide rows, K and V apart, and the rows the element variant
takes (bf16 at d = 66, the bf16 serve shape on a cache view off 16
bytes); one more copy times the element variant with one 16-byte chunk
of a row a lane in S. The copies that leave a part out
compute wrong results: they are timed, never checked.

``general`` times the calls past the tuned, wide, f32 and mixed routes
(GENERAL_ROWS; the any-dtype kernels' since they replaced the general SIMT
kernels): head dims 1024/1024 and 64/640 in bf16 and f32, decode and
flash, and K and V in different dtypes (an f32 q and K over a bf16 V) at
the decode serve shape and the flash headline, causal off and on. Each
row: kernel, plain and library ms (none for the mix), launches a call, the
bound (bytes at 3.35 TB/s, or each product at its operands' own rate:
16-bit by 16-bit at 989.4 TFLOP/s, one with an f32 operand as the TF32
products that keep f32's precision at 494.7; beside it the bound at the
TF32 products the any-dtype flash kernel issues and, for f32, at 67
TFLOP/s of SIMT) and the error against the plain version. With
OTHER_TREE it runs those rows there and here in turns (other, this, this,
other), each turn in its own process: the kernels before and after a
change. (The mixed, f32 flash and
f32 absorbed-MLA rows it timed before went to the ring, the mixed and the
f32 tensor-core kernels; ``mixed`` and ``f32`` time them against an older
tree.)

``perwarp`` times the calls a per-warp decode kernel used to take
(PERWARP_ROWS): f32 at 16 heads x 256 against the smoke's cache and
lengths (R1) and at 4 sequences of the whole cache (R2), bf16 at d = 66
(R3) and the bf16 serve shape on K and V views one element past a 16-byte
boundary (R4), each on whichever kernel the tree routes it to, and R1 and
R2 on the any-dtype decode entry as well. Each row: kernel, plain and
library ms, the byte bound (each valid K and V row read once, q and out
once, at 3.35 TB/s) and its share, launches a call, the error's share of
the flash limit and the CUDA kernels traced. With OTHER_TREE it runs there
and here in turns (other, this, this, other), each turn in its own
process.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL = Path("k8s_dra_driver_tpu_torch/csrc/flash_attention.cu")
WIDE = Path("k8s_dra_driver_tpu_torch/csrc/wide_attention.cuh")
DECODE_SRC = Path("k8s_dra_driver_tpu_torch/csrc/decode_attention.cu")
F32TC = Path("k8s_dra_driver_tpu_torch/csrc/f32tc_attention.cuh")
CLUSTER = Path("k8s_dra_driver_tpu_torch/csrc/cluster_flash.cuh")
STREAM = Path("k8s_dra_driver_tpu_torch/csrc/stream_decode.cu")
# The f32 and mixed decode body's last key tile of each split and last
# split of the cache dropped.
F32TC_TILE_AND_SPLIT = [
    ("(w.k_limit - w.k0 + kKeys - 1) / kKeys : 0;",
     "(w.k_limit - w.k0 + kKeys - 1) / kKeys - 1 : 0;"),
    ("const int len = min(a.lens[w.bh / a.h], a.keys);",
     "const int len = min(a.lens[w.bh / a.h],\n"
     "                      min(a.keys, (a.splits - 1) * a.split_keys));")]
# The any-dtype flash body's lo.hi product of S (an f32 query's lo part).
CLUSTER_Q_LO = ("          if constexpr (!kQ16) "
                "wgmma_tf32_rs_n64(s, q_lo[b], kh + off, 1);\n")
# name: (the source broken, its (text, broken text) pairs, the checks that
# must each reject it).
CONTROLS = {
    "softmax_scale_x1.01": (KERNEL, [
        ("scale * 1.4426950408889634f, causal);",
         "scale * 1.01f * 1.4426950408889634f, causal);")], ("flash",)),
    "last_key_tile_dropped": (KERNEL, [
        ("/ kN)\n                : n_tiles;",
         "/ kN)\n                : n_tiles - 1;")], ("flash",)),
    "wide_softmax_scale_x1.01": (WIDE, [
        ("const float scale_log2 = a.scale_log2;",
         "const float scale_log2 = a.scale_log2 * 1.01f;")],
        ("wide_decode", "wide_flash")),
    "wide_last_key_tile_and_split_dropped": (WIDE, [
        ("w.n_kt = (w.k_limit + kKeys - 1) / kKeys;",
         "w.n_kt = (w.k_limit + kKeys - 1) / kKeys - 1;"),
        ("const int len = min(a.lens[w.bh / a.h], a.keys);",
         "const int len = min(a.lens[w.bh / a.h],\n"
         "                        min(a.keys, (a.splits - 1) * a.split_keys));")],
        ("wide_decode", "wide_flash")),
    "ring_softmax_scale_x1.01": (DECODE_SRC, [
        ("a.scale * kLog2e, a.split_keys, a.q_type);",
         "a.scale * 1.01f * kLog2e, a.split_keys, a.q_type);")],
        ("tuned_decode", "mixed_decode")),
    "ring_last_tile_dropped": (DECODE_SRC, [
        ("k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile : 0;",
         "k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile - 1 : 0;")],
        ("tuned_decode", "mixed_decode")),
    # The f32 and mixed decode body (f32tc_attention.cuh), through the
    # decode checks.
    "f32_single_tf32": (F32TC, [
        ("""          if constexpr (!kQ16)
            wgmma_tf32_rs_n64(s, q_lo[b], kh + off, p + ks > 0);
          if constexpr (!kKV16)
            wgmma_tf32_rs_n64(s, q_hi[b], kl + off, !kQ16 || p + ks > 0);
          wgmma_tf32_rs_n64(s, q_hi[b], kh + off,
                            !kQ16 || !kKV16 || p + ks > 0);""",
         "          wgmma_tf32_rs_n64(s, q_hi[b], kh + off, p + ks > 0);"),
        ("""          if constexpr (!kKV16) {
            wgmma_tf32_rs_n32(o[vp], p_lo[ks], vh + off);
            wgmma_tf32_rs_n32(o[vp], p_hi[ks], vl + off);
          }
          wgmma_tf32_rs_n32(o[vp], p_hi[ks], vh + off);""",
         "          wgmma_tf32_rs_n32(o[vp], p_hi[ks], vh + off);")],
        ("f32_decode",)),
    "f32_softmax_scale_x1.01": (F32TC, [
        ("const float scale_log2 = a.scale_log2;",
         "const float scale_log2 = a.scale_log2 * 1.01f;")],
        ("f32_decode",)),
    "f32_last_key_tile_and_split_dropped": (F32TC, F32TC_TILE_AND_SPLIT,
                                            ("f32_decode",)),
    # The mixed decode (the same body built for 16-bit q or K and V): the
    # same dropped tile and split; an f32 query's lo product not issued (S
    # from the query's TF32 part alone); p not rounded to V's dtype (the raw
    # f32 p, read as TF32). The last two are below the narrowest input's
    # limit: mixed_decode_check's nearest-semantics checks must reject them.
    "mixed_last_key_tile_and_split_dropped": (F32TC, F32TC_TILE_AND_SPLIT,
                                              ("mixed_decode",)),
    "mixed_q_lo_dropped": (F32TC, [
        ("""          if constexpr (!kQ16)
            wgmma_tf32_rs_n64(s, q_lo[b], kh + off, p + ks > 0);
""", "")], ("mixed_decode",)),
    "mixed_p_not_rounded": (F32TC, [
        ("p_hi[ks][j] = __float_as_uint(round16(x, kv_f16));",
         "p_hi[ks][j] = __float_as_uint(x);")], ("mixed_decode",)),
    # The same four in the any-dtype flash body (cluster_flash.cuh), which
    # takes the f32 and mixed flash calls: one TF32 product where there were
    # three and the last key tile dropped, through the f32 flash check; the
    # f32 query's lo product not issued and p not rounded, through the
    # mixed flash check's nearest-semantics checks.
    "cluster_f32_single_tf32": (CLUSTER, [
        (CLUSTER_Q_LO + """\
          if constexpr (!kK16) wgmma_tf32_rs_n64(s, q_hi[b], kl + off, 1);
          wgmma_tf32_rs_n64(s, q_hi[b], kh + off, 1);""",
         "          wgmma_tf32_rs_n64(s, q_hi[b], kh + off, 1);"),
        ("""          if constexpr (!kV16) {
            wgmma_tf32_rs_n32(o[vp], p_lo[ks], vh + off);
            wgmma_tf32_rs_n32(o[vp], p_hi[ks], vl + off);
          }
          wgmma_tf32_rs_n32(o[vp], p_hi[ks], vh + off);""",
         "          wgmma_tf32_rs_n32(o[vp], p_hi[ks], vh + off);")],
        ("f32_flash",)),
    "cluster_f32_last_key_tile_dropped": (CLUSTER, [
        ("w.n_kt = (w.k_limit + kKeys - 1) / kKeys;",
         "w.n_kt = (w.k_limit + kKeys - 1) / kKeys - 1;")], ("f32_flash",)),
    "cluster_mixed_q_lo_dropped": (CLUSTER, [(CLUSTER_Q_LO, "")],
                                   ("mixed_flash",)),
    "cluster_mixed_p_not_rounded": (CLUSTER, [
        ("p_hi[ks][j] = __float_as_uint(round16(x, v_f16));",
         "p_hi[ks][j] = __float_as_uint(x);")], ("mixed_flash",)),
    # The any-dtype kernels: S scaled 1% off in each; the flash cluster's
    # last CTA's partial of S left out of the sum; the decode cache's last
    # split dropped (its keys never reach the merge).
    "cluster_softmax_scale_x1.01": (CLUSTER, [
        ("const float scale_log2 = a.scale_log2;",
         "const float scale_log2 = a.scale_log2 * 1.01f;")],
        ("cluster_flash",)),
    "cluster_last_partial_dropped": (CLUSTER, [
        ("      for (int j = 0; j < a.cluster; ++j) {\n"
         "        // A CTA's 8 loads",
         "      for (int j = 0; j < a.cluster - 1; ++j) {\n"
         "        // A CTA's 8 loads")], ("cluster_flash",)),
    "stream_softmax_scale_x1.01": (STREAM, [
        ("const float scale_log2 = a.scale_log2;",
         "const float scale_log2 = a.scale_log2 * 1.01f;")],
        ("stream_decode",)),
    "stream_last_split_dropped": (STREAM, [
        ("const int k_end = min(k_begin + a.split_keys, n_valid);",
         "const int k_end = split + 1 == splits && splits > 1\n"
         "                        ? k_begin\n"
         "                        : min(k_begin + a.split_keys, n_valid);")],
        ("stream_decode",)),
}
# A version's library is built at its first call, in the bench's warm-up
# (phase_build would hold every version to the tree's SASS requirements).
BENCH = ("import json, chip_smoke as c; card = c.phase_device(); "
         "r = c.phase_flash_bench(0); "
         "print('AB_RESULT ' + json.dumps({**r, 'card': card}))")
# Each check in its own try: a control's line says which ones rejected it.
CHECK = (
    "import numpy as np, torch, chip_smoke as c\n"
    "c.phase_device(); c.phase_build()\n"
    "def wide_decode():\n"
    "    rng = np.random.default_rng(0)\n"
    "    c.general_dims_check(rng); c.wide_decode_check(rng)\n"
    "def f32_decode():\n"
    "    rng = np.random.default_rng(0)\n"
    "    c.general_dims_check(rng); c.f32_decode_check(rng)\n"
    "checks = {{'flash': lambda: c.phase_flash_check(0),\n"
    "           'wide_decode': wide_decode,\n"
    "           'f32_decode': f32_decode,\n"
    "           'f32_flash': lambda: c.f32_flash_check(\n"
    "               torch.Generator(device='cuda:0').manual_seed(0)),\n"
    "           'tuned_decode': lambda: c.tuned_decode_check(\n"
    "               np.random.default_rng(0)),\n"
    "           'wide_flash': lambda: c.wide_flash_check(\n"
    "               torch.Generator(device='cuda:0').manual_seed(0)),\n"
    "           'mixed_decode': lambda: c.mixed_decode_check(\n"
    "               np.random.default_rng(0)),\n"
    "           'mixed_flash': lambda: c.mixed_flash_check(\n"
    "               torch.Generator(device='cuda:0').manual_seed(0)),\n"
    "           'stream_decode': lambda: c.stream_decode_check(\n"
    "               np.random.default_rng(0)),\n"
    "           'cluster_flash': lambda: c.cluster_flash_check(\n"
    "               torch.Generator(device='cuda:0').manual_seed(0))}}\n"
    "for name in {names!r}:\n"
    "    try:\n"
    "        checks[name]()\n"
    "    except SystemExit as e:\n"
    "        print(f'CONTROL_REJECTED {{name}}: {{e}}', flush=True)\n"
    "    else:\n"
    "        print(f'CONTROL_PASSED {{name}}', flush=True)\n")
SERVE = ("import chip_smoke as c; card = c.phase_device(); "
         "print('AB_CARD ' + card); "
         "c.phase_serve(0, **c.phase_enumerate())")
SERVE_KEYS = ("decode_tok_s", "step_ms_p50", "step_ms_p99", "steps",
              "kernel_launches", "claim_ready_ms", "ttfb_ms")
SERVE_SCALE = SERVE + "; c.phase_scale(card)"
SERVE_SCALE_KEYS = SERVE_KEYS + ("tokens_s_lo", "tokens_s_hi", "scaling_x",
                                 "ttfb_p50_ms", "ttfb_p99_ms")
# The f32 timing phase, then f16 and bf16 at the same shape and lengths
# (code that runs in any tree whose wrapper takes f16).
DECODE = (
    "import numpy as np, torch, chip_smoke as c\n"
    "card = c.phase_device(); print('AB_CARD ' + card)\n"
    "# A tree's first turn builds (and prints the registers); later turns\n"
    "# reuse its libraries.\n"
    "if not c._build.library_path('decode_attention').exists():\n"
    "    c.phase_build()\n"
    "rng = np.random.default_rng(0)\n"
    "k, v, lens = c.smoke_inputs(rng)\n"
    "c.phase_timing(rng, k, v, lens)\n"
    "mask = (torch.arange(c.KV_CAP, device=k.device)[None, None, None, :]"
    " < lens[:, None, None, None])\n"
    "q = torch.from_numpy(rng.standard_normal((c.BATCH, c.HEADS, 1,"
    " c.HEAD_DIM), np.float32)).to(k.device)\n"
    "fa, sdpa = c.flash_attention_decode,"
    " torch.nn.functional.scaled_dot_product_attention\n"
    "out = {}\n"
    "for name, t in (('f16', torch.float16), ('bf16', torch.bfloat16)):\n"
    "    qq, kk, vv = q.to(t), k.to(t), v.to(t)\n"
    "    out[name + '_ms'] = c.cuda_ms(lambda: fa(qq, kk, vv, lens))\n"
    "    out[name + '_library_ms'] = c.cuda_ms(lambda: sdpa(qq, kk, vv,"
    " attn_mask=mask))\n"
    "    del qq, kk, vv\n"
    "print('[timing16] ' + ' '.join(f'{n}={x}' for n, x in out.items()),"
    " flush=True)\n")
DECODE_KEYS = ("kernel_ms", "plain_ms", "library_ms", "bound_ms", "f16_ms",
               "f16_library_ms", "bf16_ms", "bf16_library_ms")
# f32 flash shapes [b, h, S, d, dv]: the bench's headline and two sweep
# rows, d 64 and 256, dv over d, padded head dims, one short sequence.
FLASH32_SHAPES = ((4, 8, 2048, 128, 128), (16, 8, 512, 128, 128),
                  (1, 8, 8192, 128, 128), (4, 8, 2048, 64, 64),
                  (4, 8, 2048, 256, 256), (4, 8, 2048, 32, 256),
                  (2, 3, 129, 40, 24), (8, 8, 64, 128, 128))
FLASH32 = (
    "import json, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute.flashattention import "
    "flash_attention as fa\n"
    "from k8s_dra_driver_tpu_torch.compute.ringattention import "
    "reference_attention as ref\n"
    "card = c.phase_device(); print('AB_CARD ' + card)\n"
    "g = torch.Generator(device='cuda:0').manual_seed(0)\n"
    "ms, over = [], []\n"
    f"for b, h, s, d, dv in {FLASH32_SHAPES!r}:\n"
    "    q, k = (torch.randn((b, h, s, d), generator=g, device='cuda:0')"
    " for _ in range(2))\n"
    "    v = torch.randn((b, h, s, dv), generator=g, device='cuda:0')\n"
    "    for causal in (False, True):\n"
    "        ms.append(c.cuda_ms(lambda: fa(q, k, v, causal=causal), runs=10,"
    " warmup=2))\n"
    "        over.append(c.compare(fa(q, k, v, causal=causal),"
    " ref(q, k, v, causal=causal), 2e-5, 2e-5)[1])\n"
    "dump = lambda x: json.dumps([round(y, 5) for y in x],"
    " separators=(',', ':'))\n"
    "print('[flash32] ms=' + dump(ms) + ' err_over_limit=' + dump(over))\n")
# The f32 rows in any tree: the f32 flash headline, causal off and on, and
# absorbed-MLA decode in f32 at the smoke's lengths.
F32_AB = (
    "import json, numpy as np, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute.flashattention import ("
    "decode_attention_reference, flash_attention, flash_attention_decode)\n"
    "from k8s_dra_driver_tpu_torch.compute.ringattention import "
    "reference_attention\n"
    "card = c.phase_device(); print('AB_CARD ' + card)\n"
    "g = torch.Generator(device='cuda:0').manual_seed(0)\n"
    "f = torch.float32\n"
    "r = {}\n"
    "q, k, v = (c.randn(g, c.FLASH_SHAPE, f) for _ in range(3))\n"
    "for causal in (False, True):\n"
    "    name = 'flash_causal' if causal else 'flash'\n"
    "    fn = lambda: flash_attention(q, k, v, causal=causal)\n"
    "    r[name + '_ms'] = c.cuda_ms(fn, runs=10, warmup=2)\n"
    "    r[name + '_err_over_limit'] = c.compare(fn(), reference_attention("
    "q, k, v, causal=causal), *c.FLASH_F32_TOL)[1]\n"
    "del q, k, v\n"
    "lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0)))"
    ".to('cuda:0')\n"
    "q = c.randn(g, (c.BATCH, 1, c.MLA_ROWS, c.MLA_D), f)\n"
    "k = c.randn(g, (c.BATCH, 1, c.KV_CAP, c.MLA_D), f)\n"
    "v = c.randn(g, (c.BATCH, 1, c.KV_CAP, c.MLA_DV), f)\n"
    "fn = lambda: flash_attention_decode(q, k, v, lens)\n"
    "before = flash_attention_decode.launches\n"
    "out = fn()\n"
    "r['mla_launches'] = flash_attention_decode.launches - before\n"
    "r['mla_ms'] = c.cuda_ms(fn, runs=10, warmup=2)\n"
    "r['mla_err_over_limit'] = c.compare(out, decode_attention_reference("
    "q, k, v, lens), *c.FLASH_F32_TOL)[1]\n"
    "print('[f32ab] ' + ' '.join(f'{n}={x}' for n, x in r.items()),"
    " flush=True)\n")
# What each mode runs in a tree, and the lines of its output it keeps.
# mixed: code that runs in any tree (an older one takes these calls on the
# general kernels): an f32 q over a bf16 cache at the decode serve shape
# and at absorbed MLA (q [32, 1, 128, 576] against the smoke's latent cache
# and lengths), and at the flash headline [4, 8, 2048, 128], causal off and
# on; beside them the same decode shapes with a bf16 q (the ring and wide
# kernels, whose code the mixed routes share or sit beside), each with its
# ms, launches a call and error against its plain version (the flash
# limit's share).
MIXED_ROWS = ("serve_f32q_bf16kv", "serve_bf16", "mla_f32q_bf16kv",
              "mla_bf16", "flash_f32q_bf16kv", "flash_f32q_bf16kv_causal")
MIXED_AB = (
    "import numpy as np, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute.flashattention import ("
    "decode_attention_reference as dref, flash_attention as fa, "
    "flash_attention_decode as fd)\n"
    "from k8s_dra_driver_tpu_torch.compute.ringattention import "
    "reference_attention as ref\n"
    "card = c.phase_device(); print('AB_CARD ' + card)\n"
    "g = torch.Generator(device='cuda:0').manual_seed(0)\n"
    "f, bf = torch.float32, torch.bfloat16\n"
    "lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0)))"
    ".to('cuda:0')\n"
    "r = {}\n"
    "def row(name, counter, fn, plain):\n"
    "    before = counter.launches\n"
    "    out = fn()\n"
    "    r[name + '_launches'] = counter.launches - before\n"
    "    r[name + '_ms'] = c.cuda_ms(fn, runs=10, warmup=2)\n"
    "    r[name + '_err_over_limit'] = c.compare(out, plain(),"
    " *c.FLASH_BF16_TOL)[1]\n"
    "for name, shapes in (('serve', [(c.BATCH, c.HEADS, 1, c.HEAD_DIM),"
    " (c.BATCH, c.HEADS, c.KV_CAP, c.HEAD_DIM)] * 2), ('mla', ["
    "(c.BATCH, 1, c.MLA_ROWS, c.MLA_D), (c.BATCH, 1, c.KV_CAP, c.MLA_D),"
    " (c.BATCH, 1, c.MLA_ROWS, c.MLA_DV), (c.BATCH, 1, c.KV_CAP,"
    " c.MLA_DV)])):\n"
    "    q = c.randn(g, shapes[0], f)\n"
    "    k, v = c.randn(g, shapes[1], bf), c.randn(g, shapes[3], bf)\n"
    "    row(name + '_f32q_bf16kv', fd, lambda: fd(q, k, v, lens),"
    " lambda: dref(q, k, v, lens))\n"
    "    qb = q.to(bf)\n"
    "    row(name + '_bf16', fd, lambda: fd(qb, k, v, lens),"
    " lambda: dref(qb, k, v, lens))\n"
    "    del q, qb, k, v\n"
    "q = c.randn(g, c.FLASH_SHAPE, f)\n"
    "k, v = (c.randn(g, c.FLASH_SHAPE, bf) for _ in range(2))\n"
    "for causal in (False, True):\n"
    "    row('flash_f32q_bf16kv' + ('_causal' if causal else ''), fa,"
    " lambda: fa(q, k, v, causal=causal),"
    " lambda: ref(q, k, v, causal=causal))\n"
    "print('[mixedab] ' + ' '.join(f'{n}={x}' for n, x in r.items()),"
    " flush=True)\n")

# host: code that runs in any tree: the bf16 absorbed-MLA decode (the wide
# kernel, ~0.08 ms of device time a call) and the bf16 decode serve shape
# (the ring kernel), each its event ms a call (chip_smoke.cuda_ms), its
# device ms a call (torch.profiler) and the host's us a call (200 calls on
# the host's clock, no synchronize inside), and for MLA the Python time a
# call under cProfile: whether a row's event time is the device's or the
# host's.
HOST_AB = (
    "import cProfile, pstats, time, numpy as np, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute.flashattention import "
    "flash_attention_decode as fd\n"
    "card = c.phase_device(); print('AB_CARD ' + card)\n"
    "g = torch.Generator(device='cuda:0').manual_seed(0)\n"
    "bf = torch.bfloat16\n"
    "lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0)))"
    ".to('cuda:0')\n"
    "r = {}\n"
    "def host_us(fn, calls=200):\n"
    "    torch.cuda.synchronize()\n"
    "    t0 = time.perf_counter()\n"
    "    for _ in range(calls):\n"
    "        fn()\n"
    "    t1 = time.perf_counter()\n"
    "    torch.cuda.synchronize()\n"
    "    return (t1 - t0) * 1e6 / calls\n"
    "for name, qs, ks, vs in (('mla', (c.BATCH, 1, c.MLA_ROWS, c.MLA_D),"
    " (c.BATCH, 1, c.KV_CAP, c.MLA_D), (c.BATCH, 1, c.KV_CAP, c.MLA_DV)),"
    " ('serve', (c.BATCH, c.HEADS, 1, c.HEAD_DIM), (c.BATCH, c.HEADS,"
    " c.KV_CAP, c.HEAD_DIM), (c.BATCH, c.HEADS, c.KV_CAP, c.HEAD_DIM))):\n"
    "    q, k, v = c.randn(g, qs, bf), c.randn(g, ks, bf), c.randn(g, vs, bf)\n"
    "    fn = lambda: fd(q, k, v, lens)\n"
    "    r[name + '_event_ms'] = c.cuda_ms(fn)\n"
    "    r[name + '_device_ms'] = c.device_busy(fn, calls=20)[0]\n"
    "    r[name + '_host_us'] = host_us(fn)\n"
    "    if name == 'mla':\n"
    "        prof = cProfile.Profile()\n"
    "        prof.enable(); host_us(fn, 300); prof.disable()\n"
    "        r['mla_profiled_python_us'] = pstats.Stats(prof).total_tt"
    " * 1e6 / 300\n"
    "    del q, k, v\n"
    "print('[hostab] ' + ' '.join(f'{n}={x}' for n, x in r.items()),"
    " flush=True)\n")

# tc-flash: code that runs in any tree: the flash calls with an f32 operand
# or a mix of the two 16-bit dtypes (the f32 and mixed routes' before the
# any-dtype kernel took them), each causal off and on: ms and the error's
# share of its narrowest input's flash limit, and at 576/512 ms at one CTA
# a cluster too. Rows: (name, [b, h, S, d], dv, q/k/v dtypes).
TC_FLASH_ROWS = (
    ("f32_headline", (4, 8, 2048, 128), 128, ("float32",) * 3),
    ("f32_256", (4, 8, 2048, 256), 256, ("float32",) * 3),
    ("f32_576_512", (1, 16, 2048, 576), 512, ("float32",) * 3),
) + tuple(
    (f"{q}q_{kv}kv_headline", (4, 8, 2048, 128), 128, (q, kv, kv))
    for q, kv in (("float32", "bfloat16"), ("float32", "float16"),
                  ("bfloat16", "float32"), ("float16", "float32"),
                  ("bfloat16", "float16"), ("float16", "bfloat16"))) + (
    ("float32q_bfloat16kv_576_512", (1, 16, 2048, 576), 512,
     ("float32", "bfloat16", "bfloat16")),
    ("bfloat16q_float32kv_576_512", (1, 16, 2048, 576), 512,
     ("bfloat16", "float32", "float32")))
TC_FLASH = (
    "import torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute import flashattention as fa\n"
    "from k8s_dra_driver_tpu_torch.compute.ringattention import "
    "reference_attention as ref\n"
    "card = c.phase_device(); print('AB_CARD ' + card)\n"
    "g = torch.Generator(device='cuda:0').manual_seed(0)\n"
    "plan = fa.cluster_flash_plan\n"
    "r = {}\n"
    f"for name, shape, dv, ts in {TC_FLASH_ROWS!r}:\n"
    "    q, k = (c.randn(g, shape, getattr(torch, t)) for t in ts[:2])\n"
    "    v = c.randn(g, shape[:3] + (dv,), getattr(torch, ts[2]))\n"
    "    tol = c.flash_tol(*(getattr(torch, t) for t in ts))\n"
    "    for causal in (False, True):\n"
    "        key = name + ('_causal' if causal else '')\n"
    "        fn = lambda: fa.flash_attention(q, k, v, causal=causal)\n"
    "        r[key + '_ms'] = c.cuda_ms(fn, runs=10, warmup=2)\n"
    "        r[key + '_err_over_limit'] = c.compare(fn(), ref(q, k, v,"
    " causal=causal), *tol)[1]\n"
    "        if dv > 256:\n"
    "            fa.cluster_flash_plan = lambda d, dv: (1,"
    " -(-d // fa.CLUSTER_GROUP_COLS), plan(d, dv)[2])\n"
    "            r[key + '_one_cta_ms'] = c.cuda_ms(fn, runs=10, warmup=2)\n"
    "            fa.cluster_flash_plan = plan\n"
    "    del q, k, v\n"
    "    torch.cuda.empty_cache()\n"
    "print('[tcflash] ' + ' '.join(f'{n}={x}' for n, x in r.items()),"
    " flush=True)\n")

TREE_MODES = {
    "serve": (SERVE, lambda ln: ln.startswith("[serve] submitted="),
              SERVE_KEYS),
    "serve-scale": (SERVE_SCALE, lambda ln: ln.startswith(
        ("[serve] submitted=", "[scale] card=", "[scale] ttfb_count=")),
        SERVE_SCALE_KEYS),
    "decode": (DECODE, lambda ln: ln.startswith(("[timing]", "[timing16]"))
               or ln.startswith("[build] kernel=decode"), DECODE_KEYS),
    "flash32": (FLASH32, lambda ln: ln.startswith("[flash32]"),
                ("ms", "err_over_limit")),
    "f32": (F32_AB, lambda ln: ln.startswith("[f32ab]"),
            ("flash_ms", "flash_causal_ms", "mla_ms", "mla_launches",
             "flash_err_over_limit", "flash_causal_err_over_limit",
             "mla_err_over_limit")),
    "mixed": (MIXED_AB, lambda ln: ln.startswith("[mixedab]"),
              tuple(f"{row}_{key}" for row in MIXED_ROWS
                    for key in ("ms", "launches", "err_over_limit"))),
    "tc-flash": (TC_FLASH, lambda ln: ln.startswith("[tcflash]"),
                 tuple(f"{row[0]}{causal}_{key}" for row in TC_FLASH_ROWS
                       for causal in ("", "_causal")
                       for key in ("ms", "err_over_limit", "one_cta_ms"))),
    "host": (HOST_AB, lambda ln: ln.startswith("[hostab]"),
             tuple(f"{row}_{key}" for row in ("mla", "serve")
                   for key in ("event_ms", "device_ms", "host_us"))
             + ("mla_profiled_python_us",)),
}
# wide-parts: the copies of the wide body, each with its (text, replacement)
# pairs: the S loop over a panel count known only at run time (as first
# built), S over one panel of d instead of all, and each consumer's P V
# left out.
_S_LOOP = "#pragma unroll\n        for (int p = 0; p < kDPanels; ++p) {"
WIDE_PARTS = {
    "this_tree": [],
    "s_loop_runtime_count": [(_S_LOOP, "#pragma unroll 1\n        for (int p = 0;"
                              " p < (a.d + kPanelCols - 1) / kPanelCols; ++p) {")],
    "s_one_panel": [(_S_LOOP, "#pragma unroll\n        for (int p = 0; p < 1;"
                     " ++p) {")],
    "no_pv_consumer1": [(
        "wgmma_rs_n256<E>(o, pa[kk], v_desc + ((kk * 2048) >> 4), 1);", ";")],
    "no_pv_consumer2": [("""            wgmma_sst_n256<E>(o, p_desc + ((kk * 32) >> 4),
                              v_desc + ((kk * 2048) >> 4), 1);""",
                         "            ;")],
}
WIDE_SPLITS = (1, 2, 4)
WIDE_PARTS_RUN = (
    "import json, numpy as np, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute import flashattention as fa\n"
    "card = c.phase_device()\n"
    "g = torch.Generator(device='cuda:0').manual_seed(0)\n"
    "bf = torch.bfloat16\n"
    "lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0)))"
    ".to('cuda:0')\n"
    "q = c.randn(g, (c.BATCH, 1, c.MLA_ROWS, c.MLA_D), bf)\n"
    "k = c.randn(g, (c.BATCH, 1, c.KV_CAP, c.MLA_D), bf)\n"
    "v = c.randn(g, (c.BATCH, 1, c.KV_CAP, c.MLA_DV), bf)\n"
    "r = {{}}\n"
    "for bps in {splits!r}:\n"
    "    fa.WIDE_BLOCKS_PER_SM = bps\n"
    "    r[f'mla_decode_blocks_per_sm_{{bps}}'] = c.cuda_ms(\n"
    "        lambda: fa.flash_attention_decode(q, k, v, lens))\n"
    "del q, k, v\n"
    "b, h, s = c.WIDE_FLASH_SHAPE\n"
    "q, k = (c.randn(g, (b, h, s, c.MLA_D), bf) for _ in range(2))\n"
    "v = c.randn(g, (b, h, s, c.MLA_DV), bf)\n"
    "for causal in (False, True):\n"
    "    r[f'flash_576_512_causal_{{causal}}'] = c.cuda_ms(\n"
    "        lambda: fa.flash_attention(q, k, v, causal=causal))\n"
    "print('AB_RESULT ' + json.dumps({{'card': card, **r}}), flush=True)\n")
# decode-keys: (name, query rows, q's dtype, d, dv); K and V in bf16, so
# an f32 q takes the general kernel (at d = 128 and at 576/512).
DECODE_KEY_CASES = (
    ("tuned_rows8_d128", 8, "bfloat16", 128, 128),
    ("tuned_rows1_d128", 1, "bfloat16", 128, 128),
    ("general_rows8_d128_f32q", 8, "float32", 128, 128),
    ("general_rows1_d128_f32q", 1, "float32", 128, 128),
    ("general_rows8_mla_f32q", 8, "float32", 576, 512),
    ("general_rows1_mla_f32q", 1, "float32", 576, 512),
    ("wide_rows128_mla", 128, "bfloat16", 576, 512),
    ("wide_rows1_mla", 1, "bfloat16", 576, 512),
)


def copy_tree(dest: Path, kernel_source: str,
              kernel: Path = KERNEL) -> Path:
    """The port, with ``kernel_source`` as its ``kernel`` source (the flash
    kernel by default), at ``dest``."""
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    shutil.copy2(ROOT / "chip_smoke.py", dest / "chip_smoke.py")
    shutil.copytree(ROOT / "k8s_dra_driver_tpu_torch",
                    dest / "k8s_dra_driver_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (dest / kernel).write_text(kernel_source)
    return dest


def run(tree: Path, code: str, timeout: float) -> tuple:
    """(exit code, output) of ``python3 -c code`` in ``tree``."""
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                              capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired as e:
        return -1, f"timed out after {timeout} s\n{e.stdout or ''}"
    return proc.returncode, proc.stdout + proc.stderr


def versions(others: list, work: Path, timeout: float) -> int:
    sources = [(str(p), Path(p).read_text()) for p in others]
    sources.append(("this-tree", (ROOT / KERNEL).read_text()))
    trees = [copy_tree(work / f"v{i}", text)
             for i, (_, text) in enumerate(sources)]
    order = list(range(len(sources))) + list(reversed(range(len(sources))))
    turns = []
    for turn, i in enumerate(order):
        label = sources[i][0]
        rc, out = run(trees[i], BENCH, timeout)
        print(f"== turn {turn}: {label} (exit {rc})", flush=True)
        for ln in out.splitlines():
            if ln.startswith("[device]") or (
                    ln.startswith("[bench]") and "shape=" in ln):
                print(ln, flush=True)
        if rc != 0:
            print(out[-4000:], flush=True)
            return 1
        result = json.loads(out.split("AB_RESULT ", 1)[1].splitlines()[0])
        turns.append({"turn": turn, "version": label,
                      "card": result["card"], "headline": {
            k: result[k] for k in ("ms", "library_ms", "bound_ms",
                                   "device_busy_ms",
                                   "library_device_busy_ms")},
            "rows": [{k: r[k] for k in ("shape", "causal", "ms",
                                        "library_ms", "bound_ms", "tflops")}
                     for r in result["rows"]]})
    print(json.dumps({"ab_turns": turns}), flush=True)
    return 0


def controls(names: list, work: Path, timeout: float) -> int:
    unknown = set(names) - set(CONTROLS)
    if unknown:
        raise SystemExit(f"no control named {sorted(unknown)}")
    passed = []
    for name, (kernel, edits, checks) in CONTROLS.items():
        if names and name not in names:
            continue
        source = (ROOT / kernel).read_text()
        for old, new in edits:
            if source.count(old) != 1:
                raise SystemExit(f"control {name}: {old!r} is not in "
                                 f"{kernel} exactly once")
            source = source.replace(old, new)
        tree = copy_tree(work / name, source, kernel)
        rc, out = run(tree, CHECK.format(names=checks), timeout)
        lines = out.splitlines()
        print(f"== control {name}: exit {rc}", flush=True)
        for ln in lines:
            if ln.startswith(("[flash]", "[check]", "CONTROL_")):
                print(ln, flush=True)
        # A control fails as it should when every one of its checks
        # rejects it.
        rejected = {ln.split()[1].rstrip(":") for ln in lines
                    if ln.startswith("CONTROL_REJECTED ")}
        if rc != 0 or rejected != set(checks):
            print(out[-3000:], flush=True)
            passed.append(name)
    if passed:
        print(f"controls a check did not reject: {passed}")
        return 1
    print("every control failed every check it must fail")
    return 0


def trees(mode: str, other: Path, rounds: int, timeout: float) -> int:
    """Run ``mode``'s code in the other tree and this one, in turns (other,
    this, this, other) ``rounds`` times; print the kept lines and one JSON
    line of every turn's numbers."""
    code, keep, keys = TREE_MODES[mode]
    sides = [("other", other.resolve()), ("this-tree", ROOT)]
    turns = []
    for turn, i in enumerate([0, 1, 1, 0] * rounds):
        label, tree = sides[i]
        rc, out = run(tree, code, timeout)
        lines = [ln for ln in out.splitlines() if keep(ln)]
        print(f"== turn {turn}: {label} (exit {rc})", flush=True)
        for ln in lines:
            print(ln, flush=True)
        if rc != 0 or not lines:
            print(out[-4000:], flush=True)
            return 1
        fields = {}
        for ln in lines:
            if not ln.startswith("[build]"):
                fields.update(re.findall(r"(\w+)=(\{[^}]*\}|\S+)", ln))
        record = {"turn": turn, "tree": label,
                  "card": out.split("AB_CARD ", 1)[1].splitlines()[0],
                  **{k: fields[k] for k in keys if k in fields}}
        builds = [dict(re.findall(r"(\w+)=(\S+)", ln)) for ln in lines
                  if ln.startswith("[build]")]
        if builds:
            record["registers"] = [f"{b['kernel']}={b['registers']}"
                                   for b in builds]
        turns.append(record)
    print(json.dumps({f"{mode}_turns": turns}), flush=True)
    return 0


WIRE = "import chip_ab; chip_ab.wire_turn({writers}, {cycles})"


def wire_turn(writers: int, cycles: int) -> None:
    """One ``run_wire_path`` with ``writers`` status writers: prints an
    ``AB_RESULT`` line of both arms' claim→ready and coalescing."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.internal.stresslab import run_wire_path

    card = chip_smoke.phase_device()
    r = run_wire_path(cycles=cycles, status_writers=writers)
    arms = {}
    for arm in ("baseline", "optimized"):
        a, wp = r[arm], r[arm]["wire_path"]
        writes = wp["status_batched"]
        arms[arm] = {
            "p50_ms": a["claim_ready_http"]["p50_ms"],
            "p99_ms": a["claim_ready_http"]["p99_ms"],
            "fanout_events": wp["fanout_events"],
            "status_batches": wp["status_batches"],
            "mean_batch": (round(writes / wp["status_batches"], 4)
                           if wp["status_batches"] else None),
            "error_count": a["error_count"]}
    print("AB_RESULT " + json.dumps({"writers": writers, "cycles": cycles,
                                     "card": card, **arms}), flush=True)


def wire(writers: list, cycles: int, timeout: float) -> int:
    turns = []
    for w in writers:
        rc, out = run(ROOT, WIRE.format(writers=w, cycles=cycles), timeout)
        print(f"== writers {w} (exit {rc})", flush=True)
        if rc != 0 or "AB_RESULT " not in out:
            print(out[-4000:], flush=True)
            return 1
        result = json.loads(out.split("AB_RESULT ", 1)[1].splitlines()[0])
        for arm in ("baseline", "optimized"):
            print(f"[wire] writers={w} arm={arm} " + " ".join(
                f"{k}={v}" for k, v in result[arm].items()), flush=True)
        turns.append(result)
    print(json.dumps({"wire_turns": turns}), flush=True)
    return 0


# decode-keys: the same code in every tree (each tree's own wrapper).
DECODE_KEYS_RUN = (
    "import json, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute.flashattention import "
    "flash_attention_decode as fa\n"
    "card = c.phase_device(); print('AB_CARD ' + card)\n"
    "dev = torch.device('cuda', 0)\n"
    "gen = torch.Generator(device=dev).manual_seed(0)\n"
    "cap = c.KV_CAP\n"
    "lens = torch.full((32,), cap, dtype=torch.int32, device=dev)\n"
    "for name, ql, qdt, d, dv in {cases!r}:\n"
    "    q = torch.randn((32, 1, ql, d), generator=gen, device=dev).to(\n"
    "        getattr(torch, qdt))\n"
    "    k = torch.randn((32, 1, cap, d), generator=gen, device=dev).to(\n"
    "        torch.bfloat16)\n"
    "    v = torch.randn((32, 1, cap, dv), generator=gen, device=dev).to(\n"
    "        torch.bfloat16)\n"
    "    fn = lambda: fa(q, k, v, lens)\n"
    "    ms = c.cuda_ms(fn, runs=10, warmup=2)\n"
    "    device_ms = c.device_busy(fn, calls=10)[0]\n"
    "    print(f'[decode-keys] case={{name}} ms={{ms}} device_ms={{device_ms}}'"
    " f' us_per_key={{ms * 1e3 / cap}}', flush=True)\n")


def decode_keys(other: Path | None, rounds: int, timeout: float) -> int:
    """DECODE_KEY_CASES in this tree, or in turns (other, this, this, other)
    ``rounds`` times with another tree: ms a call (CUDA events), device ms
    a call (torch.profiler) and microseconds a key."""
    sides = [("this-tree", ROOT)]
    order = [0]
    if other is not None:
        sides = [("other", other.resolve()), ("this-tree", ROOT)]
        order = [0, 1, 1, 0] * rounds
    turns = []
    for turn, i in enumerate(order):
        label, tree = sides[i]
        rc, out = run(tree, DECODE_KEYS_RUN.format(cases=DECODE_KEY_CASES),
                      timeout)
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("[decode-keys]")]
        print(f"== turn {turn}: {label} (exit {rc})", flush=True)
        for ln in lines:
            print(ln, flush=True)
        if rc != 0 or len(lines) != len(DECODE_KEY_CASES):
            print(out[-4000:], flush=True)
            return 1
        turns.append({"turn": turn, "tree": label,
                      "card": out.split("AB_CARD ", 1)[1].splitlines()[0],
                      "rows": [dict(re.findall(r"(\w+)=(\S+)", ln))
                               for ln in lines]})
    print(json.dumps({"decode_keys_turns": turns}), flush=True)
    return 0


# ring-variants: copies of the ring kernel's 8-row form, each with its
# (text, replacement) pairs in decode_attention.cu.
_Q_SMEM = "constexpr bool q_in_smem(int ql) { return ql >= 8; }"
_Q_REGS = "constexpr bool q_in_smem(int ql) { return false; }"
_U = "constexpr int U = QL >= 4 ? 2 : 4; "
_U1 = "constexpr int U = QL >= 8 ? 1 : QL >= 4 ? 2 : 4; "
_STEPS = ("#pragma unroll (QL >= 8 ? 1 : kWarpKeys / kStepKeys)\n"
          "    for (int step = 0;")
_STEPS_UNROLLED = "#pragma unroll\n    for (int step = 0;"
_BOUNDS = "__global__ void __launch_bounds__(kThreads, 2)"
RING_VARIANTS = {
    "this_tree": [],
    "q_regs_u1_unrolled": [(_Q_SMEM, _Q_REGS), (_U, _U1),
                           (_STEPS, _STEPS_UNROLLED)],
    "q_regs_u1": [(_Q_SMEM, _Q_REGS), (_U, _U1)],
    "q_smem_u1": [(_U, _U1)],
    "q_smem_unrolled": [(_STEPS, _STEPS_UNROLLED)],
    "q_regs_one_block_unrolled": [
        (_Q_SMEM, _Q_REGS), (_STEPS, _STEPS_UNROLLED),
        (_BOUNDS, "__global__ void __launch_bounds__(kThreads, "
                  "QL >= 8 ? 1 : 2)")],
}
RING_VARIANTS_RUN = (
    "import json, re, torch, numpy as np, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute import _build\n"
    "from k8s_dra_driver_tpu_torch.compute.flashattention import "
    "flash_attention_decode as fa\n"
    "card = c.phase_device()\n"
    "log = _build.build_all(force=True)['decode_attention'][1]\n"
    "regs = {{}}\n"
    "for chunk in log.split(\"Compiling entry function '\")[1:]:\n"
    "    name = c.kernel_name(chunk.split(\"'\", 1)[0],"
    " ['decode_ring_kernel'])\n"
    "    if name.startswith('decode_ring_kernel<') and ',8,' in name:\n"
    "        r = re.search(r'Used (\\d+) registers', chunk)\n"
    "        sp = sum(int(n) for n in re.findall(r'(\\d+) bytes spill',"
    " chunk))\n"
    "        regs[name] = f'{{r.group(1)}}/{{sp}}'\n"
    "dev = torch.device('cuda', 0)\n"
    "g = torch.Generator(device=dev).manual_seed(0)\n"
    "cap = c.KV_CAP\n"
    "r = {{'card': card, 'registers_spills_8_rows': regs}}\n"
    "lens = torch.full((32,), cap, dtype=torch.int32, device=dev)\n"
    "for ql in (1, 8):\n"
    "    q = c.randn(g, (32, 1, ql, 128), torch.bfloat16)\n"
    "    k, v = (c.randn(g, (32, 1, cap, 128), torch.bfloat16)"
    " for _ in range(2))\n"
    "    r[f'keys_rows{{ql}}_device_ms'] = c.device_busy("
    "lambda: fa(q, k, v, lens), calls=10)[0]\n"
    "lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0)))"
    ".to(dev)\n"
    "q = c.randn(g, (c.BATCH, c.HEADS, 1, c.HEAD_DIM), torch.bfloat16)\n"
    "k, v = (c.randn(g, (c.BATCH, c.HEADS, cap, c.HEAD_DIM), torch.bfloat16)"
    " for _ in range(2))\n"
    "r['serve_bf16_ms'] = c.cuda_ms(lambda: fa(q, k, v, lens))\n"
    "print('AB_RESULT ' + json.dumps(r), flush=True)\n")


def ring_variants(work: Path, timeout: float) -> int:
    source = (ROOT / DECODE_SRC).read_text()
    turns = []
    for name, edits in RING_VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"ring variant {name}: {old!r} is not in "
                                 f"{DECODE_SRC} exactly once")
            text = text.replace(old, new)
        tree = copy_tree(work / name, text, DECODE_SRC)
        rc, out = run(tree, RING_VARIANTS_RUN.format(), timeout)
        if rc != 0 or "AB_RESULT " not in out:
            print(f"== ring variant {name}: exit {rc}\n{out[-4000:]}",
                  flush=True)
            return 1
        result = json.loads(out.split("AB_RESULT ", 1)[1].splitlines()[0])
        print(f"[ring-variants] variant={name} " + " ".join(
            f"{k}={json.dumps(v) if isinstance(v, dict) else v}"
            for k, v in result.items() if k != "card"), flush=True)
        turns.append({"variant": name, **result})
    print(json.dumps({"ring_variants": turns}), flush=True)
    return 0


# general: (name, q, k and v dtypes, q, k and v shapes, causal or None for
# decode, whether one PyTorch call computes it). The head dims only the
# any-dtype kernels take (past the wide, f32 and mixed routes' 576/512):
# 1024/1024 and 64/640 in bf16 and f32, decode at the smoke's 32 sequences
# and 4096-token cache (4 heads at 1024, 8 at 64/640) and flash at [1, 8,
# 2048], each beside the library call; then K and V in different dtypes (an
# f32 q and K over a bf16 V) at the decode serve shape and the flash
# headline, causal off and on, which no one library call takes.
GENERAL_ROWS = tuple(
    row for t in ("bfloat16", "float32") for row in (
        (f"decode_1024_1024_{t}", (t,) * 3,
         ((32, 4, 1, 1024), (32, 4, 4096, 1024), (32, 4, 4096, 1024)),
         None, True),
        (f"decode_64_640_{t}", (t,) * 3,
         ((32, 8, 1, 64), (32, 8, 4096, 64), (32, 8, 4096, 640)), None,
         True),
        (f"flash_1024_1024_{t}", (t,) * 3,
         ((1, 8, 2048, 1024), (1, 8, 2048, 1024), (1, 8, 2048, 1024)),
         False, True),
        (f"flash_64_640_{t}", (t,) * 3,
         ((1, 8, 2048, 64), (1, 8, 2048, 64), (1, 8, 2048, 640)), False,
         True))) + (
    ("decode_serve_f32qk_bf16v", ("float32", "float32", "bfloat16"),
     ((32, 32, 1, 128), (32, 32, 4096, 128), (32, 32, 4096, 128)), None,
     False),
    ("flash_headline_f32qk_bf16v", ("float32", "float32", "bfloat16"),
     ((4, 8, 2048, 128),) * 3, False, False),
    ("flash_headline_f32qk_bf16v_causal", ("float32", "float32", "bfloat16"),
     ((4, 8, 2048, 128),) * 3, True, False))


def attention_flops_ms(s_macs: int, pv_macs: int, dtypes, bf16_flop_s:
                       float, tf32_flop_s: float) -> float:
    """``chip_smoke.attention_flops_ms`` (each of S's and P V's products at
    its operands' own rate: 16-bit by 16-bit at the bf16 rate, one with an
    f32 operand as 1 + [f32 a] + [f32 b] TF32 products; P takes V's dtype),
    kept here because ``general`` also runs in older trees, whose
    chip_smoke lacks it."""
    q32, k32, v32 = (t == "float32" for t in dtypes)

    def product_ms(macs: int, a32: bool, b32: bool) -> float:
        if not (a32 or b32):
            return 2 * macs / bf16_flop_s * 1e3
        return 2 * macs * (1 + a32 + b32) / tf32_flop_s * 1e3

    return product_ms(s_macs, q32, k32) + product_ms(pv_macs, v32, v32)


def general() -> int:
    """GENERAL_ROWS on the kernels that take them: ms, plain ms, library ms
    (None for the mix), the bound (bytes at 3.35 TB/s, or operations with
    each product at its operands' own rate, ``attention_flops_ms``, the
    longer; beside it the bound at the TF32 products the any-dtype flash
    kernel issues, S 1 + [q f32] + [k f32] and P V 1 with a 16-bit V or 3,
    and for f32 inputs the bound at 67 TFLOP/s of f32 SIMT), launches a
    call and the error against the plain version. It runs in the tree it is
    started from (an older tree's kernels too: ``general_ab``)."""
    import numpy as np
    import torch

    import chip_smoke as c
    from k8s_dra_driver_tpu_torch.compute.flashattention import (
        decode_attention_reference,
        flash_attention,
        flash_attention_decode,
    )
    from k8s_dra_driver_tpu_torch.compute.ringattention import (
        reference_attention,
    )

    card = c.phase_device()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0))).to(
        dev)
    rows = []
    for name, dtypes, shapes, causal, has_library in GENERAL_ROWS:
        q, k, v = (c.randn(gen, shape, getattr(torch, t))
                   for shape, t in zip(shapes, dtypes))
        b, h, ql, d = q.shape
        dv, n = v.shape[3], k.shape[2]
        if causal is None:
            mask = (torch.arange(n, device=dev)[None, None, None, :]
                    < lens[:, None, None, None])
            keys = int(lens.clamp(max=n).sum()) * h
            counter = flash_attention_decode
            kernel = lambda: flash_attention_decode(q, k, v, lens)
            plain = lambda: decode_attention_reference(q, k, v, lens)
            library = lambda: sdpa(q, k, v, attn_mask=mask)
            nbytes = (keys * (d * k.element_size() + dv * v.element_size())
                      + q.numel() * q.element_size()
                      + b * h * ql * dv * q.element_size() + lens.numel() * 4)
            flops = 2 * keys * ql * (d + dv)
            s_macs, pv_macs = keys * ql * d, keys * ql * dv
            tf32 = None
        else:
            keys = b * h * n
            counter = flash_attention
            kernel = lambda: flash_attention(q, k, v, causal=causal)
            plain = lambda: reference_attention(q, k, v, causal=causal)
            library = lambda: sdpa(q, k, v, is_causal=causal)
            nbytes = (q.numel() * q.element_size()
                      + k.numel() * k.element_size()
                      + v.numel() * v.element_size()
                      + b * h * ql * dv * q.element_size())
            half = 2 if causal else 1
            flops = 2 * b * h * ql * n * (d + dv) // half
            s_macs = b * h * ql * n * d // half
            pv_macs = b * h * ql * n * dv // half
            f32 = [t == "float32" for t in dtypes]
            tf32 = 2 * b * h * ql * n * (d * (1 + f32[0] + f32[1])
                                         + dv * (3 if f32[2] else 1)) // half
        before = counter.launches
        out = kernel()
        per_call = counter.launches - before
        ms = c.cuda_ms(kernel, runs=5, warmup=1)
        plain_ms = c.cuda_ms(plain, runs=5, warmup=1)
        library_ms = c.cuda_ms(library, runs=5, warmup=1) if has_library \
            else None
        tol = c.FLASH_F32_TOL if set(dtypes) == {"float32"} else \
            c.FLASH_BF16_TOL
        err, over = c.compare(out, plain(), *tol)
        bytes_ms = nbytes / c.HBM_BYTES_S * 1e3
        all_f32 = set(dtypes) == {"float32"}
        flops_ms = attention_flops_ms(s_macs, pv_macs, dtypes,
                                      c.BF16_FLOP_S, c.TF32_FLOP_S)
        row = {"row": name, "dtypes": "/".join(dtypes),
               "q": list(q.shape), "k": list(k.shape), "v": list(v.shape),
               "causal": causal, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(bytes_ms, flops_ms),
               "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
               **({"tf32_bound_ms": max(bytes_ms,
                                        tf32 / c.TF32_FLOP_S * 1e3)}
                  if tf32 is not None else {}),
               **({"simt_bound_ms": max(bytes_ms,
                                        flops / c.F32_FLOP_S * 1e3)}
                  if all_f32 else {}),
               "bound_share": max(bytes_ms, flops_ms) / ms,
               "launches_per_call": per_call, "max_abs_err": err,
               "err_over_limit": over}
        print("[general] " + " ".join(
            f"{key}={json.dumps(val) if isinstance(val, list) else val}"
            for key, val in row.items()), flush=True)
        rows.append(row)
        del q, k, v, out
        torch.cuda.empty_cache()
    print(json.dumps({"general": rows, "card": card}), flush=True)
    return 0


# general_ab: this tree's ``general`` run in another tree (its kernels,
# its chip_smoke), loaded under another name beside that tree's own
# chip_ab.
GENERAL_RUN = (
    "import importlib.util, sys\n"
    "spec = importlib.util.spec_from_file_location('chip_ab_rows', {path!r})\n"
    "rows = importlib.util.module_from_spec(spec)\n"
    "spec.loader.exec_module(rows)\n"
    "sys.exit(rows.general())\n")


def general_ab(other: Path, rounds: int, timeout: float) -> int:
    """GENERAL_ROWS in the other tree and this one, in turns (other, this,
    this, other) ``rounds`` times, each in its own process: the general
    kernels' times before and after a change to them. Prints each turn's
    rows, then one JSON line of every turn's."""
    code = GENERAL_RUN.format(path=str(Path(__file__).resolve()))
    sides = [("other", other.resolve()), ("this-tree", ROOT)]
    turns = []
    for turn, i in enumerate([0, 1, 1, 0] * rounds):
        label, tree = sides[i]
        rc, out = run(tree, code, timeout)
        print(f"== turn {turn}: {label} (exit {rc})", flush=True)
        lines = out.splitlines()
        for ln in lines:
            if ln.startswith("[general]"):
                print(ln, flush=True)
        found = [ln for ln in lines if ln.startswith('{"general"')]
        if rc != 0 or not found:
            print(out[-4000:], flush=True)
            return 1
        result = json.loads(found[0])
        turns.append({"turn": turn, "tree": label, "card": result["card"],
                      "rows": [{k: r[k] for k in ("row", "ms", "library_ms",
                                                  "launches_per_call",
                                                  "err_over_limit")}
                               for r in result["general"]]})
    print(json.dumps({"general_turns": turns}), flush=True)
    return 0


# perwarp: the calls a per-warp decode kernel took until the ring kernel's
# two-chunk form and the any-dtype decode took them over, as (name, dtype,
# (b, h, d, dv), lengths, K and V as views one element past a 16-byte
# boundary): R1 f32 at 16 heads x 256 against the smoke's lengths (the f32
# serve shape's cache bytes), R2 the same at 4 sequences of the whole cache,
# R3 bf16 at d = 66, R4 the bf16 serve shape on views off 16 bytes. The
# rows are kept here, not taken from chip_smoke, so that they run in older
# trees too; "stream" rows time R1 and R2 on the any-dtype decode entry
# (``_launch_stream_decode``) in whichever tree runs them.
PERWARP_ROWS = (
    ("r1_f32_hd256", "float32", (32, 16, 256, 256), "smoke", False),
    ("r2_f32_hd256_few", "float32", (4, 16, 256, 256), "full", False),
    ("r3_bf16_d66", "bfloat16", (32, 32, 66, 66), "smoke", False),
    ("r4_bf16_off16", "bfloat16", (32, 32, 128, 128), "smoke", True),
)
PERWARP_STREAM = ("r1_f32_hd256", "r2_f32_hd256_few")


def perwarp() -> int:
    """PERWARP_ROWS on the kernels that take them in the tree it runs in
    (and R1 and R2 on the any-dtype decode entry too): kernel, plain and
    library ms (``scaled_dot_product_attention`` with the boolean length
    mask), the byte bound (each valid K and V row read once, q read and out
    written once, at 3.35 TB/s) and its share, launches a call, the error
    against the plain version's share of the flash limit, and the CUDA
    kernels ``torch.profiler`` traced in three calls. Prints a line a row,
    then one JSON line of every row."""
    import numpy as np
    import torch

    import chip_smoke as c
    from k8s_dra_driver_tpu_torch.compute import flashattention as fa

    card = c.phase_device()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smoke = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0))).to(
        dev)
    rows = []
    for name, dtype_name, (b, h, d, dv), lengths, offset in PERWARP_ROWS:
        dtype = getattr(torch, dtype_name)

        def cache(width: int) -> torch.Tensor:
            t = c.randn(gen, (b, h, c.KV_CAP, width), dtype)
            if not offset:
                return t
            flat = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
            flat[1:] = t.reshape(-1)
            return flat[1:].view(t.shape)

        q = c.randn(gen, (b, h, 1, d), dtype)
        k, v = cache(d), cache(dv)
        lens = (smoke[:b].contiguous() if lengths == "smoke" else
                torch.full((b,), c.KV_CAP, dtype=torch.int32, device=dev))
        mask = (torch.arange(c.KV_CAP, device=dev)[None, None, None, :]
                < lens[:, None, None, None])
        keys = int(lens.clamp(max=c.KV_CAP).sum()) * h
        size = dtype.itemsize
        nbytes = (keys * (d + dv) * size + q.numel() * size
                  + b * h * dv * size + lens.numel() * 4)
        bound_ms = nbytes / c.HBM_BYTES_S * 1e3
        tol = c.FLASH_F32_TOL if dtype == torch.float32 else c.FLASH_BF16_TOL
        plain = lambda: fa.decode_attention_reference(q, k, v, lens)
        ref = plain()
        plain_ms = c.cuda_ms(plain)
        # The library's kernel faults (misaligned address) on views off a
        # 16-byte boundary: it takes aligned copies of the same values.
        lk, lv = (k.clone(), v.clone()) if offset else (k, v)
        library_ms = c.cuda_ms(lambda: sdpa(q, lk, lv, attn_mask=mask))
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernels = [("wrapper",
                    lambda: fa.flash_attention_decode(q, k, v, lens))]
        if name in PERWARP_STREAM:
            kernels.append(("stream", lambda: fa._launch_stream_decode(
                q, k, v, lens, stream, sms)))
        for how, fn in kernels:
            before = fa.flash_attention_decode.launches
            out = fn()
            per_call = fa.flash_attention_decode.launches - before
            ms = c.cuda_ms(fn)
            err, over = c.compare(out, ref, *tol)
            traced, _ = c.traced_kernels(fn)
            row = {"row": name, "via": how, "dtype": dtype_name,
                   "q": list(q.shape), "k": list(k.shape),
                   "view_off_16_bytes": bool(k.data_ptr() % 16),
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms, "bound_by": "bytes",
                   "bound_share": bound_ms / ms,
                   "launches_per_call": per_call, "max_abs_err": err,
                   "err_over_limit": over, "kernels": traced}
            print("[perwarp] " + " ".join(
                f"{key}={json.dumps(val)}" for key, val in row.items()),
                flush=True)
            rows.append(row)
            del out
        del q, k, v, lk, lv, lens, mask, ref
        torch.cuda.empty_cache()
    print(json.dumps({"perwarp": rows, "card": card}), flush=True)
    return 0


PERWARP_RUN = GENERAL_RUN.replace("rows.general()", "rows.perwarp()")


def perwarp_ab(other: Path, rounds: int, timeout: float) -> int:
    """PERWARP_ROWS in the other tree and this one, in turns (other, this,
    this, other) ``rounds`` times, each in its own process; one JSON line
    of every turn's rows."""
    code = PERWARP_RUN.format(path=str(Path(__file__).resolve()))
    sides = [("other", other.resolve()), ("this-tree", ROOT)]
    turns = []
    for turn, i in enumerate([0, 1, 1, 0] * rounds):
        label, tree = sides[i]
        rc, out = run(tree, code, timeout)
        print(f"== turn {turn}: {label} (exit {rc})", flush=True)
        lines = out.splitlines()
        for ln in lines:
            if ln.startswith(("[perwarp]", "[device]")):
                print(ln, flush=True)
        found = [ln for ln in lines if ln.startswith('{"perwarp"')]
        if rc != 0 or not found:
            print(out[-4000:], flush=True)
            return 1
        result = json.loads(found[0])
        turns.append({"turn": turn, "tree": label, "card": result["card"],
                      "rows": [{k: r[k] for k in (
                          "row", "via", "ms", "plain_ms", "library_ms",
                          "bound_ms", "bound_share", "launches_per_call",
                          "err_over_limit", "kernels")}
                          for r in result["perwarp"]]})
    print(json.dumps({"perwarp_turns": turns}), flush=True)
    return 0


# cluster-parts: copies of the any-dtype flash body (cluster_flash.cuh)
# that leave one part out (the S exchange between a cluster's CTAs; the
# split warps' pass), timed, never checked (their results are wrong), or
# hold at most 6 stages in the ring, or keep 3 P V panels' groups in flight
# where the body keeps 2, beside the body as it is and, in it, one CTA a
# cluster (S computed again for each 256 columns of dv instead of
# exchanged).
CLUSTER_PARTS = {
    "as_is": [],
    "six_stages": [("constexpr int kMaxStages = 12;",
                    "constexpr int kMaxStages = 6;")],
    "pv_three_in_flight": [
        ("        if (vp > 0) {\n          wgmma_wait<1>();\n"
         "          release(it + vp - 1);\n",
         "        if (vp > 1) {\n          wgmma_wait<2>();\n"
         "          release(it + vp - 2);\n"),
        ("      if constexpr (!kV16) fence_regs(p_lo);\n"
         "      release(it + VP - 1);\n",
         "      if constexpr (!kV16) fence_regs(p_lo);\n"
         "      release(it + VP - 2);\n      release(it + VP - 1);\n")],
    "no_exchange": [("        if (a.cluster > 1) exchange(tc);\n", "")],
    "no_split_pass": [
        ("for (int i = ts; i < kKeys * 4; i += kSplitThreads) {",
         "for (int i = ts; i < 0; i += kSplitThreads) {"),
        ("for (int i = ts; i < kPanelBytes / 16; i += kSplitThreads) {",
         "for (int i = ts; i < 0; i += kSplitThreads) {"),
        ("for (int i = ts; i < kCols / kPair * 2 * (kKeys / 8);",
         "for (int i = ts; i < 0;")],
}
CLUSTER_PARTS_RUN = (
    "import json, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute import flashattention as fa\n"
    "dev = torch.device('cuda', 0)\n"
    "g = torch.Generator(device=dev).manual_seed(0)\n"
    "r = {{}}\n"
    "for name, shape, ts in (\n"
    "        ('bf16_1024', (1, 8, 2048, 1024), ('bfloat16',) * 3),\n"
    "        ('f32_1024', (1, 8, 2048, 1024), ('float32',) * 3),\n"
    "        ('bf16_64_640', (1, 8, 2048, 64), ('bfloat16',) * 3),\n"
    "        ('f32qk_bf16v_headline', (4, 8, 2048, 128),\n"
    "         ('float32', 'float32', 'bfloat16'))):\n"
    "    q, k = (c.randn(g, shape, getattr(torch, t)) for t in ts[:2])\n"
    "    dv = 640 if name.endswith('640') else shape[3]\n"
    "    v = c.randn(g, shape[:3] + (dv,), getattr(torch, ts[2]))\n"
    "    r[name + '_ms'] = c.cuda_ms(lambda: fa.flash_attention(q, k, v))\n"
    "    if {one_cta}:\n"
    "        plan = fa.cluster_flash_plan\n"
    "        fa.cluster_flash_plan = lambda d, dv: (1, -(-d // 128), 8)\n"
    "        r[name + '_one_cta_ms'] = c.cuda_ms(\n"
    "            lambda: fa.flash_attention(q, k, v))\n"
    "        fa.cluster_flash_plan = plan\n"
    "    del q, k, v\n"
    "print('AB_RESULT ' + json.dumps(r), flush=True)\n")


def cluster_parts(work: Path, timeout: float) -> int:
    """Each CLUSTER_PARTS copy of the tree (csrc holding the any-dtype
    flash sources alone, so that a copy builds only them) timed at the rows
    of CLUSTER_PARTS_RUN, in its own process; prints one JSON line of
    every copy's ms."""
    source = (ROOT / CLUSTER).read_text()
    results = {}
    for name, edits in CLUSTER_PARTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"cluster part {name}: {old!r} is not in "
                                 f"{CLUSTER} exactly once")
            text = text.replace(old, new)
        tree = copy_tree(work / f"cluster_{name}", text, CLUSTER)
        for cu in (tree / CLUSTER).parent.glob("*.cu"):
            if not cu.name.startswith("cluster_flash"):
                cu.unlink()
        rc, out = run(tree, CLUSTER_PARTS_RUN.format(
            one_cta=name == "as_is"), timeout)
        print(f"== {name} (exit {rc})", flush=True)
        if rc != 0 or "AB_RESULT " not in out:
            print(out[-3000:], flush=True)
            return 1
        results[name] = json.loads(out.split("AB_RESULT ", 1)[1]
                                   .splitlines()[0])
        print(json.dumps(results[name]), flush=True)
    print(json.dumps({"cluster_parts": results}), flush=True)
    return 0


F32_SPLITS_SWEEP = (1, 2, 3, 4, 6)


# stream-parts: copies of the any-dtype decode kernel (stream_decode.cu)
# that leave one phase of a tile out (S, the softmax, P V, or all three:
# the ring alone), timed, never checked, beside the kernel as it is.
STREAM_PARTS = {
    "as_is": [],
    "no_s": [("    for (int kk = warp; kk < n; kk += kConsumers) {",
              "    for (int kk = warp; kk < 0; kk += kConsumers) {"),
             ("      for (int base = warp * per_warp; base < n;",
              "      for (int base = warp * per_warp; base < 0;")],
    "no_softmax": [("    if (warp < rows) {\n      float mx = -CUDART_INF_F;",
                    "    if (warp < 0) {\n      float mx = -CUDART_INF_F;")],
    "no_pv": [("g < kg && qd < nq;", "g < 0 && qd < nq;")],
}
STREAM_PARTS["ring_alone"] = [e for name in ("no_s", "no_softmax", "no_pv")
                              for e in STREAM_PARTS[name]]
# The element variant (rows not whole 16-byte chunks or a cache off 16
# bytes) with one 16-byte chunk of a row a lane in S (up to 32 lanes a key)
# instead of about two, timed beside the kernel as it is.
STREAM_PARTS["one_chunk_a_lane"] = [
    ("while (lanes < 32 && 2 * lanes < chunks) lanes *= 2;",
     "while (lanes < 32 && lanes < chunks) lanes *= 2;")]
STREAM_PARTS_RUN = (
    "import json, numpy as np, torch, chip_smoke as c\n"
    "from k8s_dra_driver_tpu_torch.compute import flashattention as fa\n"
    "dev = torch.device('cuda', 0)\n"
    "g = torch.Generator(device=dev).manual_seed(0)\n"
    "lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0)))"
    ".to(dev)\n"
    "r = {{}}\n"
    "def placed(t, offset):\n"
    "    if not offset:\n"
    "        return t\n"
    "    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)\n"
    "    flat[1:] = t.reshape(-1)\n"
    "    return flat[1:].view(t.shape)\n"
    "for name, heads, d, dv, ts, offset in (\n"
    "        ('bf16_1024', 4, 1024, 1024, ('bfloat16',) * 3, False),\n"
    "        ('f32_1024', 4, 1024, 1024, ('float32',) * 3, False),\n"
    "        ('bf16_64_640', 8, 64, 640, ('bfloat16',) * 3, False),\n"
    "        ('f32qk_bf16v_serve', c.HEADS, c.HEAD_DIM, c.HEAD_DIM,\n"
    "         ('float32', 'float32', 'bfloat16'), False),\n"
    "        ('bf16_d66', c.HEADS, 66, 66, ('bfloat16',) * 3, False),\n"
    "        ('bf16_serve_off16', c.HEADS, c.HEAD_DIM, c.HEAD_DIM,\n"
    "         ('bfloat16',) * 3, True)):\n"
    "    dt = [getattr(torch, t) for t in ts]\n"
    "    q = c.randn(g, (c.BATCH, heads, 1, d), dt[0])\n"
    "    k = placed(c.randn(g, (c.BATCH, heads, c.KV_CAP, d), dt[1]), offset)\n"
    "    v = placed(c.randn(g, (c.BATCH, heads, c.KV_CAP, dv), dt[2]),\n"
    "               offset)\n"
    "    r[name + '_ms'] = c.cuda_ms(\n"
    "        lambda: fa.flash_attention_decode(q, k, v, lens))\n"
    "    del q, k, v\n"
    "print('AB_RESULT ' + json.dumps(r), flush=True)\n")


def stream_parts(work: Path, timeout: float) -> int:
    """Each STREAM_PARTS copy of the tree (csrc holding the any-dtype
    decode source alone) timed at the rows of STREAM_PARTS_RUN, in its own
    process; prints one JSON line of every copy's ms."""
    source = (ROOT / STREAM).read_text()
    results = {}
    for name, edits in STREAM_PARTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"stream part {name}: {old!r} is not in "
                                 f"{STREAM} exactly once")
            text = text.replace(old, new)
        tree = copy_tree(work / f"stream_{name}", text, STREAM)
        for cu in (tree / STREAM).parent.glob("*.cu"):
            if cu.name != STREAM.name:
                cu.unlink()
        rc, out = run(tree, STREAM_PARTS_RUN.format(), timeout)
        print(f"== {name} (exit {rc})", flush=True)
        if rc != 0 or "AB_RESULT " not in out:
            print(out[-3000:], flush=True)
            return 1
        results[name] = json.loads(out.split("AB_RESULT ", 1)[1]
                                   .splitlines()[0])
        print(json.dumps(results[name]), flush=True)
    print(json.dumps({"stream_parts": results}), flush=True)
    return 0


STREAM_WAVES_SWEEP = tuple((w, two) for two in (True, False)
                           for w in (1, 2, 4))


def stream_splits() -> int:
    """The any-dtype decode kernel at each (STREAM_WAVES, two blocks an SM)
    of STREAM_WAVES_SWEEP (the blocks a slot its split count aims for; the
    tile that fits two blocks an SM, or one): ms a call, the tile and the
    split count of bf16 and f32 at 1,024/1,024 (q [32, 4, 1,
    1024]), bf16 at 64/640 and an f32 q and K over a bf16 V at the serve
    shape, each against the smoke's cache and lengths."""
    import numpy as np
    import torch

    import chip_smoke as c
    from k8s_dra_driver_tpu_torch.compute import flashattention as fa

    card = c.phase_device()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0))).to(
        dev)
    rows = []
    for name, heads, d, dv, ts in (
            ("bf16_1024", 4, 1024, 1024, ("bfloat16",) * 3),
            ("f32_1024", 4, 1024, 1024, ("float32",) * 3),
            ("bf16_64_640", 8, 64, 640, ("bfloat16",) * 3),
            ("f32qk_bf16v_serve", c.HEADS, c.HEAD_DIM, c.HEAD_DIM,
             ("float32", "float32", "bfloat16"))):
        dt = [getattr(torch, t) for t in ts]
        q = c.randn(gen, (c.BATCH, heads, 1, d), dt[0])
        k = c.randn(gen, (c.BATCH, heads, c.KV_CAP, d), dt[1])
        v = c.randn(gen, (c.BATCH, heads, c.KV_CAP, dv), dt[2])
        two = fa.STREAM_SMEM_TWO
        for waves, two_blocks in STREAM_WAVES_SWEEP:
            fa.STREAM_WAVES = waves
            fa.STREAM_SMEM_TWO = two if two_blocks else 0
            fa.stream_decode_plan.cache_clear()
            plan = fa.stream_decode_plan(c.BATCH, heads, 1, c.KV_CAP, d, dv,
                                         dt[1].itemsize, dt[2].itemsize, sms)
            ms = c.cuda_ms(lambda: fa.flash_attention_decode(q, k, v, lens))
            row = {"row": name, "waves": waves,
                   "two_blocks_an_sm": two_blocks, "rows": plan[0],
                   "tile": plan[1], "splits": plan[2], "ms": ms}
            print("[stream-splits] " + " ".join(
                f"{key}={val}" for key, val in row.items()), flush=True)
            rows.append(row)
        fa.STREAM_SMEM_TWO = two
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"stream_splits": rows, "card": card}), flush=True)
    return 0


def f32_splits() -> int:
    """The f32 absorbed-MLA decode at each F32_BLOCKS_PER_SM of
    F32_SPLITS_SWEEP: ms a call and the split count."""
    import numpy as np
    import torch

    import chip_smoke as c
    from k8s_dra_driver_tpu_torch.compute import flashattention as fa

    card = c.phase_device()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    lens = torch.from_numpy(c.smoke_lengths(np.random.default_rng(0))).to(
        dev)
    rows = []
    for ql in (c.MLA_ROWS, 1):
        q = c.randn(gen, (c.BATCH, 1, ql, c.MLA_D), torch.float32)
        k = c.randn(gen, (c.BATCH, 1, c.KV_CAP, c.MLA_D), torch.float32)
        v = c.randn(gen, (c.BATCH, 1, c.KV_CAP, c.MLA_DV), torch.float32)
        for bps in F32_SPLITS_SWEEP:
            fa.F32_BLOCKS_PER_SM = bps
            splits = fa.f32_decode_splits(c.BATCH, 1, ql, c.KV_CAP,
                                          c.MLA_DV, sms)
            ms = c.cuda_ms(lambda: fa.flash_attention_decode(q, k, v, lens))
            row = {"ql": ql, "blocks_per_sm": bps, "splits": splits[0],
                   "split_keys": splits[1], "ms": ms}
            print("[f32-splits] " + " ".join(f"{n}={x}" for n, x in
                                              row.items()), flush=True)
            rows.append(row)
        del q, k, v
    print(json.dumps({"f32_splits": rows, "card": card}), flush=True)
    return 0


def wide_parts(work: Path, timeout: float) -> int:
    source = (ROOT / WIDE).read_text()
    turns = []
    for name, edits in WIDE_PARTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"wide part {name}: {old!r} is not in "
                                 f"{WIDE} exactly once")
            text = text.replace(old, new)
        tree = copy_tree(work / name, text, WIDE)
        splits = WIDE_SPLITS if name == "this_tree" else WIDE_SPLITS[:1]
        rc, out = run(tree, WIDE_PARTS_RUN.format(splits=splits), timeout)
        if rc != 0 or "AB_RESULT " not in out:
            print(f"== wide part {name}: exit {rc}\n{out[-4000:]}",
                  flush=True)
            return 1
        result = json.loads(out.split("AB_RESULT ", 1)[1].splitlines()[0])
        print(f"[wide-parts] part={name} " + " ".join(
            f"{k}={v}" for k, v in result.items() if k != "card"),
            flush=True)
        turns.append({"part": name, **result})
    print(json.dumps({"wide_parts": turns}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("versions", "controls", "serve",
                                     "serve-scale", "decode", "wire", "flash32", "f32",
                                     "mixed", "host",
                                     "decode-keys", "wide-parts",
                                     "ring-variants", "general",
                                     "f32-splits", "cluster-parts",
                                     "stream-splits", "stream-parts",
                                     "tc-flash", "perwarp"))
    ap.add_argument("sources", nargs="*",
                    help="other flash_attention.cu files (versions), "
                         "the other tree's directory (serve, decode, "
                         "flash32, f32; decode-keys, optional), or "
                         "controls' "
                         "names (controls, optional)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="serve, decode, flash32, f32, decode-keys: "
                         "rounds of "
                         "other, this, this, other")
    ap.add_argument("--work", type=Path, default=ROOT / "chipcopy" / "ab",
                    help="where the copies go (a directory .gitignore "
                         "lists)")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds a turn may take")
    ap.add_argument("--writers", default="3,6,12,16",
                    help="wire: status-writer counts, comma-separated")
    ap.add_argument("--cycles", type=int, default=160,
                    help="wire: claims timed per arm")
    args = ap.parse_args(argv)
    if args.mode == "wire":
        return wire([int(w) for w in args.writers.split(",")],
                    args.cycles, args.timeout)
    if args.mode == "decode-keys":
        if len(args.sources) > 1:
            ap.error("decode-keys takes at most one other tree")
        return decode_keys(Path(args.sources[0]) if args.sources else None,
                           args.rounds, args.timeout)
    if args.mode == "general":
        if len(args.sources) > 1:
            ap.error("general takes at most one other tree")
        return (general_ab(Path(args.sources[0]), args.rounds, args.timeout)
                if args.sources else general())
    if args.mode == "perwarp":
        if len(args.sources) > 1:
            ap.error("perwarp takes at most one other tree")
        return (perwarp_ab(Path(args.sources[0]), args.rounds, args.timeout)
                if args.sources else perwarp())
    if args.mode == "f32-splits":
        return f32_splits()
    if args.mode == "cluster-parts":
        return cluster_parts(args.work, args.timeout)
    if args.mode == "stream-splits":
        return stream_splits()
    if args.mode == "stream-parts":
        return stream_parts(args.work, args.timeout)
    if args.mode == "ring-variants":
        return ring_variants(args.work, args.timeout)
    if args.mode == "wide-parts":
        return wide_parts(args.work, args.timeout)
    if args.mode == "versions":
        if not args.sources:
            ap.error("versions needs at least one other source")
        return versions(args.sources, args.work, args.timeout)
    if args.mode in TREE_MODES:
        if len(args.sources) != 1:
            ap.error(f"{args.mode} needs the other tree's directory")
        return trees(args.mode, Path(args.sources[0]), args.rounds,
                     args.timeout)
    return controls(args.sources, args.work, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
