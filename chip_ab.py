#!/usr/bin/env python3
"""Compare versions of the flash-attention kernel on one card, run the
kernel's mutation controls, and compare the serve phase of two trees.

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_ab.py versions OTHER.cu [OTHER.cu ...]
    python3 chip_ab.py controls
    python3 chip_ab.py serve OTHER_TREE [--rounds N]
    python3 chip_ab.py decode OTHER_TREE [--rounds N]
    python3 chip_ab.py wire [--writers 3,6,12,16] [--cycles N]
    python3 chip_ab.py flash32 OTHER_TREE [--rounds N]
    python3 chip_ab.py decode-keys

``versions`` copies the port (``chip_smoke.py`` and
``k8s_dra_driver_tpu_torch/``) once per source under ``--work``, puts the
given ``csrc/flash_attention.cu`` in each copy (the tree's own source is the
last version), and runs ``chip_smoke``'s bench phase in each copy, in turn,
in its own process: the versions in order, then in reverse (A, B, B, A for
one other source), so that every version is timed by the same Python code
and the same timing method. It prints each turn's bench rows, then one
JSON line of every turn with the card's name and power limit.

``controls`` makes two broken copies of the tree's kernel and runs
``chip_smoke``'s flash check in each; both must fail it. The first scales
the bf16 kernel's softmax scale by 1.01, the second drops the last key tile
of the non-causal walk. It exits non-zero if a control passes.

``serve`` runs ``chip_smoke``'s serve phase (48 requests from 4 tenants at
one Llama-2-7B attention layer) in OTHER_TREE (a directory holding another
checkout's ``chip_smoke.py`` and ``k8s_dra_driver_tpu_torch/``, e.g. from
``git archive``) and in this tree, each turn in its own process, in the
order other, this, this, other, ``--rounds`` times; both trees' serve
phases start from a ResourceClaim on the GPU that ``phase_enumerate``
finds. It prints each turn's serve line, then one JSON line
of every turn's decode tokens/s and step p50/p99 with the card's name and
power limit.

``decode`` does the same with ``chip_smoke``'s build and timing phases:
each turn builds its tree's kernels (printing each decode kernel's
registers) and times its decode kernel at the smoke's width, beside the
plain version and the library call; the JSON line holds every turn's
times and decode kernels' registers.

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

``decode-keys`` times one decode launch with every sequence at the full
4096-token cache (32 sequences, one head) for each of DECODE_KEY_CASES,
tuned and general kernels, 8 query rows and 1, and prints the time per
key of one block: what bounds a kernel whose grid is b * h blocks when
b * h is small.
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
CONTROLS = {
    "softmax_scale_x1.01": ("scale * 1.4426950408889634f, causal);",
                            "scale * 1.01f * 1.4426950408889634f, causal);"),
    "last_key_tile_dropped": ("/ kN)\n                : n_tiles;",
                              "/ kN)\n                : n_tiles - 1;"),
}
# A version's library is built at its first call, in the bench's warm-up
# (phase_build would hold every version to the tree's SASS requirements).
BENCH = ("import json, chip_smoke as c; card = c.phase_device(); "
         "r = c.phase_flash_bench(0); "
         "print('AB_RESULT ' + json.dumps({**r, 'card': card}))")
CHECK = ("import chip_smoke as c; c.phase_device(); c.phase_build(); "
         "c.phase_flash_check(0)")
SERVE = ("import chip_smoke as c; card = c.phase_device(); "
         "print('AB_CARD ' + card); "
         "c.phase_serve(0, **c.phase_enumerate())")
SERVE_KEYS = ("decode_tok_s", "step_ms_p50", "step_ms_p99", "steps",
              "kernel_launches", "claim_ready_ms", "ttfb_ms")
DECODE = ("import numpy as np, chip_smoke as c; card = c.phase_device(); "
          "print('AB_CARD ' + card); c.phase_build(); "
          "rng = np.random.default_rng(0); "
          "c.phase_timing(rng, *c.smoke_inputs(rng))")
DECODE_KEYS = ("kernel_ms", "plain_ms", "library_ms", "bound_ms")
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
# What each mode runs in a tree, and the lines of its output it keeps.
TREE_MODES = {
    "serve": (SERVE, lambda ln: ln.startswith("[serve] submitted="),
              SERVE_KEYS),
    "decode": (DECODE, lambda ln: ln.startswith("[timing]") or (
        ln.startswith("[build] kernel=decode")), DECODE_KEYS),
    "flash32": (FLASH32, lambda ln: ln.startswith("[flash32]"),
                ("ms", "err_over_limit")),
}
# decode-keys: (name, query rows, q's dtype, d, dv); K and V in bf16, so
# an f32 q takes the general kernel at d = 128.
DECODE_KEY_CASES = (
    ("tuned_rows8_d128", 8, "bfloat16", 128, 128),
    ("tuned_rows1_d128", 1, "bfloat16", 128, 128),
    ("general_rows8_d128_f32q", 8, "float32", 128, 128),
    ("general_rows1_d128_f32q", 1, "float32", 128, 128),
    ("general_rows8_mla", 8, "bfloat16", 576, 512),
    ("general_rows1_mla", 1, "bfloat16", 576, 512),
)


def copy_tree(dest: Path, kernel_source: str) -> Path:
    """The port, with ``kernel_source`` as its flash kernel, at ``dest``."""
    if dest.exists():
        shutil.rmtree(dest)
    dest.mkdir(parents=True)
    shutil.copy2(ROOT / "chip_smoke.py", dest / "chip_smoke.py")
    shutil.copytree(ROOT / "k8s_dra_driver_tpu_torch",
                    dest / "k8s_dra_driver_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    (dest / KERNEL).write_text(kernel_source)
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


def controls(work: Path, timeout: float) -> int:
    source = (ROOT / KERNEL).read_text()
    passed = []
    for name, (old, new) in CONTROLS.items():
        if source.count(old) != 1:
            raise SystemExit(f"control {name}: {old!r} is not in the kernel "
                             f"source exactly once")
        tree = copy_tree(work / name, source.replace(old, new))
        rc, out = run(tree, CHECK, timeout)
        failed = [ln for ln in out.splitlines() if "FAILED" in ln]
        flash = [ln for ln in out.splitlines() if ln.startswith("[flash]")]
        print(f"== control {name}: exit {rc}", flush=True)
        for ln in flash + failed:
            print(ln, flush=True)
        # A control fails as it should when the flash check rejects it.
        if rc <= 0 or not any("FAILED: flash" in ln for ln in failed):
            passed.append(name)
    if passed:
        print(f"controls the flash check did not reject: {passed}")
        return 1
    print("every control failed the flash check")
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
        fields = dict(re.findall(r"(\w+)=(\{[^}]*\}|\S+)", lines[-1]))
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


def decode_keys() -> int:
    """One decode launch per case of DECODE_KEY_CASES at a full cache:
    ms per launch and microseconds per key of one block."""
    import torch

    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute.flashattention import (
        flash_attention_decode,
    )

    card = chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cap = chip_smoke.KV_CAP
    lens = torch.full((32,), cap, dtype=torch.int32, device=dev)
    rows = []
    for name, ql, qdt, d, dv in DECODE_KEY_CASES:
        q = torch.randn((32, 1, ql, d), generator=gen, device=dev).to(
            getattr(torch, qdt))
        k = torch.randn((32, 1, cap, d), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((32, 1, cap, dv), generator=gen, device=dev).to(
            torch.bfloat16)
        ms = chip_smoke.cuda_ms(
            lambda: flash_attention_decode(q, k, v, lens), runs=10,
            warmup=2)
        rows.append({"case": name, "ms": ms, "us_per_key": ms * 1e3 / cap})
        print(f"[decode-keys] case={name} ms={ms} "
              f"us_per_key={ms * 1e3 / cap}", flush=True)
    print(json.dumps({"decode_keys": rows, "card": card}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("versions", "controls", "serve",
                                     "decode", "wire", "flash32",
                                     "decode-keys"))
    ap.add_argument("sources", nargs="*",
                    help="other flash_attention.cu files (versions), or "
                         "the other tree's directory (serve, decode, "
                         "flash32)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="serve, decode, flash32: rounds of other, this, "
                         "this, other")
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
        return decode_keys()
    if args.mode == "versions":
        if not args.sources:
            ap.error("versions needs at least one other source")
        return versions(args.sources, args.work, args.timeout)
    if args.mode in TREE_MODES:
        if len(args.sources) != 1:
            ap.error(f"{args.mode} needs the other tree's directory")
        return trees(args.mode, Path(args.sources[0]), args.rounds,
                     args.timeout)
    return controls(args.work, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
