#!/usr/bin/env python3
"""Compare versions of the flash-attention kernel on one card, and run the
kernel's mutation controls.

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_ab.py versions OTHER.cu [OTHER.cu ...]
    python3 chip_ab.py controls

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
"""

from __future__ import annotations

import argparse
import json
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("versions", "controls"))
    ap.add_argument("sources", nargs="*",
                    help="other flash_attention.cu files (versions)")
    ap.add_argument("--work", type=Path, default=ROOT / "chipcopy" / "ab",
                    help="where the copies go (a directory .gitignore "
                         "lists)")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds a turn may take")
    args = ap.parse_args(argv)
    if args.mode == "versions":
        if not args.sources:
            ap.error("versions needs at least one other source")
        return versions(args.sources, args.work, args.timeout)
    return controls(args.work, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
