"""Run one cell of BENCHMARK.json and print its result as one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for. With ``--trace 0`` the line's metrics are the cell's end-to-end
metrics; with ``--trace 1`` its per-layer metrics, read from a device
trace of a steady sub-window. ``--control tf32`` runs the correctness
control (the reference at TF32 in the place of the engine's attend),
which must come out not correct. The numbers that decide ``correct`` are
printed with their limits as the last lines on standard error and under
the line's last key, ``checks``.

Exits non-zero and prints no result without CUDA or with fewer devices
than the cell asks for, and when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def process_start() -> float:
    """The monotonic time at which this process started (from
    ``/proc/self/stat``), else now."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, age)


T_START = process_start()

#: Top-level module names that must not be loaded when the result is due.
FORBIDDEN = ("jax", "jaxlib", "flax", "k8s_dra_driver_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules`` (compared whole)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    from perfbench.reference import CONTROLS
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=tuple(CONTROLS), default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from perfbench.manifest import Bench
    bench = Bench()
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"CUDA available: {torch.cuda.is_available()}, devices: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from perfbench.harness import run_cell
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[check] {name}={c['value']} limit={c['limit']}",
              file=sys.stderr)
    print(f"[check] correct={result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
