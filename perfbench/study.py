"""Repeated runs of one cell, one process after another, and their spread.

    python3 -m perfbench.study --workload <cell> --seeds 11,12,13 \\
        --seconds 20 [--trace 0|1] [--control tf32] [--out FILE]

Runs ``python3 -m perfbench.run`` once per seed, in order, from the root of
the checkout, and appends one JSON object per run to ``--out`` (its exit
code, its seconds, its result line and the last lines of its standard
error). Then prints, for each metric and each number compared, the values
in run order, the median and the spread (the distance between the
quartiles as a share of the median) over the runs, and over the runs after
the first (which, in a fresh checkout, builds the kernels).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from perfbench.reference import CONTROLS
from perfbench.stats import spread

ROOT = Path(__file__).resolve().parent.parent


def one(workload: str, seed: int, seconds: float, trace: int,
        control: str | None, timeout: float) -> dict:
    cmd = [sys.executable, "-m", "perfbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    if control:
        cmd += ["--control", control]
    t = time.monotonic()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x
                    for x in (out, err))
    lines = [ln for ln in out.splitlines() if ln.strip()]
    result = None
    if rc == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            result = None
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "control": control, "rc": rc,
            "wall_s": time.monotonic() - t, "result": result,
            "stderr_tail": err.splitlines()[-40:]}


def summarize(runs: list) -> dict:
    table: dict = {}
    for r in runs:
        res = r["result"] or {}
        for name, m in (res.get("metrics") or {}).items():
            table.setdefault(name, []).append(m["value"])
        for name, c in (res.get("checks") or {}).items():
            table.setdefault(f"check.{name}", []).append(c["value"])
    out = {}
    for name, vals in table.items():
        nums = [v for v in vals if isinstance(v, (int, float))]
        out[name] = {"values": vals,
                     "median": statistics.median(nums) if nums else None,
                     "max": max(nums) if nums else None,
                     "spread": spread(nums),
                     "spread_after_first": spread(nums[1:])}
    out["correct"] = [(r["result"] or {}).get("correct") for r in runs]
    out["rc"] = [r["rc"] for r in runs]
    out["wall_s"] = [round(r["wall_s"], 1) for r in runs]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.study")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=tuple(CONTROLS), default=None)
    p.add_argument("--timeout", type=float, default=1200.0)
    p.add_argument("--out", default=None,
                   help="JSON lines file to append each run to")
    args = p.parse_args(argv)
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        r = one(args.workload, seed, args.seconds, args.trace, args.control,
                args.timeout)
        runs.append(r)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
        print(json.dumps({k: r[k] for k in ("workload", "seed", "trace",
                                             "control", "rc", "wall_s")}
                         | {"result": r["result"]}), flush=True)
        if r["rc"] != 0:
            print("\n".join(r["stderr_tail"]), file=sys.stderr, flush=True)
    print(json.dumps({"workload": args.workload, "trace": args.trace,
                      "control": args.control,
                      "summary": summarize(runs)}), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
