"""Run the port's node-kill soak under CPU load and report every failure.

    python -m k8s_dra_driver_tpu_torch.internal.soakload --runs 8 --hogs 8 \\
        --rounds 6

Each round starts ``--hogs`` busy-loop processes (one core each) and
``--runs`` soak processes at once. A soak process calls ``run_soak`` with
the arguments of ``tests/test_torch_blackbox.py``'s incident leg
(``TestIncidentLeg``) and applies that test's oracle; a failed run prints
its errors whole, and how often its log refused an overlapping prepare.
The hogs stop at the end of the round. One line per run, then a summary
line: whether the soak's failures depend on load, and which condition
fails.

``--disk-writers N`` adds disk load beside the CPU load: each round's soaks
keep their temporary trees (checkpoints, CDI specs, incident bundles) in a
directory of the round's own, and N writer processes write and ``fsync``
files of their own in that same directory until the round ends, so that the
soaks' durable writes wait behind theirs. The directory goes with the round;
nothing outside it is touched.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

# One soak with the incident leg's arguments and oracle; prints RESULT ok
# or RESULT FAIL and the errors.
_SOAK = """
import json
from k8s_dra_driver_tpu_torch.internal.stresslab import run_soak
r = run_soak(duration_s=6.0, gpu_fault_interval_s=0.8, lease_duration_s=1.2,
             node_kill_at_s=1.2, recovery_slo_s=8.0, blackbox=True)
bb = r["blackbox"]
ok = (r["error_count"] == 0 and not r["leaks"]
      and r["outcomes"]["stuck"] == 0 and bb["resolved"] >= 1
      and bb["timeline_complete"] >= 1 and bb["http_timeline_complete"] >= 1
      and bb["capture_errors"] == 0 and bb["profiler"]["samples"]["burst"] > 0)
print("RESULT", "ok" if ok else "FAIL")
if not ok:
    print(json.dumps({"errors": r["errors"], "leaks": r["leaks"],
                      "outcomes": r["outcomes"], "blackbox": bb},
                     default=str))
"""


# One disk writer: 4 MiB a file, each file fsynced and renamed over the
# last, in the directory it is given, until it is killed.
_WRITER = """
import os, sys
d, block, i = sys.argv[1], b"\\0" * (1 << 20), 0
while True:
    path = os.path.join(d, f"w{os.getpid()}-{i % 4}")
    with open(path + ".tmp", "wb") as f:
        for _ in range(4):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)
    i += 1
"""


def run_round(runs: int, hogs: int, timeout: float,
              disk_writers: int = 0) -> list[dict]:
    """One round: the soaks beside the hogs and the disk writers; each
    soak's verdict."""
    tmp = tempfile.mkdtemp(prefix="soakload-")
    spinners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(hogs)]
    spinners += [subprocess.Popen([sys.executable, "-c", _WRITER, tmp])
                 for _ in range(disk_writers)]
    try:
        # The soaks' temporary trees go under the round's directory, on
        # the disk the writers load.
        env = {**os.environ, "TMPDIR": tmp}
        soaks = [subprocess.Popen([sys.executable, "-c", _SOAK],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env)
                 for _ in range(runs)]
        verdicts = []
        for proc in soaks:
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                verdicts.append({"result": "timeout", "detail": out[-2000:]})
                continue
            lines = out.splitlines()
            result = next((ln.split()[1] for ln in lines
                           if ln.startswith("RESULT ")), "crashed")
            detail = next((ln for ln in lines if ln.startswith("{")),
                          "" if result == "ok" else out[-2000:])
            # A device held by another claim's prepare is logged as a
            # refused overlapping prepare: say how often, and the first.
            refused = [ln for ln in lines if "refusing overlapping" in ln]
            if refused and result != "ok":
                detail += (f"\nrefused overlapping prepares: {len(refused)};"
                           f" first: {refused[0].strip()[:400]}")
            verdicts.append({"result": result, "detail": detail})
        return verdicts
    finally:
        for proc in spinners:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6,
                    help="soak processes a round")
    ap.add_argument("--hogs", type=int, default=4,
                    help="busy-loop processes a round")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=180.0,
                    help="seconds a soak process may take")
    ap.add_argument("--disk-writers", type=int, default=0,
                    help="fsyncing writer processes a round, in the "
                         "directory of the round's soaks")
    args = ap.parse_args(argv)
    counts: dict[str, int] = {}
    for rnd in range(args.rounds):
        for i, v in enumerate(run_round(args.runs, args.hogs, args.timeout,
                                        args.disk_writers)):
            counts[v["result"]] = counts.get(v["result"], 0) + 1
            print(f"round={rnd} run={i} result={v['result']}", flush=True)
            if v["result"] != "ok":
                print(v["detail"], flush=True)
    print("SUMMARY " + json.dumps({"runs": args.runs, "hogs": args.hogs,
                                   "disk_writers": args.disk_writers,
                                   "rounds": args.rounds, **counts}),
          flush=True)
    return 0 if set(counts) == {"ok"} else 1


if __name__ == "__main__":
    sys.exit(main())
