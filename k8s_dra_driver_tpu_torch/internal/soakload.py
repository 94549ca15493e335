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
files of their own (``--writer-mib`` each, 4 by default) in that same
directory until the round ends, so that the soaks' durable writes wait
behind theirs. The directory goes with the round;
nothing outside it is touched.

``--pytest ARGS`` runs a selection of the repo's tests instead of the soak:
each of the ``--runs`` processes of a round is one ``python -m pytest ARGS``
(ARGS split as a shell would), with its temporary trees in the round's
directory, beside the same hogs and writers. Each run is read from its JUnit
report; the summary tallies the failed runs by test id:

    python -m k8s_dra_driver_tpu_torch.internal.soakload --runs 8 --hogs 0 \\
        --disk-writers 4 --writer-mib 128 --rounds 3 \\
        --pytest "tests/test_torch_remediation.py -k 'Reallocation or Drain'"
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

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


# One disk writer: a file of the given MiB (4 by default), fsynced and
# renamed over the last, in the directory it is given, until it is killed.
_WRITER = """
import os, sys
d, block, i = sys.argv[1], b"\\0" * (1 << 20), 0
mib = int(sys.argv[2]) if len(sys.argv) > 2 else 4
while True:
    path = os.path.join(d, f"w{os.getpid()}-{i % 4}")
    with open(path + ".tmp", "wb") as f:
        for _ in range(mib):
            f.write(block)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)
    i += 1
"""


def _pytest_command(pytest_args: list[str], report: str) -> list[str]:
    """One run of a test selection, alone in its process, reported to
    ``report`` as JUnit XML."""
    return [sys.executable, "-m", "pytest", *pytest_args, "-q",
            "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
            f"--junitxml={report}"]


def _pytest_verdict(rc: int, out: str, report: str) -> dict:
    """A pytest run's verdict from its JUnit report: ``ok`` when every
    test passed, ``FAIL`` with the ids and first message lines of the
    failed tests, ``crashed`` when the run left no report."""
    try:
        root = ET.parse(report).getroot()
    except (OSError, ET.ParseError):
        return {"result": "crashed", "failed": [], "detail": out[-2000:]}
    failed, lines, passed = [], [], 0
    for case in root.iter("testcase"):
        bad = case.find("failure")
        if bad is None:
            bad = case.find("error")
        if bad is None:
            passed += case.find("skipped") is None
            continue
        test_id = f"{case.get('classname', '')}::{case.get('name', '')}"
        failed.append(test_id)
        lines.append(f"{test_id}: {(bad.get('message') or '')[:300]}")
    result = "ok" if rc == 0 and not failed and passed else "FAIL"
    detail = "\n".join(lines) if lines else ("" if result == "ok"
                                              else out[-2000:])
    return {"result": result, "failed": failed, "detail": detail}


def run_round(runs: int, hogs: int, timeout: float,
              disk_writers: int = 0,
              pytest_args: list[str] | None = None,
              writer_mib: int = 4) -> list[dict]:
    """One round: the soaks (or, with ``pytest_args``, runs of that test
    selection) beside the hogs and the disk writers; each run's verdict."""
    tmp = tempfile.mkdtemp(prefix="soakload-")
    spinners = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(hogs)]
    spinners += [subprocess.Popen([sys.executable, "-c", _WRITER, tmp,
                                   str(writer_mib)])
                 for _ in range(disk_writers)]
    try:
        # The runs' temporary trees go under the round's directory, on
        # the disk the writers load.
        env = {**os.environ, "TMPDIR": tmp}
        reports = [os.path.join(tmp, f"run-{i}.xml") for i in range(runs)]
        commands = [_pytest_command(pytest_args, reports[i])
                    if pytest_args is not None
                    else [sys.executable, "-c", _SOAK] for i in range(runs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env)
                 for cmd in commands]
        verdicts = []
        for proc, report in zip(procs, reports):
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                verdicts.append({"result": "timeout", "failed": [],
                                 "detail": out[-2000:]})
                continue
            if pytest_args is not None:
                verdicts.append(_pytest_verdict(proc.returncode, out, report))
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
    ap.add_argument("--writer-mib", type=int, default=4,
                    help="MiB each disk writer writes and fsyncs a file")
    ap.add_argument("--pytest", metavar="ARGS", default=None,
                    help="run this pytest selection (node ids, -k ...) in "
                         "each process instead of the soak")
    args = ap.parse_args(argv)
    pytest_args = shlex.split(args.pytest) if args.pytest else None
    counts: dict[str, int] = {}
    by_test: dict[str, int] = {}
    for rnd in range(args.rounds):
        for i, v in enumerate(run_round(args.runs, args.hogs, args.timeout,
                                        args.disk_writers, pytest_args,
                                        args.writer_mib)):
            counts[v["result"]] = counts.get(v["result"], 0) + 1
            for test_id in v.get("failed", ()):
                by_test[test_id] = by_test.get(test_id, 0) + 1
            print(f"round={rnd} run={i} result={v['result']}", flush=True)
            if v["result"] != "ok":
                print(v["detail"], flush=True)
    summary = {"runs": args.runs, "hogs": args.hogs,
               "disk_writers": args.disk_writers, "rounds": args.rounds,
               **counts}
    if args.writer_mib != 4:
        summary["writer_mib"] = args.writer_mib
    if pytest_args is not None:
        summary["pytest"] = args.pytest
        summary["failed_tests"] = dict(sorted(by_test.items()))
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0 if set(counts) == {"ok"} else 1


if __name__ == "__main__":
    sys.exit(main())
