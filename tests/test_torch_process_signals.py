"""A binary's SIGTERM taken by a thread other than its main thread.

The kernel delivers a process-directed signal to any of its threads that
does not block it. Python runs the handler only in the main thread,
between bytecodes; a main thread parked in an untimed wait is woken only by
a signal delivered to it, so a SIGTERM that another thread took left
``block_until_signaled`` parked for good: the process never stopped and
kept its shard lease (``tests/test_torch_runnable.py::
test_controller_with_one_shard_starts_and_stops`` under six test workers;
2 of 72 controller processes started beside 16 busy loops on an 8-core
machine hung that way, the stack dump showing the main thread in the
wait). ``block_until_signaled`` now waits in slices. Each case sends the
signal to a thread of the process's own choosing (``pthread_kill``,
``tgkill``) so that the delivery the kernel chose at random is made every
time.
"""

from __future__ import annotations

import ctypes
import os
import platform
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from k8s_dra_driver_tpu_torch.k8sclient.httpapi import ApiServer, HttpClient

REPO = str(Path(__file__).resolve().parent.parent)
CONTROLLER = "k8s_dra_driver_tpu_torch.plugins.compute_domain_controller"

# A process parked in block_until_signaled whose helper thread sends
# SIGTERM to itself: the handler must still run and the handle stop.
_PROBE = """
import signal, sys, threading, time
from k8s_dra_driver_tpu_torch.pkg.process import (
    ProcessHandle, block_until_signaled)
handle = ProcessHandle("probe")
handle.on_stop(lambda: print("STOPPED", flush=True))
def other():
    time.sleep(0.5)
    signal.pthread_kill(threading.get_ident(), signal.SIGTERM)
threading.Thread(target=other, daemon=True).start()
block_until_signaled(handle)
print("RETURNED", flush=True)
"""

# tgkill(2): a signal to one thread of another process.
_TGKILL = {"x86_64": 234, "aarch64": 131}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    for k in list(env):
        if k.startswith("GPU_DRA_") or k == "NODE_NAME":
            del env[k]
    return env


def test_a_sigterm_taken_by_another_thread_stops_the_handle():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["STOPPED", "RETURNED"]


def _tgkill(pid: int, tid: int, sig: int) -> None:
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.syscall(_TGKILL[platform.machine()], pid, tid, sig) != 0:
        raise OSError(ctypes.get_errno(), f"tgkill {pid} {tid}")


@pytest.mark.skipif(platform.machine() not in _TGKILL
                    or not os.path.isdir("/proc/self/task"),
                    reason="needs Linux tgkill and /proc/<pid>/task")
def test_controller_stops_on_a_sigterm_to_a_worker_thread():
    """The one-shard controller as an OS process, as the runnable test
    starts it; once it holds its lease, SIGTERM goes to one of its worker
    threads: it must exit 0 and empty the lease."""
    server = ApiServer().start()
    client = HttpClient(server.endpoint)

    def holder():
        lease = client.try_get("Lease", "controller-shard-0", "default")
        return (lease or {}).get("spec", {}).get("holderIdentity")

    proc = subprocess.Popen(
        [sys.executable, "-m", CONTROLLER, "--api-endpoint",
         server.endpoint, "--metrics-port", "-1", "--shards", "1",
         "--identity", "solo"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=REPO,
        env=_env())
    try:
        deadline = time.time() + 30
        while time.time() < deadline and holder() != "solo":
            time.sleep(0.05)
        assert holder() == "solo"
        workers = [int(t) for t in os.listdir(f"/proc/{proc.pid}/task")
                   if int(t) != proc.pid]
        assert workers
        _tgkill(proc.pid, workers[-1], signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
        assert holder() == ""
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        server.stop()
