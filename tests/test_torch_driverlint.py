"""driverlint's package passes over the GPU port: the concurrency (DL1xx),
growth (DL301) and durability (DL401/DL402) passes that ``tools/lint.py``
runs over the JAX package with no path arguments, here over
``k8s_dra_driver_tpu_torch/``. Nothing may be found beyond the allowlist
below, whose every entry carries the reason the finding is safe and is
still raised (a stale entry fails). ``durability.check_crash_coverage``
reads the JAX package's fault-point registry and is left out."""

import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "k8s_dra_driver_tpu_torch"

sys.path.insert(0, str(ROOT / "tools"))

from analysis import concurrency, durability, growth  # noqa: E402

PASSES = {"concurrency": concurrency, "growth": growth,
          "durability": durability}

_CKPT = "k8s_dra_driver_tpu_torch/plugins/gpu_kubelet_plugin/checkpoint.py"
_PROTOLAB = "k8s_dra_driver_tpu_torch/pkg/protolab.py"
_BUDGET = ("a decrement of a fixed per-actor budget of the explored model, "
           "bounded by its actors")

#: (pass, code, file, ident) → why the finding is safe.
ALLOWLIST = {
    ("concurrency", "DL104", _CKPT,
     "CheckpointManager._commit_pending->write"):
        "the group commit's leader holds leadership across its one batched "
        "write by design (the JAX package's allowlist entry for its "
        "checkpoint)",
    ("concurrency", "DL104", _CKPT,
     "CheckpointManager._read_for_commit->read_cached"):
        "the leader's batch read is part of the commit's critical section "
        "by design (the JAX package's allowlist entry for its checkpoint)",
    ("growth", "DL301", "k8s_dra_driver_tpu_torch/pkg/crashlab.py",
     "CrashEnv.extras"):
        "one scenario run's scratch, dropped with its root when the site's "
        "verdict lands",
    ("growth", "DL301", _PROTOLAB, "_ElectorUniverse.crash_budget"): _BUDGET,
    ("growth", "DL301", _PROTOLAB, "_ElectorUniverse.part_budget"): _BUDGET,
    ("growth", "DL301", _PROTOLAB, "_ShardMapUniverse.crash_budget"): _BUDGET,
    ("growth", "DL301", _PROTOLAB, "_ShardMapUniverse.part_budget"): _BUDGET,
    ("durability", "DL402", "k8s_dra_driver_tpu_torch/compute/_build.py",
     "Path.replace:104"):
        "a kernel library built by nvcc, not driver state: the rename only "
        "keeps a loader from opening half a library, and a crash leaves a "
        "temporary file and no library, which the next call rebuilds",
    ("durability", "DL401", _CKPT, "prepared_claims[...] assignment/del:220"):
        "the V1 -> V2 upgrade-on-read inside the checkpoint module builds a "
        "Checkpoint that is not yet published (the JAX checkpoint's same "
        "line is exempt as the pass's checkpoint owner)",
    ("durability", "DL401", _CKPT, "node_boot_id assignment:289"):
        "bootstrap_checkpoint stamps the boot id at startup inside the "
        "checkpoint module, before any claim is prepared, and publishes it "
        "with the manager's atomic write (the JAX checkpoint's same line is "
        "exempt as the pass's checkpoint owner)",
}


def _findings(name):
    return PASSES[name].analyze_paths([PORT], root=ROOT)


def _key(name, f):
    return (name, f.code, f.file, f.ident)


@pytest.mark.parametrize("name", sorted(PASSES))
def test_nothing_outside_the_allowlist(name):
    found = _findings(name)
    assert [f for f in found if _key(name, f) not in ALLOWLIST] == []
    # Every entry of this pass is still raised, once: none is stale.
    pinned = sorted(k for k in ALLOWLIST if k[0] == name)
    assert sorted(_key(name, f) for f in found) == pinned


def test_every_entry_has_a_reason():
    assert all(len(reason) > 40 for reason in ALLOWLIST.values())


def test_no_unguarded_write_in_the_device_library():
    """``open_health_events`` opens the NVML event session under
    ``_events_mu``, as its closer and the health fold do: two concurrent
    openers share one session instead of leaking one."""
    found = concurrency.analyze_paths([PORT / "gpulib" / "device_lib.py"],
                                      root=ROOT)
    assert [f for f in found if f.code == "DL101"] == []


def test_the_unguarded_open_is_what_the_pass_catches(tmp_path):
    """The opener as it was, unlocked beside a locked closer: DL101."""
    src = tmp_path / "planted_events.py"
    src.write_text(textwrap.dedent('''
        import threading


        class Lib:
            def __init__(self):
                self._events_mu = threading.Lock()
                self._events = None

            def open_health_events(self):
                if self._events is None:
                    self._events = object()
                return self._events

            def close_health_events(self):
                with self._events_mu:
                    self._events = None
    '''))
    found = concurrency.analyze_paths([src], root=ROOT)
    assert [(f.code, f.ident) for f in found] == [
        ("DL101", "Lib._events:open_health_events")]
