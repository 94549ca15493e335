"""The GPU port stands alone: no JAX, nothing of the JAX package, no Triton
or kernel build at import.

A subprocess blocks ``jax`` and ``k8s_dra_driver_tpu`` in ``sys.modules``,
imports every module of the port and ``chip_smoke.py``, serves a CPU
engine to completion, runs ``entry(device="cpu")`` and one
``flash_attention`` call on CPU tensors; a source scan finds no such import anywhere in the
port or the smoke script.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "k8s_dra_driver_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "k8s_dra_driver_tpu")

_CHILD = r"""
import pkgutil, sys, time
for name in ("jax", "jaxlib", "k8s_dra_driver_tpu"):
    sys.modules[name] = None          # any import of them now fails
sys.path.insert(0, sys.argv[1])
import k8s_dra_driver_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    __import__(m)
import chip_smoke  # noqa: F401
assert "triton" not in sys.modules, "triton imported at import time"
from k8s_dra_driver_tpu_torch.compute import _build
assert _build._libs == {}, "kernel library loaded at import"
from k8s_dra_driver_tpu_torch.compute.serving import (
    DecodeRequest, ServingEngine, ServingMetrics)
eng = ServingEngine("iso", n_chips=1, metrics=ServingMetrics(), device="cpu",
                    modeled_chip_tok_s=1e9).start()
reqs = [DecodeRequest(rid=f"r{i}", tenant=f"t{i % 2}", prompt_tokens=5,
                      max_new_tokens=3) for i in range(6)]
for r in reqs:
    assert eng.submit(r)
deadline = time.monotonic() + 60
while eng.completed < len(reqs) and time.monotonic() < deadline:
    time.sleep(0.005)
s = eng.drain(timeout=5.0)
assert s["accounted"] and s["completed"] == len(reqs), s
assert eng.kv_isolation_max_err < 1e-4
import torch
from k8s_dra_driver_tpu_torch.compute.flashattention import flash_attention
from k8s_dra_driver_tpu_torch.entry import entry
fn, args = entry(device="cpu")
out = fn(*args)
assert out.shape == (8, 128, 512) and bool(torch.isfinite(out.float()).all())
q = torch.randn(1, 2, 64, 32)
att = flash_attention(q, q, q, causal=True)
assert att.shape == q.shape and flash_attention.launches == 0
assert _build._libs == {}, "kernel library loaded on the CPU path"
print("MODULES", len(mods))
"""


def _sources():
    """The port's Python sources (not its build outputs) and the smoke."""
    return sorted(p for p in PORT.rglob("*.py")
                  if p.relative_to(PORT).parts[0] != "build") \
        + [REPO / "chip_smoke.py"]


def test_port_imports_and_serves_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(REPO)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("MODULES", 1)[1])
    assert n >= 13, proc.stdout


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_level_triton_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert all(n.split(".")[0] != "triton" for n in names), \
                f"{path.name}:{node.lineno} imports triton at import time"
