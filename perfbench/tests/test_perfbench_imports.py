"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: ``k8s_dra_driver_tpu_torch`` begins with
``k8s_dra_driver_tpu`` and is allowed."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "k8s_dra_driver_tpu"}


def _tops_after(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = f"""
import time
from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
from perfbench.harness import run_cell
from perfbench.manifest import Bench
from perfbench import run, study
lib = MockDeviceLib("h100-8"); uuid = lib.enumerate_gpus()[0].uuid
for cell, trace in (("tiny-backlog", True), ("tiny-poisson", False)):
    r = run_cell(Bench({str(tiny_root)!r}), cell, 5, 0.5, trace,
                 time.monotonic(), device_lib=lib, gpu_uuid=uuid,
                 device="cpu", uuids={{uuid: 0}})
    assert r["correct"], r
print(run.forbidden_modules())
"""
    tops = _tops_after(code)
    assert "k8s_dra_driver_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "k8s_dra_driver_tpu_torch_x", sys)
    assert "k8s_dra_driver_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "k8s_dra_driver_tpu.pkg", sys)
    assert "k8s_dra_driver_tpu" in run.forbidden_modules()


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops_after("import perfbench.reference")
    assert not {t for t in tops if t.startswith("k8s_dra_driver_tpu")}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("module", ["reference.py", "stats.py",
                                    "roofline.py", "generate.py"])
def test_the_yardstick_imports_only_plain_libraries(module):
    tree = ast.parse(open(os.path.join(ROOT, "perfbench", module)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not {n for n in names if n.startswith("k8s_dra")}, names
    assert not names & FORBIDDEN
