"""Build the CUDA C++ kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>.so`` inside the
package, the first time a kernel of it is needed; all stale sources are
compiled in parallel, one ``nvcc`` each. A library is stale when its
``.cu`` or any ``csrc/*.cuh`` header is newer than it. Nothing is built at import, so
machines without ``nvcc`` (the CPU test runs) import every module.

The libraries are loaded with ``ctypes``: a wrapper declares every pointer
and the stream as ``ctypes.c_void_p`` (an undeclared pointer argument is
passed as a 32-bit int and cut), and raises on the non-zero
``cudaError_t`` the C entry returns. ctypes sets no device: the caller
launches under ``torch.cuda.device(...)`` on the tensor's device.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parent.parent
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or failed on a source in csrc/."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Whether ``lib<name>.so`` is missing or older than its ``.cu`` or any
    ``csrc/*.cuh`` (a header may be included by every source)."""
    lib = library_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(built < src.stat().st_mtime for src in sources)


def build_all(force: bool = False) -> dict[str, tuple[float, str]]:
    """Compile every stale ``csrc/*.cu`` (all of them with ``force``), one
    ``nvcc`` process per source, all started together. Returns, for each
    source built, the wall seconds until its build ended and nvcc's output
    (ptxas's register, shared-memory and spill report); raises
    KernelBuildError on a failure."""
    with _lock:
        return _build_locked(force)


def _build_locked(force: bool) -> dict[str, tuple[float, str]]:
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in todo:
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    built = _wait_all(procs, t0)
    for name, (tmp, proc) in procs.items():
        # Each source's seconds are its own nvcc job's (_wait_all).
        log = built[name][1]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        # A loader never sees a half-written library.
        tmp.replace(library_path(name))
        _libs.pop(name, None)
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return built


def _wait_all(procs: dict, t0: float) -> dict[str, tuple[float, str]]:
    """For each of ``procs`` (name -> (tmp path, nvcc process)): the
    seconds from ``t0`` until that process ended, and its output. Each
    process's output is read on a thread of its own, so that a source's
    seconds are not the wait for a slower one read before it."""
    ended: dict[str, tuple[float, str]] = {}

    def drain(name: str, proc: subprocess.Popen) -> None:
        log, _ = proc.communicate()
        ended[name] = (time.monotonic() - t0, log)

    readers = [threading.Thread(target=drain, args=(name, proc), daemon=True)
               for name, (_, proc) in procs.items()]
    for reader in readers:
        reader.start()
    for reader in readers:
        reader.join()
    return ended


def disassemble(name: str) -> str:
    """``cuobjdump -sass`` (the toolkit's, beside nvcc) of ``lib<name>.so``,
    built first if stale."""
    with _lock:
        if _stale(name):
            _build_locked(force=False)
    tool = Path(_nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not (CSRC / f"{name}.cu").exists():
                raise KernelBuildError(f"no kernel source csrc/{name}.cu")
            if _stale(name):
                _build_locked(force=False)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
