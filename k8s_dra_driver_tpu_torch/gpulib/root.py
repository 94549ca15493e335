"""Driver-root resolution: locate NVIDIA userspace artifacts under a
configurable root.

Copied from the JAX package's ``tpulib/root.py`` (the analogue of the
reference's ``cmd/gpu-kubelet-plugin/root.go``: findFile over
librarySearchPaths, dev-root detection): when the plugin runs
containerized with the host filesystem bind-mounted at some prefix, host
artifacts must be resolved under that prefix, not the container's own
``/``. The artifact this package looks for is the driver's NVML library,
``libnvidia-ml.so.1``, which the device library loads through ctypes when
the host has it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

#: directories searched for bare library files (root.go librarySearchPaths)
LIB_SEARCH_PATHS = [
    "/lib",
    "/usr/lib",
    "/lib64",
    "/usr/lib64",
    "/usr/lib/x86_64-linux-gnu",
    "/usr/lib/aarch64-linux-gnu",
    "/usr/local/lib",
]

#: soname of the driver's NVML library
LIBNVIDIA_ML = "libnvidia-ml.so.1"

ENV_DRIVER_ROOT = "GPU_DRA_DRIVER_ROOT"
# Where the mounted root actually LIVES on the host (the chart's
# kubeletPlugin.driverRoot value): /host in the plugin may be host
# /run/nvidia/driver.
ENV_DRIVER_ROOT_HOST_PREFIX = "GPU_DRA_DRIVER_ROOT_HOST_PREFIX"


class Root:
    """One filesystem root as the plugin sees it, plus where that root
    lives on the HOST (``host_prefix``): a containerized plugin mounting
    host ``/run/nvidia/driver`` at ``/host`` uses
    ``Root("/host", "/run/nvidia/driver")`` so
    paths it finds translate back to real host paths for CDI."""

    def __init__(self, path: str = "/", host_prefix: str = "/"):
        self.path = Path(path or "/")
        self.host_prefix = Path(host_prefix or "/")

    def __repr__(self) -> str:
        return f"Root({str(self.path)!r}, host_prefix={str(self.host_prefix)!r})"

    def find_file(self, name: str, *search_paths: str) -> Optional[str]:
        """First existing ``<root><search_path>/<name>``; None if absent."""
        for sp in search_paths:
            cand = self.path / sp.lstrip("/") / name
            if cand.is_file() or cand.is_symlink():
                return str(cand)
        return None

    def find_libnvidia_ml(self) -> Optional[str]:
        """Path of ``libnvidia-ml.so.1`` under this root, or None."""
        return self.find_file(LIBNVIDIA_ML, *LIB_SEARCH_PATHS)

    def is_dev_root(self) -> bool:
        """A dev root carries a /dev directory (root.go isDevRoot)."""
        return (self.path / "dev").is_dir()

    def host_path(self, found: str) -> str:
        """Plugin-view path under this root → HOST-view path.

        CDI hostPath entries are resolved by the container runtime on the
        HOST, so the plugin's mount prefix is swapped for the root's real
        host location: with ``Root("/host", "/run/nvidia/driver")``, a found
        ``/host/lib/libnvidia-ml.so.1`` emits
        ``/run/nvidia/driver/lib/libnvidia-ml.so.1``. Paths
        outside the root pass through unchanged."""
        if self.path == self.host_prefix:
            return found
        try:
            rel = Path(found).relative_to(self.path)
        except ValueError:
            return found
        return str(self.host_prefix / rel)


def resolve_driver_root(env: Optional[dict] = None) -> Root:
    """The root the plugin should resolve host artifacts under:
    ``GPU_DRA_DRIVER_ROOT`` (the in-container mount point, e.g. ``/host``)
    plus ``GPU_DRA_DRIVER_ROOT_HOST_PREFIX`` (where that mount came from on
    the host — defaults to ``/``); both default to ``/`` when running
    directly on the host."""
    e = os.environ if env is None else env
    return Root(e.get(ENV_DRIVER_ROOT, "/") or "/",
                e.get(ENV_DRIVER_ROOT_HOST_PREFIX, "/") or "/")
