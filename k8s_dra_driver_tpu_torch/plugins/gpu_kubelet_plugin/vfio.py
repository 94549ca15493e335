"""VFIO passthrough: bind/unbind GPU PCI functions to vfio-pci.

Copied from the JAX package's ``plugins/tpu_kubelet_plugin/vfio.py``, the
analogue of the reference's ``VfioPciManager``
(``cmd/gpu-kubelet-plugin/vfio-device.go:138-319``): prepare-time
``driver_override`` + unbind + ``drivers_probe`` rebinding, kernel-module
presence check, IOMMU / iommufd detection, and unprepare-time restoration of
the original driver (``nvidia`` for a GPU). The CDI shape
(``/dev/vfio/<group>`` per device plus one IOMMU API node per claim)
follows ``vfio-cdi.go:28-110``.

Everything operates on a configurable ``sysfs_root`` / ``dev_root`` so the
whole path runs against a materialized fake tree on CPU-only CI (the
mock-nvml pattern) — the kernel's *reaction* to the bind writes is the only
thing the fake tree cannot produce, so it is factored into a swappable
:class:`SysfsKernel` (``FakeVfioKernel`` in ``gpulib.device_lib`` emulates
it for the mock tree).
"""

from __future__ import annotations

import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

VFIO_DRIVER = "vfio-pci"
VFIO_MODULE = "vfio_pci"

IOMMU_BACKEND_LEGACY = "legacy"
IOMMU_BACKEND_IOMMUFD = "iommufd"


class VfioError(RuntimeError):
    """VFIO (un)binding failed; retryable unless stated otherwise."""


class SysfsKernel:
    """The raw sysfs write surface the kernel reacts to.

    On real hardware a write to ``<bdf>/driver/unbind`` makes the kernel
    drop the ``driver`` symlink, and a write to ``drivers_probe`` makes it
    re-match (honoring ``driver_override``). A fake tree has no kernel, so
    tests swap in ``FakeVfioKernel`` which applies the same writes AND
    performs the re-linking the kernel would.
    """

    def __init__(self, sysfs_root: str):
        self.sysfs = Path(sysfs_root)

    def write(self, rel_path: str, value: str) -> None:
        """One sysfs attribute write (no create: sysfs files pre-exist)."""
        path = self.sysfs / rel_path
        try:
            with open(path, "w") as f:
                f.write(value)
        except OSError as e:
            raise VfioError(f"sysfs write {path} <- {value!r} failed: {e}") from e

    def modprobe(self, module: str) -> None:
        try:
            r = subprocess.run(["modprobe", module],
                               capture_output=True, timeout=30)
        except (OSError, subprocess.SubprocessError) as e:
            raise VfioError(f"modprobe {module} failed to run: {e}") from e
        if r.returncode != 0:
            raise VfioError(
                f"modprobe {module} exited {r.returncode}: "
                f"{r.stderr.decode()[:200]}")


class VfioPciManager:
    """Binds/unbinds one PCI function at a time; stateless between calls —
    all state lives in sysfs (and the caller's checkpoint)."""

    def __init__(
        self,
        sysfs_root: str = "/sys",
        dev_root: str = "/dev",
        kernel: Optional[SysfsKernel] = None,
    ):
        self.sysfs = Path(sysfs_root)
        self.dev = Path(dev_root)
        self.kernel = kernel or SysfsKernel(sysfs_root)

    # -- detection ----------------------------------------------------------

    def iommu_enabled(self) -> bool:
        """IOMMU on = /sys/kernel/iommu_groups has at least one group
        (checkIommuEnabled, vfio-device.go:326-339)."""
        groups = self.sysfs / "kernel" / "iommu_groups"
        try:
            next(groups.iterdir())
            return True
        except (OSError, StopIteration):
            return False

    def iommufd_enabled(self) -> bool:
        """iommufd available = /dev/iommu exists (vfio-device.go:341-343)."""
        return (self.dev / "iommu").exists()

    def module_loaded(self) -> bool:
        return (self.sysfs / "module" / VFIO_MODULE).is_dir()

    # -- per-device introspection -------------------------------------------

    def _pci_dir(self, bdf: str) -> Path:
        return self.sysfs / "bus" / "pci" / "devices" / bdf

    def current_driver(self, bdf: str) -> str:
        link = self._pci_dir(bdf) / "driver"
        try:
            return os.path.basename(os.path.realpath(link)) if link.exists() else ""
        except OSError:
            return ""

    def iommu_group(self, bdf: str) -> int:
        link = self._pci_dir(bdf) / "iommu_group"
        try:
            base = os.path.basename(os.path.realpath(link)) if link.exists() else ""
        except OSError:
            base = ""
        return int(base) if base.isdigit() else -1

    def vfio_device_node(self, bdf: str) -> str:
        """Container path of the group cdev the workload opens."""
        grp = self.iommu_group(bdf)
        if grp < 0:
            raise VfioError(f"device {bdf} has no IOMMU group")
        return f"/dev/vfio/{grp}"

    def iommufd_device_node(self, bdf: str) -> str:
        """Per-device iommufd cdev the VMM opens in iommufd mode
        (``vfio-cdi.go:96-106``): the kernel publishes
        ``/sys/bus/pci/devices/<bdf>/vfio-dev/vfio<N>`` once the device is
        vfio-bound with cdev support, naming the ``/dev/vfio/devices/vfio<N>``
        node. The legacy ``/dev/vfio/<group>`` cdev is useless to an iommufd
        consumer (a VMM handed ``/dev/iommu`` cannot open the device through
        the group API), so iommufd-mode claims must inject this node instead.
        Retryable failure when absent: the bind may not have landed yet, or
        the kernel lacks VFIO_DEVICE_CDEV."""
        vdir = self._pci_dir(bdf) / "vfio-dev"
        try:
            names = sorted(p.name for p in vdir.iterdir()
                           if p.name.startswith("vfio"))
        except OSError:
            names = []
        if not names:
            raise VfioError(
                f"device {bdf}: no iommufd cdev under {vdir} (device not "
                "vfio-bound yet, or kernel lacks VFIO device cdev support)")
        return f"/dev/vfio/devices/{names[0]}"

    def iommu_api_node(self, prefer_iommufd: bool) -> str:
        """The claim-wide IOMMU API node (GetCommonEdits, vfio-cdi.go:52-79):
        /dev/iommu when iommufd is preferred AND supported, else the legacy
        /dev/vfio/vfio container device."""
        if prefer_iommufd and self.iommufd_enabled():
            return "/dev/iommu"
        return "/dev/vfio/vfio"

    # -- bind / unbind ------------------------------------------------------

    def configure(self, bdf: str) -> str:
        """Bind ``bdf`` to vfio-pci; returns the original driver name so
        unprepare can verify restoration ("" when the device was already
        vfio-bound, e.g. by an admin — then unprepare leaves it alone,
        matching Configure's skip-if-already-bound, vfio-device.go:146)."""
        if not self.iommu_enabled():
            raise VfioError("IOMMU is not enabled in the kernel")
        if not self._pci_dir(bdf).is_dir():
            raise VfioError(f"no PCI device {bdf} under {self.sysfs}")
        original = self.current_driver(bdf)
        if original == VFIO_DRIVER:
            return ""
        if not self.module_loaded():
            self.kernel.modprobe(VFIO_MODULE)
            if not self.module_loaded():
                raise VfioError(f"module {VFIO_MODULE} not loaded after modprobe")
        # driver_override survives the unbind and steers drivers_probe.
        self.kernel.write(f"bus/pci/devices/{bdf}/driver_override", VFIO_DRIVER)
        if original:
            self.kernel.write(f"bus/pci/devices/{bdf}/driver/unbind", bdf)
        self.kernel.write("bus/pci/drivers_probe", bdf)
        now = self.current_driver(bdf)
        if now != VFIO_DRIVER:
            raise VfioError(
                f"device {bdf} bound to {now!r} after probe, want {VFIO_DRIVER}")
        logger.info("bound %s to %s (was %s)", bdf, VFIO_DRIVER, original or "<none>")
        return original

    def unconfigure(self, bdf: str, original_driver: str = "") -> None:
        """Restore ``bdf`` to its pre-passthrough driver. ``original_driver``
        empty = the device was not bound by us; leave it untouched."""
        if not original_driver:
            return
        if not self._pci_dir(bdf).is_dir():
            # Device gone (hot-unplug); nothing to restore.
            logger.warning("unconfigure: PCI device %s no longer present", bdf)
            return
        current = self.current_driver(bdf)
        # Clearing the override lets the default driver match again.
        self.kernel.write(f"bus/pci/devices/{bdf}/driver_override", "\n")
        if current == VFIO_DRIVER:
            self.kernel.write(f"bus/pci/devices/{bdf}/driver/unbind", bdf)
        self.kernel.write("bus/pci/drivers_probe", bdf)
        now = self.current_driver(bdf)
        if now != original_driver:
            raise VfioError(
                f"device {bdf} bound to {now!r} after restore, "
                f"want {original_driver!r}")
        logger.info("restored %s to driver %s", bdf, original_driver)
