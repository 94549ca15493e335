"""Per-claim transient CDI spec files for GPU claims.

Prepare writes one transient spec per claim into the CDI root
(``/var/run/cdi``), the plugin hands the kubelet fully-qualified device
IDs like ``k8s.gpu.nvidia.com/claim=<claimUID>-gpu-0``, and the container
runtime performs the injection. Unprepare deletes the file.

GPU injection model: a container that uses GPUs needs the per-GPU device
node ``/dev/nvidia<minor>``, the driver's shared nodes ``/dev/nvidiactl``,
``/dev/nvidia-uvm`` and ``/dev/nvidia-uvm-tools``, and claim-wide
visibility env ``CUDA_VISIBLE_DEVICES`` / ``NVIDIA_VISIBLE_DEVICES``
(:func:`claim_edits_for` builds exactly that set). A MIG device adds its
instance's two ``/dev/nvidia-caps/nvidia-cap<K>`` nodes to its parent's
(:func:`mig_device_edits`) and is made visible by its ``MIG-<uuid>``. A
passthrough device is its ``/dev/vfio/<group>`` node (or iommufd cdev),
with one IOMMU API node for the claim and the PCI addresses in
``GPU_PASSTHROUGH_PCI_ADDRESSES`` (:func:`claim_visibility_edits`).

Specs are written atomically (tmp + rename) so a crash mid-write never
leaves a truncated spec for the runtime to trip over.
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence

from k8s_dra_driver_tpu_torch.pkg import faultpoints, tracing
from k8s_dra_driver_tpu_torch.pkg.durability import atomic_publish

logger = logging.getLogger(__name__)

#: Fault point: the transient claim-spec write fails or crashes before
#: the atomic publish.
FP_CDI_WRITE = faultpoints.register(
    "cdi.write", "claim CDI spec write fails before the atomic rename",
    errors={"oserror": OSError})

# Claim UIDs become path components of transient spec files; restrict them to
# the RFC-4122-ish charset the kubelet actually hands out so a hostile UID
# (e.g. "../../etc/cron.d/x" or an absolute path) can never escape cdi_root.
_SAFE_UID = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]*\Z")


class InvalidClaimUID(ValueError):
    """Claim UID unfit for use as a CDI spec filename component."""


# 0.7.0: first CDI spec revision with top-level containerEdits, which the
# per-claim specs rely on for claim-wide env.
CDI_VERSION = "0.7.0"
DEFAULT_VENDOR = "k8s.gpu.nvidia.com"
DEFAULT_CLASS = "claim"

#: Driver-wide device nodes every GPU container needs beside its
#: ``/dev/nvidia<minor>`` nodes.
GPU_CONTROL_NODES = ("/dev/nvidiactl", "/dev/nvidia-uvm",
                     "/dev/nvidia-uvm-tools")
#: Claim-wide env listing a passthrough claim's PCI functions for the VM
#: launcher.
PASSTHROUGH_ENV = "GPU_PASSTHROUGH_PCI_ADDRESSES"


@dataclass
class CDIDevice:
    """One device entry inside a claim spec: the container-edits payload for
    a single prepared DRA device."""

    name: str                                   # e.g. "<claimUID>-gpu-0"
    device_nodes: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)
    mounts: list[tuple[str, str]] = field(default_factory=list)  # (host, container)

    def to_dict(self, dev_root_transform) -> dict[str, Any]:
        edits: dict[str, Any] = {}
        if self.device_nodes:
            edits["deviceNodes"] = [
                {"path": p, "hostPath": dev_root_transform(p)}
                for p in self.device_nodes
            ]
        if self.env:
            edits["env"] = [f"{k}={v}" for k, v in sorted(self.env.items())]
        if self.mounts:
            edits["mounts"] = [
                {"hostPath": h, "containerPath": c,
                 "options": ["ro", "nosuid", "nodev", "bind"]}
                for h, c in self.mounts
            ]
        return {"name": self.name, "containerEdits": edits}


def claim_edits_for(indices: Sequence[int], minors: Sequence[int],
                    uuids: Optional[Sequence[str]] = None
                    ) -> tuple[list[CDIDevice], CDIDevice]:
    """The container edits a GPU plugin writes when it prepares a claim on
    the GPUs with node-local ``indices`` and device-node ``minors``
    (pairwise).

    Returns ``(devices, claim_edits)``: one ``gpu-<index>`` device per GPU
    carrying its ``/dev/nvidia<minor>`` node plus the driver's shared
    control nodes, and the claim-wide edits carrying
    ``CUDA_VISIBLE_DEVICES`` and ``NVIDIA_VISIBLE_DEVICES`` (the union over
    the claim's GPUs, which must not be set per device where several
    values would collide). The visibility lists the GPUs' ``uuids``
    (``GPU-<uuid>``) when given, else their indices: a UUID names the same
    GPU whatever order CUDA enumerates the visible devices in. Device names
    are claim-local; pass each through :meth:`CDIHandler.claim_device_name`
    before writing the spec."""
    if len(indices) != len(minors):
        raise ValueError(f"{len(indices)} indices but {len(minors)} minors")
    if uuids is not None and len(uuids) != len(indices):
        raise ValueError(f"{len(indices)} indices but {len(uuids)} uuids")
    devices = [
        CDIDevice(name=f"gpu-{i}",
                  device_nodes=[f"/dev/nvidia{m}", *GPU_CONTROL_NODES])
        for i, m in zip(indices, minors)
    ]
    return devices, claim_visibility_edits(
        list(uuids) if uuids is not None else [str(i) for i in indices])


def mig_device_edits(name: str, parent_minor: int,
                     caps_paths: Sequence[str]) -> CDIDevice:
    """A MIG device's edits: its parent's ``/dev/nvidia<minor>``, the
    driver's control nodes and the instance's ``nvidia-caps`` nodes (its
    GPU instance's and compute instance's access)."""
    return CDIDevice(name=name, device_nodes=[
        f"/dev/nvidia{parent_minor}", *GPU_CONTROL_NODES, *caps_paths])


def claim_visibility_edits(visible: Sequence[str],
                           passthrough_bdfs: Sequence[str] = (),
                           iommu_node: str = "") -> CDIDevice:
    """Claim-wide edits: ``CUDA_VISIBLE_DEVICES`` and
    ``NVIDIA_VISIBLE_DEVICES`` list ``visible`` (``GPU-``/``MIG-`` UUIDs or
    indices). A claim holding only passthrough devices sets both to
    ``void``, never leaves them unset: a runtime that reads unset as "all"
    would hand the VM launcher every GPU of the host (vfio-cdi.go:55-58).
    Passthrough functions go in :data:`PASSTHROUGH_ENV`, with the claim's
    one IOMMU API node."""
    value = ",".join(visible) or ("void" if passthrough_bdfs else "")
    env = {"CUDA_VISIBLE_DEVICES": value, "NVIDIA_VISIBLE_DEVICES": value}
    if passthrough_bdfs:
        env[PASSTHROUGH_ENV] = ",".join(passthrough_bdfs)
    return CDIDevice(name="claim", env=env,
                     device_nodes=[iommu_node] if iommu_node else [])


def claim_spec_env(spec: dict) -> dict[str, str]:
    """The env a claim spec sets in a container: its claim-wide edits' and
    every device's, ``K=V`` strings as a dict."""
    out: dict[str, str] = {}
    for edits in [spec.get("containerEdits")] + [
            d.get("containerEdits") for d in spec.get("devices") or []]:
        for e in (edits or {}).get("env") or []:
            k, _, v = e.partition("=")
            out[k] = v
    return out


class CDIHandler:
    def __init__(
        self,
        cdi_root: str,
        vendor: str = DEFAULT_VENDOR,
        device_class: str = DEFAULT_CLASS,
        dev_root: str = "",
    ):
        """``dev_root``: when the driver runs chrooted/containerized with the
        host's /dev bind-mounted elsewhere, hostPath entries are prefixed
        with it (the container-root transformation)."""
        self.cdi_root = Path(cdi_root)
        self.vendor = vendor
        self.device_class = device_class
        self.dev_root = dev_root.rstrip("/")
        self.cdi_root.mkdir(parents=True, exist_ok=True)

    # -- naming -------------------------------------------------------------

    @property
    def kind(self) -> str:
        return f"{self.vendor}/{self.device_class}"

    def _spec_path(self, claim_uid: str) -> Path:
        if not _SAFE_UID.match(claim_uid) or ".." in claim_uid:
            raise InvalidClaimUID(
                f"claim UID {claim_uid!r} is not a safe filename component")
        path = self.cdi_root / f"{self.vendor}-{self.device_class}_{claim_uid}.json"
        # Belt and braces: the rendered path must stay inside cdi_root.
        if path.parent != self.cdi_root:
            raise InvalidClaimUID(
                f"claim UID {claim_uid!r} escapes CDI root {self.cdi_root}")
        return path

    def qualified_id(self, device_name: str) -> str:
        """``k8s.gpu.nvidia.com/claim=<name>``."""
        return f"{self.kind}={device_name}"

    def claim_device_name(self, claim_uid: str, device: str) -> str:
        return f"{claim_uid}-{device}"

    # -- spec lifecycle -----------------------------------------------------

    def _transform(self, path: str) -> str:
        return f"{self.dev_root}{path}" if self.dev_root else path

    def create_claim_spec_file(
        self, claim_uid: str, devices: list[CDIDevice],
        claim_edits: Optional[CDIDevice] = None) -> list[str]:
        """Write the transient spec for a claim; returns the fully-qualified
        CDI device IDs to hand back to the kubelet.

        ``claim_edits``: top-level containerEdits applied whenever ANY device
        from this spec is injected — the place for claim-wide env like
        ``CUDA_VISIBLE_DEVICES``."""
        spec = {
            "cdiVersion": CDI_VERSION,
            "kind": self.kind,
            "devices": [d.to_dict(self._transform) for d in devices],
        }
        if claim_edits is not None:
            spec["containerEdits"] = claim_edits.to_dict(
                self._transform)["containerEdits"]
        with tracing.child_span("cdi.write", attributes={"claim": claim_uid}):
            return self._write_claim_spec(claim_uid, spec, devices)

    def _write_claim_spec(self, claim_uid: str, spec: dict,
                          devices: list[CDIDevice]) -> list[str]:
        faultpoints.maybe_fail(FP_CDI_WRITE)
        path = self._spec_path(claim_uid)
        atomic_publish(path,
                       lambda f: json.dump(spec, f, indent=2, sort_keys=True),
                       tmp=path.with_suffix(".tmp"))
        logger.debug("wrote CDI spec %s (%d devices)", path, len(devices))
        return [self.qualified_id(d.name) for d in devices]

    def delete_claim_spec_file(self, claim_uid: str) -> None:
        """No-op for invalid UIDs: this handler can never have written a spec
        for one (create validates), so there is nothing to delete — and
        raising here would wedge unprepare of such a claim record in an
        unretryable loop."""
        try:
            path = self._spec_path(claim_uid)
        except InvalidClaimUID:
            logger.warning("delete: ignoring invalid claim UID %r", claim_uid)
            return
        try:
            path.unlink()
        except FileNotFoundError:
            pass

    def read_claim_spec(self, claim_uid: str) -> Optional[dict[str, Any]]:
        try:
            path = self._spec_path(claim_uid)
        except InvalidClaimUID:
            return None  # nothing we wrote can exist under such a UID
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def list_claim_uids(self) -> list[str]:
        """UIDs of present spec files — only ones that round-trip through
        UID validation (strays with hostile names are the province of
        :meth:`sweep_invalid_spec_files`)."""
        prefix = f"{self.vendor}-{self.device_class}_"
        out = []
        for p in self.cdi_root.glob(f"{prefix}*.json"):
            uid = p.name[len(prefix):-len(".json")]
            if _SAFE_UID.match(uid) and ".." not in uid:
                out.append(uid)
        return sorted(out)

    def sweep_invalid_spec_files(self) -> list[str]:
        """Unlink spec files whose embedded UID fails validation (written by
        another agent). They can never belong to a prepared claim, and
        deleting by the discovered path (a direct child of cdi_root by
        construction) avoids round-tripping the hostile name through
        :meth:`_spec_path`."""
        prefix = f"{self.vendor}-{self.device_class}_"
        removed = []
        for p in self.cdi_root.glob(f"{prefix}*.json"):
            uid = p.name[len(prefix):-len(".json")]
            if not _SAFE_UID.match(uid) or ".." in uid:
                p.unlink(missing_ok=True)
                removed.append(p.name)
        if removed:
            logger.info("removed %d invalid-UID CDI specs: %s",
                        len(removed), removed)
        return removed
