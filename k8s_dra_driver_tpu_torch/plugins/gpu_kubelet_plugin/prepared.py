"""Prepared-device model (the ``prepared.go:31-65`` analogue), copied from
the JAX package: what Prepare materializes per allocated device and
records in the checkpoint, with JSON round-tripping so Unprepare and crash
recovery can reconstruct everything without the API object. The record
keeps every key of the JAX package's, so either package reads the other's
checkpoint; a MIG device's record adds a ``mig`` key (its profile,
placement, instance ids and UUID), written only for MIG devices."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from k8s_dra_driver_tpu_torch.kubeletplugin.types import PreparedDeviceRef


@dataclass
class PreparedDevice:
    device: str                    # DRA device name (gpu-3)
    requests: list[str]            # request names this device satisfies
    pool: str
    cdi_device_name: str           # claim-scoped CDI device name
    device_nodes: list[str] = field(default_factory=list)
    env: dict[str, str] = field(default_factory=dict)  # device-level env
    # node-local GPU indices ("chipIndices": the checkpoint format is the
    # JAX package's)
    chip_indices: list[int] = field(default_factory=list)
    mounts: list[tuple[str, str]] = field(default_factory=list)  # (host, container)
    # VFIO passthrough marker of the shared format ({"pciAddress",
    # "iommuGroup", "iommu"} for a passthrough device).
    vfio: dict[str, str] = field(default_factory=dict)
    # The MIG instance a MIG device was prepared into
    # (``MigDeviceInfo.to_dict``); empty for any other device.
    mig: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d = {
            "device": self.device,
            "requests": list(self.requests),
            "pool": self.pool,
            "cdiDeviceName": self.cdi_device_name,
            "deviceNodes": list(self.device_nodes),
            "env": dict(self.env),
            "chipIndices": list(self.chip_indices),
            "mounts": [list(m) for m in self.mounts],
            "vfio": dict(self.vfio),
        }
        if self.mig:
            d["mig"] = dict(self.mig)
        return d

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "PreparedDevice":
        return PreparedDevice(
            device=d.get("device", ""),
            requests=list(d.get("requests") or []),
            pool=d.get("pool", ""),
            cdi_device_name=d.get("cdiDeviceName", ""),
            device_nodes=list(d.get("deviceNodes") or []),
            env=dict(d.get("env") or {}),
            chip_indices=list(d.get("chipIndices") or []),
            mounts=[tuple(m) for m in d.get("mounts") or []],
            vfio=dict(d.get("vfio") or {}),
            mig=dict(d.get("mig") or {}),
        )

    def to_ref(self, qualified_id: str,
               with_metadata: bool = False) -> PreparedDeviceRef:
        """``with_metadata`` (the DeviceMetadata gate, KEP-5304): passthrough
        devices surface their identifying attributes on the prepare result —
        the VM launcher reads them from pod status instead of probing sysfs
        (device_state.go:977-987, vfio devices only there too)."""
        metadata = {}
        if with_metadata and self.vfio:
            metadata = {"attributes": dict(self.vfio)}
        return PreparedDeviceRef(
            requests=list(self.requests),
            pool=self.pool,
            device=self.device,
            cdi_device_ids=[qualified_id],
            metadata=metadata,
        )
