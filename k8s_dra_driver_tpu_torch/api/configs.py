"""Opaque device configs + decoders for GPU claims.

Copied from the JAX package's ``api/configs.py`` and cut to what the GPU
kubelet plugin prepares: every opaque config embedded in a claim or
DeviceClass is decoded by apiVersion/kind, then ``normalize()`` fills
defaults and ``validate()`` rejects nonsense. The strict decoder (user input
via the plugin's prepare path) rejects unknown fields; ``strict=False``
ignores them.

Kinds: ``GpuConfig`` carries extra env for full-GPU devices (the reference's
``GpuConfig`` without its sharing strategies); ``MigDeviceConfig{profile,
env}`` constrains the MIG profile a claim accepts (the JAX package's
``SubsliceConfig``); ``VfioDeviceConfig{iommu}`` asks for VM passthrough
(``vfiodeviceconfig.go:29``, the JAX package's ``VfioChipConfig``);
``ComputeDomainChannelConfig{domainID, allocationMode}`` and
``ComputeDomainDaemonConfig{domainID}`` are the ComputeDomain plugin's
(``computedomainconfig.go:28-82``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Mapping

from k8s_dra_driver_tpu_torch.gpulib.chip import MIG_PROFILES

API_GROUP = "resource.nvidia.com"
API_VERSION = f"{API_GROUP}/v1beta1"

_UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")

# Env the driver computes itself; user configs must not override these —
# they carry the isolation contract.
DRIVER_MANAGED_ENV = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")

#: MIG profile names of every GPU product the device library knows.
MIG_PROFILE_NAMES = frozenset(p.name for ps in MIG_PROFILES.values()
                              for p in ps)


def _validate_env_map(kind: str, env: Mapping[str, str]) -> None:
    for k in env:
        if not k or "=" in k:
            raise ConfigError(f"{kind}.env: invalid variable name {k!r}")
        if k in DRIVER_MANAGED_ENV:
            raise ConfigError(
                f"{kind}.env: {k} is driver-managed and cannot be overridden")


class ConfigError(ValueError):
    pass


@dataclass
class GpuConfig:
    """Per-claim config for full-GPU devices: extra env injected alongside
    the visibility variables."""

    KIND = "GpuConfig"

    env: dict[str, str] = field(default_factory=dict)

    def normalize(self) -> None:
        pass

    def validate(self) -> None:
        _validate_env_map("GpuConfig", self.env)

    def to_dict(self) -> dict[str, Any]:
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "env": dict(self.env)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], strict: bool) -> "GpuConfig":
        _check_fields(cls.KIND, d, {"apiVersion", "kind", "env"}, strict)
        env = d.get("env") or {}
        if not isinstance(env, Mapping):
            raise ConfigError(f"GpuConfig.env must be an object, got "
                              f"{type(env).__name__}")
        return cls(env={str(k): str(v) for k, v in env.items()})


@dataclass
class MigDeviceConfig:
    """MIG request (the reference's ``MigDeviceConfig``): the profile a
    claim accepts, e.g. ``3g.40gb`` (empty: any), and workload env. The
    published MIG devices already encode valid placements; this config
    constrains which profile the claim takes."""

    KIND = "MigDeviceConfig"

    profile: str = ""
    env: dict[str, str] = field(default_factory=dict)

    def normalize(self) -> None:
        self.profile = self.profile.lower().strip()

    def validate(self) -> None:
        if self.profile and self.profile not in MIG_PROFILE_NAMES:
            raise ConfigError(
                f"MigDeviceConfig.profile {self.profile!r}: want one of "
                f"{sorted(MIG_PROFILE_NAMES)}")
        _validate_env_map("MigDeviceConfig", self.env)

    def to_dict(self) -> dict[str, Any]:
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "profile": self.profile, "env": dict(self.env)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], strict: bool
                  ) -> "MigDeviceConfig":
        _check_fields(cls.KIND, d, {"apiVersion", "kind", "profile", "env"},
                      strict)
        env = d.get("env") or {}
        if not isinstance(env, Mapping):
            raise ConfigError(f"MigDeviceConfig.env must be an object, got "
                              f"{type(env).__name__}")
        return cls(profile=str(d.get("profile", "")),
                   env={str(k): str(v) for k, v in env.items()})


IOMMU_LEGACY = "legacy"
IOMMU_IOMMUFD = "iommufd"


@dataclass
class VfioDeviceConfig:
    """VM passthrough config (``vfiodeviceconfig.go:29``): the IOMMU API
    the VMM uses, ``legacy`` (the default) or ``iommufd``."""

    KIND = "VfioDeviceConfig"

    iommu: str = ""

    def normalize(self) -> None:
        if not self.iommu:
            self.iommu = IOMMU_LEGACY

    def validate(self) -> None:
        if self.iommu not in (IOMMU_LEGACY, IOMMU_IOMMUFD):
            raise ConfigError(
                f"VfioDeviceConfig.iommu {self.iommu!r}: want legacy|iommufd")

    def to_dict(self) -> dict[str, Any]:
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "iommu": self.iommu}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], strict: bool
                  ) -> "VfioDeviceConfig":
        _check_fields(cls.KIND, d, {"apiVersion", "kind", "iommu"}, strict)
        return cls(iommu=str(d.get("iommu", "")))


ALLOCATION_MODE_SINGLE = "Single"
ALLOCATION_MODE_ALL = "All"


@dataclass
class ComputeDomainChannelConfig:
    """Opaque config on workload-claim channel devices
    (computedomainconfig.go:28-54)."""

    KIND = "ComputeDomainChannelConfig"

    domain_id: str = ""
    allocation_mode: str = ""

    def normalize(self) -> None:
        if not self.allocation_mode:
            self.allocation_mode = ALLOCATION_MODE_SINGLE

    def validate(self) -> None:
        if not _UUID_RE.match(self.domain_id or ""):
            raise ConfigError(
                f"ComputeDomainChannelConfig.domainID {self.domain_id!r}: "
                "must be a lowercase UUID")
        if self.allocation_mode not in (ALLOCATION_MODE_SINGLE,
                                        ALLOCATION_MODE_ALL):
            raise ConfigError(
                f"ComputeDomainChannelConfig.allocationMode "
                f"{self.allocation_mode!r}: want Single|All")

    def to_dict(self) -> dict[str, Any]:
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "domainID": self.domain_id,
                "allocationMode": self.allocation_mode}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], strict: bool
                  ) -> "ComputeDomainChannelConfig":
        _check_fields(cls.KIND, d, {"apiVersion", "kind", "domainID",
                                    "allocationMode"}, strict)
        return cls(domain_id=str(d.get("domainID", "")),
                   allocation_mode=str(d.get("allocationMode", "")))


@dataclass
class ComputeDomainDaemonConfig:
    """Opaque config on the per-CD daemon claim
    (computedomainconfig.go:56-82)."""

    KIND = "ComputeDomainDaemonConfig"

    domain_id: str = ""

    def normalize(self) -> None:
        pass

    def validate(self) -> None:
        if not _UUID_RE.match(self.domain_id or ""):
            raise ConfigError(
                f"ComputeDomainDaemonConfig.domainID {self.domain_id!r}: "
                "must be a lowercase UUID")

    def to_dict(self) -> dict[str, Any]:
        return {"apiVersion": API_VERSION, "kind": self.KIND,
                "domainID": self.domain_id}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any], strict: bool
                  ) -> "ComputeDomainDaemonConfig":
        _check_fields(cls.KIND, d, {"apiVersion", "kind", "domainID"},
                      strict)
        return cls(domain_id=str(d.get("domainID", "")))


_KINDS = {c.KIND: c for c in (GpuConfig, MigDeviceConfig, VfioDeviceConfig,
                              ComputeDomainChannelConfig,
                              ComputeDomainDaemonConfig)}


def _check_fields(kind: str, d: Mapping[str, Any], known: set[str],
                  strict: bool) -> None:
    if strict:
        unknown = set(d) - known
        if unknown:
            raise ConfigError(f"{kind}: unknown fields {sorted(unknown)}")


def decode_opaque_config(params: Mapping[str, Any], strict: bool = True) -> Any:
    """Decode + normalize + validate one opaque config parameter object.
    Raises ConfigError on unknown kind/apiVersion, unknown fields (strict),
    or validation failure."""
    if not isinstance(params, Mapping):
        raise ConfigError(f"opaque config parameters must be an object, "
                          f"got {type(params).__name__}")
    api_version = params.get("apiVersion", "")
    if api_version != API_VERSION:
        raise ConfigError(
            f"unknown config apiVersion {api_version!r} (want {API_VERSION})")
    kind = params.get("kind", "")
    cls = _KINDS.get(kind)
    if cls is None:
        raise ConfigError(f"unknown config kind {kind!r}; known: {sorted(_KINDS)}")
    cfg = cls.from_dict(params, strict)
    cfg.normalize()
    cfg.validate()
    return cfg


def strict_decode(params: Mapping[str, Any]) -> Any:
    """User-supplied config (webhook, prepare path)."""
    return decode_opaque_config(params, strict=True)
