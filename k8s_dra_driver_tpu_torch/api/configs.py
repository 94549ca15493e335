"""Opaque device configs + decoders for GPU claims.

Copied from the JAX package's ``api/configs.py`` and cut to what the GPU
kubelet plugin prepares: every opaque config embedded in a claim or
DeviceClass is decoded by apiVersion/kind, then ``normalize()`` fills
defaults and ``validate()`` rejects nonsense. The strict decoder (user input
via the plugin's prepare path) rejects unknown fields; ``strict=False``
ignores them.

Kinds: ``GpuConfig`` carries extra env for full-GPU devices (the reference's
``GpuConfig`` without its sharing strategies);
``ComputeDomainChannelConfig{domainID, allocationMode}`` and
``ComputeDomainDaemonConfig{domainID}`` are the ComputeDomain plugin's
(``computedomainconfig.go:28-82``). ``MigDeviceConfig`` and
``VfioDeviceConfig`` name features this package does not have yet; decoding
either raises :class:`ConfigError` saying so.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Mapping

API_GROUP = "resource.nvidia.com"
API_VERSION = f"{API_GROUP}/v1beta1"

_UUID_RE = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")

# Env the driver computes itself; user configs must not override these —
# they carry the isolation contract.
DRIVER_MANAGED_ENV = ("CUDA_VISIBLE_DEVICES", "NVIDIA_VISIBLE_DEVICES")


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


_KINDS = {c.KIND: c for c in (GpuConfig, ComputeDomainChannelConfig,
                              ComputeDomainDaemonConfig)}

#: Kinds of the reference's config surface that wait for a later slice.
_WAITING_KINDS = {
    "MigDeviceConfig": "MIG partitions",
    "VfioDeviceConfig": "VFIO passthrough",
}


def _check_fields(kind: str, d: Mapping[str, Any], known: set[str],
                  strict: bool) -> None:
    if strict:
        unknown = set(d) - known
        if unknown:
            raise ConfigError(f"{kind}: unknown fields {sorted(unknown)}")


def decode_opaque_config(params: Mapping[str, Any], strict: bool = True) -> Any:
    """Decode + normalize + validate one opaque config parameter object.
    Raises ConfigError on unknown kind/apiVersion, unknown fields (strict),
    a kind this package does not support yet, or validation failure."""
    if not isinstance(params, Mapping):
        raise ConfigError(f"opaque config parameters must be an object, "
                          f"got {type(params).__name__}")
    api_version = params.get("apiVersion", "")
    if api_version != API_VERSION:
        raise ConfigError(
            f"unknown config apiVersion {api_version!r} (want {API_VERSION})")
    kind = params.get("kind", "")
    if kind in _WAITING_KINDS:
        raise ConfigError(f"config kind {kind!r} ({_WAITING_KINDS[kind]}) is "
                          "not supported by this driver yet")
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
