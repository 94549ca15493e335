"""Versioned feature gates.

Analogue of the reference's ``pkg/featuregates`` (``featuregates.go:47-109``),
which builds on k8s ``component-base/featuregate``: each gate carries
versioned specs (default + maturity per driver version) and an emulation
version selects which spec applies; operators flip gates via
``--feature-gates A=true,B=false`` (mirrored by the Helm values).

The GPU gate set holds the gates the GPU and ComputeDomain kubelet plugins
and the ComputeDomain controller consult.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

Version = tuple[int, int]

ALPHA = "Alpha"
BETA = "Beta"
GA = "GA"

# Emulation version: driver SemVer major.minor this build emulates. Bump with
# releases (cf. featureGateEmulationVersion pinned to the vendored kube minor,
# featuregates.go:45).
EMULATION_VERSION: Version = (0, 1)

# -- Gate names -------------------------------------------------------------

# MIG partitions published over KEP-4815 shared counters and created at
# prepare time (the reference's DynamicMIG, the JAX package's
# DynamicSubslice).
DYNAMIC_MIG = "DynamicMIG"
# Device health monitoring (NVML XID/ECC events and enumeration →
# DeviceTaints) and the drain controller that closes its loop.
DEVICE_HEALTH_CHECK = "DeviceHealthCheck"
# VM passthrough via vfio-pci: VfioDeviceConfig claims and published
# vfio-bound GPUs.
PASSTHROUGH_SUPPORT = "PassthroughSupport"
# Refuse to start instead of degrading when the GPUs of one node disagree
# (duplicate minors or UUIDs, mixed products, or different NVLink cliques).
CRASH_ON_NVLINK_FABRIC_ERRORS = "CrashOnNVLinkFabricErrors"
# Surface prepared-device attributes (KEP-5304 metadata) on prepare results
# and claim status; requires PassthroughSupport.
DEVICE_METADATA = "DeviceMetadata"
# Publish list-valued DRA device attributes (requires matching k8s gate).
DRA_LIST_TYPE_ATTRIBUTES = "DRAListTypeAttributes"
# Store per-daemon rendezvous info in ComputeDomainClique objects instead of
# ComputeDomain.Status.Nodes.
COMPUTE_DOMAIN_CLIQUES = "ComputeDomainCliques"
# The operator, not the driver, runs the rendezvous service: the controller
# creates no per-domain daemons and channel prepare reads the host's
# rendezvous file.
HOST_MANAGED_RENDEZVOUS = "HostManagedRendezvous"


@dataclass(frozen=True)
class VersionedSpec:
    version: Version        # first driver version this spec applies from
    default: bool
    prerelease: str         # ALPHA / BETA / GA


DEFAULT_FEATURE_GATES: dict[str, tuple[VersionedSpec, ...]] = {
    DYNAMIC_MIG: (VersionedSpec((0, 1), False, ALPHA),),
    DEVICE_HEALTH_CHECK: (VersionedSpec((0, 1), True, BETA),),
    PASSTHROUGH_SUPPORT: (VersionedSpec((0, 1), False, ALPHA),),
    CRASH_ON_NVLINK_FABRIC_ERRORS: (VersionedSpec((0, 1), False, ALPHA),),
    DEVICE_METADATA: (VersionedSpec((0, 1), False, ALPHA),),
    DRA_LIST_TYPE_ATTRIBUTES: (VersionedSpec((0, 1), False, ALPHA),),
    COMPUTE_DOMAIN_CLIQUES: (VersionedSpec((0, 1), True, BETA),),
    HOST_MANAGED_RENDEZVOUS: (VersionedSpec((0, 1), False, ALPHA),),
}


class FeatureGates:
    """A gate registry resolved at an emulation version, with operator
    overrides. Unknown gates and overrides of GA-locked gates raise."""

    def __init__(
        self,
        specs: Optional[Mapping[str, tuple[VersionedSpec, ...]]] = None,
        emulation_version: Version = EMULATION_VERSION,
    ):
        self._specs = dict(specs if specs is not None else DEFAULT_FEATURE_GATES)
        self._version = emulation_version
        self._overrides: dict[str, bool] = {}

    def _resolve(self, name: str) -> VersionedSpec:
        try:
            specs = self._specs[name]
        except KeyError:
            raise KeyError(f"unknown feature gate {name!r}; known: "
                           f"{sorted(self._specs)}") from None
        applicable = [s for s in specs if s.version <= self._version]
        if not applicable:
            # Gate exists but postdates the emulation version: locked off.
            return VersionedSpec(self._version, False, ALPHA)
        return max(applicable, key=lambda s: s.version)

    def enabled(self, name: str) -> bool:
        if name in self._overrides:
            return self._overrides[name]
        return self._resolve(name).default

    def set(self, name: str, value: bool) -> None:
        spec = self._resolve(name)  # raises on unknown
        if spec.prerelease == GA and not value:
            # GA gates are locked on (component-base semantics): disabling
            # graduated behavior must be a loud config error.
            raise ValueError(f"feature gate {name} is GA and cannot be disabled")
        self._overrides[name] = value

    def set_from_map(self, values: Mapping[str, bool]) -> None:
        for k, v in values.items():
            self.set(k, v)

    def parse(self, s: str) -> None:
        """Parse ``A=true,B=false`` (the --feature-gates flag format)."""
        if not s.strip():
            return
        for part in s.split(","):
            if "=" not in part:
                raise ValueError(
                    f"invalid feature gate {part!r}: want Name=true|false")
            name, _, raw = part.partition("=")
            raw = raw.strip().lower()
            if raw not in ("true", "false"):
                raise ValueError(
                    f"invalid feature gate value {part!r}: want true|false")
            self.set(name.strip(), raw == "true")

    def known(self) -> dict[str, bool]:
        return {name: self.enabled(name) for name in sorted(self._specs)}

    def summary(self) -> str:
        return ",".join(f"{k}={str(v).lower()}" for k, v in self.known().items())


def new_feature_gates(flag: str = "",
                      values: Optional[Mapping[str, bool]] = None) -> FeatureGates:
    fg = FeatureGates()
    if flag:
        fg.parse(flag)
    if values:
        fg.set_from_map(values)
    return fg


def validate_gate_dependencies(gates: FeatureGates) -> None:
    """Cross-gate dependency validation (featuregates.go:247-256): some
    gates are meaningless — and would silently do nothing — without their
    prerequisite; fail at assembly time instead."""
    if gates.enabled(DEVICE_METADATA) and not gates.enabled(PASSTHROUGH_SUPPORT):
        raise ValueError(
            f"feature gate {DEVICE_METADATA} requires {PASSTHROUGH_SUPPORT} "
            "to also be enabled")
