"""DRA data model (resource.k8s.io shapes, Python-typed).

Mirrors the slice of the Kubernetes DRA API the reference publishes and
consumes — Device attributes/capacity (``cmd/gpu-kubelet-plugin/
deviceinfo.go:170-294``), SharedCounters / counter consumption (KEP-4815,
``partitions.go:70-232``), DeviceTaints (KEP-5055, ``device_health.go:35-39``)
— plus the prepare-result types the kubelet plugin returns. Typed driver-side
models convert to/from the dict-shaped API objects stored in the fake client.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from k8s_dra_driver_tpu_torch.k8sclient.client import Obj

# Device taint effects (KEP-5055).
TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_NO_EXECUTE = "NoExecute"


@dataclass
class DeviceTaint:
    key: str
    value: str
    effect: str = TAINT_NO_SCHEDULE
    time_added: Optional[float] = None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"key": self.key, "value": self.value,
                             "effect": self.effect}
        if self.time_added is not None:
            d["timeAdded"] = self.time_added
        return d


@dataclass
class CounterConsumption:
    """One device's draw against a named CounterSet (KEP-4815)."""
    counter_set: str
    counters: dict[str, int]

    def to_dict(self) -> dict[str, Any]:
        return {"counterSet": self.counter_set,
                "counters": {k: {"value": v} for k, v in self.counters.items()}}


@dataclass
class CounterSet:
    name: str
    counters: dict[str, int]

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name,
                "counters": {k: {"value": v} for k, v in self.counters.items()}}


@dataclass
class Device:
    """One allocatable DRA device as published in a ResourceSlice."""
    name: str
    attributes: dict[str, Any] = field(default_factory=dict)
    capacity: dict[str, int] = field(default_factory=dict)
    consumes_counters: list[CounterConsumption] = field(default_factory=list)
    taints: list[DeviceTaint] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"name": self.name}
        if self.attributes:
            d["attributes"] = {k: _attr_value(v) for k, v in self.attributes.items()}
        if self.capacity:
            d["capacity"] = {k: {"value": v} for k, v in self.capacity.items()}
        if self.consumes_counters:
            d["consumesCounters"] = [c.to_dict() for c in self.consumes_counters]
        if self.taints:
            d["taints"] = [t.to_dict() for t in self.taints]
        return d


class VersionStr(str):
    """A string attribute published with the DRA ``version`` type, so real
    CEL evaluates semver operations on it (a plain string attribute would
    make ``.compareTo(semver(...))`` a type error on a real cluster)."""


def _attr_value(v: Any) -> dict[str, Any]:
    if isinstance(v, bool):
        return {"bool": v}
    if isinstance(v, VersionStr):
        return {"version": str(v)}
    if isinstance(v, int):
        return {"int": v}
    if isinstance(v, (list, tuple)):
        return {"list": list(v)}
    return {"string": str(v)}


def attr_plain(av: dict[str, Any]) -> Any:
    """Inverse of _attr_value for reading published objects."""
    for k in ("bool", "int", "list", "string", "version"):
        if k in av:
            return av[k]
    return None


@dataclass
class Slice:
    devices: list[Device] = field(default_factory=list)
    shared_counters: list[CounterSet] = field(default_factory=list)


@dataclass
class Pool:
    slices: list[Slice] = field(default_factory=list)
    generation: int = 1


@dataclass
class DriverResources:
    pools: dict[str, Pool] = field(default_factory=dict)


# -- prepare/unprepare interface types --------------------------------------

@dataclass(frozen=True)
class ClaimRef:
    uid: str
    name: str
    namespace: str = "default"

    @staticmethod
    def from_claim(claim: Obj) -> "ClaimRef":
        m = claim.get("metadata", {})
        return ClaimRef(uid=m.get("uid", ""), name=m.get("name", ""),
                        namespace=m.get("namespace", "default"))


@dataclass
class PreparedDeviceRef:
    """What Prepare returns per allocated device: which request(s) it
    satisfies and the CDI IDs the runtime must inject. ``metadata`` (KEP-5304,
    behind the DeviceMetadata gate) carries device attributes back to the
    kubelet for pod-status surfacing (device_state.go:977-987)."""
    requests: list[str]
    pool: str
    device: str
    cdi_device_ids: list[str] = field(default_factory=list)
    metadata: dict[str, Any] = field(default_factory=dict)


@dataclass
class PrepareResult:
    devices: list[PreparedDeviceRef] = field(default_factory=list)
    error: Optional[Exception] = None


# -- claim-object accessors --------------------------------------------------

def claim_uid(claim: Obj) -> str:
    return claim.get("metadata", {}).get("uid", "")


def claim_requests(claim: Obj) -> list[dict[str, Any]]:
    return (claim.get("spec") or {}).get("devices", {}).get("requests", [])


def claim_configs(claim: Obj) -> list[dict[str, Any]]:
    return (claim.get("spec") or {}).get("devices", {}).get("config", [])


def claim_allocation_results(claim: Obj) -> list[dict[str, Any]]:
    status = claim.get("status") or {}
    alloc = status.get("allocation") or {}
    return alloc.get("devices", {}).get("results", [])


def claim_allocation_configs(claim: Obj) -> list[dict[str, Any]]:
    """Config entries recorded in the allocation (class + claim sources,
    in precedence order class-first — device_state.go:1410-1482)."""
    status = claim.get("status") or {}
    alloc = status.get("allocation") or {}
    return alloc.get("devices", {}).get("config", [])
