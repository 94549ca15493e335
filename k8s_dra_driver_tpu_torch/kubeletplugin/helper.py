"""Plugin helper: registration, ResourceSlice publication, claim dispatch.

The analogue of ``kubeletplugin.Start`` + ``helper.PublishResources`` from
``k8s.io/dynamic-resource-allocation`` as used by the reference
(``cmd/gpu-kubelet-plugin/driver.go:131-179,462-501``): the driver hands the
helper a ``DriverResources`` snapshot and the helper reconciles the cluster's
ResourceSlice objects against it (create/update/delete with pool-generation
bumps); the kubelet-facing Prepare/Unprepare surface dispatches claims to the
plugin implementation. In a real cluster the kubelet side is gRPC over unix
sockets; here the fake kubelet (tests, bench) calls the same methods
directly.
"""

from __future__ import annotations

import logging
from typing import Optional, Protocol

from k8s_dra_driver_tpu_torch.k8sclient.client import FakeClient, NotFoundError, Obj
from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
    ClaimRef,
    DriverResources,
    PrepareResult,
)

logger = logging.getLogger(__name__)


class DRAPlugin(Protocol):
    """What a driver must implement (the DRA plugin interface —
    driver.go:344-378)."""

    def prepare_resource_claims(
        self, claims: list[Obj]) -> dict[str, PrepareResult]: ...

    def unprepare_resource_claims(
        self, refs: list[ClaimRef]) -> dict[str, Optional[Exception]]: ...


class Helper:
    def __init__(
        self,
        client: FakeClient,
        driver_name: str,
        node_name: str,
        plugin: DRAPlugin,
    ):
        self.client = client
        self.driver_name = driver_name
        self.node_name = node_name
        self.plugin = plugin
        self._registered = False

    # -- registration (kubelet plugin socket registration analogue) ---------

    def start(self) -> "Helper":
        """Registers the plugin: in real k8s this is the registration socket
        handshake; here it marks a Node-scoped registration object so tests
        and the healthcheck service can assert on it."""
        reg = {
            "apiVersion": "v1",
            "kind": "PluginRegistration",
            "metadata": {"name": f"{self.driver_name}-{self.node_name}"},
            "spec": {"driver": self.driver_name, "node": self.node_name},
        }
        if self.client.try_get("PluginRegistration",
                               reg["metadata"]["name"]) is None:
            self.client.create(reg)
        self._registered = True
        return self

    @property
    def is_registered(self) -> bool:
        return self._registered

    def stop(self) -> None:
        try:
            self.client.delete("PluginRegistration",
                               f"{self.driver_name}-{self.node_name}")
        except NotFoundError:
            pass
        self._registered = False

    # -- ResourceSlice publication ------------------------------------------

    def _slice_name(self, pool: str, index: int) -> str:
        return f"{self.node_name}-{self.driver_name}-{pool}-{index}"

    def publish_resources(self, resources: DriverResources) -> list[Obj]:
        """Reconcile cluster ResourceSlices to the given snapshot. Returns
        the published slice objects. Pool generation comes from the caller's
        Pool.generation — bump it when device data changes so schedulers
        invalidate stale slices (resourceslice helper semantics)."""
        published: list[Obj] = []
        wanted: set[str] = set()
        for pool_name, pool in resources.pools.items():
            count = len(pool.slices)
            for i, slc in enumerate(pool.slices):
                name = self._slice_name(pool_name, i)
                wanted.add(name)
                spec: dict = {
                    "driver": self.driver_name,
                    "nodeName": self.node_name,
                    "pool": {
                        "name": pool_name,
                        "generation": pool.generation,
                        "resourceSliceCount": count,
                    },
                    "devices": [d.to_dict() for d in slc.devices],
                }
                if slc.shared_counters:
                    spec["sharedCounters"] = [
                        c.to_dict() for c in slc.shared_counters]
                obj = {
                    "apiVersion": "resource.k8s.io/v1",
                    "kind": "ResourceSlice",
                    "metadata": {"name": name},
                    "spec": spec,
                }
                existing = self.client.try_get("ResourceSlice", name)
                if existing is None:
                    published.append(self.client.create(obj))
                else:
                    obj["metadata"] = existing["metadata"] | {"name": name}
                    published.append(self.client.update(obj))
        # Remove slices this driver/node owns that are no longer wanted.
        for slc_obj in self.client.list("ResourceSlice"):
            spec = slc_obj.get("spec", {})
            if (spec.get("driver") == self.driver_name
                    and spec.get("nodeName") == self.node_name
                    and slc_obj["metadata"]["name"] not in wanted):
                self.client.delete("ResourceSlice", slc_obj["metadata"]["name"])
        logger.debug("published %d ResourceSlices for %s/%s",
                     len(published), self.driver_name, self.node_name)
        return published

    def unpublish_resources(self) -> None:
        self.publish_resources(DriverResources())

    # -- kubelet-facing dispatch --------------------------------------------

    def node_prepare_resources(
        self, claim_names: list[tuple[str, str]]) -> dict[str, PrepareResult]:
        """Simulated kubelet NodePrepareResources: fetch the named claims
        ((namespace, name) pairs) from the API server and dispatch."""
        claims = []
        for ns, name in claim_names:
            claims.append(self.client.get("ResourceClaim", name, ns))
        return self.plugin.prepare_resource_claims(claims)

    def node_unprepare_resources(
        self, refs: list[ClaimRef]) -> dict[str, Optional[Exception]]:
        return self.plugin.unprepare_resource_claims(refs)
