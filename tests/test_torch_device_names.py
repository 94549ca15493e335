"""The GPU kubelet plugin's published device names are DNS labels, as a
real API server requires of a DRA device name (and as every name the JAX
package publishes is: ``tpu-<i>``, ``tpu-<i>-vfio``,
``<prefix>-<shape>-at-<origin>``). A MIG placement spells its profile
without the dot and the plus (``gpu-0-mig-3g40gb-0-4``,
``gpu-1-mig-1g10gbme-2-1``); a checkpoint written under the old dotted
names still unprepares. The ``1g.10gb+me`` profile's placements draw their
GPU's one media counter, so the scheduler hands out one a GPU."""

import re

import pytest

from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
from k8s_dra_driver_tpu_torch.gpulib.chip import (
    MIG_PROFILES,
    GpuType,
    VfioGpuInfo,
    mig_device_name,
    mig_profile_label,
)
from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import AllocationError
from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    DYNAMIC_MIG,
    PASSTHROUGH_SUPPORT,
    new_feature_gates,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
    partitions as P,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
    STATE_PREPARE_STARTED,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    parse_mig_name,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints

#: RFC 1123 label, the form of a DRA device name.
DNS_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
H100 = GpuType.H100_SXM_80GB
PROFILES = MIG_PROFILES[H100]
GATES = f"{DYNAMIC_MIG}=true,{PASSTHROUGH_SUPPORT}=true"
MEDIA = "1g.10gb+me"


class _MigNodeWithVfio(dl.MockDeviceLib):
    """An ``h100-8`` node in MIG mode beside a ninth H100 already bound to
    vfio-pci, so every kind of device is published."""

    def vfio_gpus(self):
        return [VfioGpuInfo(index=0, pci_address="0000:e1:00.0",
                            gpu_type=H100, iommu_group=61)]


def _node(tmp_path, lib=None, client=None):
    client = client or FakeClient()
    for name, expr in P.DEVICE_CLASS_SELECTORS.items():
        if client.try_get("DeviceClass", name) is None:
            client.create(new_object("DeviceClass", name, spec={
                "selectors": [{"cel": {"expression": expr}}]}))
    if lib is None:
        lib = dl.MockDeviceLib("h100-8", mig=True)
        lib.materialize(tmp_path / "tree")
    driver = GpuDriver(client, DriverConfig(
        node_name="node-a", state_dir=str(tmp_path / "state"),
        cdi_root=str(tmp_path / "cdi"), env={}, retry_timeout=0.5,
        feature_gates=new_feature_gates(GATES)), device_lib=lib).start()
    return client, driver, lib


def _published(client):
    (s,) = client.list("ResourceSlice")
    return s["spec"]


def _claim(client, name, profile, gpu):
    return client.create(new_object(
        "ResourceClaim", name, "default", api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{"name": "gpu", "exactly": {
            "deviceClassName": P.DEVICE_CLASS_MIG,
            "allocationMode": "ExactCount", "count": 1,
            "selectors": [{"cel": {"expression": e}} for e in (
                f"device.attributes['profile'] == '{profile}'",
                f"device.attributes['parentIndex'] == {gpu}")]}}]}}))


def test_every_published_name_is_a_dns_label(tmp_path):
    client, _, _ = _node(tmp_path, lib=_MigNodeWithVfio("h100-8", mig=True))
    spec = _published(client)
    names = [d["name"] for d in spec["devices"]]
    kinds = {d["attributes"]["type"]["string"] for d in spec["devices"]}
    assert kinds == {P.DEVICE_TYPE_GPU, P.DEVICE_TYPE_MIG, P.DEVICE_TYPE_VFIO}
    bad = [n for n in names if not DNS_LABEL.match(n) or len(n) > 63]
    assert bad == []
    assert len(names) == len(set(names)) == 208 + 1
    assert "gpu-0-mig-3g40gb-0-4" in names
    assert "gpu-7-mig-1g10gbme-6-1" in names and "vfio-gpu-0" in names


def test_208_placements_with_their_counters(tmp_path):
    """Eight whole GPUs and 25 placements each (7 + 7 + 4 + 3 + 2 + 1 +
    1); the counter set holds 64 memory slices and 8 media counters, and
    only the media-extensions placements draw a media counter."""
    client, _, _ = _node(tmp_path)
    spec = _published(client)
    devices = spec["devices"]
    assert len(devices) == 208
    media = [d for d in devices if "mediaExtensions" in d["attributes"]]
    assert len(media) == 7 * 8
    assert all(d["attributes"]["profile"]["string"] == MEDIA for d in media)
    (counters,) = spec["sharedCounters"]
    assert len(counters["counters"]) == 64 + 8
    for d in devices:
        drawn = {c for cc in d.get("consumesCounters", [])
                 for c in cc["counters"]}
        wants_media = "mediaExtensions" in d["attributes"]
        assert any(c.endswith("-media") for c in drawn) == wants_media
        if wants_media:
            gpu = d["attributes"]["parentIndex"]["int"]
            assert P.media_counter_name(gpu) in drawn


@pytest.mark.parametrize("profile", [p.name for p in PROFILES])
def test_names_round_trip(profile):
    p = next(q for q in PROFILES if q.name == profile)
    for gpu in (0, 7):
        for start in p.starts:
            name = mig_device_name(gpu, profile, start, p.size)
            assert DNS_LABEL.match(name), name
            assert f"-mig-{mig_profile_label(profile)}-" in name
            assert parse_mig_name(name) == (gpu, profile, start, p.size)
            # The dotted form a checkpoint written before the repair holds.
            old = f"gpu-{gpu}-mig-{profile}-{start}-{p.size}"
            assert parse_mig_name(old) == (gpu, profile, start, p.size)


def test_labels_are_distinct():
    labels = [mig_profile_label(p.name) for p in PROFILES]
    assert len(set(labels)) == len(labels)
    assert labels[:2] == ["1g10gb", "1g10gbme"]


def _to_dotted(driver, uid):
    """Rewrite the claim's checkpoint record as a plugin that published
    dotted names wrote it."""
    def mutate(c):
        pc = c.prepared_claims[uid]
        for r in pc.results:
            idx, profile, start, size = parse_mig_name(r["device"])
            r["device"] = f"gpu-{idx}-mig-{profile}-{start}-{size}"
        for d in pc.prepared_devices:
            idx, profile, start, size = parse_mig_name(d["device"])
            d["device"] = f"gpu-{idx}-mig-{profile}-{start}-{size}"
    driver.state.checkpoints.transact(mutate)


def test_a_claim_prepared_under_a_dotted_name_unprepares(tmp_path):
    client, driver, lib = _node(tmp_path)
    claim = Allocator(client).allocate(_claim(client, "old", "3g.40gb", 0))
    uid = claim["metadata"]["uid"]
    assert driver.prepare_resource_claims([claim])[uid].error is None
    _to_dotted(driver, uid)
    driver.stop()
    # The upgraded plugin restarts over the old checkpoint.
    _, driver2, _ = _node(tmp_path, lib=lib, client=client)
    (rec,) = driver2.state.prepared_claims()[uid].prepared_devices
    assert re.fullmatch(r"gpu-0-mig-3g\.40gb-[04]-4", rec["device"])
    assert len(lib.mig_devices()) == 1
    errs = driver2.unprepare_resource_claims([ClaimRef.from_claim(claim)])
    assert errs[uid] is None
    assert lib.mig_devices() == []
    assert driver2.state.prepared_claims() == {}
    assert driver2.cdi.list_claim_uids() == []


def test_a_dotted_name_mid_prepare_is_swept(tmp_path):
    """A crash mid-prepare under the old name: the restarted plugin's
    startup sweep reads the placement from the dotted name and destroys
    the instance."""
    client, driver, lib = _node(tmp_path)
    claim = Allocator(client).allocate(_claim(client, "crashy", "2g.20gb", 0))
    uid = claim["metadata"]["uid"]
    with pytest.raises(faultpoints.FaultCrash):
        with faultpoints.injected("cdi.write=crash-nth:1"):
            driver.state.prepare(claim)
    assert driver.state.prepared_claims()[uid].state == STATE_PREPARE_STARTED
    _to_dotted(driver, uid)
    assert len(lib.mig_devices()) == 1
    _node(tmp_path, lib=lib, client=client)
    assert lib.mig_devices() == []


def test_one_media_instance_a_gpu(tmp_path):
    """The media counter lets the scheduler place one ``+me`` instance on
    GPU 1 and refuses the second there; another GPU still takes one. The
    prepared instance is of the +me profile."""
    client, driver, lib = _node(tmp_path)
    alloc = Allocator(client)
    first = alloc.allocate(_claim(client, "me-a", MEDIA, 1))
    (res,) = first["status"]["allocation"]["devices"]["results"]
    assert res["device"].startswith("gpu-1-mig-1g10gbme-")
    uid = first["metadata"]["uid"]
    assert driver.prepare_resource_claims([first])[uid].error is None
    (m,) = lib.mig_devices()
    assert (m.profile, m.parent_index) == (MEDIA, 1)
    with pytest.raises(AllocationError):
        alloc.allocate(_claim(client, "me-b", MEDIA, 1))
    # A plain 1g.10gb beside it on GPU 1 fits.
    alloc.allocate(_claim(client, "plain", "1g.10gb", 1))
    other = alloc.allocate(_claim(client, "me-c", MEDIA, 2))
    assert other["status"]["allocation"]["devices"]["results"][0][
        "device"].startswith("gpu-2-mig-1g10gbme-")


def test_the_mock_refuses_a_second_media_instance(tmp_path):
    """As NVML does: a second ``+me`` instance on one GPU is refused, at
    any free placement."""
    lib = dl.MockDeviceLib("h100-8", mig=True)
    gpu = lib.enumerate_gpus()[1]
    lib.create_mig_device(gpu, MEDIA, 0)
    with pytest.raises(dl.EnumerationError, match="media engines"):
        lib.create_mig_device(gpu, MEDIA, 3)
    lib.create_mig_device(gpu, "1g.10gb", 3)
    lib.create_mig_device(lib.enumerate_gpus()[2], MEDIA, 3)


def test_the_media_profile_in_the_table():
    (p,) = [q for q in PROFILES if q.media_extensions]
    assert (p.name, p.starts, p.size, p.compute_slices, p.nvml_index) == (
        MEDIA, (0, 1, 2, 3, 4, 5, 6), 1, 1, 7)


def test_the_meter_bills_a_media_placement_one_slice(tmp_path):
    """The usage meter bills a device the cells of its box: a
    ``1g.10gb+me`` placement one memory slice, like a ``1g.10gb``, though
    it also draws its GPU's media counter."""
    from k8s_dra_driver_tpu_torch.pkg.usage import UsageMeter
    client, _, _ = _node(tmp_path)
    meter = UsageMeter(client)

    def units(device):
        return meter._gpus_of_results([{"pool": "node-a", "device": device}])

    assert units("gpu-1-mig-1g10gbme-2-1") == units("gpu-1-mig-1g10gb-2-1") \
        == 1
    assert units("gpu-0-mig-3g40gb-0-4") == 4 and units("gpu-0") == 8
