"""The port's GPU device library (``k8s_dra_driver_tpu_torch/gpulib``).

The ``h100-8`` mock node, its ``materialize`` → ``SysfsDeviceLib`` round
trip (the JAX package's mock-tree pattern, ``tpulib/device_lib.py:764-821``),
the cross-checks that make a backend fail loudly, the NVML backend without
PCI facts, the fault points, and ``parse_visible_devices`` on
``GPU-<uuid>`` entries. The pieces the port copied from the JAX package
are held against it on the same inputs: the driver-root lookup, the fault
schedule decisions and the mesh geometry. All comparisons are exact.
"""

import json
import os
import shutil
import uuid

import pytest

from k8s_dra_driver_tpu.pkg import faultpoints as jax_faultpoints
from k8s_dra_driver_tpu.tpulib import root as jax_root
from k8s_dra_driver_tpu.tpulib import topology as jax_topology
from k8s_dra_driver_tpu_torch.cdi import spec as cdi_spec
from k8s_dra_driver_tpu_torch.compute.serving import (
    ServingMetrics,
    bind_engine,
    parse_visible_devices,
)
from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
from k8s_dra_driver_tpu_torch.gpulib import root as port_root
from k8s_dra_driver_tpu_torch.gpulib import topology as port_topology
from k8s_dra_driver_tpu_torch.gpulib.chip import (
    GpuType,
    HealthState,
    NodeGpuInfo,
)
from k8s_dra_driver_tpu_torch.pkg import faultpoints

H100 = GpuType.H100_SXM_80GB


@pytest.fixture()
def mock():
    return dl.MockDeviceLib("h100-8")


@pytest.fixture()
def tree(mock, tmp_path):
    dev, sysfs, proc = mock.materialize(tmp_path)
    return dev, sysfs, proc


def sysfs_lib(tree, **kw):
    dev, sysfs, proc = tree
    return dl.SysfsDeviceLib(dev_root=dev, sysfs_root=sysfs, proc_root=proc,
                             env={}, **kw)


class TestMockNode:
    def test_h100_8_enumeration(self, mock):
        gpus = mock.enumerate_gpus()
        assert [g.index for g in gpus] == list(range(8))
        assert [g.canonical_name for g in gpus] == [f"gpu-{i}"
                                                    for i in range(8)]
        assert sorted(g.minor for g in gpus) == list(range(8))
        assert [g.numa_node for g in gpus] == [0] * 4 + [1] * 4
        assert [g.pci_address for g in gpus] == sorted(
            g.pci_address for g in gpus)
        assert len({g.uuid for g in gpus}) == 8
        assert all(g.uuid.startswith("GPU-") for g in gpus)
        for g in gpus:
            uuid.UUID(g.uuid[4:])            # a well-formed UUID
            assert g.gpu_type is H100
            assert g.memory_bytes == 81559 << 20
            assert g.product_name == "NVIDIA H100 80GB HBM3"
            assert g.device_paths == [f"/dev/nvidia{g.minor}"]
            assert g.health.state is HealthState.HEALTHY
        spec = H100.spec
        assert (spec.sm_count, spec.compute_capability, spec.nvlink_links) \
            == (132, (9, 0), 18)

    def test_uuids_are_fixed(self, mock):
        again = dl.MockDeviceLib("h100-8")
        assert [g.uuid for g in mock.enumerate_gpus()] == \
            [g.uuid for g in again.enumerate_gpus()]
        assert mock.node_info() == again.node_info()
        assert mock.node_info().clique_id.endswith(".0")
        assert mock.node_info().num_gpus == 8

    def test_profile_from_json_file_and_dict(self, mock, tmp_path):
        path = tmp_path / "p.json"
        path.write_text(json.dumps(mock.profile))
        assert dl.MockDeviceLib(str(path)).enumerate_gpus() == \
            mock.enumerate_gpus()
        assert dl.MockDeviceLib(dict(mock.profile)).enumerate_gpus() == \
            mock.enumerate_gpus()

    def test_health_levers(self, mock):
        g = mock.enumerate_gpus()[2]
        mock.set_unhealthy(2, reason="xid 79", xid_errors=1)
        assert mock.gpu_health(g).state is HealthState.UNHEALTHY
        assert mock.enumerate_gpus()[2].health.reason == "xid 79"
        mock.set_healthy(2)
        assert mock.gpu_health(g).state is HealthState.HEALTHY


class TestMaterializedTree:
    def test_round_trip_equals_the_mock(self, mock, tree):
        lib = sysfs_lib(tree)
        assert lib.backend == dl.BACKEND_PROCFS
        assert lib.enumerate_gpus() == mock.enumerate_gpus()
        info = lib.node_info()
        assert info == NodeGpuInfo(
            node_uuid=mock.node_info().node_uuid, num_gpus=8, gpu_type=H100,
            backend=dl.BACKEND_PROCFS)

    def test_enumeration_is_cached_until_refresh(self, tree, tmp_path):
        lib = sysfs_lib(tree)
        assert len(lib.enumerate_gpus()) == 8
        proc = tree[2]
        shutil.rmtree(os.path.join(proc, "driver", "nvidia", "gpus",
                                   "0000:db:00.0"))
        assert len(lib.enumerate_gpus()) == 8
        lib.refresh()
        assert len(lib.enumerate_gpus()) == 8 - 1

    def test_no_proc_tree_finds_nothing(self, tmp_path):
        lib = dl.SysfsDeviceLib(dev_root=str(tmp_path), sysfs_root=str(tmp_path),
                                proc_root=str(tmp_path), env={})
        assert lib.enumerate_gpus() == []
        assert lib.node_info().num_gpus == 0

    @pytest.mark.parametrize("what", ["vendor", "device", "dev_node",
                                      "sysfs_dir", "info_field"])
    def test_cross_check_failures_raise(self, tree, what):
        dev, sysfs, proc = tree
        bdf = "0000:2a:00.0"
        pci = os.path.realpath(os.path.join(sysfs, "bus", "pci", "devices",
                                            bdf))
        if what == "vendor":
            open(os.path.join(pci, "vendor"), "w").write("0x1ae0\n")
        elif what == "device":
            open(os.path.join(pci, "device"), "w").write("0x1234\n")
        elif what == "dev_node":
            os.remove(os.path.join(dev, "nvidia1"))
        elif what == "sysfs_dir":
            os.remove(os.path.join(sysfs, "bus", "pci", "devices", bdf))
        else:
            info = os.path.join(proc, "driver", "nvidia", "gpus", bdf,
                                "information")
            text = open(info).read().replace("GPU UUID", "GPU ID")
            open(info, "w").write(text)
        with pytest.raises(dl.EnumerationError):
            sysfs_lib(tree).enumerate_gpus()

    def test_gpu_health_reads_the_tree(self, tree):
        lib = sysfs_lib(tree)
        g = lib.enumerate_gpus()[5]
        assert lib.gpu_health(g).state is HealthState.HEALTHY
        os.remove(os.path.join(tree[0], f"nvidia{g.minor}"))
        assert lib.gpu_health(g).state is HealthState.UNHEALTHY

    def test_new_device_lib_selects_by_env(self, tree):
        dev, sysfs, proc = tree
        assert isinstance(dl.new_device_lib(
            {dl.ENV_MOCK_PROFILE: "h100-8"}), dl.MockDeviceLib)
        lib = dl.new_device_lib({dl.ENV_DEV_ROOT: dev,
                                 dl.ENV_SYSFS_ROOT: sysfs,
                                 dl.ENV_PROC_ROOT: proc})
        assert isinstance(lib, dl.SysfsDeviceLib)
        assert len(lib.enumerate_gpus()) == 8
        assert lib.backend == dl.BACKEND_PROCFS
        with pytest.raises(ValueError, match="backend"):
            dl.SysfsDeviceLib(dev_root=dev, sysfs_root=sysfs,
                              proc_root=proc, backend="pci", env={})

    def test_locate_gpu(self, mock, tree, tmp_path):
        dev, sysfs, proc = tree
        env = {dl.ENV_DEV_ROOT: dev, dl.ENV_SYSFS_ROOT: sysfs,
               dl.ENV_PROC_ROOT: proc,
               "GPU_DRA_DRIVER_ROOT": str(tmp_path / "noroot"),
               dl.ENV_NVML_LIBRARY: ""}
        want = mock.enumerate_gpus()[6]
        assert dl.new_device_lib(env).backend == dl.BACKEND_PROCFS
        lib, gpu = dl.locate_gpu(want.uuid.lower(), env)
        assert lib.backend == dl.BACKEND_PROCFS and gpu == want
        with pytest.raises(dl.EnumerationError, match="no backend"):
            dl.locate_gpu("GPU-00000000-0000-0000-0000-000000000000", env)


class _FakeNvml:
    """Stands in for the NVML binding: what a sandboxed container's NVML
    reports (no PCI address, no device id)."""

    def __init__(self, gpus):
        self.gpus = gpus

    def enumerate(self):
        return list(self.gpus), "580.159.03"


class TestNvmlBackend:
    def test_gpu_without_pci_facts(self, tmp_path):
        (tmp_path / "nvidia5").write_text("")
        raw = dl.RawGpu(uuid="GPU-73c4229c-ad5b-35c2-99a6-411722b9ffae",
                        minor=5, pci_bdf="",
                        product_name="NVIDIA H100 80GB HBM3",
                        memory_bytes=85520809984)
        lib = dl.SysfsDeviceLib(dev_root=str(tmp_path),
                                sysfs_root=str(tmp_path / "nosys"),
                                backend=dl.BACKEND_NVML, env={},
                                nvml=_FakeNvml([raw]))
        (g,) = lib.enumerate_gpus()
        assert (g.index, g.minor, g.uuid, g.gpu_type) == (0, 5, raw.uuid, H100)
        assert (g.pci_address, g.pci_device_id, g.numa_node) == ("", 0, -1)
        assert g.memory_bytes == 85520809984
        assert g.driver_version == "580.159.03"
        assert lib.node_info().backend == dl.BACKEND_NVML

    def test_missing_device_node_raises(self, tmp_path):
        raw = dl.RawGpu(uuid="GPU-x", minor=3, pci_bdf="",
                        product_name="NVIDIA H100 80GB HBM3")
        lib = dl.SysfsDeviceLib(dev_root=str(tmp_path), backend="nvml",
                                env={}, nvml=_FakeNvml([raw]))
        with pytest.raises(dl.EnumerationError, match="nvidia3"):
            lib.enumerate_gpus()

    def test_unknown_product_raises(self, tmp_path):
        (tmp_path / "nvidia0").write_text("")
        raw = dl.RawGpu(uuid="GPU-y", minor=0, pci_bdf="",
                        product_name="NVIDIA A100-SXM4-80GB")
        lib = dl.SysfsDeviceLib(dev_root=str(tmp_path), backend="nvml",
                                env={}, nvml=_FakeNvml([raw]))
        with pytest.raises(dl.EnumerationError, match="no GPU spec"):
            lib.enumerate_gpus()

    def test_missing_library_raises(self):
        with pytest.raises(dl.EnumerationError, match="cannot load NVML"):
            dl.NvmlBinding(lib_path="/nonexistent/libnvidia-ml.so.1")

    def test_asked_for_backend_fails_loudly(self, tmp_path):
        env = {"GPU_DRA_DRIVER_ROOT": str(tmp_path),
               dl.ENV_NVML_LIBRARY: str(tmp_path / "libnvidia-ml.so.1")}
        lib = dl.SysfsDeviceLib(backend=dl.BACKEND_NVML, env=env)
        with pytest.raises(dl.EnumerationError):
            lib.enumerate_gpus()


class TestHelpers:
    @pytest.mark.parametrize("raw,want", [
        ("00000000:18:00.0", "0000:18:00.0"),
        ("0000:DB:00.0", "0000:db:00.0"),
        ("0001:3a:1f.7", "0001:3a:1f.7"),
    ])
    def test_normalize_bdf(self, raw, want):
        assert dl.normalize_bdf(raw) == want

    def test_normalize_bdf_rejects(self):
        with pytest.raises(dl.EnumerationError):
            dl.normalize_bdf("18:00")

    @pytest.mark.parametrize("raw,want", [
        ("550.54.15", "550.54.15"), ("535.104.05", "535.104.5"),
        ("580.159.03", "580.159.3"), ("560.28", "560.28.0"), ("", ""),
        ("r550", ""),
    ])
    def test_semver_driver_version(self, raw, want):
        assert dl.semver_driver_version(raw) == want

    def test_parse_information(self):
        info = dl.parse_information(
            "Model: \t\t NVIDIA H100 80GB HBM3\nGPU UUID: \t GPU-1\n"
            "Bus Location: \t 0000:18:00.0\nDevice Minor: \t 0\n")
        assert info["Model"] == "NVIDIA H100 80GB HBM3"
        assert info["Bus Location"] == "0000:18:00.0"

    def test_fabric_consistency(self, mock):
        gpus = mock.enumerate_gpus()
        assert dl.fabric_consistency_problems(gpus) == []
        gpus[3].minor = gpus[2].minor
        problems = dl.fabric_consistency_problems(gpus)
        assert problems and "minor" in problems[0]
        with pytest.raises(dl.EnumerationError, match="strict"):
            dl.enforce_fabric_consistency(gpus, strict=True)
        dl.enforce_fabric_consistency(gpus, strict=False)


class TestFaultPoints:
    def test_enumerate_fails_wholesale(self, mock, tree):
        for lib in (mock, sysfs_lib(tree)):
            with faultpoints.injected("gpulib.enumerate=nth:1"):
                with pytest.raises(dl.EnumerationError):
                    lib.enumerate_gpus()
                assert len(lib.enumerate_gpus()) == 8

    def test_vanish_and_unhealthy(self, mock, tree):
        for lib in (mock, sysfs_lib(tree)):
            with faultpoints.injected("gpulib.gpu.vanish=nth:2;"
                                      "gpulib.gpu.unhealthy=nth:1"):
                first = lib.enumerate_gpus()
                second = lib.enumerate_gpus()
            assert first[0].health.state is HealthState.UNHEALTHY
            assert len(first) == 8 and len(second) == 7
            assert second[-1].index == 6
            assert lib.enumerate_gpus()[0].health.state is \
                HealthState.HEALTHY

    def test_registered(self):
        assert cdi_spec.FP_CDI_WRITE == "cdi.write"
        names = dict(faultpoints.iter_points())
        for n in ("gpulib.enumerate", "gpulib.gpu.vanish",
                  "gpulib.gpu.unhealthy", "cdi.write"):
            assert n in names

    @pytest.mark.parametrize("spec", [
        "seed=7;p=rate:0.3", "p=every:3", "p=first:4", "p=nth:5",
        "seed=11;p=rate:0.9:conflict", "p=crash-nth:2",
    ])
    def test_schedules_decide_as_the_jax_package(self, spec):
        ours = faultpoints.FaultPlan(spec)
        theirs = jax_faultpoints.FaultPlan(spec)
        assert [ours.hit("p")[0] for _ in range(40)] == \
            [theirs.hit("p")[0] for _ in range(40)]

    @pytest.mark.parametrize("spec", ["p=sometimes:1", "p=nth:0",
                                      "p=rate:2", "seed=x", "p"])
    def test_bad_specs_rejected_as_the_jax_package(self, spec):
        with pytest.raises(jax_faultpoints.FaultSpecError):
            jax_faultpoints.FaultPlan(spec)
        with pytest.raises(faultpoints.FaultSpecError):
            faultpoints.FaultPlan(spec)


class TestCopiedFromTheJaxPackage:
    def test_driver_root_as_the_jax_package(self, tmp_path):
        lib = tmp_path / "usr" / "lib" / "x86_64-linux-gnu"
        lib.mkdir(parents=True)
        (lib / "libnvidia-ml.so.1").write_text("")
        for name in ("libnvidia-ml.so.1", "libcuda.so.1"):
            ours = port_root.Root(str(tmp_path), "/run/nvidia/driver")
            theirs = jax_root.Root(str(tmp_path), "/run/nvidia/driver")
            found = ours.find_file(name, *port_root.LIB_SEARCH_PATHS)
            assert found == theirs.find_file(name, *jax_root.LIB_SEARCH_PATHS)
            if found:
                assert ours.host_path(found) == theirs.host_path(found) == \
                    "/run/nvidia/driver/usr/lib/x86_64-linux-gnu/" + name
        assert port_root.Root(str(tmp_path)).find_libnvidia_ml() == \
            str(lib / "libnvidia-ml.so.1")
        env = {"GPU_DRA_DRIVER_ROOT": "/host",
               "GPU_DRA_DRIVER_ROOT_HOST_PREFIX": "/opt/x"}
        r = port_root.resolve_driver_root(env)
        assert (str(r.path), str(r.host_prefix)) == ("/host", "/opt/x")

    @pytest.mark.parametrize("dims", [(2, 4), (4, 4, 4), (8,)])
    def test_topology_as_the_jax_package(self, dims):
        ours = port_topology.Topology(dims=dims)
        theirs = jax_topology.Topology(dims=dims)
        assert list(ours.all_coords()) == list(theirs.all_coords())
        assert ours.num_chips == theirs.num_chips
        assert [ours.coords_of(i) for i in range(ours.num_chips)] == \
            [theirs.coords_of(i) for i in range(theirs.num_chips)]
        shapes = ours.standard_subslice_shapes()
        assert shapes == theirs.standard_subslice_shapes()
        assert [(b.origin, b.shape) for b in ours.enumerate_subslices(shapes)] \
            == [(b.origin, b.shape)
                for b in theirs.enumerate_subslices(shapes)]


class TestParseVisibleDevicesUuids:
    UUIDS = {"GPU-aaaa": 3, "GPU-BBBB": 0}

    def spec(self, val):
        return {"containerEdits": {"env": [f"CUDA_VISIBLE_DEVICES={val}"]}}

    def test_uuid_entries_map_through_the_callers_table(self):
        assert parse_visible_devices(self.spec("GPU-aaaa,GPU-bbbb"),
                                     self.UUIDS) == [0, 3]
        assert parse_visible_devices(self.spec("gpu-AAAA, 1"),
                                     self.UUIDS) == [1, 3]

    def test_mock_claim_uuids(self, mock):
        gpus = mock.enumerate_gpus()
        table = {g.uuid: g.index for g in gpus}
        val = ",".join(g.uuid for g in (gpus[6], gpus[1]))
        assert parse_visible_devices(self.spec(val), table) == [1, 6]

    @pytest.mark.parametrize("val", ["GPU-cccc", "MIG-aaaa", "x1"])
    def test_unknown_entries_raise(self, val):
        with pytest.raises(ValueError):
            parse_visible_devices(self.spec(val), self.UUIDS)

    def test_mig_entries_map_through_the_table_or_cuda(self, monkeypatch):
        """A ``MIG-<uuid>`` entry is a device of its own: matched in the
        caller's table, or among the CUDA devices (whose UUIDs torch
        reports without the prefix)."""
        import torch
        spec = self.spec("MIG-1111,GPU-bbbb")
        assert parse_visible_devices(spec, {"MIG-1111": 2,
                                            **self.UUIDS}) == [0, 2]

        class Props:
            def __init__(self, u):
                self.uuid = u
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: Props(["aaaa", "1111"][i]))
        assert parse_visible_devices(self.spec("MIG-1111")) == [1]
        assert parse_visible_devices(self.spec("GPU-aaaa")) == [0]
        with pytest.raises(ValueError, match="no device has the UUID"):
            parse_visible_devices(self.spec("MIG-2222"))

    def test_uuid_without_a_table_or_cuda_raises(self, monkeypatch):
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ValueError, match="neither a UUID mapping"):
            parse_visible_devices(self.spec("GPU-aaaa"))

    def test_bind_engine_uses_the_table(self):
        eng = bind_engine(self.spec("GPU-aaaa,GPU-bbbb"), "u", device="cpu",
                          uuids=self.UUIDS, metrics=ServingMetrics())
        assert eng.n_chips == 2
