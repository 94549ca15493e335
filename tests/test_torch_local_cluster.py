"""The GPU port's local process cluster (``internal/localcluster.py``), the
counterpart of ``tests/test_local_cluster.py``: the webhook, the API server,
two elected controllers, two node pairs of kubelet plugins and the
ComputeDomain daemons as real OS processes, driving the GPU quickstart
matrix in eight phases (``run_demo``; slow, as the JAX demo's test is), a
short leg of one node (the webhook's refusal and gpu-test1, under a 60 s
limit), and the ``_read_banner`` deadline contract."""

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from k8s_dra_driver_tpu_torch.internal.localcluster import LocalCluster

REPO = Path(__file__).resolve().parents[1]
MODULE = "k8s_dra_driver_tpu_torch.internal.localcluster"

#: One line per phase of ``run_demo`` that its test requires.
PASS_LINES = (
    "webhook: typo'd config rejected at admission — PASS",
    "gpu-test5: ComputeDomain Ready — PASS",
    "gpu-test5: every GPU's counters free after unprepare — PASS",
    "gpu-test4: disjoint 3g.40gb tenants",
    "gpu-test7: implicit claim",
    "took over and reconciled — PASS",
    "gpu-test6: unprepare restored original driver — PASS",
    "updowngrade: adopted claim unprepared cleanly — PASS",
    "cd-updowngrade: adopted channel claim unprepared — PASS",
    "ALL PHASES PASS",
)


@pytest.mark.slow
def test_local_cluster_demo():
    r = subprocess.run(
        [sys.executable, "-m", MODULE, "demo", "--timeout", "90"],
        capture_output=True, text=True, timeout=400, cwd=str(REPO))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for want in PASS_LINES:
        assert want in r.stdout, want


def test_the_short_leg_in_real_processes():
    """One node behind the webhook: a typo'd config refused at admission,
    then gpu-test1's two pods on distinct GPUs, prepared by the plugin
    process; every process stopped after."""
    child = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
             f"from {MODULE} import run_quick; run_quick()")
    r = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=60, cwd=str(REPO))
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "webhook: typo'd config rejected at admission — PASS" in r.stdout
    assert "gpu-test1: exclusive GPUs" in r.stdout


class _FakeProc:
    """Just enough Popen for _read_banner: an iterable stdout and poll()."""

    def __init__(self, stdout, poll_result=None):
        self.stdout = stdout
        self._poll = poll_result

    def poll(self):
        return self._poll


class TestReadBanner:
    """The _read_banner deadline contract: a wedged or dead child fails
    fast against the monotonic clock, never blocking the cluster on
    readline()."""

    def test_banner_found_returns_last_word(self):
        proc = _FakeProc(iter(["booting...\n",
                               "api listening on http://127.0.0.1:61234\n"]))
        got = LocalCluster._read_banner(proc, "listening on", 5.0)
        assert got == "http://127.0.0.1:61234"

    def test_dead_child_fails_fast_before_deadline(self):
        proc = _FakeProc(iter([]), poll_result=1)
        t0 = time.monotonic()
        got = LocalCluster._read_banner(proc, "listening on", 30.0)
        elapsed = time.monotonic() - t0
        assert got == ""
        assert elapsed < 5.0, f"dead child took {elapsed:.1f}s to fail"

    def test_wedged_child_expires_at_monotonic_deadline(self):
        hang = threading.Event()

        def wedged_stdout():
            hang.wait(timeout=30)
            if False:
                yield ""

        proc = _FakeProc(wedged_stdout(), poll_result=None)
        t0 = time.monotonic()
        try:
            got = LocalCluster._read_banner(proc, "listening on", 1.0)
            elapsed = time.monotonic() - t0
        finally:
            hang.set()
        assert got == ""
        assert 0.9 <= elapsed < 5.0, f"deadline not honored: {elapsed:.1f}s"


def test_the_smokes_cluster_phase_on_a_mock_node(tmp_path, monkeypatch,
                                                 capsys):
    """``chip_smoke.phase_cluster``'s card leg as the card runs it, with a
    one-GPU mock profile file in place of NVML and a small CPU engine:
    gpu-test2 applied unchanged, its claim prepared by the plugin process,
    both containers on the GPU's UUID, the batch served, nothing left."""
    import json

    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build
    from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
    from tests.test_torch_crashlab import SMALL_CHECK_WIDTH

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    profile = dl._h100_8_profile(0)
    profile["gpus"] = profile["gpus"][:1]
    path = tmp_path / "one-gpu.json"
    path.write_text(json.dumps(profile))
    gpu = dl.MockDeviceLib(profile).enumerate_gpus()[0]
    out = chip_smoke.phase_cluster(
        "mock", 0, gpu, width={**SMALL_CHECK_WIDTH, "uuids": {gpu.uuid: 0}},
        profile=str(path), host_leg=False)
    assert out["launches"] == 0 and out["decode_steps"] > 0  # plain on CPU
    assert out["residue"] == [] and out["children"] == []
    assert out["max_abs_err"] is None
    text = capsys.readouterr().out
    assert text.count("[cluster] leg=card") == 1
    assert json.dumps({"ctr0": gpu.uuid, "ctr1": gpu.uuid}) in text


def test_the_smokes_cluster_phase_refuses_a_node_without_nvml(
        tmp_path, monkeypatch):
    """No fallback: where NVML does not load, the card leg's plugin process
    exits instead of reading the GPUs another way, and the phase fails."""
    import chip_smoke
    from k8s_dra_driver_tpu_torch.compute import _build
    from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("GPU_DRA_NVML_LIBRARY", str(tmp_path / "no-nvml.so"))
    monkeypatch.setattr(LocalCluster, "UP_TIMEOUT_S", 5.0)
    gpu = dl.MockDeviceLib("h100-8").enumerate_gpus()[0]
    with pytest.raises(TimeoutError, match="GPU slices"):
        chip_smoke.phase_cluster("mock", 0, gpu, host_leg=False)


class TestWhatTheClusterRunsOn:
    """The knobs a plugin process of the cluster is started with."""

    def test_the_device_backend_env_picks_the_library(self, tmp_path):
        from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
        dev, sysfs, proc = dl.MockDeviceLib("h100-8").materialize(tmp_path)
        env = {dl.ENV_DEV_ROOT: dev, dl.ENV_SYSFS_ROOT: sysfs,
               dl.ENV_PROC_ROOT: proc,
               dl.ENV_NVML_LIBRARY: str(tmp_path / "no-nvml.so")}
        # Auto: a named NVML library is taken to be there (and fails).
        assert dl.new_device_lib(env=env).backend == dl.BACKEND_NVML
        lib = dl.new_device_lib(env={**env, dl.ENV_DEVICE_BACKEND: "procfs"})
        assert lib.backend == dl.BACKEND_PROCFS
        assert len(lib.enumerate_gpus()) == 8
        nvml = dl.new_device_lib(env={**env, dl.ENV_DEVICE_BACKEND: "nvml"})
        with pytest.raises(dl.EnumerationError):
            nvml.enumerate_gpus()
        with pytest.raises(dl.EnumerationError, match="want nvml or procfs"):
            dl.new_device_lib(env={**env, dl.ENV_DEVICE_BACKEND: "mock"})
        # A mock profile still wins over the backend.
        assert dl.new_device_lib(env={**env, dl.ENV_DEVICE_BACKEND: "nvml"},
                                 mock_profile="h100-8").backend == "mock"

    def test_a_profile_file_turns_mig_mode_on(self, tmp_path):
        import json

        from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
        path = tmp_path / "mig.json"
        path.write_text(json.dumps({**dl.PROFILES["h100-8"](1),
                                    "mig": True}))
        lib = dl.MockDeviceLib(str(path), host_index=1)
        gpus = lib.enumerate_gpus()
        assert len(gpus) == 8 and all(g.mig_enabled for g in gpus)
        assert [g.uuid for g in gpus] == [
            g.uuid for g in dl.MockDeviceLib(
                "h100-8", host_index=1).enumerate_gpus()]
        assert not any(g.mig_enabled for g in dl.MockDeviceLib(
            "h100-8").enumerate_gpus())

    def test_the_fake_vfio_kernel_env(self, tmp_path, monkeypatch):
        from k8s_dra_driver_tpu_torch.gpulib import device_lib as dl
        from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
        from k8s_dra_driver_tpu_torch.pkg.featuregates import (
            new_feature_gates,
        )
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
            DriverConfig,
            GpuDriver,
        )
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
            device_state,
        )
        dev, sysfs, proc = dl.MockDeviceLib("h100-8").materialize(tmp_path)
        lib = dl.SysfsDeviceLib(dev_root=dev, sysfs_root=sysfs,
                                proc_root=proc, env={})

        def driver(name):
            return GpuDriver(FakeClient(), DriverConfig(
                node_name="n", state_dir=str(tmp_path / name),
                cdi_root=str(tmp_path / f"{name}-cdi"), env={},
                feature_gates=new_feature_gates("PassthroughSupport=true")),
                device_lib=lib)
        assert not isinstance(driver("a").state.vfio.kernel,
                              dl.FakeVfioKernel)
        monkeypatch.setenv(device_state.ENV_FAKE_VFIO_KERNEL, "1")
        mgr = driver("b").state.vfio
        assert isinstance(mgr.kernel, dl.FakeVfioKernel)
        assert str(mgr.sysfs) == sysfs


class TestCdiSpecReads:
    def test_a_spec_removed_between_glob_and_read_reads_as_gone(
            self, tmp_path, monkeypatch):
        """An unprepare deletes a claim's CDI spec while a waiter polls
        for that: the read after the glob finds no file, which is the
        answer the waiter waits for, not an error."""
        cluster = LocalCluster.__new__(LocalCluster)
        cluster.workdir = tmp_path
        cdi = tmp_path / "node-0" / "gpu-cdi"
        cdi.mkdir(parents=True)
        spec = cdi / "k8s.gpu.nvidia.com-claim_u1.json"
        spec.write_text('{"containerEdits": {"env": ["A=1"]}}')
        assert cluster.claim_cdi_spec("node-0", "u1") is not None
        assert cluster.container_env("node-0", ["u1"]) == {"A": "1"}
        read_text = Path.read_text

        def unprepared_meanwhile(path, *a, **kw):
            if path == spec:
                spec.unlink()
            return read_text(path, *a, **kw)
        monkeypatch.setattr(Path, "read_text", unprepared_meanwhile)
        assert cluster.claim_cdi_spec("node-0", "u1") is None
        spec.write_text('{"containerEdits": {"env": ["A=1"]}}')
        assert cluster.container_env("node-0", ["u1"]) == {}
