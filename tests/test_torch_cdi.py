"""The GPU port's per-claim CDI specs and their atomic publish.

The claim spec round-trips through write, read and delete, byte for byte
what the JAX package's handler writes for the same devices; it is
published atomically (tmp + rename); hostile claim UIDs are refused; and
``claim_edits_for`` builds a GPU claim's edits — ``CUDA_VISIBLE_DEVICES``
claim-wide, the ``/dev/nvidia*`` nodes per device — which the serving
engine's ``parse_visible_devices`` reads back.
"""

import json
import os

import pytest

from k8s_dra_driver_tpu.cdi import spec as jax_cdi
from k8s_dra_driver_tpu_torch.cdi.spec import (
    CDI_VERSION,
    DEFAULT_VENDOR,
    GPU_CONTROL_NODES,
    CDIDevice,
    CDIHandler,
    InvalidClaimUID,
    claim_edits_for,
)
from k8s_dra_driver_tpu_torch.compute.serving import parse_visible_devices
from k8s_dra_driver_tpu_torch.pkg.durability import (
    ENV_CHECKPOINT_FSYNC,
    atomic_publish,
)

UID = "3f2a9c1e-0b7d-4c55-9a1e-5d2f7b6c8e90"
HOSTILE_UIDS = ["../../etc/cron.d/x", "/abs/path", "a/b", "..", "",
                ".hidden", "-flag", "x..y", "uid\n"]


def _claim(handler, uid=UID, indices=(0, 2), minors=(0, 2)):
    devices, claim_edits = claim_edits_for(list(indices), list(minors))
    named = [CDIDevice(name=handler.claim_device_name(uid, d.name),
                       device_nodes=d.device_nodes) for d in devices]
    return named, claim_edits


class TestRoundTrip:
    def test_write_read_delete(self, tmp_path):
        h = CDIHandler(str(tmp_path))
        devices, claim_edits = _claim(h)
        ids = h.create_claim_spec_file(UID, devices, claim_edits=claim_edits)
        assert ids == [f"{DEFAULT_VENDOR}/claim={UID}-gpu-0",
                       f"{DEFAULT_VENDOR}/claim={UID}-gpu-2"]
        spec = h.read_claim_spec(UID)
        assert spec["cdiVersion"] == CDI_VERSION
        assert spec["kind"] == "k8s.gpu.nvidia.com/claim"
        assert [d["name"] for d in spec["devices"]] == \
            [f"{UID}-gpu-0", f"{UID}-gpu-2"]
        assert h.list_claim_uids() == [UID]
        assert parse_visible_devices(spec) == [0, 2]
        h.delete_claim_spec_file(UID)
        assert h.read_claim_spec(UID) is None
        assert h.list_claim_uids() == []
        h.delete_claim_spec_file(UID)            # idempotent
        assert list(tmp_path.iterdir()) == []

    def test_same_bytes_as_the_jax_handler(self, tmp_path):
        port = CDIHandler(str(tmp_path / "port"), dev_root="/host")
        ref = jax_cdi.CDIHandler(str(tmp_path / "jax"),
                                 vendor=DEFAULT_VENDOR, dev_root="/host")
        devices, claim_edits = _claim(port)
        port_ids = port.create_claim_spec_file(UID, devices, claim_edits)
        ref_ids = ref.create_claim_spec_file(
            UID, [jax_cdi.CDIDevice(name=d.name,
                                    device_nodes=d.device_nodes)
                  for d in devices],
            jax_cdi.CDIDevice(name="claim", env=claim_edits.env))
        assert port_ids == ref_ids
        name = f"{DEFAULT_VENDOR}-claim_{UID}.json"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()

    def test_published_atomically(self, tmp_path):
        h = CDIHandler(str(tmp_path))
        devices, claim_edits = _claim(h)
        h.create_claim_spec_file(UID, devices, claim_edits)
        first = h.read_claim_spec(UID)
        # A writer that dies mid-write leaves the published spec intact.
        path = tmp_path / f"{DEFAULT_VENDOR}-claim_{UID}.json"

        def torn(f):
            f.write('{"cdiVersion": "0.7.0", "devi')
            raise OSError("disk full")
        with pytest.raises(OSError, match="disk full"):
            atomic_publish(path, torn, tmp=path.with_suffix(".tmp"))
        assert h.read_claim_spec(UID) == first
        # Rewrites replace the whole file and leave no temporary behind.
        h.create_claim_spec_file(UID, devices[:1], claim_edits)
        assert len(h.read_claim_spec(UID)["devices"]) == 1
        assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]


class TestAtomicPublish:
    def test_payload_kinds_and_signature(self, tmp_path):
        p = tmp_path / "state"
        for data, want in (("text", b"text"), (b"\x00bytes", b"\x00bytes"),
                           (lambda f: json.dump({"a": 1}, f), b'{"a": 1}')):
            sig = atomic_publish(p, data, sync=True)
            st = os.stat(p)
            assert p.read_bytes() == want
            assert sig == (st.st_ino, st.st_size, st.st_mtime_ns)
        assert not (tmp_path / "state.tmp").exists()

    @pytest.mark.parametrize("env,sync,synced", [
        (None, None, False), ("1", None, True), ("yes", None, False),
        ("1", False, False), (None, True, True)])
    def test_fsync_follows_the_policy_unless_told(self, tmp_path, monkeypatch,
                                                  env, sync, synced):
        calls = []
        monkeypatch.setattr(os, "fsync", calls.append)
        if env is None:
            monkeypatch.delenv(ENV_CHECKPOINT_FSYNC, raising=False)
        else:
            monkeypatch.setenv(ENV_CHECKPOINT_FSYNC, env)
        atomic_publish(tmp_path / "state", "x", sync=sync)
        assert bool(calls) == synced

    def test_before_replace_sees_the_full_tmp_and_the_old_file(
            self, tmp_path):
        p = tmp_path / "state"
        p.write_text("old")
        seen = []
        atomic_publish(p, "new", before_replace=lambda tmp: seen.append(
            (open(tmp).read(), p.read_text())))
        assert seen == [("new", "old")] and p.read_text() == "new"


class TestHostileUids:
    @pytest.mark.parametrize("uid", HOSTILE_UIDS)
    def test_refused(self, tmp_path, uid):
        root = tmp_path / "cdi"
        h = CDIHandler(str(root))
        with pytest.raises(InvalidClaimUID):
            h.create_claim_spec_file(uid, [CDIDevice(name="gpu-0")])
        assert h.read_claim_spec(uid) is None
        h.delete_claim_spec_file(uid)            # no-op, never raises
        assert list(root.iterdir()) == []
        assert list(tmp_path.iterdir()) == [root]

    def test_sweep_removes_planted_hostile_files(self, tmp_path):
        h = CDIHandler(str(tmp_path))
        h.create_claim_spec_file(UID, [CDIDevice(name="gpu-0")])
        planted = tmp_path / f"{DEFAULT_VENDOR}-claim_.evil.json"
        planted.write_text("{}")
        assert h.list_claim_uids() == [UID]
        assert h.sweep_invalid_spec_files() == [planted.name]
        assert not planted.exists() and h.read_claim_spec(UID) is not None


class TestClaimEditsFor:
    def test_visibility_claim_wide_and_nodes_per_device(self):
        devices, claim_edits = claim_edits_for([1, 3], [5, 7])
        assert claim_edits.env == {"CUDA_VISIBLE_DEVICES": "1,3",
                                   "NVIDIA_VISIBLE_DEVICES": "1,3"}
        assert claim_edits.device_nodes == []
        assert [d.name for d in devices] == ["gpu-1", "gpu-3"]
        for d, minor in zip(devices, (5, 7)):
            assert d.device_nodes == [f"/dev/nvidia{minor}",
                                      *GPU_CONTROL_NODES]
            assert d.env == {}
        assert set(GPU_CONTROL_NODES) == {
            "/dev/nvidiactl", "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools"}

    def test_spec_carries_them_with_the_dev_root_transform(self, tmp_path):
        h = CDIHandler(str(tmp_path), dev_root="/host/")
        devices, claim_edits = _claim(h, indices=(4,), minors=(4,))
        h.create_claim_spec_file(UID, devices, claim_edits)
        spec = h.read_claim_spec(UID)
        assert spec["containerEdits"] == {"env": [
            "CUDA_VISIBLE_DEVICES=4", "NVIDIA_VISIBLE_DEVICES=4"]}
        nodes = spec["devices"][0]["containerEdits"]["deviceNodes"]
        assert nodes[0] == {"path": "/dev/nvidia4",
                            "hostPath": "/host/dev/nvidia4"}
        assert [n["path"] for n in nodes[1:]] == list(GPU_CONTROL_NODES)
        assert parse_visible_devices(spec) == [4]

    def test_indices_and_minors_must_pair(self):
        with pytest.raises(ValueError):
            claim_edits_for([0, 1], [0])
