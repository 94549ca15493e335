"""Node boot-id reading for checkpoint invalidation across reboots.

Analogue of the reference's ``pkg/bootid`` (``bootid.go``): prepared-claim
checkpoints embed the boot id at write time; on startup a mismatch means the
node rebooted and all prepared state (device visibility env, CDI specs) is
stale and must be discarded (``cmd/gpu-kubelet-plugin/device_state.go:241-287``).
"""

from __future__ import annotations

import os
import uuid

from k8s_dra_driver_tpu_torch.pkg import durability

BOOT_ID_PATH = "/proc/sys/kernel/random/boot_id"
# Test/mock escape hatch (cf. ALT_PROC_DEVICES_PATH, internal/common/util.go:72).
ENV_ALT_BOOT_ID_PATH = "GPU_DRA_ALT_BOOT_ID_PATH"


def read_boot_id(env: dict[str, str] | None = None) -> str:
    e = os.environ if env is None else env
    path = e.get(ENV_ALT_BOOT_ID_PATH) or BOOT_ID_PATH
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return ""


def flip_boot_id(env: dict[str, str] | None = None) -> str:
    """Simulate a node reboot for repair flows (docs/self-healing.md): write
    a fresh boot id to the mock boot-id file and return it.

    Only the ``GPU_DRA_ALT_BOOT_ID_PATH`` override is ever written — the
    real ``/proc`` boot id belongs to the kernel, so without the override
    this is a no-op returning "" (the caller treats that as "repair done,
    no reboot to record"). The write is atomic (tmp + rename), matching the
    checkpoint layer's durability contract for the file it invalidates
    against."""
    e = os.environ if env is None else env
    path = e.get(ENV_ALT_BOOT_ID_PATH)
    if not path:
        return ""
    new_id = uuid.uuid4().hex
    durability.atomic_publish(path, new_id + "\n")
    return new_id
