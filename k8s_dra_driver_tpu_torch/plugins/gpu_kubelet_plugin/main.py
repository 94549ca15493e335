"""GPU kubelet plugin entrypoint.

The counterpart of the JAX package's ``plugins/tpu_kubelet_plugin/main.py``
(the analogue of ``cmd/gpu-kubelet-plugin/main.go:89-359``): flag parsing
with env mirrors, flag validation, debug signal handlers, metrics + gRPC
health servers, driver assembly, resource publication, and signal-driven
shutdown.

Run against the machine's own GPUs (NVML where the host has it)::

    python -m k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin \
        --node-name node-0 --api-endpoint http://127.0.0.1:8700 \
        --state-dir /var/lib/gpu-dra --cdi-root /var/run/cdi

or on the mock backend with ``--mock-profile h100-8``.
``--feature-gates DynamicMIG=true,PassthroughSupport=true`` publishes the
MIG placements of the GPUs in MIG mode and the vfio-bound GPUs, and
prepares both. Point
``--api-endpoint`` at ``python -m k8s_dra_driver_tpu_torch.k8sclient.httpapi``
to share cluster state with other processes; empty, the plugin runs on an
in-process fake API of its own.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Optional

from k8s_dra_driver_tpu_torch.internal.common import (
    standard_debug_handlers,
    start_debug_signal_handlers,
)
from k8s_dra_driver_tpu_torch.internal.info import version_string
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import DrainController
from k8s_dra_driver_tpu_torch.pkg import flags, sanitizer
from k8s_dra_driver_tpu_torch.pkg.blackbox import ContinuousProfiler
from k8s_dra_driver_tpu_torch.pkg.featuregates import DEVICE_HEALTH_CHECK
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    DRAMetrics,
    MetricsServer,
    default_allocator_metrics,
    default_informer_metrics,
    default_node_metrics,
    default_remediation_metrics,
)
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    NodeLeaseHeartbeat,
    fence_cleanup_for,
)
from k8s_dra_driver_tpu_torch.pkg.process import (
    ProcessHandle,
    block_until_signaled,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.cleanup import (
    CheckpointCleanupManager,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.driver import (
    DriverConfig,
    GpuDriver,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health import (
    attach_health_monitor,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck import (
    HealthcheckServer,
    driver_probe,
    require_grpc,
)

logger = logging.getLogger(__name__)

BINARY = "gpu-kubelet-plugin"


def default_health_sock(name: str) -> str:
    """The default gRPC health address: a unix socket in the temp dir."""
    return "unix://" + os.path.join(tempfile.gettempdir(), name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=BINARY, description="GPU DRA kubelet plugin (gpu.nvidia.com)")
    flags.add_logging_flags(p)
    flags.add_api_client_flags(p)
    flags.add_feature_gate_flags(p)
    flags.add_node_flags(p)
    flags.add_plugin_path_flags(p, DRIVER_NAME)
    flags.add_observability_flags(
        p, default_health_sock=default_health_sock("gpu-dra-health.sock"))
    p.add_argument("--health-poll-interval", action=flags.EnvDefault,
                   env="GPU_DRA_HEALTH_POLL_INTERVAL", type=float, default=5.0)
    p.add_argument("--remediation-poll-interval", action=flags.EnvDefault,
                   env="GPU_DRA_REMEDIATION_POLL_INTERVAL", type=float,
                   default=5.0,
                   help="drain-controller poll interval (taint -> drain -> "
                        "repair -> rejoin pipeline, docs/self-healing.md); "
                        "follows the DeviceHealthCheck feature gate")
    p.add_argument("--gc-interval", action=flags.EnvDefault,
                   env="GPU_DRA_GC_INTERVAL", type=float, default=600.0)
    p.add_argument("--node-lease-duration", action=flags.EnvDefault,
                   env="GPU_DRA_NODE_LEASE_DURATION", type=float,
                   default=10.0,
                   help="node liveness lease duration in seconds (the "
                        "cluster controller declares the node lost and "
                        "cordons it after ~1.5x this without a renewal; "
                        "docs/self-healing.md, 'Whole-node repair'); "
                        "0 disables the heartbeat")
    p.add_argument("--version", action="version", version=version_string())
    return p


def validate_flags(args: argparse.Namespace) -> None:
    """Fail fast on nonsense (validateCLIFlags, main.go:268-298)."""
    if not args.node_name:
        raise SystemExit("--node-name (or NODE_NAME) is required")
    if args.health_poll_interval <= 0:
        raise SystemExit("--health-poll-interval must be > 0")
    if args.remediation_poll_interval <= 0:
        raise SystemExit("--remediation-poll-interval must be > 0")
    if args.gc_interval <= 0:
        raise SystemExit("--gc-interval must be > 0")
    if args.node_lease_duration < 0:
        raise SystemExit("--node-lease-duration must be >= 0 (0 disables)")
    if args.profile_interval < 0:
        raise SystemExit("--profile-interval must be >= 0 (0 disables)")


def run_plugin(args: argparse.Namespace, block: bool = True) -> ProcessHandle:
    """Assemble and start the full plugin process. ``block=True``
    (production) waits for SIGTERM/SIGINT and stops everything before
    returning; ``block=False`` (tests/embedding) returns the running
    handle — the caller owns ``handle.stop()``."""
    gates = flags.parse_feature_gates(args)
    flags.log_startup_config(BINARY, args, gates)
    flags.enable_tracing_if_requested(args)
    if args.healthcheck_addr:
        require_grpc()
    flags.tune_interpreter()
    # Before any assembly: locks record contention only if profiling is
    # on when they are CREATED (pkg/sanitizer).
    if getattr(args, "lock_profile", False):
        sanitizer.set_lock_profiling(True)
    client = flags.build_client(args)
    device_lib = flags.build_device_lib(args)

    # Continuous profiling (docs/observability.md): always-on low-rate
    # sampling over every thread, served via /debug/profile.
    profiler = None
    if getattr(args, "profile_interval", 0) > 0:
        profiler = ContinuousProfiler(
            base_interval_s=args.profile_interval).start()

    cfg = DriverConfig(
        node_name=args.node_name,
        state_dir=args.state_dir,
        cdi_root=args.cdi_root,
        feature_gates=gates,
    )
    metrics = DRAMetrics()
    driver = GpuDriver(client, cfg, device_lib=device_lib,
                       metrics=metrics).start()

    # Node liveness (docs/self-healing.md, "Whole-node repair"): renew
    # the per-node lease; on heal from a fence (partition, node-lost
    # cordon) unwind moved claims before serving again.
    heartbeat = None
    if args.node_lease_duration > 0:
        heartbeat = NodeLeaseHeartbeat(
            client, args.node_name, state_dir=args.state_dir,
            lease_duration=args.node_lease_duration,
            identity=BINARY,
            fence_cleanup=fence_cleanup_for(driver, client)).start()
    fence_gate = ((lambda: heartbeat.fenced or heartbeat.suspect)
                  if heartbeat is not None else None)

    servers: list = []
    if args.metrics_port >= 0:
        ms = MetricsServer(metrics.registry,
                           default_informer_metrics().registry,
                           default_allocator_metrics().registry,
                           default_remediation_metrics().registry,
                           default_node_metrics().registry,
                           port=args.metrics_port,
                           debug=standard_debug_handlers()).start()
        logger.info("metrics on http://127.0.0.1:%d/metrics "
                    "(+ /debug/{traces,informers,workqueue,inflight,...})",
                    ms.port)
        servers.append(ms)

    # Health monitoring + remediation are gate-controlled together
    # (NVMLDeviceHealthCheck analogue): the drain controller closes the
    # loop the monitor's taints open (docs/self-healing.md). No repair
    # hook here — production waits for external repair and rejoins once
    # the GPU reports healthy again.
    monitor = None
    drainer = None
    if gates.enabled(DEVICE_HEALTH_CHECK):
        monitor = attach_health_monitor(
            driver, poll_interval=args.health_poll_interval)
        drainer = DrainController(
            client, driver,
            poll_interval=args.remediation_poll_interval).start()
    else:
        logger.info("device health monitoring disabled by feature gate")

    if args.healthcheck_addr:
        servers.append(HealthcheckServer(
            lambda: driver_probe(driver, drainer=drainer, fenced=fence_gate),
            address=args.healthcheck_addr).start())

    gc = CheckpointCleanupManager(
        client, driver.state, interval=args.gc_interval).start()

    # The kubelet-role loop: drives prepare/unprepare from claim state so a
    # bare-process cluster works without a kubelet. state_dir persists the
    # informer's resourceVersion alongside the checkpoint, so a restart
    # resumes the watch instead of relisting.
    prep_loop = NodePrepareLoop(
        client, driver, DRIVER_NAME, driver.pool_name,
        state_dir=args.state_dir, fence=fence_gate).start()

    handle = ProcessHandle(BINARY, driver=driver, servers=servers,
                           monitor=monitor, gc=gc, profiler=profiler)
    handle.on_stop(prep_loop.stop)
    if heartbeat is not None:
        handle.on_stop(heartbeat.stop)
    handle.on_stop(driver.stop)
    for s in servers:
        handle.on_stop(s.stop)
    if monitor is not None:
        handle.on_stop(monitor.stop)
    if drainer is not None:
        handle.on_stop(drainer.stop)
    if profiler is not None:
        handle.on_stop(profiler.stop)
    handle.on_stop(gc.stop)
    if not block:
        return handle

    block_until_signaled(handle, f"{BINARY} running on node "
                                 f"{args.node_name} "
                                 f"({len(driver.state.gpus)} GPUs)")
    return handle


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    flags.setup_logging(args, component=BINARY)
    validate_flags(args)
    start_debug_signal_handlers()
    run_plugin(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
