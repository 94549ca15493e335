"""ComputeDomain kubelet plugin entrypoint.

The counterpart of the JAX package's ``plugins/
compute_domain_kubelet_plugin/main.py`` (the analogue of
``cmd/compute-domain-kubelet-plugin/main.go``): the same process shape as
the GPU plugin (flags + env mirrors, metrics, gRPC health, GC) assembling
the CD driver — channel/daemon devices, readiness gating, and the
PrepareAborted-aware checkpoint GC.

Run standalone::

    python -m k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin \
        --node-name node-0 --mock-profile h100-8 \
        --state-dir /var/lib/cd-dra --cdi-root /var/run/cdi
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

from k8s_dra_driver_tpu_torch.internal.common import (
    standard_debug_handlers,
    start_debug_signal_handlers,
)
from k8s_dra_driver_tpu_torch.internal.info import version_string
from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
from k8s_dra_driver_tpu_torch.pkg import flags, sanitizer
from k8s_dra_driver_tpu_torch.pkg.blackbox import ContinuousProfiler
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    DRAMetrics,
    MetricsServer,
    default_allocator_metrics,
    default_informer_metrics,
    default_node_metrics,
)
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    NodeLeaseHeartbeat,
    fence_cleanup_for,
)
from k8s_dra_driver_tpu_torch.pkg.process import (
    ProcessHandle,
    block_until_signaled,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.cleanup import (
    CdCheckpointCleanupManager,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.driver import (
    CD_DRIVER_NAME,
    CdDriver,
    CdDriverConfig,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.healthcheck import (
    HealthcheckServer,
    driver_probe,
    require_grpc,
)
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.main import (
    default_health_sock,
)

logger = logging.getLogger(__name__)

BINARY = "compute-domain-kubelet-plugin"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=BINARY,
        description="ComputeDomain DRA kubelet plugin "
                    "(compute-domain.nvidia.com)")
    flags.add_logging_flags(p)
    flags.add_api_client_flags(p)
    flags.add_feature_gate_flags(p)
    flags.add_node_flags(p)
    p.add_argument("--driver-namespace", action=flags.EnvDefault,
                   env="DRIVER_NAMESPACE", default=None,
                   help="namespace where the controller parks cliques "
                        "(multi-namespace layout); default: co-located "
                        "with each ComputeDomain")
    flags.add_plugin_path_flags(p, CD_DRIVER_NAME)
    flags.add_observability_flags(
        p, default_health_sock=default_health_sock("gpu-dra-cd-health.sock"))
    p.add_argument("--channel-count", action=flags.EnvDefault,
                   env="GPU_DRA_CHANNEL_COUNT", type=int, default=None,
                   help="synthetic rendezvous channels per node")
    p.add_argument("--gc-interval", action=flags.EnvDefault,
                   env="GPU_DRA_GC_INTERVAL", type=float, default=600.0)
    p.add_argument("--node-lease-duration", action=flags.EnvDefault,
                   env="GPU_DRA_NODE_LEASE_DURATION", type=float,
                   default=10.0,
                   help="node liveness lease duration in seconds (shared "
                        "per-node lease, co-renewed with the GPU plugin; "
                        "docs/self-healing.md, 'Whole-node repair'); "
                        "0 disables the heartbeat")
    p.add_argument("--version", action="version", version=version_string())
    return p


def validate_flags(args: argparse.Namespace) -> None:
    if not args.node_name:
        raise SystemExit("--node-name (or NODE_NAME) is required")
    if args.channel_count is not None and args.channel_count < 1:
        raise SystemExit("--channel-count must be >= 1")
    if args.gc_interval <= 0:
        raise SystemExit("--gc-interval must be > 0")
    if args.node_lease_duration < 0:
        raise SystemExit("--node-lease-duration must be >= 0 (0 disables)")
    if args.profile_interval < 0:
        raise SystemExit("--profile-interval must be >= 0 (0 disables)")


def run_plugin(args: argparse.Namespace, block: bool = True) -> ProcessHandle:
    """Assemble and start the full CD plugin process — same contract as
    the GPU plugin's run_plugin (one RunPlugin shape across binaries,
    main.go:236-359)."""
    gates = flags.parse_feature_gates(args)
    flags.log_startup_config(BINARY, args, gates)
    flags.enable_tracing_if_requested(args)
    if args.healthcheck_addr:
        require_grpc()
    flags.tune_interpreter()
    if getattr(args, "lock_profile", False):
        sanitizer.set_lock_profiling(True)
    client = flags.build_client(args)
    device_lib = flags.build_device_lib(args)

    profiler = None
    if getattr(args, "profile_interval", 0) > 0:
        profiler = ContinuousProfiler(
            base_interval_s=args.profile_interval).start()

    cfg = CdDriverConfig(
        node_name=args.node_name,
        state_dir=args.state_dir,
        cdi_root=args.cdi_root,
        namespace=None,  # CDs may live in any namespace
        driver_namespace=args.driver_namespace,
        feature_gates=gates,
        channel_count=args.channel_count,
    )
    metrics = DRAMetrics()
    driver = CdDriver(client, cfg, device_lib=device_lib,
                      metrics=metrics).start()

    # Node liveness: co-renew the per-node lease with the GPU plugin
    # (larger epoch wins) and honor fencing on heal — the CD plugin's
    # channel checkpoints need the same moved-claim cleanup.
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
                           default_node_metrics().registry,
                           port=args.metrics_port,
                           debug=standard_debug_handlers()).start()
        logger.info("metrics on http://127.0.0.1:%d/metrics "
                    "(+ /debug/{traces,informers,workqueue,inflight,...})",
                    ms.port)
        servers.append(ms)
    if args.healthcheck_addr:
        servers.append(HealthcheckServer(
            lambda: driver_probe(driver, fenced=fence_gate),
            address=args.healthcheck_addr).start())

    gc = CdCheckpointCleanupManager(
        client, driver.state, interval=args.gc_interval).start()

    # Kubelet-role loop (see the GPU plugin's main): claim-state-driven
    # prepare, with the informer rv persisted next to the checkpoint for
    # resume-instead-of-relist restarts.
    prep_loop = NodePrepareLoop(
        client, driver, CD_DRIVER_NAME, driver.pool_name,
        state_dir=args.state_dir, fence=fence_gate).start()

    handle = ProcessHandle(BINARY, driver=driver, servers=servers, gc=gc,
                           profiler=profiler)
    handle.on_stop(prep_loop.stop)
    if heartbeat is not None:
        handle.on_stop(heartbeat.stop)
    handle.on_stop(driver.stop)
    for s in servers:
        handle.on_stop(s.stop)
    if profiler is not None:
        handle.on_stop(profiler.stop)
    handle.on_stop(gc.stop)
    if not block:
        return handle

    block_until_signaled(handle,
                         f"{BINARY} running on node {args.node_name}")
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
