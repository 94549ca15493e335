"""ComputeDomain daemon entrypoint.

The counterpart of the JAX package's ``plugins/compute_domain_daemon/
main.py`` (the analogue of ``cmd/compute-domain-daemon/main.go:212-459``):
the ``run`` command validates the CDI-injected identity env
(``COMPUTE_DOMAIN_UUID``), starts the rendezvous sync loop (clique
membership + readiness), and withdraws on SIGTERM; the ``check``
subcommand is the probe the DaemonSet's startup/liveness/readiness probes
exec (exit 0 iff the local GPUs are healthy — the ``nvidia-imex-ctl -q``
analogue).

Run standalone::

    COMPUTE_DOMAIN_UUID=<uid> COMPUTE_DOMAIN_NAME=cd \
    python -m k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon run \
        --node-name node-0 --mock-profile h100-8
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
from k8s_dra_driver_tpu_torch.pkg import flags
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    DaemonMetrics,
    MetricsServer,
    default_informer_metrics,
)
from k8s_dra_driver_tpu_torch.pkg.process import (
    ProcessHandle,
    block_until_signaled,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon.daemon import (
    ComputeDomainDaemon,
)

logger = logging.getLogger(__name__)

BINARY = "compute-domain-daemon"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=BINARY, description="per-ComputeDomain rendezvous daemon")
    sub = p.add_subparsers(dest="command")
    run_p = sub.add_parser("run", help="run the rendezvous sync loop")
    check_p = sub.add_parser(
        "check", help="probe local readiness (exit 0 iff healthy)")
    for sp in (run_p, check_p):
        flags.add_logging_flags(sp)
        flags.add_api_client_flags(sp)
        flags.add_node_flags(sp)
        flags.add_device_flags(sp)
    run_p.add_argument("--cd-uid", action=flags.EnvDefault,
                       env="COMPUTE_DOMAIN_UUID", default="",
                       help="owning ComputeDomain uid (CDI-injected)")
    run_p.add_argument("--cd-name", action=flags.EnvDefault,
                       env="COMPUTE_DOMAIN_NAME", default="")
    run_p.add_argument("--hostname", action=flags.EnvDefault,
                       env="HOSTNAME", default="")
    run_p.add_argument("--pod-ip", action=flags.EnvDefault,
                       env="POD_IP", default="")
    run_p.add_argument("--pod-name", action=flags.EnvDefault,
                       env="POD_NAME", default="",
                       help="own Pod name (downward API): watch its Ready "
                            "condition and fold it into published readiness")
    run_p.add_argument("--sync-interval", action=flags.EnvDefault,
                       env="GPU_DRA_SYNC_INTERVAL", type=float, default=5.0)
    run_p.add_argument("--metrics-port", action=flags.EnvDefault,
                       env="GPU_DRA_METRICS_PORT", type=int, default=-1,
                       help="serve /metrics on this port (0 = ephemeral, "
                            "-1 = disabled) — sync_consecutive_failures "
                            "and informer reconnect counters")
    p.add_argument("--version", action="version", version=version_string())
    return p


def run_check(args: argparse.Namespace) -> int:
    """Readiness probe: enumerate + health-check the local GPUs."""
    device_lib = flags.build_device_lib(args)
    client = flags.build_client(args)
    daemon = ComputeDomainDaemon(
        client=client, device_lib=device_lib,
        cd_uid="probe", cd_name="probe",
        node_name=args.node_name, namespace=args.namespace)
    ok = daemon.local_ready()
    print("READY" if ok else "NOT_READY", flush=True)
    return 0 if ok else 1


def run_daemon(args: argparse.Namespace, block: bool = True) -> ProcessHandle:
    """Assemble and start the daemon — same run_*(args, block=) contract
    as the plugins. The core component withdraws its clique entry on
    shutdown (SIGTERM → withdraw, main.go:340-347)."""
    if not args.cd_uid:
        # The identity env is injected by the daemon device's CDI edits; its
        # absence means the claim machinery did not run (main.go:212-235).
        raise SystemExit(
            "COMPUTE_DOMAIN_UUID not set: this process must run inside a "
            "pod whose daemon ResourceClaim was prepared by the CD plugin")
    flags.log_startup_config(BINARY, args)
    daemon = ComputeDomainDaemon(
        client=flags.build_client(args),
        device_lib=flags.build_device_lib(args),
        cd_uid=args.cd_uid,
        cd_name=args.cd_name,
        node_name=args.node_name,
        namespace=args.namespace,
        hostname=args.hostname or args.node_name,
        ip_address=args.pod_ip,
        pod_name=args.pod_name,
        metrics=DaemonMetrics(),
    )
    daemon.start(interval=args.sync_interval)
    handle = ProcessHandle(BINARY, driver=daemon)
    handle.on_stop(lambda: daemon.stop(withdraw=True))
    if getattr(args, "metrics_port", -1) >= 0:
        ms = MetricsServer(daemon.metrics.registry,
                           default_informer_metrics().registry,
                           port=args.metrics_port,
                           debug=standard_debug_handlers()).start()
        logger.info("metrics on http://127.0.0.1:%d/metrics "
                    "(+ /debug/{traces,informers,workqueue,inflight,...})",
                    ms.port)
        handle.on_stop(ms.stop)
    if not block:
        return handle

    block_until_signaled(handle, f"{BINARY} running for ComputeDomain "
                                 f"{args.cd_uid} on {args.node_name}")
    return handle


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.command:
        build_parser().print_help()
        return 2
    flags.setup_logging(args, component=BINARY)
    start_debug_signal_handlers()
    if args.command == "check":
        return run_check(args)
    run_daemon(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
