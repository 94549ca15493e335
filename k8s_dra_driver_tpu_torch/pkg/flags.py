"""Reusable CLI flag groups with environment-variable mirrors.

The counterpart of the JAX package's ``pkg/flags.py`` (the reference's
``pkg/flags`` + per-binary urfave/cli apps, ``cmd/gpu-kubelet-plugin/
main.go:94-214``, ``pkg/flags/kubeclient.go:32-118``, ``logging.go:30``,
``utils.go:42``): every flag has an env mirror (flag wins when both are
set), flags come in shared groups (api client, logging, feature gates,
node plugin paths), and every binary logs its resolved startup config.
The env mirrors are the JAX package's with ``GPU_DRA_*`` for
``TPU_DRA_*``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Any, Mapping, Optional

from k8s_dra_driver_tpu_torch.pkg.featuregates import (
    FeatureGates,
    new_feature_gates,
    validate_gate_dependencies,
)

logger = logging.getLogger(__name__)

# Default filesystem layout (the /var/lib/kubelet/plugins/<driver> analogue).
DEFAULT_STATE_ROOT = "/var/lib/gpu-dra-driver"
DEFAULT_CDI_ROOT = "/var/run/cdi"


def parse_bool(v: object) -> bool:
    """Boolean flag/env parser for value-taking switches (e.g.
    ``--lock-profile false`` / ``GPU_DRA_LOCK_PROFILE=0``)."""
    s = str(v).strip().lower()
    if s in ("1", "true", "yes", "on"):
        return True
    if s in ("0", "false", "no", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"invalid boolean {v!r}")


class EnvDefault(argparse.Action):
    """Flag with an env mirror: precedence flag > env > default (the
    urfave/cli EnvVars semantics)."""

    def __init__(self, env: str, required: bool = False,
                 default: Any = None, **kwargs):
        self.env = env
        env_val = os.environ.get(env)
        if env_val is not None:
            t = kwargs.get("type")
            default = t(env_val) if t else env_val
            required = False
        super().__init__(default=default, required=required, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)


def add_logging_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("-v", "--verbosity", action=EnvDefault,
                   env="GPU_DRA_VERBOSITY", type=int, default=0,
                   help="log verbosity (0=info, 1+=debug); superseded by "
                        "--log-level when that is set")
    p.add_argument("--log-level", action=EnvDefault,
                   env="GPU_DRA_LOG_LEVEL", default="",
                   choices=["", "debug", "info", "warning", "error"],
                   help="log level (default: info, or debug when -v > 0)")
    p.add_argument("--log-format", action=EnvDefault,
                   env="GPU_DRA_LOG_FORMAT", default="text",
                   choices=["text", "json"],
                   help="log output format: human text or JSON lines with "
                        "the component and trace ids")


def add_api_client_flags(p: argparse.ArgumentParser) -> None:
    """The kube-client flag group (kubeclient.go:32-118). The endpoint
    selects the HTTP API substrate; empty means in-process fake (single-
    process demos and tests)."""
    p.add_argument("--api-endpoint", action=EnvDefault,
                   env="GPU_DRA_API_ENDPOINT", default="",
                   help="API server endpoint, e.g. http://127.0.0.1:8700 "
                        "(empty = in-process fake API)")
    p.add_argument("--kube-api-qps", action=EnvDefault,
                   env="KUBE_API_QPS", type=float, default=5.0,
                   help="client-side request rate limit (documented; the "
                        "HTTP substrate does not enforce it)")
    p.add_argument("--kube-api-burst", action=EnvDefault,
                   env="KUBE_API_BURST", type=int, default=10)


def add_feature_gate_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--feature-gates", action=EnvDefault,
                   env="GPU_DRA_FEATURE_GATES", default="",
                   help="comma-separated Name=true|false overrides")


def add_node_flags(p: argparse.ArgumentParser) -> None:
    """Flags shared by the node-side binaries (kubelet plugins, daemon)."""
    p.add_argument("--node-name", action=EnvDefault, env="NODE_NAME",
                   required=True, help="this node's Node object name")
    p.add_argument("--namespace", action=EnvDefault, env="POD_NAMESPACE",
                   default="default")


def add_device_flags(p: argparse.ArgumentParser) -> None:
    """Which GPUs a node binary sees (see :func:`build_device_lib`)."""
    p.add_argument("--mock-profile", action=EnvDefault,
                   env="GPU_DRA_MOCK_PROFILE", default="",
                   help="use the mock device backend with this profile "
                        "(h100-8 or dgx-h100-256); empty = the machine's "
                        "own GPUs")
    p.add_argument("--host-index", action=EnvDefault,
                   env="GPU_DRA_HOST_INDEX", type=int, default=None,
                   help="this node's index in a multi-node mock layout "
                        "(mock backend; unset = node 0, publishing none)")


def add_plugin_path_flags(p: argparse.ArgumentParser,
                          driver_subdir: str) -> None:
    p.add_argument("--state-dir", action=EnvDefault, env="GPU_DRA_STATE_DIR",
                   default=os.path.join(DEFAULT_STATE_ROOT, driver_subdir),
                   help="checkpoint + lock directory")
    p.add_argument("--cdi-root", action=EnvDefault, env="CDI_ROOT",
                   default=DEFAULT_CDI_ROOT,
                   help="directory for transient CDI spec files")
    add_device_flags(p)


def add_observability_flags(p: argparse.ArgumentParser,
                            default_health_sock: str) -> None:
    p.add_argument("--metrics-port", action=EnvDefault,
                   env="GPU_DRA_METRICS_PORT", type=int, default=0,
                   help="serve /metrics on this port (0 = ephemeral, "
                        "-1 = disabled)")
    p.add_argument("--healthcheck-addr", action=EnvDefault,
                   env="GPU_DRA_HEALTHCHECK_ADDR",
                   default=default_health_sock,
                   help="gRPC health service address (unix:///… or "
                        "ipv4:…; empty = disabled); needs the grpc package")
    add_profiling_flags(p)


def add_profiling_flags(p: argparse.ArgumentParser) -> None:
    """Continuous-profiling flags (docs/observability.md, "Continuous
    profiling") — shared by every main that serves /debug/profile."""
    p.add_argument("--profile-interval", action=EnvDefault,
                   env="GPU_DRA_PROFILE_INTERVAL", type=float,
                   default=0.25,
                   help="always-on wall-clock profiler sampling interval "
                        "in seconds; 0 disables")
    p.add_argument("--lock-profile", action=EnvDefault,
                   env="GPU_DRA_LOCK_PROFILE", type=parse_bool,
                   default=False,
                   help="record lock-contention wait times into the "
                        "profiler's table (pkg/sanitizer); applies to "
                        "locks created after startup")
    p.add_argument("--trace", action=EnvDefault,
                   env="GPU_DRA_TRACE", type=parse_bool, default=False,
                   help="enable claim-lifecycle tracing in this process "
                        "(pkg/tracing; bounded ring buffer): prepare phase "
                        "timings become span events in /debug/traces "
                        "and incident bundles instead of log lines")


#: GIL switch interval the control-plane binaries run with. The
#: interpreter default of 5 ms quantizes every cross-thread handoff
#: (HTTP handler → watch queue → informer is several of them) to 5 ms
#: multiples under load. These processes are I/O-bound coordinators, so
#: faster preemption costs them no meaningful throughput.
SWITCH_INTERVAL_S = 0.0005


def tune_interpreter() -> None:
    """Pin the sub-millisecond GIL switch interval (``SWITCH_INTERVAL_S``)
    — called by every binary at assembly time, before threads start."""
    sys.setswitchinterval(SWITCH_INTERVAL_S)


def enable_tracing_if_requested(args: argparse.Namespace) -> None:
    """Honor --trace/GPU_DRA_TRACE at assembly time (the phase-timing
    span events in device_state/driver are no-ops until enabled)."""
    if getattr(args, "trace", False):
        from k8s_dra_driver_tpu_torch.pkg import tracing
        tracing.enable()


def parse_feature_gates(args: argparse.Namespace) -> FeatureGates:
    """Parse AND cross-validate: every binary sharing the --feature-gates
    flag fails uniformly at assembly time on an invalid combination, rather
    than only the binaries that happen to consult the dependent gate."""
    try:
        gates = new_feature_gates(getattr(args, "feature_gates", "") or "")
        validate_gate_dependencies(gates)
    except (KeyError, ValueError) as e:
        # Operator typo or invalid combination: a clean usage error, not a
        # traceback. str(KeyError) reprs its argument (adds quotes), so
        # unwrap args[0].
        msg = e.args[0] if isinstance(e, KeyError) and e.args else e
        raise SystemExit(f"invalid --feature-gates: {msg}") from e
    return gates


def setup_logging(args: argparse.Namespace, component: str = "") -> None:
    """Shared structured-logging setup (pkg/logging.py): --log-level wins;
    legacy -v maps 0→info, 1+→debug; --log-format selects text vs JSON
    lines carrying the component."""
    from k8s_dra_driver_tpu_torch.pkg import logging as gpulogging

    level = getattr(args, "log_level", "") or (
        "debug" if getattr(args, "verbosity", 0) > 0 else "info")
    fmt = getattr(args, "log_format", "") or "text"
    try:
        gpulogging.setup_logging(component=component, level=level, fmt=fmt)
    except ValueError as e:
        raise SystemExit(f"invalid logging flags: {e}") from e


def log_startup_config(binary: str, args: argparse.Namespace,
                       gates: Optional[FeatureGates] = None) -> None:
    """Dump the resolved config at startup (pkg/flags/utils.go:42) — the
    first thing an operator checks in a misbehaving pod's log."""
    items: Mapping[str, Any] = vars(args)
    lines = [f"  {k}={v!r}" for k, v in sorted(items.items())]
    if gates is not None:
        lines.append(f"  featureGates resolved: {gates.summary()}")
    logger.info("%s starting with configuration:\n%s",
                binary, "\n".join(lines))


def build_device_lib(args: argparse.Namespace):
    """The GPUs a node binary serves: ``gpulib``'s ``new_device_lib`` for
    ``--mock-profile`` and ``--host-index`` (the mock when a profile is
    given, else the machine's own GPUs)."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import new_device_lib
    return new_device_lib(mock_profile=getattr(args, "mock_profile", ""),
                          host_index=getattr(args, "host_index", None))


def build_client(args: argparse.Namespace):
    from k8s_dra_driver_tpu_torch.k8sclient.httpapi import new_client
    return new_client(getattr(args, "api_endpoint", ""))
