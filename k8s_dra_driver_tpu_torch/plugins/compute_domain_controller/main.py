"""ComputeDomain controller entrypoint.

The counterpart of the JAX package's ``plugins/compute_domain_controller/
main.py`` (the analogue of ``cmd/compute-domain-controller/main.go``):
flags + ``GPU_DRA_*`` env mirrors, the metrics endpoint, controller
assembly, and signal-driven shutdown. Around the reconcile loop it runs
the cluster half of the observability and self-healing planes: fleet
telemetry over the node plugins' ``/metrics`` (with the SLO engine and
``/debug/fleet``), the claim reallocator, the usage meter, the canary
prober, the defrag planner, the incident flight recorder and the node
lifecycle controller. With ``--shards N`` the replicas run active-active:
each reconciles only the keys of the shards it holds (``sharding.py``),
and the singletons run on whichever replica holds shard 0.

Run standalone::

    python -m k8s_dra_driver_tpu_torch.plugins.compute_domain_controller \
        --api-endpoint http://127.0.0.1:8700
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
from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
    ClaimReallocator,
)
from k8s_dra_driver_tpu_torch.pkg import flags
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    MetricsServer,
    default_allocator_metrics,
    default_informer_metrics,
    default_node_metrics,
    default_remediation_metrics,
    default_workqueue_metrics,
)
from k8s_dra_driver_tpu_torch.pkg.nodelease import (
    NodeLifecycleController,
    scraper_staleness_signal,
)
from k8s_dra_driver_tpu_torch.pkg.process import (
    ProcessHandle,
    block_until_signaled,
)
from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (
    DEFAULT_WORKERS,
    ComputeDomainController,
)

logger = logging.getLogger(__name__)

BINARY = "compute-domain-controller"

#: where incident bundles go by default (``<dir>/incidents/``).
DEFAULT_INCIDENT_DIR = os.path.join(tempfile.gettempdir(),
                                    "gpu-dra-controller")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=BINARY, description="ComputeDomain cluster controller")
    flags.add_logging_flags(p)
    flags.add_api_client_flags(p)
    flags.add_feature_gate_flags(p)
    p.add_argument("--namespace", action=flags.EnvDefault,
                   env="POD_NAMESPACE", default=None,
                   help="restrict reconciliation to one namespace "
                        "(default: all)")
    p.add_argument("--driver-namespace", action=flags.EnvDefault,
                   env="DRIVER_NAMESPACE", default=None,
                   help="namespace for driver-owned children (per-CD "
                        "DaemonSets, daemon RCTs, cliques); default: "
                        "co-located with each ComputeDomain")
    p.add_argument("--metrics-port", action=flags.EnvDefault,
                   env="GPU_DRA_METRICS_PORT", type=int, default=0,
                   help="serve /metrics on this port (0 = ephemeral, "
                        "-1 = disabled)")
    p.add_argument("--workers", action=flags.EnvDefault,
                   env="GPU_DRA_RECONCILE_WORKERS", type=int,
                   default=DEFAULT_WORKERS,
                   help="reconcile worker-pool size; per-key exclusivity "
                        "keeps one ComputeDomain from reconciling on two "
                        "workers at once")
    p.add_argument("--remediation", action=flags.EnvDefault,
                   env="GPU_DRA_REMEDIATION", type=flags.parse_bool,
                   default=True,
                   help="run the claim reallocator: drained claims "
                        "(gpu.nvidia.com/drain annotation) are released "
                        "and re-allocated onto healthy devices "
                        "(docs/self-healing.md)")
    p.add_argument("--defrag", action=flags.EnvDefault,
                   env="GPU_DRA_DEFRAG", type=flags.parse_bool,
                   default=True,
                   help="run the defrag planner when fleet telemetry and "
                        "the reallocator are both on: a firing "
                        "allocation_admission SLO alert triggers scored "
                        "preemption of movable small claims to unblock "
                        "fragmentation-blocked large claims "
                        "(docs/performance.md, 'Topology-aware "
                        "allocation')")
    p.add_argument("--fleet-scrape-targets", action=flags.EnvDefault,
                   env="GPU_DRA_FLEET_SCRAPE_TARGETS", default="",
                   help="comma-separated node /metrics endpoints "
                        "(host:port, URLs, or node=host:port — the "
                        "named form also feeds scrape staleness to the "
                        "node lifecycle controller as a corroborating "
                        "node-lost signal); empty = fleet telemetry "
                        "disabled (docs/observability.md, "
                        "'Fleet telemetry')")
    p.add_argument("--node-lifecycle", action=flags.EnvDefault,
                   env="GPU_DRA_NODE_LIFECYCLE", type=flags.parse_bool,
                   default=True,
                   help="run the node lifecycle controller: nodes whose "
                        "liveness lease expires are fenced, cordoned "
                        "(all devices tainted NoSchedule), their claims "
                        "handed to the reallocator, and uncordoned when "
                        "the lease renews and the fence clears "
                        "(docs/self-healing.md, 'Whole-node repair')")
    p.add_argument("--fleet-scrape-interval", action=flags.EnvDefault,
                   env="GPU_DRA_FLEET_SCRAPE_INTERVAL", type=float,
                   default=15.0,
                   help="seconds between fleet scrape rounds")
    p.add_argument("--blackbox", action=flags.EnvDefault,
                   env="GPU_DRA_BLACKBOX", type=flags.parse_bool,
                   default=True,
                   help="run the incident flight recorder when fleet "
                        "telemetry is on: every SLO alert FIRED/CLEARED "
                        "transition captures a versioned incident bundle "
                        "(timeline, Events, metric windows, lease/cordon "
                        "state, profiler snapshot) under --incident-dir, "
                        "served via /debug/incidents "
                        "(docs/observability.md, 'Incident bundles')")
    p.add_argument("--incident-dir", action=flags.EnvDefault,
                   env="GPU_DRA_INCIDENT_DIR",
                   default=DEFAULT_INCIDENT_DIR,
                   help="state directory for incident bundles "
                        "(written under <dir>/incidents/)")
    p.add_argument("--incident-retention", action=flags.EnvDefault,
                   env="GPU_DRA_INCIDENT_RETENTION", type=int, default=32,
                   help="incident bundles kept on disk (oldest evicted, "
                        "counted)")
    p.add_argument("--canary-interval", action=flags.EnvDefault,
                   env="GPU_DRA_CANARY_INTERVAL", type=float, default=0.0,
                   help="seconds between synthetic canary probe rounds "
                        "(full claim lifecycles against every node, "
                        "gpu_dra_canary_* families + /debug/canary; "
                        "needs the reallocator's allocator); 0 disables "
                        "(docs/observability.md, 'Synthetic probing')")
    p.add_argument("--canary-deadline", action=flags.EnvDefault,
                   env="GPU_DRA_CANARY_DEADLINE", type=float, default=5.0,
                   help="per-probe claim-ready/teardown deadline in "
                        "seconds — a probe exceeding it is a classified "
                        "failure, not a hang")
    p.add_argument("--usage-metering", action=flags.EnvDefault,
                   env="GPU_DRA_USAGE_METERING", type=flags.parse_bool,
                   default=True,
                   help="run the per-tenant GPU-seconds usage meter "
                        "over the claim informer (gpu_dra_usage_* "
                        "families + /debug/usage; docs/observability.md, "
                        "'Usage metering')")
    flags.add_profiling_flags(p)
    p.add_argument("--leader-elect", action="store_true",
                   default=False,
                   help="enable lease-based leader election")
    p.add_argument("--leader-lease-name", action=flags.EnvDefault,
                   env="GPU_DRA_LEASE_NAME",
                   default="compute-domain-controller")
    p.add_argument("--identity", action=flags.EnvDefault,
                   env="POD_NAME", default="",
                   help="leader-election / shard-ownership identity "
                        "(defaults to hostname)")
    p.add_argument("--shards", action=flags.EnvDefault,
                   env="GPU_DRA_SHARDS", type=int, default=0,
                   help="active-active controller sharding: partition the "
                        "reconcile keyspace into this many lease-claimed "
                        "shards; every replica runs its informers and a "
                        "shard gate admits only confidently-owned work, "
                        "with the singleton components (canary prober, "
                        "usage meter, flight recorder, defrag planner) "
                        "pinned to the leader shard; ownership churn in "
                        "gpu_dra_shard_* (docs/architecture.md, "
                        "'Controller sharding'). 0 disables — single "
                        "active controller; use --leader-elect for "
                        "hot-standby HA instead")
    p.add_argument("--version", action="version", version=version_string())
    return p


def _parse_targets(spec: str) -> list:
    """``--fleet-scrape-targets``: ``node=host:port`` entries name the
    target after its node so the lifecycle controller can correlate
    scrape staleness with the node's lease (plain ``host:port`` entries
    stay self-named)."""
    from k8s_dra_driver_tpu_torch.pkg.telemetry import normalize_target

    targets: list = []
    for t in spec.split(","):
        t = t.strip()
        if not t:
            continue
        if "=" in t and "://" not in t.split("=", 1)[0]:
            name, _, url = t.partition("=")
            targets.append((name.strip(), normalize_target(url)[1]))
        else:
            targets.append(t)
    return targets


def _build_telemetry(args: argparse.Namespace, client):
    """Fleet telemetry (docs/observability.md, "Fleet telemetry"): scrape
    every node plugin's /metrics, aggregate into gpu_dra_fleet_*
    families, evaluate recording rules + SLO burn-rate alerts."""
    from k8s_dra_driver_tpu_torch.pkg.canary import default_canary_metrics
    from k8s_dra_driver_tpu_torch.pkg.events import EventRecorder
    from k8s_dra_driver_tpu_torch.pkg.slo import (
        SloEngine,
        allocation_admission_slo,
        canary_availability_slo,
        default_slos,
    )
    from k8s_dra_driver_tpu_torch.pkg.telemetry import (
        FleetTelemetry,
        _http_fetch,
    )
    from k8s_dra_driver_tpu_torch.pkg.usage import default_usage_metrics

    # The controller's OWN allocator families (the reallocator's and
    # defrag planner's admission outcomes — the allocation_admission
    # SLO's signal) join the fleet through a LOCAL pseudo-target serving
    # just that registry's text. Scraping the controller's full /metrics
    # endpoint instead would re-ingest the aggregate it serves
    # (gpu_dra_fleet_* names pass fleet_family_name through unchanged)
    # and feed back into itself. The canary/usage registries ride a
    # second pseudo-target for the same reason — that is what mints the
    # gpu_dra_fleet_canary_*/usage_* mirrors the canary_availability SLO
    # and dashboards read.
    local_url = "local://controller-allocator"
    local_canary_url = "local://controller-canary"

    def _fetch(name: str, url: str) -> str:
        if url == local_url:
            return default_allocator_metrics().registry.expose_text()
        if url == local_canary_url:
            return (default_canary_metrics().registry.expose_text()
                    + default_usage_metrics().registry.expose_text())
        return _http_fetch(url, 2.0)

    telemetry = FleetTelemetry(
        targets=[*_parse_targets(args.fleet_scrape_targets),
                 ("controller-allocator", local_url),
                 ("controller-canary", local_canary_url)],
        interval_s=args.fleet_scrape_interval,
        fetch=_fetch)
    telemetry.slo_engine = SloEngine(
        telemetry.rules,
        slos=(*default_slos(), allocation_admission_slo(),
              # The outside-in availability objective: evaluates only
              # when a canary feeds the probe families (no probes = no
              # verdict, never a page).
              canary_availability_slo()),
        events=EventRecorder(client, "fleetwatch"))
    return telemetry


def run_controller(args: argparse.Namespace,
                   block: bool = True) -> ProcessHandle:
    """Assemble and start the controller — same run_*(args, block=)
    contract as the plugins."""
    gates = flags.parse_feature_gates(args)
    flags.log_startup_config(BINARY, args, gates)
    flags.tune_interpreter()
    if getattr(args, "lock_profile", False):
        from k8s_dra_driver_tpu_torch.pkg import sanitizer
        sanitizer.set_lock_profiling(True)
    flags.enable_tracing_if_requested(args)
    client = flags.build_client(args)

    # Continuous profiling (docs/observability.md): always-on low-rate
    # sampling; burst-coupled to the SLO engine below when telemetry is
    # on, and snapshotted into every incident bundle.
    profiler = None
    if getattr(args, "profile_interval", 0) > 0:
        from k8s_dra_driver_tpu_torch.pkg.blackbox import ContinuousProfiler
        profiler = ContinuousProfiler(
            base_interval_s=args.profile_interval).start()

    # Active-active sharding (docs/architecture.md, "Controller
    # sharding"): N replicas partition the reconcile keyspace by
    # lease-claimed shard. Every replica watches everything; the gate
    # admits only confidently-owned work, recorded in the epoch-stamped
    # op ledger.
    sharded = None
    if args.shards > 0:
        import socket

        from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.sharding import (
            ShardedController,
        )
        sharded = ShardedController(
            client, args.identity or socket.gethostname(), args.shards)
    gate = sharded.gate if sharded is not None else None

    controller = ComputeDomainController(
        client, namespace=args.namespace, gates=gates,
        driver_namespace=args.driver_namespace,
        workers=getattr(args, "workers", DEFAULT_WORKERS), shard_gate=gate)

    if sharded is not None:
        from k8s_dra_driver_tpu_torch.pkg.shardmap import shard_for
        from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (
            KIND_COMPUTE_DOMAIN,
        )

        def _resync_shard(shard: int) -> None:
            # Replay the acquired shard's CDs: work the previous owner
            # had in flight runs again here — reconciles are idempotent,
            # so at-least-once per owner is safe, and the gate keeps it
            # to exactly one owner at a time.
            try:
                cds = client.list(KIND_COMPUTE_DOMAIN, args.namespace)
            except Exception:  # noqa: BLE001 — transient: the informer
                # resync and the next acquisition replay cover it.
                logger.warning("shard %d resync list failed", shard,
                               exc_info=True)
                return
            for cd in cds:
                m = cd["metadata"]
                if shard_for(m.get("namespace", ""), m.get("uid", ""),
                             sharded.shard_map.shards) == shard:
                    controller._enqueue_cd(cd)

        sharded.on_shard_acquired = _resync_shard

    # Assembled before the MetricsServer so the aggregate and the SLO
    # families ride the same endpoint.
    telemetry = None
    if (getattr(args, "fleet_scrape_targets", "") or "").strip():
        telemetry = _build_telemetry(args, client)

    servers = []
    if args.metrics_port >= 0:
        # One endpoint for the whole control-plane surface: reconcile
        # counters, informer health, the workqueue families — plus, when
        # fleet telemetry is on, the gpu_dra_fleet_* aggregate (the
        # aggregator duck-types a Registry), its scrape-health families,
        # the gpu_dra_slo_* families, and /debug/fleet.
        from k8s_dra_driver_tpu_torch.pkg.blackbox import (
            default_blackbox_metrics,
        )
        from k8s_dra_driver_tpu_torch.pkg.canary import default_canary_metrics
        from k8s_dra_driver_tpu_torch.pkg.usage import default_usage_metrics
        # The blackbox families live on the controller endpoint only
        # (never on scraped node endpoints: the fleet aggregator would
        # mint gpu_dra_fleet_* mirrors for a controller-local plane). The
        # canary/usage families serve here too AND join the fleet
        # aggregate via the local pseudo-target above.
        extra_regs: list = [default_blackbox_metrics().registry,
                            default_canary_metrics().registry,
                            default_usage_metrics().registry]
        debug = standard_debug_handlers()
        if telemetry is not None:
            from k8s_dra_driver_tpu_torch.pkg.slo import default_slo_metrics
            extra_regs += [telemetry.metrics.registry,
                           default_slo_metrics().registry,
                           telemetry.aggregator]
            debug["fleet"] = telemetry.debug_snapshot
        if sharded is not None:
            extra_regs.append(sharded.metrics.registry)
        ms = MetricsServer(controller.metrics.registry,
                           default_informer_metrics().registry,
                           default_workqueue_metrics().registry,
                           default_remediation_metrics().registry,
                           default_node_metrics().registry,
                           # The reallocator/defrag Allocator's placement
                           # families (fragmentation gauge, admission
                           # outcomes, cache counters).
                           default_allocator_metrics().registry,
                           *extra_regs,
                           port=args.metrics_port,
                           debug=debug).start()
        logger.info("metrics on http://127.0.0.1:%d/metrics "
                    "(+ /debug/{traces,informers,workqueue,inflight%s})",
                    ms.port, ",fleet" if telemetry is not None else "")
        servers.append(ms)
    if telemetry is not None:
        telemetry.start()

    if args.leader_elect and sharded is None:
        import socket

        from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.election import (
            LeaderElector,
        )
        elector = LeaderElector(
            client, lease_name=args.leader_lease_name,
            identity=args.identity or socket.gethostname(),
            on_started_leading=controller.start,
            on_stopped_leading=controller.stop)
        elector.start()
        runner = elector
    else:
        # Sharded replicas are active-active: every replica starts its
        # controller (informers + queue) and the shard gate partitions
        # the WORK — singleton leader election would defeat the point.
        controller.start()
        runner = controller

    # Self-healing's cluster half: drained claims (annotated by the node
    # plugins' drain controllers) are released and re-allocated onto
    # healthy devices (docs/self-healing.md). Shard-gated: a replica
    # processes only the pending claims whose shard it owns.
    realloc = None
    if getattr(args, "remediation", True):
        realloc = ClaimReallocator(client, namespace=args.namespace,
                                   shard_gate=gate).start()

    # The user-perspective plane (docs/observability.md, "Synthetic
    # probing" / "Usage metering") and its downstream consumers are
    # process singletons. Single-replica: built and started inline.
    # Sharded: registered as leader-pinned singleton FACTORIES on the
    # ShardedController — whichever replica owns the leader shard builds
    # fresh incarnations (the usage meter rebuilds its ledger exactly from
    # the durable usage-since stamps), and loses them before a successor
    # can act confidently. Each factory returns a handle whose ``stop``
    # tears its incarnation down.
    #
    # ``pinned`` carries the current incarnations between factories (the
    # recorder bundles the leader's meter and prober); factories run in
    # registration order.
    pinned: dict = {}

    def _make_meter():
        from k8s_dra_driver_tpu_torch.pkg.usage import UsageMeter
        m = UsageMeter(client, namespace=args.namespace).start(
            observe_interval_s=min(5.0, args.fleet_scrape_interval))
        pinned["usage"] = m
        return m

    def _make_prober():
        from k8s_dra_driver_tpu_torch.pkg.canary import CanaryProber
        pr = CanaryProber(
            client, realloc.alloc,
            interval_s=args.canary_interval,
            namespace=args.namespace or "default",
            probe_deadline_s=getattr(args, "canary_deadline", 5.0),
            # realloc.alloc_mutex IS the allocator's own reentrant mutex:
            # every consumer stays on the one scheduler lock.
            alloc_mutex=realloc.alloc_mutex).start()
        pinned["canary"] = pr
        return pr

    def _make_defrag():
        # Defragmentation (docs/performance.md, "Topology-aware
        # allocation"): a firing allocation_admission alert triggers
        # scored preemption of movable small claims through the
        # reallocator's drain pipeline. One scheduler actor fleet-wide —
        # leader-pinned under sharding for the same reason the prober is.
        from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
            DefragPlanner,
            attach_defrag_planner,
        )
        from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.sharding import (
            SingletonHandle,
        )
        d = DefragPlanner(client, realloc.alloc,
                          alloc_mutex=realloc.alloc_mutex)
        attach_defrag_planner(telemetry.slo_engine, d)
        d.start(poll_interval=args.fleet_scrape_interval)

        def _stop() -> None:
            telemetry.slo_engine.unsubscribe(d.on_alert)
            d.stop()
        return SingletonHandle(d, _stop)

    def _make_recorder():
        # Incident flight recorder (docs/observability.md, "Incident
        # bundles"): a FIRED transition captures the bundle, the matching
        # CLEARED resolves it. The informer/workqueue/inflight debug
        # snapshots ride along; /debug/incidents itself is excluded (a
        # bundle embedding the previous bundle would grow without bound).
        from k8s_dra_driver_tpu_torch.pkg import tracing
        from k8s_dra_driver_tpu_torch.pkg.blackbox import FlightRecorder
        from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.sharding import (
            SingletonHandle,
        )
        all_debug = standard_debug_handlers()
        rec = FlightRecorder(
            args.incident_dir,
            client=client,
            engine=telemetry.slo_engine,
            telemetry=telemetry,
            tracer=tracing.default_tracer(),
            allocator=realloc.alloc if realloc is not None else None,
            alloc_mutex=(realloc.alloc_mutex if realloc is not None
                         else None),
            # What users saw (probe history) + who was consuming
            # (per-tenant ledger) ride every bundle.
            canary=pinned.get("canary"),
            usage=pinned.get("usage"),
            profiler=profiler,
            debug={k: all_debug[k]
                   for k in ("informers", "workqueue", "inflight")},
            namespace=args.namespace,
            retention=args.incident_retention)
        # on_alert owns the profiler burst toggle too — no separate
        # attach_profiler_burst subscription (one owner, not two).
        telemetry.slo_engine.subscribe(rec.on_alert)
        return SingletonHandle(
            rec, lambda: telemetry.slo_engine.unsubscribe(rec.on_alert))

    factories: dict = {}
    if getattr(args, "usage_metering", True):
        factories["usage-meter"] = _make_meter
    if getattr(args, "canary_interval", 0.0) > 0 and realloc is not None:
        factories["canary-prober"] = _make_prober
    if (getattr(args, "defrag", True) and telemetry is not None
            and realloc is not None):
        factories["defrag-planner"] = _make_defrag
    want_recorder = getattr(args, "blackbox", True) and telemetry is not None
    if want_recorder:
        factories["flight-recorder"] = _make_recorder
    stops: list = []
    if sharded is not None:
        sharded.singleton_factories.update(factories)
    else:
        for make in factories.values():
            stops.append(make().stop)
    meter, prober = pinned.get("usage"), pinned.get("canary")
    if not want_recorder and profiler is not None and telemetry is not None:
        # Recorder disabled but engine + profiler present: the burst
        # coupling still wants an owner.
        from k8s_dra_driver_tpu_torch.pkg.blackbox import (
            attach_profiler_burst,
        )
        attach_profiler_burst(telemetry.slo_engine, profiler)

    # Node failure domains (docs/self-healing.md, "Whole-node repair"):
    # expired node leases ⇒ fence + cordon + hand the node's claims to
    # the reallocator; rejoin on renewal + fence clear. Scrape staleness
    # and the canary verdict corroborate (never decide) node loss.
    node_lifecycle = None
    if getattr(args, "node_lifecycle", True):
        scrape_stale = (scraper_staleness_signal(telemetry.scraper)
                        if telemetry is not None else None)
        canary_signal = None
        if prober is not None:
            from k8s_dra_driver_tpu_torch.pkg.canary import (
                canary_probe_signal,
            )
            canary_signal = canary_probe_signal(prober)
        node_lifecycle = NodeLifecycleController(
            client, scrape_stale=scrape_stale,
            canary_failing=canary_signal, shard_gate=gate).start()

    if sharded is not None:
        # Last: every component and factory is wired, so the sync loop
        # may acquire shards (and the leader shard may start singletons)
        # from its first round.
        sharded.start()

    handle = ProcessHandle(BINARY, driver=runner, servers=servers,
                           telemetry=telemetry, reallocator=realloc,
                           meter=meter, sharded=sharded)
    for s in servers:
        handle.on_stop(s.stop)
    if telemetry is not None:
        handle.on_stop(telemetry.stop)
    for fn in stops:
        handle.on_stop(fn)
    if realloc is not None:
        handle.on_stop(realloc.stop)
    if node_lifecycle is not None:
        handle.on_stop(node_lifecycle.stop)
    if sharded is not None:
        # Releases every shard lease (successors take over immediately)
        # and stops the leader-pinned singletons.
        handle.on_stop(sharded.stop)
    if profiler is not None:
        handle.on_stop(profiler.stop)
    handle.on_stop(runner.stop)
    if not block:
        return handle

    block_until_signaled(handle, f"{BINARY} running")
    return handle


def main(argv: Optional[list[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    flags.setup_logging(args, component=BINARY)
    start_debug_signal_handlers()
    run_controller(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
