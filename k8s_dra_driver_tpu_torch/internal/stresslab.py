"""Stress harness: tenant replicas through the claim path, the soak, serving
at scale, the churn, fleet and chaos harnesses, allocation and the wire path
at scale, and the observability overhead legs.

The pieces of the JAX package's ``internal/stresslab.py`` that the port
has so far:

- :class:`ServingReplica` and :func:`run_serving_smoke`. A session creates
  a ResourceClaim, has it allocated and prepared by the GPU kubelet plugin
  through the claim watcher, reads the claim's CDI spec back and binds a
  ``ServingEngine`` to the GPUs it names, serves a burst through the
  decode kernel, then drains and tears the claim down; the smoke audits
  that nothing is left behind. A replica's loop (:meth:`ServingReplica.
  start`) cycles such sessions.
- :func:`run_soak`, the seeded self-healing soak over several mock
  ``h100-8`` nodes with the whole remediation pipeline live, and its
  legs: :func:`run_canary` (the synthetic probes and the usage meter
  through a node kill) and :func:`run_serving_soak` (tenant replicas
  decoding through a node kill while the ``claim_ready`` burn-rate SLO
  pages and the flight recorder captures the incident).
- :func:`run_serving_scale`, the serving dataplane at scale: interleaved
  1-vs-N replica throughput arms, an autoscale leg through faults, and a
  sharded-controller leg, then the residue, accounting and KV-isolation
  audits.
- :func:`run_controller_shard_scale` and :func:`run_shard_smoke`, the
  controller-sharding legs: one replica against N shard-gated replicas
  on one workload, then replica-kill failover with the usage meter's
  exact conservation across incarnations, a partitioned replica's
  handoff audited by the epoch-stamped op ledger, and rebalance
  hysteresis.
- :func:`run_claim_churn` (both kubelet plugins churned under optional
  fault schedules, with a leak audit), :func:`run_node_fleet` (the API
  machinery under a fleet of informer stacks), :func:`run_cd_fleet` (a
  ComputeDomain fleet through the live controller) and
  :func:`run_cross_kind_writes` (the sharded store against one lock).
- :func:`run_allocator_scale`, first-fit against best-fit on one seeded
  tape over ``h100-8`` nodes in MIG mode (the GPU x memory-slice mesh),
  then the SLO-driven defrag leg, and :func:`run_wire_path`, claim→Ready
  over HTTP with the store's baseline wire path against its defaults
  under status-writer churn (:class:`WireContenders`).
- The observability overhead legs: :func:`run_fleetwatch` (per-node
  MetricsServers scraped over HTTP, a prepare-failure burst that must page
  and clear, the scrape fault leg), :func:`run_blackbox_overhead` and
  :func:`run_canary_overhead`.
- :func:`replay_protocol_counterexample`, which replays a counterexample of
  the protocol model checker (``pkg/protolab.py``) through the schedule
  fuzzer's slot.

The serving paths run on the card unless the caller asks for the CPU
(``device="cpu"``), where the engine uses the decode kernel's plain
version and the nodes are ``h100-8`` mocks.
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time
import uuid as uuidlib
from collections import deque
from typing import Any, Optional, Union

import torch

from k8s_dra_driver_tpu_torch.compute._device import _resolve_device
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    flash_attention_decode,
)
from k8s_dra_driver_tpu_torch.compute.serving import (
    CLAIM_ERROR,
    CLAIM_OK,
    DecodeRequest,
    ServingMetrics,
    bind_engine,
    cuda_device_uuids,
    parse_visible_devices,
)
from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
    DRIVER_NAME,
)


#: the serving smoke's engine: 8 slots of 2 heads x 8 over a 32-token
#: cache (the decode kernel's shapes in ``run_serving_smoke``)
SERVING_SMOKE_ENGINE = dict(max_batch=8, kv_cap=32, heads=2, head_dim=8,
                            tokens_per_chip_step=16,
                            modeled_chip_tok_s=2000.0, queue_cap=32)


#: the serving soak's engine (the JAX leg's): 8 slots over a 32-token
#: cache at the engine's default width, a bounded queue of 64
SOAK_SERVING_ENGINE = dict(max_batch=8, kv_cap=32, tokens_per_chip_step=16,
                           modeled_chip_tok_s=2000.0, queue_cap=64)


def _pct(xs: list[float], q: float) -> float:
    """The nearest-rank percentile the JAX package's harnesses report."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _serving_warmup(engine_kwargs: dict, device: torch.device) -> int:
    """One decode-attention call at the engines' shapes, outside any
    session deadline: on the card it builds (at first use) and loads the
    decode kernel, so no session pays for that. Returns the kernel
    launches it made (one on the card, none on the CPU)."""
    mb = engine_kwargs.get("max_batch", 8)
    h = engine_kwargs.get("heads", 2)
    d = engine_kwargs.get("head_dim", 8)
    cap = engine_kwargs.get("kv_cap", 64)
    q = torch.zeros((mb, h, 1, d), dtype=torch.float32, device=device)
    kv = torch.zeros((mb, h, cap, d), dtype=torch.float32, device=device)
    before = flash_attention_decode.launches
    flash_attention_decode(q, kv, kv, torch.ones((mb,), dtype=torch.int32,
                                                 device=device)).cpu()
    return flash_attention_decode.launches - before


class ServingReplica:
    """One tenant replica cycling bounded serve sessions through the claim
    path — the JAX package's replica, binding GPUs.

    Each session: create a ResourceClaim for ``gpus_per_claim`` GPUs (each
    of ``selectors`` a CEL expression the request adds) → allocate
    node-pinned → wait Ready → read the claim's CDI spec and bind an engine
    to exactly the GPUs ``CUDA_VISIBLE_DEVICES`` names (``bind_engine``,
    with ``uuids`` mapping GPU UUIDs to torch indices; ``None`` matches the
    CUDA devices this process sees) → serve a saturated burst for
    ``serve_s`` → drain → unreserve → wait unprepare → delete. Every session
    counts one ``gpu_dra_serving_claim_attempts_total`` attempt (``ok`` iff
    the claim reached a first decoded batch inside ``deadline_s``), and an
    ``ok`` session observes claim-create → first-decoded-batch into
    ``gpu_dra_serving_first_batch_seconds``. ``device`` places the engines
    (``None``: the card the spec names). :meth:`start` runs sessions in a
    loop, ``session_gap_s`` apart, until :meth:`stop`. Bounded sessions
    (rather than one claim held forever) keep the SLO's event stream
    flowing, so a dead node turns into a visible error stream within one
    session deadline instead of silence."""

    def __init__(self, name: str, tenant: str, client, allocator,
                 node: str, metrics, cdi_lookup,
                 gpus_per_claim: int = 1, serve_s: float = 0.4,
                 deadline_s: float = 1.5, namespace: str = "default",
                 device_class: str = DRIVER_NAME,
                 selectors: tuple[str, ...] = (),
                 requests_per_burst: int = 32, prompt_tokens: int = 8,
                 max_new_tokens: int = 8, session_gap_s: float = 0.02,
                 engine_kwargs: Optional[dict] = None,
                 device: Union[str, torch.device, None] = None,
                 uuids: Optional[dict[str, int]] = None,
                 clock=time.monotonic):
        self.name = name
        self.tenant = tenant
        self.client = client
        self.allocator = allocator
        self.node = node
        self.metrics = metrics
        self.cdi_lookup = cdi_lookup
        self.gpus_per_claim = gpus_per_claim
        self.serve_s = serve_s
        self.deadline_s = deadline_s
        self.namespace = namespace
        self.device_class = device_class
        self.selectors = tuple(selectors)
        self.driver_name = DRIVER_NAME
        self.requests_per_burst = requests_per_burst
        self.prompt_tokens = prompt_tokens
        self.max_new_tokens = max_new_tokens
        self.session_gap_s = session_gap_s
        self.engine_kwargs = dict(engine_kwargs or {})
        self.device = device
        self.uuids = uuids
        self.clock = clock

        self._mu = sanitizer.new_lock(f"ServingReplica.{tenant}.{name}._mu")
        self._nonce = uuidlib.uuid4().hex[:8]
        self._seq = 0
        self._req = 0
        self.sessions = 0
        self.ok = 0
        self.errors = 0
        self.last_error = ""
        self.ttfb_s: list[float] = []
        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.rejected = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.decode_steps = 0
        self.kv_isolation_max_err = 0.0
        self.history: Any = deque(maxlen=512)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- claim-path plumbing ------------------------------------------------

    def _claim_obj(self, name: str) -> Optional[dict]:
        try:
            return self.client.try_get("ResourceClaim", name,
                                       self.namespace)
        except Exception:  # noqa: BLE001 — transient read; the caller's
            # poll loop retries
            return None

    def _ready_entry(self, name: str) -> Optional[dict]:
        c = self._claim_obj(name)
        if c is None:
            return None
        for d in (c.get("status") or {}).get("devices") or []:
            if d.get("driver") == self.driver_name and any(
                    cond.get("type") == "Ready"
                    and cond.get("status") == "True"
                    for cond in d.get("conditions") or []):
                return d
        return None

    def _unreserve(self, name: str) -> None:
        for _ in range(40):
            c = self._claim_obj(name)
            if c is None:
                return
            st = c.setdefault("status", {})
            if not st.get("reservedFor"):
                return
            st.pop("reservedFor", None)
            try:
                self.client.update_status(c)
                return
            except Exception:  # noqa: BLE001 — conflict/transient
                time.sleep(0.005)
        raise RuntimeError(f"could not unreserve {name}")

    def _teardown(self, name: str) -> None:
        self._unreserve(name)
        deadline = self.clock() + self.deadline_s
        while self.clock() < deadline:
            c = self._claim_obj(name)
            if c is None or not any(
                    d.get("driver") == self.driver_name
                    for d in (c.get("status") or {}).get("devices") or []):
                break
            time.sleep(0.01)
        else:
            raise RuntimeError(
                f"node never unprepared {name} within {self.deadline_s}s")
        last: Optional[BaseException] = None
        for _ in range(20):
            try:
                self.client.delete("ResourceClaim", name, self.namespace)
                return
            except Exception as e:  # noqa: BLE001 — NotFound = done;
                # transient failures get a bounded retry
                if type(e).__name__ == "NotFoundError":
                    return
                last = e
                time.sleep(0.005)
        raise RuntimeError(f"could not delete {name}: {last!r}")

    def _cleanup(self, name: str) -> None:
        """Best-effort removal of a FAILED session's claim — a failed
        session must not become the residue audit's leak."""
        try:
            self._unreserve(name)
        except Exception:  # noqa: BLE001 — best-effort
            pass
        try:
            self.client.delete("ResourceClaim", name, self.namespace)
        except Exception:  # noqa: BLE001 — gone or transient; the
            # end-of-run residue audit is the backstop
            pass

    # -- one serve session --------------------------------------------------

    def _feed(self, engine, n: int, seq: int) -> None:
        for _ in range(n):
            self._req += 1
            engine.submit(DecodeRequest(
                rid=f"{self.tenant}-{seq}-{self._req}",
                tenant=self.tenant,
                prompt_tokens=self.prompt_tokens,
                max_new_tokens=self.max_new_tokens))

    def _absorb(self, engine) -> None:
        with self._mu:
            self.submitted += engine.submitted
            self.completed += engine.completed
            self.shed += engine.shed
            self.rejected += engine.rejected
            self.prefill_tokens += engine.prefill_tokens
            self.decode_tokens += engine.decode_tokens
            self.decode_steps += engine.decode_steps
            if engine.kv_isolation_max_err > self.kv_isolation_max_err:
                self.kv_isolation_max_err = engine.kv_isolation_max_err

    def serve_once(self) -> dict:
        """One full serve session. Never raises; returns the session
        record (also appended to ``history``)."""
        with self._mu:
            self._seq += 1
            seq = self._seq
        name = f"serve-{self.tenant}-{self.name}-{self._nonce}-{seq}"
        t0 = self.clock()
        at = time.time()
        outcome = CLAIM_ERROR
        err = ""
        ttfb = None
        engine = None
        gpus: list[int] = []
        try:
            exactly = {"deviceClassName": self.device_class,
                       "allocationMode": "ExactCount",
                       "count": self.gpus_per_claim}
            if self.selectors:
                exactly["selectors"] = [{"cel": {"expression": s}}
                                        for s in self.selectors]
            claim = {
                "apiVersion": "resource.k8s.io/v1",
                "kind": "ResourceClaim",
                "metadata": {"name": name, "namespace": self.namespace},
                "spec": {"devices": {"requests": [{
                    "name": "gpu", "exactly": exactly}]}},
            }
            created = self.client.create(claim)
            uid = created["metadata"].get("uid", "")
            self.allocator.allocate(
                created,
                reserved_for=[{"resource": "pods", "name": f"pod-{name}"}],
                node=self.node)
            deadline = t0 + self.deadline_s
            entry = self._ready_entry(name)
            while entry is None and self.clock() < deadline:
                time.sleep(0.005)
                entry = self._ready_entry(name)
            if entry is None:
                raise RuntimeError(
                    f"claim {name} not Ready within {self.deadline_s}s")
            spec = self.cdi_lookup(self.node, uid)
            gpus = parse_visible_devices(spec, self.uuids)
            if len(gpus) != self.gpus_per_claim:
                raise RuntimeError(
                    f"CDI spec for {name} made GPUs {gpus} visible, "
                    f"want {self.gpus_per_claim}")
            engine = bind_engine(
                spec, f"{self.tenant}-{self.name}", device=self.device,
                uuids=self.uuids, metrics=self.metrics, clock=self.clock,
                **self.engine_kwargs).start()
            self._feed(engine, self.requests_per_burst, seq)
            while engine.first_batch_t is None and self.clock() < deadline:
                time.sleep(0.002)
            if engine.first_batch_t is None:
                raise RuntimeError(
                    f"no first decoded batch within {self.deadline_s}s "
                    f"of claim create")
            ttfb = engine.first_batch_t - t0
            self.metrics.first_batch_seconds.observe(ttfb,
                                                     tenant=self.tenant)
            serve_end = self.clock() + self.serve_s
            while self.clock() < serve_end:
                if engine.queue_depth() < self.requests_per_burst // 2:
                    self._feed(engine, self.requests_per_burst // 2, seq)
                time.sleep(0.01)
            engine.drain(timeout=self.deadline_s)
            self._teardown(name)
            outcome = CLAIM_OK
        except Exception as e:  # noqa: BLE001 — every failure is one
            # counted error attempt; the session loop goes on
            err = repr(e)
            self._cleanup(name)
        finally:
            if engine is not None:
                engine.stop()      # idempotent after a drain
                self._absorb(engine)
        dt = self.clock() - t0
        rec = {"at": at, "duration_s": round(dt, 6), "outcome": outcome,
               "error": err, "ttfb_s": ttfb, "node": self.node,
               "tenant": self.tenant, "name": name, "gpus": gpus,
               "device": str(engine.device) if engine is not None else ""}
        with self._mu:
            self.sessions += 1
            if outcome == CLAIM_OK:
                self.ok += 1
                if ttfb is not None:
                    self.ttfb_s.append(ttfb)
            else:
                self.errors += 1
                self.last_error = err
            self.history.append(rec)
        self.metrics.claim_attempts_total.inc(tenant=self.tenant,
                                              outcome=outcome)
        return rec

    # -- the replica loop --------------------------------------------------

    def start(self) -> "ServingReplica":
        self._thread = threading.Thread(
            target=self._run, name=f"replica-{self.tenant}-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.serve_once()
            if self._stop.wait(self.session_gap_s):
                break

    def stop(self) -> None:
        """Scale-down: the in-flight session finishes (drain + teardown
        bounded by serve_s + deadline_s), then the loop exits. The stop
        flag is cleared afterwards so a caller can still run synchronous
        post-quiesce sessions (the green-after-rejoin round)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self._stop.clear()


def run_serving_smoke(tmpdir: Optional[str] = None,
                      device: Union[str, torch.device, None] = None) -> dict:
    """Seconds-scale serving smoke (the ``make serve-smoke`` contract):
    ONE tenant, ONE replica, one full serve session — claim → first
    decoded batch → drain → teardown — then a zero-residue audit (claims,
    checkpoint entries, CDI specs) and the accounting identity.

    On the card (``device`` None or CUDA): the node is the host's own GPUs
    (:func:`~k8s_dra_driver_tpu_torch.gpulib.device_lib.locate_gpu`
    finds the card ``device`` is, by UUID), and the claim asks for that GPU
    by a CEL selector on its UUID, since neither the node's index nor the
    device minor is the CUDA index. On the CPU (``device="cpu"``): the
    ``h100-8`` mock, two GPUs per claim as in the JAX smoke, their UUIDs
    mapped to the mock's indices. State lives under ``tmpdir`` (a
    temporary directory, removed after, when None)."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import (
        MockDeviceLib,
        locate_gpu,
    )
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
    from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import (
        NodePrepareLoop,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )

    dev = _resolve_device(device)
    if dev.type == "cuda":
        want = next(u for u, i in cuda_device_uuids().items()
                    if i == dev.index)
        lib, gpu = locate_gpu(want)
        gpus_per_claim = 1
        selectors: tuple[str, ...] = (
            f"device.attributes['uuid'] == '{gpu.uuid}'",)
        uuids = None
        engine_device = None
    else:
        lib = MockDeviceLib("h100-8")
        gpus_per_claim = 2
        selectors = ()
        uuids = {g.uuid: g.index for g in lib.enumerate_gpus()}
        engine_device = dev
    with tempfile.TemporaryDirectory(prefix="serve-smoke-") as scratch:
        tmp = tmpdir or scratch
        client = FakeClient()
        client.create(new_object(
            "DeviceClass", DRIVER_NAME,
            spec={"selectors": [{"cel": {
                "expression": "device.attributes['type'] == 'gpu'"}}]}))
        client.create(new_object("Node", "node-0"))
        driver = GpuDriver(client, DriverConfig(
            node_name="node-0", state_dir=f"{tmp}/gpu", cdi_root=f"{tmp}/cdi",
            env={}, retry_timeout=2.0,
        ), device_lib=lib).start()
        loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0",
                               namespace="default").start()
        metrics = ServingMetrics()
        engine_kwargs = dict(SERVING_SMOKE_ENGINE)
        _serving_warmup(engine_kwargs, dev)
        rep = ServingReplica(
            name="r0", tenant="smoke", client=client,
            allocator=Allocator(client), node="node-0", metrics=metrics,
            cdi_lookup=lambda _n, uid: driver.cdi.read_claim_spec(uid),
            gpus_per_claim=gpus_per_claim, selectors=selectors,
            serve_s=0.2, deadline_s=5.0,
            requests_per_burst=12, prompt_tokens=6, max_new_tokens=6,
            engine_kwargs=engine_kwargs, device=engine_device, uuids=uuids)
        try:
            rec = rep.serve_once()
        finally:
            loop.stop()
            driver.stop()
        leaks = [f"claim:{(c.get('metadata') or {}).get('name', '')}"
                 for c in client.list("ResourceClaim", "default")
                 if ((c.get("metadata") or {}).get("name", "")
                     .startswith("serve-"))]
        leaks += [f"checkpoint:{pc.name}"
                  for _uid, pc in sorted(driver.state.prepared_claims_nolock()
                                         .items())
                  if pc.name.startswith("serve-")]
        leaks += [f"cdi:{uid}" for uid in driver.cdi.list_claim_uids()]
    accounted = (rep.completed + rep.shed + rep.rejected == rep.submitted)
    return {
        "outcome": rec["outcome"],
        "ttfb_s": rec["ttfb_s"],
        "completed": rep.completed,
        "shed": rep.shed,
        "rejected": rep.rejected,
        "decode_tokens": rep.decode_tokens,
        "kv_isolation_max_err": rep.kv_isolation_max_err,
        "accounted": accounted,
        "leaks": leaks,
        "error": rec["error"],
        "backend": lib.backend,
        "gpus": rec["gpus"],
        "device": rec["device"],
        "ok": (rec["outcome"] == CLAIM_OK and rep.completed > 0
               and accounted and not leaks),
    }


#: the scale harness's engine on the CPU (the JAX harness's): 32 slots
#: over a 64-token cache at the engine's default width, a queue of 128,
#: device time modeled at 500 tokens/s a GPU
SCALE_SERVING_ENGINE = dict(max_batch=32, kv_cap=64, tokens_per_chip_step=16,
                            modeled_chip_tok_s=500.0, queue_cap=128)


def run_serving_scale(
    measure_rounds: int = 2,
    arm_window_s: float = 1.5,
    replicas_hi: int = 4,
    gpus_per_claim: int = 2,
    n_nodes: int = 2,
    profile: str = "h100-8",
    serve_s: float = 0.45,
    deadline_s: float = 2.0,
    ttfb_bound_s: float = 1.5,
    autoscale: bool = True,
    autoscale_phase_s: float = 0.8,
    shards: int = 2,
    tmpdir: Optional[str] = None,
    serving_engine: Optional[dict] = None,
    device: Union[str, torch.device, None] = None,
) -> dict:
    """Serving-dataplane scale harness (the JAX package's, on GPUs): tenant
    replicas claim GPUs through the real claim path, bind decode engines to
    the GPUs their CDI specs name, and serve continuous-batched traffic —
    measured, autoscaled and audited.

    **Throughput arms**: the aggregate decode rate is measured as 1 replica
    and as ``replicas_hi`` replicas in the same run, alternating the arms'
    order each round so drift lands on both; the drain barrier sits outside
    the measured window. Each claim takes ``gpus_per_claim`` whole GPUs of
    a mock ``h100-8`` node (2, as the JAX harness's ``chips_per_claim``, so
    each engine's modeled rate matches; at ``replicas_hi=4`` each node is
    half full, where the JAX harness's 4-chip hosts are full).

    **Autoscale leg**: two tenants follow a four-phase curve of replica
    counts, serving through a GPU-vanish flap (``set_unhealthy`` on node
    1's GPU 0) and a restart of node 0's prepare loop; scale-down drains,
    and every tenant must serve green again after the faults heal.

    **Shard leg** (``shards`` > 1): a tenant replica churns claims while
    ``shards`` shard-gated ComputeDomain controllers race six domains —
    the shared op ledger must stay violation-free and the usage-meter
    singleton pinned to the leader shard's holder.

    The end audit: no claim, checkpoint entry or CDI spec left, the
    admission accounting identity across every replica, and the
    KV-isolation oracle's maximum deviation.

    ``device``: where the engines run — the card by default (every engine
    on it: the nodes are mock nodes, so a claim's GPU UUIDs map to the
    mock's indices, which keeps a claim's two GPUs two, and the engine is
    placed on the card), ``"cpu"`` for the decode kernel's plain version;
    without a card and without ``device="cpu"`` it raises. Engines take
    ``serving_engine`` (default :data:`SCALE_SERVING_ENGINE`). The keys are
    the JAX harness's (``gpus_per_claim`` for ``chips_per_claim``);
    ``tokens`` adds ``decode_steps`` and ``warmup_launches``, the counts a
    caller holds the decode kernel's launches to."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
    from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import (
        NodePrepareLoop,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )

    dev = _resolve_device(device)
    tmp = tmpdir or tempfile.mkdtemp(prefix="serving-scale-")
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER_NAME,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    libs: list = []
    drivers: list = []
    loops: list = [None] * n_nodes
    for i in range(n_nodes):
        client.create(new_object("Node", f"node-{i}"))
        lib = MockDeviceLib(profile, host_index=i)
        libs.append(lib)
        drv = GpuDriver(client, DriverConfig(
            node_name=f"node-{i}", state_dir=f"{tmp}/gpu-{i}",
            cdi_root=f"{tmp}/cdi-{i}", env={}, retry_timeout=2.0,
        ), device_lib=lib).start()
        drivers.append(drv)
        loops[i] = NodePrepareLoop(client, drv, DRIVER_NAME,
                                   f"node-{i}", namespace="default").start()
    uuids = {g.uuid: g.index for lib in libs for g in lib.enumerate_gpus()}
    alloc = Allocator(client)
    metrics = ServingMetrics()
    engine_kwargs = dict(serving_engine or SCALE_SERVING_ENGINE)
    warmup_launches = _serving_warmup(engine_kwargs, dev)

    def _cdi(node: str, uid: str):
        return drivers[int(node.rsplit("-", 1)[1])].cdi.read_claim_spec(uid)

    all_reps: list[ServingReplica] = []

    def _mk_replica(j: int, tenant: Optional[str] = None,
                    node: Optional[str] = None,
                    serve: float = serve_s) -> ServingReplica:
        r = ServingReplica(
            name=f"r{len(all_reps)}", tenant=tenant or f"tenant-{j}",
            client=client, allocator=alloc,
            node=node or f"node-{j % n_nodes}", metrics=metrics,
            cdi_lookup=_cdi, gpus_per_claim=gpus_per_claim,
            serve_s=serve, deadline_s=deadline_s,
            engine_kwargs=engine_kwargs, device=dev, uuids=uuids)
        all_reps.append(r)
        return r

    errors: list = []
    ttfb_all: list[float] = []
    arm_tput: dict[int, list[float]] = {1: [], replicas_hi: []}
    auto_result = None
    shard_result = None

    def _decode_total(tenants: list[str]) -> float:
        return sum(metrics.tokens_total.value(tenant=t, kind="decode")
                   for t in tenants)

    try:
        # One unmeasured warm session: claim path + engine.
        warm = _mk_replica(0)
        w = warm.serve_once()
        if w["outcome"] != CLAIM_OK:
            errors.append(("warmup", w["error"]))

        def _run_arm(n: int) -> None:
            reps = [_mk_replica(j) for j in range(n)]
            tenants = [r.tenant for r in reps]
            for r in reps:
                r.start()
            settle = time.monotonic() + 10.0
            while time.monotonic() < settle:
                if all(r.ok >= 1 for r in reps):
                    break
                time.sleep(0.02)
            t0 = time.monotonic()
            tok0 = _decode_total(tenants)
            time.sleep(arm_window_s)
            tok1 = _decode_total(tenants)
            t1 = time.monotonic()
            for r in reps:           # drain barrier OUTSIDE the window
                r.stop()
            arm_tput[n].append((tok1 - tok0) / max(t1 - t0, 1e-9))
            for r in reps:
                ttfb_all.extend(r.ttfb_s)
                if r.errors:
                    errors.append((f"arm{n}:{r.tenant}", r.last_error))

        for rnd in range(measure_rounds):
            for n in ([1, replicas_hi] if rnd % 2 == 0
                      else [replicas_hi, 1]):
                _run_arm(n)

        # -- autoscale + resilience leg --------------------------------
        if autoscale:
            curve = [
                {"tenant-a": 1, "tenant-b": 1},
                {"tenant-a": 2, "tenant-b": 1},   # + GPU-vanish flap
                {"tenant-a": 1, "tenant-b": 2},   # + prepare-loop restart
                {"tenant-a": 1, "tenant-b": 1},
            ]
            fleets: dict[str, list[ServingReplica]] = {
                t: [] for t in curve[0]}
            spawned = [0]

            def _scale_to(targets: dict[str, int]) -> None:
                for tenant, want in targets.items():
                    fleet = fleets[tenant]
                    while len(fleet) < want:
                        r = _mk_replica(spawned[0], tenant=tenant,
                                        node=f"node-{len(fleet) % n_nodes}",
                                        serve=0.3)
                        spawned[0] += 1
                        fleet.append(r)
                        r.start()
                    while len(fleet) > want:
                        # Scale-down is the drain contract: stop() lets
                        # the in-flight session finish; anything unshed
                        # shows up in the accounting audit.
                        fleet.pop().stop()

            events: list[str] = []
            for pi, targets in enumerate(curve):
                _scale_to(targets)
                if pi == 1:
                    libs[1 % n_nodes].set_unhealthy(
                        0, reason="serving GPU-vanish flap")
                    events.append("gpu_vanish")
                if pi == 2:
                    libs[1 % n_nodes].set_healthy(0)
                    loops[0].stop()
                    loops[0] = NodePrepareLoop(
                        client, drivers[0], DRIVER_NAME, "node-0",
                        namespace="default").start()
                    events.append("daemon_restart")
                time.sleep(autoscale_phase_s)
            for fleet in fleets.values():
                for r in fleet:
                    r.stop()
            # Green after the faults: one synchronous session per tenant
            # must serve end to end now that the flap healed and the
            # restarted loop took over.
            recovered = {t: fleets[t][0].serve_once()["outcome"] == CLAIM_OK
                         for t in fleets}
            fault_window_errors = sum(
                r.errors for f in fleets.values() for r in f)
            auto_result = {
                "phases": len(curve),
                "events": events,
                "tenants": {t: {"sessions": sum(r.sessions for r in f),
                                "ok": sum(r.ok for r in f),
                                "errors": sum(r.errors for r in f)}
                            for t, f in fleets.items()},
                "fault_window_errors": fault_window_errors,
                "recovered": recovered,
                "ok": all(recovered.values()),
            }
            if not all(recovered.values()):
                errors.append(("autoscale_recovery", str(recovered)))

        # -- sharded-controller compatibility leg ----------------------
        if shards > 1:
            from k8s_dra_driver_tpu_torch.api.computedomain import (
                new_compute_domain,
            )
            from k8s_dra_driver_tpu_torch.pkg.shardmap import ShardOpLedger
            from k8s_dra_driver_tpu_torch.pkg.usage import (
                UsageMeter,
                UsageMetrics,
            )
            from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller \
                .controller import ComputeDomainController
            from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller \
                .sharding import (
                    LEADER_SHARD,
                    ShardedController,
                    SingletonHandle,
                )

            ledger = ShardOpLedger()
            singleton_log: list[tuple[str, str]] = []

            def _meter_factory(ident: str):
                def make():
                    m = UsageMeter(client, namespace="default",
                                   metrics=UsageMetrics())
                    singleton_log.append((ident, "start"))
                    return SingletonHandle(
                        m, lambda: singleton_log.append((ident, "stop")))
                return make

            sharded: list = []
            controllers: list = []
            for i in range(shards):
                ident = f"serve-shard-{i}"
                s = ShardedController(
                    client, ident, shards, lease_prefix="serve-shard",
                    # Static ownership: the leg audits gate discipline
                    # under claim churn, not lease churn.
                    lease_duration=3600.0, renew_deadline=2400.0,
                    ledger=ledger,
                    singleton_factories={
                        "usage-meter": _meter_factory(ident)})
                c = ComputeDomainController(client, workers=1,
                                            shard_gate=s.gate)
                c.cleanup.interval = 3600.0
                c.cleanup.min_gap = 3600.0
                sharded.append(s)
                controllers.append(c)
            for s in sharded:
                s.shard_map._renew_membership()
            settled = _settle_shard_fleet(sharded, advance=lambda: None,
                                          rounds=50)
            churn = _mk_replica(0, tenant="tenant-shard", serve=0.25)
            churn.start()
            cd_names = []
            for di in range(6):
                cd = client.create(new_compute_domain(
                    f"serve-cd-{di}", "default", num_nodes=1))
                cd_names.append(cd["metadata"]["name"])
            for _ in range(4):
                for nm in cd_names:
                    obj = client.get("ComputeDomain", nm, "default")
                    for c in controllers:
                        # Both replicas race every domain; the shard
                        # gate must admit exactly one.
                        c.reconcile(obj)
                time.sleep(0.05)
            churn.stop()
            # Read leadership before stopping: stop() releases the
            # leases, so confidence (rightly) drops to zero after.
            leaders = [s.identity for s in sharded
                       if s.shard_map.confident(LEADER_SHARD)]
            for s in sharded:
                s.stop()
            starts = [e for e in singleton_log if e[1] == "start"]
            leader_pinned = (len(leaders) == 1 and len(starts) == 1
                             and starts[0][0] == leaders[0])
            violations = ledger.violations()
            shard_result = {
                "shards": shards,
                "settled": settled,
                "ledger_violations": violations[:5],
                "leaders": leaders,
                "singleton_starts": [e[0] for e in starts],
                "leader_pinned": leader_pinned,
                "churn_sessions": churn.sessions,
                "churn_ok": churn.ok,
                "churn_errors": churn.errors,
                "ok": (settled and leader_pinned and not violations
                       and churn.ok > 0 and churn.errors == 0),
            }
            if violations:
                errors.append(("shard_ledger", str(violations[:3])))
            if not leader_pinned:
                errors.append(("shard_singleton",
                               f"leaders={leaders} starts={starts}"))
            if churn.errors:
                errors.append(("shard_churn", churn.last_error))
    finally:
        for r in all_reps:
            r.stop()
        for lp in loops:
            if lp is not None:
                lp.stop()
        for d in drivers:
            d.stop()

    # -- end audits --------------------------------------------------------
    leaks: list[str] = []
    try:
        for c in client.list("ResourceClaim", "default"):
            nm = (c.get("metadata") or {}).get("name", "")
            if nm.startswith("serve-"):
                leaks.append(f"claim:{nm}")
    except Exception as e:  # noqa: BLE001 — a failed audit LIST is
        # itself a failure, not a pass
        leaks.append(f"audit-list-failed:{e!r}")
    for i, drv in enumerate(drivers):
        try:
            for _uid, pc in sorted(drv.state.prepared_claims_nolock()
                                   .items()):
                if pc.name.startswith("serve-"):
                    leaks.append(f"checkpoint:node-{i}:{pc.name}")
        except Exception:  # noqa: BLE001 — a stopped driver's state dir
            # is still readable; a race here would re-read empty
            pass
        leaks += [f"cdi:node-{i}:{uid}" for uid in drv.cdi.list_claim_uids()]
    if tmpdir is None:
        shutil.rmtree(tmp, ignore_errors=True)

    agg = {k: sum(getattr(r, k) for r in all_reps)
           for k in ("sessions", "ok", "errors", "submitted", "completed",
                     "shed", "rejected", "prefill_tokens",
                     "decode_tokens", "decode_steps")}
    accounted = (agg["completed"] + agg["shed"] + agg["rejected"]
                 == agg["submitted"])
    if not accounted:
        errors.append(("accounting", str(agg)))
    if leaks:
        errors.append(("residue", str(leaks[:5])))
    kv_err = max((r.kv_isolation_max_err for r in all_reps), default=0.0)

    t_lo = _trimmed_mean(arm_tput[1], lo=0.0, hi=0.98)
    t_hi = _trimmed_mean(arm_tput[replicas_hi], lo=0.0, hi=0.98)
    scaling = round(t_hi / t_lo, 2) if t_lo else 0.0
    ttfb_p99 = _pct(ttfb_all, 0.99)
    return {
        "rounds": measure_rounds,
        "arm_window_s": arm_window_s,
        "replicas_hi": replicas_hi,
        "gpus_per_claim": gpus_per_claim,
        "tokens_s_lo": round(t_lo, 1),
        "tokens_s_hi": round(t_hi, 1),
        "scaling_x": scaling,
        "per_round": {str(k): [round(x, 1) for x in v]
                      for k, v in arm_tput.items()},
        "ttfb": {
            "count": len(ttfb_all),
            "p50_s": round(_pct(ttfb_all, 0.50), 4),
            "p99_s": round(ttfb_p99, 4),
            "bound_s": ttfb_bound_s,
            "ok": bool(ttfb_all) and ttfb_p99 <= ttfb_bound_s,
        },
        "sessions": agg["sessions"],
        "ok_sessions": agg["ok"],
        "error_sessions": agg["errors"],
        "accounting": {
            "submitted": agg["submitted"],
            "completed": agg["completed"],
            "shed": agg["shed"],
            "rejected": agg["rejected"],
            "ok": accounted,
        },
        "tokens": {"prefill": agg["prefill_tokens"],
                   "decode": agg["decode_tokens"],
                   "decode_steps": agg["decode_steps"],
                   "warmup_launches": warmup_launches},
        "kv_isolation_max_err": kv_err,
        "autoscale": auto_result,
        "shard": shard_result,
        "leaks": leaks[:10],
        "leak_count": len(leaks),
        "errors": errors[:10],
        "error_count": len(errors),
    }


def run_canary(
    duration_s: float = 8.0,
    n_nodes: int = 2,
    lease_duration_s: float = 1.2,
    node_kill_at_s: float = 2.0,
    canary_interval_s: float = 0.15,
    canary_deadline_s: float = 0.5,
    tmpdir: Optional[str] = None,
    fault_seed: int = 0,
) -> dict:
    """The canary harness leg (docs/observability.md, "Synthetic
    probing"): the node-kill soak with the user-perspective plane
    live — :func:`run_soak` with ``canary=True``, GPU chaos off (the
    kill is the only incident, so any probe failure off the kill path is
    a genuine fault-free-arm violation), and one claim worker per node
    so the probes never contend for the last GPU. The returned dict's
    ``canary`` section carries the oracle: outside-in detection within
    2× the lease duration, cleared + green after rejoin, zero residue,
    and the GPU-seconds conservation verdict."""
    return run_soak(
        duration_s=duration_s, n_nodes=n_nodes, workers_per_node=1,
        gpu_fault_interval_s=0.0,
        lease_duration_s=lease_duration_s,
        node_kill_at_s=node_kill_at_s, recovery_slo_s=8.0,
        canary=True, canary_interval_s=canary_interval_s,
        canary_deadline_s=canary_deadline_s,
        tmpdir=tmpdir, fault_seed=fault_seed)




def run_serving_soak(
    duration_s: float = 8.0,
    n_nodes: int = 2,
    lease_duration_s: float = 1.2,
    node_kill_at_s: float = 2.0,
    serving_replicas: int = 2,
    serving_session_s: float = 0.35,
    serving_deadline_s: float = 0.6,
    tmpdir: Optional[str] = None,
    fault_seed: int = 0,
    serving_engine: Optional[dict] = None,
    device: Union[str, torch.device, None] = None,
) -> dict:
    """The serving node-kill leg (docs/performance.md, "Serving
    dataplane"): the node-kill soak with the serving plane live —
    :func:`run_soak` with ``serving=True``, GPU chaos off (the kill is
    the only incident), one claim worker per node. The returned dict's
    ``serving`` section carries the oracle: the ``claim_ready``
    burn-rate page fires during node loss, the FlightRecorder bundle
    captures it, usage intervals conserve exactly across the kill, and
    the page clears after repair — plus green-after-rejoin sessions and
    the admission accounting identity.

    ``device``: where the replicas' engines run — the card by default
    (every mock GPU's UUID mapped onto it: the nodes are mock nodes and
    the engines share the one card), ``"cpu"`` for the decode kernel's
    plain version. ``serving_engine``: the engines' ServingEngine
    arguments (default :data:`SOAK_SERVING_ENGINE`)."""
    return run_soak(
        duration_s=duration_s, n_nodes=n_nodes, workers_per_node=1,
        gpu_fault_interval_s=0.0,
        lease_duration_s=lease_duration_s,
        node_kill_at_s=node_kill_at_s, recovery_slo_s=8.0,
        serving=True, serving_replicas=serving_replicas,
        serving_session_s=serving_session_s,
        serving_deadline_s=serving_deadline_s,
        serving_engine=serving_engine, device=device,
        tmpdir=tmpdir, fault_seed=fault_seed)


#: the full seeded fault mix the self-healing soak runs under: API-verb
#: failures (the in-process analogue of apiserver 500s), watch-stream
#: drops, torn checkpoint publishes, CDI write failures, and transient
#: GPU-vanish flaps — on TOP of the harness's own GPU-unhealthy
#: injections and reallocator restarts (process-crash simulation).
#: Crash schedules are rejected.
SOAK_FAULT_MIX = (
    "k8sclient.fake.mutate=rate:0.01;"
    "k8sclient.fake.read=rate:0.005;"
    "k8sclient.watch.drop=rate:0.01;"
    "checkpoint.replace=rate:0.005;"
    "checkpoint.write=rate:0.005;"
    "cdi.write=rate:0.005;"
    "gpulib.gpu.vanish=rate:0.002"
)


def run_soak(
    duration_s: float = 8.0,
    n_nodes: int = 2,
    workers_per_node: int = 2,
    profile: str = "h100-8",
    tmpdir: Optional[str] = None,
    channel_every: int = 5,
    faults: Optional[str] = None,
    fault_seed: int = 0,
    gpu_fault_interval_s: float = 0.6,
    targeted_fault_bias: float = 0.7,
    realloc_restart_interval_s: float = 0.0,
    recovery_slo_s: float = 5.0,
    hold_s: float = 0.25,
    claim_deadline_s: float = 20.0,
    quiesce_timeout_s: float = 30.0,
    lease_duration_s: float = 0.8,
    node_kill_at_s: Optional[float] = None,
    partition_at_s: Optional[float] = None,
    partition_duration_s: Optional[float] = None,
    blackbox: bool = False,
    blackbox_burst_faults: str = "devicestate.prepare=rate:0.9",
    blackbox_scrape_interval_s: float = 0.05,
    blackbox_burst_timeout_s: float = 6.0,
    canary: bool = False,
    canary_interval_s: float = 0.15,
    canary_deadline_s: float = 0.5,
    serving: bool = False,
    serving_replicas: int = 2,
    serving_session_s: float = 0.35,
    serving_deadline_s: float = 0.6,
    serving_gpus: int = 1,
    serving_engine: Optional[dict] = None,
    device: Union[str, torch.device, None] = None,
) -> dict:
    """Self-healing soak (docs/self-healing.md): an hours-compressed,
    seeded fault mix over ``n_nodes`` full node stacks with the WHOLE
    remediation pipeline live, plus an oracle that makes recovery a hard
    contract rather than a hope.

    Per node: both kubelet plugins (real drivers over MockDeviceLib),
    their NodePrepareLoops, the device health monitor, and a
    DrainController with a :class:`remediation.SimulatedRepair` hook (heal
    the GPU + boot-id flip, adopted by both plugins). Cluster-side: the
    CD controller children for channel claims and a ClaimReallocator —
    optionally killed and recreated every ``realloc_restart_interval_s``
    (its only state is API annotations, so a restart must lose nothing;
    this is the controller-crash leg of the fault mix).

    The workload: ``workers_per_node`` claim workers per node cycling
    create → allocate (node-pinned, one scheduler actor) → wait Ready →
    hold ``hold_s`` → graceful unreserve → delete, mixing in a
    ComputeDomain channel claim every ``channel_every`` cycles. While a
    worker holds a Ready claim it keeps watching: a drain (Ready lost)
    extends the wait until the claim is Ready again ELSEWHERE — that
    re-Ready gap is the claim-level recovery sample the SLO gates.

    GPU chaos: a seeded injector flips a GPU unhealthy every
    ``gpu_fault_interval_s`` (biased toward GPUs that currently hold a
    prepared claim, so drains actually exercise), and ONLY the repair hook
    heals it — every injection must ride the full taint → drain → repair →
    rejoin pipeline. ``faults`` (e.g. :data:`SOAK_FAULT_MIX`) layers the
    API/checkpoint/watch fault schedule on top.

    Oracle (every violation is a hard failure, listed in ``errors``):

    - zero leaked prepares: every checkpoint empty (tombstones expired
      through the real GC), no CDI spec files, no lingering claims;
    - every claim terminal Ready-or-cleanly-failed: a claim that never
      became Ready must carry a clean failure record (ReallocationFailed
      Event / failed allocation), never a silent wedge;
    - every injected unhealthy GPU drained, repaired, and rejoined: no
      taints left in the published slices, every injection has a
      later repair record;
    - every drained claim reallocated or cleanly failed (Events), with no
      unresolved drain annotations;
    - recovery SLO: claim drain → Ready-elsewhere p99 within
      ``recovery_slo_s``.

    **Node-scale failure legs** (docs/self-healing.md, "Whole-node
    repair"): ``node_kill_at_s`` kills node 0's ENTIRE stack mid-load
    (heartbeat, monitor, drainer, claim loops, drivers — plugin-process
    death); ``partition_at_s`` partitions node 1's clients from the API
    server for ``partition_duration_s`` (default 3 lease durations) via
    the :class:`k8sclient.PartitionGate`. Either leg assembles the node
    plane: a per-node ``NodeLeaseHeartbeat`` (duration
    ``lease_duration_s``, fence cleanup covering both plugins), all
    node-side components behind per-node :class:`PartitionedClient`
    wrappers, and a :class:`NodeLifecycleController` whose repair hook
    heals the node's GPUs and — for the killed node — flips the boot id
    and restarts the whole stack (new epoch, fresh bootstrap). The
    oracle grows node legs: node loss must be DETECTED (cordon recorded,
    detection delay reported against the 2×lease bound), every cordoned
    node must uncordon and rejoin (no cordon annotations, fences, or
    cordon taints left at quiesce), and a continuous split-brain sampler
    asserts no claim stays checkpoint-prepared on two nodes past the
    reallocation-handoff window unless one of them is currently
    dead/partitioned/fenced.

    **Blackbox leg** (docs/observability.md, "Incident bundles"):
    ``blackbox=True`` (requires the node-kill leg, no partition leg)
    assembles the whole flight-recorder plane over real HTTP — per-node
    MetricsServers scraped by a :class:`telemetry.FleetTelemetry`,
    a seconds-compressed :class:`slo.SloEngine` over the prepare-error
    ratio, a :class:`blackbox.ContinuousProfiler` (burst-sampled while
    firing), and a :class:`blackbox.FlightRecorder` subscribed as the
    engine's consumer. The node kill doubles as the incident: the kill
    activates ``blackbox_burst_faults`` on top of the base mix and keeps
    it burning until the killed node UNCORDONS (so the alert provably
    clears after repair), yielding the full
    injection → burn → fence → repair → clear arc inside ONE resolved
    bundle — :func:`blackbox.audit_timeline_chain` is the oracle, and
    the same assert is re-run against the bundle served over real HTTP
    via ``/debug/incidents``.

    **Canary leg** (docs/observability.md, "Synthetic probing" + "Usage
    metering"): ``canary=True`` (requires the node-kill leg, no
    partition/blackbox legs) runs the user-perspective plane through the
    soak — a :class:`canary.CanaryProber` probing every node with full
    claim lifecycles (in-process CDI/checkpoint verify + residue hooks),
    a :class:`usage.UsageMeter` metering every tenant's GPU-seconds off
    the claim informer, and a seconds-compressed ``canary_availability``
    SLO engine fed by the probe counters through a local pseudo-target.
    Oracle: the kill must be DETECTED from the outside (probe failures
    firing the availability page within 2× the lease duration), the
    alert must CLEAR and probes go green after rejoin, probes off the
    kill path must all succeed, zero probe residue, and the meter's
    interval ledger must conserve exactly against an independent
    claim-watch draw recorder (nothing lost, nothing double-counted).
    """
    import random as _random

    from k8s_dra_driver_tpu_torch.api.computedomain import new_compute_domain
    from k8s_dra_driver_tpu_torch.k8sclient import (
        FakeClient,
        PartitionedClient,
        PartitionGate,
    )
    from k8s_dra_driver_tpu_torch.k8sclient.client import (
        AlreadyExistsError,
        NotFoundError,
        new_object,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin import AllocationError, Allocator
    from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import NodePrepareLoop
    from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
        ANN_DRAIN,
        ANN_DRAIN_FAILED,
        ClaimReallocator,
        DrainController,
        SimulatedRepair,
        parse_gpu_index,
    )
    from k8s_dra_driver_tpu_torch.pkg import bootid, faultpoints
    from k8s_dra_driver_tpu_torch.pkg.nodelease import (
        ANN_CORDON,
        KIND_LEASE,
        LEASE_NAMESPACE,
        TAINT_KEY_CORDON,
        NodeLeaseHeartbeat,
        NodeLifecycleController,
        fence_cleanup_for,
    )
    from k8s_dra_driver_tpu_torch.pkg.events import (
        REASON_CLAIM_DRAINED,
        REASON_CLAIM_REALLOCATED,
        REASON_REALLOCATION_FAILED,
        list_events,
    )
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (
        DEVICE_CLASS_CHANNEL,
        ComputeDomainController,
    )
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
        ComputeDomainDaemon,
    )
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin import (
        CdDriver,
        CdDriverConfig,
    )
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin.devices import (
        CD_DRIVER_NAME,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.device_state import (
        DRIVER_NAME as GPU_DRIVER_NAME,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.health import (
        attach_health_monitor,
    )
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib

    # The serving engines' device, resolved before anything starts: a
    # card asked for where there is none raises here, with nothing to
    # stop.
    sv_device = _resolve_device(device) if serving else None
    plan = faultpoints.FaultPlan(faults or "", seed=fault_seed)
    crashers = [n for n, s in plan.schedules.items()
                if s.mode.startswith("crash")]
    if crashers:
        raise ValueError(
            f"run_soak cannot host crash schedules {crashers}; process "
            "death is simulated by the reallocator restart leg and the "
            "kill-restart tests, not by FaultCrash in shared threads")

    tmp = tmpdir or tempfile.mkdtemp(prefix="soak-")
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", "gpu.nvidia.com",
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object(
        "DeviceClass", DEVICE_CLASS_CHANNEL,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'channel'"}}]}))

    rng = _random.Random(fault_seed ^ 0x50AC)
    alloc = Allocator(client)  # the one scheduler actor (workers AND the
    # reallocator AND the prober allocate through this shared instance —
    # two uncoordinated allocators could double-book a device, exactly as
    # two schedulers would; the shared reentrant ``Allocator.mutex`` is
    # the scheduler lock now, held only over the placement math)

    node_plane = node_kill_at_s is not None or partition_at_s is not None
    kill_node_i = 0
    part_node_i = 1 if n_nodes > 1 else 0
    if (node_kill_at_s is not None and partition_at_s is not None
            and n_nodes < 2):
        raise ValueError("node-kill + partition legs need n_nodes >= 2")
    if blackbox and (node_kill_at_s is None or partition_at_s is not None):
        raise ValueError(
            "blackbox=True needs the node-kill leg and no partition leg "
            "(the kill IS the incident; the legs thread holds the fault "
            "burst open until the killed node uncordons)")
    if canary and (node_kill_at_s is None or partition_at_s is not None
                   or blackbox):
        raise ValueError(
            "canary=True needs the node-kill leg and no partition/"
            "blackbox legs (the kill is what the outside-in probes must "
            "detect; detection attribution assumes one incident)")
    if serving and (node_kill_at_s is None or partition_at_s is not None
                    or blackbox or canary):
        raise ValueError(
            "serving=True needs the node-kill leg and no partition/"
            "blackbox/canary legs (the kill is the incident the "
            "claim_ready burn rate must page on; attribution assumes "
            "one incident and one paging plane)")
    part_dur = (partition_duration_s if partition_duration_s is not None
                else 3 * lease_duration_s)

    gate = PartitionGate() if node_plane else None
    libs: list[MockDeviceLib] = []
    envs: list[dict] = []
    node_clients: list = []
    gpu_drivers: list = [None] * n_nodes
    cd_drivers: list = [None] * n_nodes
    loops: list = [None] * (2 * n_nodes)
    monitors: list = [None] * n_nodes
    drainers: list = [None] * n_nodes
    heartbeats: list = [None] * n_nodes
    bb_servers: list = [None] * n_nodes
    bb_ports: list = [None] * n_nodes
    repairs: list[SimulatedRepair] = []
    for i in range(n_nodes):
        node = f"node-{i}"
        client.create(new_object("Node", node))
        boot_path = f"{tmp}/boot-{i}"
        with open(boot_path, "w") as f:
            f.write(f"boot-{i}-epoch0\n")
        env = {bootid.ENV_ALT_BOOT_ID_PATH: boot_path}
        envs.append(env)
        lib = MockDeviceLib(profile, host_index=i)
        libs.append(lib)
        node_clients.append(PartitionedClient(client, node, gate=gate)
                            if node_plane else client)
        repairs.append(SimulatedRepair(
            heal=(lambda dev, _lib=lib: _lib.set_healthy(
                parse_gpu_index(dev))), env=env))

    def build_stack(i: int) -> None:
        """(Re)assemble one node's full stack — the restart half of the
        whole-node repair leg replaces a killed node's entries in place
        (a fresh plugin process: new drivers bootstrapping from the
        flipped boot id, a new heartbeat with a bumped epoch)."""
        node = f"node-{i}"
        ncli = node_clients[i]
        # Blackbox runs shrink the in-batch retry budget: the burst's
        # injected prepare failures must reach the error COUNTERS (one
        # increment per failed batch) fast enough for the burn-rate
        # alert to fire before the lease-expiry fence — a 2 s budget
        # would throttle the SLO signal to one sample per claim per 2 s.
        # The claim watcher's own retry timer still recovers the claims.
        budget = 0.3 if blackbox else 2.0
        gpu = GpuDriver(ncli, DriverConfig(
            node_name=node, state_dir=f"{tmp}/gpu-{i}",
            cdi_root=f"{tmp}/cdi-gpu-{i}", env=envs[i],
            retry_timeout=budget,
        ), device_lib=libs[i]).start()
        cdd = CdDriver(ncli, CdDriverConfig(
            node_name=node, state_dir=f"{tmp}/cd-{i}",
            cdi_root=f"{tmp}/cdi-cd-{i}", env=envs[i],
            retry_timeout=budget,
        ), device_lib=MockDeviceLib(profile, host_index=i)).start()
        gpu_drivers[i] = gpu
        cd_drivers[i] = cdd
        fence = None
        if node_plane:
            hb = NodeLeaseHeartbeat(
                ncli, node, state_dir=f"{tmp}/gpu-{i}",
                lease_duration=lease_duration_s,
                renew_interval=lease_duration_s / 4.0,
                fence_cleanup=_joint_fence_cleanup(gpu, cdd, ncli),
            ).start()
            heartbeats[i] = hb
            fence = (lambda _hb=hb: _hb.fenced or _hb.suspect)
        loop_kwargs = dict(namespace="default", fence=fence)
        if node_plane:
            # Fence-deferred claims must re-check quickly once the
            # fence clears; the default 2 s timer would dominate the
            # recovery distribution at a sub-second lease.
            loop_kwargs["retry_delay"] = 0.2
        loops[2 * i] = NodePrepareLoop(ncli, gpu, GPU_DRIVER_NAME, node,
                                       **loop_kwargs).start()
        loops[2 * i + 1] = NodePrepareLoop(ncli, cdd, CD_DRIVER_NAME, node,
                                           **loop_kwargs).start()
        monitors[i] = attach_health_monitor(gpu, poll_interval=0.05)
        drainers[i] = DrainController(
            ncli, gpu, repair=repairs[i], companions=[cdd],
            poll_interval=0.05).start()
        if blackbox:
            # Per-node /metrics over real HTTP — the scrape targets the
            # blackbox plane's FleetTelemetry polls. A restarted node
            # re-binds its ORIGINAL port (allow_reuse_address) so the
            # fixed target set sees it rejoin.
            from k8s_dra_driver_tpu_torch.pkg.metrics import MetricsServer
            bb_servers[i] = MetricsServer(
                gpu.metrics.registry, cdd.metrics.registry,
                port=bb_ports[i] or 0).start()
            bb_ports[i] = bb_servers[i].port

    def _joint_fence_cleanup(gpu, cdd, ncli):
        a = fence_cleanup_for(gpu, ncli)
        b = fence_cleanup_for(cdd, ncli)

        def cleanup() -> None:
            a()
            b()
        return cleanup

    for i in range(n_nodes):
        build_stack(i)

    # CD stack for channel claims: a Ready domain over every node.
    controller = ComputeDomainController(client)
    cd = client.create(new_compute_domain("soak-dom", "default",
                                          num_nodes=n_nodes))
    controller.reconcile(cd)
    for i in range(n_nodes):
        ComputeDomainDaemon(
            client=client,
            device_lib=MockDeviceLib(profile, host_index=i),
            cd_uid=cd["metadata"]["uid"], cd_name="soak-dom",
            node_name=f"node-{i}", namespace="default",
            hostname=f"node-{i}").sync_once()
    controller.reconcile(client.get("ComputeDomain", "soak-dom", "default"))
    channel_rct = client.get("ResourceClaimTemplate", "soak-dom-channel",
                             "default")

    realloc_box = {"r": ClaimReallocator(
        client, retry_delay=0.05, attempt_budget=60,
        allocator=alloc).start()}
    realloc_restarts = [0]

    # -- node failure plane (docs/self-healing.md, "Whole-node repair") ----
    killed: set = set()
    incapacitated: set = set()      # node indices exempt from the
    # split-brain oracle RIGHT NOW (dead, partitioned, or fenced)
    incap_lock = sanitizer.new_lock("stresslab.soak.incap_lock")
    split_violations: list = []
    t_kill: list = [None]
    t_kill_wall: list = [None]
    t_part: list = [None]
    retired_fence_recoveries = [0]
    node_kills = [0]
    lifecycle = None

    def node_repair(node: str) -> bool:
        """The lifecycle controller's whole-node repair hook. Heals every
        unhealthy GPU through the node's SimulatedRepair (so the
        injection oracle sees repair records) and, for a KILLED node,
        flips the boot id and restarts the entire stack — the simulated
        'replace the machine' path. A partitioned node needs no restart:
        its own processes resume once the partition heals."""
        try:
            i = int(node.rsplit("-", 1)[1])
        except (ValueError, IndexError):
            return True
        lib = libs[i]
        for idx in sorted(set(lib._unhealthy)):
            new_boot = repairs[i](f"gpu-{idx}")
            if i not in killed and new_boot:
                # Live node (partition leg): both plugins adopt the
                # flipped boot id exactly as the per-device repair does.
                try:
                    gpu_drivers[i].adopt_boot_id(new_boot)
                    cd_drivers[i].adopt_boot_id(new_boot)
                except Exception:  # noqa: BLE001 — retried next poll
                    return False
        if i in killed:
            bootid.flip_boot_id(envs[i])
            build_stack(i)
            killed.discard(i)
        return True

    def kill_node(i: int) -> None:
        """Plugin-process death: every node-side thread stops, the lease
        stops renewing, checkpoints stay on disk exactly as a crashed
        process leaves them."""
        node_kills[0] += 1
        with incap_lock:
            killed.add(i)
            incapacitated.add(i)
        if bb_servers[i] is not None:
            # The dead node's /metrics goes dark with it — the scraper
            # must staleness-mark the target, not read a ghost registry.
            bb_servers[i].stop()
            bb_servers[i] = None
        hb = heartbeats[i]
        if hb is not None:
            retired_fence_recoveries[0] += hb.fence_recoveries
            hb.stop()
        monitors[i].stop()
        drainers[i].stop()
        for j in (2 * i, 2 * i + 1):
            loops[j].initiate_stop()
        for j in (2 * i, 2 * i + 1):
            loops[j].join(timeout=10.0)
        for drv in (gpu_drivers[i], cd_drivers[i]):
            try:
                drv.stop()
            except Exception:  # noqa: BLE001 — an injected API fault on
                # the helper's deregistration write must not abort the
                # kill (a real crashed plugin leaves its registration
                # behind too; the leg schedule must go on).
                pass

    if node_plane:
        lifecycle = NodeLifecycleController(
            client, poll_interval=lease_duration_s / 4.0,
            repair=node_repair).start()

    # -- blackbox plane (docs/observability.md, "Incident bundles") --------
    bb_telemetry = None
    bb_engine = None
    bb_recorder = None
    bb_profiler = None
    bb_debug_server = None
    bb_burst_plan = None
    bb_result = None
    if blackbox:
        from k8s_dra_driver_tpu_torch.pkg import slo as slolib
        from k8s_dra_driver_tpu_torch.pkg.blackbox import (
            BlackboxMetrics,
            ContinuousProfiler,
            FlightRecorder,
        )
        from k8s_dra_driver_tpu_torch.pkg.events import EventRecorder
        from k8s_dra_driver_tpu_torch.pkg.metrics import MetricsServer
        from k8s_dra_driver_tpu_torch.pkg.telemetry import (
            FLEET_PREPARE_ERRORS,
            FLEET_REQUESTS_TOTAL,
            FleetMetrics,
            FleetTelemetry,
        )

        burst_check = faultpoints.FaultPlan(blackbox_burst_faults,
                                            seed=fault_seed)
        if any(s.mode.startswith("crash")
               for s in burst_check.schedules.values()):
            raise ValueError("blackbox burst cannot host crash schedules")
        spec = ";".join(s for s in (faults, blackbox_burst_faults) if s)
        bb_burst_plan = faultpoints.FaultPlan(spec, seed=fault_seed)

        bb_telemetry = FleetTelemetry(
            targets=[(f"node-{i}",
                      f"http://127.0.0.1:{bb_ports[i]}/metrics")
                     for i in range(n_nodes)],
            interval_s=blackbox_scrape_interval_s,
            rule_window_s=1.0,
            metrics=FleetMetrics())
        # One SLO, seconds-compressed SRE pairs. Objective 0.99 (not the
        # shipped 0.999): the base SOAK_FAULT_MIX feeds ~1.5 % transient
        # prepare errors, which must NOT page — only the kill's burst
        # (~90 %) may. The ticket pair can still fire on the base mix;
        # extra ticket incidents are legitimate bundles, the oracle just
        # needs ONE resolved bundle whose timeline carries the full arc.
        bb_engine = slolib.SloEngine(
            bb_telemetry.rules,
            slos=(slolib.ratio_slo(
                "prepare_errors_incident", 0.99,
                FLEET_PREPARE_ERRORS, FLEET_REQUESTS_TOTAL,
                total_match={"operation": "prepare"},
                description="node prepares succeed (incident leg)"),),
            # Page pair compressed tighter than fleetwatch's (0.3/1.0):
            # the burn must land BEFORE the lease-expiry fence
            # (1.5 x lease after the kill) for the bundle timeline's
            # injection -> burn -> fence ordering to hold.
            windows=(
                slolib.BurnWindow(slolib.SEVERITY_PAGE, 0.3, 1.0, 14.4),
                slolib.BurnWindow(slolib.SEVERITY_TICKET, 2.4, 7.2, 1.0),
            ),
            events=EventRecorder(client, "blackbox"),
            metrics=slolib.SloMetrics())
        bb_telemetry.slo_engine = bb_engine
        bbm = BlackboxMetrics()
        bb_profiler = ContinuousProfiler(
            base_interval_s=0.2, burst_interval_s=0.02,
            metrics=bbm).start()
        bb_recorder = FlightRecorder(
            f"{tmp}/blackbox", client=client, engine=bb_engine,
            telemetry=bb_telemetry, profiler=bb_profiler,
            retention=8, metrics=bbm,
            window_families=(FLEET_PREPARE_ERRORS, FLEET_REQUESTS_TOTAL))
        # The engine's third subscribe() consumer (after flap damping
        # and the defrag planner in the production assembly).
        bb_engine.subscribe(bb_recorder.on_alert)
        bb_telemetry.start()
        # The /debug/incidents surface the smoke asserts over real HTTP.
        bb_debug_server = MetricsServer(
            bbm.registry, port=0,
            debug={"incidents": bb_recorder.debug_snapshot,
                   "profile": bb_profiler.snapshot}).start()

    # -- canary plane (docs/observability.md, "Synthetic probing") ---------
    cn_prober = cn_meter = cn_telemetry = cn_engine = cn_tracker = None
    cn_result = None
    cn_track_mu = None
    cn_track_live: dict = {}
    cn_track_done: list = []
    if canary:
        from k8s_dra_driver_tpu_torch.k8sclient.informer import Informer
        from k8s_dra_driver_tpu_torch.pkg import slo as cn_slolib
        from k8s_dra_driver_tpu_torch.pkg.canary import (
            CanaryMetrics,
            CanaryProber,
            driver_probe_hooks,
        )
        from k8s_dra_driver_tpu_torch.pkg.events import EventRecorder
        from k8s_dra_driver_tpu_torch.pkg.telemetry import (
            FleetMetrics,
            FleetTelemetry,
        )
        from k8s_dra_driver_tpu_torch.pkg.usage import UsageMeter, UsageMetrics

        cn_metrics = CanaryMetrics()

        def _cn_lookup(node: str):
            """The in-process probe hooks' driver handle — None while
            the node is dead or fenced (an out-of-process prober could
            not read node-local state mid-incident either; the post-
            rejoin probes re-check it after fence cleanup ran)."""
            try:
                i = int(node.rsplit("-", 1)[1])
            except (ValueError, IndexError):
                return None
            with incap_lock:
                dead = i in killed
            hb = heartbeats[i]
            if dead or (hb is not None and (hb.fenced or hb.suspect)):
                return None
            return gpu_drivers[i]

        cn_verify, cn_residue = driver_probe_hooks(_cn_lookup)
        cn_prober = CanaryProber(
            client, alloc,
            nodes=[f"node-{i}" for i in range(n_nodes)],
            interval_s=canary_interval_s, namespace="default",
            probe_deadline_s=canary_deadline_s,
            metrics=cn_metrics,
            verify=cn_verify, residue=cn_residue,
            history_cap=512)  # the oracle reads the WHOLE run's history
        cn_meter = UsageMeter(client, namespace="default",
                              metrics=UsageMetrics())
        # The probe counters join a recording-rule ring through a local
        # pseudo-target (the controller main's wiring, compressed), so
        # the availability SLO runs the REAL scrape→rules→engine path.
        cn_telemetry = FleetTelemetry(
            targets=[("canary", "local://canary")],
            interval_s=0.05, rule_window_s=1.0,
            metrics=FleetMetrics(),
            fetch=lambda _n, _u: cn_metrics.registry.expose_text())
        cn_engine = cn_slolib.SloEngine(
            cn_telemetry.rules,
            slos=(cn_slolib.canary_availability_slo(0.99),),
            # Seconds-compressed SRE pairs (the blackbox leg's shape):
            # the kill's probe failures must page BEFORE the lease fence.
            windows=(
                cn_slolib.BurnWindow(cn_slolib.SEVERITY_PAGE,
                                     0.3, 1.0, 14.4),
                cn_slolib.BurnWindow(cn_slolib.SEVERITY_TICKET,
                                     2.4, 7.2, 1.0),
            ),
            events=EventRecorder(client, "canary"),
            metrics=cn_slolib.SloMetrics())
        cn_telemetry.slo_engine = cn_engine

        # The conservation oracle's independent draw ledger: a dead-
        # simple claim-watch recorder of (uid, namespace, gpus)
        # intervals — same transition rules as the meter, none of its
        # machinery.
        cn_track_mu = sanitizer.new_lock("stresslab.soak.cn_track_mu")
        cn_dev_gpus: dict = {}

        def _cn_gpus(results: list) -> int:
            total = 0
            for r in results:
                key = (r.get("pool", ""), r.get("device", ""))
                if key not in cn_dev_gpus:
                    try:
                        for s in client.list("ResourceSlice"):
                            pool = s["spec"]["pool"]["name"]
                            for dev in s["spec"].get("devices") or []:
                                draws = sum(
                                    int(cv.get("value", 0) or 0)
                                    for cc in dev.get(
                                        "consumesCounters") or []
                                    for cv in cc.get("counters",
                                                     {}).values())
                                cn_dev_gpus[(pool, dev["name"])] = max(
                                    1, draws)
                    except Exception:  # noqa: BLE001 — retried on the
                        # next unknown-key lookup
                        pass
                total += cn_dev_gpus.get(key, 1)
            return total

        def _cn_track(c: dict, deleted: bool = False) -> None:
            meta = c.get("metadata") or {}
            uid = meta.get("uid", "")
            res = (((c.get("status") or {}).get("allocation") or {})
                   .get("devices", {}).get("results", []))
            with cn_track_mu:
                if res and not deleted and uid not in cn_track_live:
                    cn_track_live[uid] = (meta.get("namespace", ""),
                                          _cn_gpus(res))
                elif (not res or deleted) and uid in cn_track_live:
                    ns, gpus = cn_track_live.pop(uid)
                    cn_track_done.append((uid, ns, gpus))

        cn_tracker = Informer(
            client, "ResourceClaim", "default",
            on_add=_cn_track,
            on_update=lambda _o, n: _cn_track(n),
            on_delete=lambda c: _cn_track(c, deleted=True)).start()
        cn_tracker.wait_for_cache_sync()
        cn_meter.start(observe_interval_s=0.05)
        cn_telemetry.start()
        cn_prober.start()

    # -- serving plane (docs/performance.md, "Serving dataplane") ----------
    sv_metrics = sv_meter = sv_telemetry = sv_engine = None
    sv_recorder = sv_tracker = None
    sv_replicas: list = []
    sv_result = None
    sv_green = None
    sv_track_mu = None
    sv_track_live: dict = {}
    sv_track_done: list = []
    if serving:
        from k8s_dra_driver_tpu_torch.compute.serving import ServingMetrics
        from k8s_dra_driver_tpu_torch.k8sclient.informer import Informer
        from k8s_dra_driver_tpu_torch.pkg import slo as sv_slolib
        from k8s_dra_driver_tpu_torch.pkg.blackbox import (
            BlackboxMetrics,
            FlightRecorder,
        )
        from k8s_dra_driver_tpu_torch.pkg.events import EventRecorder
        from k8s_dra_driver_tpu_torch.pkg.telemetry import (
            FLEET_SERVING_CLAIM_ATTEMPTS,
            FleetMetrics,
            FleetTelemetry,
        )
        from k8s_dra_driver_tpu_torch.pkg.usage import UsageMeter, UsageMetrics

        sv_metrics = ServingMetrics()
        sv_engine_kwargs = dict(serving_engine or SOAK_SERVING_ENGINE)
        # The mock nodes' GPUs are bound through their UUIDs: onto the
        # one card (the engines share it), or onto the CPU by the mock's
        # own indices.
        sv_uuids = {g.uuid: (sv_device.index or 0
                             if sv_device.type == "cuda" else g.index)
                    for lib in libs for g in lib.enumerate_gpus()}
        sv_engine_device = None if sv_device.type == "cuda" else sv_device
        sv_warmup_launches = _serving_warmup(sv_engine_kwargs, sv_device)

        def _sv_cdi(node: str, uid: str):
            """Node-local CDI spec read for a serving replica — raises
            while the node is dead (the replica's session then counts
            one claim_ready error, which is exactly the SLO signal)."""
            i = int(node.rsplit("-", 1)[1])
            with incap_lock:
                dead = i in killed
            drv = gpu_drivers[i]
            if dead or drv is None:
                raise RuntimeError(f"{node} is dead")
            return drv.cdi.read_claim_spec(uid)

        # Replica j pins node j % n_nodes, so with the default shape one
        # tenant rides THROUGH the killed node (its sessions fail fast
        # at the Ready-poll deadline — the error stream the page needs)
        # while the others keep an ok stream (the ratio's denominator).
        sv_replicas = [
            ServingReplica(
                name=f"r{j}", tenant=f"tenant-{j}", client=client,
                allocator=alloc, node=f"node-{j % n_nodes}",
                metrics=sv_metrics, cdi_lookup=_sv_cdi,
                gpus_per_claim=serving_gpus,
                serve_s=serving_session_s,
                deadline_s=serving_deadline_s,
                requests_per_burst=8, prompt_tokens=4, max_new_tokens=4,
                engine_kwargs=sv_engine_kwargs, device=sv_engine_device,
                uuids=sv_uuids)
            for j in range(serving_replicas)]
        # The claim_ready SLO runs the REAL scrape→rules→engine path
        # over a local pseudo-target, exactly like the canary plane.
        sv_telemetry = FleetTelemetry(
            targets=[("serving", "local://serving")],
            interval_s=0.05, rule_window_s=1.0,
            metrics=FleetMetrics(),
            fetch=lambda _n, _u: sv_metrics.registry.expose_text())
        sv_engine = sv_slolib.SloEngine(
            sv_telemetry.rules,
            slos=(sv_slolib.claim_ready_slo(0.99),),
            windows=(
                sv_slolib.BurnWindow(sv_slolib.SEVERITY_PAGE,
                                     0.3, 1.0, 14.4),
                sv_slolib.BurnWindow(sv_slolib.SEVERITY_TICKET,
                                     2.4, 7.2, 1.0),
            ),
            events=EventRecorder(client, "serving"),
            metrics=sv_slolib.SloMetrics())
        sv_telemetry.slo_engine = sv_engine
        sv_recorder = FlightRecorder(
            f"{tmp}/serving", client=client, engine=sv_engine,
            telemetry=sv_telemetry, retention=8,
            metrics=BlackboxMetrics(),
            window_families=(FLEET_SERVING_CLAIM_ATTEMPTS,))
        sv_engine.subscribe(sv_recorder.on_alert)
        sv_meter = UsageMeter(client, namespace="default",
                              metrics=UsageMetrics())

        # Independent draw ledger for the conservation oracle — the
        # canary plane's recorder, watching the serving run's claims.
        sv_track_mu = sanitizer.new_lock("stresslab.soak.sv_track_mu")
        sv_dev_gpus: dict = {}

        def _sv_gpus(results: list) -> int:
            total = 0
            for r in results:
                key = (r.get("pool", ""), r.get("device", ""))
                if key not in sv_dev_gpus:
                    try:
                        for s in client.list("ResourceSlice"):
                            pool = s["spec"]["pool"]["name"]
                            for dev in s["spec"].get("devices") or []:
                                draws = sum(
                                    int(cv.get("value", 0) or 0)
                                    for cc in dev.get(
                                        "consumesCounters") or []
                                    for cv in cc.get("counters",
                                                     {}).values())
                                sv_dev_gpus[(pool, dev["name"])] = max(
                                    1, draws)
                    except Exception:  # noqa: BLE001 — retried on the
                        # next unknown-key lookup
                        pass
                total += sv_dev_gpus.get(key, 1)
            return total

        def _sv_track(c: dict, deleted: bool = False) -> None:
            meta = c.get("metadata") or {}
            uid = meta.get("uid", "")
            res = (((c.get("status") or {}).get("allocation") or {})
                   .get("devices", {}).get("results", []))
            with sv_track_mu:
                if res and not deleted and uid not in sv_track_live:
                    sv_track_live[uid] = (meta.get("namespace", ""),
                                          _sv_gpus(res))
                elif (not res or deleted) and uid in sv_track_live:
                    ns, gpus = sv_track_live.pop(uid)
                    sv_track_done.append((uid, ns, gpus))

        sv_tracker = Informer(
            client, "ResourceClaim", "default",
            on_add=_sv_track,
            on_update=lambda _o, n: _sv_track(n),
            on_delete=lambda c: _sv_track(c, deleted=True)).start()
        sv_tracker.wait_for_cache_sync()
        sv_meter.start(observe_interval_s=0.05)
        sv_telemetry.start()
        for r in sv_replicas:
            r.start()

    errors: list = []
    fault_errors: list = []
    outcomes: dict[str, int] = {"ready_completed": 0, "alloc_failed": 0,
                                "failed_clean": 0, "stuck": 0}
    outcome_lock = sanitizer.new_lock("stresslab.soak.outcome_lock")
    claim_recoveries: list[float] = []
    stop_at = time.monotonic() + duration_s
    stop_all = threading.Event()

    def is_injected(err: BaseException) -> bool:
        return faultpoints.is_injected(err)

    def record(name: str, err: BaseException) -> None:
        (fault_errors if faults and is_injected(err) else errors).append(
            (name, repr(err)))

    def api(fn, *args):
        last: Optional[BaseException] = None
        for _ in range(80):
            try:
                return fn(*args)
            except (AllocationError, NotFoundError, AlreadyExistsError):
                raise
            except Exception as e:  # noqa: BLE001 — bounded retry
                last = e
                time.sleep(0.005)
        raise last  # type: ignore[misc]

    def claim_obj(name: str):
        """None means the claim is GONE — a transient (injected) read
        failure is retried through api() instead, because callers treat
        None as "already deleted" and e.g. graceful_teardown abandoning a
        live reserved claim on a read blip would leak it."""
        try:
            return api(client.get, "ResourceClaim", name, "default")
        except NotFoundError:
            return None

    def claim_ready(c: Optional[Obj], driver_name: str) -> bool:
        if c is None:
            return False
        for d in (c.get("status") or {}).get("devices") or []:
            if d.get("driver") == driver_name and any(
                    cond.get("type") == "Ready"
                    and cond.get("status") == "True"
                    for cond in d.get("conditions") or []):
                return True
        return False

    def cleanly_failed(name: str, c: Optional[Obj]) -> bool:
        if c is not None and ANN_DRAIN_FAILED in (
                (c.get("metadata") or {}).get("annotations") or {}):
            return True
        try:
            return bool(list_events(client, involved_name=name,
                                    reason=REASON_REALLOCATION_FAILED))
        except Exception:  # noqa: BLE001 — injected read
            return False

    def graceful_teardown(name: str, driver_name: str) -> None:
        """Unreserve, wait for the node side to unprepare (status.devices
        entry gone), then delete."""
        for _ in range(40):
            c = claim_obj(name)
            if c is None:
                return
            st = c.setdefault("status", {})
            if not st.get("reservedFor"):
                break
            st.pop("reservedFor", None)
            try:
                client.update_status(c)
                break
            except Exception:  # noqa: BLE001 — conflict/injected
                time.sleep(0.005)
        unprep_deadline = time.monotonic() + claim_deadline_s
        while time.monotonic() < unprep_deadline:
            c = claim_obj(name)
            if c is None or not any(
                    d.get("driver") == driver_name
                    for d in (c.get("status") or {}).get("devices") or []):
                break
            time.sleep(0.01)
        try:
            api(client.delete, "ResourceClaim", name, "default")
        except NotFoundError:
            pass

    # Claims whose worker deadline passed mid-chaos without a verdict:
    # "every claim terminal" is an END-STATE property, so the verdict is
    # deferred to the steady state after quiesce — a claim mid-remediation
    # at worker-deadline under in-suite load is not a wedge; one still
    # unready once everything healed IS.
    undecided: list[tuple[str, str]] = []

    def worker(node_i: int, w: int) -> None:
        cycle = 0
        while time.monotonic() < stop_at and not stop_all.is_set():
            cycle += 1
            use_channel = cycle % channel_every == 0
            name = f"soak-{node_i}-{w}-{cycle}"
            driver_name = CD_DRIVER_NAME if use_channel else GPU_DRIVER_NAME
            try:
                if use_channel:
                    spec = dict(channel_rct["spec"]["spec"])
                else:
                    spec = {"devices": {"requests": [{
                        "name": "gpu", "exactly": {
                            "deviceClassName": "gpu.nvidia.com",
                            "allocationMode": "ExactCount", "count": 1}}]}}
                api(client.create, new_object(
                    "ResourceClaim", name, "default",
                    api_version="resource.k8s.io/v1", spec=spec))
                try:
                    api(lambda: alloc.allocate(
                        claim_obj(name) or client.get(
                            "ResourceClaim", name, "default"),
                        reserved_for=[{"resource": "pods",
                                       "name": f"pod-{name}"}],
                        node=f"node-{node_i}"))
                except AllocationError:
                    api(client.delete, "ResourceClaim", name, "default")
                    with outcome_lock:
                        outcomes["alloc_failed"] += 1
                    # Brief backoff: a cordoned node's pinned workers
                    # would otherwise hot-spin create/delete until their
                    # node rejoins.
                    time.sleep(0.01)
                    continue
                deadline = time.monotonic() + claim_deadline_s

                def wait_ready() -> bool:
                    while time.monotonic() < deadline:
                        if claim_ready(claim_obj(name), driver_name):
                            return True
                        time.sleep(0.01)
                    return False

                got_ready = wait_ready()
                if got_ready:
                    # Hold, watching for drains: Ready lost then regained
                    # elsewhere is one recovery sample.
                    hold_until = time.monotonic() + hold_s
                    while time.monotonic() < hold_until:
                        if not claim_ready(claim_obj(name), driver_name):
                            lost_at = time.monotonic()
                            if wait_ready():
                                dt = time.monotonic() - lost_at
                                with outcome_lock:
                                    claim_recoveries.append(dt)
                                hold_until = time.monotonic() + hold_s
                            else:
                                got_ready = False
                                break
                        time.sleep(0.01)
                if not got_ready:
                    c = claim_obj(name)
                    with outcome_lock:
                        if cleanly_failed(name, c):
                            outcomes["failed_clean"] += 1
                        else:
                            # Verdict deferred to the post-quiesce oracle;
                            # the claim is kept alive for it.
                            undecided.append((name, driver_name))
                            continue
                else:
                    with outcome_lock:
                        outcomes["ready_completed"] += 1
                graceful_teardown(name, driver_name)
            except Exception as e:  # noqa: BLE001 — audited
                record(name, e)

    def gpu_chaos() -> None:
        """Seeded unhealthy-GPU injector; only the repair hook heals."""
        while time.monotonic() < stop_at and not stop_all.is_set():
            if stop_all.wait(gpu_fault_interval_s):
                return
            if time.monotonic() >= stop_at:
                return
            node_i = rng.randrange(n_nodes)
            lib = libs[node_i]
            held: list[int] = []
            try:
                for pc in gpu_drivers[node_i].state.prepared_claims_nolock(
                        ).values():
                    for d in pc.prepared_devices:
                        held.extend(d.get("chipIndices") or [])
            except Exception:  # noqa: BLE001 — injected checkpoint read
                held = []
            if held and rng.random() < targeted_fault_bias:
                idx = rng.choice(held)
            else:
                idx = rng.randrange(lib.node_info().num_gpus)
            if idx in lib._unhealthy:
                continue  # already faulted; the pipeline owns it
            lib.set_unhealthy(idx, "soak injected fault",
                              ecc_errors=rng.randrange(1, 9))
            injections.append((node_i, idx, time.monotonic()))

    def realloc_restarter() -> None:
        """Controller-crash leg: kill and recreate the reallocator; its
        only state is the API annotations, so nothing may be lost."""
        while not stop_all.wait(realloc_restart_interval_s):
            if time.monotonic() >= stop_at:
                return
            old = realloc_box["r"]
            old.stop()
            realloc_box["r"] = ClaimReallocator(
                client, retry_delay=0.05, attempt_budget=60,
                allocator=alloc).start()
            realloc_restarts[0] += 1

    def node_legs() -> None:
        """The node-scale fault schedule: kill / partition / heal at
        their appointed offsets from the soak start."""
        schedule: list[tuple[float, str]] = []
        if node_kill_at_s is not None:
            schedule.append((node_kill_at_s, "kill"))
        if partition_at_s is not None:
            schedule.append((partition_at_s, "partition"))
            schedule.append((partition_at_s + part_dur, "heal"))
        for t_ev, kind in sorted(schedule):
            delay = (t_start + t_ev) - time.monotonic()
            if delay > 0 and stop_all.wait(delay):
                break
            try:
                if kind == "kill":
                    t_kill[0] = time.monotonic()
                    t_kill_wall[0] = time.time()
                    kill_node(kill_node_i)
                    if bb_burst_plan is not None:
                        # The incident's burn signal: elevated prepare
                        # errors riding the node loss. Held open until
                        # the killed node UNCORDONS (so the alert
                        # provably clears AFTER repair — the arc the
                        # bundle oracle audits), bounded by a timeout.
                        # Runs inside this thread, which the main flow
                        # joins BEFORE deactivating faults — no race
                        # between restore and the final deactivate.
                        faultpoints.activate(bb_burst_plan)
                        burst_deadline = (time.monotonic()
                                          + blackbox_burst_timeout_s)
                        while (not stop_all.is_set()
                               and time.monotonic() < burst_deadline):
                            # Only THIS kill's uncordon ends the burst —
                            # a pre-kill cordon/uncordon cycle (heavier
                            # fault rates expiring the lease early)
                            # must not tear it down immediately.
                            if any(n == f"node-{kill_node_i}"
                                   and t >= t_kill[0]
                                   for n, t in lifecycle.uncordons):
                                break
                            time.sleep(0.05)
                        if not stop_all.is_set():
                            faultpoints.activate(plan)
                elif kind == "partition":
                    t_part[0] = time.monotonic()
                    with incap_lock:
                        incapacitated.add(part_node_i)
                    gate.partition(f"node-{part_node_i}")
                else:
                    gate.heal(f"node-{part_node_i}")
            except Exception as e:  # noqa: BLE001 — a failed leg is a
                # harness bug and fails the run, but the REMAINING legs
                # (above all a pending heal) must still run.
                errors.append((f"node_leg_{kind}", repr(e)))

    sampler_stop = threading.Event()

    #: how long a multi-node checkpoint overlap must PERSIST before it
    #: counts as split brain. A reallocation handoff inherently has a
    #: transient overlap — the new node prepares on ITS event delivery
    #: while the old holder unprepares on ITS OWN — which converges in
    #: tens of milliseconds; a genuine split brain (a node serving state
    #: the fence should have reaped) persists until cleanup or forever.
    SPLIT_BRAIN_PERSIST_S = 0.75

    def split_brain_sampler() -> None:
        """Continuously asserts the fencing contract: a claim uid
        checkpoint-prepared (PrepareCompleted) on two nodes, PERSISTING
        past the handoff window, is a split brain UNLESS at least one
        involved node is currently dead / partitioned / fenced (its
        stale state is exactly what the fence exists to clean up; the
        node cannot serve it). Nodes leave the exemption set when the
        lifecycle controller uncordons them — by then their fence
        cleanup provably ran."""
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_COMPLETED,
        )
        overlap_since: dict[tuple, float] = {}  # (uid, nodes) -> t0
        while not sampler_stop.wait(0.03):
            if lifecycle is not None:
                uncordoned = {n for n, _t in lifecycle.uncordons}
                with incap_lock:
                    for i in list(incapacitated):
                        if i not in killed and f"node-{i}" in uncordoned:
                            incapacitated.discard(i)
            holders: dict[str, list[int]] = {}
            for i in range(n_nodes):
                for drv in (gpu_drivers[i], cd_drivers[i]):
                    try:
                        prepared = drv.state.prepared_claims_nolock()
                    except Exception:  # noqa: BLE001 — raced a commit
                        continue
                    for uid, pc in prepared.items():
                        if pc.state == STATE_PREPARE_COMPLETED:
                            holders.setdefault(uid, []).append(i)
            with incap_lock:
                exempt = set(incapacitated)
            now = time.monotonic()
            live: set[tuple] = set()
            for uid, nodes in holders.items():
                distinct = tuple(sorted(set(nodes)))
                if len(distinct) > 1 and not any(i in exempt
                                                 for i in distinct):
                    key = (uid, distinct)
                    live.add(key)
                    t0 = overlap_since.setdefault(key, now)
                    if now - t0 >= SPLIT_BRAIN_PERSIST_S:
                        split_violations.append(
                            (uid, list(distinct),
                             round(now - t_start, 3)))
                        overlap_since[key] = now  # re-arm: count episodes
            for key in list(overlap_since):
                if key not in live:
                    overlap_since.pop(key, None)

    injections: list[tuple[int, int, float]] = []
    prev_plan = faultpoints.active_plan()
    faultpoints.activate(plan)
    t_start = time.monotonic()
    try:
        threads = [threading.Thread(target=worker, args=(i, w), daemon=True)
                   for i in range(n_nodes) for w in range(workers_per_node)]
        if gpu_fault_interval_s > 0:
            # 0 disables GPU chaos entirely (the canary leg: the node
            # kill must be the ONLY incident, so probe failures off the
            # kill path are genuine violations).
            threads.append(threading.Thread(target=gpu_chaos, daemon=True))
        if realloc_restart_interval_s > 0:
            threads.append(threading.Thread(target=realloc_restarter,
                                            daemon=True))
        if node_plane:
            threads.append(threading.Thread(target=node_legs, daemon=True))
            threading.Thread(target=split_brain_sampler,
                             daemon=True).start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=duration_s + 240)
        elapsed = time.monotonic() - t_start

        # Injection over: recovery must now complete on its own. The
        # remediation pipeline (monitors, drainers, reallocator) keeps
        # running fault-free until quiescent.
        faultpoints.deactivate()
        stop_all.set()
        def node_plane_quiet() -> bool:
            if not node_plane:
                return True
            if killed or (lifecycle is not None
                          and lifecycle.cordoned_nodes()):
                return False
            if any(hb is not None and hb.fenced for hb in heartbeats):
                return False
            for n in client.list("Node"):
                if ANN_CORDON in (n["metadata"].get("annotations") or {}):
                    return False
            for lease in client.list(KIND_LEASE, LEASE_NAMESPACE):
                if "fencedEpoch" in (lease.get("spec") or {}):
                    return False
            for slc in client.list("ResourceSlice"):
                for dev in (slc.get("spec") or {}).get("devices") or []:
                    if any(t.get("key") == TAINT_KEY_CORDON
                           for t in dev.get("taints") or []):
                        return False
            return True

        quiesce_deadline = time.monotonic() + quiesce_timeout_s
        quiesced = False
        pending_anns: list = []
        while time.monotonic() < quiesce_deadline:
            all_healthy = all(not lib._unhealthy for lib in libs)
            no_taints = all(not d.device_taints() for d in gpu_drivers)
            drains_idle = all(not d.draining for d in drainers)
            realloc_idle = realloc_box["r"].pending_count() == 0
            pending_anns = [
                c["metadata"]["name"] for c in client.list(
                    "ResourceClaim", "default")
                if ANN_DRAIN in (c["metadata"].get("annotations") or {})]
            bb_cleared = bb_engine is None or not bb_engine.firing()
            cn_cleared = cn_engine is None or not cn_engine.firing()
            if (all_healthy and no_taints and drains_idle and realloc_idle
                    and not pending_anns and node_plane_quiet()
                    and bb_cleared and cn_cleared):
                quiesced = True
                break
            time.sleep(0.05)
        if not quiesced:
            # Every condition of the loop above, so that the message names
            # the one that held.
            firing = sorted(f"{slo}/{sev}" for engine in (bb_engine, cn_engine)
                            if engine is not None for slo, sev in engine.firing())
            errors.append(("quiesce", "remediation pipeline never went "
                           f"idle within {quiesce_timeout_s}s: "
                           f"unhealthy={[sorted(lib._unhealthy) for lib in libs]} "
                           f"taints={[d.device_taints() for d in gpu_drivers]} "
                           f"drains={[d.active_devices() for d in drainers]} "
                           f"realloc_pending={realloc_box['r'].pending_count()} "
                           f"drain_annotated={pending_anns} firing={firing} "
                           + (f"node_plane_quiet={node_plane_quiet()} "
                              f"killed={sorted(killed)} cordoned="
                              f"{lifecycle.cordoned_nodes()} fenced="
                              f"{[i for i, hb in enumerate(heartbeats) if hb is not None and hb.fenced]}"
                              if node_plane else "")))
        sampler_stop.set()

        # Resolve the deferred verdicts in the steady state: injection is
        # over and the pipeline has quiesced, so a claim that STILL cannot
        # reach Ready-or-cleanly-failed now is genuinely stuck.
        for name, driver_name in undecided:
            verdict_deadline = time.monotonic() + claim_deadline_s
            verdict = None
            while time.monotonic() < verdict_deadline:
                c = claim_obj(name)
                if claim_ready(c, driver_name):
                    verdict = "ready_completed"
                    break
                if cleanly_failed(name, c):
                    verdict = "failed_clean"
                    break
                time.sleep(0.05)
            if verdict is None:
                verdict = "stuck"
                c = claim_obj(name)
                uid = (c or {}).get("metadata", {}).get("uid", "")
                cp_states = {}
                for di, drv in enumerate(gpu_drivers):
                    for _u, pc in drv.state.prepared_claims_nolock().items():
                        if pc.name == name:
                            cp_states[f"gpu-{di}"] = pc.state
                loop_states = {}
                for li, lp in enumerate(loops):
                    inf = lp._informer
                    cached = None
                    if inf is not None:
                        with inf._cache_lock:
                            cobj = inf._cache.get(("default", name))
                        cached = (cobj or {}).get("metadata", {}).get(
                            "resourceVersion") if cobj else None
                    loop_states[f"loop-{li}-{lp.driver_name[:3]}-"
                                f"{lp.pool_name}"] = {
                        "tracked": uid in lp._prepared,
                        "sig": lp._prepared_sig.get(uid),
                        "cached_rv": cached,
                        "relists": getattr(inf, "relist_count", None),
                        "resumes": getattr(inf, "resume_count", None),
                    }
                errors.append((name, "claim neither Ready nor cleanly "
                               "failed in the post-quiesce steady state: "
                               f"obj={c} checkpoints={cp_states} "
                               f"loops={loop_states}"))
            outcomes[verdict] += 1
            graceful_teardown(name, driver_name)

        # Settle: deleted claims unprepare through the claim watchers'
        # retry timers (2 s backoff under injected failures) — the audit
        # must wait for those to drain, not snapshot mid-retry.
        from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin.checkpoint import (
            STATE_PREPARE_ABORTED,
        )

        def dirty() -> bool:
            for d in [*gpu_drivers, *cd_drivers]:
                try:
                    for pc in d.state.prepared_claims_nolock().values():
                        if pc.state != STATE_PREPARE_ABORTED:
                            return True
                except Exception:  # noqa: BLE001 — read raced a commit
                    return True
            return any(
                c["metadata"]["name"].startswith("soak-")
                and c["metadata"]["name"] != "soak-dom-channel"
                for c in client.list("ResourceClaim"))

        # The serving replicas and the canary prober quiesce BEFORE the
        # settle wait and the leak audit — a replica still cycling, or a
        # probe in flight, keeps a claim prepared, which the settle wait
        # reads as not yet drained and the audit as checkpoint residue.
        # After the audit each runs one SYNCHRONOUS round: every tenant,
        # including the one pinned to the killed-and-repaired node, must
        # serve green end-to-end after rejoin, and every node probe green.
        if serving:
            for r in sv_replicas:
                r.stop()
        if cn_prober is not None:
            cn_prober.stop()

        settle_deadline = time.monotonic() + quiesce_timeout_s
        while time.monotonic() < settle_deadline and dirty():
            time.sleep(0.05)

        if serving:
            sv_green = [r.serve_once() for r in sv_replicas]

        # Expire drain tombstones through the real GC path
        # (time-accelerated) so the leak audit sees only true leaks.
        for d in [*gpu_drivers, *cd_drivers]:
            d.state.delete_expired_aborted(
                now=time.time() + d.state.aborted_ttl + 1.0)

        # Leak audit (fault-free window).
        leaks: dict[str, Any] = {}
        for i in range(n_nodes):
            if gpu_drivers[i].state.prepared_claims():
                leaks[f"gpu-{i}-checkpoint"] = list(
                    gpu_drivers[i].state.prepared_claims())
            if gpu_drivers[i].cdi.list_claim_uids():
                leaks[f"gpu-{i}-cdi"] = gpu_drivers[i].cdi.list_claim_uids()
            if cd_drivers[i].state.prepared_claims():
                leaks[f"cd-{i}-checkpoint"] = list(
                    cd_drivers[i].state.prepared_claims())
            if cd_drivers[i].cdi.list_claim_uids():
                leaks[f"cd-{i}-cdi"] = cd_drivers[i].cdi.list_claim_uids()
        lingering = [
            c["metadata"]["name"] for c in client.list("ResourceClaim")
            if c["metadata"]["name"].startswith("soak-")
            and c["metadata"]["name"] != "soak-dom-channel"]
        if lingering:
            leaks["claims"] = lingering

        # Oracle: every injected GPU repaired + rejoined.
        unresolved_injections = []
        for node_i, idx, t_inj in injections:
            dev = f"gpu-{idx}"
            repaired = any(d == dev and t_rep >= t_inj
                           for d, t_rep, _boot in
                           repairs[node_i].repaired_devices())
            if not repaired or idx in libs[node_i]._unhealthy:
                unresolved_injections.append((node_i, idx))
        if unresolved_injections:
            errors.append(("unresolved_injections",
                           str(unresolved_injections)))

        # Node-leg oracle: every induced node loss was detected (cordon
        # recorded) and the fencing contract held (no split brain).
        if node_plane:
            if node_kill_at_s is not None and t_kill[0] is not None:
                if not any(n == f"node-{kill_node_i}"
                           for n, _t in lifecycle.cordons):
                    errors.append(("node_kill", "killed node was never "
                                   "declared lost / cordoned"))
            if partition_at_s is not None and t_part[0] is not None:
                if not any(n == f"node-{part_node_i}"
                           for n, _t in lifecycle.cordons):
                    errors.append(("partition", "partitioned node was "
                                   "never declared lost / cordoned"))
            if split_violations:
                errors.append(("split_brain", str(split_violations[:5])))

        # Oracle: every drained claim reallocated or cleanly failed (or
        # deleted by its owner — lingering/annotation leaks are caught
        # above and in the quiesce check).
        drained_names = {(e.get("involvedObject") or {}).get("name")
                         for e in list_events(
                             client, reason=REASON_CLAIM_DRAINED)}
        realloc_names = {(e.get("involvedObject") or {}).get("name")
                         for e in list_events(
                             client, reason=REASON_CLAIM_REALLOCATED)}
        failed_names = {(e.get("involvedObject") or {}).get("name")
                        for e in list_events(
                            client, reason=REASON_REALLOCATION_FAILED)}

        # Blackbox-leg oracle: >= 1 RESOLVED bundle whose timeline
        # carries the full injection -> burn -> fence -> repair -> clear
        # arc, both from disk and as served over real HTTP.
        if blackbox:
            import json as _json
            import urllib.request as _urlreq

            from k8s_dra_driver_tpu_torch.pkg.blackbox import (
                audit_timeline_chain,
            )
            bundles = bb_recorder.list_bundles()
            complete = 0
            audit_samples: list = []
            for meta in bundles:
                if meta["status"] != "resolved":
                    continue
                try:
                    doc = bb_recorder.bundle(meta["id"])
                except Exception as e:  # noqa: BLE001 — a torn bundle
                    # is an oracle failure, not a crash.
                    audit_samples.append((meta["id"], repr(e)))
                    continue
                problems = audit_timeline_chain((doc or {}).get(
                    "timeline") or [])
                if not problems:
                    complete += 1
                else:
                    audit_samples.append((meta["id"], problems[:3]))
            http_complete = 0
            http_samples: list = []
            try:
                with _urlreq.urlopen(
                        f"http://127.0.0.1:{bb_debug_server.port}"
                        "/debug/incidents", timeout=5.0) as resp:
                    served = _json.loads(resp.read().decode())
                if not isinstance(served, list):
                    served = [served]
                for rec in served:
                    latest = rec.get("latest") or {}
                    problems = audit_timeline_chain(
                        latest.get("timeline") or [])
                    if latest.get("status") == "resolved" and not problems:
                        http_complete += 1
                    else:
                        http_samples.append((latest.get("id"),
                                             latest.get("status"),
                                             problems[:3]))
            except Exception as e:  # noqa: BLE001 — audited below
                errors.append(("blackbox_http", repr(e)))
            page_fired = None
            for tr in bb_engine.transitions():
                if (tr.severity == "page" and tr.transition == "fired"
                        and t_kill[0] is not None
                        and tr.at >= t_kill[0]):
                    page_fired = round(tr.at - t_kill[0], 3)
                    break
            prof = bb_profiler.snapshot(top=5)
            bb_result = {
                "incidents": len(bundles),
                "resolved": sum(1 for m in bundles
                                if m["status"] == "resolved"),
                "partial_captures": bb_recorder.partial_captures,
                "capture_errors": bb_recorder.capture_errors,
                "captures": bb_recorder.captures,
                "evicted": bb_recorder.evicted,
                "timeline_complete": complete,
                "http_timeline_complete": http_complete,
                "audit_samples": audit_samples[:3],
                "page_fired_after_kill_s": page_fired,
                "profiler": {
                    "samples": prof["samples"],
                    "distinct_stacks": prof["distinct_stacks"],
                    "dropped_stacks": prof["dropped_stacks"],
                    "lock_contention_rows": len(prof["lock_contention"]),
                },
                "scrapes": {
                    "success": int(bb_telemetry.metrics.scrapes_total
                                   .value(outcome="success")),
                    "error": int(bb_telemetry.metrics.scrapes_total
                                 .value(outcome="error")),
                },
            }
            if not complete:
                errors.append(("blackbox",
                               "no resolved bundle passed the timeline "
                               f"completeness oracle: {audit_samples[:2]}"))
            if not http_complete:
                errors.append(("blackbox_http",
                               "no HTTP-served bundle passed the "
                               "timeline completeness oracle: served "
                               f"{http_samples[:3]}; on disk "
                               f"{[(m['id'], m['status']) for m in bundles]}"
                               f"; audits {audit_samples[:3]}"))
            if bb_recorder.capture_errors:
                errors.append(("blackbox_capture",
                               f"{bb_recorder.capture_errors} capture(s) "
                               "raised internally (the recorder must "
                               "ride out the fault mix)"))

        # Canary-leg oracle: outside-in detection within the fence
        # bound, green again after rejoin, zero residue, and the
        # meter's interval ledger conserved EXACTLY against the
        # independent draw recorder.
        if canary:
            from k8s_dra_driver_tpu_torch.pkg.slo import SLO_CANARY_AVAILABILITY
            cn_prober.stop()
            final_round = cn_prober.run_once()  # post-quiesce green round
            green_after_rejoin = all(r["outcome"] == "ok"
                                     for r in final_round)
            detection = None
            cleared = False
            pre_kill_pages = 0
            for tr in cn_engine.transitions():
                if (tr.slo != SLO_CANARY_AVAILABILITY
                        or tr.severity != "page"):
                    continue
                if tr.transition == "fired":
                    if t_kill[0] is not None and tr.at >= t_kill[0]:
                        if detection is None:
                            detection = round(tr.at - t_kill[0], 3)
                    else:
                        pre_kill_pages += 1
                elif tr.transition == "cleared" and detection is not None:
                    cleared = True
            snap = cn_prober.debug_snapshot()
            # Probes off the kill path must all be green: every failure
            # on a non-killed node, or on the killed node whose probe
            # ENDED before the kill, is a fault-free-arm violation. A
            # probe that STARTED pre-kill but failed because the kill
            # landed mid-flight belongs to the kill, not the fault-free
            # arm — classify by the probe's end time, not its start.
            fault_free_failures = 0
            for node, st in snap["nodes"].items():
                if node != f"node-{kill_node_i}":
                    fault_free_failures += st["failures"]
                elif t_kill_wall[0] is not None:
                    fault_free_failures += sum(
                        1 for h in st["history"]
                        if h["outcome"] == "failed"
                        and h["at"] + h["duration_s"] < t_kill_wall[0])
            # Conservation: drain both observers (all claims are gone by
            # now; delivery may still be in flight), then compare the
            # interval ledgers claim by claim.
            drain_deadline = time.monotonic() + 5.0
            led = cn_meter.ledger()
            while time.monotonic() < drain_deadline:
                cn_meter.observe()
                led = cn_meter.ledger()
                with cn_track_mu:
                    live_now = dict(cn_track_live)
                if not led["live"] and not live_now:
                    break
                time.sleep(0.05)
            with cn_track_mu:
                track_done = list(cn_track_done)
                track_live_final = dict(cn_track_live)
            track_map: dict = {}
            for uid, ns, gpus in track_done:
                e = track_map.setdefault(
                    uid, {"namespace": ns, "gpus": gpus, "intervals": 0})
                e["intervals"] += 1
            meter_map = {
                uid: {"namespace": e["namespace"], "gpus": e["gpus"],
                      "intervals": e["intervals"]}
                for uid, e in led["claims"].items()}
            mismatches = [
                (uid, meter_map.get(uid), track_map.get(uid))
                for uid in sorted(set(meter_map) | set(track_map))
                if meter_map.get(uid) != track_map.get(uid)]
            # Internal exactness: the per-tenant totals must equal the
            # per-claim interval sums they were accrued from.
            by_ns: dict[str, float] = {}
            for e in led["claims"].values():
                by_ns[e["namespace"]] = (by_ns.get(e["namespace"], 0.0)
                                         + e["seconds"])
            internal_ok = all(
                abs(led["namespaces"].get(ns, 0.0) - v) < 1e-6
                for ns, v in by_ns.items())
            conservation_ok = (not mismatches and not led["live"]
                               and not track_live_final
                               and led["intervals_evicted"] == 0
                               and internal_ok)
            # snap was taken AFTER the final round, so its leak count
            # already includes the final round's findings.
            leaked = snap["leaked"]
            cn_result = {
                "interval_s": canary_interval_s,
                "deadline_s": canary_deadline_s,
                "detect_bound_s": round(2 * lease_duration_s, 3),
                "fired_page": detection is not None,
                "detection_delay_s": detection,
                "cleared": cleared,
                "green_after_rejoin": green_after_rejoin,
                "pre_kill_pages": pre_kill_pages,
                "fault_free_failures": fault_free_failures,
                "probes": snap["probes"],
                "failures": snap["failures"],
                "leaked": leaked,
                "probe_p99_s": snap["success_p99_s"],
                "per_node": {n: {k: st[k] for k in
                                 ("probes", "failures", "leaked",
                                  "last_outcome", "last_error")}
                             for n, st in snap["nodes"].items()},
                "conservation_ok": conservation_ok,
                "conservation": {
                    "intervals": sum(e["intervals"]
                                     for e in meter_map.values()),
                    "claims": len(meter_map),
                    "tracker_claims": len(track_map),
                    "mismatches": mismatches[:5],
                    "meter_live": len(led["live"]),
                    "tracker_live": len(track_live_final),
                    "evicted": led["intervals_evicted"],
                    "internal_consistent": internal_ok,
                    "namespaces": {ns: round(v, 4) for ns, v in
                                   sorted(led["namespaces"].items())},
                },
                "meter_observe_failures": cn_meter.observe_failures,
            }
            if not conservation_ok:
                errors.append(("canary_conservation",
                               f"GPU-seconds ledger diverged from the "
                               f"draw recorder: mismatches="
                               f"{mismatches[:3]} live={led['live'][:2]}"
                               f"/{list(track_live_final)[:2]} "
                               f"evicted={led['intervals_evicted']}"))

        # Serving-leg oracle: the claim_ready burn rate paged on the
        # kill and cleared after repair, the FlightRecorder's resolved
        # bundle carries that arc, every tenant serves green after
        # rejoin, the admission accounting identity holds across every
        # replica, and GPU-seconds conserve EXACTLY against the
        # independent draw recorder.
        if serving:
            from k8s_dra_driver_tpu_torch.pkg.slo import SLO_CLAIM_READY
            detection = None
            cleared = False
            pre_kill_pages = 0
            for tr in sv_engine.transitions():
                if tr.slo != SLO_CLAIM_READY or tr.severity != "page":
                    continue
                if tr.transition == "fired":
                    if t_kill[0] is not None and tr.at >= t_kill[0]:
                        if detection is None:
                            detection = round(tr.at - t_kill[0], 3)
                    else:
                        pre_kill_pages += 1
                elif tr.transition == "cleared" and detection is not None:
                    cleared = True
            # Fault-free-arm discipline: a failed session on a
            # non-killed node, or on the killed node that ENDED before
            # the kill, is a violation. A session that failed because
            # the kill landed mid-flight belongs to the kill —
            # classify by end time, exactly like the canary probes.
            fault_free_failures = 0
            for r in sv_replicas:
                for h in list(r.history):
                    if h["outcome"] == "ok":
                        continue
                    if h["node"] != f"node-{kill_node_i}":
                        fault_free_failures += 1
                    elif (t_kill_wall[0] is not None
                          and h["at"] + h["duration_s"] < t_kill_wall[0]):
                        fault_free_failures += 1
            # The resolved bundle whose SLO is claim_ready IS the
            # page's flight evidence (fired bundle re-captured on
            # clear).
            sv_bundles = sv_recorder.list_bundles()
            bundle_captured = any(
                b.get("slo") == SLO_CLAIM_READY
                and b.get("status") == "resolved"
                for b in sv_bundles)
            green_after_rejoin = (sv_green is not None and all(
                g["outcome"] == "ok" for g in sv_green))
            # Conservation: drain both observers, then compare the
            # interval ledgers claim by claim (the canary oracle's
            # comparator, fed by the serving run's claims).
            drain_deadline = time.monotonic() + 5.0
            led = sv_meter.ledger()
            while time.monotonic() < drain_deadline:
                sv_meter.observe()
                led = sv_meter.ledger()
                with sv_track_mu:
                    live_now = dict(sv_track_live)
                if not led["live"] and not live_now:
                    break
                time.sleep(0.05)
            with sv_track_mu:
                track_done = list(sv_track_done)
                track_live_final = dict(sv_track_live)
            track_map = {}
            for uid, ns, gpus in track_done:
                e = track_map.setdefault(
                    uid, {"namespace": ns, "gpus": gpus, "intervals": 0})
                e["intervals"] += 1
            meter_map = {
                uid: {"namespace": e["namespace"], "gpus": e["gpus"],
                      "intervals": e["intervals"]}
                for uid, e in led["claims"].items()}
            mismatches = [
                (uid, meter_map.get(uid), track_map.get(uid))
                for uid in sorted(set(meter_map) | set(track_map))
                if meter_map.get(uid) != track_map.get(uid)]
            by_ns = {}
            for e in led["claims"].values():
                by_ns[e["namespace"]] = (by_ns.get(e["namespace"], 0.0)
                                         + e["seconds"])
            internal_ok = all(
                abs(led["namespaces"].get(ns, 0.0) - v) < 1e-6
                for ns, v in by_ns.items())
            conservation_ok = (not mismatches and not led["live"]
                               and not track_live_final
                               and led["intervals_evicted"] == 0
                               and internal_ok)
            agg = {k: sum(getattr(r, k) for r in sv_replicas)
                   for k in ("sessions", "ok", "errors", "submitted",
                             "completed", "shed", "rejected",
                             "decode_tokens", "decode_steps")}
            accounted = (agg["completed"] + agg["shed"] + agg["rejected"]
                         == agg["submitted"])
            ttfb = [t for r in sv_replicas for t in r.ttfb_s]
            # The page's clear, from the killed node's rejoin (its
            # uncordon after the kill).
            rejoin = next((t for n, t in lifecycle.uncordons
                           if n == f"node-{kill_node_i}"
                           and t_kill[0] is not None and t >= t_kill[0]),
                          None)
            clear_after_rejoin = next(
                (round(tr.at - rejoin, 3) for tr in sv_engine.transitions()
                 if rejoin is not None and tr.slo == SLO_CLAIM_READY
                 and tr.severity == "page" and tr.transition == "cleared"
                 and tr.at >= (t_kill[0] or 0.0)), None)
            sv_result = {
                "replicas": serving_replicas,
                "session_s": serving_session_s,
                "deadline_s": serving_deadline_s,
                "sessions": agg["sessions"],
                "ok_sessions": agg["ok"],
                "error_sessions": agg["errors"],
                "fired_page": detection is not None,
                "detection_delay_s": detection,
                "cleared": cleared,
                "pre_kill_pages": pre_kill_pages,
                "fault_free_failures": fault_free_failures,
                "bundle_captured": bundle_captured,
                "bundles": len(sv_bundles),
                "green_after_rejoin": green_after_rejoin,
                "rejoin_after_kill_s": (round(rejoin - t_kill[0], 3)
                                        if rejoin is not None else None),
                "clear_after_rejoin_s": clear_after_rejoin,
                "ttfb_p50_s": _pct(ttfb, 0.50),
                "ttfb_p99_s": round(_pct(ttfb, 0.99), 4),
                "decode_tokens": agg["decode_tokens"],
                "decode_steps": agg["decode_steps"],
                "kv_isolation_max_err": max(
                    (r.kv_isolation_max_err for r in sv_replicas),
                    default=0.0),
                "device": str(sv_device),
                "warmup_launches": sv_warmup_launches,
                "per_replica": {
                    r.name: {"node": r.node, "sessions": r.sessions,
                             "ok": r.ok, "errors": r.errors,
                             "ttfb_p50_s": _pct(r.ttfb_s, 0.50),
                             "decode_tokens": r.decode_tokens,
                             "decode_steps": r.decode_steps,
                             "accounted": (r.completed + r.shed + r.rejected
                                           == r.submitted)}
                    for r in sv_replicas},
                "accounting": {
                    "submitted": agg["submitted"],
                    "completed": agg["completed"],
                    "shed": agg["shed"],
                    "rejected": agg["rejected"],
                    "ok": accounted,
                },
                "conservation_ok": conservation_ok,
                "conservation": {
                    "intervals": sum(e["intervals"]
                                     for e in meter_map.values()),
                    "claims": len(meter_map),
                    "tracker_claims": len(track_map),
                    "mismatches": mismatches[:5],
                    "meter_live": len(led["live"]),
                    "tracker_live": len(track_live_final),
                    "evicted": led["intervals_evicted"],
                    "internal_consistent": internal_ok,
                },
                "meter_observe_failures": sv_meter.observe_failures,
            }
            if not conservation_ok:
                errors.append(("serving_conservation",
                               f"GPU-seconds ledger diverged from the "
                               f"draw recorder: mismatches="
                               f"{mismatches[:3]} live={led['live'][:2]}"
                               f"/{list(track_live_final)[:2]} "
                               f"evicted={led['intervals_evicted']}"))
            if not accounted:
                errors.append(("serving_accounting", str(agg)))
    finally:
        stop_all.set()
        sampler_stop.set()
        faultpoints.deactivate()
        if gate is not None:
            gate.heal()
        if bb_telemetry is not None:
            bb_telemetry.stop()
        if bb_profiler is not None:
            bb_profiler.stop()
        if bb_debug_server is not None:
            bb_debug_server.stop()
        if cn_prober is not None:
            cn_prober.stop()
        if cn_telemetry is not None:
            cn_telemetry.stop()
        if cn_meter is not None:
            cn_meter.stop()
        if cn_tracker is not None:
            cn_tracker.stop()
        for r in sv_replicas:
            r.stop()
        if sv_telemetry is not None:
            sv_telemetry.stop()
        if sv_meter is not None:
            sv_meter.stop()
        if sv_tracker is not None:
            sv_tracker.stop()
        for srv in bb_servers:
            if srv is not None:
                srv.stop()
        if lifecycle is not None:
            lifecycle.stop()
        for hb in heartbeats:
            if hb is not None:
                hb.stop()
        realloc_box["r"].stop()
        for d in drainers:
            d.stop()
        for m in monitors:
            m.stop()
        for lp in loops:
            lp.initiate_stop()
        for lp in loops:
            lp.join(timeout=10.0)
        for d in [*gpu_drivers, *cd_drivers]:
            d.stop()
        if prev_plan is not None:
            faultpoints.activate(prev_plan)
        if tmpdir is None:
            shutil.rmtree(tmp, ignore_errors=True)

    device_recoveries = [dt for d in drainers for _dev, dt in d.recoveries]
    total_drain_events = len(list_events(client,
                                         reason=REASON_CLAIM_DRAINED))

    def pct_dist(xs: list[float]) -> dict:
        return {
            "count": len(xs),
            "p50_s": round(_pct(xs, 0.50), 3),
            "p99_s": round(_pct(xs, 0.99), 3),
            "max_s": round(max(xs), 3) if xs else 0.0,
        }

    claim_rec = pct_dist(claim_recoveries)
    slo_ok = (not claim_recoveries
              or claim_rec["p99_s"] <= recovery_slo_s)
    out = {
        "duration_s": round(elapsed, 2),
        "n_nodes": n_nodes,
        "workers": n_nodes * workers_per_node,
        "profile": profile,
        "outcomes": dict(outcomes),
        "claims_total": sum(outcomes.values()),
        "gpu_injections": len(injections),
        "unresolved_injections": len(unresolved_injections),
        "drained_claims": len({n for n in drained_names if n}),
        "drain_events": total_drain_events,
        "reallocated": len({n for n in realloc_names if n}),
        "realloc_failed": len({n for n in failed_names if n}),
        "realloc_restarts": realloc_restarts[0],
        "device_recovery": pct_dist(device_recoveries),
        "claim_recovery": claim_rec,
        "recovery_slo_s": recovery_slo_s,
        "slo_ok": slo_ok,
        "errors": errors[:10],
        "error_count": len(errors),
        "leaks": leaks,
    }
    if node_plane:
        detections: dict[str, float] = {}
        if t_kill[0] is not None:
            for n, t in lifecycle.cordons:
                if n == f"node-{kill_node_i}":
                    detections["node_kill"] = round(t - t_kill[0], 3)
                    break
        if t_part[0] is not None:
            for n, t in lifecycle.cordons:
                if n == f"node-{part_node_i}":
                    detections["partition"] = round(t - t_part[0], 3)
                    break
        out["node_failure"] = {
            "lease_duration_s": lease_duration_s,
            "detect_bound_s": round(2 * lease_duration_s, 3),
            "detections_s": detections,
            "cordons": len(lifecycle.cordons),
            "uncordons": len(lifecycle.uncordons),
            "cordoned_at_end": lifecycle.cordoned_nodes(),
            "node_kills": node_kills[0],
            "partitions": 1 if t_part[0] is not None else 0,
            "fence_recoveries": retired_fence_recoveries[0] + sum(
                hb.fence_recoveries for hb in heartbeats
                if hb is not None),
            "split_brain_violations": len(split_violations),
            "split_brain_samples": split_violations[:5],
            "lease_renewals": sum(hb.renewals for hb in heartbeats
                                  if hb is not None),
        }
    if bb_result is not None:
        out["blackbox"] = bb_result
    if cn_result is not None:
        out["canary"] = cn_result
    if sv_result is not None:
        out["serving"] = sv_result
    if faults:
        fired: dict[str, int] = {}
        for point, _hit, _action in plan.log():
            fired[point] = fired.get(point, 0) + 1
        out["faults"] = {"spec": faults, "seed": fault_seed,
                         "injected": len(plan.log()),
                         "fault_errors": len(fault_errors),
                         "fired_by_point": fired}
    return out


# -- protolab counterexample replay ------------------------------------------

def replay_protocol_counterexample(model: str, entries: list,
                                   planted: tuple = ()) -> dict:
    """Re-run a protolab counterexample through the racelab fuzzer
    harness: the schedule installs as THE active fuzzer (the same
    ``set_fuzzer`` slot seeded ScheduleFuzzer runs use), the trace
    replays against a fresh universe, and the violation must reproduce
    byte-for-byte — a found trace is immediately a regression test,
    not a one-off observation.

    ``entries`` is the schedule's sorted ``(point, hit#, action)``
    decision log (``CounterexampleSchedule.log()`` / the ``schedule``
    field of an explorer violation)."""
    from k8s_dra_driver_tpu_torch.pkg import protolab, racelab

    sched = protolab.CounterexampleSchedule(entries)
    prev = racelab.set_fuzzer(sched)
    try:
        result = protolab.replay_trace(model, sched.to_trace(),
                                       planted=planted)
    finally:
        racelab.set_fuzzer(prev)
    return {
        "model": model,
        "planted": sorted(planted),
        "trace": result["trace"],
        "violations": result["violations"],
        # Round-trip proof: the replay re-encodes to the exact entries
        # it was handed (sorted decision-log equality, the racelab
        # same-seed contract).
        "schedule_identical": result["schedule"] == sorted(
            tuple(e) for e in entries),
        "fuzzer_installed": prev is not sched,
    }


# ---------------------------------------------------------------------------
# Controller sharding: scale, failover, partition, hysteresis
# ---------------------------------------------------------------------------

def _trimmed_mean(xs: list[float], lo: float = 0.1, hi: float = 0.9) -> float:
    """Mean of the middle (lo, hi) quantile band: a median of one arm's
    few rounds can flip on a hair's-width shift; the trimmed mean moves
    smoothly and still ignores the tails."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    n = len(xs)
    cut = xs[int(lo * n):max(int(lo * n) + 1, int(hi * n))]
    return sum(cut) / len(cut)


def _settle_shard_fleet(replicas: list, advance, rounds: int = 200,
                        per_replica: "Optional[int]" = None) -> bool:
    """Round-robin ``sync_once`` (with clock advances between rounds)
    until the fleet's owned sets partition the whole keyspace with each
    replica at its fair share (``per_replica`` when given). Returns
    whether it settled within ``rounds``."""
    shards = replicas[0].shard_map.shards
    want = (per_replica if per_replica is not None
            else -(-shards // len(replicas)))
    for _ in range(rounds):
        owned = []
        for r in replicas:
            owned.append(r.sync_once())
        flat = [s for o in owned for s in o]
        if (len(flat) == shards and len(set(flat)) == shards
                and all(len(o) <= want for o in owned)):
            return True
        advance()
    return False


def run_controller_shard_scale(
    n_domains: int = 1000,
    n_replicas: int = 4,
    rounds: int = 4,
    workers: int = 2,
    reconcile_latency_s: float = 0.008,
    ready_timeout_s: float = 120.0,
) -> dict:
    """Headline bench for active-active controller sharding
    (docs/architecture.md, "Controller sharding"): the same control
    plane measured as ONE replica and as ``n_replicas`` shard-gated
    replicas, same run, interleaved arms — plus the protocol legs the
    scaling claim rests on (replica-kill failover, partitioned-replica
    handoff, rebalance hysteresis, leader-pinned usage-meter
    conservation), every admitted op recorded in one shared
    epoch-stamped :class:`~k8s_dra_driver_tpu_torch.pkg.shardmap.ShardOpLedger`
    whose audit IS the zero-double-reconcile claim.

    **Throughput arms.** ``n_domains`` ComputeDomains (numNodes=1, one
    fake node each) are converged in per-round batches, alternating
    1-replica and N-replica arms with the order flipped each round so
    machine drift lands on both symmetrically; per-round throughputs
    pool into per-arm trimmed means. ``reconcile_latency_s`` holds each
    ADMITTED reconcile open via the ``cd.controller.reconcile`` fault
    point (the API-round-trip stand-in); gated skips stay cheap, which is exactly the claim under test:
    replicas scale because they drop each other's work at the gate, not
    re-do it. Shard ownership for these arms is pre-settled through the
    REAL lease protocol (membership census + acquisition), with long
    leases so the arms measure reconcile scaling, not lease churn.

    **Failover leg** (fake clock): two replicas at fair share, one
    killed dead (stops syncing AND its leader-pinned singletons stop,
    leases left to expire — a page-out, not a graceful leave). The
    survivor must own every orphaned shard within ONE lease duration of
    the victim's last renewal, and the leader-shard singletons must
    fail over: the usage meter's next incarnation rebuilds from the
    durable ``usage-since`` stamps and closes the victim-opened
    interval EXACTLY (bit-equal GPU-seconds, endpoint arithmetic).

    **Partition leg** (fake clock): one replica partitioned mid-flight;
    its gate keeps admitting only while lease confidence lasts (renew
    deadline), the survivor claims within one lease duration, and the
    shared ledger must show zero double-reconcile and zero epoch
    regressions across the handoff.

    **Hysteresis leg** (fake clock): a fresh replica joins a loaded
    one; voluntary handoffs are counted per rebalance window and must
    never exceed ``rebalance_max_handoffs`` — the excess shows up as
    counted deferrals, never a storm, and the fleet still converges to
    fair share.
    """
    from k8s_dra_driver_tpu_torch.api.computedomain import (
        STATUS_READY,
        new_clique,
        new_compute_domain,
    )
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import (
        PartitionGate,
        PartitionedClient,
    )
    from k8s_dra_driver_tpu_torch.pkg import faultpoints
    from k8s_dra_driver_tpu_torch.pkg.shardmap import ShardOpLedger, shard_for
    from k8s_dra_driver_tpu_torch.pkg.usage import ANN_USAGE_SINCE, UsageMeter
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.controller import (
        ComputeDomainController,
    )
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller.sharding import (
        LEADER_SHARD,
        ShardedController,
        SingletonHandle,
    )

    shards = n_replicas
    per_round = max(1, n_domains // rounds)

    # -- throughput arms -----------------------------------------------------

    plan = faultpoints.FaultPlan("", seed=0)
    if reconcile_latency_s > 0:
        plan.add("cd.controller.reconcile", f"latency:{reconcile_latency_s}")

    def _mk_arm(arm_replicas: int) -> dict:
        client = FakeClient()
        ledger = ShardOpLedger()
        sharded, controllers = [], []
        for i in range(arm_replicas):
            s = ShardedController(
                client, f"replica-{arm_replicas}r-{i}", shards,
                lease_prefix=f"bench-{arm_replicas}r",
                # Static ownership: the arms measure reconcile scaling.
                lease_duration=3600.0, renew_deadline=2400.0,
                ledger=ledger)
            c = ComputeDomainController(client, workers=workers,
                                        shard_gate=s.gate)
            # The orphan sweep is kicked per reconcile and LISTs the
            # whole store; its cost belongs to the apiserver, not this
            # in-process GIL — unthrottled it grows with every batch and
            # buries the signal the arms exist to measure.
            c.cleanup.interval = 3600.0
            c.cleanup.min_gap = 3600.0
            sharded.append(s)
            controllers.append(c)
        # Register every replica's membership before anyone acquires, so
        # the census is complete and the fair share is right from round
        # one (a real fleet converges there through rebalancing; the
        # bench wants the steady state, not the join transient).
        for s in sharded:
            s.shard_map._renew_membership()
        settled = _settle_shard_fleet(sharded, advance=lambda: None,
                                      rounds=50)
        for c in controllers:
            c.start()
        return {"client": client, "ledger": ledger, "sharded": sharded,
                "controllers": controllers, "settled": settled,
                "throughputs": [], "created": []}

    arms = {1: _mk_arm(1), n_replicas: _mk_arm(n_replicas)}
    stuck: list[str] = []
    prev_plan = faultpoints.active_plan()
    faultpoints.activate(plan)
    try:
        def _drive_batch(arm: dict, tag: str) -> None:
            client = arm["client"]
            # One namespace per batch: list-scoped work stays O(batch)
            # instead of growing with every prior round's leftovers, so
            # each round measures the same workload.
            ns = f"bench-{tag}"
            names = []
            t0 = time.monotonic()
            for i in range(per_round):
                cd = client.create(new_compute_domain(
                    f"cd-{tag}-{i}", ns, num_nodes=1))
                names.append(cd["metadata"]["name"])
                clique = new_clique(cd["metadata"]["uid"], "slice0", ns,
                                    owner_cd_name=cd["metadata"]["name"])
                clique["daemons"] = [{"nodeName": f"node-{tag}-{i}",
                                      "index": 0, "status": STATUS_READY}]
                client.create(clique)
            deadline = t0 + ready_timeout_s

            pending = set(names)
            while time.monotonic() < deadline:
                for n in list(pending):
                    cd = client.get("ComputeDomain", n, ns)
                    if (cd.get("status") or {}).get("status") == STATUS_READY:
                        pending.discard(n)
                if not pending:
                    break
                # Coarse poll: the convergence signal must not compete
                # with the workers for the interpreter.
                time.sleep(0.05)
            else:
                stuck.append(tag)
            arm["throughputs"].append(per_round / (time.monotonic() - t0))
            arm["created"].extend((ns, n) for n in names)
            # Drain barrier, OUTSIDE the measured window: the final
            # status updates re-enqueue their CDs, and each of those
            # trailing reconciles holds a worker for the fault latency.
            # Without the drain the next batch of this arm starts
            # against busy workers and measures leftover work, not the
            # workload (the 1-vs-N comparison then skews by arm order).
            drain_deadline = time.monotonic() + ready_timeout_s
            while time.monotonic() < drain_deadline:
                if all(len(c.queue) == 0 for c in arm["controllers"]):
                    break
                time.sleep(0.02)
            time.sleep(2 * reconcile_latency_s + 0.02)  # last in-flight op

        for rnd in range(rounds):
            order = ([1, n_replicas] if rnd % 2 == 0
                     else [n_replicas, 1])  # flip: drift lands on both
            for arm_n in order:
                _drive_batch(arms[arm_n], f"{arm_n}r-{rnd}")
    finally:
        faultpoints.deactivate()
        for arm in arms.values():
            for c in arm["controllers"]:
                c.stop()
        if prev_plan is not None:
            faultpoints.activate(prev_plan)

    tput = {n: _trimmed_mean(arm["throughputs"])
            for n, arm in arms.items()}
    scaling_x = (tput[n_replicas] / tput[1]) if tput[1] else 0.0

    errors = 0
    leaks: dict[str, Any] = {}
    for n, arm in arms.items():
        for c in arm["controllers"]:
            errors += int(c.metrics.reconciles_total.value(outcome="error"))
        ds = sorted((d["metadata"]["namespace"], d["metadata"]["name"])
                    for d in arm["client"].list("DaemonSet"))
        want = sorted((ns, f"{name}-daemon")
                      for ns, name in arm["created"])
        if ds != want:
            leaks[f"arm{n}_daemonsets"] = {"got": len(ds),
                                           "want": len(want)}
    # Per-shard single-writer proof for the N-replica arm: every
    # admitted op in the shared ledger, audited.
    tput_violations = arms[n_replicas]["ledger"].violations()

    # -- failover + singleton-conservation leg (fake clock) ------------------

    now = [10_000.0]
    lease_d, renew_d = 10.0, 6.0
    f_client = FakeClient()
    f_ledger = ShardOpLedger()
    meters: list[UsageMeter] = []
    singleton_log: list[tuple[str, str, str]] = []

    def _meter_factory(ident: str):
        def make():
            m = UsageMeter(f_client, clock=lambda: now[0])
            meters.append(m)
            singleton_log.append((ident, "usage-meter", "start"))
            return SingletonHandle(
                m, lambda: singleton_log.append(
                    (ident, "usage-meter", "stop")))
        return make

    def _mk_failover_replica(ident: str) -> ShardedController:
        return ShardedController(
            f_client, ident, shards, lease_prefix="fo-shard",
            lease_duration=lease_d, renew_deadline=renew_d,
            clock=lambda: now[0], ledger=f_ledger,
            singleton_factories={"usage-meter": _meter_factory(ident)},
            rebalance_max_handoffs=1, rebalance_window=1.0)

    fo = [_mk_failover_replica("fo-a"), _mk_failover_replica("fo-b")]
    for s in fo:
        s.shard_map._renew_membership()
    fo_settled = _settle_shard_fleet(
        fo, advance=lambda: now.__setitem__(0, now[0] + 1.0))

    # One allocated claim, observed by the CURRENT leader's meter (the
    # victim's incarnation) — its durable usage-since stamp is what the
    # successor's incarnation must rebuild from.
    claim = {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": {"name": "tenant-claim", "namespace": "tenant-a",
                     "uid": "claim-uid-1"},
        "status": {"allocation": {"devices": {"results": [
            {"pool": "node-0", "device": "gpu-0"},
            {"pool": "node-0", "device": "gpu-1"},
        ]}}},
    }
    f_client.create(claim)
    t_open = now[0]

    def _leader() -> "Optional[ShardedController]":
        owners = [s for s in fo
                  if s.shard_map.confident(LEADER_SHARD)]
        return owners[0] if len(owners) == 1 else None

    def _tick_meter() -> None:
        lead = _leader()
        if lead is not None:
            handle = lead.singleton("usage-meter")
            if handle is not None:
                handle.obj.observe(now[0])

    _tick_meter()  # opens the interval + stamps usage-since durably
    stamped = (f_client.get("ResourceClaim", "tenant-claim", "tenant-a")
               ["metadata"].get("annotations") or {}).get(ANN_USAGE_SINCE)

    victim = _leader()
    survivor = fo[1] if victim is fo[0] else fo[0]
    # The kill strictly AFTER the last renewal: the one-lease failover
    # clock starts at the victim's final renew, which is in the past.
    now[0] += 0.5
    t_kill = now[0]
    victim._stop_singletons()  # the dead process takes its singletons
    singleton_log.append((victim.identity, "killed", "dead"))

    failover_s = None
    fo_deadline = t_kill + 3.0 * lease_d
    while now[0] < fo_deadline:
        survivor.sync_once()
        _tick_meter()
        if len(survivor.shard_map.owned()) == shards:
            failover_s = now[0] - t_kill
            break
        now[0] += 0.25

    # Conservation across the forced failover: deallocate, let the
    # SUCCESSOR incarnation close the interval it never saw open.
    now[0] += 2.0
    live = f_client.get("ResourceClaim", "tenant-claim", "tenant-a")
    live["status"] = {}
    f_client.update(live)
    t_close = now[0]
    survivor.sync_once()
    _tick_meter()
    successor_handle = survivor.singleton("usage-meter")
    successor_meter = (successor_handle.obj
                       if successor_handle is not None else None)
    expected_cs = 2 * max(0.0, t_close - t_open)  # 2 GPUs, exact endpoints
    observed_cs = (successor_meter.completed().get("tenant-a", 0.0)
                   if successor_meter is not None else -1.0)
    conservation_exact = (
        stamped is not None
        and successor_meter is not None
        and len(meters) >= 2                 # a genuinely fresh incarnation
        and successor_meter is not meters[0]
        and observed_cs == expected_cs)      # bit-equal, not approx

    # No overlapping incarnations: starts and stops alternate per the
    # log — a second start before the victim died would be a double
    # singleton.
    starts_before_kill = [e for e in singleton_log
                          if e[2] == "start"
                          and singleton_log.index(e) < singleton_log.index(
                              (victim.identity, "killed", "dead"))]
    singleton_overlap = len(starts_before_kill) > 1

    # -- partition leg (fake clock, shared op ledger) ------------------------

    p_now = [50_000.0]
    p_gate = PartitionGate()
    p_base = FakeClient()
    p_ledger = ShardOpLedger()

    def _mk_part_replica(ident: str) -> ShardedController:
        return ShardedController(
            PartitionedClient(p_base, ident, p_gate), ident, shards,
            lease_prefix="part-shard", lease_duration=lease_d,
            renew_deadline=renew_d, clock=lambda: p_now[0],
            ledger=p_ledger, rebalance_window=1.0)

    pa, pb = _mk_part_replica("part-a"), _mk_part_replica("part-b")
    for s in (pa, pb):
        s.shard_map._renew_membership()
    part_settled = _settle_shard_fleet(
        [pa, pb], advance=lambda: p_now.__setitem__(0, p_now[0] + 1.0))

    # Keys routed one per shard, so both replicas' gates face every
    # shard's traffic each step.
    keys = []
    i = 0
    while len(keys) < shards and i < 10_000:
        uid = f"uid-{i}"
        s = shard_for("tenant", uid, shards)
        if s not in [k[1] for k in keys]:
            keys.append((uid, s))
        i += 1

    p_now[0] += 0.5
    p_gate.partition(pa.identity)
    t_part = p_now[0]
    served_after_deadline = 0
    pa_last_admit = None
    takeover_s = None
    part_deadline = t_part + 3.0 * lease_d
    while p_now[0] < part_deadline:
        pa.sync_once()   # fails to renew through the partition
        pb.sync_once()
        for uid, _s in keys:
            if pa.gate.admit("tenant", uid, "reconcile"):
                pa_last_admit = p_now[0]
                if p_now[0] - t_part > renew_d:
                    served_after_deadline += 1
            pb.gate.admit("tenant", uid, "reconcile")
        if takeover_s is None and len(pb.shard_map.owned()) == shards:
            takeover_s = p_now[0] - t_part
        if takeover_s is not None and p_now[0] - t_part > lease_d + 2.0:
            break
        p_now[0] += 0.25
    p_gate.heal()
    part_violations = p_ledger.violations()

    # -- hysteresis leg (fake clock) -----------------------------------------

    h_now = [90_000.0]
    h_client = FakeClient()
    h_shards, h_window, h_cap = 2 * shards, 4.0, 1

    def _mk_h_replica(ident: str) -> ShardedController:
        return ShardedController(
            h_client, ident, h_shards, lease_prefix="hys-shard",
            lease_duration=lease_d, renew_deadline=renew_d,
            clock=lambda: h_now[0], rebalance_max_handoffs=h_cap,
            rebalance_window=h_window)

    h1 = _mk_h_replica("hys-a")
    h1.shard_map._renew_membership()
    h1.sync_once()  # sole member: absorbs the whole keyspace
    h2 = _mk_h_replica("hys-b")
    h2.shard_map._renew_membership()

    window_handoffs: dict[int, int] = {}
    deferred_events = 0
    h_deadline = h_now[0] + 40.0 * h_window
    h_converged = False
    while h_now[0] < h_deadline:
        for r in (h1, h2):
            r.sync_once()
            for reason, _shard in r.shard_map.last_events:
                if reason == "rebalance":
                    bucket = int(h_now[0] // h_window)
                    window_handoffs[bucket] = (
                        window_handoffs.get(bucket, 0) + 1)
                elif reason == "defer":
                    deferred_events += 1
        if (len(h1.shard_map.owned()) == h_shards // 2
                and len(h2.shard_map.owned()) == h_shards // 2):
            h_converged = True
            break
        h_now[0] += 0.5
    max_window_handoffs = max(window_handoffs.values(), default=0)

    return {
        "n_domains": per_round * rounds,
        "n_replicas": n_replicas,
        "shards": shards,
        "rounds": rounds,
        "workers_per_replica": workers,
        "reconcile_latency_ms": reconcile_latency_s * 1e3,
        "throughput": {
            "arms_settled": all(a["settled"] for a in arms.values()),
            "one_replica_cds_per_s": round(tput[1], 2),
            "n_replica_cds_per_s": round(tput[n_replicas], 2),
            "per_round": {str(n): [round(x, 2) for x in a["throughputs"]]
                          for n, a in arms.items()},
            "scaling_x": round(scaling_x, 3),
            "ledger_violations": tput_violations,
        },
        "failover": {
            "settled": fo_settled,
            "lease_duration_s": lease_d,
            "failover_s": failover_s,
            "within_one_lease": (failover_s is not None
                                 and failover_s <= lease_d),
            "meter_incarnations": len(meters),
            "usage_stamp_durable": stamped is not None,
            "expected_gpu_seconds": expected_cs,
            "observed_gpu_seconds": observed_cs,
            "conservation_exact": conservation_exact,
            "singleton_overlap": singleton_overlap,
        },
        "partition": {
            "settled": part_settled,
            "renew_deadline_s": renew_d,
            "served_after_deadline": served_after_deadline,
            "victim_last_admit_after_partition_s": (
                None if pa_last_admit is None
                else round(pa_last_admit - t_part, 3)),
            "takeover_s": takeover_s,
            "within_one_lease": (takeover_s is not None
                                 and takeover_s <= lease_d),
            "ledger_violations": part_violations,
        },
        "hysteresis": {
            "shards": h_shards,
            "cap_per_window": h_cap,
            "max_window_handoffs": max_window_handoffs,
            "within_bound": max_window_handoffs <= h_cap,
            "deferred_events": deferred_events,
            "converged": h_converged,
        },
        "errors": errors,
        "leaks": leaks,
        "stuck": stuck,
    }


def run_shard_smoke() -> dict:
    """Seconds-scale sharding smoke: the full
    :func:`run_controller_shard_scale` protocol surface at a fraction of
    the fleet — every leg runs (interleaved arms, replica kill, partition
    handoff, hysteresis, conservation), only the throughput statistics
    are too small to gate on."""
    res = run_controller_shard_scale(
        n_domains=96, n_replicas=4, rounds=2, workers=2,
        reconcile_latency_s=0.004, ready_timeout_s=60.0)
    ok = (res["throughput"]["arms_settled"]
          and res["throughput"]["ledger_violations"] == []
          and res["failover"]["within_one_lease"]
          and res["failover"]["conservation_exact"]
          and not res["failover"]["singleton_overlap"]
          and res["partition"]["within_one_lease"]
          and res["partition"]["served_after_deadline"] == 0
          and res["partition"]["ledger_violations"] == []
          and res["hysteresis"]["within_bound"]
          and res["hysteresis"]["deferred_events"] > 0
          and res["hysteresis"]["converged"]
          and res["errors"] == 0
          and not res["leaks"]
          and not res["stuck"])
    return {"ok": ok, "result": res}


# -- Fault injection, churn and fleets ---------------------------------------


def _reject_crash_schedules(plan, harness: str, what: str) -> None:
    """A FaultCrash would kill a harness thread with nothing playing the
    restarted process; crash schedules belong to the kill-restart tests."""
    crashers = [n for n, s in plan.schedules.items()
                if s.mode.startswith("crash")]
    if crashers:
        raise ValueError(
            f"{harness} cannot host crash schedules {crashers}; a "
            f"FaultCrash would kill {what} with nothing playing the "
            "restarted process — use the kill-restart tests")


def _fired_by_point(plan) -> dict[str, int]:
    fired: dict[str, int] = {}
    for point, _hit, _action in plan.log():
        fired[point] = fired.get(point, 0) + 1
    return fired


def run_cd_fleet(
    n_domains: int = 32,
    workers: int = 4,
    reconcile_latency_s: float = 0.005,
    ready_timeout_s: float = 120.0,
    settle_timeout_s: float = 10.0,
    storm_window_s: float = 0.75,
    faults: Optional[str] = None,
    fault_seed: int = 0,
) -> dict:
    """Control-plane convergence: converge an ``n_domains`` ComputeDomain
    fleet through the live controller loop (informers + workqueue worker
    pool) and measure time-to-all-Ready.

    Each CD (numNodes=1) gets a Ready clique at once, so convergence is
    pure control-plane work. ``reconcile_latency_s`` holds every reconcile
    open through the ``cd.controller.reconcile`` latency fault point — the
    stand-in for a real reconcile's API round-trips, without which an
    in-memory reconcile is GIL-bound and shows no worker scaling.

    After convergence the harness waits for the queue to go quiet and
    counts reconciles over ``storm_window_s``: a converged fleet must make
    none (anything else is a self-sustaining event storm).

    ``faults``: an extra fault schedule (``GPU_DRA_FAULTS`` syntax), e.g.
    ``cd.controller.patch=rate:0.2``; crash schedules are rejected. The
    audit then checks convergence despite injection: every CD Ready,
    exactly one set of children per CD, nothing orphaned."""
    from k8s_dra_driver_tpu_torch.api.computedomain import (
        STATUS_READY,
        new_clique,
        new_compute_domain,
    )
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.pkg import faultpoints
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller \
        .controller import ComputeDomainController

    plan = faultpoints.FaultPlan(faults or "", seed=fault_seed)
    _reject_crash_schedules(plan, "run_cd_fleet", "a workqueue worker thread")
    if reconcile_latency_s > 0:
        plan.add("cd.controller.reconcile", f"latency:{reconcile_latency_s}")

    client = FakeClient()
    controller = ComputeDomainController(client, workers=workers)
    controller.cleanup.interval = 3600.0  # the periodic sweep is noise here

    def reconcile_totals() -> dict[str, float]:
        return {outcome: controller.metrics.reconciles_total.value(
                    outcome=outcome)
                for outcome in ("success", "error", "teardown")}

    prev_plan = faultpoints.active_plan()
    faultpoints.activate(plan)
    try:
        controller.start()
        t0 = time.monotonic()
        names = []
        for i in range(n_domains):
            cd = client.create(new_compute_domain(
                f"fleet-{i}", "default", num_nodes=1))
            names.append(cd["metadata"]["name"])
            clique = new_clique(cd["metadata"]["uid"], "slice0", "default",
                                owner_cd_name=cd["metadata"]["name"])
            clique["daemons"] = [{"nodeName": f"node-{i}", "index": 0,
                                  "status": STATUS_READY}]
            client.create(clique)

        deadline = t0 + ready_timeout_s
        converged = False

        def cd_statuses() -> list:
            return [(client.get("ComputeDomain", n, "default").get("status")
                     or {}).get("status") for n in names]

        while time.monotonic() < deadline:
            if all(s == STATUS_READY for s in cd_statuses()):
                converged = True
                break
            time.sleep(0.01)
        t_ready = time.monotonic() - t0

        # Settle: wait for the queue to drain and the counters to stop
        # moving, then measure the storm window.
        settle_deadline = time.monotonic() + settle_timeout_s
        last = reconcile_totals()
        quiet_since = time.monotonic()
        while time.monotonic() < settle_deadline:
            time.sleep(0.05)
            cur = reconcile_totals()
            if cur != last or len(controller.queue):
                last = cur
                quiet_since = time.monotonic()
            elif time.monotonic() - quiet_since >= 0.25:
                break
        before = reconcile_totals()
        time.sleep(storm_window_s)
        after = reconcile_totals()
        storm_events = int(sum(after.values()) - sum(before.values()))

        # Audit: exactly one child set per CD, nothing extra (a retried
        # reconcile that minted a second DaemonSet/RCT is a dup bug).
        leaks: dict[str, Any] = {}
        ds_names = sorted(d["metadata"]["name"]
                          for d in client.list("DaemonSet", "default"))
        want_ds = sorted(f"{n}-daemon" for n in names)
        if ds_names != want_ds:
            leaks["daemonsets"] = {"got": ds_names, "want": want_ds}
        rct_names = sorted(r["metadata"]["name"] for r in client.list(
            "ResourceClaimTemplate", "default"))
        want_rct = sorted([f"{n}-daemon" for n in names]
                          + [f"{n}-channel" for n in names])
        if rct_names != want_rct:
            leaks["rcts"] = {"got": rct_names, "want": want_rct}
        if not converged:
            leaks["not_ready"] = [
                n for n, s in zip(names, cd_statuses()) if s != STATUS_READY]
    finally:
        faultpoints.deactivate()
        controller.stop()
        if prev_plan is not None:
            faultpoints.activate(prev_plan)

    totals = reconcile_totals()
    reconciles = sum(totals.values())
    out = {
        "n_domains": n_domains,
        "workers": workers,
        "reconcile_latency_ms": reconcile_latency_s * 1e3,
        "converged": converged,
        "time_to_ready_s": round(t_ready, 4),
        "reconciles": {k: int(v) for k, v in totals.items()},
        "reconciles_per_sec": (round(reconciles / t_ready, 2)
                               if t_ready else 0.0),
        "errors": int(totals["error"]),
        "storm_events": storm_events,
        "leaks": leaks,
    }
    if faults:
        out["faults"] = {"spec": faults, "seed": fault_seed,
                         "fired_by_point": _fired_by_point(plan)}
    return out


class _InstantDriver:
    """Stub DRA plugin for the node fleet: prepares instantly and
    perfectly. The fleet measures the API machinery — watch fan-out,
    informer delivery, LIST latency, status-write throughput — so the
    disk/CDI prepare path (what :func:`run_claim_churn` measures) is
    stubbed out; every claim transition still flows through the real
    NodePrepareLoop + Informer + FakeClient stack."""

    def __init__(self, driver_name: str):
        self.driver_name = driver_name
        self.prepares = 0
        self.unprepares = 0
        self._mu = sanitizer.new_lock("stresslab._InstantDriver._mu")

    def prepare_resource_claims(self, claims: list) -> dict:
        from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
            PreparedDeviceRef,
            PrepareResult,
            claim_allocation_results,
        )
        out = {}
        for c in claims:
            refs = [PreparedDeviceRef(
                        requests=[r.get("request") or "gpu"],
                        pool=r.get("pool", ""), device=r.get("device", ""),
                        cdi_device_ids=[
                            f"{self.driver_name}/dev={r.get('device', '')}"])
                    for r in claim_allocation_results(c)
                    if r.get("driver") == self.driver_name]
            out[c["metadata"]["uid"]] = PrepareResult(devices=refs)
        with self._mu:
            self.prepares += len(claims)
        return out

    def unprepare_resource_claims(self, refs: list) -> dict:
        with self._mu:
            self.unprepares += len(refs)
        return {r.uid: None for r in refs}


def run_node_fleet(
    n_nodes: int = 200,
    ready_timeout_s: float = 240.0,
    list_limit: int = 50,
    list_probe_interval_s: float = 0.05,
    stall_queue: int = 64,
    bookmark_interval_s: float = 1.0,
    faults: Optional[str] = None,
    fault_seed: int = 0,
    sharded: bool = True,
    trace: bool = False,
    trace_capacity: int = 60_000,
) -> dict:
    """Fleet-scale API machinery: ``n_nodes`` simulated nodes, each running
    both kubelet plugins' informer stacks (a NodePrepareLoop for the GPU
    driver and one for the ComputeDomain driver — 2×n informers on
    ResourceClaim) against ONE shared FakeClient.

    The wave: one allocated+reserved ResourceClaim per node (alternating
    the two drivers), created through the API — every create fans out to
    every informer, the owning node prepares through its loop, and the
    status publish fans out again. Convergence = every claim carries its
    driver's Ready device status.

    Measured: time to converge, watch events/s delivered to watcher
    queues, paginated-LIST latency percentiles under the fan-out (a prober
    crawls ``list_limit``-sized pages throughout), and the stalled-watcher
    bound — a never-consumed watch must be disconnected with at most
    ``stall_queue`` events held.

    ``faults``: a chaos schedule (e.g. watch drops and forced 410s); crash
    schedules are rejected. The fleet must still converge — informer
    resumes replay missed events from the backlog, forced-expired resumes
    fall back to relist. ``sharded=False`` runs the single-lock store.
    ``trace``: a root span per wave claim, ended when the harness sees it
    Ready; the loops' ``node_prepare`` spans stitch in."""
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import (
        NodePrepareLoop,
    )
    from k8s_dra_driver_tpu_torch.pkg import faultpoints, tracing
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin \
        .devices import CD_DRIVER_NAME

    plan = faultpoints.FaultPlan(faults or "", seed=fault_seed)
    _reject_crash_schedules(plan, "run_node_fleet", "an informer thread")

    client = FakeClient(sharded=sharded)
    loops: list = []
    drivers: list[_InstantDriver] = []

    errors: list = []
    prev_plan = faultpoints.active_plan()
    faultpoints.activate(plan)
    try:
        for i in range(n_nodes):
            client.create(new_object("Node", f"fleet-node-{i}"))
        for i in range(n_nodes):
            for drv in (DRIVER_NAME, CD_DRIVER_NAME):
                stub = _InstantDriver(drv)
                drivers.append(stub)
                loops.append(NodePrepareLoop(
                    client, stub, driver_name=drv,
                    pool_name=f"fleet-node-{i}",
                    namespace="default").start())

        # The stalled consumer: subscribed like any watcher, never read.
        stalled = client.watch("ResourceClaim", namespace="default",
                               max_queue=stall_queue,
                               bookmark_interval=bookmark_interval_s)

        # LIST prober: paginated crawls for the whole convergence window.
        list_lat: list[float] = []
        probe_stop = threading.Event()

        def probe() -> None:
            while not probe_stop.is_set():
                token = ""
                try:
                    while True:
                        t0 = time.perf_counter()
                        page = client.list_page(
                            "ResourceClaim", "default", limit=list_limit,
                            continue_token=token)
                        list_lat.append(time.perf_counter() - t0)
                        token = page["metadata"].get("continue", "")
                        if not token:
                            break
                except Exception as e:  # noqa: BLE001 — audited
                    if not faultpoints.is_injected(e):
                        errors.append(("list-probe", repr(e)))
                probe_stop.wait(list_probe_interval_s)

        prober = threading.Thread(target=probe, name="fleet-list-probe",
                                  daemon=True)
        prober.start()

        if trace:
            tracing.enable(capacity=trace_capacity)
        roots: dict[str, Any] = {}
        delivered_before = client.watch_events_delivered()
        expected_driver: dict[str, str] = {}
        t0 = time.monotonic()
        for i in range(n_nodes):
            drv = DRIVER_NAME if i % 2 == 0 else CD_DRIVER_NAME
            name = f"fleet-claim-{i}"
            expected_driver[name] = drv
            obj = new_object(
                "ResourceClaim", name, "default",
                api_version="resource.k8s.io/v1",
                spec={"devices": {"requests": [{"name": "gpu"}]}},
                status={
                    "allocation": {"devices": {"results": [{
                        "request": "gpu", "driver": drv,
                        "pool": f"fleet-node-{i}", "device": "gpu-0"}]}},
                    "reservedFor": [{"resource": "pods",
                                     "name": f"fleet-pod-{i}"}],
                })
            if trace:
                # new_root (many roots minted from this one thread must
                # not nest), not activated (ended from the poll loop).
                root = tracing.start_span(
                    "claim", new_root=True, activate=False,
                    attributes={"claim": name, "driver": drv})
                tracing.inject(root, obj)
                roots[name] = root
            client.create(obj)

        def ready_count() -> int:
            n = 0
            for c in client.list("ResourceClaim", "default"):
                name = c["metadata"]["name"]
                drv = expected_driver.get(name)
                if drv is None:
                    continue
                for d in (c.get("status") or {}).get("devices") or []:
                    if d.get("driver") == drv and any(
                            cond.get("type") == "Ready"
                            and cond.get("status") == "True"
                            for cond in d.get("conditions") or []):
                        n += 1
                        root = roots.get(name)
                        if root is not None:
                            root.set_status("ok")
                            root.end()
                            roots.pop(name, None)
                        break
            return n

        deadline = t0 + ready_timeout_s
        ready = 0
        while time.monotonic() < deadline:
            ready = ready_count()
            if ready >= n_nodes:
                break
            time.sleep(0.05)
        t_converge = time.monotonic() - t0
        converged = ready >= n_nodes
        delivered = client.watch_events_delivered() - delivered_before

        probe_stop.set()
        prober.join(timeout=10)

        if not converged:
            errors.append(("not_converged",
                           f"{ready}/{n_nodes} claims ready"))
        for name, root in sorted(roots.items()):
            root.set_status("error", "never observed Ready")
            root.end()
        roots.clear()

        # The stalled watcher: disconnected, its held events capped at the
        # queue bound. Enforced only when the wave (~2 events a claim)
        # exceeds the bound — tiny fleets just report.
        stalled_queued = stalled.events.qsize()
        stalled_report = {
            "max_queue": stall_queue,
            "disconnected": not stalled.alive,
            "overflowed": stalled.overflowed,
            "queued_at_end": stalled_queued,
            "bounded": stalled.overflowed and stalled_queued <= stall_queue,
        }
        if 2 * n_nodes > stall_queue and not stalled_report["bounded"]:
            errors.append(("stalled_watcher", str(stalled_report)))
        stalled.stop()

        if faults:
            # Heal before reporting: stop injecting, then wait for every
            # informer stream to be re-established, so the resume/relist/
            # reconnect counts are settled.
            faultpoints.deactivate()
            heal_deadline = time.monotonic() + 30.0
            while time.monotonic() < heal_deadline:
                if all(lp._informer is not None
                       and lp._informer._watch is not None
                       and lp._informer._watch.alive for lp in loops):
                    break
                time.sleep(0.05)
    finally:
        if trace:
            tracing.disable()
        faultpoints.deactivate()
        # Teardown in two phases: signal everything, then join.
        for lp in loops:
            lp.initiate_stop()
        for lp in loops:
            lp.join(timeout=10.0)
        if prev_plan is not None:
            faultpoints.activate(prev_plan)

    # Summarize only after the loops are joined: a node_prepare span still
    # open would make its stored children read as orphans.
    tracing_report = (tracing.summarize_store(
        tracing.default_tracer().store) if trace else None)

    informers = [lp._informer for lp in loops if lp._informer is not None]
    out = {
        "n_nodes": n_nodes,
        "informers": len(loops),
        "sharded": sharded,
        "converged": converged,
        "time_to_converge_s": round(t_converge, 3),
        "watch_events_delivered": delivered,
        "watch_events_per_sec": (round(delivered / t_converge, 1)
                                 if t_converge else 0.0),
        "list_pages": len(list_lat),
        "list_p50_ms": round(_pct(list_lat, 0.50) * 1e3, 3),
        "list_p99_ms": round(_pct(list_lat, 0.99) * 1e3, 3),
        "stalled_watcher": stalled_report,
        "watch_resumes": sum(i.resume_count for i in informers),
        "watch_relists": sum(i.relist_count for i in informers),
        "watch_reconnects": sum(i.reconnect_count for i in informers),
        "prepares": sum(d.prepares for d in drivers),
        "errors": errors[:10],
        "error_count": len(errors),
    }
    if trace:
        out["tracing"] = tracing_report
    if faults:
        out["faults"] = {"spec": faults, "seed": fault_seed,
                         "fired_by_point": _fired_by_point(plan)}
    return out


def run_cross_kind_writes(
    n_kinds: int = 4,
    writes_per_kind: int = 150,
    commit_hold_s: float = 0.00025,
    rounds: int = 2,
) -> dict:
    """Same-run shard-vs-single-lock comparison: ``n_kinds`` writer
    threads, each creating ``writes_per_kind`` objects of its own kind,
    against (a) the sharded store and (b) ``FakeClient(sharded=False)``,
    where every kind shares one lock.

    Every commit is held open ``commit_hold_s`` through the
    ``k8sclient.fake.commit`` latency fault point, fired inside the shard
    lock — the stand-in for a real apiserver's per-write work (a bare dict
    insert would measure Python's scheduler, not lock contention). Under
    one lock the holds serialize across kinds; per-kind shards overlap
    them. ``rounds`` alternating measurements per mode; the minimum wins."""
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.pkg import faultpoints

    plan = faultpoints.FaultPlan(
        f"k8sclient.fake.commit=latency:{commit_hold_s}", seed=0)

    def one(sharded: bool) -> float:
        client = FakeClient(sharded=sharded)
        start = threading.Barrier(n_kinds + 1)

        def writer(k: int) -> None:
            start.wait()
            for j in range(writes_per_kind):
                client.create(new_object(f"BenchKind{k}", f"obj-{j}",
                                         "default"))

        threads = [threading.Thread(target=writer, args=(k,), daemon=True)
                   for k in range(n_kinds)]
        for t in threads:
            t.start()
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    best = {True: float("inf"), False: float("inf")}
    prev_plan = faultpoints.active_plan()
    faultpoints.activate(plan)
    try:
        for _ in range(rounds):
            for sharded in (False, True):
                best[sharded] = min(best[sharded], one(sharded))
    finally:
        faultpoints.deactivate()
        if prev_plan is not None:
            faultpoints.activate(prev_plan)

    total_writes = n_kinds * writes_per_kind
    return {
        "n_kinds": n_kinds,
        "writes_per_kind": writes_per_kind,
        "commit_hold_ms": commit_hold_s * 1e3,
        "single_lock_s": round(best[False], 4),
        "sharded_s": round(best[True], 4),
        "speedup": round(best[False] / best[True], 2) if best[True] else 0.0,
        "sharded_writes_per_sec": (round(total_writes / best[True], 1)
                                   if best[True] else 0.0),
    }


def run_claim_churn(
    duration_s: float = 10.0,
    n_nodes: int = 4,
    workers_per_node: int = 2,
    profile: str = "h100-8",
    tmpdir: Optional[str] = None,
    channel_every: int = 4,
    faults: Optional[str] = None,
    fault_seed: int = 0,
    trace: bool = False,
    trace_capacity: int = 120_000,
    trace_every: int = 1,
) -> dict:
    """Churn prepare/unprepare across ``n_nodes`` node stacks (the GPU and
    the ComputeDomain kubelet plugin on each mock ``profile`` node) for
    ``duration_s`` seconds. Every worker cycles: create a claim for one
    whole GPU → allocate node-pinned → prepare → unprepare → delete,
    mixing in a ComputeDomain channel claim every ``channel_every``
    cycles. Returns latency percentiles per driver and a leak audit.

    ``faults``: a ``pkg.faultpoints`` schedule (the ``GPU_DRA_FAULTS``
    syntax) active for the churn window only. Crash schedules are
    rejected. The harness plays kubelet: a retryably-failed unprepare is
    retried (after the window if need be) rather than abandoned, and the
    claim object is deleted only once its unprepare succeeded.
    Injection-attributable failures are reported apart (``fault_errors``)
    from real errors (``errors``).

    ``trace``: the process-global tracer on for the window, a root span
    per claim cycle propagated through the claim's annotations; the result
    gains a ``tracing`` report (completeness audit, per-phase breakdown).
    Under ``faults`` every claim whose prepare failed by injection must
    carry a ``PrepareFailed`` Event (``missing_events``).

    ``trace_every``: trace every Nth GPU cycle only; the GPU prepare
    latencies are then split into traced and untraced arms of one run
    (``tracing.p50_traced_ms`` / ``p50_untraced_ms``)."""
    import statistics

    from k8s_dra_driver_tpu_torch.api.computedomain import new_compute_domain
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import (
        AlreadyExistsError,
        NotFoundError,
        new_object,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin import (
        AllocationError,
        Allocator,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
    from k8s_dra_driver_tpu_torch.pkg import faultpoints, tracing
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_controller \
        .controller import DEVICE_CLASS_CHANNEL, ComputeDomainController
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_daemon import (
        ComputeDomainDaemon,
    )
    from k8s_dra_driver_tpu_torch.plugins.compute_domain_kubelet_plugin \
        import CdDriver, CdDriverConfig
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )

    plan = None
    if faults:
        plan = faultpoints.FaultPlan(faults, seed=fault_seed)
        _reject_crash_schedules(plan, "run_claim_churn",
                                "a churn worker thread")

    tmp = tmpdir or tempfile.mkdtemp(prefix="stress-")
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER_NAME,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object(
        "DeviceClass", DEVICE_CLASS_CHANNEL,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'channel'"}}]}))

    gpu_drivers: list = []
    cd_drivers: list = []
    for i in range(n_nodes):
        node = f"node-{i}"
        client.create(new_object("Node", node))
        gpu_drivers.append(GpuDriver(client, DriverConfig(
            node_name=node, state_dir=f"{tmp}/gpu-{i}",
            cdi_root=f"{tmp}/cdi-gpu-{i}", env={}, retry_timeout=1.0,
        ), device_lib=MockDeviceLib(profile, host_index=i)).start())
        cd_drivers.append(CdDriver(client, CdDriverConfig(
            node_name=node, state_dir=f"{tmp}/cd-{i}",
            cdi_root=f"{tmp}/cdi-cd-{i}", env={}, retry_timeout=1.0,
        ), device_lib=MockDeviceLib(profile, host_index=i)).start())

    # One ComputeDomain spanning all nodes with Ready daemons, so channel
    # claims prepare instead of being rendezvous-gated.
    controller = ComputeDomainController(client)
    cd = client.create(new_compute_domain("stress-dom", "default",
                                          num_nodes=n_nodes))
    controller.reconcile(cd)
    for i in range(n_nodes):
        ComputeDomainDaemon(
            client=client,
            device_lib=MockDeviceLib(profile, host_index=i),
            cd_uid=cd["metadata"]["uid"], cd_name="stress-dom",
            node_name=f"node-{i}", namespace="default",
            hostname=f"node-{i}").sync_once()
    controller.reconcile(client.get("ComputeDomain", "stress-dom",
                                    "default"))

    channel_rct = client.get("ResourceClaimTemplate", "stress-dom-channel",
                             "default")

    alloc = Allocator(client)  # one scheduler actor, shared
    lat: dict[str, list[float]] = {"gpu": [], "cd": []}
    # Interleaved-arm split (trace_every > 1): GPU prepare latencies by
    # whether that cycle carried a root span.
    lat_split: dict[str, list[float]] = {"traced": [], "untraced": []}
    lat_lock = sanitizer.new_lock("stresslab.churn.lat_lock")
    errors: list = []
    fault_errors: list = []
    # Claims whose PREPARE failed by injection: the Event oracle's set.
    prep_fault_failed: set = set()
    prep_failed_lock = sanitizer.new_lock("stresslab.churn.prep_failed_lock")
    # Unprepares that exhausted their in-cycle retry budget under
    # injection, drained fault-free after the window.
    deferred: list = []
    deferred_lock = sanitizer.new_lock("stresslab.churn.deferred_lock")
    stop_at = time.monotonic() + duration_s

    def is_injected(err: BaseException) -> bool:
        """A failure attributable to the active plan, by provenance marker:
        a real liveness bug that happens to time out under churn does not
        qualify and fails the run."""
        return faultpoints.is_injected(err)

    def record(name: str, err: BaseException) -> None:
        (fault_errors if faults and is_injected(err) else errors).append(
            (name, repr(err)))

    def api(fn, *args):
        """One API interaction as the harness actor: retried over injected
        or transient failures."""
        last: Optional[BaseException] = None
        for _ in range(50):
            try:
                return fn(*args)
            except (AllocationError, NotFoundError, AlreadyExistsError):
                raise
            except Exception as e:  # noqa: BLE001 — bounded retry
                last = e
                time.sleep(0.005)
        raise last  # type: ignore[misc]

    def churn(node_i: int, worker: int) -> None:
        gpu = gpu_drivers[node_i]
        cdd = cd_drivers[node_i]
        cycle = 0
        gpu_cycle = 0
        while time.monotonic() < stop_at:
            cycle += 1
            use_channel = cycle % channel_every == 0
            if not use_channel:
                gpu_cycle += 1
            name = f"stress-{node_i}-{worker}-{cycle}"
            # With trace_every > 1 the arms alternate over GPU cycles only,
            # so the split does not correlate with channel_every's phase.
            traced_cycle = trace and (
                trace_every == 1
                or (not use_channel and gpu_cycle % trace_every == 0))
            root = (tracing.start_span(
                        "claim", new_root=True,
                        attributes={"claim": name, "driver": "gpu"})
                    if traced_cycle else None)
            try:
                if use_channel:
                    spec = dict(channel_rct["spec"]["spec"])
                    driver, kind = cdd, "cd"
                else:
                    spec = {"devices": {"requests": [{
                        "name": "gpu", "exactly": {
                            "deviceClassName": DRIVER_NAME,
                            "allocationMode": "ExactCount", "count": 1}}]}}
                    driver, kind = gpu, "gpu"
                if root is not None:
                    root.set_attribute("driver", kind)
                obj = new_object(
                    "ResourceClaim", name, "default",
                    api_version="resource.k8s.io/v1", spec=spec)
                if root is not None:
                    tracing.inject(root, obj)
                claim = api(client.create, obj)
                try:
                    allocated = api(
                        lambda: alloc.allocate(claim,
                                               node=f"node-{node_i}"))
                except AllocationError:
                    api(client.delete, "ResourceClaim", name, "default")
                    if root is not None:
                        root.set_status("error", "allocation contention")
                    continue  # contention: everything busy right now
                uid = allocated["metadata"]["uid"]
                t0 = time.perf_counter()
                res = driver.prepare_resource_claims([allocated])[uid]
                dt = time.perf_counter() - t0
                if res.error is not None:
                    record(name, res.error)
                    if faults and is_injected(res.error):
                        with prep_failed_lock:
                            prep_fault_failed.add(name)
                    if root is not None:
                        root.set_status("error", repr(res.error))
                else:
                    with lat_lock:
                        lat[kind].append(dt)
                        if trace and trace_every > 1 and kind == "gpu":
                            lat_split["traced" if traced_cycle
                                      else "untraced"].append(dt)
                    if root is not None:
                        root.set_status("ok")
                if root is not None:
                    # Ready or failed: the root ends here, so unprepare and
                    # delete never leave it open.
                    root.end()
                # Unprepare runs even after a failed prepare (partial state
                # is what it must be able to unwind).
                ref = ClaimRef(uid=uid, name=name, namespace="default")
                errs = driver.unprepare_resource_claims([ref])
                if errs[uid] is not None:
                    if faults and is_injected(errs[uid]):
                        with deferred_lock:
                            deferred.append((driver, ref))
                        continue  # claim object kept until unprepared
                    record(name, errs[uid])
                api(client.delete, "ResourceClaim", name, "default")
            except Exception as e:  # noqa: BLE001 — audited below
                record(name, e)
                if root is not None and root.status == "unset":
                    root.set_status("error", repr(e))
            finally:
                if root is not None:
                    if root.status == "unset":
                        root.set_status("error", "cycle aborted")
                    root.end()  # idempotent when already ended above

    prev_plan = None
    if plan is not None:
        prev_plan = faultpoints.active_plan()
        faultpoints.activate(plan)
    if trace:
        # Enabled after all fallible setup, disabled in the finally below.
        tracing.enable(capacity=trace_capacity)
    t_start = time.monotonic()
    try:
        try:
            threads = [
                threading.Thread(target=churn, args=(i, w), daemon=True)
                for i in range(n_nodes) for w in range(workers_per_node)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=duration_s + 120)
        finally:
            if plan is not None:
                faultpoints.deactivate()
        elapsed = time.monotonic() - t_start

        # Fault-free drain of the deferred unprepares: every one must now
        # succeed; one that still cannot is a recovery bug.
        for driver, ref in deferred:
            errs = driver.unprepare_resource_claims([ref])
            if errs[ref.uid] is not None:
                errors.append((ref.name, repr(errs[ref.uid])))
            else:
                try:
                    client.delete("ResourceClaim", ref.name, "default")
                except NotFoundError:
                    pass

        if faults:
            # A prepare that timed out under injection and was then
            # unprepared leaves a PrepareAborted tombstone by design;
            # expire them through the real GC path, time-accelerated.
            for d in cd_drivers:
                d.state.delete_expired_aborted(
                    now=time.time() + d.state.aborted_ttl + 1.0)

        # Leak audit across every node stack.
        leaks: dict[str, Any] = {}
        for i in range(n_nodes):
            if gpu_drivers[i].state.prepared_claims():
                leaks[f"gpu-{i}-checkpoint"] = list(
                    gpu_drivers[i].state.prepared_claims())
            if gpu_drivers[i].cdi.list_claim_uids():
                leaks[f"gpu-{i}-cdi"] = gpu_drivers[i].cdi.list_claim_uids()
            if cd_drivers[i].state.prepared_claims():
                leaks[f"cd-{i}-checkpoint"] = list(
                    cd_drivers[i].state.prepared_claims())
            if cd_drivers[i].cdi.list_claim_uids():
                leaks[f"cd-{i}-cdi"] = cd_drivers[i].cdi.list_claim_uids()
        lingering = [
            c["metadata"]["name"] for c in client.list("ResourceClaim")
            if c["metadata"]["name"].startswith("stress-")
            and c["metadata"]["name"] != "stress-dom-channel"]
        if lingering:
            leaks["claims"] = lingering

        # Event oracle: every claim whose prepare failed by injection must
        # carry a durable PrepareFailed Event.
        missing_events: list = []
        if faults and prep_fault_failed:
            from k8s_dra_driver_tpu_torch.pkg.events import (
                REASON_PREPARE_FAILED,
                list_events,
            )
            have = {(e.get("involvedObject") or {}).get("name")
                    for e in list_events(client,
                                         reason=REASON_PREPARE_FAILED)}
            missing_events = sorted(n for n in prep_fault_failed
                                    if n not in have)
    finally:
        if trace:
            tracing.disable()
        if prev_plan is not None:
            faultpoints.activate(prev_plan)

    def dist(xs: list[float]) -> dict:
        return {
            "ops": len(xs),
            "p50_ms": round(statistics.median(xs) * 1e3, 3) if xs else 0.0,
            "p90_ms": round(_pct(xs, 0.90) * 1e3, 3),
            "p99_ms": round(_pct(xs, 0.99) * 1e3, 3),
            "max_ms": round(max(xs) * 1e3, 3) if xs else 0.0,
        }

    for d in [*gpu_drivers, *cd_drivers]:
        d.stop()
    if tmpdir is None:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "duration_s": round(elapsed, 2),
        "n_nodes": n_nodes,
        "workers": n_nodes * workers_per_node,
        "profile": profile,
        "gpu_prepare": dist(lat["gpu"]),
        "cd_prepare": dist(lat["cd"]),
        "errors": errors[:10],
        "error_count": len(errors),
        "leaks": leaks,
    }
    if trace:
        out["tracing"] = tracing.summarize_store(
            tracing.default_tracer().store,
            started=tracing.default_tracer().started_spans())
        if trace_every > 1:
            t = out["tracing"]
            t["trace_every"] = trace_every
            for arm in ("traced", "untraced"):
                xs = lat_split[arm]
                t[f"p50_{arm}_ms"] = (round(statistics.median(xs) * 1e3, 3)
                                      if xs else 0.0)
                t[f"mean_{arm}_ms"] = round(_trimmed_mean(xs) * 1e3, 3)
            t["split_ops"] = {k: len(v) for k, v in lat_split.items()}
    if faults:
        log = plan.log() if plan is not None else []
        out["faults"] = {
            "spec": faults,
            "seed": fault_seed,
            "injected": len(log),
            # The full (point, hit#, action) log: determinism tests compare
            # per-point prefixes across runs.
            "log": log,
            "fault_errors": len(fault_errors),
            "deferred_unprepares": len(deferred),
            "prepare_fault_failures": sorted(prep_fault_failed),
            "missing_events": missing_events,
        }
    return out


# --------------------------------------------------------------------------
# Observability overhead legs: fleetwatch, the flight recorder and
# profiler, the canary and the usage meter
# --------------------------------------------------------------------------


def run_fleetwatch(
    n_nodes: int = 2,
    workers_per_node: int = 2,
    profile: str = "h100-8",
    tmpdir: Optional[str] = None,
    baseline_s: float = 1.5,
    clean_s: float = 1.5,
    burst_s: float = 2.0,
    baseline2_s: float = 1.0,
    scrape_interval_s: float = 0.1,
    rule_window_s: float = 1.0,
    burn_windows: Optional[tuple] = None,
    burst_faults: str = "devicestate.prepare=rate:0.9",
    scrape_faults: str = "telemetry.scrape=rate:0.2",
    fault_seed: int = 0,
    detect_bound_s: float = 2.5,
    clear_bound_s: float = 10.0,
    retry_timeout_s: float = 0.25,
) -> dict:
    """The whole telemetry plane — per-node MetricsServers scraped over
    real HTTP, fleet aggregation, recording rules and the multi-window SLO
    burn-rate engine — against live GPU node stacks on mock ``profile``
    nodes, with three claims measured in one run:

    1. **detection**: a seeded prepare-failure burst must fire the
       fast-burn (page) alert within ``detect_bound_s`` of the burst
       starting, and the alert must CLEAR within ``clear_bound_s`` of
       the burst ending;
    2. **zero false positives**: the telemetered fault-free window before
       the burst must produce no alert transitions at all — including
       while the ``telemetry.scrape`` fault leg is failing a fifth of
       all scrapes (a scrape failure is per-target and non-fatal, never
       an SLO signal);
    3. **overhead**: the telemetered clean arm's trimmed-mean prepare
       latency against UNTELEMETERED arms run before and after it in the
       same process (bracketing, so one-sided drift cannot masquerade as
       overhead).

    The phases: baseline (no metrics servers, no scraper) → telemetered
    clean (scrape-fault leg active) → burst → recovery (injection off,
    alerts must clear) → trailing baseline. Workers churn claim →
    allocate (node-pinned) → prepare → unprepare → delete throughout;
    injected prepare failures during the burst are the SLO signal, not
    harness errors."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import (
        AlreadyExistsError,
        NotFoundError,
        new_object,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin import (
        AllocationError,
        Allocator,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
    from k8s_dra_driver_tpu_torch.pkg import faultpoints, slo as slolib
    from k8s_dra_driver_tpu_torch.pkg.events import (
        REASON_SLO_BURN_RATE_CLEARED,
        REASON_SLO_BURN_RATE_HIGH,
        EventRecorder,
        list_events,
    )
    from k8s_dra_driver_tpu_torch.pkg.metrics import MetricsServer
    from k8s_dra_driver_tpu_torch.pkg.telemetry import (
        FleetMetrics,
        FleetTelemetry,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )

    if burn_windows is None:
        # Seconds-compressed SRE pairs: page 0.4 s / 1.6 s @ 14.4x,
        # ticket 2.4 s / 7.2 s @ 1x — the production shape at the
        # harness's clock (pkg/slo.compressed_windows form).
        burn_windows = (
            slolib.BurnWindow(slolib.SEVERITY_PAGE, 0.4, 1.6, 14.4),
            slolib.BurnWindow(slolib.SEVERITY_TICKET, 2.4, 7.2, 1.0),
        )
    for spec in (burst_faults, scrape_faults):
        _reject_crash_schedules(
            faultpoints.FaultPlan(spec or "", seed=fault_seed),
            "run_fleetwatch", "a churn worker thread")

    tmp = tmpdir or tempfile.mkdtemp(prefix="fleetwatch-")
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER_NAME,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))

    drivers: list = []
    for i in range(n_nodes):
        node = f"node-{i}"
        client.create(new_object("Node", node))
        drivers.append(GpuDriver(client, DriverConfig(
            node_name=node, state_dir=f"{tmp}/gpu-{i}",
            cdi_root=f"{tmp}/cdi-gpu-{i}", env={},
            retry_timeout=retry_timeout_s,
        ), device_lib=MockDeviceLib(profile, host_index=i)).start())

    alloc = Allocator(client)  # the one scheduler actor, shared; it
    # serializes on its own reentrant mutex
    phase = {"name": "baseline"}
    lat: dict[str, list[float]] = {"baseline": [], "clean": [],
                                   "baseline2": []}
    lat_lock = sanitizer.new_lock("stresslab.fleetwatch.lat_lock")
    errors: list = []
    prep_fault_failures = [0]
    cycles = [0]
    stop_all = threading.Event()

    def worker(node_i: int, w: int) -> None:
        driver = drivers[node_i]
        cycle = 0
        while not stop_all.is_set():
            cycle += 1
            name = f"fw-{node_i}-{w}-{cycle}"
            try:
                claim = client.create(new_object(
                    "ResourceClaim", name, "default",
                    api_version="resource.k8s.io/v1",
                    spec={"devices": {"requests": [{
                        "name": "gpu", "exactly": {
                            "deviceClassName": DRIVER_NAME,
                            "allocationMode": "ExactCount", "count": 1}}]}}))
                try:
                    allocated = alloc.allocate(claim,
                                               node=f"node-{node_i}")
                except AllocationError:
                    try:
                        client.delete("ResourceClaim", name, "default")
                    except NotFoundError:
                        pass
                    continue
                uid = allocated["metadata"]["uid"]
                arm = phase["name"]
                t0 = time.perf_counter()
                res = driver.prepare_resource_claims([allocated])[uid]
                dt = time.perf_counter() - t0
                if res.error is not None:
                    if faultpoints.is_injected(res.error):
                        with lat_lock:
                            prep_fault_failures[0] += 1
                    else:
                        errors.append((name, repr(res.error)))
                elif arm in lat:
                    with lat_lock:
                        lat[arm].append(dt)
                with lat_lock:
                    cycles[0] += 1
                ref = ClaimRef(uid=uid, name=name, namespace="default")
                errs = driver.unprepare_resource_claims([ref])
                if errs[uid] is not None:
                    errors.append((name, repr(errs[uid])))
                client.delete("ResourceClaim", name, "default")
            except AlreadyExistsError:
                continue
            except NotFoundError:
                continue
            except Exception as e:  # noqa: BLE001 — audited
                errors.append((name, repr(e)))

    fleet_metrics = FleetMetrics()
    telemetry = None
    servers: list = []
    engine = None
    prev_plan = faultpoints.active_plan()
    t_burst = None
    detection_delay = None
    clear_delay = None
    fired_page = False
    cleared = False
    threads = [threading.Thread(target=worker, args=(i, w), daemon=True)
               for i in range(n_nodes) for w in range(workers_per_node)]
    try:
        for t in threads:
            t.start()
        # Phase 1: untelemetered baseline — no servers, no scraper.
        time.sleep(baseline_s)

        # Phase 2: telemetry up; scrape-fault leg active; must stay
        # alert-free.
        for d in drivers:
            servers.append(MetricsServer(d.metrics.registry,
                                         port=0).start())
        telemetry = FleetTelemetry(
            targets=[f"127.0.0.1:{s.port}" for s in servers],
            interval_s=scrape_interval_s,
            rule_window_s=rule_window_s,
            metrics=fleet_metrics)
        engine = slolib.SloEngine(
            telemetry.rules, slos=slolib.default_slos(),
            windows=burn_windows,
            events=EventRecorder(client, "fleetwatch"),
            metrics=slolib.SloMetrics())
        telemetry.slo_engine = engine
        telemetry.start()
        if scrape_faults:
            faultpoints.activate(faultpoints.FaultPlan(scrape_faults,
                                                       seed=fault_seed))
        phase["name"] = "clean"
        time.sleep(clean_s)

        # Phase 3: the burst. Detection delay = burst start → first page
        # alert fired.
        spec = ";".join(s for s in (scrape_faults, burst_faults) if s)
        t_burst = time.monotonic()
        faultpoints.activate(faultpoints.FaultPlan(spec, seed=fault_seed))
        phase["name"] = "burst"
        # Scan for the first page-fired transition through the burst
        # window and, while undetected, a grace window past it (a late
        # detection still lands and is still held against the bound).
        burst_deadline = t_burst + burst_s
        grace_deadline = t_burst + max(burst_s, detect_bound_s) + 1.0
        while time.monotonic() < (burst_deadline if fired_page
                                  else grace_deadline):
            if not fired_page:
                for tr in engine.transitions():
                    if (tr.severity == slolib.SEVERITY_PAGE
                            and tr.transition == "fired"
                            and tr.at >= t_burst):
                        fired_page = True
                        detection_delay = tr.at - t_burst
                        break
            time.sleep(0.02)

        # Phase 4: recovery — injection off, traffic continues, every
        # alert must clear.
        faultpoints.deactivate()
        t_end_burst = time.monotonic()
        phase["name"] = "recovery"
        clear_deadline = t_end_burst + clear_bound_s
        while time.monotonic() < clear_deadline:
            if not engine.firing():
                cleared = True
                clear_delay = time.monotonic() - t_end_burst
                break
            time.sleep(0.05)

        # Phase 5: trailing untelemetered baseline (the drift bracket).
        telemetry.stop()
        for s in servers:
            s.stop()
        servers = []
        phase["name"] = "baseline2"
        time.sleep(baseline2_s)
    finally:
        stop_all.set()
        faultpoints.deactivate()
        for t in threads:
            t.join(timeout=30.0)
        if telemetry is not None and telemetry._thread is not None:
            telemetry.stop()
        for s in servers:
            s.stop()
        for d in drivers:
            d.stop()
        if prev_plan is not None:
            faultpoints.activate(prev_plan)

    # False positives: any transition that FIRED before the burst began.
    false_positives = [
        tr for tr in (engine.transitions() if engine is not None else [])
        if tr.transition == "fired"
        and (t_burst is None or tr.at < t_burst)]

    # Leak audit (fault-free window): checkpoints, CDI, claim objects.
    leaks: dict[str, Any] = {}
    for i in range(n_nodes):
        if drivers[i].state.prepared_claims():
            leaks[f"gpu-{i}-checkpoint"] = list(
                drivers[i].state.prepared_claims())
        if drivers[i].cdi.list_claim_uids():
            leaks[f"gpu-{i}-cdi"] = drivers[i].cdi.list_claim_uids()
    lingering = [c["metadata"]["name"]
                 for c in client.list("ResourceClaim", "default")
                 if c["metadata"]["name"].startswith("fw-")]
    if lingering:
        leaks["claims"] = lingering
    if tmpdir is None:
        shutil.rmtree(tmp, ignore_errors=True)

    baseline_lat = lat["baseline"] + lat["baseline2"]
    mean_base = _trimmed_mean(baseline_lat) * 1e3
    mean_clean = _trimmed_mean(lat["clean"]) * 1e3
    overhead_pct = (round((mean_clean - mean_base) / mean_base * 100, 2)
                    if mean_base else 0.0)

    scrape_errors = fleet_metrics.scrapes_total.value(outcome="error")
    scrape_ok = fleet_metrics.scrapes_total.value(outcome="success")
    high_events = len(list_events(client,
                                  reason=REASON_SLO_BURN_RATE_HIGH))
    cleared_events = len(list_events(client,
                                     reason=REASON_SLO_BURN_RATE_CLEARED))

    return {
        "n_nodes": n_nodes,
        "workers": n_nodes * workers_per_node,
        "targets": n_nodes,
        "cycles": cycles[0],
        "prepare_fault_failures": prep_fault_failures[0],
        "fired_page": fired_page,
        "detection_delay_s": (round(detection_delay, 3)
                              if detection_delay is not None else None),
        "detect_bound_s": detect_bound_s,
        "cleared": cleared,
        "clear_delay_s": (round(clear_delay, 3)
                          if clear_delay is not None else None),
        "clear_bound_s": clear_bound_s,
        "false_positives": len(false_positives),
        "false_positive_samples": [vars(tr) for tr in false_positives[:3]],
        "transitions": [vars(tr) for tr in (
            engine.transitions() if engine is not None else [])],
        "slo_events": {"high": high_events, "cleared": cleared_events},
        "scrapes": {"success": int(scrape_ok), "error": int(scrape_errors)},
        "ticks": telemetry.ticks() if telemetry is not None else 0,
        "rule_values": (telemetry.rule_values()
                        if telemetry is not None else {}),
        "series": telemetry.rules.series_count() if telemetry else 0,
        "series_dropped": (telemetry.rules.dropped_series
                           if telemetry else 0),
        "overhead": {
            "mean_untelemetered_ms": round(mean_base, 3),
            "mean_telemetered_ms": round(mean_clean, 3),
            "overhead_pct": overhead_pct,
            "ops": {k: len(v) for k, v in lat.items()},
        },
        "errors": errors[:10],
        "error_count": len(errors),
        "leaks": leaks,
    }


def _one_gpu_claim(name: str) -> dict:
    """A ResourceClaim for one whole GPU of the ``gpu.nvidia.com`` class."""
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    return new_object(
        "ResourceClaim", name, "default",
        api_version="resource.k8s.io/v1",
        spec={"devices": {"requests": [{
            "name": "gpu", "exactly": {
                "deviceClassName": DRIVER_NAME,
                "allocationMode": "ExactCount", "count": 1}}]}})


def _single_gpu_node(tmp: str, profile: str):
    """One fake API with the ``gpu.nvidia.com`` class, ``node-0`` and its
    started GPU driver on a mock ``profile`` node: the world of the
    overhead legs. Returns ``(client, driver)``."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        DriverConfig,
        GpuDriver,
    )
    client = FakeClient()
    client.create(new_object(
        "DeviceClass", DRIVER_NAME,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object("Node", "node-0"))
    driver = GpuDriver(client, DriverConfig(
        node_name="node-0", state_dir=f"{tmp}/gpu",
        cdi_root=f"{tmp}/cdi", env={}, retry_timeout=2.0,
    ), device_lib=MockDeviceLib(profile, host_index=0)).start()
    return client, driver


def run_blackbox_overhead(
    cycles: int = 300,
    profile: str = "h100-8",
    tmpdir: Optional[str] = None,
    sample_interval_s: float = 0.02,
) -> dict:
    """Flight-recorder + profiler overhead on the claim path, by the
    interleaved-arm methodology: ONE sequential churn loop (create →
    allocate → prepare → unprepare → delete on a single node's GPU
    driver) alternating the profiler per cycle — even cycles paused, odd
    cycles sampling at the BURST interval (the worst case; the always-on
    base rate is strictly cheaper). Both arms share the same window, disk
    state and heap, so drift cancels; trimmed means, not mode-flipping
    medians. A live FlightRecorder rides the whole run (it is passive
    between alerts — the measurement proves that, not assumes it)."""
    from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
    from k8s_dra_driver_tpu_torch.pkg.blackbox import (
        BlackboxMetrics,
        ContinuousProfiler,
        FlightRecorder,
    )

    tmp = tmpdir or tempfile.mkdtemp(prefix="bb-overhead-")
    client, driver = _single_gpu_node(tmp, profile)
    bbm = BlackboxMetrics()
    profiler = ContinuousProfiler(
        base_interval_s=sample_interval_s,
        burst_interval_s=sample_interval_s, metrics=bbm)
    profiler.pause()
    profiler.start()
    recorder = FlightRecorder(f"{tmp}/blackbox", client=client,
                              metrics=bbm)
    alloc = Allocator(client)
    lat: dict[str, list[float]] = {"off": [], "on": []}
    errors: list = []
    try:
        for i in range(cycles):
            arm = "on" if i % 2 else "off"
            if arm == "on":
                profiler.resume()
            else:
                profiler.pause()
            name = f"bb-ov-{i}"
            try:
                claim = client.create(_one_gpu_claim(name))
                allocated = alloc.allocate(claim, node="node-0")
                uid = allocated["metadata"]["uid"]
                t0 = time.perf_counter()
                res = driver.prepare_resource_claims([allocated])[uid]
                dt = time.perf_counter() - t0
                if res.error is not None:
                    errors.append((name, repr(res.error)))
                else:
                    lat[arm].append(dt)
                driver.unprepare_resource_claims([ClaimRef(
                    uid=uid, name=name, namespace="default")])
                client.delete("ResourceClaim", name, "default")
            except Exception as e:  # noqa: BLE001 — audited
                errors.append((name, repr(e)))
    finally:
        profiler.stop()
        driver.stop()
        if tmpdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    # Top-trim only the extreme tail: the profiled arm's cost
    # concentrates in the minority of cycles a sampling tick lands in,
    # and the usual 10-90 % trim would cut exactly those cycles and
    # report a vacuous zero.
    mean_off = _trimmed_mean(lat["off"], lo=0.0, hi=0.98) * 1e3
    mean_on = _trimmed_mean(lat["on"], lo=0.0, hi=0.98) * 1e3
    overhead_pct = (round((mean_on - mean_off) / mean_off * 100, 2)
                    if mean_off else 0.0)
    prof = profiler.snapshot(top=3)
    return {
        "cycles": cycles,
        "mean_unprofiled_ms": round(mean_off, 3),
        "mean_profiled_ms": round(mean_on, 3),
        "overhead_pct": overhead_pct,
        "ops": {k: len(v) for k, v in lat.items()},
        "profiler_samples": prof["samples"],
        "distinct_stacks": prof["distinct_stacks"],
        "recorder_captures": recorder.captures,
        "errors": errors[:5],
        "error_count": len(errors),
    }


def run_canary_overhead(
    cycles: int = 240,
    probe_every: int = 8,
    profile: str = "h100-8",
    tmpdir: Optional[str] = None,
) -> dict:
    """Canary + metering steady-state overhead on the claim path, by the
    interleaved-arm methodology: ONE sequential churn loop (create →
    allocate → prepare → unprepare → delete on a single node) alternating
    the user-perspective plane per cycle — even cycles bare, odd cycles
    pay a metering ``observe()`` tick plus (every ``probe_every``-th
    active cycle) one full synthetic probe run CONCURRENTLY with the
    timed claim work (started just before the timed section, joined
    after it, before the next cycle — so the contention a live prober
    causes, the shared allocator-mutex wait included, lands IN the
    measured arm while the bare arm stays clean). Both arms share the
    window, disk state and heap, so drift cancels; the prepare loop's
    asynchronous event handling rides both arms. Trimmed means."""
    from k8s_dra_driver_tpu_torch.kubeletplugin import Allocator
    from k8s_dra_driver_tpu_torch.kubeletplugin.claimwatcher import (
        NodePrepareLoop,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import ClaimRef
    from k8s_dra_driver_tpu_torch.pkg.canary import (
        CanaryMetrics,
        CanaryProber,
    )
    from k8s_dra_driver_tpu_torch.pkg.usage import UsageMeter, UsageMetrics

    tmp = tmpdir or tempfile.mkdtemp(prefix="canary-overhead-")
    client, driver = _single_gpu_node(tmp, profile)
    alloc = Allocator(client)  # shared scheduler: the prober allocates
    # through this same instance, so its probe serializes with the timed
    # claim work on the allocator's own reentrant mutex
    loop = NodePrepareLoop(client, driver, DRIVER_NAME, "node-0",
                           namespace="default").start()
    prober = CanaryProber(
        client, alloc, nodes=["node-0"],
        probe_deadline_s=2.0,
        metrics=CanaryMetrics())
    meter = UsageMeter(client, namespace="default", metrics=UsageMetrics())
    lat: dict[str, list[float]] = {"off": [], "on": []}
    errors: list = []
    probes = 0
    try:
        for i in range(cycles):
            arm = "on" if i % 2 else "off"
            name = f"cn-ov-{i}"
            probe_thread = None
            try:
                if arm == "on":
                    meter.observe()
                    if (i // 2) % probe_every == 0:
                        # The probe runs DURING the timed claim work —
                        # its allocator-mutex holds, prepare-loop events
                        # and interpreter time are the interference
                        # being measured.
                        probe_thread = threading.Thread(
                            target=prober.probe_node, args=("node-0",),
                            daemon=True)
                        probe_thread.start()
                        probes += 1
                claim = client.create(_one_gpu_claim(name))
                t0 = time.perf_counter()
                allocated = alloc.allocate(claim, node="node-0")
                uid = allocated["metadata"]["uid"]
                res = driver.prepare_resource_claims([allocated])[uid]
                dt = time.perf_counter() - t0
                if res.error is not None:
                    errors.append((name, repr(res.error)))
                else:
                    lat[arm].append(dt)
                driver.unprepare_resource_claims([ClaimRef(
                    uid=uid, name=name, namespace="default")])
                client.delete("ResourceClaim", name, "default")
            except Exception as e:  # noqa: BLE001 — audited
                errors.append((name, repr(e)))
            finally:
                if probe_thread is not None:
                    # Joined before the next cycle: the bare arm never
                    # overlaps a live probe.
                    probe_thread.join(timeout=30.0)
    finally:
        loop.stop()
        driver.stop()
        if tmpdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    # Top-trim only the extreme tail, as the blackbox overhead leg does:
    # the canary arm's cost concentrates in the probe cycles, and a
    # symmetric trim would cut exactly those and report zero.
    mean_off = _trimmed_mean(lat["off"], lo=0.0, hi=0.98) * 1e3
    mean_on = _trimmed_mean(lat["on"], lo=0.0, hi=0.98) * 1e3
    overhead_pct = (round((mean_on - mean_off) / mean_off * 100, 2)
                    if mean_off else 0.0)
    return {
        "cycles": cycles,
        "probes": probes,
        "mean_bare_ms": round(mean_off, 3),
        "mean_canary_ms": round(mean_on, 3),
        "overhead_pct": overhead_pct,
        "ops": {k: len(v) for k, v in lat.items()},
        "probe_failures": prober.failures,
        "probe_leaked": prober.leaked,
        "meter_observe_failures": meter.observe_failures,
        "errors": errors[:5],
        "error_count": len(errors),
    }


# --------------------------------------------------------------------------
# Topology-aware allocation at fleet scale, and the defrag loop
# --------------------------------------------------------------------------

#: the allocator-scale harness's classes: claim size in memory slices →
#: (DeviceClass, MIG profile it selects). Each class pins one published
#: profile, as the JAX harness's classes pin one subslice shape: 1g.10gb,
#: 1g.20gb (whose starts 0, 2, 4, 6 tile the GPU, where 2g.20gb's do not
#: reach slice 7), 3g.40gb and 7g.80gb. The admission probe is one whole
#: GPU (``gpu.nvidia.com``), the 1x8 box of the GPU × memory-slice mesh.
ALLOC_SCALE_CLASSES = {
    1: ("mig-1g10gb", "1g.10gb"),
    2: ("mig-1g20gb", "1g.20gb"),
    4: ("mig-3g40gb", "3g.40gb"),
    8: ("mig-7g80gb", "7g.80gb"),
}
#: the seeded tape's size mix (the JAX harness's weights)
ALLOC_SCALE_WEIGHTS = ((1, 0.50), (2, 0.22), (4, 0.18), (8, 0.10))
#: memory slices of one ``h100-8`` node: 8 GPUs x 8 slices
ALLOC_SCALE_NODE_SLICES = 64


def alloc_scale_tape(n_claims: int, n_nodes: int, seed: int) -> list:
    """The seeded op tape of :func:`run_allocator_scale`, identical for
    both arms: ``(size in memory slices, node index, release fraction)``
    per op, drawn exactly as the JAX harness draws it."""
    import random

    rng = random.Random(seed)
    tape = []
    for _ in range(n_claims):
        roll = rng.random()
        acc = 0.0
        size = 1
        for s, w in ALLOC_SCALE_WEIGHTS:
            acc += w
            if roll <= acc:
                size = s
                break
        tape.append((size, rng.randrange(n_nodes), rng.random()))
    return tape


def alloc_scale_world(client, n_nodes: int) -> None:
    """Create the allocator-scale classes and publish ``n_nodes`` pools,
    each one ``h100-8`` mock in MIG mode: its whole GPUs with counters and
    every MIG placement, over the node's memory-slice counter set (64
    unit counters, as the JAX harness's 8x8 chip mesh)."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.kubeletplugin.helper import Helper
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
        DriverResources,
        Pool,
        Slice,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        partitions,
    )

    client.create(new_object(
        "DeviceClass", partitions.DEVICE_CLASS_GPU,
        spec={"selectors": [{"cel": {"expression": partitions
              .DEVICE_CLASS_SELECTORS[partitions.DEVICE_CLASS_GPU]}}]}))
    for cls, profile in ALLOC_SCALE_CLASSES.values():
        client.create(new_object(
            "DeviceClass", cls,
            spec={"selectors": [{"cel": {"expression":
                "device.attributes['type'] == 'mig' && "
                f"device.attributes['profile'] == '{profile}'"}}]}))
    for i in range(n_nodes):
        gpus = MockDeviceLib("h100-8", host_index=i,
                             mig=True).enumerate_gpus()
        devices = [partitions.full_gpu_device(g, with_counters=True)
                   for g in gpus]
        devices += partitions.mig_devices(gpus)
        Helper(client, DRIVER_NAME, f"node-{i}",
               _StubPlugin()).publish_resources(DriverResources(
                   pools={f"node-{i}": Pool(slices=[Slice(
                       devices=devices,
                       shared_counters=[
                           partitions.memory_slice_counter_set(gpus)])])}))


class _StubPlugin:
    """A plugin that prepares nothing: the allocator harnesses publish
    devices directly and measure scheduling, not prepare."""

    def prepare_resource_claims(self, claims):
        return {}

    def unprepare_resource_claims(self, refs):
        return {}


def _claim_spec(cls: str, request: str = "r") -> dict:
    return {"devices": {"requests": [{"name": request, "exactly": {
        "deviceClassName": cls, "allocationMode": "ExactCount",
        "count": 1}}]}}


def _counter_audit(client, alloc) -> dict:
    """Every allocated claim's counter draws summed per (pool, counter
    set, counter) against the published capacity: over-consumed counters
    (the KEP-4815 invariant no strategy may bend) and the units in use."""
    idx = alloc._slice_index()
    consumed: dict = {}
    for c in client.list("ResourceClaim"):
        rs = ((c.get("status") or {}).get("allocation") or {}).get(
            "devices", {}).get("results", [])
        for r in rs:
            dev = idx.by_pool_device.get((r["pool"], r["device"]))
            if not dev:
                continue
            for cc in dev.get("consumesCounters", []):
                for cn, cv in cc.get("counters", {}).items():
                    k = (r["pool"], cc["counterSet"], cn)
                    consumed[k] = consumed.get(k, 0) + cv["value"]
    over = {k: v for k, v in consumed.items()
            if v > idx.capacity.get(k, 0)}
    return {"overcommitted": len(over),
            "overcommitted_samples": list(over.items())[:3],
            "used": sum(consumed.values())}


def run_allocator_scale(
    n_nodes: int = 6,
    n_claims: int = 10000,
    seed: int = 0,
    target_util: float = 0.8,
    probe_every: int = 10,
    probe_warmup_frac: float = 0.3,
    defrag: bool = True,
    defrag_probes: int = 8,
    defrag_timeout_s: float = 12.0,
    max_evictions_per_claim: int = 4,
    faults: Optional[str] = None,
    fault_seed: int = 0,
    realloc_restart: bool = False,
    pending_batch: int = 500,
) -> dict:
    """The topology-aware allocator at fleet scale: the same seeded
    mixed-size claim tape driven through a FIRST-FIT arm and a BEST-FIT
    arm on identical fresh clusters, ops INTERLEAVED one per arm so
    cross-arm clock drift cancels, then (best-fit arm) the SLO-driven
    defrag leg.

    Each arm: ``n_nodes`` pools, each one ``h100-8`` node in MIG mode —
    the GPU × memory-slice mesh of 8 x 8 = 64 unit counters, publishing
    every whole GPU and every MIG placement (:func:`alloc_scale_world`).
    ``n_claims`` NODE-PINNED claims of 1, 2, 4 or 8 memory slices (the
    classes of :data:`ALLOC_SCALE_CLASSES`, created in pending batches
    ahead of allocation) are churned with every node held at
    ``target_util`` (seeded releases), and non-perturbing whole-GPU
    admission probes ride inside the churn every ``probe_every`` ops past
    the warmup. Where the JAX harness counts chips, this one counts
    memory slices (``total_slices``, ``slices_used``). Measured:
    allocations/s over time spent INSIDE allocate/release calls (and the
    trimmed-mean form the ratio uses), the time-integrated whole-GPU
    admission rate, end-state fragmentation (gauge + report), cache
    counters, and an overlap audit (no counter over-consumed).

    ``target_util`` defaults to 0.8 where the JAX harness's is 0.55: a
    whole GPU is an eighth of a node here, not a quarter of its 8x8 mesh,
    so at 0.55 both arms admit every probe and the harness measures
    nothing; at 0.8 first-fit admits 0.1429 and best-fit 0.2300 of the
    probes at the defaults (6 x 10000).

    The defrag leg proves the whole loop: blocked whole-GPU probes burn
    the ``allocation_admission`` SLO (the allocator's
    ``outcome=fragmented`` counter scraped through a FleetScraper +
    RecordingRules), the ticket alert fires, the subscribed DefragPlanner
    preempts movable small claims through the live ClaimReallocator
    (annotation → release → re-allocate with the target placement
    avoided), and the blocked probe's retry must land. The pressure is one
    ``1g.10gb`` pin in every still-free GPU, placed by a naive scheduler;
    the whole GPU and ``7g.80gb`` share the GPU's 1x8 box, so a free box
    of volume 8 is one free GPU. ``faults`` layers a seeded fault mix over
    the leg (crash schedules rejected); ``realloc_restart`` kills and
    recreates the reallocator mid-leg (the annotation IS the crash-safe
    work queue). Oracle: every preempted claim ends reallocated or
    cleanly failed, evictions stay within ``max_evictions_per_claim`` per
    blocked claim, zero leaks."""
    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.kubeletplugin import (
        AllocationError,
        Allocator,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin.allocator import (
        STRATEGY_BEST_FIT,
        STRATEGY_FIRST_FIT,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
        ANN_DRAIN,
        ANN_DRAIN_FAILED,
        ClaimReallocator,
        DefragPlanner,
        attach_defrag_planner,
    )
    from k8s_dra_driver_tpu_torch.pkg import faultpoints, slo as slolib
    from k8s_dra_driver_tpu_torch.pkg.events import EventRecorder
    from k8s_dra_driver_tpu_torch.pkg.metrics import AllocatorMetrics
    from k8s_dra_driver_tpu_torch.pkg.telemetry import (
        FleetMetrics,
        FleetScraper,
        FleetTelemetry,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        partitions,
    )

    if faults:
        _reject_crash_schedules(
            faultpoints.FaultPlan(faults, seed=fault_seed),
            "run_allocator_scale", "the defrag leg's loop")

    small_class = ALLOC_SCALE_CLASSES[1][0]
    large_class, large_slices = partitions.DEVICE_CLASS_GPU, 8
    node_slices = ALLOC_SCALE_NODE_SLICES
    total_slices = n_nodes * node_slices

    def build_cluster() -> FakeClient:
        client = FakeClient()
        alloc_scale_world(client, n_nodes)
        return client

    tape = alloc_scale_tape(n_claims, n_nodes, seed)

    def overlap_audit(client: FakeClient, alloc: Allocator) -> dict:
        a = _counter_audit(client, alloc)
        return {"overcommitted": a["overcommitted"],
                "overcommitted_samples": a["overcommitted_samples"],
                "slices_used": a["used"],
                "utilization": round(a["used"] / total_slices, 3)}

    warmup = int(n_claims * probe_warmup_frac)

    class _Arm:
        """One strategy's whole world: its own cluster, allocator and
        bookkeeping, advanced ONE TAPE OP AT A TIME so the two arms'
        measurements interleave and cross-arm clock drift hits both."""

        def __init__(self, strategy: str):
            self.strategy = strategy
            self.client = build_cluster()
            self.metrics = AllocatorMetrics()
            self.alloc = Allocator(self.client, metrics=self.metrics,
                                   strategy=strategy)
            # Per-node live sets: the churn policy holds EVERY node at
            # the utilization target (a fleet-global target lets node
            # utilizations drift apart, and then capacity, not
            # placement, decides admission).
            self.live: dict[int, list[tuple[str, int]]] = {
                i: [] for i in range(n_nodes)}
            self.used: dict[int, int] = {i: 0 for i in range(n_nodes)}
            self.seq = 0
            self.attempts = self.successes = self.releases = 0
            self.alloc_seconds = 0.0
            self.alloc_lat: list[float] = []
            self.errors: list = []
            self.pending: list[tuple[str, int, int]] = []
            self.admitted = self.probed = 0

        def _make_pending(self) -> None:
            while len(self.pending) < pending_batch and self.seq < len(tape):
                size, node_i, _frac = tape[self.seq]
                name = f"as-{self.seq}"
                self.client.create(new_object(
                    "ResourceClaim", name, "default",
                    api_version="resource.k8s.io/v1",
                    spec=_claim_spec(ALLOC_SCALE_CLASSES[size][0])))
                self.pending.append((name, size, node_i))
                self.seq += 1

        def _probe(self, p: int) -> None:
            # Whole-GPU admission probes ride INSIDE the churn: each is a
            # node-pinned, non-perturbing attempt (an admitted probe is
            # released at once), so the admission rate integrates
            # placement quality over the whole steady state.
            name = f"as-large-{p}"
            self.client.create(new_object(
                "ResourceClaim", name, "default",
                api_version="resource.k8s.io/v1",
                spec=_claim_spec(large_class)))
            self.probed += 1
            try:
                self.alloc.allocate(
                    self.client.get("ResourceClaim", name, "default"),
                    node=f"node-{p % n_nodes}")
                self.admitted += 1
                self.alloc.release(
                    self.client.get("ResourceClaim", name, "default"))
            except AllocationError:
                pass
            except Exception as e:  # noqa: BLE001 — audited
                self.errors.append((name, repr(e)))
            self.client.delete("ResourceClaim", name, "default")

        def step(self, i: int) -> None:
            self._make_pending()
            if not self.pending:
                return
            name, size, node_i = self.pending.pop(0)
            _size, _node, frac = tape[i]
            claim = self.client.get("ResourceClaim", name, "default")
            alloc = self.alloc
            t0 = time.perf_counter()
            try:
                alloc.allocate(claim, node=f"node-{node_i}")
                ok = True
            except AllocationError:
                ok = False
            except Exception as e:  # noqa: BLE001 — audited
                ok = False
                self.errors.append((name, repr(e)))
            dt = time.perf_counter() - t0
            self.alloc_seconds += dt
            self.alloc_lat.append(dt)
            self.attempts += 1
            if ok:
                self.successes += 1
                self.live[node_i].append((name, size))
                self.used[node_i] += size
            else:
                self.client.delete("ResourceClaim", name, "default")
            # Churn policy: above the node's utilization target, release
            # seeded-chosen live claims of that node (the tape's
            # fraction keeps the choice identical across arms with
            # identical live sets).
            node_live = self.live[node_i]
            while node_live and self.used[node_i] / node_slices \
                    > target_util:
                victim_name, units = node_live.pop(
                    int(frac * len(node_live)) % len(node_live))
                t0 = time.perf_counter()
                try:
                    alloc.release(self.client.get(
                        "ResourceClaim", victim_name, "default"))
                except Exception as e:  # noqa: BLE001 — audited
                    self.errors.append((victim_name, repr(e)))
                self.alloc_seconds += time.perf_counter() - t0
                self.client.delete("ResourceClaim", victim_name, "default")
                self.releases += 1
                self.used[node_i] -= units
            if i + 1 > warmup and (i + 1) % probe_every == 0:
                self._probe((i + 1) // probe_every)

        def finish(self) -> dict:
            self.alloc.blocked.clear()  # probes are gone; defrag gets
            # fresh ones
            frag_rows = self.alloc.fragmentation_report()
            frags = [r["fragmentation"] for r in frag_rows]
            audit = overlap_audit(self.client, self.alloc)
            exposition = self.metrics.registry.expose_text()
            m = self.metrics
            return {
                "strategy": self.strategy,
                "attempts": self.attempts,
                "allocations": self.successes,
                "releases": self.releases,
                "alloc_seconds": round(self.alloc_seconds, 3),
                "allocs_per_sec": round(
                    self.successes / self.alloc_seconds, 1)
                if self.alloc_seconds else 0.0,
                # Noise-robust throughput: 1 / trimmed-mean per-attempt
                # latency — a GC pause or scheduler blip cannot swing
                # the ratio.
                "allocs_per_sec_trimmed": round(
                    1.0 / _trimmed_mean(self.alloc_lat), 1)
                if self.alloc_lat else 0.0,
                "alloc_p50_us": round(_pct(self.alloc_lat, 0.50) * 1e6, 1)
                if self.alloc_lat else 0.0,
                "alloc_p99_us": round(_pct(self.alloc_lat, 0.99) * 1e6, 1)
                if self.alloc_lat else 0.0,
                "large_attempted": self.probed,
                "large_admitted": self.admitted,
                "large_admission_rate": round(
                    self.admitted / self.probed, 4)
                if self.probed else 0.0,
                "end_utilization": audit["utilization"],
                "fragmentation_mean": round(sum(frags) / len(frags), 4)
                if frags else 0.0,
                "fragmentation_max": max(frags) if frags else 0.0,
                "fragmentation_gauge_exported":
                    "gpu_dra_allocator_fragmentation{" in exposition,
                "cache": {
                    "usage_hits": int(m.cache_hits_total.value(
                        cache="usage")),
                    "usage_misses": int(m.cache_misses_total.value(
                        cache="usage")),
                    "evictions_counted":
                        "gpu_dra_allocator_cache_evictions_total"
                        in exposition,
                },
                "outcomes": {
                    "success": int(m.allocations_total.value(
                        outcome="success")),
                    "fragmented": int(m.allocations_total.value(
                        outcome="fragmented")),
                    "unsatisfiable": int(m.allocations_total.value(
                        outcome="unsatisfiable")),
                },
                "overlap_audit": audit,
                "errors": self.errors[:10],
                "error_count": len(self.errors),
            }

    ff_arm = _Arm(STRATEGY_FIRST_FIT)
    bf_arm = _Arm(STRATEGY_BEST_FIT)
    for i in range(len(tape)):
        ff_arm.step(i)
        bf_arm.step(i)
    first_fit = ff_arm.finish()
    best_fit = bf_arm.finish()
    client, alloc, metrics = bf_arm.client, bf_arm.alloc, bf_arm.metrics

    out: dict[str, Any] = {
        "n_nodes": n_nodes,
        "total_slices": total_slices,
        "n_claims": n_claims,
        "seed": seed,
        "target_util": target_util,
        "first_fit": first_fit,
        "best_fit": best_fit,
        "throughput_ratio": round(
            best_fit["allocs_per_sec_trimmed"]
            / first_fit["allocs_per_sec_trimmed"], 3)
        if first_fit["allocs_per_sec_trimmed"] else 0.0,
        "admission_ratio": round(
            best_fit["large_admission_rate"]
            / first_fit["large_admission_rate"], 3)
        if first_fit["large_admission_rate"]
        else (999.0 if best_fit["large_admission_rate"] else 0.0),
        "errors": first_fit["errors"] + best_fit["errors"],
        "error_count": first_fit["error_count"] + best_fit["error_count"],
        "leaks": {},
    }

    if not defrag:
        return out

    # ---- defrag leg (best-fit arm's end state) ----------------------------
    # The reallocator, the planner and the unblock probes below all
    # coordinate through the shared allocator's own reentrant mutex.
    realloc = ClaimReallocator(client, allocator=alloc).start()
    planner = DefragPlanner(
        client, alloc, max_evictions_per_claim=max_evictions_per_claim,
        events=EventRecorder(client, "defrag-planner"))
    fleet_metrics = FleetMetrics()
    scraper = FleetScraper(
        targets=[("allocator", "mem://allocator")],
        metrics=fleet_metrics,
        fetch=lambda _n, _u: metrics.registry.expose_text())
    telemetry = FleetTelemetry(scraper=scraper, interval_s=3600.0,
                               rule_window_s=1.0, metrics=fleet_metrics)
    engine = slolib.SloEngine(
        telemetry.rules,
        slos=(slolib.allocation_admission_slo(),),
        windows=(slolib.BurnWindow(slolib.SEVERITY_TICKET, 0.4, 1.6, 1.0),),
        events=EventRecorder(client, "fleetwatch"),
        metrics=slolib.SloMetrics())
    telemetry.slo_engine = engine
    attach_defrag_planner(engine, planner)

    # Fragmentation pressure: small claims placed by an external naive
    # scheduler (status.allocation written directly, the harness playing
    # the scheduler) — one 1g.10gb pin inside every still-free GPU, so
    # whole-GPU admission is blocked by PLACEMENT, not capacity. These
    # pins are exactly the movable small claims the planner migrates.
    pins = 0
    for _round in range(total_slices):
        idx = alloc._slice_index()
        _s, _c, _a, _d, masks = alloc._usage()
        target = None
        for pool in sorted(idx.geometry):
            geo = idx.geometry[pool]
            pm = masks.get(pool, 0)
            for g in geo.boxes.values():
                if g.volume == large_slices and not g.mask & pm:
                    unit = next(
                        (cb for cb in geo.boxes.values()
                         if cb.volume == 1 and cb.mask & g.mask),
                        None)
                    if unit is not None:
                        target = (pool, unit.name)
                        break
            if target:
                break
        if target is None:
            break
        name = f"as-pin-{pins}"
        pinned = client.create(new_object(
            "ResourceClaim", name, "default",
            api_version="resource.k8s.io/v1",
            spec=_claim_spec(small_class)))
        pinned.setdefault("status", {})["allocation"] = {
            "devices": {"results": [{
                "request": "r", "driver": DRIVER_NAME,
                "pool": target[0], "device": target[1]}]}}
        client.update_status(pinned)
        pins += 1

    probes = []
    for p in range(defrag_probes):
        name = f"as-defrag-{p}"
        client.create(new_object(
            "ResourceClaim", name, "default",
            api_version="resource.k8s.io/v1",
            spec=_claim_spec(large_class)))
        probes.append(name)

    prev_plan = faultpoints.active_plan()
    defrag_errors: list = []
    unblocked: set = set()
    alert_fired = False
    restarted = False
    realloc_done = realloc_fail = 0
    t0 = time.monotonic()
    try:
        if faults:
            faultpoints.activate(faultpoints.FaultPlan(faults,
                                                       seed=fault_seed))
        while (len(unblocked) < len(probes)
               and time.monotonic() - t0 < defrag_timeout_s):
            for name in probes:
                if name in unblocked:
                    continue
                try:
                    alloc.allocate(client.get("ResourceClaim", name,
                                              "default"))
                    unblocked.add(name)
                except AllocationError:
                    pass
                except Exception as e:  # noqa: BLE001 — injected/
                    # transient API faults retry next round.
                    if not faultpoints.is_injected(e):
                        defrag_errors.append((name, repr(e)))
            # One telemetry tick: scrape the allocator registry, ring the
            # fragmented/total counters, evaluate the SLO — a FIRED
            # transition calls the subscribed planner on this thread,
            # and maybe_plan() retries while the alert stays firing (a
            # pass that lost victims to injected API faults must not
            # wait for a fresh alert edge).
            telemetry.tick()
            planner.maybe_plan()
            alert_fired = alert_fired or any(
                tr.transition == "fired" for tr in engine.transitions())
            if (realloc_restart and not restarted
                    and planner.preempted > 0):
                # Crash-simulate the reallocator mid-preemption: the
                # drain annotation is the durable work queue; the
                # replacement must pick every victim back up via its
                # initial informer LIST.
                realloc_done += realloc.reallocated
                realloc_fail += realloc.failed
                realloc.stop()
                realloc = ClaimReallocator(
                    client, allocator=alloc).start()
                restarted = True
            time.sleep(0.05)
    finally:
        faultpoints.deactivate()

    # Quiesce fault-free: keep planning/retrying until annotations
    # resolve and every probe had a clean shot, then audit.
    settle_deadline = time.monotonic() + 6.0
    while time.monotonic() < settle_deadline:
        planner.plan_once()
        for name in probes:
            if name in unblocked:
                continue
            try:
                alloc.allocate(client.get("ResourceClaim", name,
                                          "default"))
                unblocked.add(name)
            except AllocationError:
                pass
            except Exception as e:  # noqa: BLE001 — audited
                defrag_errors.append((name, repr(e)))
        pending_anns = [
            c["metadata"]["name"] for c in client.list("ResourceClaim")
            if ANN_DRAIN in (c["metadata"].get("annotations") or {})]
        if not pending_anns and len(unblocked) == len(probes):
            break
        time.sleep(0.05)
    realloc_done += realloc.reallocated
    realloc_fail += realloc.failed
    realloc.stop()

    leaks: dict[str, Any] = {}
    unresolved = [
        c["metadata"]["name"] for c in client.list("ResourceClaim")
        if ANN_DRAIN in (c["metadata"].get("annotations") or {})]
    if unresolved:
        leaks["unresolved_drain_annotations"] = unresolved
    audit = overlap_audit(client, alloc)
    if audit["overcommitted"]:
        leaks["overcommitted_counters"] = audit["overcommitted_samples"]
    # Every preempted victim must be terminal: re-bound (has an
    # allocation) or cleanly failed (drain-failed annotation).
    stuck = []
    preempted_names = {v for h in planner.hints() for v in h["victims"]}
    for full in preempted_names:
        ns, _, vn = full.partition("/")
        c = client.try_get("ResourceClaim", vn, ns)
        if c is None:
            continue  # released + deleted by churn — terminal enough
        anns = c["metadata"].get("annotations") or {}
        has_alloc = bool((c.get("status") or {}).get("allocation"))
        if not has_alloc and ANN_DRAIN_FAILED not in anns:
            stuck.append(full)
    out["defrag"] = {
        "pins": pins,
        "probes": len(probes),
        "unblocked": len(unblocked),
        "alert_fired": alert_fired,
        # The per-pool gauge must surface in the FLEET aggregate the
        # scrape loop re-serves (the gpu_dra_fleet_* mirror contract).
        "fleet_fragmentation_visible":
            "gpu_dra_fleet_allocator_fragmentation"
            in telemetry.aggregator.families(),
        "planner": {"planned": planner.planned,
                    "preempted": planner.preempted,
                    "skipped": planner.skipped},
        "hints": planner.hints()[:5],
        "max_evictions_per_claim": max_evictions_per_claim,
        "eviction_bound_held": all(
            n <= max_evictions_per_claim
            for n in planner._spent.values()) if planner._spent else True,
        "reallocated": realloc_done,
        "realloc_failed": realloc_fail,
        "realloc_restarted": restarted,
        "stuck_victims": stuck,
        "seconds": round(time.monotonic() - t0, 3),
        "errors": defrag_errors[:10],
        "error_count": len(defrag_errors),
    }
    out["leaks"] = leaks
    out["error_count"] += len(defrag_errors)
    out["errors"] = (out["errors"] + defrag_errors)[:20]
    if prev_plan is not None:
        faultpoints.activate(prev_plan)
    return out


# --------------------------------------------------------------------------
# Wire-path tail latency: claim → Ready over HTTP under status churn
# --------------------------------------------------------------------------


def wire_path_world(client, profile: str = "h100-8") -> None:
    """The wire-path world: the ``gpu.nvidia.com`` class, ``node-0`` and
    its whole GPUs of a mock ``profile`` node published directly with
    their memory-slice counters (no driver stack: the harness measures
    the wire path, not prepare)."""
    from k8s_dra_driver_tpu_torch.gpulib.device_lib import MockDeviceLib
    from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
    from k8s_dra_driver_tpu_torch.kubeletplugin.helper import Helper
    from k8s_dra_driver_tpu_torch.kubeletplugin.types import (
        DriverResources,
        Pool,
        Slice,
    )
    from k8s_dra_driver_tpu_torch.plugins.gpu_kubelet_plugin import (
        partitions,
    )

    client.create(new_object(
        "DeviceClass", DRIVER_NAME,
        spec={"selectors": [{"cel": {
            "expression": "device.attributes['type'] == 'gpu'"}}]}))
    client.create(new_object("Node", "node-0"))
    gpus = MockDeviceLib(profile, host_index=0).enumerate_gpus()
    devices = [partitions.full_gpu_device(g, with_counters=True)
               for g in gpus]
    Helper(client, DRIVER_NAME, "node-0",
           _StubPlugin()).publish_resources(DriverResources(
               pools={"node-0": Pool(slices=[Slice(
                   devices=devices,
                   shared_counters=[
                       partitions.memory_slice_counter_set(gpus)])])}))


class WireContenders:
    """The control-plane load the wire-path harness rides on, over one
    store: ``status_writers`` threads each churning ``update_status``
    over ``writer_objects`` claims of their own, a ``ClaimReallocator``
    watching the store, a reader polling ``fragmentation_report`` (an
    ``Allocator.mutex`` consumer), and a bounded watch (``max_queue=4``)
    that is NEVER read — the stalled-watcher probe, whose overflow must
    be counted, never silent. :meth:`stop` ends them and returns the
    first errors they met."""

    def __init__(self, client, alloc, tag: str, status_writers: int = 3,
                 writer_objects: int = 6, namespace: str = "default"):
        from k8s_dra_driver_tpu_torch.k8sclient.client import new_object
        from k8s_dra_driver_tpu_torch.kubeletplugin.remediation import (
            ClaimReallocator,
        )

        self.client = client
        self.alloc = alloc
        self.tag = tag
        self.namespace = namespace
        self.writer_objects = writer_objects
        self.errors: list = []
        self.stop_all = threading.Event()
        self.stalled = client.watch("ResourceClaim", namespace=namespace,
                                    max_queue=4)
        for w in range(status_writers):
            for j in range(writer_objects):
                client.create(new_object(
                    "ResourceClaim", f"wp-load-{tag}-{w}-{j}", namespace,
                    api_version="resource.k8s.io/v1",
                    spec=_claim_spec(DRIVER_NAME, "gpu")))
        self._threads = [threading.Thread(target=self._writer, args=(w,),
                                          daemon=True)
                         for w in range(status_writers)]
        self._threads.append(threading.Thread(target=self._reader,
                                              daemon=True))
        for t in self._threads:
            t.start()
        self.realloc = ClaimReallocator(client, allocator=alloc).start()

    def _writer(self, w: int) -> None:
        tick = 0
        while not self.stop_all.is_set():
            tick += 1
            name = f"wp-load-{self.tag}-{w}-{tick % self.writer_objects}"
            try:
                o = self.client.get("ResourceClaim", name, self.namespace)
                o.setdefault("status", {})["writerTick"] = tick
                self.client.update_status(o)
            except Exception as e:  # noqa: BLE001 — audited
                self.errors.append((name, repr(e)))
                return
            # Production-shaped churn: a kubelet stack's status writes are
            # tens per second per writer, not thousands — saturating the
            # GIL would measure interpreter starvation, not the wire path.
            time.sleep(0.005)

    def _reader(self) -> None:
        while not self.stop_all.is_set():
            try:
                self.alloc.fragmentation_report(update_gauge=False)
            except Exception as e:  # noqa: BLE001 — audited
                self.errors.append(("fragmentation_report", repr(e)))
                return
            time.sleep(0.01)

    def stop(self) -> list:
        self.stop_all.set()
        self.realloc.stop()
        for t in self._threads:
            t.join(timeout=5.0)
        self.stalled.stop()
        return self.errors


def run_wire_path(
    cycles: int = 160,
    status_writers: int = 3,
    writer_objects: int = 6,
    contention_burst_s: float = 0.5,
    profile: str = "h100-8",
) -> dict:
    """Claim→ready latency THROUGH THE HTTP PATH under status churn, by
    the interleaved-arm methodology: two arms stepped alternately in one
    window —

    - ``baseline``: ``FakeClient(fanout_copy=True, coalesce_status=False)``
      — one deep copy per event, one lock round-trip per status write;
    - ``optimized``: the defaults (copy-free fan-out, group-committed
      status writes, per-object wire-bytes memo on the LIST path).

    Each arm is its own store behind its own in-process ``ApiServer``,
    seeded with :func:`wire_path_world` (the whole GPUs of a mock
    ``profile`` node). Each step times HTTP create → in-process allocate
    → the MODIFIED event (with allocation status) arriving on an HTTP
    watch. The whole run rides on :class:`WireContenders` (status writers,
    a reallocator, a ``fragmentation_report`` reader, and a never-read
    ``max_queue=4`` watch whose overflow must be counted).

    Before the arms, a short baseline-shaped churn burst runs with lock
    profiling enabled and the ranked ``lock_contention_snapshot`` rows
    are returned as ``contention_before``. The arms run with the
    interpreter's switch interval at 0.5 ms, restored on exit.

    Returns per-arm latency distributions, wire-path counter snapshots
    (fan-out copies/event, coalesce batches, wire-memo hits, backpressure
    drops), encoder fallback counts, and leak/overcommit audits; derived:
    ``p99_over_p50`` (optimized arm), ``copies_halved`` (optimized copies
    per event at most half the baseline's) and ``backpressure_counted``
    (the stalled watch was disconnected and counted in both arms)."""
    import statistics
    import sys

    from k8s_dra_driver_tpu_torch.k8sclient import FakeClient, wirecodec
    from k8s_dra_driver_tpu_torch.k8sclient.client import (
        NotFoundError,
        new_object,
    )
    from k8s_dra_driver_tpu_torch.k8sclient.httpapi import (
        ApiServer,
        HttpClient,
        HttpWatch,
    )
    from k8s_dra_driver_tpu_torch.kubeletplugin import (
        AllocationError,
        Allocator,
    )

    def dist(xs: list[float]) -> dict:
        return {
            "ops": len(xs),
            "p50_ms": round(statistics.median(xs) * 1e3, 3) if xs else 0.0,
            "p90_ms": round(_pct(xs, 0.90) * 1e3, 3),
            "p99_ms": round(_pct(xs, 0.99) * 1e3, 3),
            "max_ms": round(max(xs) * 1e3, 3) if xs else 0.0,
        }

    def claim_spec() -> dict:
        return _claim_spec(DRIVER_NAME, "gpu")

    # ---- contention before-picture (baseline-shaped, profiled burst) ----
    # Instrumented locks are minted only while profiling is ON, so the
    # flag flips BEFORE the burst world is built.
    sanitizer.set_lock_profiling(True)
    sanitizer.reset_lock_contention()
    try:
        bc = FakeClient(fanout_copy=True, coalesce_status=False)
        wire_path_world(bc, profile)
        balloc = Allocator(bc)
        burst_stop = threading.Event()
        burst_errors: list = []

        def burst(w: int) -> None:
            i = 0
            while not burst_stop.is_set():
                i += 1
                name = f"wp-burst-{w}-{i}"
                try:
                    claim = bc.create(new_object(
                        "ResourceClaim", name, "default",
                        api_version="resource.k8s.io/v1",
                        spec=claim_spec()))
                    try:
                        got = balloc.allocate(claim, node="node-0")
                    except AllocationError:
                        bc.delete("ResourceClaim", name, "default")
                        continue
                    balloc.release(got)
                    bc.delete("ResourceClaim", name, "default")
                except Exception as e:  # noqa: BLE001 — audited
                    burst_errors.append((name, repr(e)))
        burst_threads = [threading.Thread(target=burst, args=(w,),
                                          daemon=True) for w in range(4)]
        for t in burst_threads:
            t.start()
        time.sleep(contention_burst_s)
        burst_stop.set()
        for t in burst_threads:
            t.join(timeout=5.0)
        contention_before = sanitizer.lock_contention_snapshot()[:12]
    finally:
        sanitizer.set_lock_profiling(False)
        sanitizer.reset_lock_contention()

    wirecodec.reset_fallback_counts()

    # ---- interleaved arms -------------------------------------------------
    class _Arm:
        def __init__(self, name: str, fanout_copy: bool, coalesce: bool):
            self.name = name
            self.client = FakeClient(fanout_copy=fanout_copy,
                                     coalesce_status=coalesce)
            wire_path_world(self.client, profile)
            self.alloc = Allocator(self.client)
            self.server = ApiServer(self.client).start()
            self.hc = HttpClient(self.server.endpoint)
            self.lat: list[float] = []
            self.seg: dict[str, list[float]] = {
                "create": [], "allocate": [], "watch": []}
            self.errors: list = []
            self._ready_mu = threading.Lock()
            self._ready: dict[str, threading.Event] = {}
            self.stop_all = threading.Event()
            # The measurement watcher: claim→ready is observed where a
            # real consumer observes it — on the HTTP watch stream.
            self.watch = HttpWatch(self.server.endpoint, "ResourceClaim",
                                   "default")
            self._consumer = threading.Thread(target=self._consume,
                                              daemon=True)
            self._consumer.start()
            self.contenders = WireContenders(
                self.client, self.alloc, name,
                status_writers=status_writers,
                writer_objects=writer_objects)

        def _consume(self) -> None:
            while not self.stop_all.is_set():
                ev = self.watch.next(timeout=0.2)
                if ev is None:
                    continue
                obj = ev.object
                if not ((obj.get("status") or {}).get("allocation")):
                    continue
                with self._ready_mu:
                    done = self._ready.pop(
                        obj["metadata"].get("name", ""), None)
                if done is not None:
                    done.set()

        def step(self, i: int) -> None:
            name = f"wp-{self.name}-{i}"
            done = threading.Event()
            with self._ready_mu:
                self._ready[name] = done
            allocated = None
            try:
                t0 = time.perf_counter()
                claim = self.hc.create(new_object(
                    "ResourceClaim", name, "default",
                    api_version="resource.k8s.io/v1", spec=claim_spec()))
                t1 = time.perf_counter()
                allocated = self.alloc.allocate(claim, node="node-0")
                t2 = time.perf_counter()
                if done.wait(timeout=10.0):
                    t3 = time.perf_counter()
                    self.lat.append(t3 - t0)
                    self.seg["create"].append(t1 - t0)
                    self.seg["allocate"].append(t2 - t1)
                    self.seg["watch"].append(t3 - t2)
                else:
                    self.errors.append(
                        (name, "never became ready on the HTTP watch"))
            except Exception as e:  # noqa: BLE001 — audited
                self.errors.append((name, repr(e)))
            finally:
                with self._ready_mu:
                    self._ready.pop(name, None)
                # Cleanup rides OUTSIDE the timed window.
                try:
                    if allocated is not None:
                        self.alloc.release(allocated)
                    self.hc.delete("ResourceClaim", name, "default")
                except NotFoundError:
                    pass
                except Exception as e:  # noqa: BLE001 — audited
                    self.errors.append((name, "cleanup: " + repr(e)))

        def finish(self) -> dict:
            self.stop_all.set()
            self.errors.extend(self.contenders.stop())
            self._consumer.join(timeout=5.0)
            self.watch.stop()
            self.server.stop()
            snap = self.client.wire_path_snapshot()
            leaked = [c["metadata"]["name"]
                      for c in self.client.list("ResourceClaim")
                      if c["metadata"]["name"].startswith(
                          f"wp-{self.name}-")]
            copies_per_event = round(
                snap["fanout_copies"] / snap["fanout_events"], 4) \
                if snap["fanout_events"] else 0.0
            audit = _counter_audit(self.client, self.alloc)
            return {
                "claim_ready_http": dist(self.lat),
                "segments": {k: dist(v) for k, v in self.seg.items()},
                "wire_path": snap,
                "copies_per_event": copies_per_event,
                "stalled_watch_dropped": self.contenders.stalled.dropped,
                "leaked_claims": leaked,
                "overcommit": {
                    "overcommitted": audit["overcommitted"],
                    "overcommitted_samples":
                        audit["overcommitted_samples"]},
                "errors": self.errors[:10],
                "error_count": len(self.errors),
            }

    base = _Arm("base", fanout_copy=True, coalesce=False)
    opt = _Arm("opt", fanout_copy=False, coalesce=True)
    # The interpreter's default 5 ms GIL switch interval quantizes every
    # cross-thread hand-off (client → handler → client is two of them,
    # watch delivery three) to multiples of 5 ms under load. The plugin
    # mains pin a sub-millisecond interval; the harness pins it over the
    # measured window and restores the caller's value on exit.
    prev_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        for i in range(cycles):
            base.step(i)
            opt.step(i)
    finally:
        sys.setswitchinterval(prev_switch)
        baseline = base.finish()
        optimized = opt.finish()

    out: dict[str, Any] = {
        "cycles": cycles,
        "status_writers": status_writers,
        "contention_before": contention_before,
        "contention_burst_errors": burst_errors[:5],
        "baseline": baseline,
        "optimized": optimized,
        "encoder_fallbacks": wirecodec.fallback_counts(),
        "errors": (baseline["errors"] + optimized["errors"])[:10],
        "error_count": (baseline["error_count"]
                        + optimized["error_count"]),
    }
    p = optimized["claim_ready_http"]
    out["p99_over_p50"] = round(p["p99_ms"] / p["p50_ms"], 2) \
        if p["p50_ms"] else 0.0
    out["copies_halved"] = (
        optimized["copies_per_event"]
        <= baseline["copies_per_event"] / 2.0)
    # The stalled watcher MUST have been disconnected and counted on
    # both arms — backpressure is load-bearing, not best-effort.
    out["backpressure_counted"] = all(
        a["wire_path"]["overflow_disconnects"] >= 1
        and a["wire_path"]["dropped_events"] >= 1
        and a["stalled_watch_dropped"] >= 1
        for a in (baseline, optimized))
    return out
