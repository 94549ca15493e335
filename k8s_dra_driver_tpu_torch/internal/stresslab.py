"""Stress harness: tenant replicas through the claim path, and the soak.

The pieces of the JAX package's ``internal/stresslab.py`` that the serving
smoke and the self-healing soak need:

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
            errors.append(("quiesce", "remediation pipeline never went "
                           f"idle within {quiesce_timeout_s}s: "
                           f"taints={[d.device_taints() for d in gpu_drivers]} "
                           f"drains={[d.active_devices() for d in drainers]} "
                           f"realloc_pending={realloc_box['r'].pending_count()} "
                           + (f"killed={sorted(killed)} cordoned="
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
            try:
                with _urlreq.urlopen(
                        f"http://127.0.0.1:{bb_debug_server.port}"
                        "/debug/incidents", timeout=5.0) as resp:
                    served = _json.loads(resp.read().decode())
                if not isinstance(served, list):
                    served = [served]
                for rec in served:
                    latest = rec.get("latest") or {}
                    if (latest.get("status") == "resolved"
                            and not audit_timeline_chain(
                                latest.get("timeline") or [])):
                        http_complete += 1
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
                               "timeline completeness oracle"))
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
