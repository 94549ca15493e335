"""Serving harness: tenant replicas that bind engines through the claim path.

The two pieces of the JAX package's ``internal/stresslab.py`` that the
serving smoke (``make serve-smoke``'s contract) needs: :class:`ServingReplica`
and :func:`run_serving_smoke`. A session creates a ResourceClaim, has it
allocated and prepared by the GPU kubelet plugin through the claim watcher,
reads the claim's CDI spec back and binds a ``ServingEngine`` to the GPUs
it names, serves a burst through the decode kernel, then drains and tears
the claim down; the smoke audits that nothing is left behind.

Runs on the card unless the caller asks for the CPU (``device="cpu"``),
where the engine uses the decode kernel's plain version and the node is
the ``h100-8`` mock.
"""

from __future__ import annotations

import tempfile
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


def _serving_warmup(engine_kwargs: dict, device: torch.device) -> None:
    """One decode-attention call at the engines' shapes, outside any
    session deadline: on the card it builds (at first use) and loads the
    decode kernel, so no session pays for that."""
    mb = engine_kwargs.get("max_batch", 8)
    h = engine_kwargs.get("heads", 2)
    d = engine_kwargs.get("head_dim", 8)
    cap = engine_kwargs.get("kv_cap", 64)
    q = torch.zeros((mb, h, 1, d), dtype=torch.float32, device=device)
    kv = torch.zeros((mb, h, cap, d), dtype=torch.float32, device=device)
    flash_attention_decode(q, kv, kv, torch.ones((mb,), dtype=torch.int32,
                                                 device=device)).cpu()


class ServingReplica:
    """One tenant replica's bounded serve sessions through the claim path —
    the JAX package's replica, binding GPUs (its session loop, for the
    scale and soak harnesses, waits).

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
    (``None``: the card the spec names)."""

    def __init__(self, name: str, tenant: str, client, allocator,
                 node: str, metrics, cdi_lookup,
                 gpus_per_claim: int = 1, serve_s: float = 0.4,
                 deadline_s: float = 1.5, namespace: str = "default",
                 device_class: str = DRIVER_NAME,
                 selectors: tuple[str, ...] = (),
                 requests_per_burst: int = 32, prompt_tokens: int = 8,
                 max_new_tokens: int = 8,
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
        self.kv_isolation_max_err = 0.0
        self.history: Any = deque(maxlen=512)

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
