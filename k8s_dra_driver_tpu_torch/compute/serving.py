"""Serving dataplane on a GPU: continuous-batched decode on claimed devices.

The engine a tenant's replica binds to once its claim is prepared: the
claim's CDI spec names the visible devices (``CUDA_VISIBLE_DEVICES``),
:func:`bind_engine` sizes a :class:`ServingEngine` to them, and the engine
serves a request stream with continuous batching — requests join and
leave the running batch every step instead of waiting for a full batch to
drain. Behaviour is the JAX package's engine, step for step:

- **Bounded, counted admission**: the queue has a hard cap; an
  overflowing submit is REJECTED and counted, never silently dropped.
- **Per-step token budget sized to the visible devices**: each step
  spends at most ``tokens_per_chip_step × n_chips`` tokens, decode first
  (one token per in-flight request, round-robin), the remainder feeding
  chunked prefill.
- **Slot-isolated KV state**: every admitted request owns one KV-cache
  slot for its lifetime and attends only its own rows (ragged lengths
  masked in the kernel). Each tenant's rows are seeded with its constant
  vector, and a softmax-weighted average of identical rows reproduces the
  constant, so any cross-slot read shows up as ``kv_isolation_max_err``.
- **Accounting identity**: ``submitted == completed + shed + rejected``
  after drain; nothing exits uncounted.

What differs from the JAX engine is where the state lives. The K/V slabs
and lengths are tensors resident on ``device`` (the GPU unless the caller
asks for the CPU); a step writes only the rows that change (the prefill
chunk and the decoded row) instead of uploading the whole slab, reduces
the isolation error on the device, and copies the step's decoded rows to
the host once. The attend defaults to ``flash_attention_decode``: the CUDA
kernel on the GPU, its plain version on CPU tensors. The modeled pacing
sleep stays; a large ``modeled_chip_tok_s`` makes it nil, so that the
device sets the pace.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from k8s_dra_driver_tpu_torch.compute._device import _resolve_device
from k8s_dra_driver_tpu_torch.compute.flashattention import (
    flash_attention_decode,
)
from k8s_dra_driver_tpu_torch.pkg import sanitizer
from k8s_dra_driver_tpu_torch.pkg.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    exponential_buckets,
)

#: request outcomes — every submitted request ends in exactly one.
OUTCOME_COMPLETED = "completed"
OUTCOME_SHED = "shed"
OUTCOME_REJECTED = "rejected"

#: replica serve-session outcomes (``claim_attempts_total``'s label)
CLAIM_OK = "ok"
CLAIM_ERROR = "error"


class ServingMetrics:
    """The serving dataplane's families: the JAX package's
    ``tpu_dra_serving_*`` families, with the same labels and buckets, named
    ``gpu_dra_serving_*``."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.requests_total = r.register(Counter(
            "gpu_dra_serving_requests_total",
            "Decode requests by tenant and outcome (completed / shed / "
            "rejected) — the admission-accounting identity's terms: "
            "submitted == completed + shed + rejected.",
            ("tenant", "outcome")))
        self.tokens_total = r.register(Counter(
            "gpu_dra_serving_tokens_total",
            "Tokens processed by tenant and kind (prefill / decode) — "
            "aggregate decode rate is the throughput-scaling signal.",
            ("tenant", "kind")))
        self.queue_depth = r.register(Gauge(
            "gpu_dra_serving_queue_depth",
            "Requests waiting in the bounded admission queue, per "
            "tenant (bounded by the queue cap; overflow is rejected "
            "and counted, never silently buffered).",
            ("tenant",)))
        self.batch_size = r.register(Histogram(
            "gpu_dra_serving_batch_size",
            "Requests active in one engine step (prefill + decode) — "
            "the continuous-batching occupancy distribution.",
            exponential_buckets(1, 2, 8)))
        self.ttft_seconds = r.register(Histogram(
            "gpu_dra_serving_ttft_seconds",
            "Enqueue to first decoded token, per tenant.",
            exponential_buckets(0.001, 2, 14), ("tenant",),
            exemplars=True))
        self.request_seconds = r.register(Histogram(
            "gpu_dra_serving_request_seconds",
            "Enqueue to completion, per tenant.",
            exponential_buckets(0.001, 2, 14), ("tenant",),
            exemplars=True))
        self.claim_attempts_total = r.register(Counter(
            "gpu_dra_serving_claim_attempts_total",
            "Replica serve sessions by tenant and outcome: ok when the "
            "claim reached a first decoded batch inside the deadline, "
            "error otherwise.",
            ("tenant", "outcome")))
        self.first_batch_seconds = r.register(Histogram(
            "gpu_dra_serving_first_batch_seconds",
            "Claim create to first decoded batch (time-to-first-batch), "
            "per tenant.",
            exponential_buckets(0.005, 2, 12), ("tenant",),
            exemplars=True))


_default_serving_metrics: Optional[ServingMetrics] = None


def default_serving_metrics() -> ServingMetrics:
    global _default_serving_metrics
    if _default_serving_metrics is None:
        _default_serving_metrics = ServingMetrics()
    return _default_serving_metrics


def visible_device_entries(spec: Optional[dict]) -> List[str]:
    """The ``CUDA_VISIBLE_DEVICES`` entries a CDI claim spec sets, as
    written: integer indices or ``GPU-<uuid>`` and ``MIG-<uuid>`` names.

    Scans both the claim-wide ``containerEdits`` and every per-device
    edit block; entries are ``"K=V"`` strings. Returns the unique entries
    in the order met; ``[]`` for a missing spec or the ``void``
    sentinel."""
    if not spec:
        return []
    entries: List[str] = []

    def scan(edits: Optional[dict]) -> None:
        for e in (edits or {}).get("env") or []:
            if isinstance(e, str) and e.startswith("CUDA_VISIBLE_DEVICES="):
                val = e.split("=", 1)[1]
                if val and val != "void":
                    for part in val.split(","):
                        part = part.strip()
                        if part and part not in entries:
                            entries.append(part)

    scan(spec.get("containerEdits"))
    for dev in spec.get("devices") or []:
        scan(dev.get("containerEdits"))
    return entries


def cuda_device_uuids() -> Dict[str, int]:
    """``GPU-<uuid>`` and ``MIG-<uuid>`` → torch device index, for every
    CUDA device this process sees (a MIG instance is a CUDA device of its
    own, and torch reports its UUID without the prefix). Raises without
    CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available to match GPU UUIDs "
                           "against")
    out = {}
    for i in range(torch.cuda.device_count()):
        u = str(torch.cuda.get_device_properties(i).uuid).lower()
        if u.startswith(_UUID_PREFIXES):
            out[u] = i
        else:
            out.update({f"{p}{u}": i for p in _UUID_PREFIXES})
    return out


#: The prefixes of CUDA_VISIBLE_DEVICES entries naming a device by UUID: a
#: whole GPU's and a MIG instance's.
_UUID_PREFIXES = ("gpu-", "mig-")


def parse_visible_devices(spec: Optional[dict],
                          uuids: Optional[Dict[str, int]] = None
                          ) -> List[int]:
    """Torch device indices of the GPUs a CDI claim spec makes visible
    (``CUDA_VISIBLE_DEVICES``); sorted and unique, ``[]`` for a missing
    spec or ``void``.

    An integer entry is an index already. A ``GPU-<uuid>`` or
    ``MIG-<uuid>`` entry is the index of the device with that UUID: in
    ``uuids`` (UUID → index) when the caller passes it, else among the CUDA
    devices this process sees (``torch.cuda.get_device_properties(i).uuid``),
    since the UUID, not the node's enumeration order, names the device. A
    UUID that matches no device, a UUID with neither a mapping nor CUDA to
    match it against, and any other entry raise ValueError."""
    devices: set = set()
    table: Optional[Dict[str, int]] = None
    if uuids is not None:
        table = {k.lower(): v for k, v in uuids.items()}
    for part in visible_device_entries(spec):
        if part.lstrip("-").isdigit():
            devices.add(int(part))
            continue
        if not part.lower().startswith(_UUID_PREFIXES):
            raise ValueError(f"CUDA_VISIBLE_DEVICES entry {part!r} is "
                             "neither an index nor a GPU or MIG UUID")
        if table is None:
            if not torch.cuda.is_available():
                raise ValueError(
                    f"CUDA_VISIBLE_DEVICES entry {part!r} is a GPU UUID, and "
                    "there is neither a UUID mapping nor a CUDA device to "
                    "match it against")
            table = cuda_device_uuids()
        if part.lower() not in table:
            raise ValueError(f"no device has the UUID {part!r}; known: "
                             f"{sorted(table)}")
        devices.add(table[part.lower()])
    return sorted(devices)


def tenant_vector(tenant: str, head_dim: int) -> np.ndarray:
    """The tenant's constant KV row — the isolation oracle's watermark.

    A softmax-weighted average of identical rows reproduces the row (the
    weights sum to 1), so a slot seeded entirely with its tenant's
    constant must decode to that constant; any cross-tenant KV read
    skews the output by the inter-tenant spacing (0.5 per bucket)."""
    bucket = zlib.crc32(tenant.encode()) % 16
    return np.full((head_dim,), 1.0 + 0.5 * bucket, np.float32)


@dataclass
class DecodeRequest:
    """One tenant request through the engine; the engine fills the
    runtime fields (timestamps are the engine clock — monotonic)."""
    rid: str
    tenant: str
    prompt_tokens: int
    max_new_tokens: int
    enqueue_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    outcome: Optional[str] = None
    slot: Optional[int] = None
    kv_len: int = 0
    generated: int = 0
    phase: str = "queued"        # queued -> prefill -> decode -> done
    last_output: Optional[np.ndarray] = field(default=None, repr=False)


class ServingEngine:
    """Continuous-batching decode engine for one replica's devices.

    ``n_chips`` is the number of devices the replica's CDI spec makes
    visible (:func:`parse_visible_devices`); it sizes the per-step token
    budget and the modeled device rate. ``attend`` is the batched
    decode-attention callable on ``device`` tensors (default
    ``flash_attention_decode``). ``device`` holds the KV slabs: ``None``
    is the current CUDA device and raises without one; ``"cpu"`` runs the
    engine on the CPU."""

    def __init__(self, name: str, n_chips: int,
                 metrics: Optional[ServingMetrics] = None,
                 attend: Optional[Callable] = None,
                 max_batch: int = 8, kv_cap: int = 64,
                 heads: int = 2, head_dim: int = 8,
                 tokens_per_chip_step: int = 16,
                 modeled_chip_tok_s: float = 500.0,
                 queue_cap: int = 64,
                 clock: Callable[[], float] = time.monotonic,
                 device: Union[str, torch.device, None] = None):
        if n_chips < 1:
            raise ValueError(f"engine {name}: n_chips must be >= 1, "
                             f"got {n_chips}")
        self.name = name
        self.n_chips = n_chips
        self.metrics = metrics or default_serving_metrics()
        self.attend = attend or flash_attention_decode
        self.max_batch = max_batch
        self.kv_cap = kv_cap
        self.heads = heads
        self.head_dim = head_dim
        self.step_budget = tokens_per_chip_step * n_chips
        self.modeled_tok_s = modeled_chip_tok_s * n_chips
        self.queue_cap = queue_cap
        self.clock = clock
        self.device = _resolve_device(device)

        self._mu = sanitizer.new_lock(f"ServingEngine.{name}._mu")
        self._queue: deque = deque()
        self._active: Dict[int, DecodeRequest] = {}      # slot -> request
        self._free = list(range(max_batch))
        self._rr = 0                    # decode round-robin offset
        # Slot-isolated KV slabs on the device: slot i's cache lives ONLY
        # in row i. f32, the JAX engine's dtype.
        shape = (max_batch, heads, kv_cap, head_dim)
        self._K = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._V = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self._lens = torch.zeros((max_batch,), dtype=torch.int32,
                                 device=self.device)

        self.submitted = 0
        self.completed = 0
        self.shed = 0
        self.rejected = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.steps = 0
        #: steps that decoded: one decode-attention call each
        self.decode_steps = 0
        self.kv_isolation_max_err = 0.0
        self.first_batch_t: Optional[float] = None
        self.step_log: deque = deque(maxlen=4096)
        self._draining = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._queue_depth: Dict[str, int] = {}

    # -- admission ---------------------------------------------------------

    def submit(self, req: DecodeRequest) -> bool:
        """Admit a request to the bounded queue. False == rejected, and
        the rejection is already counted — callers never re-count."""
        m = self.metrics
        with self._mu:
            self.submitted += 1
            if self._draining or self._stop.is_set() \
                    or len(self._queue) >= self.queue_cap:
                self.rejected += 1
                m.requests_total.inc(tenant=req.tenant,
                                     outcome=OUTCOME_REJECTED)
                return False
            req.enqueue_t = self.clock()
            req.phase = "queued"
            self._queue.append(req)
            d = self._queue_depth
            d[req.tenant] = d.get(req.tenant, 0) + 1
            m.queue_depth.set(d[req.tenant], tenant=req.tenant)
        return True

    def queue_depth(self) -> int:
        with self._mu:
            return len(self._queue)

    # -- engine loop -------------------------------------------------------

    def start(self) -> "ServingEngine":
        self._thread = threading.Thread(
            target=self._run, name=f"serving-{self.name}", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            spent = self.step()
            if spent:
                time.sleep(spent / self.modeled_tok_s)
            else:
                # Idle: nothing queued or active. Nap a step quantum so
                # the loop doesn't spin a core while starved.
                time.sleep(self.step_budget / self.modeled_tok_s)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def step(self) -> int:
        """One continuous-batching step; returns tokens spent (<= budget).

        Split into a locked assembly phase (admission + budget split),
        an unlocked attend (slots touched this step cannot be reassigned
        because only this thread completes requests), and a locked
        commit. Device writes under the lock are enqueued, not waited
        for; the step waits for the device once, when it copies the
        decoded rows to the host."""
        now = self.clock()
        m = self.metrics
        with self._mu:
            while self._free and self._queue:
                req = self._queue.popleft()
                d = self._queue_depth
                d[req.tenant] = max(0, d.get(req.tenant, 0) - 1)
                m.queue_depth.set(d[req.tenant], tenant=req.tenant)
                slot = self._free.pop()
                req.slot = slot
                req.admit_t = now
                req.phase = "prefill"
                self._lens[slot] = 0
                self._active[slot] = req

            budget = self.step_budget
            decoding = [s for s, r in sorted(self._active.items())
                        if r.phase == "decode"]
            # Decode first — latency of in-flight requests beats new
            # admissions — round-robin rotated so a budget smaller than
            # the decode set starves nobody across steps.
            if decoding:
                k = self._rr % len(decoding)
                decoding = decoding[k:] + decoding[:k]
            decode_slots = decoding[:budget]
            self._rr += 1
            budget -= len(decode_slots)
            prefill_plan = []                    # (slot, chunk)
            for slot, req in sorted(self._active.items()):
                if budget <= 0:
                    break
                if req.phase != "prefill":
                    continue
                chunk = min(budget, req.prompt_tokens - req.kv_len)
                if chunk > 0:
                    prefill_plan.append((slot, chunk))
                    budget -= chunk
            batch_reqs = len(decode_slots) + len(prefill_plan)

        if not decode_slots and not prefill_plan:
            return 0

        # Prefill: seed the chunk's rows with the tenant's constant KV —
        # under _mu, because the slab cursors are shared with the locked
        # assembly phase.
        pf_tokens = 0
        with self._mu:
            for slot, chunk in prefill_plan:
                req = self._active[slot]
                vec = self._to_device(tenant_vector(req.tenant,
                                                    self.head_dim))
                lo = req.kv_len
                self._K[slot, :, lo:lo + chunk, :] = vec
                self._V[slot, :, lo:lo + chunk, :] = vec
                req.kv_len += chunk
                self._lens[slot] = req.kv_len
                pf_tokens += chunk
                m.tokens_total.inc(chunk, tenant=req.tenant,
                                   kind="prefill")
                if req.kv_len >= req.prompt_tokens:
                    req.phase = "decode"

        # Decode: one batched attend over the whole slab (fixed shapes);
        # only this step's decode slots commit output.
        dc_tokens = 0
        if decode_slots:
            n = len(decode_slots)
            vecs = np.stack([tenant_vector(self._active[s].tenant,
                                           self.head_dim)
                             for s in decode_slots])          # [n, d]
            q = np.zeros((self.max_batch, self.heads, 1, self.head_dim),
                         np.float32)
            q[decode_slots, :, 0, :] = vecs[:, None, :]
            out = self.attend(self._to_device(q), self._K, self._V,
                              torch.clamp(self._lens, min=1))
            slots_t = torch.tensor(decode_slots, device=self.device)
            vecs_t = self._to_device(vecs)
            rows = out[slots_t, :, 0, :]                      # [n, h, d]
            err_t = (rows - vecs_t[:, None, :]).abs().amax()
            # The step's one device-to-host copy: the error, then the rows.
            host = torch.cat((err_t.reshape(1), rows.reshape(-1))).cpu()
            host = host.numpy()
            err = float(host[0])
            rows_np = host[1:].reshape(n, self.heads, self.head_dim)
            t_tok = self.clock()
            with self._mu:
                if err > self.kv_isolation_max_err:
                    self.kv_isolation_max_err = err
                grow, grow_pos = [], []
                for i, slot in enumerate(decode_slots):
                    req = self._active[slot]
                    if req.kv_len < self.kv_cap:
                        grow.append(i)
                        grow_pos.append(req.kv_len)
                        req.kv_len += 1
                    req.generated += 1
                    req.last_output = rows_np[i]
                    dc_tokens += 1
                    m.tokens_total.inc(tenant=req.tenant, kind="decode")
                    if req.first_token_t is None:
                        req.first_token_t = t_tok
                        m.ttft_seconds.observe(t_tok - req.enqueue_t,
                                               tenant=req.tenant)
                if grow:
                    # Append each decoded row at its slot's cursor: K gets
                    # the tenant's vector, V the decoded row.
                    gi = torch.tensor(grow, device=self.device)
                    s = slots_t[gi]
                    pos = torch.tensor(grow_pos, device=self.device)
                    self._K[s, :, pos, :] = vecs_t[gi][:, None, :].expand(
                        -1, self.heads, -1)
                    self._V[s, :, pos, :] = rows[gi]
                    self._lens[s] = (pos + 1).to(torch.int32)
                if self.first_batch_t is None:
                    self.first_batch_t = t_tok

        with self._mu:
            done_t = self.clock()
            for slot in decode_slots:
                req = self._active.get(slot)
                if req is None:
                    continue
                if req.generated >= req.max_new_tokens \
                        or req.kv_len >= self.kv_cap:
                    req.phase = "done"
                    req.done_t = done_t
                    req.outcome = OUTCOME_COMPLETED
                    self.completed += 1
                    m.requests_total.inc(tenant=req.tenant,
                                         outcome=OUTCOME_COMPLETED)
                    m.request_seconds.observe(done_t - req.enqueue_t,
                                              tenant=req.tenant)
                    del self._active[slot]
                    self._free.append(slot)
            self.prefill_tokens += pf_tokens
            self.decode_tokens += dc_tokens
            self.steps += 1
            if decode_slots:
                self.decode_steps += 1
            self.step_log.append({
                "step": self.steps,
                "prefill_tokens": pf_tokens,
                "decode_tokens": dc_tokens,
                "tokens": pf_tokens + dc_tokens,
                "budget": self.step_budget,
                "batch": batch_reqs,
                "tenants": sorted({r.tenant
                                   for r in self._active.values()}),
            })
        m.batch_size.observe(batch_reqs)
        return pf_tokens + dc_tokens

    # -- teardown ----------------------------------------------------------

    def drain(self, timeout: float = 5.0) -> dict:
        """Stop admission, let in-flight requests finish until the
        deadline, count everything still unfinished as shed. The
        accounting identity holds on return."""
        m = self.metrics
        with self._mu:
            self._draining = True
        deadline = self.clock() + timeout
        while self.clock() < deadline:
            with self._mu:
                if not self._active and not self._queue:
                    break
            time.sleep(0.002)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._mu:
            leftovers = list(self._queue) + list(self._active.values())
            self._queue.clear()
            self._active.clear()
            self._free = list(range(self.max_batch))
            for req in leftovers:
                req.phase = "done"
                req.outcome = OUTCOME_SHED
                self.shed += 1
                m.requests_total.inc(tenant=req.tenant, outcome=OUTCOME_SHED)
            for tenant in list(self._queue_depth):
                self._queue_depth[tenant] = 0
                m.queue_depth.set(0, tenant=tenant)
            summary = {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "rejected": self.rejected,
                "prefill_tokens": self.prefill_tokens,
                "decode_tokens": self.decode_tokens,
                "accounted": (self.completed + self.shed + self.rejected
                              == self.submitted),
            }
        return summary

    def stop(self) -> None:
        """Hard stop (error paths). Equivalent to an instant drain, so
        nothing escapes the accounting identity."""
        self.drain(timeout=0.0)


def kv_state_from_numpy(engine: ServingEngine, K: np.ndarray, V: np.ndarray,
                        lens: np.ndarray) -> None:
    """Load KV slabs held as numpy arrays (a JAX engine's ``_K``, ``_V``
    and ``_lens``) into ``engine``'s device slabs. The system has no
    weights; the slabs are its state, and this carries them across. Shapes
    must match the engine's."""
    for what, src, dst in (("K", K, engine._K), ("V", V, engine._V),
                           ("lens", lens, engine._lens)):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: shape {tuple(src.shape)} != engine's "
                             f"{tuple(dst.shape)}")
    with engine._mu:
        engine._K.copy_(torch.from_numpy(np.asarray(K, np.float32)))
        engine._V.copy_(torch.from_numpy(np.asarray(V, np.float32)))
        engine._lens.copy_(torch.from_numpy(np.asarray(lens, np.int32)))


def bind_engine(spec: Optional[dict], name: str,
                device: Union[str, torch.device, None] = None,
                uuids: Optional[Dict[str, int]] = None,
                **engine_kwargs) -> ServingEngine:
    """The engine for a prepared claim: one device per GPU or MIG instance
    its CDI ``spec`` makes visible (:func:`parse_visible_devices`, ``uuids`` as
    there), with the slabs on ``cuda:<first visible index>`` unless
    ``device`` says otherwise. Raises ValueError when the spec makes no
    device visible."""
    devices = parse_visible_devices(spec, uuids)
    if not devices:
        raise ValueError(f"engine {name}: the claim's CDI spec makes no "
                         f"CUDA device visible")
    if device is None:
        device = f"cuda:{devices[0]}"
    return ServingEngine(name, n_chips=len(devices), device=device,
                         **engine_kwargs)
