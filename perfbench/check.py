"""The comparison that decides ``correct``.

Four numbers, each against its limit (the configuration's ``checks``):

- ``unanswered``: requests due in the window that the engine accepted and
  never completed by the time the harness stopped waiting (limit 0). A
  refused request is an answer (it counts as failed, not as wrong).
- ``unaccounted``: the engine's submitted, completed, shed and rejected
  counts against the harness's own tally of what it sent and what became
  of each request, plus requests left with no outcome (limit 0).
- ``rows_err``: the engine's decoded rows against the reference's. Every
  KV row of a tenant holds the tenant's constant, so attention over them,
  at any length, is that constant, and so is every row decoded from them
  (an altered row shifts every later row of its request). Read: the last
  row of every completed request, and every K and V row of each slot's
  last occupant where the engine's slabs (``_K``, ``_V``) are there to
  read; as the largest gap over the constant, relative to it.
- ``attn_err``: the decode attention the window drove (the engine's
  ``attend``), at the slab's shape and at the lengths the engine attended
  when the window closed, on K, V and q drawn from the seed, against the
  plain reference (``reference.decode_attention``): the largest gap over
  the largest reference value. The constant rows above cannot tell a
  lower precision from the stated one; random rows can.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import numpy as np
import torch

from perfbench import generate, reference
from perfbench.record import Sent

NUMBERS = ("unanswered", "unaccounted", "rows_err", "attn_err")


def unanswered(sent: Iterable[Sent]) -> int:
    return sum(1 for s in sent
               if s.in_window and not s.rejected and not s.completed)


def unaccounted(engine, sent: List[Sent]) -> int:
    """How far the engine's counts are from the harness's tally."""
    mine = {"submitted": len(sent),
            "completed": sum(1 for s in sent if s.completed),
            "rejected": sum(1 for s in sent if s.rejected),
            "shed": sum(1 for s in sent if not s.rejected and getattr(
                s.req, "outcome", None) == "shed")}
    gap = sum(abs(getattr(engine, k) - v) for k, v in mine.items())
    no_outcome = sum(1 for s in sent if not s.rejected
                     and getattr(s.req, "outcome", None) is None)
    return gap + no_outcome


def _rel(x, c: float) -> float:
    err = float(x) / c
    return err if math.isfinite(err) else math.inf


def rows_error(engine, sent: List[Sent]) -> float:
    """The largest gap of a decoded row over its tenant's constant,
    relative to the constant (see the module docstring)."""
    worst = 0.0
    last = {}
    for s in sent:
        r = s.req
        if r.admit_t is not None and r.slot is not None and (
                r.slot not in last or r.admit_t >= last[r.slot].admit_t):
            last[r.slot] = r
        if not s.completed:
            continue
        c = generate.tenant_value(r.tenant)
        row = r.last_output
        if row is None:
            return math.inf
        worst = max(worst, _rel(np.abs(np.asarray(row, np.float64)
                                       - c).max(), c))
    K, V = getattr(engine, "_K", None), getattr(engine, "_V", None)
    if not isinstance(K, torch.Tensor) or not isinstance(V, torch.Tensor):
        return worst
    with torch.no_grad():
        for slot, r in last.items():
            if r.outcome != "completed" or r.kv_len < 1:
                continue
            c = generate.tenant_value(r.tenant)
            for slab in (K, V):
                rows = slab[slot, :, :r.kv_len]
                worst = max(worst, _rel((rows - c).abs().amax().item(), c))
    return worst


def kernel_error(attend: Callable, shape: tuple, dtype: torch.dtype,
                 device: torch.device, lens: torch.Tensor,
                 seed: int) -> float:
    """``attend`` on K, V and q drawn from ``seed`` (a device generator,
    in the slab's shape and dtype) at ``lens``, against the reference: the
    largest gap over the largest reference value."""
    b, h, cap, d = shape
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    with torch.no_grad():
        k = torch.empty(shape, dtype=dtype, device=device).normal_(
            generator=g)
        v = torch.empty(shape, dtype=dtype, device=device).normal_(
            generator=g)
        q = torch.empty((b, h, 1, d), dtype=torch.float32,
                        device=device).normal_(generator=g)
        lens = torch.clamp(lens.to(device=device, dtype=torch.int32),
                           min=1, max=cap).contiguous()
        out = attend(q, k, v, lens)
        ref = reference.decode_attention(q, k, v, lens)
        gap = (out.double() - ref.double()).abs().max().item()
        scale = ref.double().abs().max().item()
        del k, v, q, out, ref
    return _rel(gap, scale)


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit, in NUMBERS order;
    correct when every number is finite and within its limit."""
    checks = {}
    ok = True
    for name in NUMBERS:
        value = numbers.get(name)
        limit = limits.get(name, 0)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if value is None
                        or math.isfinite(value) else str(value),
                        "limit": limit}
    return ok, checks


def lens_at(engine, sent: List[Sent], max_batch: int) -> torch.Tensor:
    """The lengths the engine attends in its next step: its ``_lens`` where
    it keeps them, else each slot's latest occupant's length."""
    lens = getattr(engine, "_lens", None)
    if isinstance(lens, torch.Tensor):
        return lens.clone()
    out = [0] * max_batch
    seen: dict = {}
    for s in sent:
        r = s.req
        if r.slot is not None and r.admit_t is not None and (
                r.slot not in seen or r.admit_t >= seen[r.slot]):
            seen[r.slot] = r.admit_t
            out[r.slot] = r.kv_len
    return torch.tensor(out, dtype=torch.int32)
