"""Traffic: one general generator, driven by a mix's data file.

A mix (``perfbench/traffic/<name>.json``) names its ``kind`` and the
parameters the generator reads:

- ``backlog``: a closed backlog. The harness keeps at least ``queued_min``
  requests waiting in the engine's queue, so no slot ever waits for work;
  requests are taken from the stream in order.
- ``poisson``: an open loop. Requests are due on a schedule, ``rate_per_s``
  on average with exponential gaps, whether or not earlier ones finished.

Both take ``tenants`` (how many, each its own isolation bucket, in turn),
and ``prompt`` and ``output`` lengths, each one of
``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
``{"dist": "uniform", "min", "max"}``.

Every seed gets the same work in another order: each block of ``block``
requests takes the block's stratified quantiles, ``(i + 0.5) / block``, of
each distribution (prompt, output, gap), and the seed permutes each of the
three on its own. So a seed changes the order and pairing of the sizes and
gaps, never their set.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List, Optional

import numpy as np

_STD_NORMAL = NormalDist()


@dataclass(frozen=True)
class Request:
    """One generated request; ``due_s`` is its offset from the start of the
    window in an open loop (None in a backlog)."""
    rid: str
    tenant: str
    prompt_tokens: int
    max_new_tokens: int
    due_s: Optional[float] = None


def tenant_bucket(tenant: str) -> int:
    """The serving engine's isolation bucket of a tenant: crc32 of the name
    modulo 16 (its documented watermark convention)."""
    return zlib.crc32(tenant.encode()) % 16


def tenant_value(tenant: str) -> float:
    """The constant that every KV row of the tenant holds, and so the value
    of every row it decodes: 1 + 0.5 times its bucket."""
    return 1.0 + 0.5 * tenant_bucket(tenant)


def tenant_names(n: int) -> List[str]:
    """``n`` tenant names ``tenant-a``, ``tenant-b``, ... each in a bucket of
    its own (names whose bucket is taken are skipped); at most 16."""
    if not 1 <= n <= 16:
        raise ValueError(f"tenants must be 1 to 16, got {n}")
    names, used = [], set()
    i = 0
    while len(names) < n:
        name = "tenant-" + _letters(i)
        i += 1
        if tenant_bucket(name) not in used:
            used.add(tenant_bucket(name))
            names.append(name)
    return names


def _letters(i: int) -> str:
    s = ""
    while True:
        s = chr(ord("a") + i % 26) + s
        i = i // 26 - 1
        if i < 0:
            return s


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of a length distribution, as whole
    numbers of at least 1, in increasing order."""
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "uniform":
        lo, hi = spec["min"], spec["max"]
        x = lo + np.floor(u * (hi - lo + 1))
    elif dist == "lognormal":
        z = np.array([_STD_NORMAL.inv_cdf(p) for p in u])
        x = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
        x = np.clip(x, spec["min"], spec["max"])
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.maximum(x, 1).astype(np.int64)


def unit_gaps(n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of an exponential gap of mean 1."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u)


def _rng(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, purpose])


def _check_backlog(mix: dict) -> None:
    if int(mix["queued_min"]) < 1:
        raise ValueError("queued_min must be at least 1")


def _check_poisson(mix: dict) -> None:
    if float(mix["rate_per_s"]) <= 0:
        raise ValueError("rate_per_s must be positive")


#: The mix kinds, each with the check of its own parameters.
KINDS = {"backlog": _check_backlog, "poisson": _check_poisson}


def check_mix(mix: dict) -> None:
    """Raise ValueError on a mix the generator cannot run."""
    if mix.get("kind") not in KINDS:
        raise ValueError(f"mix kind {mix.get('kind')!r}: want one of "
                         f"{tuple(KINDS)}")
    for key in ("prompt", "output"):
        quantiles(mix[key], 2)
    tenant_names(int(mix.get("tenants", 1)))
    KINDS[mix["kind"]](mix)


def _blocks(mix: dict, seed: int, purpose: int, block: int):
    """Endless (prompt, output, unit gap) triples, block by block."""
    rng = _rng(seed, purpose)
    prompts = quantiles(mix["prompt"], block)
    outputs = quantiles(mix["output"], block)
    gaps = unit_gaps(block)
    while True:
        for p, o, g in zip(rng.permutation(prompts), rng.permutation(outputs),
                           rng.permutation(gaps)):
            yield int(p), int(o), float(g)


def stream(mix: dict, seed: int, prefix: str = "r") -> Iterator[Request]:
    """The mix's endless request stream for ``seed``: tenants in turn; in
    an open loop each request carries its due offset in seconds."""
    check_mix(mix)
    tenants = tenant_names(int(mix.get("tenants", 1)))
    block = int(mix.get("block", 256))
    rate = float(mix["rate_per_s"]) if mix["kind"] == "poisson" else None
    unit_t = 0.0
    for i, (p, o, g) in enumerate(_blocks(mix, seed, 1, block)):
        due = None
        if rate is not None:
            unit_t += g
            due = unit_t / rate
        yield Request(f"{prefix}{i}", tenants[i % len(tenants)], p, o, due)


def arrivals(mix: dict, seed: int, seconds: float,
             prefix: str = "r") -> List[Request]:
    """The open loop's requests due in the first ``seconds`` of a window."""
    out = []
    for r in stream(mix, seed, prefix):
        if r.due_s >= seconds:
            return out
        out.append(r)
    return out


def warmup(mix: dict, seed: int, n: int, prefix: str = "w") -> List[Request]:
    """``n`` requests of the mix's sizes (one block of ``n`` quantiles,
    permuted by the seed) to warm an engine with before an open loop."""
    tenants = tenant_names(int(mix.get("tenants", 1)))
    blocks = _blocks(mix, seed, 2, n)
    return [Request(f"{prefix}{i}", tenants[i % len(tenants)], p, o)
            for i, (p, o, _) in zip(range(n), blocks)]
