"""The blessed wire-format encoder for the apiserver serve path.

The counterpart of the JAX package's ``k8sclient/wirecodec.py``, byte for
byte the same encoder: every byte the fake apiserver puts on the wire —
LIST pages, PUT/POST responses, watch frames — is produced HERE, nowhere
else, so one encoder decides the bytes the two packages' servers and
clients exchange:

- **Encode once per event.** A committed event is serialized once
  (``WatchEvent.wire`` memoizes its frame), and the same bytes go to
  every watcher that streams it.
- **Shape-specialized envelopes.** The serve path's documents are two
  fixed shapes — ``{"type": ..., "object": ...}`` watch frames and
  ``{"items": [...], "metadata": {...}}`` list pages — assembled by
  splicing pre-encoded object bytes, skipping the re-walk of every
  object tree that a whole-document ``json.dumps`` pays.

**Equivalence contract**: every function here is byte-identical to the
obvious ``json.dumps(...)`` spelling (default separators, ASCII
escapes) for JSON-shaped input. Input outside the JSON shape (non-str
keys, subclassed scalars, exotic values) takes the ``json.dumps`` slow
path, COUNTED per call site in :func:`fallback_counts` — never silent.
"""

from __future__ import annotations

import json
import threading
from json.encoder import encode_basestring_ascii as _esc
from typing import Any, Optional

__all__ = [
    "encode_doc",
    "encode_obj",
    "wire_watch_frame",
    "wire_list_page",
    "fallback_counts",
    "reset_fallback_counts",
]

#: recursion bound for the fast path — API objects are shallow trees; a
#: deeper (or cyclic) value falls back to ``json.dumps``, whose own
#: circular-reference detection produces the canonical error.
_MAX_DEPTH = 100


class _Unsupported(Exception):
    """Internal: the value is outside the fast path's JSON shape."""


# -- fallback accounting (counted, never silent) -----------------------------

_fallback_mu = threading.Lock()
_fallbacks: dict[str, int] = {}


def _count_fallback(site: str) -> None:
    with _fallback_mu:
        _fallbacks[site] = _fallbacks.get(site, 0) + 1


def fallback_counts() -> dict[str, int]:
    """Slow-path encodes per call site since the last reset."""
    with _fallback_mu:
        return dict(_fallbacks)


def reset_fallback_counts() -> None:
    with _fallback_mu:
        _fallbacks.clear()


# -- the shape-specialized fast path -----------------------------------------

def _append(out: list[str], o: Any, depth: int) -> None:
    """Append ``o``'s JSON fragments to ``out``, byte-equivalent to
    ``json.dumps(o)``. Exact-type checks on purpose: ``json.dumps``
    serializes scalar *subclasses* through their own hooks (an IntEnum's
    repr is not its int repr), so anything but the exact JSON shape
    raises :class:`_Unsupported` and the caller falls back."""
    t = o.__class__
    if o is None:
        out.append("null")
    elif t is bool:
        out.append("true" if o else "false")
    elif t is str:
        out.append(_esc(o))
    elif t is int:
        out.append(repr(o))
    elif t is float:
        # json's floatstr: repr for finite, names for the specials.
        if o != o:
            out.append("NaN")
        elif o == float("inf"):
            out.append("Infinity")
        elif o == float("-inf"):
            out.append("-Infinity")
        else:
            out.append(float.__repr__(o))
    elif t is dict:
        if depth >= _MAX_DEPTH:
            raise _Unsupported("too deep")
        out.append("{")
        first = True
        for k, v in o.items():
            if k.__class__ is not str:
                raise _Unsupported("non-str key")
            if first:
                first = False
            else:
                out.append(", ")
            out.append(_esc(k))
            out.append(": ")
            _append(out, v, depth + 1)
        out.append("}")
    elif t is list or t is tuple:
        if depth >= _MAX_DEPTH:
            raise _Unsupported("too deep")
        out.append("[")
        first = True
        for v in o:
            if first:
                first = False
            else:
                out.append(", ")
            _append(out, v, depth + 1)
        out.append("]")
    else:
        raise _Unsupported(t.__name__)


def encode_obj(obj: Any, site: str = "encode_obj") -> bytes:
    """``json.dumps(obj).encode()``, via the shape-specialized fast path.

    The fast path covers exactly the JSON shape API objects live in
    (str-keyed dicts, lists/tuples, exact-type scalars); anything else
    falls back to ``json.dumps`` itself — counted under ``site``, and
    raising exactly what ``json.dumps`` would for the unencodable."""
    out: list[str] = []
    try:
        _append(out, obj, 0)
    except _Unsupported:
        _count_fallback(site)
        return json.dumps(obj).encode()
    return "".join(out).encode()


def encode_doc(payload: Any) -> bytes:
    """General serve-path document encoder — THE one blessed spelling of
    ``json.dumps(payload).encode()`` (driverlint DL601). Response bodies
    that are not object/list/frame shaped (admission reviews, error
    docs, client request bodies) route here."""
    return encode_obj(payload, site="encode_doc")


# -- envelope splicers --------------------------------------------------------

def wire_watch_frame(etype: str, obj_bytes: bytes) -> bytes:
    """One watch frame, byte-identical to
    ``(json.dumps({"type": etype, "object": obj}) + "\\n").encode()``
    given ``obj_bytes == encode_obj(obj)`` — the object tree is spliced,
    not re-walked."""
    return b'{"type": %s, "object": %s}\n' % (_esc(etype).encode(),
                                              obj_bytes)


def wire_list_page(item_bytes: list[bytes], resource_version: str,
                   continue_token: str) -> bytes:
    """One LIST page, byte-identical to ``json.dumps({"items": [...],
    "metadata": {"resourceVersion": rv, "continue": cont}}).encode()``
    with every item spliced from its memoized bytes."""
    return (b'{"items": [' + b", ".join(item_bytes)
            + b'], "metadata": {"resourceVersion": '
            + _esc(resource_version).encode()
            + b', "continue": ' + _esc(continue_token).encode() + b"}}")


def _self_check() -> Optional[str]:
    """Cheap invariant probe used by tests: one representative of each
    envelope shape compared against its ``json.dumps`` spelling."""
    obj = {"kind": "X", "metadata": {"name": "n", "labels": {}},
           "spec": {"n": 1.5, "ok": True, "xs": [1, "α", None]}}
    ob = encode_obj(obj)
    if ob != json.dumps(obj).encode():
        return "encode_obj diverged"
    frame = wire_watch_frame("ADDED", ob)
    if frame != (json.dumps({"type": "ADDED", "object": obj})
                 + "\n").encode():
        return "wire_watch_frame diverged"
    page = wire_list_page([ob, ob], "17", "tok")
    want = json.dumps({"items": [obj, obj],
                       "metadata": {"resourceVersion": "17",
                                    "continue": "tok"}}).encode()
    if page != want:
        return "wire_list_page diverged"
    return None
