"""Retryable-vs-permanent error taxonomy.

Analogue of the reference's ``permanentError`` wrapper
(``cmd/compute-domain-kubelet-plugin/driver.go:73-80``): by default every
error in a prepare/unprepare path is retried (with backoff) until the
per-request deadline; errors marked permanent short-circuit the retries and
fail the request immediately.
"""

from __future__ import annotations


class PermanentError(Exception):
    """An error that must NOT be retried.

    Wrap a causal exception via ``PermanentError(str(e))`` with ``raise ...
    from e``, or raise directly with a message. ``is_permanent`` also walks
    ``__cause__``/``__context__`` so a PermanentError buried under a generic
    re-raise is still honored.
    """


class StaleAbortedClaimError(PermanentError):
    """A prepare retried the exact claim version whose prepare was aborted
    (drained/rolled back) — re-preparing would resurrect state onto the
    devices the abort freed (docs/self-healing.md).

    A distinct type so the claim watcher can tell this apart from other
    permanent failures: when the CURRENT allocation legitimately matches
    the drained version (the reallocator re-picked the repaired device)
    and no drain is pending, the watcher resolves the tombstone and
    re-prepares instead of retrying forever."""


def is_permanent(err: BaseException) -> bool:
    seen: set[int] = set()
    cur: BaseException | None = err
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, PermanentError):
            return True
        seen.add(id(cur))
        cur = cur.__cause__ or cur.__context__
    return False
