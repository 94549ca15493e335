"""Atomic publish of node-local state files (CDI specs).

Every state file is published with write-tmp → ``os.replace``: after a
process crash at any instruction, readers see either the old file or the
new one, never a mixture. A per-write ``fsync`` additionally protects
against power loss; it is off by default because the CDI specs it guards
are re-derivable (a torn spec is deleted and the claim's prepare rewrites
it), and on network filesystems it costs milliseconds per call.
``GPU_DRA_CHECKPOINT_FSYNC=1`` turns it on for every publish.
"""

from __future__ import annotations

import os
from typing import IO, Callable, Optional, Union

ENV_CHECKPOINT_FSYNC = "GPU_DRA_CHECKPOINT_FSYNC"


def fsync_enabled(environ: Optional[dict] = None) -> bool:
    env = os.environ if environ is None else environ
    return env.get(ENV_CHECKPOINT_FSYNC, "").strip().lower() in (
        "1", "true", "on", "always")


def atomic_publish(
    path: Union[str, os.PathLike],
    data: Union[str, bytes, Callable[[IO], None]],
    *,
    tmp: Union[str, os.PathLike, None] = None,
    sync: Optional[bool] = None,
    before_replace: Optional[Callable[[str], None]] = None,
) -> tuple[int, int, int]:
    """Publish ``data`` to ``path`` with the write-tmp → ``os.replace``
    protocol; torn bytes can only ever land in the ``.tmp``.

    ``data``: a str/bytes payload, or a writer callback taking the open
    file. ``tmp``: override the temporary path (default ``<path>.tmp``).
    ``sync``: fsync the tmp before publishing; ``None`` follows
    ``GPU_DRA_CHECKPOINT_FSYNC``. ``before_replace`` runs after the tmp is
    written and before the rename.

    Returns the published file's ``(st_ino, st_size, st_mtime_ns)``, taken
    from the open tmp fd (a rename keeps the inode)."""
    path = os.fspath(path)
    tmp = f"{path}.tmp" if tmp is None else os.fspath(tmp)
    mode = "wb" if isinstance(data, bytes) else "w"
    with open(tmp, mode) as f:
        if callable(data):
            data(f)
        else:
            f.write(data)
        f.flush()
        if fsync_enabled() if sync is None else sync:
            os.fsync(f.fileno())
        st = os.fstat(f.fileno())
        sig = (st.st_ino, st.st_size, st.st_mtime_ns)
    if before_replace is not None:
        before_replace(tmp)
    os.replace(tmp, path)
    return sig
