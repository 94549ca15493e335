"""Version information.

The counterpart of the JAX package's ``internal/info.py`` (itself the
analogue of the reference's ``internal/info/version.go``): a version string
from VERSION plus the git state, which every binary's ``--version`` prints.
The driver names live with their plugins (``DRIVER_NAME``,
``CD_DRIVER_NAME``).
"""

from __future__ import annotations

import os
import subprocess

VERSION = "0.1.0-dev"


def git_describe() -> str:
    """Best-effort git state for the version string (cf. internal/info/version.go)."""
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def version_string() -> str:
    return f"{VERSION}+{git_describe()}"
