"""Path placeholder utilities (the port's own copy).

Job files are portable across nodes with a shared filesystem by using the
``%BASE%`` placeholder, resolved per-worker against its base directory
(reference: worker/src/utilities.rs:5-37).
"""

from __future__ import annotations

import os
from pathlib import Path

BASE_PLACEHOLDER = "%BASE%"


def parse_with_tilde_support(path: str) -> Path:
    """Expand a leading ``~`` using the HOME environment variable."""
    if path == "~" or path.startswith("~/") or path.startswith("~\\"):
        home = os.environ.get("HOME")
        if not home:
            raise ValueError("Cannot expand '~': HOME is not set.")
        return Path(home) / path[2:] if len(path) > 1 else Path(home)
    return Path(path)


def parse_with_base_directory_prefix(path: str, base_directory: Path | str | None) -> Path:
    """Resolve the %BASE% placeholder against the worker's base directory."""
    if path.startswith(BASE_PLACEHOLDER):
        if base_directory is None:
            raise ValueError(f"Path {path!r} uses %BASE% but no base directory was provided.")
        remainder = path[len(BASE_PLACEHOLDER):].lstrip("/\\")
        return Path(base_directory) / remainder
    return parse_with_tilde_support(path)
