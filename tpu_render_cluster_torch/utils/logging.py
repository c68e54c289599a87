"""Console + optional file logging initialisation (the port's own copy).

Mirrors the reference's tracing-subscriber setup: console layer with an
env-var level filter plus an optional non-blocking file layer
(reference: shared/src/logging.rs:39-96). The env filter variable is
``TRC_LOG`` (the reference uses ``RUST_LOG``); both are honoured.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

from tpu_render_cluster_torch.utils.env import env_str

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"


def _env_level(default: str = "info") -> int:
    raw = env_str("TRC_LOG") or os.environ.get("RUST_LOG") or default
    # The global level is the first directive WITHOUT a module prefix
    # (e.g. "tungstenite=warn,info" -> "info"); per-module filters are ignored.
    level = default
    for directive in raw.split(","):
        directive = directive.strip().lower()
        if directive and "=" not in directive:
            level = directive
            break
    return _LEVELS.get(level, logging.INFO)


def initialize_console_and_file_logging(
    log_file_path: str | Path | None = None,
    *,
    console_level: int | None = None,
) -> logging.Logger:
    """Set up the root logger with a console handler and optional file handler.

    Returns the root logger (the reference returns a flush guard; Python's
    logging flushes on process exit, so no guard is needed).
    """
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    # Re-initialisation replaces handlers (tests call this repeatedly).
    for handler in list(root.handlers):
        root.removeHandler(handler)

    console = logging.StreamHandler(sys.stderr)
    console.setLevel(console_level if console_level is not None else _env_level())
    console.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(console)

    if log_file_path is not None:
        path = Path(log_file_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        file_handler = logging.FileHandler(path, encoding="utf-8")
        file_handler.setLevel(logging.DEBUG)
        file_handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(file_handler)

    return root

