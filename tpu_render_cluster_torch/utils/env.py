"""``TRC_*`` environment overrides that the port reads (its own copy).

The port keeps the reference's names and defaults for the knobs its copied
modules read: the reconnect budget (``transport/reconnect.py``), the
event-loop lag probe (``obs/loopmon.py``), the log filter
(``utils/logging.py``), the BVH tiers that ``integrator.resolve_bvh_config``
resolves (``render/mesh.py``, ``render/kernels.py``), the TLAS tiers that
``integrator.resolve_tlas_config`` resolves (``render/kernels.py``) and the
ray pool's window and width (``render/raypool.py``). Values are read at call time, not import time, so a
long-lived process and a test that patches ``os.environ`` both see the
current value. Reference: ``tpu_render_cluster/utils/env.py``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class EnvVar:
    """One declared ``TRC_*`` knob (name, value grammar, one-line doc)."""

    name: str
    kind: str  # "int" | "float" | "flag" | "spec"
    default: object
    doc: str


ENV_VARS: dict[str, EnvVar] = {}


def declare(name: str, kind: str, default: object, doc: str) -> None:
    """Register one variable; a duplicate declaration is an error."""
    if name in ENV_VARS:
        raise ValueError(f"duplicate env declaration: {name}")
    ENV_VARS[name] = EnvVar(name, kind, default, doc)


# -- transport / reconnect ---------------------------------------------------
declare("TRC_BACKOFF_BASE", "float", 2.0, "Full-jitter reconnect backoff base")
declare("TRC_BACKOFF_CAP_SECONDS", "float", 30.0, "Reconnect backoff sleep cap")
declare("TRC_MAX_CONNECT_RETRIES", "int", 12, "Connect attempts before giving up")
declare("TRC_MAX_RECONNECTS_PER_OP", "int", 2, "Reconnects one logical op may absorb")
declare("TRC_OP_DEADLINE_SECONDS", "float", 30.0, "Per-op reconnect deadline")
# -- observability -----------------------------------------------------------
declare("TRC_OBS_LOOPMON_INTERVAL", "float", 0.25, "Event-loop lag probe interval")
declare("TRC_OBS_LOOPMON_THRESHOLD", "float", 0.1, "Loop lag that counts as a blocked episode")
# -- render tiers ------------------------------------------------------------
declare("TRC_RAYPOOL_FRAMES", "int", 8, "Frames per compiled pool window")
declare("TRC_RAYPOOL_WIDTH", "int", None, "Ray-pool width (default: one frame, block-rounded)")
declare("TRC_TLAS", "flag", 1, "Two-level (TLAS) mesh traversal on/off")
declare("TRC_TLAS_LEAF", "int", 4, "Instances per TLAS leaf (clamped 1..16)")
declare("TRC_TLAS_BLOCK", "int", 256, "Ray-block width of the TLAS kernel variants")
declare("TRC_BVH_QUANT", "int", 0, "Quantized BVH/TLAS node tier: 0 off, 1 16-bit, 2 8-bit slabs (+ packed carried ray state)")
declare("TRC_BVH_BUILDER", "spec", "sah", "BLAS build strategy: sah (binned) | median")
declare("TRC_BVH_WIDE", "int", 4, "BLAS branching factor after wide collapse (1 = binary, clamped 1..8)")
# -- logging -----------------------------------------------------------------
declare("TRC_LOG", "spec", None, "Log level/filter (RUST_LOG grammar; RUST_LOG also accepted)")


def env_float(name: str, default: float) -> float:
    """``float(os.environ[name])`` with a logged fallback on bad values."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("Ignoring non-numeric %s=%r; using %s", name, raw, default)
        return default


def env_int(name: str, default: int) -> int:
    """``int(os.environ[name])`` with a logged fallback on bad values."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("Ignoring non-integer %s=%r; using %s", name, raw, default)
        return default


def env_str(name: str, default: str | None = None) -> str | None:
    """Raw string value, or ``default`` when unset (``""`` is returned as is)."""
    raw = os.environ.get(name)
    return default if raw is None else raw
