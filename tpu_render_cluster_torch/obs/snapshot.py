"""Atomic JSON metrics snapshots (the port's own copy).

``write_metrics_snapshot`` serialises a registry, plus caller-supplied
extras, atomically (tmp + fsync + replace) so a reader never sees a torn
JSON document. The worker entry writes one at exit. The reference's
periodic ``SnapshotWriter`` belongs to its master.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any

from tpu_render_cluster_torch.obs.registry import MetricsRegistry

__all__ = ["write_metrics_snapshot"]


def write_metrics_snapshot(
    path: str | Path,
    registry: MetricsRegistry,
    *,
    extra: dict[str, Any] | None = None,
) -> Path:
    """Write one atomic snapshot: ``{written_at, metrics, **extra}``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload: dict[str, Any] = {
        "written_at": time.time(),
        "metrics": registry.snapshot(),
    }
    if extra:
        payload.update(extra)
    tmp = path.with_suffix(path.suffix + ".tmp")
    # flush + fsync BEFORE the atomic rename: os.replace is atomic against
    # concurrent readers, but without the fsync a crash (or SIGKILL) after
    # the rename can still leave a truncated/empty file once the page cache
    # is lost — the rename must only ever publish fully-durable bytes.
    with open(tmp, "w", encoding="utf-8") as handle:
        handle.write(json.dumps(payload, indent=2))
        handle.flush()
        os.fsync(handle.fileno())
    os.replace(tmp, path)
    return path

