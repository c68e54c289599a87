"""Worker-side per-frame phase timing (the port's own copy).

JSON schema is byte-compatible with the reference so the analysis suite
parses the traces unchanged: every timestamp serialises as fractional unix
seconds (reference: shared/src/results/worker_trace.rs:12-147).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class FrameRenderTime:
    """The 7-point per-frame phase timing.

    Reference: shared/src/results/worker_trace.rs:13-34. Timestamps are
    fractional unix seconds.
    """

    started_process_at: float
    finished_loading_at: float
    started_rendering_at: float
    finished_rendering_at: float
    file_saving_started_at: float
    file_saving_finished_at: float
    exited_process_at: float

    def total_execution_time(self) -> float:
        duration = self.exited_process_at - self.started_process_at
        if duration < 0:
            raise ValueError("Total execution time is negative?!")
        return duration

    def to_dict(self) -> dict[str, float]:
        return {
            "started_process_at": self.started_process_at,
            "finished_loading_at": self.finished_loading_at,
            "started_rendering_at": self.started_rendering_at,
            "finished_rendering_at": self.finished_rendering_at,
            "file_saving_started_at": self.file_saving_started_at,
            "file_saving_finished_at": self.file_saving_finished_at,
            "exited_process_at": self.exited_process_at,
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "FrameRenderTime":
        return cls(
            started_process_at=float(data["started_process_at"]),
            finished_loading_at=float(data["finished_loading_at"]),
            started_rendering_at=float(data["started_rendering_at"]),
            finished_rendering_at=float(data["finished_rendering_at"]),
            file_saving_started_at=float(data["file_saving_started_at"]),
            file_saving_finished_at=float(data["file_saving_finished_at"]),
            exited_process_at=float(data["exited_process_at"]),
        )
