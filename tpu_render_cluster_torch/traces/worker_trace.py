"""Worker-side trace models (the port's own copy).

JSON schema is byte-compatible with the reference so the analysis suite
parses the traces unchanged: every timestamp serialises as fractional unix
seconds (reference: shared/src/results/worker_trace.rs:12-147; parsed by
analysis/core/models.py:46-131).
"""

from __future__ import annotations

import threading
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


@dataclass(frozen=True)
class WorkerFrameTrace:
    """A rendered frame's index + phase details (worker_trace.rs:48-63)."""

    frame_index: int
    details: FrameRenderTime

    def to_dict(self) -> dict[str, Any]:
        return {"frame_index": self.frame_index, "details": self.details.to_dict()}

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "WorkerFrameTrace":
        return cls(
            frame_index=int(data["frame_index"]),
            details=FrameRenderTime.from_dict(data["details"]),
        )


@dataclass(frozen=True)
class WorkerPingTrace:
    """Heartbeat RTT sample (worker_trace.rs:65-82)."""

    pinged_at: float
    received_at: float

    def to_dict(self) -> dict[str, float]:
        return {"pinged_at": self.pinged_at, "received_at": self.received_at}

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "WorkerPingTrace":
        return cls(pinged_at=float(data["pinged_at"]), received_at=float(data["received_at"]))


@dataclass(frozen=True)
class WorkerReconnectionTrace:
    """A connection-loss window (worker_trace.rs:84-100)."""

    lost_connection_at: float
    reconnected_at: float

    def to_dict(self) -> dict[str, float]:
        return {
            "lost_connection_at": self.lost_connection_at,
            "reconnected_at": self.reconnected_at,
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "WorkerReconnectionTrace":
        return cls(
            lost_connection_at=float(data["lost_connection_at"]),
            reconnected_at=float(data["reconnected_at"]),
        )


@dataclass(frozen=True)
class WorkerTrace:
    """Aggregate worker trace, carried by ``response_job-finished``.

    Reference: shared/src/results/worker_trace.rs:103-126.
    """

    total_queued_frames: int
    total_queued_frames_removed_from_queue: int
    job_start_time: float
    job_finish_time: float
    frame_render_traces: list[WorkerFrameTrace]
    ping_traces: list[WorkerPingTrace]
    reconnection_traces: list[WorkerReconnectionTrace]

    def to_dict(self) -> dict[str, Any]:
        return {
            "total_queued_frames": self.total_queued_frames,
            "total_queued_frames_removed_from_queue": self.total_queued_frames_removed_from_queue,
            "job_start_time": self.job_start_time,
            "job_finish_time": self.job_finish_time,
            "frame_render_traces": [t.to_dict() for t in self.frame_render_traces],
            "ping_traces": [t.to_dict() for t in self.ping_traces],
            "reconnection_traces": [t.to_dict() for t in self.reconnection_traces],
        }

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "WorkerTrace":
        return cls(
            total_queued_frames=int(data["total_queued_frames"]),
            total_queued_frames_removed_from_queue=int(
                data["total_queued_frames_removed_from_queue"]
            ),
            job_start_time=float(data["job_start_time"]),
            job_finish_time=float(data["job_finish_time"]),
            frame_render_traces=[
                WorkerFrameTrace.from_dict(t) for t in data["frame_render_traces"]
            ],
            ping_traces=[WorkerPingTrace.from_dict(t) for t in data["ping_traces"]],
            reconnection_traces=[
                WorkerReconnectionTrace.from_dict(t) for t in data["reconnection_traces"]
            ],
        )


class WorkerTraceBuilder:
    """Thread-safe incremental trace collector.

    A single builder instance is threaded through the worker's runner, queue,
    heartbeat responder, and client (reference:
    shared/src/results/worker_trace.rs:149-237). ``build`` refuses
    incomplete traces (missing start/finish), matching the reference's
    builder semantics (worker_trace.rs:165-181).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._total_queued_frames = 0
        self._total_removed = 0
        self._job_start_time: float | None = None
        self._job_finish_time: float | None = None
        self._frame_render_traces: list[WorkerFrameTrace] = []
        self._ping_traces: list[WorkerPingTrace] = []
        self._reconnection_traces: list[WorkerReconnectionTrace] = []

    def trace_new_rendered_frame(self, frame_index: int, timing: FrameRenderTime) -> None:
        with self._lock:
            self._frame_render_traces.append(WorkerFrameTrace(frame_index, timing))

    def trace_new_ping(self, pinged_at: float, received_at: float) -> None:
        with self._lock:
            self._ping_traces.append(WorkerPingTrace(pinged_at, received_at))

    def trace_new_reconnect(self, lost_connection_at: float, reconnected_at: float) -> None:
        with self._lock:
            self._reconnection_traces.append(
                WorkerReconnectionTrace(lost_connection_at, reconnected_at)
            )

    def increment_total_queued_frames(self) -> None:
        with self._lock:
            self._total_queued_frames += 1

    def increment_total_frames_removed_from_queue(self) -> None:
        with self._lock:
            self._total_removed += 1

    def set_job_start_time(self, ts: float) -> None:
        with self._lock:
            self._job_start_time = ts

    def ensure_job_start_time(self, ts: float) -> None:
        """Stamp the start time only if no job-started event ever did —
        the close-out path of a worker that served an idle master (a
        drained shard with zero jobs) must still produce a buildable
        trace without clobbering a real job's start."""
        with self._lock:
            if self._job_start_time is None:
                self._job_start_time = ts

    def set_job_finish_time(self, ts: float) -> None:
        with self._lock:
            self._job_finish_time = ts

    def build(self) -> WorkerTrace:
        with self._lock:
            if self._job_start_time is None:
                raise ValueError("Cannot build trace: job start time was never set.")
            if self._job_finish_time is None:
                raise ValueError("Cannot build trace: job finish time was never set.")
            return WorkerTrace(
                total_queued_frames=self._total_queued_frames,
                total_queued_frames_removed_from_queue=self._total_removed,
                job_start_time=self._job_start_time,
                job_finish_time=self._job_finish_time,
                frame_render_traces=list(self._frame_render_traces),
                ping_traces=list(self._ping_traces),
                reconnection_traces=list(self._reconnection_traces),
            )
