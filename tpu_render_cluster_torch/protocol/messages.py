"""The 14-message job protocol (+ the goodbye drain extension); the port's own copy.

Wire format is the reference's externally-observable contract: a JSON text
frame ``{"message_type": "<tag>", "payload": {...}}`` (reference:
shared/src/messages/mod.rs:150-236) with the exact serde tags from the
reference's enum (including the asymmetric ``response_frame-queue-add`` tag,
shared/src/messages/mod.rs:171). Requests carry a random u64
``message_request_id``; responses echo it as ``message_request_context_id``
(shared/src/messages/utilities.rs:5-14, shared/src/messages/queue.rs:13-100).
``event_worker-goodbye`` is this repo's one NEW message (graceful drain);
every other extension rides as optional keys inside reference payloads —
``trace`` (causal context), the heartbeat metrics/clock fields, and
``job_id`` (the multi-job scheduler's submission id, PROTOCOL.md
§Multi-job scheduling).

Worker IDs are random u32s displayed as 8-hex
(shared/src/messages/handshake.rs:9-26).
"""

from __future__ import annotations

import json
import secrets
from dataclasses import dataclass
from typing import Any, ClassVar

from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.traces.worker_trace import WorkerTrace

# ---------------------------------------------------------------------------
# IDs

def generate_message_request_id() -> int:
    """Random u64 request id (reference: shared/src/messages/utilities.rs:11)."""
    return secrets.randbits(64)


def generate_worker_id() -> int:
    """Random u32 worker id (reference: shared/src/messages/handshake.rs:20)."""
    return secrets.randbits(32)


def generate_trace_id() -> int:
    """Random u64 trace id: one per job, shared by every frame's spans."""
    return secrets.randbits(64)


# ---------------------------------------------------------------------------
# Trace context (optional, beyond-reference)
#
# A (trace_id, span_id) pair rides protocol messages the same way the
# heartbeat metrics payload does: an OPTIONAL key that absent decodes to
# None and that reference-shaped peers (the C++ daemons) simply ignore.
# The master mints one span_id per frame ASSIGNMENT (a re-queued or stolen
# frame starts a fresh span chain) and the worker echoes the context on its
# rendering/finished events, so the two sides' Perfetto spans link up as
# flow arrows without any clock agreement.


@dataclass(frozen=True)
class TraceContext:
    """Causal link for one frame assignment: job trace id + assignment span."""

    trace_id: int
    span_id: int

    @classmethod
    def new(cls, trace_id: int) -> "TraceContext":
        return cls(trace_id=trace_id, span_id=secrets.randbits(64))

    @property
    def flow_id(self) -> str:
        """Perfetto flow-event id (string: u64s overflow JSON readers)."""
        return f"{self.span_id:016x}"

    def to_dict(self) -> dict[str, int]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "TraceContext":
        return cls(trace_id=int(data["trace_id"]), span_id=int(data["span_id"]))


def _trace_from_payload(payload: dict[str, Any]) -> TraceContext | None:
    """Decode the optional ``trace`` key (piggyback idiom: absent -> None)."""
    data = payload.get("trace")
    if data is None:
        return None
    if not isinstance(data, dict):
        raise ValueError("trace context must be an object")
    return TraceContext.from_dict(data)


def worker_id_to_string(worker_id: int) -> str:
    """Workers display as 8-hex (reference: shared/src/messages/handshake.rs:14-17)."""
    return f"{worker_id:08x}"


def _job_id_from_payload(payload: dict[str, Any]) -> str | None:
    """Decode the optional ``job_id`` key (piggyback idiom: absent -> None).

    Rides queue-add requests and their echo events when the master runs
    the multi-job scheduler (sched/), uniquely naming the job *submission*
    even across job-name reuse. Single-job masters never set it, so their
    wire traffic stays byte-identical to the reference.
    """
    job_id = payload.get("job_id")
    if job_id is None:
        return None
    if not isinstance(job_id, str):
        raise ValueError("job_id must be a string")
    return job_id


def _epoch_from_payload(payload: dict[str, Any]) -> int | None:
    """Decode the optional ``epoch`` key (piggyback idiom: absent -> None).

    The monotonic master-incarnation counter of the replicated control
    plane (PROTOCOL.md §Epoch fencing & failover): a ledger-backed master
    stamps its epoch on the handshake request and every queue-add, and
    (Python) workers echo it on their frame events, so a master that took
    over after a failover can refuse results belonging to a predecessor's
    assignments instead of silently applying them. Masters without a
    ledger never set it — their traffic stays byte-identical to the
    reference, and C++ peers route unmodified.
    """
    epoch = payload.get("epoch")
    if epoch is None:
        return None
    if isinstance(epoch, bool) or not isinstance(epoch, int):
        raise ValueError("epoch must be an integer")
    if epoch < 0:
        raise ValueError(f"epoch must be >= 0, got {epoch}")
    return epoch


def _tile_from_payload(payload: dict[str, Any]) -> int | None:
    """Decode the optional ``tile`` key (piggyback idiom: absent -> None).

    Rides queue add/remove requests and both frame-event echoes when the
    job splits frames into sub-frame tiles (PROTOCOL.md §Tile-sharded
    frames). Whole-frame jobs never set it — their traffic stays
    byte-identical to the reference, and C++ workers (which neither read
    nor echo the key) interoperate on whole-frame jobs unmodified.
    """
    tile = payload.get("tile")
    if tile is None:
        return None
    if isinstance(tile, bool) or not isinstance(tile, int):
        raise ValueError("tile must be an integer tile index")
    if tile < 0:
        raise ValueError(f"tile index must be >= 0, got {tile}")
    return tile


# ---------------------------------------------------------------------------
# Result-enum wire values

FRAME_QUEUE_ADD_RESULT_ADDED = "added-to-queue"
FRAME_QUEUE_ADD_RESULT_ERRORED = "errored"

FRAME_QUEUE_REMOVE_RESULT_REMOVED = "removed-from-queue"
FRAME_QUEUE_REMOVE_RESULT_ALREADY_RENDERING = "already-rendering"
FRAME_QUEUE_REMOVE_RESULT_ALREADY_FINISHED = "already-finished"
FRAME_QUEUE_REMOVE_RESULT_ERRORED = "errored"

FRAME_QUEUE_ITEM_FINISHED_OK = "ok"
FRAME_QUEUE_ITEM_FINISHED_ERRORED = "errored"

HANDSHAKE_TYPE_FIRST_CONNECTION = "first-connection"
HANDSHAKE_TYPE_RECONNECTING = "reconnecting"


def _result_to_dict(result: str, error_reason: str | None) -> dict[str, Any]:
    out: dict[str, Any] = {"result": result}
    if result == "errored":
        out["reason"] = error_reason or ""
    return out


def _result_from_dict(data: dict[str, Any]) -> tuple[str, str | None]:
    return str(data["result"]), data.get("reason")


# ---------------------------------------------------------------------------
# Message classes


class Message:
    """Base class; subclasses define ``type_name`` (the wire tag) and payload serde."""

    type_name: ClassVar[str]

    def to_payload(self) -> dict[str, Any]:  # pragma: no cover - overridden
        raise NotImplementedError

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "Message":  # pragma: no cover
        raise NotImplementedError


@dataclass(frozen=True)
class MasterHandshakeRequest(Message):
    """M→W (reference: shared/src/messages/handshake.rs:31-47)."""

    type_name: ClassVar[str] = "handshake_request"
    server_version: str
    # Optional master epoch (replicated control plane, piggyback idiom):
    # a reconnecting worker that sees a DIFFERENT epoch than the master it
    # lost knows it is talking to a new incarnation and re-announces as a
    # fresh session instead of replaying stale queue state into it.
    epoch: int | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {"server_version": self.server_version}
        if self.epoch is not None:
            out["epoch"] = self.epoch
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterHandshakeRequest":
        return cls(
            server_version=str(payload["server_version"]),
            epoch=_epoch_from_payload(payload),
        )


@dataclass(frozen=True)
class WorkerHandshakeResponse(Message):
    """W→M (reference: shared/src/messages/handshake.rs:66-117)."""

    type_name: ClassVar[str] = "handshake_response"
    handshake_type: str  # "first-connection" | "reconnecting"
    worker_version: str
    worker_id: int

    def to_payload(self) -> dict[str, Any]:
        return {
            "handshake_type": self.handshake_type,
            "worker_version": self.worker_version,
            "worker_id": self.worker_id,
        }

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerHandshakeResponse":
        return cls(
            handshake_type=str(payload["handshake_type"]),
            worker_version=str(payload["worker_version"]),
            worker_id=int(payload["worker_id"]),
        )


@dataclass(frozen=True)
class MasterHandshakeAcknowledgement(Message):
    """M→W (reference: shared/src/messages/handshake.rs:139-153)."""

    type_name: ClassVar[str] = "handshake_acknowledgement"
    ok: bool

    def to_payload(self) -> dict[str, Any]:
        return {"ok": self.ok}

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterHandshakeAcknowledgement":
        return cls(ok=bool(payload["ok"]))


@dataclass(frozen=True)
class MasterFrameQueueAddRequest(Message):
    """M→W: queue a frame; carries the full job (shared/src/messages/queue.rs:15-38)."""

    type_name: ClassVar[str] = "request_frame-queue_add"
    message_request_id: int
    job: BlenderJob
    frame_index: int
    # Optional causal context (beyond-reference, piggyback idiom): absent
    # on the wire decodes to None; the C++ worker ignores the extra key.
    trace: TraceContext | None = None
    # Optional scheduler job id (multi-job masters only, same idiom).
    job_id: str | None = None
    # Optional sub-frame tile index (tiled jobs only, same idiom).
    tile: int | None = None
    # Optional master epoch (ledger-backed masters only, same idiom): the
    # worker stamps its copy and echoes it on the frame's events, fencing
    # a pre-failover assignment's results out of the successor master.
    epoch: int | None = None

    @classmethod
    def new(
        cls,
        job: BlenderJob,
        frame_index: int,
        *,
        trace: TraceContext | None = None,
        job_id: str | None = None,
        tile: int | None = None,
        epoch: int | None = None,
    ) -> "MasterFrameQueueAddRequest":
        return cls(
            generate_message_request_id(), job, frame_index, trace, job_id,
            tile, epoch,
        )

    def to_payload(self) -> dict[str, Any]:
        out = {
            "message_request_id": self.message_request_id,
            "job": self.job.to_dict(),
            "frame_index": self.frame_index,
        }
        if self.trace is not None:
            out["trace"] = self.trace.to_dict()
        if self.job_id is not None:
            out["job_id"] = self.job_id
        if self.tile is not None:
            out["tile"] = self.tile
        if self.epoch is not None:
            out["epoch"] = self.epoch
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterFrameQueueAddRequest":
        return cls(
            message_request_id=int(payload["message_request_id"]),
            job=BlenderJob.from_dict(payload["job"]),
            frame_index=int(payload["frame_index"]),
            trace=_trace_from_payload(payload),
            job_id=_job_id_from_payload(payload),
            tile=_tile_from_payload(payload),
            epoch=_epoch_from_payload(payload),
        )


@dataclass(frozen=True)
class WorkerFrameQueueAddResponse(Message):
    """W→M (shared/src/messages/queue.rs:61-100). Note the asymmetric wire tag."""

    type_name: ClassVar[str] = "response_frame-queue-add"
    message_request_context_id: int
    result: str
    error_reason: str | None = None

    @classmethod
    def new_ok(cls, request_id: int) -> "WorkerFrameQueueAddResponse":
        return cls(request_id, FRAME_QUEUE_ADD_RESULT_ADDED)

    @classmethod
    def new_errored(cls, request_id: int, reason: str) -> "WorkerFrameQueueAddResponse":
        return cls(request_id, FRAME_QUEUE_ADD_RESULT_ERRORED, reason)

    def to_payload(self) -> dict[str, Any]:
        return {
            "message_request_context_id": self.message_request_context_id,
            "result": _result_to_dict(self.result, self.error_reason),
        }

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerFrameQueueAddResponse":
        result, reason = _result_from_dict(payload["result"])
        return cls(int(payload["message_request_context_id"]), result, reason)


@dataclass(frozen=True)
class MasterFrameQueueRemoveRequest(Message):
    """M→W: un-queue (steal) a frame (shared/src/messages/queue.rs:123-146)."""

    type_name: ClassVar[str] = "request_frame-queue_remove"
    message_request_id: int
    job_name: str
    frame_index: int
    # Optional sub-frame tile index (piggyback idiom): a tiled steal or
    # preemption removes one TILE; whole-frame requests omit the key.
    tile: int | None = None

    @classmethod
    def new(
        cls, job_name: str, frame_index: int, *, tile: int | None = None
    ) -> "MasterFrameQueueRemoveRequest":
        return cls(generate_message_request_id(), job_name, frame_index, tile)

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "message_request_id": self.message_request_id,
            "job_name": self.job_name,
            "frame_index": self.frame_index,
        }
        if self.tile is not None:
            out["tile"] = self.tile
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterFrameQueueRemoveRequest":
        return cls(
            message_request_id=int(payload["message_request_id"]),
            job_name=str(payload["job_name"]),
            frame_index=int(payload["frame_index"]),
            tile=_tile_from_payload(payload),
        )


@dataclass(frozen=True)
class WorkerFrameQueueRemoveResponse(Message):
    """W→M (shared/src/messages/queue.rs:168-227)."""

    type_name: ClassVar[str] = "response_frame-queue_remove"
    message_request_context_id: int
    result: str
    error_reason: str | None = None

    @classmethod
    def new_with_result(
        cls, request_id: int, result: str, reason: str | None = None
    ) -> "WorkerFrameQueueRemoveResponse":
        return cls(request_id, result, reason)

    def to_payload(self) -> dict[str, Any]:
        return {
            "message_request_context_id": self.message_request_context_id,
            "result": _result_to_dict(self.result, self.error_reason),
        }

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerFrameQueueRemoveResponse":
        result, reason = _result_from_dict(payload["result"])
        return cls(int(payload["message_request_context_id"]), result, reason)


@dataclass(frozen=True)
class WorkerFrameQueueItemRenderingEvent(Message):
    """W→M: frame started rendering (shared/src/messages/queue.rs:255-274).

    The reference defines + handles this event but its worker never emits it
    (SURVEY.md §3.3); our worker does emit it, completing the protocol.
    """

    type_name: ClassVar[str] = "event_frame-queue_item-started-rendering"
    job_name: str
    frame_index: int
    # Echo of the queue-add request's optional trace context.
    trace: TraceContext | None = None
    # Echo of the queue-add request's optional scheduler job id.
    job_id: str | None = None
    # Echo of the queue-add request's optional tile index.
    tile: int | None = None
    # Echo of the queue-add request's optional master epoch (fencing).
    epoch: int | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "job_name": self.job_name,
            "frame_index": self.frame_index,
        }
        if self.trace is not None:
            out["trace"] = self.trace.to_dict()
        if self.job_id is not None:
            out["job_id"] = self.job_id
        if self.tile is not None:
            out["tile"] = self.tile
        if self.epoch is not None:
            out["epoch"] = self.epoch
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerFrameQueueItemRenderingEvent":
        return cls(
            str(payload["job_name"]),
            int(payload["frame_index"]),
            trace=_trace_from_payload(payload),
            job_id=_job_id_from_payload(payload),
            tile=_tile_from_payload(payload),
            epoch=_epoch_from_payload(payload),
        )


@dataclass(frozen=True)
class WorkerFrameQueueItemFinishedEvent(Message):
    """W→M: frame finished (ok | errored) (shared/src/messages/queue.rs:299-343).

    Unlike the reference's worker (which swallows render errors —
    worker/src/rendering/queue.rs:169-174), ours reports errors so the
    master can reschedule instead of hanging.
    """

    type_name: ClassVar[str] = "event_frame-queue_item-finished"
    job_name: str
    frame_index: int
    result: str  # "ok" | "errored"
    error_reason: str | None = None
    # Echo of the queue-add request's optional trace context, so the
    # master can terminate the frame's flow without local bookkeeping.
    trace: TraceContext | None = None
    # Echo of the queue-add request's optional scheduler job id.
    job_id: str | None = None
    # Echo of the queue-add request's optional tile index: the master's
    # assembly ledger credits the finished TILE, not the whole frame.
    tile: int | None = None
    # Echo of the queue-add request's optional master epoch: a result
    # stamped with a predecessor master's epoch is refused (and counted)
    # by the successor instead of silently applied.
    epoch: int | None = None

    @classmethod
    def new_ok(
        cls,
        job_name: str,
        frame_index: int,
        *,
        trace: TraceContext | None = None,
        job_id: str | None = None,
        tile: int | None = None,
        epoch: int | None = None,
    ) -> "WorkerFrameQueueItemFinishedEvent":
        return cls(
            job_name, frame_index, FRAME_QUEUE_ITEM_FINISHED_OK, trace=trace,
            job_id=job_id, tile=tile, epoch=epoch,
        )

    @classmethod
    def new_errored(
        cls,
        job_name: str,
        frame_index: int,
        reason: str,
        *,
        trace: TraceContext | None = None,
        job_id: str | None = None,
        tile: int | None = None,
        epoch: int | None = None,
    ) -> "WorkerFrameQueueItemFinishedEvent":
        return cls(
            job_name, frame_index, FRAME_QUEUE_ITEM_FINISHED_ERRORED, reason,
            trace=trace, job_id=job_id, tile=tile, epoch=epoch,
        )

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "job_name": self.job_name,
            "frame_index": self.frame_index,
            "result": _result_to_dict(self.result, self.error_reason),
        }
        if self.trace is not None:
            out["trace"] = self.trace.to_dict()
        if self.job_id is not None:
            out["job_id"] = self.job_id
        if self.tile is not None:
            out["tile"] = self.tile
        if self.epoch is not None:
            out["epoch"] = self.epoch
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerFrameQueueItemFinishedEvent":
        result, reason = _result_from_dict(payload["result"])
        return cls(
            str(payload["job_name"]),
            int(payload["frame_index"]),
            result,
            reason,
            trace=_trace_from_payload(payload),
            job_id=_job_id_from_payload(payload),
            tile=_tile_from_payload(payload),
            epoch=_epoch_from_payload(payload),
        )


@dataclass(frozen=True)
class MasterHeartbeatRequest(Message):
    """M→W ping with fractional unix timestamp (shared/src/messages/heartbeat.rs:12-31)."""

    type_name: ClassVar[str] = "request_heartbeat"
    request_time: float

    def to_payload(self) -> dict[str, Any]:
        return {"request_time": self.request_time}

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterHeartbeatRequest":
        return cls(request_time=float(payload["request_time"]))


@dataclass(frozen=True)
class WorkerHeartbeatResponse(Message):
    """W→M pong (shared/src/messages/heartbeat.rs:52-66).

    Extensions over the reference's empty payload, all riding the same
    piggyback idiom (absent key decodes to ``None``; the C++ worker sends
    the reference's empty payload and the C++ master reads only
    ``message_type``, so both directions stay reference-compatible):

    - ``metrics`` — OPTIONAL compact metrics payload
      (``obs.registry.to_wire()`` shape) so the master can aggregate a
      live cluster-wide view with zero extra round-trips;
    - ``received_at`` / ``responded_at`` — OPTIONAL fractional-unix
      timestamps on the worker's clock. Together with the ping's
      ``request_time`` and the master's receive time they complete the
      NTP four-timestamp exchange the per-worker clock-offset estimator
      (``obs/clocksync.py``) feeds on;
    - ``echo_request_time`` — OPTIONAL echo of the ping's
      ``request_time``, correlating pong to ping. The reference's pongs
      are anonymous, which was fine while one missed pong evicted the
      worker; with pong-miss retries a stale pong could otherwise be
      taken for the retry's answer and feed the clock estimator a sample
      whose four timestamps span two different exchanges.
    """

    type_name: ClassVar[str] = "response_heartbeat"
    metrics: dict[str, Any] | None = None
    received_at: float | None = None
    responded_at: float | None = None
    echo_request_time: float | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.metrics is not None:
            out["metrics"] = self.metrics
        if self.received_at is not None:
            out["received_at"] = self.received_at
        if self.responded_at is not None:
            out["responded_at"] = self.responded_at
        if self.echo_request_time is not None:
            out["echo_request_time"] = self.echo_request_time
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerHeartbeatResponse":
        metrics = payload.get("metrics")
        if metrics is not None and not isinstance(metrics, dict):
            raise ValueError("heartbeat metrics payload must be an object")
        received_at = payload.get("received_at")
        responded_at = payload.get("responded_at")
        echo_request_time = payload.get("echo_request_time")
        return cls(
            metrics=metrics,
            received_at=None if received_at is None else float(received_at),
            responded_at=None if responded_at is None else float(responded_at),
            echo_request_time=(
                None if echo_request_time is None else float(echo_request_time)
            ),
        )


@dataclass(frozen=True)
class WorkerGoodbyeEvent(Message):
    """W→M: graceful departure (beyond-reference, drain protocol).

    Sent when a worker is asked to drain (SIGTERM, maintenance): it
    finishes the frame it is rendering, returns every still-queued frame
    index so the master can requeue them immediately — instead of paying
    a heartbeat-timeout eviction to discover the departure — and goes
    away. Reference-compatible by the piggyback rule: a C++ master may
    ignore the unknown message type (the socket death that follows takes
    the reference's eviction path instead).
    """

    type_name: ClassVar[str] = "event_worker-goodbye"
    reason: str = "drain"
    job_name: str | None = None
    returned_frames: tuple[int, ...] = ()
    # Optional tile indices aligned 1:1 with ``returned_frames`` (null for
    # whole-frame entries). Omitted entirely when every returned unit is a
    # whole frame, keeping untiled goodbyes byte-identical.
    returned_tiles: tuple[int | None, ...] | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "reason": self.reason,
            "returned_frames": list(self.returned_frames),
        }
        if self.job_name is not None:
            out["job_name"] = self.job_name
        if self.returned_tiles is not None and any(
            t is not None for t in self.returned_tiles
        ):
            out["returned_tiles"] = list(self.returned_tiles)
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerGoodbyeEvent":
        frames = payload.get("returned_frames") or []
        if not isinstance(frames, list):
            raise ValueError("returned_frames must be a list")
        tiles = payload.get("returned_tiles")
        if tiles is not None:
            if not isinstance(tiles, list) or len(tiles) != len(frames):
                raise ValueError(
                    "returned_tiles must align 1:1 with returned_frames"
                )
            tiles = tuple(None if t is None else int(t) for t in tiles)
        job_name = payload.get("job_name")
        return cls(
            reason=str(payload.get("reason", "drain")),
            job_name=None if job_name is None else str(job_name),
            returned_frames=tuple(int(f) for f in frames),
            returned_tiles=tiles,
        )


@dataclass(frozen=True)
class MasterJobStartedEvent(Message):
    """M→W job-started broadcast (shared/src/messages/job.rs:11-25).

    Empty in the reference; this repo's master piggybacks the OPTIONAL job
    ``trace_id`` so every process stamps its spans with the same trace.
    """

    type_name: ClassVar[str] = "event_job-started"
    trace_id: int | None = None
    # Optional scheduler job id (multi-job masters announce one event per
    # ACTIVE job — late joiners get them all replayed at handshake time).
    job_id: str | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.job_id is not None:
            out["job_id"] = self.job_id
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterJobStartedEvent":
        trace_id = payload.get("trace_id")
        return cls(
            trace_id=None if trace_id is None else int(trace_id),
            job_id=_job_id_from_payload(payload),
        )


@dataclass(frozen=True)
class MasterJobFinishedRequest(Message):
    """M→W: request the worker's trace (shared/src/messages/job.rs:48-67)."""

    type_name: ClassVar[str] = "request_job-finished"
    message_request_id: int

    @classmethod
    def new(cls) -> "MasterJobFinishedRequest":
        return cls(generate_message_request_id())

    def to_payload(self) -> dict[str, Any]:
        return {"message_request_id": self.message_request_id}

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterJobFinishedRequest":
        return cls(message_request_id=int(payload["message_request_id"]))


@dataclass(frozen=True)
class WorkerJobFinishedResponse(Message):
    """W→M: the full WorkerTrace (shared/src/messages/job.rs:90-110).

    Piggyback extension: ``span_events`` optionally carries the worker's
    Chrome trace-event timeline (``{"process_name": ..., "events": [...]}``)
    so a multi-host master can assemble the merged cluster timeline without
    a separate collection RPC. Absent (the C++ worker, a version-skewed
    peer) decodes to ``None`` and the master simply omits that worker's row.
    """

    type_name: ClassVar[str] = "response_job-finished"
    message_request_context_id: int
    trace: WorkerTrace
    span_events: dict[str, Any] | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "message_request_context_id": self.message_request_context_id,
            "trace": self.trace.to_dict(),
        }
        if self.span_events is not None:
            out["span_events"] = self.span_events
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "WorkerJobFinishedResponse":
        span_events = payload.get("span_events")
        if span_events is not None and not isinstance(span_events, dict):
            raise ValueError("span_events payload must be an object")
        return cls(
            message_request_context_id=int(payload["message_request_context_id"]),
            trace=WorkerTrace.from_dict(payload["trace"]),
            span_events=span_events,
        )


# ---------------------------------------------------------------------------
# Ledger streaming replication (PROTOCOL.md §Ledger streaming replication)
#
# Follower <-> primary traffic over the JSON-lines control-plane idiom —
# one ``encode_message`` envelope per line on a plain TCP socket, NOT the
# worker WebSocket. These tags never ride the reference worker protocol,
# but they use the same envelope + schema registry so the wire-schema
# lint covers the replication contract too.


@dataclass(frozen=True)
class ReplicationAttachRequest(Message):
    """F→P: attach (or re-attach) to the primary's record stream.

    ``last_seq`` is the highest *contiguous* sequence number durably in
    the follower's local replica (0 = empty). The primary answers with
    everything after it — via a snapshot when ``last_seq`` predates the
    primary's compaction floor. The optional ``epoch`` carries the newest
    master epoch the follower has durably observed: a primary whose own
    epoch is LOWER knows it has been deposed and must refuse the attach
    rather than stream a stale timeline.
    """

    type_name: ClassVar[str] = "request_replication-attach"
    message_request_id: int
    last_seq: int
    epoch: int | None = None
    follower_id: str | None = None

    @classmethod
    def new(
        cls, last_seq: int, *, epoch: int | None = None, follower_id: str | None = None
    ) -> "ReplicationAttachRequest":
        return cls(
            generate_message_request_id(),
            last_seq=last_seq,
            epoch=epoch,
            follower_id=follower_id,
        )

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "message_request_id": self.message_request_id,
            "last_seq": self.last_seq,
        }
        if self.epoch is not None:
            out["epoch"] = self.epoch
        if self.follower_id is not None:
            out["follower_id"] = self.follower_id
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "ReplicationAttachRequest":
        last_seq = int(payload["last_seq"])
        if last_seq < 0:
            raise ValueError(f"last_seq must be >= 0, got {last_seq}")
        follower_id = payload.get("follower_id")
        return cls(
            message_request_id=int(payload["message_request_id"]),
            last_seq=last_seq,
            epoch=_epoch_from_payload(payload),
            follower_id=None if follower_id is None else str(follower_id),
        )


@dataclass(frozen=True)
class ReplicationAttachResponse(Message):
    """P→F: accept (stream follows) or refuse an attach.

    On accept: ``epoch`` is the primary's current epoch, ``primary_seq``
    its highest committed sequence number (the follower's initial lag
    baseline), and ``snapshot`` — present only when the follower's
    ``last_seq`` predates the compaction floor — a full ledger snapshot
    document to seed the replica before the record stream resumes. On
    refusal ``error`` says why and the connection closes; the follower
    counts the refusal and does NOT retry a stale-epoch one.
    """

    type_name: ClassVar[str] = "response_replication-attach"
    message_request_context_id: int
    epoch: int
    primary_seq: int
    snapshot: dict[str, Any] | None = None
    error: str | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "message_request_context_id": self.message_request_context_id,
            "epoch": self.epoch,
            "primary_seq": self.primary_seq,
        }
        if self.snapshot is not None:
            out["snapshot"] = self.snapshot
        if self.error is not None:
            out["error"] = self.error
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "ReplicationAttachResponse":
        snapshot = payload.get("snapshot")
        if snapshot is not None and not isinstance(snapshot, dict):
            raise ValueError("snapshot payload must be an object")
        error = payload.get("error")
        return cls(
            message_request_context_id=int(payload["message_request_context_id"]),
            epoch=int(payload["epoch"]),
            primary_seq=int(payload["primary_seq"]),
            snapshot=snapshot,
            error=None if error is None else str(error),
        )


@dataclass(frozen=True)
class ReplicationRecordEvent(Message):
    """P→F: one committed ledger record.

    ``record`` is the exact dict the primary appended (``{"v", "seq",
    "type", "job", "ts", ...}``); ``seq`` duplicates ``record["seq"]`` at
    the envelope level so the follower's gap detector never has to trust
    a partially-validated body. Streamed in strict sequence order; a gap
    means the connection lost records and the follower must re-attach
    from its last contiguous sequence.
    """

    type_name: ClassVar[str] = "event_replication-record"
    seq: int
    record: dict[str, Any]

    def to_payload(self) -> dict[str, Any]:
        return {"seq": self.seq, "record": self.record}

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "ReplicationRecordEvent":
        record = payload["record"]
        if not isinstance(record, dict):
            raise ValueError("record must be an object")
        return cls(seq=int(payload["seq"]), record=record)


@dataclass(frozen=True)
class ReplicationAckEvent(Message):
    """F→P: cumulative acknowledgement — every record up to and including
    ``seq`` is durably on the follower's disk. Sent every
    ``TRC_HA_REPL_ACK_EVERY`` records (and on stream idle), not per
    record; the primary's per-follower lag gauge is derived from it."""

    type_name: ClassVar[str] = "event_replication-ack"
    seq: int

    def to_payload(self) -> dict[str, Any]:
        return {"seq": self.seq}

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "ReplicationAckEvent":
        return cls(seq=int(payload["seq"]))


@dataclass(frozen=True)
class MasterWorkerMigrateEvent(Message):
    """M→W: re-home to another shard master (beyond-reference, rebalance).

    The shard router's rebalancer asks a hot shard's master to shed a
    worker; the master picks one and sends this event. The worker treats
    it exactly like a drain — finish the in-flight unit, return queued
    frames via ``event_worker-goodbye`` (reason ``"migrate"``) — then
    reconnects to ``host``:``port`` with a FRESH first-connection
    announce instead of exiting. A reference worker ignores the unknown
    tag and simply stays put, so rebalancing degrades to a no-op rather
    than an error on mixed fleets.
    """

    type_name: ClassVar[str] = "event_worker-migrate"
    host: str
    port: int
    reason: str | None = None

    def to_payload(self) -> dict[str, Any]:
        out: dict[str, Any] = {"host": self.host, "port": self.port}
        if self.reason is not None:
            out["reason"] = self.reason
        return out

    @classmethod
    def from_payload(cls, payload: dict[str, Any]) -> "MasterWorkerMigrateEvent":
        port = int(payload["port"])
        if not (0 < port < 65536):
            raise ValueError(f"port must be 1..65535, got {port}")
        reason = payload.get("reason")
        return cls(
            host=str(payload["host"]),
            port=port,
            reason=None if reason is None else str(reason),
        )


# ---------------------------------------------------------------------------
# Envelope

ALL_MESSAGE_TYPES: tuple[type[Message], ...] = (
    MasterHandshakeRequest,
    WorkerHandshakeResponse,
    MasterHandshakeAcknowledgement,
    MasterFrameQueueAddRequest,
    WorkerFrameQueueAddResponse,
    MasterFrameQueueRemoveRequest,
    WorkerFrameQueueRemoveResponse,
    WorkerFrameQueueItemRenderingEvent,
    WorkerFrameQueueItemFinishedEvent,
    WorkerGoodbyeEvent,
    MasterHeartbeatRequest,
    WorkerHeartbeatResponse,
    MasterJobStartedEvent,
    MasterJobFinishedRequest,
    WorkerJobFinishedResponse,
    ReplicationAttachRequest,
    ReplicationAttachResponse,
    ReplicationRecordEvent,
    ReplicationAckEvent,
    MasterWorkerMigrateEvent,
)

_TYPE_REGISTRY: dict[str, type[Message]] = {m.type_name: m for m in ALL_MESSAGE_TYPES}


def encode_message(message: Message) -> str:
    """Serialise to the tagged JSON envelope (a WS text frame)."""
    return json.dumps(
        {"message_type": message.type_name, "payload": message.to_payload()},
        separators=(",", ":"),
    )


def decode_message(text: str | bytes) -> Message:
    """Parse a tagged JSON envelope back into a typed message."""
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    try:
        data = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"Malformed message frame: {e}") from e
    if not isinstance(data, dict):
        raise ValueError(f"Message frame must be a JSON object, got {type(data).__name__}")
    tag = data.get("message_type")
    cls = _TYPE_REGISTRY.get(tag) if isinstance(tag, str) else None
    if cls is None:
        raise ValueError(f"Unknown message_type: {tag!r}")
    payload = data.get("payload") or {}
    if not isinstance(payload, dict):
        raise ValueError(f"Message payload must be a JSON object, got {type(payload).__name__}")
    try:
        return cls.from_payload(payload)
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"Invalid payload for {tag!r}: {e}") from e
