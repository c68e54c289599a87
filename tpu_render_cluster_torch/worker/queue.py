"""Worker-side automatic render queue (the port's own copy).

Reference: ``WorkerAutomaticQueue`` (worker/src/rendering/queue.rs:16-230) —
a 100 ms poll loop takes the first Queued frame, marks it Rendering, renders
one frame at a time, then emits the finished event and pops it.

Two deliberate deviations (reference bugs fixed — SURVEY.md §7):
- the ``event_frame-queue_item-started-rendering`` event IS emitted (the
  reference defines and handles it but never sends it, §3.3);
- a render failure emits ``event_frame-queue_item-finished`` with
  ``errored`` instead of silently dropping the frame (which would hang the
  reference master forever — worker/src/rendering/queue.rs:169-174).
"""

from __future__ import annotations

import asyncio
import enum
import logging
import time
from dataclasses import dataclass, field

from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.jobs.tiles import WorkUnit
from tpu_render_cluster_torch.obs import MetricsRegistry, Tracer
from tpu_render_cluster_torch.protocol import messages as pm
from tpu_render_cluster_torch.transport.actors import SenderHandle
from tpu_render_cluster_torch.traces.worker_trace import WorkerTraceBuilder
from tpu_render_cluster_torch.utils.cancellation import CancellationToken
from tpu_render_cluster_torch.worker.backends.base import RenderBackend

logger = logging.getLogger(__name__)

QUEUE_POLL_SECONDS = 0.1  # reference: worker/src/rendering/queue.rs:74-96

# The per-frame phase breakdown the paper's analysis is built around
# (reading/rendering/writing), plus the queue-wait the paper only derives
# post-hoc from trace gaps — here measured directly.
FRAME_PHASES = ("queue_wait", "read", "render", "write")


class FrameState(enum.Enum):
    QUEUED = "queued"
    RENDERING = "rendering"
    FINISHED = "finished"


@dataclass
class QueuedFrame:
    job: BlenderJob
    frame_index: int
    state: FrameState = FrameState.QUEUED
    queued_at: float = field(default_factory=time.time)
    # Trace context from the master's queue-add request (None from a
    # reference-shaped master); echoed on rendering/finished events and
    # routed through the phase spans as a Perfetto flow.
    trace: pm.TraceContext | None = None
    # Scheduler job id from the queue-add request (None from single-job
    # masters); echoed on rendering/finished events.
    job_id: str | None = None
    # Sub-frame tile index from the queue-add request (None = whole
    # frame); echoed on rendering/finished events.
    tile: int | None = None
    # Master epoch from the queue-add request (None from epoch-less
    # masters); echoed on rendering/finished events so a successor master
    # can fence out a predecessor's assignments after a failover.
    epoch: int | None = None
    # Worker-local session generation at queue time (see reset_session).
    session: int = 0

    @property
    def unit(self) -> WorkUnit:
        return WorkUnit(self.frame_index, self.tile)


class WorkerAutomaticQueue:
    """Serial render queue polled every 100 ms."""

    def __init__(
        self,
        backend: RenderBackend,
        sender: SenderHandle,
        tracer: WorkerTraceBuilder,
        cancellation: CancellationToken,
        *,
        metrics: MetricsRegistry | None = None,
        span_tracer: Tracer | None = None,
    ) -> None:
        self._backend = backend
        self._sender = sender
        self._tracer = tracer
        self._cancellation = cancellation
        self._metrics = metrics
        self._span_tracer = span_tracer
        self._phase_histogram = (
            metrics.histogram(
                "worker_frame_phase_seconds",
                "Per-frame phase durations (queue_wait/read/render/write)",
                labels=("phase",),
            )
            if metrics is not None
            else None
        )
        self._frames: list[QueuedFrame] = []
        self._finished_indices: set[tuple[str, int, int | None]] = set()
        # Bumped by reset_session(): a frame queued under a previous
        # master session that only finishes rendering AFTER the reset
        # must not re-enter the finished index (the new master may
        # legitimately re-assign that unit).
        self._session_generation = 0
        self._task: asyncio.Task | None = None
        self._draining = False
        # Wakes the render loop as soon as work arrives; the 100 ms sleep
        # remains only as a fallback poll (the reference burns up to a full
        # poll interval of idle time per queue refill — queue.rs:74-96).
        self._work_available = asyncio.Event()

    # -- queue interface (called from the message manager) -------------------

    def queue_frame(
        self,
        job: BlenderJob,
        frame_index: int,
        *,
        trace: pm.TraceContext | None = None,
        job_id: str | None = None,
        tile: int | None = None,
        epoch: int | None = None,
    ) -> None:
        if self._draining:
            # Refuse, don't silently park: the add RPC answers errored and
            # the master returns the frame to the pending pool — a frame
            # accepted here after drain() collected the queue would be lost.
            raise RuntimeError("Worker is draining; not accepting new frames.")
        self._frames.append(
            QueuedFrame(
                job, frame_index, trace=trace, job_id=job_id, tile=tile,
                epoch=epoch, session=self._session_generation,
            )
        )
        self._work_available.set()

    def unqueue_frame(
        self, job_name: str, frame_index: int, tile: int | None = None
    ) -> str:
        """Returns the frame-queue-remove result enum wire value.

        Reference: worker/src/rendering/queue.rs:192-229. ``tile`` rides
        the same optional piggyback as queue-add: a tiled steal removes
        exactly one tile, and whole-frame requests (tile None) only ever
        match whole-frame entries.
        """
        if (job_name, frame_index, tile) in self._finished_indices:
            return pm.FRAME_QUEUE_REMOVE_RESULT_ALREADY_FINISHED
        for i, frame in enumerate(self._frames):
            if (
                frame.job.job_name == job_name
                and frame.frame_index == frame_index
                and frame.tile == tile
            ):
                if frame.state is FrameState.RENDERING:
                    return pm.FRAME_QUEUE_REMOVE_RESULT_ALREADY_RENDERING
                if frame.state is FrameState.FINISHED:
                    return pm.FRAME_QUEUE_REMOVE_RESULT_ALREADY_FINISHED
                del self._frames[i]
                return pm.FRAME_QUEUE_REMOVE_RESULT_REMOVED
        return pm.FRAME_QUEUE_REMOVE_RESULT_ERRORED

    async def drain(self) -> list[tuple[str, int]]:
        """Graceful drain: finish the in-flight frame, hand back the rest.

        Stops the loop from starting new frames, waits for the one
        currently rendering to complete (its finished event goes out
        normally), and returns the ``(job_name, frame_index)`` pairs that
        never started — the payload of the goodbye message the runtime
        sends so the master can requeue them without waiting for a
        heartbeat-timeout eviction.
        """
        self._draining = True
        self._work_available.set()  # wake the loop so it parks promptly
        while any(f.state is FrameState.RENDERING for f in self._frames):
            await asyncio.sleep(0.01)
        returned = [
            (f.job.job_name, f.unit)
            for f in self._frames
            if f.state is FrameState.QUEUED
        ]
        self._frames = [f for f in self._frames if f.state is not FrameState.QUEUED]
        return returned

    def reset_session(self) -> int:
        """Drop the previous master session's queue state (failover).

        Called when the worker re-announces itself to a NEW master
        incarnation (epoch change / refused reconnect): the queued-but-
        not-started frames belong to assignments the new master does not
        know about, so replaying them would render work nobody tracks.
        The frame currently RENDERING is left to finish — its finished
        event carries the OLD epoch and the new master refuses it as
        stale, which is the fence working as designed. The already-
        finished index is cleared too: the new master may legitimately
        re-assign a unit this worker rendered for the predecessor, and an
        ``already-finished`` answer to a later remove RPC would lie about
        the NEW assignment. Returns how many queued frames were dropped.
        """
        dropped = [f for f in self._frames if f.state is FrameState.QUEUED]
        self._frames = [
            f for f in self._frames if f.state is not FrameState.QUEUED
        ]
        self._finished_indices.clear()
        # The frame left mid-RENDER belongs to the OLD session: when it
        # finishes, it must not re-enter the just-cleared finished index
        # (the generation check at insert time fences it out).
        self._session_generation += 1
        return len(dropped)

    # -- render loop ---------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="render-queue")

    async def join(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def _next_queued(self) -> QueuedFrame | None:
        for frame in self._frames:
            if frame.state is FrameState.QUEUED:
                return frame
        return None

    async def _run(self) -> None:
        while not self._cancellation.is_cancelled():
            frame = None if self._draining else self._next_queued()
            if frame is None:
                self._work_available.clear()
                try:
                    await asyncio.wait_for(
                        self._work_available.wait(), QUEUE_POLL_SECONDS
                    )
                except asyncio.TimeoutError:
                    pass
                continue
            await self._render_frame_and_report(frame)

    async def _render_frame_and_report(self, frame: QueuedFrame) -> None:
        frame.state = FrameState.RENDERING
        job_name = frame.job.job_name
        # Backends that batch internally (ray-pool mode) get the same-job
        # frames still queued HERE — real assigned work, so batching ahead
        # never renders a frame this worker doesn't own (see
        # RenderBackend's hint protocol).
        note_upcoming = getattr(self._backend, "note_upcoming_frames", None)
        if note_upcoming is not None:
            note_upcoming(
                frame.job,
                tuple(
                    f.unit
                    for f in self._frames
                    if f.state is FrameState.QUEUED
                    and f.job.job_name == job_name
                ),
            )
        await self._sender.send_message(
            pm.WorkerFrameQueueItemRenderingEvent(
                job_name, frame.frame_index, trace=frame.trace,
                job_id=frame.job_id, tile=frame.tile, epoch=frame.epoch,
            )
        )
        try:
            timing = await self._backend.render_frame(
                frame.job, frame.frame_index, tile=frame.tile
            )
        except Exception as e:  # noqa: BLE001 - report, don't hang the master
            logger.error("Unit %s render failed: %s", frame.unit.label, e)
            if self._metrics is not None:
                self._metrics.counter(
                    "worker_frames_errored_total", "Frames that failed to render"
                ).inc()
            # NOT added to _finished_indices: the master returns errored
            # frames to the pending pool and may re-queue them here; a later
            # remove request must not answer "already-finished".
            self._remove(frame)
            await self._sender.send_message(
                pm.WorkerFrameQueueItemFinishedEvent.new_errored(
                    job_name, frame.frame_index, str(e), trace=frame.trace,
                    job_id=frame.job_id, tile=frame.tile, epoch=frame.epoch,
                )
            )
            return
        self._tracer.trace_new_rendered_frame(frame.frame_index, timing)
        self._observe_frame_phases(frame, timing)
        self._remove(frame)
        if frame.session == self._session_generation:
            # A frame queued under a PREVIOUS master session (failover hit
            # while it rendered) stays out of the index: the new master
            # may re-assign this unit, and an "already-finished" answer to
            # a later remove RPC would lie about the NEW assignment.
            self._finished_indices.add(
                (job_name, frame.frame_index, frame.tile)
            )
        await self._sender.send_message(
            pm.WorkerFrameQueueItemFinishedEvent.new_ok(
                job_name, frame.frame_index, trace=frame.trace,
                job_id=frame.job_id, tile=frame.tile, epoch=frame.epoch,
            )
        )

    def _observe_frame_phases(self, frame: QueuedFrame, timing) -> None:
        """Feed the live per-phase histograms + emit retroactive spans.

        The spans reuse the 7-point wall-clock timestamps the backend
        already measured (the trace of record), so the Perfetto view and
        the legacy ``FrameRenderTime`` analysis agree exactly.
        """
        if self._metrics is None and self._span_tracer is None:
            return
        bounds = {
            "queue_wait": (frame.queued_at, timing.started_process_at),
            "read": (timing.started_process_at, timing.finished_loading_at),
            "render": (timing.started_rendering_at, timing.finished_rendering_at),
            "write": (timing.file_saving_started_at, timing.file_saving_finished_at),
        }
        for phase in FRAME_PHASES:
            start, end = bounds[phase]
            duration = max(0.0, end - start)
            if self._phase_histogram is not None:
                self._phase_histogram.observe(duration, phase=phase)
            if self._span_tracer is not None:
                args = {"frame": frame.frame_index}
                if frame.tile is not None:
                    args["tile"] = frame.tile
                if frame.trace is not None:
                    args["flow"] = frame.trace.flow_id
                self._span_tracer.complete(
                    phase,
                    cat="worker",
                    start_wall=start,
                    duration=duration,
                    track="frames",
                    args=args,
                )
                if frame.trace is not None:
                    # Route the assignment's flow through each phase span
                    # (mid-span so it binds even to zero-length phases):
                    # the master's assign span started it; its
                    # result-received span will terminate it.
                    flow_args = {"frame": frame.frame_index, "phase": phase}
                    if frame.tile is not None:
                        flow_args["tile"] = frame.tile
                    self._span_tracer.flow_step(
                        "frame",
                        id=frame.trace.flow_id,
                        ts=start + duration / 2.0,
                        cat="frame",
                        track="frames",
                        args=flow_args,
                    )
        if self._metrics is not None:
            self._metrics.counter(
                "worker_frames_rendered_total", "Frames rendered successfully"
            ).inc()

    def _remove(self, frame: QueuedFrame) -> None:
        if frame in self._frames:
            self._frames.remove(frame)
