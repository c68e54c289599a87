"""Worker runtime: reconnecting client + heartbeat responder + message manager
(the port's own copy of ``tpu_render_cluster/worker/runtime.py``).

Reference: worker/src/connection/mod.rs:46-713. The worker connects with
exponential backoff, performs the 3-step handshake (first-connection, or
reconnecting after socket death), then runs three loops until the job
finishes: the heartbeat responder (tracing every 8th ping —
``TRACE_EVERY_NTH_PING`` at worker/src/connection/mod.rs:46), the message
manager (queue add/remove, job started/finished), and the automatic render
queue.
"""

from __future__ import annotations

import asyncio
import logging
import time

from tpu_render_cluster_torch import PROTOCOL_VERSION
from tpu_render_cluster_torch.obs import (
    LoopLagMonitor,
    MetricsRegistry,
    Tracer,
    get_registry,
)
from tpu_render_cluster_torch.protocol import messages as pm
from tpu_render_cluster_torch.traces.worker_trace import WorkerTrace, WorkerTraceBuilder
from tpu_render_cluster_torch.transport.actors import MessageRouter, SenderHandle
from tpu_render_cluster_torch.transport.reconnect import (
    ReconnectingClient,
    TransportMetrics,
    connect_with_exponential_backoff,
)
from tpu_render_cluster_torch.transport.ws import WebSocketClosed, WebSocketConnection
from tpu_render_cluster_torch.transport.wirecost import WireAccounting
from tpu_render_cluster_torch.utils.cancellation import CancellationToken
from tpu_render_cluster_torch.worker.backends.base import RenderBackend
from tpu_render_cluster_torch.worker.queue import WorkerAutomaticQueue

logger = logging.getLogger(__name__)

TRACE_EVERY_NTH_PING = 8  # reference: worker/src/connection/mod.rs:46
HANDSHAKE_TIMEOUT = 30.0


class ReconnectRefused(WebSocketClosed):
    """The master refused a RECONNECTING handshake (it does not know this
    worker — typically a restarted master whose in-memory registry died).
    The caller retries with a fresh first-connection announce instead of
    replaying stale session state into a master that never saw it."""


async def _perform_handshake(
    ws: WebSocketConnection,
    worker_id: int,
    *,
    is_reconnect: bool,
    last_epoch: int | None = None,
    wire: WireAccounting | None = None,
) -> tuple[int | None, bool]:
    """Client side of the 3-step handshake; returns ``(epoch, fresh)``.

    Reference: worker/src/connection/mod.rs:402-454, extended with epoch
    fencing (PROTOCOL.md §Epoch fencing & failover): the master's
    handshake request optionally carries its ledger epoch. A reconnecting
    worker that sees a DIFFERENT epoch than the master it lost is talking
    to a new incarnation — it announces ``first-connection`` (a fresh
    session) instead of ``reconnecting``, because the new master has no
    session to resume. ``fresh`` is True when a first-connection announce
    was sent.
    """
    if wire is None:
        wire = WireAccounting(None)  # bare-codec passthrough
    request = wire.decode(await ws.receive_text())
    if not isinstance(request, pm.MasterHandshakeRequest):
        raise WebSocketClosed(f"Expected handshake request, got {type(request)}")
    announce_fresh = not is_reconnect or request.epoch != last_epoch
    if is_reconnect and announce_fresh:
        logger.info(
            "Master epoch changed (%s -> %s); re-announcing as a fresh session.",
            last_epoch,
            request.epoch,
        )
    handshake_type = (
        pm.HANDSHAKE_TYPE_FIRST_CONNECTION
        if announce_fresh
        else pm.HANDSHAKE_TYPE_RECONNECTING
    )
    await ws.send_text(
        wire.encode(
            pm.WorkerHandshakeResponse(handshake_type, PROTOCOL_VERSION, worker_id)
        )
    )
    ack = wire.decode(await ws.receive_text())
    if not isinstance(ack, pm.MasterHandshakeAcknowledgement) or not ack.ok:
        if handshake_type == pm.HANDSHAKE_TYPE_RECONNECTING:
            # An epoch-less restarted master refuses reconnects from
            # workers it never met; fall back to a fresh announce on the
            # next attempt (the master aborts this socket after refusing).
            raise ReconnectRefused("Master refused the reconnect handshake.")
        raise WebSocketClosed("Master refused the handshake.")
    return request.epoch, announce_fresh


class Worker:
    """A single render node."""

    def __init__(
        self,
        master_host: str,
        master_port: int,
        backend: RenderBackend,
        *,
        tracer: WorkerTraceBuilder | None = None,
        metrics: MetricsRegistry | None = None,
        span_tracer: Tracer | None = None,
    ) -> None:
        self.master_host = master_host
        self.master_port = master_port
        self.backend = backend
        self.worker_id = pm.generate_worker_id()
        self.tracer = tracer or WorkerTraceBuilder()
        # Live observability: the worker's registry ships to the master as
        # the heartbeat's compact payload; the span tracer is one Perfetto
        # process row per worker. The registry defaults to the
        # PROCESS-GLOBAL one so process-scoped sources (the torch-raytrace
        # backend's render_* series feed get_registry()) ride the same
        # heartbeat in daemon mode (one worker per process).
        self.metrics = metrics if metrics is not None else get_registry()
        self.span_tracer = span_tracer or Tracer(
            f"worker-{pm.worker_id_to_string(self.worker_id)}"
        )
        # Worker-end wire accounting + event-loop lag probe: the same
        # transport_*/obs_loop_* families the master exports, so both
        # ends of every exchange (and both loops) are priced.
        self._wire = WireAccounting(self.metrics)
        self.loopmon = LoopLagMonitor(
            self.metrics, role="worker", span_tracer=self.span_tracer
        )
        self.cancellation = CancellationToken()
        self._drain_requested = asyncio.Event()
        self._client: ReconnectingClient | None = None
        self._final_trace: WorkerTrace | None = None
        # Epoch of the master incarnation this worker last handshook with
        # (None until the first connect, and forever against epoch-less
        # masters). A reconnect that lands on a DIFFERENT epoch is a new
        # master: the worker re-announces fresh and drops stale queue
        # state instead of replaying it (PROTOCOL.md §Epoch fencing).
        self._master_epoch: int | None = None
        # Set when a RECONNECTING handshake was refused: the next attempt
        # announces first-connection (restarted epoch-less master).
        self._force_fresh_announce = False
        self._frame_queue: WorkerAutomaticQueue | None = None

    def _begin_fresh_session(self) -> None:
        """A reconnect landed on a NEW master incarnation (epoch change or
        refused reconnect): drop queue state belonging to the lost
        session. Anything still rendering finishes and is fenced by its
        old-epoch result; anything merely queued is work the new master
        will re-dispatch itself (its ledger knows what actually finished).
        """
        dropped = 0
        if self._frame_queue is not None:
            dropped = self._frame_queue.reset_session()
        self.metrics.counter(
            "worker_session_reannounces_total",
            "Reconnects that re-announced a fresh session to a new master "
            "incarnation (epoch change or refused reconnect)",
        ).inc()
        logger.info(
            "Fresh session with master (epoch %s); dropped %d stale "
            "queued frame(s).",
            self._master_epoch,
            dropped,
        )

    def request_drain(self) -> None:
        """Ask the worker to drain gracefully: finish the frame being
        rendered, return the rest of the queue via the goodbye message,
        and disconnect. Wired to SIGTERM by the CLI; safe to call from
        any task on the worker's loop, idempotent."""
        self._drain_requested.set()

    async def connect_and_run_to_job_completion(self) -> WorkerTrace:
        """Connect, serve the job protocol until job-finished, return the trace."""
        transport_metrics = TransportMetrics(self.metrics)

        async def fresh_connection(is_reconnect: bool) -> WebSocketConnection:
            with self.span_tracer.span(
                "reconnect" if is_reconnect else "connect",
                cat="transport",
                track="connection",
            ):
                ws = await connect_with_exponential_backoff(
                    self.master_host,
                    self.master_port,
                    metrics=transport_metrics,
                )
                announce_reconnect = is_reconnect and not self._force_fresh_announce
                try:
                    epoch, fresh = await asyncio.wait_for(
                        _perform_handshake(
                            ws,
                            self.worker_id,
                            is_reconnect=announce_reconnect,
                            last_epoch=self._master_epoch,
                            wire=self._wire,
                        ),
                        HANDSHAKE_TIMEOUT,
                    )
                except ReconnectRefused:
                    # Retry (through the reconnect budget) with a fresh
                    # first-connection announce — the refusing master has
                    # no session to resume.
                    self._force_fresh_announce = True
                    ws.abort()
                    raise
                self._force_fresh_announce = False
                self._master_epoch = epoch
                if fresh and is_reconnect:
                    self._begin_fresh_session()
            return ws

        first = await fresh_connection(False)
        client = ReconnectingClient(
            first,
            lambda: fresh_connection(True),
            on_reconnect=self.tracer.trace_new_reconnect,
            metrics=transport_metrics,
        )
        self._client = client
        logger.info(
            "Worker %s connected to %s:%d",
            pm.worker_id_to_string(self.worker_id),
            self.master_host,
            self.master_port,
        )

        sender = SenderHandle(lambda m: client.send_text(self._wire.encode(m)))
        sender.start()
        self.loopmon.start()

        async def receive() -> pm.Message:
            return self._wire.decode(await client.receive_text())

        router = MessageRouter(receive)
        # Subscribe BEFORE the receive loop can dispatch: the master pings
        # immediately at registration (seeding its clock-offset estimator),
        # and an unsubscribed dispatch drops the message — the responder
        # task's own subscribe would run one scheduling pass too late.
        heartbeat_queue = router.subscribe(pm.MasterHeartbeatRequest)
        router.start()

        frame_queue = WorkerAutomaticQueue(
            self.backend,
            sender,
            self.tracer,
            self.cancellation,
            metrics=self.metrics,
            span_tracer=self.span_tracer,
        )
        self._frame_queue = frame_queue
        frame_queue.start()

        heartbeat_task = asyncio.create_task(
            self._respond_to_heartbeats(heartbeat_queue, sender),
            name="heartbeats",
        )
        try:
            await self._manage_incoming_messages(router, sender, frame_queue)
        finally:
            self.cancellation.cancel()
            heartbeat_task.cancel()
            await self.loopmon.stop()
            await frame_queue.join()
            await router.stop()
            await sender.stop()
            client.close()
        assert self._final_trace is not None
        return self._final_trace

    async def _respond_to_heartbeats(
        self, queue: asyncio.Queue, sender: SenderHandle
    ) -> None:
        """Answer pings; record every 8th as a ping trace.

        Reference: worker/src/connection/mod.rs:503-599. The queue is
        subscribed by the caller before the router starts, so the master's
        immediate first ping can never be dropped.
        """
        ping_counter = 0
        while True:
            request = await queue.get()
            received_at = time.time()
            # Every pong carries the compact metrics payload (the master
            # aggregates a live cluster-wide view with zero extra RPCs)
            # plus the worker-clock receive/respond timestamps that close
            # the NTP loop for the master's clock-offset estimator.
            await sender.send_message(
                pm.WorkerHeartbeatResponse(
                    metrics=self.metrics.to_wire(),
                    received_at=received_at,
                    responded_at=time.time(),
                    # Correlate pong to ping: with pong-miss retries on the
                    # master, an anonymous late pong could be mistaken for
                    # the retry's answer.
                    echo_request_time=request.request_time,
                )
            )
            ping_counter += 1
            if ping_counter % TRACE_EVERY_NTH_PING == 0:
                self.tracer.trace_new_ping(request.request_time, received_at)

    async def _manage_incoming_messages(
        self,
        router: MessageRouter,
        sender: SenderHandle,
        frame_queue: WorkerAutomaticQueue,
    ) -> None:
        """The select-loop over master requests/events.

        Reference: worker/src/connection/mod.rs:601-713.
        """
        add_queue = router.subscribe(pm.MasterFrameQueueAddRequest)
        remove_queue = router.subscribe(pm.MasterFrameQueueRemoveRequest)
        started_queue = router.subscribe(pm.MasterJobStartedEvent)
        finished_queue = router.subscribe(pm.MasterJobFinishedRequest)
        migrate_queue = router.subscribe(pm.MasterWorkerMigrateEvent)
        job_done = asyncio.Event()

        async def depart(reason: str) -> None:
            """Drain-style graceful departure: finish the in-flight frame,
            return the queued rest via the goodbye, close out the trace
            locally (no job-finished request will come for a departed
            worker), and end this run."""
            returned = await frame_queue.drain()
            job_name = returned[0][0] if returned else None
            await sender.send_message(
                pm.WorkerGoodbyeEvent(
                    reason=reason,
                    job_name=job_name,
                    returned_frames=tuple(
                        unit.frame_index for _, unit in returned
                    ),
                    returned_tiles=(
                        tuple(unit.tile for _, unit in returned)
                        if any(unit.tile is not None for _, unit in returned)
                        else None
                    ),
                )
            )
            logger.info(
                "Goodbye sent (%s, %d frame(s) returned); disconnecting.",
                reason,
                len(returned),
            )
            self.tracer.ensure_job_start_time(time.time())
            self.tracer.set_job_finish_time(time.time())
            self._final_trace = self.tracer.build()
            job_done.set()

        async def handle_adds() -> None:
            while True:
                request = await add_queue.get()
                if (
                    request.epoch is not None
                    and self._master_epoch is not None
                    and request.epoch != self._master_epoch
                ):
                    # A queue-add stamped with a different incarnation's
                    # epoch (a partitioned predecessor's socket flushing
                    # late): refuse and count, never silently enqueue.
                    self.metrics.counter(
                        "worker_stale_epoch_requests_total",
                        "Queue-add requests refused because their epoch "
                        "does not match the current master session",
                    ).inc()
                    await sender.send_message(
                        pm.WorkerFrameQueueAddResponse.new_errored(
                            request.message_request_id,
                            f"stale epoch {request.epoch} "
                            f"(current session epoch {self._master_epoch})",
                        )
                    )
                    continue
                try:
                    frame_queue.queue_frame(
                        request.job, request.frame_index, trace=request.trace,
                        job_id=request.job_id, tile=request.tile,
                        epoch=request.epoch,
                    )
                    self.tracer.increment_total_queued_frames()
                    response = pm.WorkerFrameQueueAddResponse.new_ok(
                        request.message_request_id
                    )
                except Exception as e:  # noqa: BLE001
                    response = pm.WorkerFrameQueueAddResponse.new_errored(
                        request.message_request_id, str(e)
                    )
                await sender.send_message(response)

        async def handle_removes() -> None:
            while True:
                request = await remove_queue.get()
                result = frame_queue.unqueue_frame(
                    request.job_name, request.frame_index, request.tile
                )
                if result == pm.FRAME_QUEUE_REMOVE_RESULT_REMOVED:
                    self.tracer.increment_total_frames_removed_from_queue()
                await sender.send_message(
                    pm.WorkerFrameQueueRemoveResponse.new_with_result(
                        request.message_request_id, result
                    )
                )

        async def handle_job_started() -> None:
            while True:
                event = await started_queue.get()
                logger.info(
                    "Job started%s.",
                    f" ({event.job_id})" if event.job_id is not None else "",
                )
                self.tracer.set_job_start_time(time.time())
                # Stamp the span timeline with the job's trace id (when the
                # master piggybacked one) so multi-job worker artifacts can
                # be partitioned by run; under the scheduler each announced
                # job also carries its submission id.
                args: dict | None = None
                if event.trace_id is not None:
                    args = {"trace_id": f"{event.trace_id:016x}"}
                if event.job_id is not None:
                    args = {**(args or {}), "job_id": event.job_id}
                self.span_tracer.instant(
                    "job started", cat="worker", track="job", args=args
                )

        async def handle_job_finished() -> None:
            request = await finished_queue.get()
            logger.info("Job finished; sending trace.")
            # A worker that never received event_job-started (an idle
            # shard drained before any job reached it) must still answer:
            # an unset start time would make build() raise, silently
            # killing this handler while the master waits out its 600 s
            # trace budget.
            self.tracer.ensure_job_start_time(time.time())
            self.tracer.set_job_finish_time(time.time())
            trace = self.tracer.build()
            self._final_trace = trace
            # Piggyback this worker's Chrome span timeline on the response:
            # every frame is finished by now, so the phase spans (and their
            # flow steps) are all recorded, and the master can assemble the
            # merged cluster timeline without another RPC.
            span_events = {
                "process_name": self.span_tracer.process_name,
                "events": self.span_tracer.metadata_events()
                + self.span_tracer.events(),
            }
            if self.span_tracer.dropped:
                # Truncation must stay visible across the wire: the master
                # records it in the merged document's otherData.
                span_events["dropped"] = self.span_tracer.dropped
            await sender.send_message(
                pm.WorkerJobFinishedResponse(
                    request.message_request_id, trace, span_events=span_events
                )
            )
            job_done.set()

        async def handle_drain() -> None:
            await self._drain_requested.wait()
            logger.info("Drain requested; finishing the in-flight frame.")
            await depart("drain")

        async def handle_migrate() -> None:
            event = await migrate_queue.get()
            logger.info(
                "Migrate requested (%s:%d%s); finishing the in-flight frame.",
                event.host,
                event.port,
                f", {event.reason}" if event.reason is not None else "",
            )
            # The worker returns its queue and exits; following the target
            # (re-homing) is not in the port yet.
            self.metrics.counter(
                "worker_migrations_total",
                "Master-requested re-homes to another shard (rebalancing)",
            ).inc()
            await depart("migrate")

        tasks = [
            asyncio.create_task(handle_adds()),
            asyncio.create_task(handle_removes()),
            asyncio.create_task(handle_job_started()),
            asyncio.create_task(handle_job_finished()),
            asyncio.create_task(handle_drain()),
            asyncio.create_task(handle_migrate()),
        ]
        job_done_task = asyncio.create_task(job_done.wait())
        try:
            # Select on BOTH job completion and receive-loop death: when
            # the master is gone for good (the reconnect budget exhausted
            # inside the receive op), no job-finished event will ever set
            # ``job_done`` — the failure must propagate instead of parking
            # this worker forever.
            await asyncio.wait(
                {job_done_task, router.dead},
                return_when=asyncio.FIRST_COMPLETED,
            )
            if not job_done.is_set():
                error = router.dead.result()
                if error is not None:
                    raise error
                raise WebSocketClosed(
                    "Receive loop ended before the job finished."
                )
        finally:
            job_done_task.cancel()
            for task in tasks:
                task.cancel()
            await asyncio.gather(
                job_done_task, *tasks, return_exceptions=True
            )
