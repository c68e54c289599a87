"""Reconnection semantics of the worker's side of the cluster link.

The reference treats a connection as a *logical* entity that survives socket
death: the worker actively reconnects with exponential backoff (base 2.0,
30 s cap, max 12 retries — worker/src/connection/mod.rs:360-398,475-487) and
re-handshakes with ``handshake_type=reconnecting``; the master passively
accepts the reconnect handshake and swaps the new socket into the existing
connection object while in-flight send/receive calls wait for the swap
(master/src/cluster/mod.rs:45-231,453-477). The port's own copy of
``tpu_render_cluster/transport/reconnect.py`` keeps the worker's side only.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import TYPE_CHECKING, Awaitable, Callable

from tpu_render_cluster_torch.transport.ws import (
    WebSocketClosed,
    WebSocketConnection,
    websocket_connect,
)
from tpu_render_cluster_torch.utils.env import env_float, env_int

if TYPE_CHECKING:
    from tpu_render_cluster_torch.obs import MetricsRegistry

logger = logging.getLogger(__name__)


class TransportMetrics:
    """Message/byte/reconnect accounting for one logical connection,
    labeled by direction."""

    def __init__(self, registry: "MetricsRegistry") -> None:
        self._messages = registry.counter(
            "transport_messages_total",
            "WS text messages through the logical connection",
            labels=("direction",),
        )
        self._bytes = registry.counter(
            "transport_bytes_total",
            "Payload characters through the logical connection (~bytes; "
            "the protocol JSON is ASCII)",
            labels=("direction",),
        )
        self._reconnects = registry.counter(
            "transport_reconnects_total", "Socket replacements survived"
        )
        self._connect_attempts = registry.counter(
            "transport_connect_attempts_total",
            "TCP connect + WS upgrade attempts (incl. backoff retries)",
        )

    def sent(self, text: str) -> None:
        self._messages.inc(direction="sent")
        self._bytes.inc(len(text), direction="sent")

    def received(self, text: str) -> None:
        self._messages.inc(direction="received")
        self._bytes.inc(len(text), direction="received")

    def reconnected(self) -> None:
        self._reconnects.inc()

    def connect_attempt(self) -> None:
        self._connect_attempts.inc()

# Reference: worker/src/connection/mod.rs:360-398,475-487. All of these are
# defaults behind TRC_* environment overrides (utils/env.py): deployments
# with different failure profiles — and the chaos harness, which compresses
# every timeout — retune them without code changes.
BACKOFF_BASE = 2.0
BACKOFF_CAP_SECONDS = 30.0
MAX_CONNECT_RETRIES = 12
# Reference: worker/src/connection/mod.rs:133-274 (per-op reconnect budget).
MAX_RECONNECTS_PER_OP = 2
OP_DEADLINE_SECONDS = 30.0


def backoff_base() -> float:
    return env_float("TRC_BACKOFF_BASE", BACKOFF_BASE)


def backoff_cap_seconds() -> float:
    return env_float("TRC_BACKOFF_CAP_SECONDS", BACKOFF_CAP_SECONDS)


def max_connect_retries() -> int:
    return env_int("TRC_MAX_CONNECT_RETRIES", MAX_CONNECT_RETRIES)


def max_reconnects_per_op() -> int:
    return env_int("TRC_MAX_RECONNECTS_PER_OP", MAX_RECONNECTS_PER_OP)


def op_deadline_seconds() -> float:
    return env_float("TRC_OP_DEADLINE_SECONDS", OP_DEADLINE_SECONDS)


async def connect_with_exponential_backoff(
    host: str,
    port: int,
    *,
    max_retries: int | None = None,
    base: float | None = None,
    cap_seconds: float | None = None,
    metrics: TransportMetrics | None = None,
) -> WebSocketConnection:
    """TCP connect + WS upgrade with full-jitter exponential backoff.

    Each retry sleeps ``uniform(0, min(cap, base**attempt))`` (AWS
    "full jitter"): after a master restart every worker of a large cluster
    retries at an independently random moment instead of reconnecting in
    lockstep at the same deterministic ``base**attempt`` instants.
    """
    max_retries = max_connect_retries() if max_retries is None else max_retries
    base = backoff_base() if base is None else base
    cap_seconds = backoff_cap_seconds() if cap_seconds is None else cap_seconds
    last_error: Exception | None = None
    for attempt in range(max_retries + 1):
        try:
            if metrics is not None:
                metrics.connect_attempt()
            return await websocket_connect(host, port)
        except (WebSocketClosed, OSError) as e:
            last_error = e
            if attempt == max_retries:
                break
            delay = random.uniform(0.0, min(base**attempt, cap_seconds))
            logger.debug(
                "Connect attempt %d/%d to %s:%d failed (%s); retrying in %.2f s",
                attempt + 1, max_retries, host, port, e, delay,
            )
            await asyncio.sleep(delay)
    raise WebSocketClosed(
        f"Could not connect to {host}:{port} after {max_retries} retries: {last_error}"
    )


class ReconnectingClient:
    """Worker-side logical connection with transparent reconnect.

    ``reconnect_fn`` re-establishes the socket AND replays the application
    handshake (with ``handshake_type=reconnecting``); it returns the new
    ``WebSocketConnection``. Send/receive transparently retry through at
    most ``MAX_RECONNECTS_PER_OP`` reconnects within a 30 s op deadline,
    recording each outage window via ``on_reconnect(lost_at, restored_at)``.
    """

    def __init__(
        self,
        connection: WebSocketConnection,
        reconnect_fn: Callable[[], Awaitable[WebSocketConnection]],
        *,
        on_reconnect: Callable[[float, float], None] | None = None,
        metrics: TransportMetrics | None = None,
    ) -> None:
        self._connection = connection
        self._reconnect_fn = reconnect_fn
        self._on_reconnect = on_reconnect
        self._metrics = metrics
        self._reconnect_lock = asyncio.Lock()
        self._generation = 0
        self._closed = False

    @property
    def connection(self) -> WebSocketConnection:
        return self._connection

    def close(self) -> None:
        self._closed = True
        self._connection.abort()

    async def _reconnect(self, failed_generation: int, lost_at: float) -> None:
        """Re-establish the socket once (deduplicated across concurrent ops).

        ``lost_at`` is the wall-clock time of the failing op's FIRST
        exception, stamped by the caller before it contends for the
        reconnect lock: under concurrent op failures the lock is held for
        the whole reconnect, and stamping at lock *acquisition* (as this
        used to) would shorten every recorded outage window by however long
        the op queued behind its siblings.
        """
        async with self._reconnect_lock:
            if self._generation != failed_generation:
                return  # another task already reconnected
            if self._closed:
                raise WebSocketClosed("Client is closed.")
            self._connection.abort()
            self._connection = await self._reconnect_fn()
            self._generation += 1
            if self._metrics is not None:
                self._metrics.reconnected()
            if self._on_reconnect is not None:
                self._on_reconnect(lost_at, time.time())
            logger.info("Reconnected to master (generation %d).", self._generation)

    async def _with_retries(self, op: Callable[[WebSocketConnection], Awaitable]):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + op_deadline_seconds()
        reconnect_budget = max_reconnects_per_op()
        reconnects = 0
        while True:
            connection = self._connection
            generation = self._generation
            try:
                return await op(connection)
            except WebSocketClosed:
                lost_at = time.time()
                if self._closed:
                    raise
                reconnects += 1
                if reconnects > reconnect_budget or loop.time() > deadline:
                    raise
                while True:
                    try:
                        await self._reconnect(generation, lost_at)
                        break
                    except WebSocketClosed:
                        # The reconnect ATTEMPT failed — e.g. the master
                        # died mid-handshake (TCP accepted, then the
                        # process was torn down before its
                        # acknowledgement). That must not kill the op (a
                        # worker racing a master failover would give up
                        # exactly when its standby is about to appear),
                        # and it must not burn the per-op reconnect
                        # budget either: a dying master can refuse
                        # handshakes in MILLISECONDS, faster than any
                        # budget survives. Attempt failures are bounded
                        # by the op DEADLINE instead, with a short pause
                        # so refusals don't spin the loop hot.
                        if self._closed or loop.time() > deadline:
                            raise
                        await asyncio.sleep(
                            min(0.25, backoff_cap_seconds())
                        )

    async def send_text(self, text: str) -> None:
        await self._with_retries(lambda c: c.send_text(text))
        if self._metrics is not None:
            self._metrics.sent(text)

    async def receive_text(self) -> str:
        text = await self._with_retries(lambda c: c.receive_text())
        if self._metrics is not None:
            self._metrics.received(text)
        return text

