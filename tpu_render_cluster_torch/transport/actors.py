"""Connection actor runtime: sender queue and typed receiver fan-out.

The reference runs three cooperating tokio tasks per connection — a sender
draining an mpsc queue (with a oneshot fired when the message is actually
written), a receiver fanning each message variant into a per-type broadcast
channel, and a requester composing the two into RPC with request-id
correlation (reference: master/src/connection/{sender,receiver,requester}.rs,
worker/src/connection/{sender,receiver}.rs). This is the asyncio
re-expression of the worker's side of it: one sender task, one receiver
task and per-type subscriber queues. The port's own copy of
``tpu_render_cluster/transport/actors.py`` without the master's RPC helpers.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, TypeVar

from tpu_render_cluster_torch.protocol.messages import Message

logger = logging.getLogger(__name__)

M = TypeVar("M", bound=Message)


class SenderHandle:
    """Queue-backed message sender; ``send_message`` resolves when written.

    Reference semantics: shared/src/messages/mod.rs:41-75 (enqueue + await
    the "actually sent" oneshot).
    """

    def __init__(self, send_fn: Callable[[Message], Awaitable[None]]) -> None:
        self._send_fn = send_fn
        self._queue: asyncio.Queue[tuple[Message, asyncio.Future]] = asyncio.Queue()
        self._task: asyncio.Task | None = None
        self._closed = False

    def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name="sender")

    async def _run(self) -> None:
        while True:
            message, done = await self._queue.get()
            if message is None:  # shutdown sentinel
                if not done.done():
                    done.set_result(None)
                return
            try:
                await self._send_fn(message)
                if not done.done():
                    done.set_result(None)
            except Exception as e:  # propagate to the waiting caller
                if not done.done():
                    done.set_exception(e)

    async def send_message(self, message: Message) -> None:
        """Enqueue and wait until the message has actually been written."""
        if self._closed:
            raise ConnectionError("Sender is closed.")
        done: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((message, done))
        await done

    async def stop(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._task is not None:
            done: asyncio.Future = asyncio.get_running_loop().create_future()
            await self._queue.put((None, done))  # type: ignore[arg-type]
            try:
                await asyncio.wait_for(self._task, 5.0)
            except asyncio.TimeoutError:
                self._task.cancel()


class MessageRouter:
    """Receiver fan-out: parses incoming messages, dispatches by type.

    Each ``subscribe`` returns an independent queue (broadcast semantics,
    like the reference's per-type ``tokio::broadcast`` channels of capacity
    512 — master/src/connection/receiver.rs:30-47). Slow subscribers drop
    the oldest entries rather than erroring.
    """

    QUEUE_CAPACITY = 512

    def __init__(self, receive_fn: Callable[[], Awaitable[Message]]) -> None:
        self._receive_fn = receive_fn
        self._subscribers: dict[type[Message], list[asyncio.Queue[Message]]] = {}
        self._task: asyncio.Task | None = None
        self._dead: asyncio.Future | None = None

    def start(self) -> None:
        self._dead = asyncio.get_running_loop().create_future()
        self._task = asyncio.create_task(self._run(), name="receiver")

    @property
    def dead(self) -> asyncio.Future:
        """Resolves (with the exception) when the receive loop dies."""
        assert self._dead is not None
        return self._dead

    async def _run(self) -> None:
        try:
            while True:
                message = await self._receive_fn()
                self._dispatch(message)
        except asyncio.CancelledError:
            if self._dead and not self._dead.done():
                self._dead.set_result(None)
            raise
        except Exception as e:
            logger.debug("Receiver loop terminated: %s", e)
            if self._dead and not self._dead.done():
                self._dead.set_result(e)

    def _dispatch(self, message: Message) -> None:
        queues = self._subscribers.get(type(message))
        if not queues:
            logger.warning("No subscriber for %s; dropping.", type(message).__name__)
            return
        for queue in queues:
            if queue.full():
                try:
                    queue.get_nowait()  # drop-oldest
                except asyncio.QueueEmpty:
                    pass
            queue.put_nowait(message)

    def subscribe(self, message_type: type[M]) -> asyncio.Queue:
        queue: asyncio.Queue = asyncio.Queue(self.QUEUE_CAPACITY)
        self._subscribers.setdefault(message_type, []).append(queue)
        return queue

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

