"""The port's WebSocket transport against the reference's, over real sockets.

The port's client talks to the reference's ``websocket_accept`` server and
the reference's ``websocket_connect`` client to the port's server: short
payloads, the 16- and 64-bit length forms (a payload past 64 KiB), a
message fragmented past the 16 MiB frame limit, masked client frames and a
clean close. The frame codecs are held against each other directly, and the
port's ``ReconnectingClient`` survives a dropped socket.
"""

from __future__ import annotations

import asyncio
import random

import pytest

from tpu_render_cluster.transport import ws as ref_ws
from tpu_render_cluster_torch.transport import ws as port_ws
from tpu_render_cluster_torch.transport.reconnect import (
    ReconnectingClient,
    connect_with_exponential_backoff,
)

SIZES = [0, 5, 125, 126, 65_535, 65_536, 70_000]
SIDES = {"port": port_ws, "reference": ref_ws}


def _text(size: int, seed: int) -> str:
    rng = random.Random(seed)
    return "".join(rng.choice("abcdefghij{}[]:,\"0123456789") for _ in range(size))


def _run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _close(tcp_server) -> None:
    tcp_server.close()
    await asyncio.wait_for(tcp_server.wait_closed(), 5.0)


async def _echo_server(server_ws, received: list[str], closed: asyncio.Event):
    """An echo server on ``server_ws``'s accept; returns (server, port)."""

    async def handle(reader, writer):
        connection = await server_ws.websocket_accept(reader, writer)
        try:
            while True:
                text = await connection.receive_text()
                received.append(text)
                await connection.send_text(text)
        except server_ws.WebSocketClosed:
            closed.set()
        finally:
            connection.abort()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1]


@pytest.mark.parametrize(
    "client,server", [("port", "reference"), ("reference", "port")]
)
def test_echo_and_clean_close(client, server):
    client_ws, server_ws = SIDES[client], SIDES[server]
    messages = [_text(size, seed) for seed, size in enumerate(SIZES)]
    # Fragmented on send: one text message past the 16 MiB frame limit.
    messages.append("x" * (client_ws.MAX_FRAME_SIZE + 7))

    async def scenario():
        received: list[str] = []
        closed = asyncio.Event()
        tcp_server, port = await _echo_server(server_ws, received, closed)
        connection = None
        try:
            connection = await client_ws.websocket_connect("127.0.0.1", port)
            for text in messages:
                await connection.send_text(text)
                assert await connection.receive_text() == text
            await connection.close()
            await asyncio.wait_for(closed.wait(), 10.0)
            return received
        finally:
            if connection is not None:
                connection.abort()
            await _close(tcp_server)

    assert _run(scenario()) == messages


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize(
    "writer,reader", [("port", "reference"), ("reference", "port")]
)
def test_frame_codec_cross_reads(writer, reader, size):
    payload = _text(size, size).encode()
    write_ws, read_ws = SIDES[writer], SIDES[reader]

    async def scenario():
        for masked in (True, False):
            frame = write_ws.encode_frame(write_ws.OP_TEXT, payload, masked=masked)
            assert bool(frame[1] & 0x80) == masked
            length_form = frame[1] & 0x7F
            assert length_form == (size if size < 126 else 126 if size < 1 << 16 else 127)
            if masked and size:
                assert payload not in frame  # the body is masked on the wire
            stream = asyncio.StreamReader()
            stream.feed_data(frame)
            stream.feed_eof()
            opcode, fin, body = await read_ws.read_frame(stream)
            assert (opcode, fin, body) == (read_ws.OP_TEXT, True, payload)

    _run(scenario())


def test_reconnecting_client_survives_a_dropped_socket():
    """The reference's server greets each socket and drops the first one
    after one echo; the client's next receive reconnects and carries on."""

    async def scenario():
        connections = 0

        async def handle(reader, writer):
            nonlocal connections
            connections += 1
            number = connections
            connection = await ref_ws.websocket_accept(reader, writer)
            try:
                await connection.send_text(f"hello-{number}")
                while True:
                    await connection.send_text(await connection.receive_text())
                    if number == 1:
                        return  # drop without a close frame
            except ref_ws.WebSocketClosed:
                pass
            finally:
                connection.abort()

        tcp_server = await asyncio.start_server(handle, "127.0.0.1", 0)
        port = tcp_server.sockets[0].getsockname()[1]
        outages: list[tuple[float, float]] = []
        received = []
        try:
            first = await connect_with_exponential_backoff("127.0.0.1", port, max_retries=2)
            client = ReconnectingClient(
                first,
                lambda: connect_with_exponential_backoff("127.0.0.1", port, max_retries=2),
                on_reconnect=lambda lost, back: outages.append((lost, back)),
            )
            try:
                received.append(await client.receive_text())
                await client.send_text("before")
                received.append(await client.receive_text())
                # The socket is gone now: this receive goes through a reconnect.
                received.append(await client.receive_text())
                await client.send_text("after")
                received.append(await client.receive_text())
            finally:
                client.close()
        finally:
            await _close(tcp_server)
        return connections, outages, received

    connections, outages, received = _run(scenario())
    assert received == ["hello-1", "before", "hello-2", "after"]
    assert connections == 2
    assert len(outages) == 1 and outages[0][0] <= outages[0][1]


def test_env_knobs_are_the_references():
    """Every ``TRC_*`` name the port reads through its env helpers is
    declared in its ``utils/env.py``, and each declaration is the
    reference's own (name, grammar, default): the port adds no knob."""
    import ast
    from pathlib import Path

    from tpu_render_cluster.utils import env as ref_env
    from tpu_render_cluster_torch.utils import env as port_env

    port = Path(port_env.__file__).resolve().parent.parent
    read = set()
    for path in port.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("env_int", "env_float", "env_str")
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                read.add(node.args[0].value)
    assert read == set(port_env.ENV_VARS)
    for name, var in port_env.ENV_VARS.items():
        reference = ref_env.ENV_VARS[name]
        assert (var.kind, var.default) == (reference.kind, reference.default), name
