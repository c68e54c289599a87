"""Minimal RFC 6455 WebSocket implementation over asyncio streams.

The reference rides tokio-tungstenite with 256 MB max message / 16 MB max
frame limits (reference: shared/src/websockets.rs:3-9); we keep the same
limits. Only what the job protocol needs is implemented: text messages,
ping/pong, close, and fragmentation on receive. Client-to-server frames are
masked per the RFC; masking uses a numpy XOR for large payloads (traces can
be tens of MB). The port's own copy of ``tpu_render_cluster/transport/ws.py``:
the reference's optional C++ masking codec is not part of it, so every
frame takes the numpy path.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import secrets
import struct

import numpy as np

MAX_MESSAGE_SIZE = 256 * 1024 * 1024  # reference: shared/src/websockets.rs:5
MAX_FRAME_SIZE = 16 * 1024 * 1024  # reference: shared/src/websockets.rs:7

_WS_MAGIC_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


class WebSocketError(Exception):
    """Protocol violation or I/O failure."""


class WebSocketClosed(WebSocketError):
    """The peer closed the connection (or the socket died)."""


def _mask_payload(payload: bytes, mask: bytes) -> bytes:
    if len(payload) >= 512:
        data = np.frombuffer(payload, dtype=np.uint8)
        key = np.frombuffer(
            (mask * ((len(payload) + 3) // 4))[: len(payload)], dtype=np.uint8
        )
        return (data ^ key).tobytes()
    return bytes(b ^ mask[i & 3] for i, b in enumerate(payload))


def encode_frame(opcode: int, payload: bytes, *, masked: bool, fin: bool = True) -> bytes:
    """Encode one WebSocket frame."""
    header = bytearray()
    header.append((0x80 if fin else 0x00) | opcode)
    mask_bit = 0x80 if masked else 0x00
    length = len(payload)
    if length < 126:
        header.append(mask_bit | length)
    elif length < 1 << 16:
        header.append(mask_bit | 126)
        header += struct.pack(">H", length)
    else:
        header.append(mask_bit | 127)
        header += struct.pack(">Q", length)
    if masked:
        mask = secrets.token_bytes(4)
        header += mask
        return bytes(header) + _mask_payload(payload, mask)
    return bytes(header) + payload


async def _read_exact(reader: asyncio.StreamReader, n: int) -> bytes:
    try:
        return await reader.readexactly(n)
    except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
        raise WebSocketClosed(f"Socket closed while reading: {e}") from e


async def read_frame(reader: asyncio.StreamReader) -> tuple[int, bool, bytes]:
    """Read one frame; returns (opcode, fin, payload) with unmasking applied."""
    head = await _read_exact(reader, 2)
    fin = bool(head[0] & 0x80)
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    length = head[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", await _read_exact(reader, 2))[0]
    elif length == 127:
        length = struct.unpack(">Q", await _read_exact(reader, 8))[0]
    if length > MAX_FRAME_SIZE:
        raise WebSocketError(f"Frame of {length} bytes exceeds the {MAX_FRAME_SIZE} limit.")
    mask = await _read_exact(reader, 4) if masked else None
    payload = await _read_exact(reader, length) if length else b""
    if mask:
        payload = _mask_payload(payload, mask)
    return opcode, fin, payload


class WebSocketConnection:
    """A single established WebSocket; handles control frames transparently."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        is_client: bool,
    ) -> None:
        self._reader = reader
        self._writer = writer
        self._is_client = is_client
        self._send_lock = asyncio.Lock()
        self._closed = False

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        if self._closed:
            raise WebSocketClosed("Connection is closed.")
        frame = encode_frame(opcode, payload, masked=self._is_client)
        async with self._send_lock:
            try:
                self._writer.write(frame)
                await self._writer.drain()
            except (ConnectionError, OSError) as e:
                self._closed = True
                raise WebSocketClosed(f"Socket died on send: {e}") from e

    async def send_text(self, text: str) -> None:
        data = text.encode("utf-8")
        if len(data) > MAX_MESSAGE_SIZE:
            raise WebSocketError(
                f"Message of {len(data)} bytes exceeds the {MAX_MESSAGE_SIZE} limit."
            )
        # Fragment oversized messages under the frame limit.
        if len(data) <= MAX_FRAME_SIZE:
            await self._send_frame(OP_TEXT, data)
            return
        if self._closed:
            raise WebSocketClosed("Connection is closed.")
        async with self._send_lock:
            try:
                for start in range(0, len(data), MAX_FRAME_SIZE):
                    chunk = data[start : start + MAX_FRAME_SIZE]
                    opcode = OP_TEXT if start == 0 else OP_CONT
                    fin = start + MAX_FRAME_SIZE >= len(data)
                    self._writer.write(
                        encode_frame(opcode, chunk, masked=self._is_client, fin=fin)
                    )
                await self._writer.drain()
            except (ConnectionError, OSError) as e:
                self._closed = True
                raise WebSocketClosed(f"Socket died on send: {e}") from e

    async def receive_text(self) -> str:
        """Receive the next complete text message, answering pings en route."""
        buffer = bytearray()
        expecting_continuation = False
        while True:
            opcode, fin, payload = await read_frame(self._reader)
            if opcode == OP_PING:
                await self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                self._closed = True
                try:
                    await self._send_frame(OP_CLOSE, b"")
                except WebSocketError:
                    pass
                raise WebSocketClosed("Peer sent close frame.")
            if opcode == OP_TEXT or opcode == OP_BINARY:
                if expecting_continuation:
                    raise WebSocketError("New data frame while awaiting continuation.")
                buffer += payload
                expecting_continuation = not fin
            elif opcode == OP_CONT:
                if not expecting_continuation:
                    raise WebSocketError("Unexpected continuation frame.")
                buffer += payload
                expecting_continuation = not fin
            else:
                raise WebSocketError(f"Unsupported opcode: {opcode:#x}")
            if len(buffer) > MAX_MESSAGE_SIZE:
                raise WebSocketError("Incoming message exceeds the size limit.")
            if not expecting_continuation:
                return bytes(buffer).decode("utf-8")

    async def close(self) -> None:
        if not self._closed:
            try:
                await self._send_frame(OP_CLOSE, struct.pack(">H", 1000))
            except WebSocketError:
                pass
            self._closed = True
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass

    def abort(self) -> None:
        """Tear down the socket without a close handshake (used on swap)."""
        self._closed = True
        try:
            self._writer.close()
        except (ConnectionError, OSError):
            pass


def _compute_accept(key: str) -> str:
    digest = hashlib.sha1((key + _WS_MAGIC_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


async def _read_http_headers(reader: asyncio.StreamReader) -> tuple[str, dict[str, str]]:
    raw = await reader.readuntil(b"\r\n\r\n")
    if len(raw) > 64 * 1024:
        raise WebSocketError("HTTP header block too large.")
    lines = raw.decode("latin-1").split("\r\n")
    start_line = lines[0]
    headers: dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    return start_line, headers


async def websocket_accept(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter
) -> WebSocketConnection:
    """Server side: perform the HTTP upgrade on a fresh TCP connection."""
    try:
        start_line, headers = await _read_http_headers(reader)
    except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
        raise WebSocketClosed(f"Connection died during upgrade: {e}") from e
    if not start_line.startswith("GET "):
        raise WebSocketError(f"Expected GET upgrade request, got: {start_line!r}")
    if headers.get("upgrade", "").lower() != "websocket":
        raise WebSocketError("Missing 'Upgrade: websocket' header.")
    key = headers.get("sec-websocket-key")
    if not key:
        raise WebSocketError("Missing Sec-WebSocket-Key header.")
    response = (
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {_compute_accept(key)}\r\n"
        "\r\n"
    )
    writer.write(response.encode("ascii"))
    await writer.drain()
    return WebSocketConnection(reader, writer, is_client=False)


async def websocket_connect(
    host: str, port: int, *, path: str = "/", connect_timeout: float = 10.0
) -> WebSocketConnection:
    """Client side: open TCP, perform the HTTP upgrade, validate the accept key."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), connect_timeout
        )
    except (ConnectionError, OSError, asyncio.TimeoutError) as e:
        raise WebSocketClosed(f"TCP connect to {host}:{port} failed: {e}") from e
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    request = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}:{port}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n"
        "\r\n"
    )
    try:
        writer.write(request.encode("ascii"))
        await writer.drain()
        start_line, headers = await _read_http_headers(reader)
    except (asyncio.IncompleteReadError, ConnectionError, OSError) as e:
        writer.close()
        raise WebSocketClosed(f"Connection died during upgrade: {e}") from e
    if "101" not in start_line:
        writer.close()
        raise WebSocketError(f"Upgrade rejected: {start_line!r}")
    if headers.get("sec-websocket-accept") != _compute_accept(key):
        writer.close()
        raise WebSocketError("Invalid Sec-WebSocket-Accept from server.")
    return WebSocketConnection(reader, writer, is_client=True)
