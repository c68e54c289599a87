from tpu_render_cluster_torch.transport.ws import (
    MAX_FRAME_SIZE,
    MAX_MESSAGE_SIZE,
    WebSocketClosed,
    WebSocketConnection,
    WebSocketError,
    websocket_accept,
    websocket_connect,
)

__all__ = [
    "MAX_FRAME_SIZE",
    "MAX_MESSAGE_SIZE",
    "WebSocketClosed",
    "WebSocketConnection",
    "WebSocketError",
    "websocket_accept",
    "websocket_connect",
]
