"""Per-message-tag wire-cost accounting around the protocol codec.

Every control-plane byte crosses exactly one seam: ``encode_message`` on
the way out and ``decode_message`` on the way in (protocol/messages.py).
``WireAccounting`` wraps that seam with a metrics registry so both ends
of a socket price their traffic per message tag —

- ``transport_message_bytes_total{tag,direction}``: exact UTF-8 wire
  payload bytes. ``encode_message`` emits ASCII-escaped JSON
  (``json.dumps`` default ``ensure_ascii=True``), so ``len(text)`` IS
  the byte count the WebSocket layer frames; the sender's ``send``
  series and the receiver's ``recv`` series for a tag count the same
  bytes and must agree exactly.
- ``transport_serialize_seconds{tag,direction}``: time spent in
  ``json.dumps``/``json.loads`` per message.

The accounting observes the text the codec already produces — it adds
ZERO bytes on the wire and, with ``metrics=None``, is the bare codec. The
port's own copy of ``tpu_render_cluster/transport/wirecost.py`` (its
worker's side).
"""

from __future__ import annotations

import time

from tpu_render_cluster_torch.protocol import messages as pm

__all__ = ["WireAccounting"]

BYTES_METRIC = "transport_message_bytes_total"
SERIALIZE_METRIC = "transport_serialize_seconds"

_BYTES_HELP = "Wire payload bytes by message tag and direction"
_SERIALIZE_HELP = "Message JSON serialize/parse seconds by tag and direction"
_LABELS = ("tag", "direction")


class WireAccounting:
    """Codec wrapper recording per-tag byte and serialize-time series.

    One instance per connection endpoint; instances sharing a registry
    share series. With
    ``metrics=None`` both methods are passthroughs to the codec.
    """

    def __init__(self, metrics=None) -> None:
        self.metrics = metrics
        if metrics is not None:
            self._bytes = metrics.counter(BYTES_METRIC, _BYTES_HELP, labels=_LABELS)
            self._seconds = metrics.histogram(
                SERIALIZE_METRIC, _SERIALIZE_HELP, labels=_LABELS
            )

    def encode(self, message: pm.Message) -> str:
        if self.metrics is None:
            return pm.encode_message(message)
        started = time.perf_counter()
        text = pm.encode_message(message)
        elapsed = time.perf_counter() - started
        tag = message.type_name
        self._seconds.observe(elapsed, tag=tag, direction="send")
        self._bytes.inc(len(text), tag=tag, direction="send")
        return text

    def decode(self, text: str | bytes) -> pm.Message:
        if self.metrics is None:
            return pm.decode_message(text)
        started = time.perf_counter()
        message = pm.decode_message(text)
        elapsed = time.perf_counter() - started
        tag = message.type_name
        self._seconds.observe(elapsed, tag=tag, direction="recv")
        self._bytes.inc(len(text), tag=tag, direction="recv")
        return message

