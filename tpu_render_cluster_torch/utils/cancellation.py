"""Cooperative cancellation token (the port's own copy).

Semantics follow the reference's clonable atomic-bool token that every task
loop polls (reference: shared/src/cancellation.rs:5-24).
"""

from __future__ import annotations

import threading


class CancellationToken:
    """Thread-safe, clonable-by-reference cancellation flag."""

    __slots__ = ("_event",)

    def __init__(self) -> None:
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    def is_cancelled(self) -> bool:
        return self._event.is_set()
