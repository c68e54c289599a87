"""Span tracer with Chrome trace-event export (the port's own copy).

Spans carry BOTH clocks: wall-clock (``time.time``) anchors the span on the
trace timeline (and lets traces from different processes line up), and the
monotonic clock (``time.perf_counter``) measures the duration, immune to
NTP steps. Export is the Chrome trace-event JSON object format —
``{"traceEvents": [...]}`` with ``ph: "X"`` complete events — which loads
directly in Perfetto (https://ui.perfetto.dev) or chrome://tracing.

Each ``Tracer`` is one *process row* in the viewer (``pid``); tracks within
it (``tid``) are named virtual threads, so asyncio tasks that interleave on
one OS thread still render as separate, properly-nested lanes. The in-
process harness merges the master tracer and every worker tracer into one
file via ``export_chrome_trace`` — indistinguishable from a multi-host
collection.
"""

from __future__ import annotations

import itertools
import json
import logging
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Iterable, Mapping

__all__ = ["Tracer", "export_chrome_trace"]

logger = logging.getLogger(__name__)

_pid_counter = itertools.count(1)

# Bounded event buffers: a 14400-frame job emits ~5 events per frame; the
# cap keeps a runaway instrumentation site from eating the master's heap.
MAX_EVENTS = 200_000


class Tracer:
    """Thread-safe span collector for one logical process."""

    def __init__(
        self, process_name: str, *, pid: int | None = None, max_events: int = MAX_EVENTS
    ) -> None:
        self.process_name = process_name
        self.pid = next(_pid_counter) if pid is None else pid
        self._max_events = max_events
        self._lock = threading.Lock()
        self._events: list[dict[str, Any]] = []
        self._dropped = 0
        self._tracks: dict[str, int] = {}

    # -- recording -----------------------------------------------------------

    def _tid(self, track: str | None) -> int:
        if track is None:
            return threading.get_ident() & 0x7FFFFFFF
        with self._lock:
            tid = self._tracks.get(track)
            if tid is None:
                tid = len(self._tracks) + 1
                self._tracks[track] = tid
            return tid

    def _append(self, event: dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(event)

    def complete(
        self,
        name: str,
        *,
        cat: str = "",
        start_wall: float,
        duration: float,
        track: str | None = None,
        args: Mapping[str, Any] | None = None,
    ) -> None:
        """Record a finished span from explicit timestamps (seconds)."""
        event: dict[str, Any] = {
            "name": name,
            "cat": cat or "default",
            "ph": "X",
            "pid": self.pid,
            "tid": self._tid(track),
            "ts": round(start_wall * 1e6, 3),
            "dur": round(max(0.0, duration) * 1e6, 3),
        }
        if args:
            event["args"] = dict(args)
        self._append(event)

    def instant(
        self,
        name: str,
        *,
        cat: str = "",
        track: str | None = None,
        args: Mapping[str, Any] | None = None,
    ) -> None:
        event: dict[str, Any] = {
            "name": name,
            "cat": cat or "default",
            "ph": "i",
            "s": "t",
            "pid": self.pid,
            "tid": self._tid(track),
            "ts": round(time.time() * 1e6, 3),
        }
        if args:
            event["args"] = dict(args)
        self._append(event)

    # -- flow events ---------------------------------------------------------
    #
    # Perfetto flow events ("s" start / "t" step / "f" end, matched by id)
    # draw arrows between spans on different process rows — the causal link
    # from a master-side assignment to the worker-side frame phases. A flow
    # event binds to the slice that encloses its ``ts`` on its (pid, tid)
    # track, so emitters place the flow timestamp INSIDE the span it should
    # attach to (mid-span is the safe choice for zero-duration spans).

    def _flow(
        self,
        phase: str,
        name: str,
        *,
        id: str,
        ts: float,
        cat: str = "",
        track: str | None = None,
        args: Mapping[str, Any] | None = None,
    ) -> None:
        event: dict[str, Any] = {
            "name": name,
            "cat": cat or "flow",
            "ph": phase,
            "id": id,
            "pid": self.pid,
            "tid": self._tid(track),
            "ts": round(ts * 1e6, 3),
        }
        if phase == "f":
            event["bp"] = "e"  # bind the arrowhead to the enclosing slice
        if args:
            event["args"] = dict(args)
        self._append(event)

    def flow_step(self, name: str, *, id: str, ts: float, **kwargs: Any) -> None:
        """Route an open flow through the span enclosing ``ts``."""
        self._flow("t", name, id=id, ts=ts, **kwargs)

    @contextmanager
    def span(
        self,
        name: str,
        *,
        cat: str = "",
        track: str | None = None,
        args: Mapping[str, Any] | None = None,
    ):
        """Context manager span: wall-clock anchor, monotonic duration."""
        start_wall = time.time()
        start_mono = time.perf_counter()
        try:
            yield
        finally:
            self.complete(
                name,
                cat=cat,
                start_wall=start_wall,
                duration=time.perf_counter() - start_mono,
                track=track,
                args=args,
            )

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        """Drop buffered events (and the dropped counter); track-name
        assignments persist so tids stay stable across exports. Exporters
        of long-lived shared tracers (the process-global one) call this
        after a write so the next artifact holds only its own run's
        spans."""
        with self._lock:
            self._events.clear()
            self._dropped = 0

    @property
    def dropped(self) -> int:
        return self._dropped

    def metadata_events(self) -> list[dict[str, Any]]:
        """process_name / thread_name metadata for the viewer's labels."""
        out = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.pid,
                "tid": 0,
                "args": {"name": self.process_name},
            }
        ]
        with self._lock:
            tracks = dict(self._tracks)
        for track, tid in tracks.items():
            out.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        return out

    def to_chrome(self) -> dict[str, Any]:
        # Truncation must not be silent: a capped buffer drops the TAIL of
        # the run, and a viewer (or the analysis roll-up) reading a clean-
        # looking file would conclude the instrumented window covered the
        # whole job. The count rides in the document (otherData survives
        # the object format) and is also logged at export time.
        out: dict[str, Any] = {
            "traceEvents": self.metadata_events() + self.events(),
            "displayTimeUnit": "ms",
        }
        if self._dropped:
            out["otherData"] = {
                "dropped_events": {self.process_name: self._dropped}
            }
        return out

    def export(self, path: str | Path) -> Path:
        if self._dropped:
            logger.warning(
                "Tracer %r dropped %d events past the %d-event cap; the "
                "exported timeline is truncated.",
                self.process_name, self._dropped, self._max_events,
            )
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome()), encoding="utf-8")
        return path


def export_chrome_trace(path: str | Path, tracers: Iterable[Tracer]) -> Path:
    """Merge several tracers (master + workers) into one loadable file."""
    events: list[dict[str, Any]] = []
    dropped: dict[str, int] = {}
    for tracer in tracers:
        events.extend(tracer.metadata_events())
        events.extend(tracer.events())
        if tracer.dropped:
            dropped[tracer.process_name] = tracer.dropped
            logger.warning(
                "Tracer %r dropped %d events past its cap; the exported "
                "timeline is truncated.", tracer.process_name, tracer.dropped,
            )
    document: dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    if dropped:
        document["otherData"] = {"dropped_events": dropped}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(document), encoding="utf-8")
    return path
