"""Sampled asyncio event-loop lag probe.

It measures how late the loop actually runs scheduled callbacks. The
probe sleeps ``TRC_OBS_LOOPMON_INTERVAL`` seconds and compares the
monotonic wake time against the scheduled one: the delta is exactly the
time some other callback held the loop (GC pauses, an unexpectedly-sync
hot path, a compiler sneaking onto the loop). Each sample feeds the
``obs_loop_lag_seconds{role}`` histogram; samples over
``TRC_OBS_LOOPMON_THRESHOLD`` count a blocked episode
(``obs_loop_blocked_episodes_total{role}``), draw a span on the "loop"
Perfetto track covering the blocked window.

The port's own copy of ``tpu_render_cluster/obs/loopmon.py``, for its
worker runtime (``role="worker"``); the reference's flight-recorder hook
belongs to its master.
"""

from __future__ import annotations

import asyncio
import logging
import time

from tpu_render_cluster_torch.utils.env import env_float

__all__ = ["LoopLagMonitor", "LAG_METRIC", "EPISODES_METRIC"]

logger = logging.getLogger(__name__)

LAG_METRIC = "obs_loop_lag_seconds"
EPISODES_METRIC = "obs_loop_blocked_episodes_total"

_LAG_HELP = "Event-loop callback lag (scheduled vs actual wake) by role"
_EPISODES_HELP = "Loop-lag samples over TRC_OBS_LOOPMON_THRESHOLD by role"


def loopmon_interval_seconds() -> float:
    return max(0.001, env_float("TRC_OBS_LOOPMON_INTERVAL", 0.25))


def loopmon_threshold_seconds() -> float:
    return max(0.0, env_float("TRC_OBS_LOOPMON_THRESHOLD", 0.1))


class LoopLagMonitor:
    """Periodic lag sampler for the current event loop.

    ``start()`` inside a running loop; ``await stop()`` on teardown.
    The span tracer is optional.
    """

    def __init__(
        self,
        metrics,
        *,
        role: str,
        span_tracer=None,
    ) -> None:
        self.metrics = metrics
        self.role = role
        self.span_tracer = span_tracer
        self.samples = 0
        self.blocked_episodes = 0
        self.max_lag_seconds = 0.0
        self._lag = metrics.histogram(LAG_METRIC, _LAG_HELP, labels=("role",))
        self._episodes = metrics.counter(
            EPISODES_METRIC, _EPISODES_HELP, labels=("role",)
        )
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(
                self._run(), name=f"loopmon-{self.role}"
            )

    async def stop(self) -> None:
        if self._task is None:
            return
        self._task.cancel()
        try:
            await self._task
        except asyncio.CancelledError:
            pass
        self._task = None

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            interval = loopmon_interval_seconds()
            scheduled = loop.time() + interval
            await asyncio.sleep(interval)
            lag = max(0.0, loop.time() - scheduled)
            self.samples += 1
            self.max_lag_seconds = max(self.max_lag_seconds, lag)
            self._lag.observe(lag, role=self.role)
            if lag >= loopmon_threshold_seconds():
                self._record_episode(lag)

    def _record_episode(self, lag: float) -> None:
        self.blocked_episodes += 1
        self._episodes.inc(role=self.role)
        logger.warning(
            "Event loop (%s) blocked ~%.3fs (threshold %.3fs).",
            self.role, lag, loopmon_threshold_seconds(),
        )
        if self.span_tracer is not None:
            # The lag window ends at the sample; anchor the span so it
            # covers the time the loop was held.
            self.span_tracer.complete(
                "loop blocked",
                cat="obs",
                start_wall=time.time() - lag,
                duration=lag,
                track="loop",
                args={"role": self.role, "lag_s": round(lag, 6)},
            )
