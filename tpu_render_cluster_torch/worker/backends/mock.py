"""Sleep-based fake renderer (the port's counterpart of the reference's
``mock`` backend): exercises the worker process, strategies, steals and
trace collection without a GPU. Each unit sleeps a fixed time per phase.
"""

from __future__ import annotations

import asyncio
import time

from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.traces.worker_trace import FrameRenderTime
from tpu_render_cluster_torch.worker.backends.base import RenderBackend

LOAD_SECONDS = 0.005
RENDER_SECONDS = 0.02
SAVE_SECONDS = 0.005


class MockBackend(RenderBackend):
    async def render_frame(
        self, job: BlenderJob, frame_index: int, tile: int | None = None
    ) -> FrameRenderTime:
        started_process = time.time()
        await asyncio.sleep(LOAD_SECONDS)
        finished_loading = time.time()
        await asyncio.sleep(RENDER_SECONDS)
        finished_rendering = time.time()
        await asyncio.sleep(SAVE_SECONDS)
        saving_finished = time.time()
        return FrameRenderTime(
            started_process_at=started_process,
            finished_loading_at=finished_loading,
            started_rendering_at=finished_loading,
            finished_rendering_at=finished_rendering,
            file_saving_started_at=finished_rendering,
            file_saving_finished_at=saving_finished,
            exited_process_at=time.time(),
        )
