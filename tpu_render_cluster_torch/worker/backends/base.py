"""Render backend interface (the port's own copy)."""

from __future__ import annotations

import abc

from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.traces.worker_trace import FrameRenderTime


class RenderBackend(abc.ABC):
    """Renders one frame of a job and reports 7-phase timing.

    Implementations must write the output file to the job's resolved output
    directory and return a ``FrameRenderTime`` whose phases are monotonic
    (the performance reducer of the analysis suite requires it).

    Tiled jobs: when the job carries a tile grid, ``render_frame`` is
    called once per ``(frame, tile)`` work unit with ``tile`` set. A
    backend that cannot render sub-frame regions must raise a clear error
    instead of silently rendering the whole frame under a tile's name.
    """

    @abc.abstractmethod
    async def render_frame(
        self, job: BlenderJob, frame_index: int, tile: int | None = None
    ) -> FrameRenderTime:
        ...
