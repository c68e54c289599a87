"""Multi-device frame rendering: tile bands, spp subsets, frame batches.

Port of ``tpu_render_cluster/parallel/sharded_render.py``. The reference
traces ``render_tile`` under ``shard_map`` over a 1-D device mesh and
combines the shards with XLA collectives. Here a frame's inputs (scene,
camera, instances and TLAS operands) are computed once on the host
(``frame_inputs``) and copied to each device, each shard is one
``render_tile`` call on its own device, issued in turn from one thread
(``_on_devices``), and the shards of a process are combined on its first
device; the processes of a multi-host group (``mesh.initialize_multihost``)
then exchange their parts through ``torch.distributed``.

The host's eager work sets a frame's time here: on an H100 host four
cards took one card's time for the same shards (PERF.md, section 6), so
sharding buys no frames/s yet. It is the reference's option, kept for
parity; a node's cards render more frames as one worker process each
(``--device cuda:i``), each handed its own frames by the master.

- ``render_frame_sharded(mode="tile")``: shard ``b`` of ``n`` renders the
  band of rows ``[b * H / n, (b + 1) * H / n)``, with the band's own RNG
  root ``tile_base_key(frame, y0, 0)``; the bands are stacked (across
  processes: ``all_gather``);
- ``render_frame_sharded(mode="spp")``: shard ``d`` renders the whole frame
  with ``samples / n`` samples and the RNG root ``tile_base_key(frame, 0,
  d * 131071)``; the images are summed in shard order and divided by ``n``
  (across processes: ``all_reduce(SUM)``, then the division);
- ``render_frames_batched``: shard ``d`` renders the contiguous slice
  ``frames[d * B / n:(d + 1) * B / n]``; the slices are stacked.

Where the reference's spp mode passes the shard tag as the tile's ``x0``,
which also shifts the camera's pixel columns by ``d * 131071`` (its
comment says "x0 only feeds the RNG here"; ``camera_rays`` adds it to the
columns), so that every shard past the first traces columns far outside
the view, the port keeps the tag in the key alone (``render_tile``'s
``key_x0``) and renders the frame's own pixels: with one device the two
agree; with more, the reference's spp frame averages off-view images in.

The wavefront and the ray pool are host-driven per device and do not run
here; deep meshes take the masked deep loop per shard, as in the
reference. ``shard_plan``, ``render_shard`` and ``compose`` expose the
decomposition, so that an n-shard frame can be rendered and checked on one
card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from tpu_render_cluster_torch.parallel.mesh import MeshLayout, mesh_layout
from tpu_render_cluster_torch.render.camera import Camera, scene_camera_on
from tpu_render_cluster_torch.render.integrator import render_tile, resolve_bvh_config
from tpu_render_cluster_torch.render.mesh import MeshFrame, mesh_frame_on, mesh_frame_on_host
from tpu_render_cluster_torch.render.scene import Scene, on_device, scene_on

MODES = ("tile", "spp")
# The reference's shard tag of the spp mode: shard d's RNG root takes
# x0 = d * 131071.
SPP_KEY_STRIDE = 131071


class Shard(NamedTuple):
    """One shard of a frame: its rows ``[y0, y0 + rows)``, its samples and
    the ``x0`` of its RNG root."""

    index: int
    y0: int
    rows: int
    samples: int
    key_x0: int


def shard_plan(mode: str, n: int, *, height: int, samples: int) -> list[Shard]:
    """The ``n`` shards of a frame in ``mode``; raises ``ValueError`` where
    the rows (``tile``) or samples (``spp``) do not divide by ``n``, as the
    reference does."""
    if mode == "tile":
        if height % n != 0:
            raise ValueError(f"height {height} not divisible by {n} devices.")
        rows = height // n
        return [Shard(band, band * rows, rows, samples, 0) for band in range(n)]
    if mode == "spp":
        if samples % n != 0:
            raise ValueError(f"samples {samples} not divisible by {n} devices.")
        return [
            Shard(index, 0, height, samples // n, index * SPP_KEY_STRIDE) for index in range(n)
        ]
    raise ValueError(f"Unknown sharding mode: {mode!r}")


class FrameInputs(NamedTuple):
    """A frame's inputs on the host, shared by its shards: the scene and
    the camera (``build_scene``'s and ``scene_camera``'s arithmetic), and
    a mesh scene's instances and TLAS operands (``scene_mesh_set``'s)."""

    scene: Scene
    camera: Camera
    mesh: MeshFrame | None


def frame_inputs(scene_name: str, frame_index: int, builder: str, wide: int) -> FrameInputs:
    """The inputs of one frame, computed once on the host."""
    return FrameInputs(
        scene_on(scene_name, frame_index, "cpu"),
        scene_camera_on(scene_name, frame_index, "cpu"),
        mesh_frame_on_host(scene_name, frame_index, builder, wide),
    )


def render_shard(
    scene_name: str,
    frame_index: int,
    shard: Shard,
    *,
    width: int,
    height: int,
    max_bounces: int,
    device: torch.device,
    bounce_scan: bool = False,
    per_instance: bool = False,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
    inputs: FrameInputs | None = None,
) -> torch.Tensor:
    """One shard on ``device``: the frame's ``inputs`` (computed here when
    not given) copied there, then ``render_tile`` over its rows and
    samples; [rows, W, 3] linear."""
    use_tlas, quant, builder, wide = resolve_bvh_config(use_tlas, quant, builder, wide)
    if inputs is None:
        inputs = frame_inputs(scene_name, frame_index, builder, wide)
    return render_tile(
        on_device(inputs.scene, device),
        on_device(inputs.camera, device),
        frame_index, shard.y0, 0,
        width=width, height=height, tile_height=shard.rows, tile_width=width,
        samples=shard.samples, max_bounces=max_bounces,
        mesh=mesh_frame_on(inputs.mesh, device),
        bounce_scan=bounce_scan, per_instance=per_instance, use_tlas=use_tlas, quant=quant,
        key_x0=shard.key_x0,
    )


def compose(mode: str, images: list[torch.Tensor]) -> torch.Tensor:
    """A frame from all its shards' images, in shard order, on the first
    one's device: the bands stacked (``tile``), or the subsets summed in
    shard order and divided by their number (``spp``)."""
    first = images[0].device
    images = [image.to(first) for image in images]
    if mode == "tile":
        return torch.cat(images, dim=0)
    return _sum(images) / len(images)


def _sum(images: list[torch.Tensor]) -> torch.Tensor:
    total = images[0]
    for image in images[1:]:
        total = total + image
    return total


def _on_devices(
    fn: Callable[[int, torch.device], torch.Tensor], devices: list[torch.device]
) -> list[torch.Tensor]:
    """``fn(i, devices[i])`` for each local device of the mesh, issued in
    turn from this thread with that device current. A shard waits on the
    host only at its start (its jitter key's copy to its card, which waits
    for that card's stream alone), so a card can run its shard while the
    host issues the next; but the host's eager work per shard is longer
    than a card's, so the frame takes the sum of the shards' host times
    (PERF.md, section 6). A thread a card contends for the interpreter and
    the CPU's operator threads: on an H100 host it measured 8-12x slower
    than the same shards issued in turn to one card."""
    images = []
    for index, device in enumerate(devices):
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            images.append(fn(index, device))
    return images


def _gather(local: torch.Tensor) -> torch.Tensor:
    """Every process's equal ``local`` block, stacked in rank order."""
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts, dim=0)


def _combine(mode: str, images: list[torch.Tensor], layout: MeshLayout) -> torch.Tensor:
    """The whole frame from this process's shards (and, in a process
    group, every other process's), on this process's first device."""
    if not dist.is_initialized():
        return compose(mode, images)
    first = layout.devices[0]
    images = [image.to(first) for image in images]
    if mode == "tile":
        return _gather(torch.cat(images, dim=0))
    total = _sum(images).contiguous()
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total / layout.n


def render_frame_sharded(
    scene_name: str,
    frame_index: int,
    *,
    width: int = 512,
    height: int = 512,
    samples: int = 8,
    max_bounces: int = 4,
    mode: str = "tile",
    n_devices: int | None = None,
    device: str | torch.device | None = None,
    bounce_scan: bool = False,
    per_instance: bool = False,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
) -> torch.Tensor:
    """Render one frame across the mesh (``mesh.device_mesh``); [H, W, 3]
    linear on this process's first device, the whole frame in every process
    of a group. ``bounce_scan``, ``per_instance`` and the BVH tiers as
    ``integrator.render_frame``'s, the tiers resolved once, here."""
    layout = mesh_layout(n_devices, device=device)
    shards = shard_plan(mode, layout.n, height=height, samples=samples)
    use_tlas, quant, builder, wide = resolve_bvh_config(use_tlas, quant, builder, wide)
    options = dict(
        width=width, height=height, max_bounces=max_bounces, bounce_scan=bounce_scan,
        per_instance=per_instance, use_tlas=use_tlas, quant=quant, builder=builder, wide=wide,
        inputs=frame_inputs(scene_name, frame_index, builder, wide),
    )
    images = _on_devices(
        lambda index, on: render_shard(
            scene_name, frame_index, shards[layout.first_shard + index], device=on, **options
        ),
        layout.devices,
    )
    return _combine(mode, images, layout)


def render_frames_batched(
    scene_name: str,
    frame_indices,
    *,
    width: int = 256,
    height: int = 256,
    samples: int = 4,
    max_bounces: int = 4,
    n_devices: int | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Render a batch of frames, a contiguous slice of the batch per device;
    [B, H, W, 3] linear on this process's first device, the whole batch in
    every process of a group. The batch must divide by the mesh's size."""
    layout = mesh_layout(n_devices, device=device)
    frames = [int(frame) for frame in frame_indices]
    if len(frames) % layout.n != 0:
        raise ValueError(f"Batch {len(frames)} not divisible by {layout.n} devices.")
    per_shard = len(frames) // layout.n
    whole = Shard(0, 0, height, samples, 0)
    tiers = dict(zip(("use_tlas", "quant", "builder", "wide"), resolve_bvh_config()))
    slices: list[list[torch.Tensor]] = [[] for _ in layout.devices]
    # Step by step across the cards (a frame of each card's slice a step):
    # a frame's start waits for its card's previous frame, by when the
    # host has issued the other cards' frames.
    for step in range(per_shard):
        images = _on_devices(
            lambda index, on: render_shard(
                scene_name, frames[(layout.first_shard + index) * per_shard + step], whole,
                width=width, height=height, max_bounces=max_bounces, device=on, **tiers,
            ),
            layout.devices,
        )
        for rendered, image in zip(slices, images):
            rendered.append(image)
    return _combine("tile", [torch.stack(rendered) for rendered in slices], layout)
