"""The device-resident ray pool: multi-frame batches without per-bounce syncs.

Port of ``tpu_render_cluster/render/raypool.py``. The wavefront tier
(``compaction.py``) reads the live count back once per bounce and its
launches only shrink. The pool keeps one fixed-width set of lanes on the
device and refills lanes freed by dead paths with the next unserved primary
rays of the batch, across frames, so a window of frames runs as one loop
whose iterations each do, on the device:

1. permutation: dead lanes to the tail. Mesh scenes fold the coherence
   re-sort into the same permutation: under the mesh kernel's TLAS variant
   (the default) one stable argsort of the key column the previous
   iteration's launch wrote (dead flag, frame id, first-entered slot,
   Morton cell and direction octant; all lanes dead-keyed at the start),
   under the flat variant ``_pool_sort_order`` (the same kind of key,
   computed here with its ``[P, K]`` broadphase); sphere scenes take the
   stable partition of ``compaction.compaction_order``;
2. refill: the freed tail gathers the next unserved primaries of the
   window, pre-generated per frame by ``integrator.frame_rays_and_seed``,
   the rays and seeds of the masked per-frame renderer;
3. bounce: ONE launch of ``kernels.pool_mesh_bounce`` (or
   ``pool_sphere_bounce``) over the pool. Lanes carry (frame, original
   lane, bounce), so each draws the RNG stream it has in its own frame's
   masked loop, against its own frame's rows of the stacked scene;
4. scatter-back: each lane's contribution lands in its frame's buffer at
   ``fid * n + lane``, whatever the order of service;
5. lifecycle: bounce + 1, lanes at the bounce cap die (and, under TLAS,
   get the dead flag stamped onto their key).

The host reads nothing inside an iteration: the counts stay device tensors,
the shapes are fixed, and there is no ``.item()``, boolean-mask indexing or
``nonzero``. It checks the loop condition (``it < iter_cap`` and (unserved
primaries remain or any lane lives), as the reference's ``while_loop``)
once per chunk of at most ``CHECK_EVERY`` iterations. A chunk is never
longer than the iterations that must still run (each serves at most the
pool's width of primaries, and a live lane needs one more), so no launch
is wasted; and every update is masked with the device's ``active`` flag,
so an iteration after the condition turned false would leave the whole
state, ``it`` included, bit for bit as it was. The chunking changes no
image and no statistic.

Telemetry (``PoolStats``): iterations, primaries served and refilled, the
live lanes summed over iterations and the refill log depend only on the
paths' lifetimes and equal the reference's. Launched lanes count the live
prefix rounded up, under TLAS, to the TLAS kernel's packet (the resolved
``TRC_TLAS_BLOCK`` tier, the reference's rounding), otherwise to the port
kernels' thread block (256 lanes), their granularity of skipping a dead
tail, where the reference rounds to its 1,024-lane ray block. The occupancy log follows
that count. The reference's registry and trace emission
(``_emit_batch_obs``) come with the port of its ``obs`` package. ``on_iteration`` sees each launch's input
state without reading it back.

A window may render one region of its frames (``region``: one tile of
each frame, the same tile in every frame): it serves the region's rays
(``integrator.region_rays_and_seed``), scatters by the local lane, and
keys each lane's RNG with its whole-frame lane (``region_lane_map``), so
the region's images equal the whole-frame pool's pixels there.

The BVH and TLAS tiers resolve once per window
(``integrator.resolve_bvh_config``, ``resolve_tlas_config``: None takes the
environment's); so do the window's frame cap (``raypool_frame_cap``:
``TRC_RAYPOOL_FRAMES``) and the pool's width (``raypool_width``:
``TRC_RAYPOOL_WIDTH``), as the reference's. At ``quant`` 1 or 2 the mesh kernel reads
quantized node tables (the window's TLAS windows against one grid) and the
loop carries the throughput column as bf16 words
(``kernels.pack_throughput_bf16``, a refilled lane packed ones); the
kernels compute in float32, unpacked at the launch and packed after it.

Differences of form from the reference: a window stacks only its real
frames (the reference pads the window to its cap with the last frame,
which changes no lane and no min or max of the instance boxes; the node
format's degrade rule still counts the padded window,
``kernels.pool_quant``); the reference's quantized tiers also fold the
alive, frame and bounce columns into one meta word a lane, which holds
them losslessly (a frame id below 32, a bounce below 256), so the port
keeps the columns.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from tpu_render_cluster_torch import resolve_device
from tpu_render_cluster_torch.render import kernels
from tpu_render_cluster_torch.render.camera import scene_camera
from tpu_render_cluster_torch.render.compaction import compaction_order, wavefront_active
from tpu_render_cluster_torch.render.integrator import (
    frame_rays_and_seed,
    region_rays_and_seed,
    resolve_bvh_config,
    resolve_tlas_config,
)
from tpu_render_cluster_torch.render.mesh import scene_mesh_set
from tpu_render_cluster_torch.render.rng import MASK32
from tpu_render_cluster_torch.render.scene import build_scene, mesh_kind_for_scene
from tpu_render_cluster_torch.utils.env import env_int

# Length of the per-iteration occupancy and refill logs; later iterations
# overwrite the last slot (as the reference's fixed-size device logs).
RAYPOOL_LOG_CAP = 2048
# Ceiling of the frame window (the sort key holds 5 frame-id bits).
RAYPOOL_MAX_FRAMES = 32
RAYPOOL_FRAMES = kernels.RAYPOOL_FRAMES  # the reference's default window
# The pool width's quantum: the reference's ray block (BVH_BLOCK_R and
# SPHERE_BOUNCE_BLOCK_R), so the port's pool is the reference's width.
POOL_BLOCK = 1024
# The pool kernels' thread block: a block past the live count skips.
KERNEL_BLOCK = 256
CHECK_EVERY = 16  # iterations per host check of the loop condition
RAYPOOL_MODES = ("auto", "off", "force")


def raypool_frame_cap(frames: int | None = None) -> int:
    """Frames per pool window: ``frames``, or the ``TRC_RAYPOOL_FRAMES`` tier
    (default 8), clamped to [1, RAYPOOL_MAX_FRAMES] (the reference's
    ``raypool_frame_cap``)."""
    frames = env_int("TRC_RAYPOOL_FRAMES", RAYPOOL_FRAMES) if frames is None else int(frames)
    return max(1, min(frames, RAYPOOL_MAX_FRAMES))


def raypool_width(rays_per_frame: int, width: int | None = None) -> int:
    """Pool lanes: ``width``, or the ``TRC_RAYPOOL_WIDTH`` tier, or one
    frame's rays up to 64 blocks, rounded up to whole blocks of POOL_BLOCK
    (at least one; the reference's ``raypool_width``)."""
    if width is None:
        width = env_int("TRC_RAYPOOL_WIDTH", min(rays_per_frame, 64 * POOL_BLOCK))
    return max(POOL_BLOCK, -(-int(width) // POOL_BLOCK) * POOL_BLOCK)


def raypool_active(scene_name: str, *, mode: str | None = None, frames_ahead: int = 0) -> bool:
    """Whether the pool renders this workload: ``off`` never, ``force``
    always (single frames and sphere scenes too), ``auto`` (or None) when
    at least one more frame of the job is queued behind this one
    (``frames_ahead`` >= 1) and the scene is one the wavefront's auto rule
    picks, the deep-walk meshes (a choice made once per scene). A single
    frame keeps the per-frame tiers, where the pool cannot refill across
    frames."""
    mode = "auto" if mode is None else mode
    if mode not in RAYPOOL_MODES:
        raise ValueError(f"raypool mode {mode!r} is not one of {RAYPOOL_MODES}")
    if mode != "auto":
        return mode == "force"
    return frames_ahead >= 1 and wavefront_active(scene_name, mode="auto")


def _dilate4(v: torch.Tensor) -> torch.Tensor:
    """Spread a 4-bit value to every third bit (Morton dilation)."""
    return (
        (v & 1) | (((v >> 1) & 1) << 3) | (((v >> 2) & 1) << 6) | (((v >> 3) & 1) << 9)
    )


def pool_sort_key(origins, directions, alive, fid, lo_w, hi_w) -> torch.Tensor:
    """The reference's key of the mesh pool's permutation ([P] int64 holding
    the uint32 key; torch's CPU lacks uint32 operations), LSB to MSB:
    direction octant [0:3), the 4-bit-per-axis Morton cell of
    ``origin + direction`` over the whole pool's span (dead lanes
    included) [3:15), the first-entered instance of the slot-union boxes
    ``lo_w``/``hi_w`` [K, 3] (K for none, clamped to 1023) [15:25), the
    frame id (clamped to 31) [25:30), the dead flag at bit 30."""
    candidate = kernels.instance_entry_candidates(origins, directions, lo_w, hi_w)
    candidate = torch.clamp_max(candidate, 1023)
    point = origins + directions
    lo = point.min(dim=0).values
    span = torch.clamp_min(point.max(dim=0).values - lo, 1e-6)
    cell = ((point - lo) / span * 15.999).to(torch.int64)  # 4 bits per axis
    morton = _dilate4(cell[:, 0]) | (_dilate4(cell[:, 1]) << 1) | (_dilate4(cell[:, 2]) << 2)
    octant = (
        (directions[:, 0] > 0).to(torch.int64)
        | ((directions[:, 1] > 0).to(torch.int64) << 1)
        | ((directions[:, 2] > 0).to(torch.int64) << 2)
    )
    fid_bits = torch.clamp_max(fid.to(torch.int64) & MASK32, 31)
    dead = (~alive).to(torch.int64) << 30
    return octant | (morton << 3) | (candidate << 15) | (fid_bits << 25) | dead


def _pool_sort_order(origins, directions, alive, fid, lo_w, hi_w) -> torch.Tensor:
    """One permutation for the mesh pool, compaction and coherence at once:
    dead lanes last (the kernels' live-count contract), live lanes grouped
    by frame, then packed by candidate instance and Morton cell. A stable
    argsort, as ``jnp.argsort``: the reference's permutation."""
    key = pool_sort_key(origins, directions, alive, fid, lo_w, hi_w)
    return torch.argsort(key, stable=True)


class PoolStats(NamedTuple):
    """One window's telemetry, read once at its end."""

    iterations: int
    served: int  # primaries served (= frames x rays per frame)
    refilled: int  # primaries loaded into freed lanes (= served)
    live_sum: int  # live lanes at launch, summed over iterations
    launched_sum: int  # launched lanes (live prefix in KERNEL_BLOCK units), summed
    occ_log: list[float]  # per iteration: live / launched lanes
    refill_log: list[int]  # per iteration: primaries refilled
    host_reads: int  # reads of the device by the host, the final one included


class PoolLaunch(NamedTuple):
    """One pool launch as ``on_iteration`` sees it: the iteration (counted
    on the host), the device live count and the kernel's input state."""

    iteration: int
    live: torch.Tensor  # int64 [] on the device
    # (origins, directions, throughput, alive, lane: the RNG counters, fid, seed_row, bounce_row)
    state: tuple


class PoolState(NamedTuple):
    """The loop's carried state, all on the device."""

    origins: torch.Tensor  # [P, 3]
    directions: torch.Tensor  # [P, 3]
    throughput: torch.Tensor  # [P, 3]; at quant 1-2 [P, 2] bf16 words
    alive: torch.Tensor  # [P] bool
    lane: torch.Tensor  # [P] int32: the local lane, the scatter's index
    fid: torch.Tensor  # [P] int32
    bounce: torch.Tensor  # [P] int32
    counters: torch.Tensor  # int64 [5]: served, it, refilled, live_sum, launched_sum
    occ_log: torch.Tensor  # [RAYPOOL_LOG_CAP] float32
    refill_log: torch.Tensor  # [RAYPOOL_LOG_CAP] int64
    radiance: torch.Tensor  # [F n, 3]
    key: torch.Tensor | None = None  # [P] int32: the TLAS kernel's key column


class PoolWindow:
    """One window of frames of one scene through the pool: its stacked
    scene, pre-generated primaries and trace seeds, and the loop.
    ``run`` renders the window; ``iteration`` is one step of the loop,
    ``more`` its condition, both without a host read. ``region`` (y0, x0,
    tile_height, tile_width): the window renders that region of each of
    its frames. The BVH tiers (``use_tlas``, ``quant``, ``builder``,
    ``wide``), the TLAS tiers (``tlas_leaf``, ``tlas_block``: the reference's
    ``_raypool_batch`` takes them resolved) and the pool's width
    (``pool_width``) resolve here, None taking the environment's; the node
    format's degrade rule counts the window padded to the environment's
    frame cap (``raypool_frame_cap()``), as the reference's compiled window."""

    def __init__(
        self,
        scene_name: str,
        frames: Sequence[int],
        *,
        width: int,
        height: int,
        samples: int,
        max_bounces: int,
        pool_width: int | None = None,
        device: torch.device,
        use_tlas: bool | None = None,
        region: tuple[int, int, int, int] | None = None,
        quant: int | None = None,
        builder: str | None = None,
        wide: int | None = None,
        tlas_leaf: int | None = None,
        tlas_block: int | None = None,
    ) -> None:
        frames = [int(f) for f in frames]
        use_tlas, self.quant, builder, wide = resolve_bvh_config(use_tlas, quant, builder, wide)
        tlas_leaf, self.tlas_block = resolve_tlas_config(tlas_leaf, tlas_block)
        if not 1 <= len(frames) <= RAYPOOL_MAX_FRAMES:
            raise ValueError(f"a pool window holds 1 to {RAYPOOL_MAX_FRAMES} frames, not {len(frames)}")
        self.frames, self.device = frames, device
        self.width, self.height, self.samples = width, height, samples
        self.max_bounces = max_bounces
        y0, x0, self.tile_height, self.tile_width = (
            (0, 0, height, width) if region is None else (int(v) for v in region)
        )
        self.n = samples * self.tile_height * self.tile_width  # rays per frame
        self.total = len(frames) * self.n
        self.pool = raypool_width(self.n, pool_width)
        # The reference's backstop against a loop that does not end: every
        # iteration serves rays or ages the live lanes toward the cap.
        self.iter_cap = (self.total // self.pool + 2) * (max_bounces + 1) + 4
        scenes = [build_scene(scene_name, f, device) for f in frames]
        # A region's local lane -> its whole-frame lane, the RNG counter.
        self.glane_map = None
        if region is None:
            rays = [
                frame_rays_and_seed(
                    scene_camera(scene_name, f, device), f, width=width, height=height,
                    samples=samples,
                )
                for f in frames
            ]
        else:
            rays = [
                region_rays_and_seed(
                    scene_camera(scene_name, f, device), f, width=width, height=height,
                    samples=samples, y0=y0, x0=x0, tile_height=self.tile_height,
                    tile_width=self.tile_width,
                )
                for f in frames
            ]
            self.glane_map = rays[0][2]
            rays = [(o, d, seed) for o, d, _, seed in rays]
        self.primary_origins = torch.cat([r[0] for r in rays])
        self.primary_directions = torch.cat([r[1] for r in rays])
        self.seeds = torch.tensor([r[2] for r in rays], dtype=torch.int32, device=device)
        self.tlas = False
        if mesh_kind_for_scene(scene_name) is None:
            self.mesh_ops = None
            self.ops = kernels.pool_sphere_operands(scenes)
        else:
            meshes = [scene_mesh_set(scene_name, f, builder, wide, device, tlas_leaf)
                      for f in frames]
            self.mesh_ops = self.ops = kernels.pool_mesh_operands(
                scenes, meshes, raypool_frame_cap())
            self.tlas = kernels.use_tlas_for(self.mesh_ops.per_frame, use_tlas, tlas_leaf)
            if not self.tlas:
                # The flat sort key's broadphase over SLOT-UNION boxes:
                # instance k's world box unioned over the window's frames,
                # [K, 3] not [F K, 3]. The frame id sits above the candidate
                # in the key, so within a frame's group the union box only
                # dilates the frame's own.
                lo, hi = kernels.pool_instance_aabbs(self.mesh_ops)
                k = self.mesh_ops.per_frame
                self.slot_lo = lo.reshape(len(frames), k, 3).amin(dim=0)
                self.slot_hi = hi.reshape(len(frames), k, 3).amax(dim=0)
        # The lane quantum of the launched-lane count.
        self.block = self.tlas_block if self.tlas else KERNEL_BLOCK
        # A refilled lane's throughput, in the carried form.
        ones = torch.ones((1, 3), dtype=torch.float32, device=device)
        self.fresh_throughput = kernels.pack_throughput_bf16(ones) if self.quant else ones

    def initial_state(self) -> PoolState:
        """Every lane dead with a ray that misses everything (far origin,
        unit direction) and fid/lane 0, so its zero contribution scatters
        harmlessly."""
        pool, device = self.pool, self.device
        zeros = torch.zeros((pool,), dtype=torch.int32, device=device)
        return PoolState(
            origins=torch.full((pool, 3), 1e7, dtype=torch.float32, device=device),
            directions=torch.tensor([0.0, 1.0, 0.0], device=device).expand(pool, 3).clone(),
            throughput=self.fresh_throughput.expand(pool, -1).clone(),
            alive=torch.zeros((pool,), dtype=torch.bool, device=device),
            lane=zeros, fid=zeros.clone(), bounce=zeros.clone(),
            counters=torch.zeros((5,), dtype=torch.int64, device=device),
            occ_log=torch.zeros((RAYPOOL_LOG_CAP,), dtype=torch.float32, device=device),
            refill_log=torch.zeros((RAYPOOL_LOG_CAP,), dtype=torch.int64, device=device),
            radiance=torch.zeros((self.total, 3), dtype=torch.float32, device=device),
            # Every lane starts dead: one dead-flag key for all, so the first
            # sort keeps the order and the refill fills the pool's head.
            key=torch.full((pool,), 1 << kernels.KEY_DEAD_BIT, dtype=torch.int32, device=device)
            if self.tlas else None,
        )

    def more(self, state: PoolState) -> torch.Tensor:
        """The loop condition as a device bool."""
        served, it = state.counters[0], state.counters[1]
        return (it < self.iter_cap) & ((served < self.total) | state.alive.any())

    def iteration(
        self,
        state: PoolState,
        index: int = 0,
        on_iteration: Callable[[PoolLaunch], None] | None = None,
    ) -> PoolState:
        """One iteration (steps 1-5 of the module docstring), every update
        masked by the loop condition, without a host read."""
        active = self.more(state)
        served, it = state.counters[0], state.counters[1]
        # 1. One permutation, dead lanes to the tail, and ONE packed gather.
        if self.mesh_ops is None:
            perm, _ = compaction_order(state.alive)
        elif self.tlas:
            perm = torch.argsort(state.key, stable=True)
        else:
            perm = _pool_sort_order(
                state.origins, state.directions, state.alive, state.fid, self.slot_lo,
                self.slot_hi,
            )
        packed = torch.cat([state.origins, state.directions, state.throughput], dim=1)[perm]
        o, d, thr = packed[:, 0:3], packed[:, 3:6], packed[:, 6:]
        alive, lane = state.alive[perm], state.lane[perm]
        fid, bounce = state.fid[perm], state.bounce[perm]
        live = alive.sum(dtype=torch.int64)

        # 2. Refill the freed tail with the next unserved primaries.
        take = torch.minimum(self.pool - live, self.total - served)
        slot = torch.arange(self.pool, device=self.device)
        src = torch.clamp(served + slot - live, 0, self.total - 1)
        is_new = (slot >= live) & (slot < live + take)
        o = torch.where(is_new[:, None], self.primary_origins[src], o)
        d = torch.where(is_new[:, None], self.primary_directions[src], d)
        thr = torch.where(is_new[:, None], self.fresh_throughput, thr)
        alive = alive | is_new
        new_fid = src // self.n
        fid = torch.where(is_new, new_fid.to(torch.int32), fid)
        lane = torch.where(is_new, (src - new_fid * self.n).to(torch.int32), lane)
        bounce = torch.where(is_new, 0, bounce)
        # An iteration past the end launches over no lane.
        live2 = torch.where(active, live + take, 0)

        # 3. One pool bounce over the live prefix; a region's lanes draw
        # their whole-frame lanes' random numbers.
        seed_row = self.seeds[fid.clamp(0, len(self.frames) - 1)]
        counter = lane
        if self.glane_map is not None:
            counter = self.glane_map[lane.clamp(0, self.n - 1)]
        inputs = (
            o, d, kernels.unpack_throughput_bf16(thr) if self.quant else thr, alive, counter,
            fid, seed_row, bounce,
        )
        if on_iteration is not None:
            on_iteration(PoolLaunch(index, live2, inputs))
        if self.mesh_ops is None:
            step = kernels.pool_sphere_bounce(
                self.ops, *inputs, live2, total_bounces=self.max_bounces
            )
        else:
            step = kernels.pool_mesh_bounce(
                self.ops, *inputs, live2, total_bounces=self.max_bounces, use_tlas=self.tlas,
                quant=self.quant, tlas_block=self.tlas_block,
            )

        # 4. Scatter-back into each lane's frame buffer. The ids are unique
        # (each is served into one lane and kept there until the lane is
        # refilled with a fresh one; only the never-filled lanes share id
        # 0, and add zeros), so the sum does not depend on the order.
        radiance = state.radiance.index_add_(
            0, fid.to(torch.int64) * self.n + lane.to(torch.int64),
            torch.where(active, step.contribution, 0.0),
        )

        # 5. Lifecycle and telemetry, masked by `active`.
        bounce = bounce + 1
        alive = step.alive & (bounce < self.max_bounces)
        key = None
        if self.tlas:
            # The kernel keyed its own post-bounce alive; a lane the bounce
            # cap kills here gets the dead flag, so the next sort parks it.
            key = torch.where(alive, step.key, step.key | (1 << kernels.KEY_DEAD_BIT))
        launched = (live2 + self.block - 1) // self.block * self.block
        occupancy = live2.to(torch.float32) / torch.clamp_min(launched, 1).to(torch.float32)
        at = torch.clamp_max(it, RAYPOOL_LOG_CAP - 1).reshape(1)
        occ_log = state.occ_log.index_copy(
            0, at, torch.where(active, occupancy, state.occ_log[at]).reshape(1)
        )
        refill_log = state.refill_log.index_copy(
            0, at, torch.where(active, take, state.refill_log[at]).reshape(1)
        )
        step_counts = torch.stack([take, torch.ones_like(it), take, live2, launched])
        counters = state.counters + active * step_counts
        keep = lambda new, old: torch.where(  # noqa: E731
            active.reshape([1] * new.ndim), new, old
        )
        throughput = step.throughput
        if self.quant:
            throughput = kernels.pack_throughput_bf16(throughput)
        return PoolState(
            origins=keep(step.origins, state.origins),
            directions=keep(step.directions, state.directions),
            throughput=keep(throughput, state.throughput),
            alive=keep(alive, state.alive),
            lane=keep(lane, state.lane),
            fid=keep(fid, state.fid),
            bounce=keep(bounce, state.bounce),
            counters=counters, occ_log=occ_log, refill_log=refill_log, radiance=radiance,
            key=None if key is None else keep(key, state.key),
        )

    def run(
        self, *, on_iteration: Callable[[PoolLaunch], None] | None = None
    ) -> tuple[list[torch.Tensor], PoolStats]:
        """Render the window: (linear images [H, W, 3] (a region's [th, tw,
        3]) on the device, one per frame in order, and its PoolStats)."""
        state = self.initial_state()
        index, reads = 0, 0
        while True:
            # The iterations that must still run: each serves at most the
            # pool's width of primaries; a live lane needs at least one.
            # The first chunk needs no read.
            if index == 0:
                ahead = -(-self.total // self.pool)
            else:
                served, it, alive_any = torch.stack(
                    [state.counters[0], state.counters[1], state.alive.any().to(torch.int64)]
                ).tolist()
                reads += 1
                if it >= self.iter_cap or (served >= self.total and not alive_any):
                    break
                ahead = max(1, -(-(self.total - served) // self.pool))
            for _ in range(min(CHECK_EVERY, ahead, self.iter_cap - index)):
                state = self.iteration(state, index, on_iteration)
                index += 1
        counters = state.counters.tolist()
        logged = min(counters[1], RAYPOOL_LOG_CAP)
        stats = PoolStats(
            iterations=counters[1], served=counters[0], refilled=counters[2],
            live_sum=counters[3], launched_sum=counters[4],
            occ_log=state.occ_log[:logged].tolist(),
            refill_log=state.refill_log[:logged].tolist(),
            host_reads=reads + 3,
        )
        return self.images(state), stats

    def images(self, state: PoolState) -> list[torch.Tensor]:
        """The window's linear images [th, tw, 3] (the whole frame's size
        without a region), one per frame in order, from the radiance the
        loop has scattered so far."""
        return [
            state.radiance[f * self.n:(f + 1) * self.n]
            .reshape(self.samples, self.tile_height * self.tile_width, 3)
            .mean(dim=0)
            .reshape(self.tile_height, self.tile_width, 3)
            for f in range(len(self.frames))
        ]


def render_batch_raypool(
    scene_name: str,
    frame_indices: Sequence[int],
    *,
    width: int = 512,
    height: int = 512,
    samples: int = 8,
    max_bounces: int = 4,
    pool_width: int | None = None,
    frame_cap: int | None = None,
    device: str | torch.device | None = None,
    on_iteration: Callable[[PoolLaunch], None] | None = None,
    use_tlas: bool | None = None,
    region: tuple[int, int, int, int] | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
) -> tuple[list[torch.Tensor], list[PoolStats]]:
    """Render a batch of frames through the pool, in windows of at most
    ``frame_cap`` frames (None: ``raypool_frame_cap()``, the environment's):
    (linear [H, W, 3] images on ``device`` (CUDA unless ``cpu`` is asked
    for), one per frame in order, and one PoolStats per window). Each
    window's rays and trace seeds are the masked per-frame renderer's. The
    BVH tiers ``use_tlas``, ``quant``, ``builder`` and ``wide`` (None: the
    environment's) and the environment's TLAS tiers resolve once for the
    batch (``integrator.resolve_bvh_config``, ``resolve_tlas_config``), the
    pool's width ``pool_width`` once a window (``raypool_width``). ``region`` (y0, x0, tile_height, tile_width):
    every frame is rendered on that region only, [th, tw, 3] each, equal to
    the whole-frame pool's pixels there (a tiled job's same-tile units)."""
    device = resolve_device(device)
    use_tlas, quant, builder, wide = resolve_bvh_config(use_tlas, quant, builder, wide)
    tlas_leaf, tlas_block = resolve_tlas_config()
    frames = [int(f) for f in frame_indices]
    cap = raypool_frame_cap(frame_cap)
    images: list[torch.Tensor] = []
    stats: list[PoolStats] = []
    for start in range(0, len(frames), cap):
        window = PoolWindow(
            scene_name, frames[start:start + cap], width=width, height=height,
            samples=samples, max_bounces=max_bounces, pool_width=pool_width, device=device,
            use_tlas=use_tlas, region=region, quant=quant, builder=builder, wide=wide,
            tlas_leaf=tlas_leaf, tlas_block=tlas_block,
        )
        window_images, window_stats = window.run(on_iteration=on_iteration)
        images.extend(window_images)
        stats.append(window_stats)
    return images, stats


def render_frame_raypool(scene_name: str, frame_index: int, **kwargs):
    """One frame through the pool: (linear [H, W, 3] image, PoolStats)."""
    images, stats = render_batch_raypool(scene_name, [frame_index], **kwargs)
    return images[0], stats[0]
