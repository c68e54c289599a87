"""Drive the PyTorch port on one CUDA GPU and check every kernel of its paths.

Usage (from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit):

    python3 chip_smoke.py

Twelve main paths, each through ``TorchRaytraceBackend``, nine of them one per
kernel: whole frames of the sphere scene 04_very-simple through ``trace_fused``,
of the mesh scene 02_physics-mesh through ``trace_fused_mesh_tlas``, of the
deep mesh scene 03_physics-2-mesh through the wavefront driver (the
backend's default tier for a frame with none queued behind it) and
``mesh_bounce_tlas``, two frames of 04_very-simple under ``wavefront="force"``
through ``sphere_bounce``, the same deep job through the ray pool (the
backend's default tier when the worker queue's hint names more frames of the
job) and ``pool_mesh_bounce_tlas``, two frames of 04_very-simple under
``raypool="force"`` through ``pool_sphere_bounce``, and the flat variants of
the three mesh kernels, the reference's ``TRC_TLAS=0`` tier, under
``use_tlas=False`` (2 frames of 02 through ``trace_fused_mesh``, 2 of the deep
wavefront through ``mesh_bounce``, one 2-frame pool window through
``pool_mesh_bounce``); the mesh paths at the backend's default
(``use_tlas=None``) run the TLAS variants, the reference's default; and two
through the per-bounce scan renderer (``bounce_scan=True``), one bounce of
eager tensor code per sample around the unit kernels: 10 frames of the deep job through
``intersect_spheres``, ``occluded_spheres``, ``intersect_instances`` and
``occluded_instances``, and 2 frames of 04_very-simple through the first
two; and one through the scan's per-instance branch (``bounce_scan=True,
per_instance=True``): 2 frames of the deep job through the sphere unit
kernels and ``intersect_mesh`` and ``occluded_mesh``, each launched once per
instance (48 times per sample and bounce). Then four tile paths, tiled work
units ``(frame, tile)`` of a job given a 2x2 ``tiles`` grid, through the
same backend: 2 frames of 04_very-simple, each tile one launch of
``trace_fused_lanes`` (row 1's lane mode, whole-frame lanes as RNG
counters), 2 frames of the deep job through the wavefront's region path, 4
frames of the deep job with the queue's hint before each unit (one pool
window of the 4 frames per tile), and 2 frames of 02_physics-mesh through
the masked region loop (``mesh_bounce_tlas``, never the mesh megakernel).
Every scene's BVH carries octant tables, so the mesh kernels of rows 3, 4
and 6 walk the octant-ordered tables of their packets' votes (the
reference's default), and each per-bounce or pool mesh launch brings its
passes (``kernels.ORDERED_PASSES``): the packet vote ``packet_octants`` and,
for ``mesh_bounce_tlas``, the key pass ``mesh_entry_keys``; a path's counts
include them.
Phases, each of which raises (exit code 1) if its check fails:
1. the card: name and power limit as nvidia-smi reports them;
2. build every CUDA source of the port with nvcc (sm_90a), one nvcc per
   source, all at once, timed, and print each kernel's registers and spills
   (the TLAS kernels' other packet widths then build in a thread beside
   phases 3-8, for phase 11, waited for at phase 9);
3. the inputs of every frame of the main paths (scene, camera, mesh
   instances, the primary rays of the three ray builders) on the card
   against the CPU's, bit for bit: the number of differing elements must be
   0. Each kernel against its plain PyTorch version on the card at 128x128,
   4 spp: the megakernels at 1 and 4 bounces, row 1 (``trace_fused``) bit
   for bit, the mesh ones at the tolerances of
   tests/test_torch_kernels_mesh.py (the mesh kernel also on the deep
   icosphere tree of 03_physics-2-mesh, called directly); the per-bounce
   kernels on every launch of a wavefront
   frame (bounce 0 with every lane alive and the lanes re-sorted, later
   bounces with a sorted dead tail), all five outputs, at the tolerance of
   tests/test_torch_mesh_bounce.py, and a TLAS kernel's key column bit for
   bit on every lane and, on the lanes alive below the live count, equal to
   ``kernels.mesh_sort_keys`` of the launch's own outputs (with
   ``instance_entry_candidates`` over the slot-ordered world boxes; the TLAS
   megakernel too at 1 and 4 bounces); the pool kernels on the windows of
   their main paths at 512x512, 8 spp (the deep job's frames 1-8 and 9-10,
   the sphere job's frames 1-2), in each window on the first launch, at
   every boundary between two frames the first launch with live lanes of
   both (at mixed bounces where there is one), and the last launch (the
   drain), all 65,536 lanes, at the same tolerance, and one chunk of the
   pool's loop body under ``torch.cuda.set_sync_debug_mode("error")``; the
   unit kernels on every launch of frame 1 of each scan path at 128x128, 4
   spp (their wrappers recorded in place on ``kernels``), each on the
   launch's own inputs, at the tolerances of tests/test_torch_geometry.py
   and tests/test_torch_bvh.py (the single-BVH kernels: every launch of the
   first sample, 4 bounces x 48 instances), the instanced ones (rows 7 and
   8) bit for bit on every output of every lane; the lane kernel on the
   rays and lanes of tile 3 of a 2x2
   grid at 128x128, 4 spp, 1 and 4 bounces, bit for bit against its plain
   version, and on lanes 0..R-1 bit for bit against ``trace_fused``; the
   group-walk kernels (``mesh_bounce_tlas``, ``pool_mesh_bounce_tlas``)
   bit for bit on every lane of every launch checked, here and in phase 4,
   and also on the pool's mixed launch with its lanes shuffled over all 8
   frames (every block reads the frame tables from global memory) and on
   the narrowest launch of a 512x512 8 spp deep wavefront frame (131,072
   lanes, a group of 4 threads a ray), all lanes; on the octant-ordered
   walk every launch of the six mesh kernels checked bit for bit on every
   output of every lane (a per-bounce launch's SUBSET rays drawn as whole
   packets, whose votes they keep), and its passes against their plain
   versions exactly (a pool launch's vote only on the rows of the frames
   each packet carries, also on the shuffled 8-frame launch); a TLAS
   launch's key against ``mesh_sort_keys`` but
   exact entry ties (the twin gives a tie to the lowest slot, the ordered
   entry walk to the slot its packet's table meets first; counted);
4. each main path: the first frames of a job file loaded through the
   port's job model and rendered by the backend at 512x512, 8 spp, 4
   bounces. The launch counts are zeroed just before each path and read
   just after: its kernel must have launched once per frame (a megakernel)
   or once per bounce the wavefront driver launched, and nothing else
   ran, no plain version either; a pool kernel once per pool iteration.
   Every PNG must decode with non-trivial content. Frame 1 is checked further: a megakernel's against its plain
   version's render; the deep path's against the masked deep loop ray for
   ray and against the mesh megakernel's render, and each of its
   launches against the plain per-bounce version on 65,536 of its rays;
   the sphere wavefront's against the sphere megakernel and its frames; a
   TLAS path's frame 1 against the flat kernels' on the same rays (a pool:
   a window of its first two frames), within atol 1e-5; a
   pool path's (the worker queue's hint given before each frame, as the
   queue gives it: two windows, 8 and 2 frames, of the deep job) against
   the wavefront tier's image of the same frame (atol 1e-5, the bit-equal
   share printed) and the megakernel's PNG, and every other frame of
   its first window against the wavefront tier's image too; a scan path's
   unit kernels each once per sample and bounce (the single-BVH ones once
   per instance too), and its frame against the scan tier's render with the
   plain versions on the card (the deep scan: both renders of frame 1 at
   128x128, 1 spp; the bit-equal share printed); the per-instance scan's frame 1
   against the instanced scan's of this run (never rendered with the plain
   versions: their walks take seconds per launch); a tile path's kernel
   once per tile (the lane kernel), per wavefront bounce, per pool
   iteration or per tile and bounce (02), nothing else; its tile PNGs
   stitched as the master's assembler stitches them, against the
   whole-frame path's PNGs (04 and the 03 wavefront bit for bit, the pool
   and 02 >= 99.5% within 1, the bit-equal share printed), and its region
   renders stitched against the whole-frame render of the same tier on the
   card (bit for bit; the pool's against the whole-frame pool's bit for bit
   and the wavefront's within atol 1e-5; 02's region loop against row 3,
   the bit-equal share printed);
5. timings: each path's per-frame phases and frames/s and a breakdown of
   one frame; each megakernel's time (its wrapper's calls, CUDA events, the
   median of 10 batches of 20) beside its bound, its plain version's time
   and the host time of one wrapper call; each per-bounce kernel's time at
   every launch width of a frame, with the compaction of that bounce, and
   the mesh megakernel on the same deep frame for comparison; each pool
   kernel at its three launches, beside the glue of its iteration (sort,
   refill, scatter), its bound from the plain version's work counters on
   the whole launch, and the pool path's frames/s beside the wavefront's;
   each unit kernel at the four launches of frame 1's first sample (262,144
   rays; a single-BVH kernel: the 48 of its bounce 0), its bound from its
   plain version's counters on the bounce-0 launch (instance 0's), and each
   scan path's frames/s and split of a frame beside the megakernel,
   wavefront and instanced scan paths of the same run; each tile path's
   per-tile render and save ms, a tile's rays beside a whole frame's, and
   the tiled job's frames/s beside its whole-frame path's; the lane kernel
   at a tile's 524,288 rays beside ``trace_fused`` on the same rays, its
   plain version and its bound at 40 bytes a ray; each group-walk kernel's
   group size G, resident blocks per SM, time alone against its bound and
   beside its one-thread predecessor's (PERF.md) (the sweeps over every G
   of earlier runs, kept in PERF.md, are left out to make room for phase
   9);
   The passes at the deep wavefront's bounce-0 launch: each wrapper, its
   plain version, its bound and its launches on the main paths; the frames
   a walked packet carries at the deep pool's checked launches;
6. under torch.profiler (reported, not checked: the numbers read "not
   measured" where the profiler records no device time or misses a launch
   of the kernel, three tries in a row; the unit kernels'
   alone times per bounce profile windows of 5 calls, rows 9 and 10 the 48
   bounce-0 calls in windows of 6, up to six times each):
   each kernel's own device time apart from its wrapper's set-up work, and
   the card's idle share over two frames of
   each main path, or one window of a pool path, or one 128x128 frame at 2
   spp of the per-instance scan (busy: the sum of the device's own events;
   a scan path's also split by unit kernel; a tile path: frame 1's four
   tiles, the pool tile path all its units);
7. the kernels redesigned for Hopper in the last three slices, the packet
   vote ``packet_octants`` and ``trace_fused_mesh_tlas``, row 1 in both
   modes (``trace_fused``, ``trace_fused_lanes``), then the key pass
   ``mesh_entry_keys``: each one's ptxas lines and resident blocks per SM,
   row 1 also its persistent grid at a whole frame's and a tile's rays, the
   key pass its mode (persistent or a block a packet), staged bytes and grid
   at each launch it is timed at (these on the kernels line's entries under
   ``resources``); the
   vote exactly against its plain
   version, on CUDA events and alone under the profiler at row 4 TLAS's
   four launches of a deep wavefront frame and at the deep pool's first
   window's checked launches and its 8-frame shuffled launch (rows voted,
   frames a packet, the bound from the rows voted beside the every-row
   one); the key pass exactly against its plain version and the launch's
   key column, on CUDA events and alone at row 4 TLAS's four launches of a
   deep wavefront frame and of a deep wavefront tile (the region path), and
   its alone time summed over each. Then the octant-ordered walk against the canonical order (the
   wrappers' ``kernels.walks_ordered`` answering False, as for a BVH
   without octant tables), in turns ordered, canonical, canonical,
   ordered: each of the six kernels of rows 3, 4 and 6 on CUDA events and
   alone under the profiler at the widths of PERF.md section 6 (rows 3:
   frame 1 of the 02 path, row 3 TLAS frame 2 too, for the two frames'
   mean; rows 4: the deep wavefront's bounce-0 launch; rows 6: the mixed
   launch of the pool paths' first windows), with the passes alone; and
   frames/s of the 02 path, the deep wavefront and the deep pool, 2 frames
   a turn. (``chip_ab.py`` times row 1 in both modes and the key pass
   against the builds of the sources they replaced.)
8. the wire: the unmodified C++ master (``native/master_daemon.cpp`` and
   ``native/wscodec.cpp``, built with g++ by its own build line into the
   ignored ``render/csrc/build/``) serves one port worker process
   (``python -m tpu_render_cluster_torch.worker.main --warmScene ...``, the
   card, 512x512, 8 spp) a 10-frame 04_very-simple job (``naive-fine``: row
   1) and a 4-frame 03_physics-2-mesh job (``eager-naive-coarse``, 4 queued:
   the frames added while frame 1 renders are pooled through the queue's
   hint, row 6 TLAS and the vote pass); both processes must exit 0 within
   their timeouts (else both are killed and the phase fails); the master's
   raw trace must hold one worker trace with the job's frames; the worker's
   metrics snapshot must show exactly the launches and the pool cache hits
   of the same frames rendered in this process by the backend through the
   same tiers (04: ``trace_fused`` once a frame; 03: no hint for frame 1,
   which the worker starts before the master's next add arrives, then the
   rest of the job as each later frame's hint, so frame 1 takes the
   wavefront and frames 2-4 one pool window), and no plain version; every
   PNG the worker wrote is held against that in-process render (04 bit for
   bit, 03 within phase 4's pool check: >= 99.5% of uint8 values within 1;
   the bit-equal share printed). Printed: each job's frames/s over the master's job wall time
   beside the in-process loop's, the worker's median phase times from the
   raw trace, its launches (also on the kernels line as ``wire_launches``)
   and the card. A third job, the 03 job again, goes to a worker started
   with ``TRC_BVH_QUANT=1`` in its environment: its snapshot must show the
   quantized launches (``mesh_bounce_tlas[q1]``, ``mesh_entry_keys[q1]``,
   ``pool_mesh_bounce_tlas[q1]``), and its PNGs must equal the in-process
   backend's at ``quant=1`` bit for bit. A fourth job, 4 frames of
   04_very-simple, goes to a worker started with ``--sharding tile``: its
   launch map must be ``trace_fused`` 4 and its PNGs equal the in-process
   sharded backend's bit for bit;
9. the node formats, the reference's ``TRC_BVH_QUANT`` tiers 1 and 2
   (``kernels.QUANT_KERNELS``; each count names its tier, and each path
   prints the format it resolved to and fails where it came back 0): each
   instantiation against its plain version at the same format, bit for bit
   on every output, at the main paths' widths: row 4 TLAS at the deep
   wavefront's bounce-0 launch (2,097,152 lanes, its plain version on
   65,536 of them drawn as whole packets, the hit column too) and its key
   pass on every lane (persistent blocks, fed the bounce's hit column), row
   6 TLAS on every lane of the first, mixed and last launches of phase 3's
   first deep pool window (8 frames, 65,536 lanes); and on every lane at
   64x64, 4 spp: row 3 TLAS on 02, row 4 TLAS with its vote and key passes
   on every launch of a deep wavefront frame, the flat rows at one format
   each and the canonical walk of a ``median``, ``wide=2`` build; the
   quantized TLAS words the card computes equal the CPU's; whole frames through ``TorchRaytraceBackend`` at
   512x512, 8 spp, 4 bounces with their staged bytes a block: 02 at 1 and
   2 bit-equal to 0, the deep wavefront and pool at 1 and 2 within the
   reference's budget of the packed carried state (linear MAE < 1e-3,
   uint8 within 2), a ``median``, ``wide=1`` and a ``sah``, ``wide=8``
   build's masked frames of 02 and the deep scene bit-equal to the default
   build's; and rows 3, 4 (with its key pass) and 6 TLAS alone at formats
   0, 1 and 2 in turns, beside their bounds (on the kernels line under
   ``node_formats``);
10. sharding (``tpu_render_cluster_torch/parallel/``) on the one card: (a)
   the backend with ``sharding`` tile and spp (the wavefront and the pool
   forced on, which sharding must override) at 512x512, 8 spp: 2 frames of
   04_very-simple and of 02_physics-mesh, 1 of 03_physics-2-mesh, each PNG
   bit-equal to the default path's frame rendered here (the deep scene's:
   the masked deep loop) and to phase 4's, the launches exactly one masked
   frame's each frame, no wavefront or pool launch; frames/s of each beside
   the default path's, run before and after them (the launches on the
   kernels line as ``sharded_launches``); (b) 4
   shards through ``sharded_render.render_shard`` at 128x128, 4 spp: tile
   bands and spp subsets of 04 and 02 (4 bounces), bands of 03 (2), each shard and the
   composed frame against the same rendered with the plain versions on the
   card, bit for bit (row 1; rows 3 and 4 TLAS on the octant-ordered walk);
   (c) a ``torch.distributed`` group of this one process over NCCL on a
   free localhost port: ``render_frame_sharded`` in both modes on 04 frame
   1, through the collectives, bit-equal to (a)'s PNGs;
11. the TLAS tiers, the reference's ``TRC_TLAS_BLOCK`` (the TLAS kernels'
   packet: 128, 512 and 1,024 beside the default 256, each a build of its
   own, ``_build.variant``, started after phase 2's builds in a thread of
   its own, beside phases 3-8, and waited for at phase 9) and
   ``TRC_TLAS_LEAF`` (1, 8 and 16 beside the default 4), and the pool's
   ``TRC_RAYPOOL_FRAMES`` and ``TRC_RAYPOOL_WIDTH``: rows 3, 4 and 6 TLAS,
   the vote and the key pass at each packet and leaf bit for bit against
   their plain versions on every lane at the main widths (row 4 TLAS, the
   vote and the key pass at the deep wavefront's 2,097,152-lane bounce-0
   launch; row 6 TLAS on the mixed launch of phase 3's first deep window;
   row 3 TLAS on 02 frame 1's 2,097,152 rays; each max abs error measured),
   in three processes of their own started at phase 9 beside phase 9's
   checks at QUANT_SIDE (a fourth), all joined before phase 9's times;
   each count names its width (``mesh_bounce_tlas[p128]``); each kernel's
   staged bytes and route, resident blocks per SM and ptxas's registers
   and spills at each packet and leaf; the tiers' main path with the tiers
   in the environment, as a worker takes them, its launches counted from
   0 just before each backend render and read just after, exactly (the
   width builds' entries on the kernels line): through the backend at
   512x512, 8 spp, 4 bounces at each packet and leaf, 02 frame 1
   against the masked deep loop of its rays, the deep wavefront's frame 1
   against the masked deep loop (>= 99.5% of uint8 values within 1, the
   bit-equal share printed), the deep pool over frames 1-2 against the
   wavefront (atol 1e-5), and at the default tiers a pool window of 16
   frames at ``TRC_RAYPOOL_FRAMES=16`` and one of 2 frames at twice the
   default pool width, each against the wavefront; a 4-frame 03 job over
   the wire to a worker started with ``TRC_TLAS_BLOCK=128
   TRC_TLAS_LEAF=8``, its launch map and PNGs equal to the in-process
   render's in that environment; and rows 3, 4 (with its vote and key
   pass) and 6 (with its vote) TLAS alone under the profiler and on CUDA
   events at each packet and at leaves 1 and 16, in turns.

Prints a ``{"kernels": [...]}`` line, then the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Without CUDA, or
without the port beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, SAMPLES, BOUNCES = 512, 512, 8, 4
CHECK_SIDE, CHECK_SAMPLES = 128, 4  # phase 3's frames
SUBSET = 65536  # rays of each launch held against the plain per-bounce version
# Published H100 SXM peaks (dense): float32 outside the tensor cores, and
# device memory bandwidth.
FP32_PEAK_FLOPS = 67e12
MEMORY_BYTES_PER_S = 3.35e12
# Operations per unit of work of the kernels, counted from their CUDA
# sources (an FMA counts 2): a nearest-hit sphere test (two 3-dots, the
# quadratic, sqrt, two roots, selects: 26), a shadow-ray sphere test (one
# 3-dot, the quadratic, sqrt, compares: 17), the shading of one hit (ray
# dots, plane test, hit point, normal, emission, NEE set-up and direct
# term, PCG hashes, cos/sin, tangent frame and new direction: about 200), an
# AABB slab test of an instance's world box or a BVH node (6 subtractions,
# 6 products, 10 min/max, 3 compares: 25), entering an instance (origin and
# direction into object space, 3 reciprocals: 48) and a Moller-Trumbore
# triangle test (two cross products, three 3-dots, a division, 7 compares:
# 54).
OPS_NEAREST_SPHERE = 26
OPS_SHADOW_SPHERE = 17
# A shadow test along the ray's own direction (the unit kernel
# occluded_spheres) also takes c . d: one more 3-dot.
OPS_ANY_HIT_SPHERE = 22
OPS_SHADE_HIT = 200
OPS_SLAB = 25
OPS_INSTANCE_WALK = 48
OPS_TRIANGLE = 54
# The packet vote (packet_octants.cu): a direction into one instance's
# object space (three 3-dots as 2 FMAs and a product each, three products
# by 1/s: 18) and three sign tests, per lane and instance row; a world vote
# three sign tests per lane.
OPS_VOTE_ROW = 21
OPS_VOTE_WORLD = 3
# The key pass (mesh_entry_keys.cu) reads a lane's origin, direction and
# alive byte and writes its key; the vote reads directions (12 bytes a
# lane) and writes a byte per packet and row.
KEY_PASS_RAY_BYTES = 24 + 1 + 4
VOTE_RAY_BYTES = 12
# Bytes per ray: a megakernel reads origin and direction and writes
# radiance; a per-bounce kernel reads origin, direction, throughput, alive
# (1 byte) and lane (4) and writes the contribution, origin, direction,
# throughput and alive.
MEGAKERNEL_RAY_BYTES = (3 + 3 + 3) * 4
BOUNCE_RAY_BYTES = 3 * 12 + 1 + 4 + 4 * 12 + 1
# A pool kernel also reads each lane's frame id, seed and bounce.
POOL_RAY_BYTES = BOUNCE_RAY_BYTES + 3 * 4
# The TLAS per-bounce and pool kernels also write each lane's sort key.
KEY_BYTES = 4
# The unit kernels of the bounce scan read origin and direction (24) and
# their per-ray input (the seed t: 4, already: 1) and write t and index (8),
# the any-hit (1), t, triangle row and instance (12), or t and triangle row
# (8). The any-hits over the instances or one BVH read a lane's origin and
# direction only where it walks (``already`` unset): ``unit_bound`` adds
# those 24 bytes per walking lane.
SPHERE_UNITS = ("intersect_spheres", "occluded_spheres")
INSTANCE_UNITS = ("intersect_instances", "occluded_instances")
BVH_UNITS = ("intersect_mesh", "occluded_mesh")  # once per instance: the per-instance scan
UNIT_KERNELS = SPHERE_UNITS + INSTANCE_UNITS + BVH_UNITS
UNIT_RAY_BYTES = {
    "intersect_spheres": 24 + 8,
    "occluded_spheres": 24 + 1,
    "intersect_instances": 24 + 4 + 12,
    "occluded_instances": 1 + 1,
    "intersect_mesh": 24 + 4 + 8,
    "occluded_mesh": 1 + 1,
}
DEEP_INSTANCES = 48  # 03_physics-2-mesh's icospheres: a BVH unit kernel's launches per query
# The scene whose scan path carries a unit kernel's numbers in the kernels line.
UNIT_SCENE = {name: "04_very-simple" for name in SPHERE_UNITS} | {
    name: "03_physics-2-mesh" for name in INSTANCE_UNITS + BVH_UNITS
}
# The deep scan's frame 1 is held against its plain render at this size and
# sample count: the plain instance walks take 3-5 s per call on the card at
# 65,536 or 262,144 rays alike (a Python sweep over 48 instances x 39
# nodes), so the calls, not the rays, set the plain render's time: one
# sample (its launches: one a bounce and unit kernel) keeps the script in
# its time limit beside phase 11.
PLAIN_SCAN_SIDE, PLAIN_SCAN_SAMPLES = 128, 1

SPHERE_JOB = "blender-projects/04_very-simple/04_very-simple_demo_10f-1w.toml"
DEEP_JOB = "blender-projects/03_physics-2/03_physics-2-mesh_240f-8w_tpu-batch_tpu-raytrace.toml"


class MainPath(NamedTuple):
    kernel: str  # the path's kernel; a scan path's name
    job_file: str
    scene: str
    frames: int
    wavefront: str | None  # the backend's options
    raypool: str | None = None
    bounce_scan: bool = False
    per_instance: bool = False
    use_tlas: bool | None = None

    @property
    def launched(self) -> tuple[str, ...]:
        """The kernels the path launches: a scan path's unit kernels (for a
        mesh scene also the instanced ones, or with ``per_instance`` the
        single-BVH ones), else its one kernel, with a per-bounce or pool
        mesh kernel the passes of its octant-ordered walk (every scene's
        BVH carries octant tables)."""
        if not self.bounce_scan:
            from tpu_render_cluster_torch.render.kernels import launch_names

            return launch_names(self.kernel)
        if not self.scene.endswith("-mesh"):
            return SPHERE_UNITS
        return SPHERE_UNITS + (BVH_UNITS if self.per_instance else INSTANCE_UNITS)

    def launches_per_step(self, name: str) -> int:
        """A scan path's launches of unit kernel ``name`` per sample and
        bounce: one per instance for a single-BVH kernel, else one."""
        return DEEP_INSTANCES if name in BVH_UNITS else 1


MESH_JOB = "blender-projects/02_physics/02_physics-mesh_240f-4w_tpu-batch_tpu-raytrace.toml"
# The mesh main paths run the reference's default, the TLAS variants of the
# mesh kernels; each flat variant keeps a check path of 2 frames
# (use_tlas=False), after its TLAS path and the scans.
PATHS = [
    MainPath("trace_fused", SPHERE_JOB, "04_very-simple", 10, None),
    MainPath("trace_fused_mesh_tlas", MESH_JOB, "02_physics-mesh", 10, None),
    MainPath("mesh_bounce_tlas", DEEP_JOB, "03_physics-2-mesh", 10, None),
    MainPath("sphere_bounce", SPHERE_JOB, "04_very-simple", 2, "force"),
    MainPath("pool_mesh_bounce_tlas", DEEP_JOB, "03_physics-2-mesh", 10, None),
    MainPath("pool_sphere_bounce", SPHERE_JOB, "04_very-simple", 2, None, "force"),
    MainPath("bounce_scan 03_physics-2-mesh", DEEP_JOB, "03_physics-2-mesh", 10, None, bounce_scan=True),
    MainPath("bounce_scan 04_very-simple", SPHERE_JOB, "04_very-simple", 2, None, bounce_scan=True),
    MainPath(
        "bounce_scan per_instance 03_physics-2-mesh", DEEP_JOB, "03_physics-2-mesh", 2, None,
        bounce_scan=True, per_instance=True,
    ),
    MainPath("trace_fused_mesh", MESH_JOB, "02_physics-mesh", 2, None, use_tlas=False),
    MainPath("mesh_bounce", DEEP_JOB, "03_physics-2-mesh", 2, None, use_tlas=False),
    MainPath("pool_mesh_bounce", DEEP_JOB, "03_physics-2-mesh", 2, None, use_tlas=False),
]
INSTANCED_SCAN = "bounce_scan 03_physics-2-mesh"  # the per-instance scan's comparison
MEGAKERNELS = ("trace_fused", "trace_fused_mesh", "trace_fused_mesh_tlas")
POOLS = ("pool_mesh_bounce", "pool_sphere_bounce", "pool_mesh_bounce_tlas")
TLAS_KERNELS = ("trace_fused_mesh_tlas", "mesh_bounce_tlas", "pool_mesh_bounce_tlas")
# The group-walk kernels (csrc/mesh_common.cuh, GroupTlas): held bit-equal to
# their plain versions on every lane of every launch checked, and timed at
# every group size G. Their earlier one-thread-a-lane times on NVIDIA H100
# 80GB HBM3, 700 W (PERF.md section 6; row 4 by bounce, the wrapper's ms and
# the kernel alone), printed beside this run's on the [5] lines only: the
# kernels line carries this run's measurements.
GROUP_KERNELS = ("mesh_bounce_tlas", "pool_mesh_bounce_tlas")
# The kernels of the octant-ordered walk (rows 3, 4 and 6, TLAS and flat):
# on a BVH with octant tables (every scene's) each is held bit-equal to its
# plain version on every output of every lane it is checked on, and
# phase 7 times each in both walk orders. The passes their per-bounce and
# pool launches bring (kernels.ORDERED_PASSES): the packet vote
# (csrc/packet_octants.cu) and the per-bounce TLAS kernel's key
# (csrc/mesh_entry_keys.cu), each held to its plain version exactly.
ORDERED_KERNELS = MEGAKERNELS[1:] + ("mesh_bounce", "mesh_bounce_tlas", "pool_mesh_bounce",
                                     "pool_mesh_bounce_tlas")
PASSES = ("packet_octants", "mesh_entry_keys")
# Passes' checks of phases 3 and 4: (launches checked, max abs error).
PASS_CHECKS = {name: 0 for name in PASSES}  # launches held to the plain version
# The scan's instance kernels (rows 7 and 8, GroupFlat) have their earlier
# one-thread times by bounce too, at frame 1's first 512x512 sample.
EARLIER = {
    "mesh_bounce_tlas": {0: (0.8993, 0.7536), 1: (0.8018, 0.6519), 2: (0.4109, 0.3511),
                         3: (0.2947, 0.2404)},
    "pool_mesh_bounce_tlas": {"mixed": (0.2607, 0.2000)},
    "intersect_instances": {0: (0.0869, 0.0831), 1: (0.1556, 0.1498), 2: (0.1026, 0.0995),
                            3: (0.0602, 0.0573)},
    "occluded_instances": {0: (0.0741, 0.0661), 1: (0.0684, 0.0554), 2: (0.0553, 0.0428),
                           3: (0.0386, 0.0245)},
}
REPLACES = {
    "trace_fused": "tpu_render_cluster/render/pallas_kernels.py:901",
    # _octant_of, the packet vote inside _mesh_trace_kernel_factory (rows 3, 4, 6)
    "packet_octants": "tpu_render_cluster/render/pallas_kernels.py:2263",
    # the ordered key epilogue's entry walk, tlas_base(edx, edy, edz) (row 4)
    "mesh_entry_keys": "tpu_render_cluster/render/pallas_kernels.py:3044",
    "trace_fused_lanes": "tpu_render_cluster/render/pallas_kernels.py:901",
    "trace_fused_mesh": "tpu_render_cluster/render/pallas_kernels.py:3205",
    "trace_fused_mesh_tlas": "tpu_render_cluster/render/pallas_kernels.py:3205",
    "mesh_bounce": "tpu_render_cluster/render/pallas_kernels.py:3345",
    "mesh_bounce_tlas": "tpu_render_cluster/render/pallas_kernels.py:3345",
    "sphere_bounce": "tpu_render_cluster/render/pallas_kernels.py:1004",
    "pool_sphere_bounce": "tpu_render_cluster/render/pallas_kernels.py:3784",
    "pool_mesh_bounce": "tpu_render_cluster/render/pallas_kernels.py:3854",
    "pool_mesh_bounce_tlas": "tpu_render_cluster/render/pallas_kernels.py:3854",
    "intersect_instances": "tpu_render_cluster/render/pallas_kernels.py:1869",
    "occluded_instances": "tpu_render_cluster/render/pallas_kernels.py:1926",
    "intersect_spheres": "tpu_render_cluster/render/pallas_kernels.py:447",
    "occluded_spheres": "tpu_render_cluster/render/pallas_kernels.py:533",
    "intersect_mesh": "tpu_render_cluster/render/pallas_kernels.py:1291",
    "occluded_mesh": "tpu_render_cluster/render/pallas_kernels.py:1444",
}
BOUNCE_TOLERANCE = (
    "rtol=atol=1e-4 per ray on contribution, origin, direction and throughput, alive exact; "
    "all rays but max(1, round(0.001 R)) edge-tie rays"
)
KEY_TOLERANCE = (
    BOUNCE_TOLERANCE + "; the key column bit-equal on every lane, and on live lanes equal to "
    "mesh_sort_keys of the launch's outputs"
)
GROUP_TOLERANCE = (
    "every output bit-equal on every lane (the five state outputs, alive and the key column); "
    "the key on live lanes equal to mesh_sort_keys of the launch's outputs"
)
MESH_MEGAKERNEL_TOLERANCE = (
    "rtol=atol=1e-4 per ray; at 1 bounce all but max(1, round(0.001 R)) edge-tie rays, "
    ">=99.9% at 4"
)
ORDERED_TOLERANCE = "; on the octant-ordered walk every output bit-equal on every lane"
TOLERANCE = {
    "trace_fused": "bit-equal to its plain version on every ray, at 1 and 4 bounces",
    "packet_octants": "every vote byte equal, on every launch checked",
    "mesh_entry_keys": "every key equal, and equal to the launch's key column",
    "trace_fused_mesh": MESH_MEGAKERNEL_TOLERANCE + ORDERED_TOLERANCE,
    "trace_fused_mesh_tlas": MESH_MEGAKERNEL_TOLERANCE + ORDERED_TOLERANCE,
    "mesh_bounce": BOUNCE_TOLERANCE + ORDERED_TOLERANCE,
    "mesh_bounce_tlas": GROUP_TOLERANCE,
    "sphere_bounce": BOUNCE_TOLERANCE,
    "pool_mesh_bounce": BOUNCE_TOLERANCE + ORDERED_TOLERANCE,
    "pool_mesh_bounce_tlas": GROUP_TOLERANCE,
    "pool_sphere_bounce": BOUNCE_TOLERANCE,
    "intersect_spheres": "t within rtol 2e-5 / atol 2e-4 and the index equal on every ray that hits",
    "occluded_spheres": "equal on every ray",
    "intersect_instances": "t, triangle row and instance bit-equal on every ray",
    "occluded_instances": "bit-equal on every ray",
    "intersect_mesh": (
        "t within rtol=atol=1e-4 on every ray; triangle row equal on every hit ray but "
        "max(1, round(0.001 R)) exact-tie rays"
    ),
    "occluded_mesh": "equal on every ray but max(1, round(0.001 R)) edge-tie rays",
}


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def agreement(got, expected) -> tuple[float, int, float]:
    """(fraction of rays whose 3 channels agree at rtol=atol=1e-4, rays
    that do not, max abs error over all values)."""
    import torch

    close = torch.isclose(got, expected, rtol=1e-4, atol=1e-4).all(dim=1)
    return close.float().mean().item(), int((~close).sum()), (got - expected).abs().max().item()


def bounce_agreement(got, expected) -> dict:
    """Two ``BounceState``s of the same rays: the fraction of rays whose
    four float outputs agree at rtol=atol=1e-4, the rays that do not, those
    whose alive differs, the bit-equal fraction and the max abs error."""
    import torch

    close = torch.ones_like(got.alive)
    equal = got.alive == expected.alive
    err = 0.0
    for have, want in zip(got[:4], expected[:4]):
        close &= torch.isclose(have, want, rtol=1e-4, atol=1e-4).all(dim=1)
        equal &= (have == want).all(dim=1)
        err = max(err, (have - want).abs().max().item())
    return {
        "fraction": close.float().mean().item(), "bad": int((~close).sum()),
        "alive_bad": int((got.alive != expected.alive).sum()),
        "bit_equal": equal.float().mean().item(), "err": err,
    }


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / repeats


def host_ms(fn, repeats: int) -> float:
    """Mean host milliseconds per call of ``fn``, the queue drained first:
    the time to build a call's operands and enqueue its launches. Where it
    nears ``cuda_ms``, the host, not the card, sets the call's time."""
    import torch

    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(repeats):
        fn()
    elapsed = time.perf_counter() - started
    torch.cuda.synchronize()
    return elapsed * 1e3 / repeats


def device_time(fn, kernel: str | tuple[str, ...], launches: int | None = None) -> dict | None:
    """One run of ``fn`` under torch.profiler (CUPTI): its wall ms, the
    summed device ms of every device operation it ran (kernels, copies,
    fills: the device's own events; a PyTorch operator's events repeat the
    device time of the kernels it launched and are left out), and that of
    ``kernel``'s own launches (the events of its CUDA function
    ``<kernel>_kernel``; several kernels: summed, and each in
    ``per_kernel``), with the launches the profile saw and those the
    wrappers counted (``launches``: those ``fn`` makes where no wrapper
    counts them, an earlier build of the kernel, chip_ab.py). None where the profiler
    records no device time (then these numbers are not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_render_cluster_torch.render import kernels

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    torch.cuda.synchronize()
    counted = {name: kernels.counts[name] for name in names}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        # Idle margins inside the window: the profiler has dropped device
        # events that lie next to its start or stop.
        time.sleep(0.05)
        started = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3
        time.sleep(0.05)
    events = [e for e in trace.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None
    own = {name: [e for e in events if re.search(rf"\b{name}_kernel\b", e.name)] for name in names}
    per_kernel = {name: sum(e.device_time_total for e in own[name]) / 1e3 for name in names}
    return {
        "wall_ms": wall_ms,
        "device_ms": sum(e.device_time_total for e in events) / 1e3,
        "kernel_ms": sum(per_kernel.values()),
        "per_kernel": per_kernel,
        "kernels": len(events),
        "seen": sum(len(found) for found in own.values()),
        "launched": launches if launches is not None else sum(
            kernels.counts[name] - counted[name] for name in names
        ),
    }


def profiled(fn, kernel: str | tuple[str, ...], label: str, tries: int = 3,
             launches: int | None = None) -> dict | None:
    """``device_time`` that reports, and does not raise, when the
    profiler cannot trace the card, and that trusts a profile only where it
    saw every launch of ``kernel`` that ``fn`` made: it profiles ``fn`` up
    to ``tries`` times (also after a profile that recorded no device time
    at all, which on the H100 machine every other profile in a row can be),
    and else reports not measured."""
    for _ in range(tries):
        try:
            result = device_time(fn, kernel, launches)
        except Exception as error:  # noqa: BLE001 - the profiler is optional here
            print(f"[6] {label}: profiler failed ({type(error).__name__}: {error}); not measured")
            return None
        if result is None:
            print(f"[6] {label}: the profiler recorded no device time; profiling again")
            continue
        if result["seen"] == result["launched"] > 0:
            return result
        print(
            f"[6] {label}: the profile saw {result['seen']} of {result['launched']} "
            f"{kernel} launches ({result['kernels']} device operations); profiling again"
        )
    print(f"[6] {label}: no profile saw every launch; not measured")
    return None


def alone_ms(once, kernel: str, label: str, calls: int = 5, counted: bool = True) -> float | None:
    """The kernel alone per call of ``once`` (one launch of ``kernel``),
    from a window of ``calls`` calls that the profiler saw whole, profiled
    up to six times (``counted`` False: a launch no wrapper counts). None:
    not measured."""
    result = profiled(lambda: [once() for _ in range(calls)], kernel, label, tries=6,
                      launches=None if counted else calls)
    return None if result is None else result["kernel_ms"] / calls


class Trace:
    """One kernel's path trace and plain version, bound to a scene's inputs:
    a megakernel's wrapper, or for a per-bounce kernel the wavefront driver
    (``run``), the masked deep loop (``masked``) and one bounce. A mesh
    kernel's name picks its variant: ``..._tlas`` the TLAS one, else the
    flat one (``use_tlas=False``)."""

    def __init__(self, kernel: str, scene_name: str, frame: int, device):
        from tpu_render_cluster_torch.render import kernels
        from tpu_render_cluster_torch.render.mesh import scene_mesh_set
        from tpu_render_cluster_torch.render.scene import build_scene

        self.kernels = kernels
        self.kernel = kernel
        self.base = kernel.removesuffix("_tlas")
        self.use_tlas = kernel in TLAS_KERNELS
        self.scene = build_scene(scene_name, frame, device)
        self.mesh = None
        if self.base in ("trace_fused_mesh", "mesh_bounce"):
            # Any mesh, also one past the dispatch bound (a direct call).
            self.mesh = scene_mesh_set(scene_name, frame, device=device)

    def run(self, origins, directions, seed, max_bounces, on_launch=None):
        from tpu_render_cluster_torch.render import compaction

        if self.base in ("sphere_bounce", "mesh_bounce"):
            return compaction.trace_paths_wavefront(
                self.scene, origins, directions, seed, max_bounces=max_bounces,
                mesh=self.mesh, on_launch=on_launch, use_tlas=self.use_tlas,
            )
        if self.mesh is None:
            return self.kernels.trace_paths_fused(
                self.scene, origins, directions, seed, max_bounces=max_bounces
            )
        return self.kernels.trace_paths_fused_mesh(
            self.scene, self.mesh, origins, directions, seed, max_bounces=max_bounces,
            use_tlas=self.use_tlas,
        )

    def masked(self, origins, directions, seed, max_bounces):
        from tpu_render_cluster_torch.render import integrator

        return integrator.trace_paths(
            self.scene, origins, directions, seed, max_bounces=max_bounces, mesh=self.mesh,
            use_tlas=self.use_tlas,
        )

    def plain(self, origins, directions, seed, max_bounces, stats=None):
        if self.mesh is None:
            return self.kernels.trace_paths_fused_reference(
                self.scene, origins, directions, seed, max_bounces=max_bounces, stats=stats
            )
        return self.kernels.trace_paths_fused_mesh_reference(
            self.scene, self.mesh, origins, directions, seed, max_bounces=max_bounces,
            use_tlas=self.use_tlas, stats=stats,
        )

    def bounce(self, state, live, seed, bounce, *, plain=False, stats=None):
        """One launch of the per-bounce kernel (or its plain version) on a
        wavefront launch's state."""
        kernels = self.kernels
        args = (*state, live, seed, bounce)
        if self.mesh is None:
            if plain:
                return kernels.sphere_bounce_reference(
                    self.scene, *args, total_bounces=BOUNCES, stats=stats
                )
            return kernels.sphere_bounce(self.scene, *args, total_bounces=BOUNCES)
        if plain:
            return kernels.mesh_bounce_reference(
                self.scene, self.mesh, *args, total_bounces=BOUNCES, use_tlas=self.use_tlas,
                stats=stats,
            )
        return kernels.mesh_bounce(
            self.scene, self.mesh, *args, total_bounces=BOUNCES, use_tlas=self.use_tlas
        )


def kernel_vs_plain(kernel: str, scene_name: str, device) -> tuple[float, float]:
    """Phase 3 for one megakernel and scene: (lowest agreeing fraction, max
    abs error) over 1 and 4 bounces at CHECK_SIDE x CHECK_SIDE x CHECK_SAMPLES spp."""
    import torch

    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed

    frame = 7 if kernel == "trace_fused" else 30
    trace = Trace(kernel, scene_name, frame, device)
    origins, directions, seed = frame_rays_and_seed(
        scene_camera(scene_name, frame, device), frame,
        width=CHECK_SIDE, height=CHECK_SIDE, samples=CHECK_SAMPLES,
    )
    agree_min, max_err = 1.0, 0.0
    for max_bounces in (1, 4):
        got = trace.run(origins, directions, seed, max_bounces)
        expected = trace.plain(origins, directions, seed, max_bounces)
        torch.cuda.synchronize()
        fraction, bad, err = agreement(got, expected)
        bit_equal = (got == expected).all(dim=1).float().mean().item()
        print(
            f"[3] {kernel} vs plain, {scene_name}, {CHECK_SIDE}x{CHECK_SIDE}x{CHECK_SAMPLES} spp, {max_bounces} bounce(s): "
            f"{fraction:.6f} of rays within 1e-4 ({bad} not), {bit_equal:.6f} bit-equal, "
            f"max abs err {err:.3g}"
        )
        check(torch.isfinite(got).all().item(), f"non-finite radiance ({kernel}, {scene_name})")
        if kernel in ORDERED_KERNELS and trace.kernels.walks_ordered(trace.mesh.bvh):
            check(bit_equal == 1.0, f"{kernel} {scene_name}: the ordered walk is not bit-equal "
                                    f"to its plain version")
        if kernel == "trace_fused":
            check(bit_equal == 1.0, f"{kernel} {scene_name} {max_bounces} bounce(s): not "
                                    f"bit-equal to its plain version ({bit_equal})")
        elif max_bounces == 4:
            check(fraction >= 0.999, f"{kernel} {scene_name} 4 bounces: {fraction} < 0.999")
        else:
            budget = max(1, round(0.001 * got.shape[0]))
            check(bad <= budget, f"{kernel} {scene_name} 1 bounce: {bad} rays > budget {budget}")
        agree_min = min(agree_min, fraction)
        max_err = max(max_err, err)
    return agree_min, max_err


def check_bounce(label: str, trace: Trace, launch, seed, rows=None, stats=None) -> dict:
    """One wavefront launch through the per-bounce kernel and through its
    plain version: on every ray, or the plain version on ``rows`` of the
    launch only (the kernel's result for a ray does not depend on the other
    rays). Raises past the edge-tie budget."""
    import torch

    got = trace.bounce(launch.state, launch.live, seed, launch.bounce)
    state, live = launch.state, launch.live
    if rows is not None:  # ascending, so the live rows stay in front
        state = tuple(t[rows] for t in state)
        live = int((rows < launch.live).sum())
        got = type(got)(*(t[rows] for t in got))
    out: list = []
    plain_ms = cuda_ms(
        lambda: out.append(trace.bounce(state, live, seed, launch.bounce, plain=True, stats=stats)), 1
    )
    expected = out[0]
    result = {**bounce_agreement(got, expected), "plain_ms": plain_ms}
    rays = state[0].shape[0]
    budget = max(1, round(0.001 * rays))
    print(
        f"[{label}] {trace.kernel} vs plain, bounce {launch.bounce} (live {launch.live} of "
        f"{launch.bucket}{'' if rows is None else f', {rays} rays drawn'}): "
        f"{result['fraction']:.6f} of rays within 1e-4 ({result['bad']} not), "
        f"{result['alive_bad']} alive differ, {result['bit_equal']:.6f} bit-equal, "
        f"max abs err {result['err']:.3g}"
    )
    check(all(torch.isfinite(t).all().item() for t in got[:4]), f"{label}: non-finite state")
    check(result["bad"] <= budget and result["alive_bad"] <= budget,
          f"{trace.kernel} bounce {launch.bounce}: past the budget of {budget} rays")
    check(not got.alive[live:].any().item(), f"{trace.kernel}: a lane past the live count lives")
    ordered = trace.mesh is not None and trace.kernels.walks_ordered(trace.mesh.bvh)
    if trace.kernel in GROUP_KERNELS or ordered:
        check(result["bit_equal"] == 1.0 and result["alive_bad"] == 0,
              f"{trace.kernel} bounce {launch.bounce}: not bit-equal to its plain version")
    if ordered:
        tables = trace.kernels.tlas_frame(trace.mesh).slots if trace.use_tlas else None
        check_passes(label, trace.kernel, trace.mesh, state, live, launch.bounce, got, tables,
                     expected)
    if trace.use_tlas:
        frame = trace.kernels.tlas_frame(trace.mesh)
        result.update(check_keys(
            label, trace.kernel, got, expected, live, launch.bounce < BOUNCES - 1, frame.slots,
            frame.key_window,
        ))
    return result


def check_passes(label: str, kernel: str, mesh, state, live: int, bounce: int | None, got,
                 table=None, expected=None, per_frame: int = 0) -> None:
    """The passes of an ordered launch of ``kernel`` on its input ``state``
    and output ``got``, each through its kernel against its plain version on
    the card, exactly: the packet votes (over ``table``'s rows: the slots
    under TLAS, else ``mesh``'s instance table; a pool's stacked rows,
    ``per_frame`` a frame, for the frames of each packet's lanes) and,
    for the per-bounce TLAS kernel, the key pass on ``got`` against the key
    column of the plain bounce ``expected`` (the plain key pass's
    arithmetic, ``kernels._keys_reference``) and the launch's own. ``bounce``
    None: a pool launch (no world vote)."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    tlas = kernel in TLAS_KERNELS
    block = kernels.TLAS_BLOCK_R if tlas else kernels.BVH_BLOCK_R
    table = kernels.instance_table(mesh) if table is None else table
    world = tlas and bounce is not None
    # A pool launch votes only the rows of the frames each packet carries.
    frames = {} if bounce is not None else {"frames": state[5], "per_frame": per_frame}
    votes = kernels.packet_votes(state[1], table, live, block=block, world=world, **frames)
    plain = kernels.packet_votes_reference(state[1], table, live, block=block, world=world,
                                           **frames)
    differ = sum(int((a != b).sum()) for a, b in zip(votes, plain) if a is not None)
    check(differ == 0, f"{kernel}: {differ} packet votes differ from the plain version's")
    PASS_CHECKS["packet_octants"] += 1
    packets = -(-state[1].shape[0] // block)
    message = f"[{label}] {kernel}'s passes: the packet votes ({packets} packets) equal the plain version's"
    if tlas and bounce is not None:
        keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive, live, bounce,
                                  total_bounces=BOUNCES)
        differ = int((keys != expected.key).sum()) + int((keys != got.key).sum())
        check(differ == 0, f"{kernel}: {differ} keys of the key pass differ")
        PASS_CHECKS["mesh_entry_keys"] += 1
        message += f"; the key pass's {keys.shape[0]} keys equal the plain version's and the launch's"
    torch.cuda.synchronize()
    print(message)


def packet_rows(bucket: int, block: int, count: int, generator, device):
    """``count`` lanes of a launch of ``bucket`` lanes drawn as whole
    packets of ``block`` (ascending): on the octant-ordered walk a lane's
    result depends on its packet's votes, which a subset of whole packets
    keeps."""
    import torch

    packets = torch.randperm(bucket // block, generator=generator, device=device)
    chosen = packets[:max(1, count // block)].sort().values
    return (chosen[:, None] * block + torch.arange(block, device=device)).reshape(-1)


def check_keys(label: str, kernel: str, got, expected, live: int, keyed: bool, slots, window,
               fid=None, per_frame: int = 0) -> dict:
    """A TLAS launch's key column against its plain version's, bit for bit
    on every lane; on the lanes that walked for a candidate (alive after
    the bounce, below the live count; not on the last bounce) also against
    the key computed outside the kernel from the launch's own outputs
    (``mesh_sort_keys`` with ``instance_entry_candidates`` over the
    slot-ordered world boxes ``slots``; a pool, with each lane's frame id
    ``fid``: its frame's ``per_frame`` rows of the stack, the candidate
    frame-local). ``instance_entry_candidates`` gives an exact entry tie to
    the lowest slot; the octant-ordered entry walk (the reference's default)
    to the slot its packet's table meets first: a lane may differ from the
    twin only so, in the candidate bits alone, between two slots the ray
    enters at the same distance (counted as ties). Raises on any other
    difference."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    differ = int((got.key != expected.key).sum())
    lanes = got.alive & (torch.arange(got.alive.shape[0], device=got.alive.device) < live)
    twin_differ, walked, ties = 0, int(lanes.sum()) if keyed else 0, 0
    if keyed:
        if fid is None:
            candidate = kernels.instance_entry_candidates(
                got.origins, got.directions, slots[:, 13:16], slots[:, 16:19]
            )
        else:
            candidate = torch.full(fid.shape, per_frame, dtype=torch.int64, device=fid.device)
            for f in range(slots.shape[0] // per_frame):
                rows = (fid == f).nonzero()[:, 0]
                boxes = slots[f * per_frame:(f + 1) * per_frame]
                candidate[rows] = kernels.instance_entry_candidates(
                    got.origins[rows], got.directions[rows], boxes[:, 13:16], boxes[:, 16:19]
                )
        twin = kernels.mesh_sort_keys(
            got.origins, got.directions, got.alive, window, fid=fid, candidate=candidate,
        )
        mismatch = (twin != got.key) & lanes
        if bool(mismatch.any()):
            rows = mismatch.nonzero()[:, 0]
            cand_bits = 0x3F << 18
            offset = 0 if fid is None else fid[rows].long() * per_frame
            count = slots.shape[0] if fid is None else per_frame
            picked = [((key[rows] >> 18) & 63).long() for key in (got.key, twin)]
            entries = [
                kernels.slot_entries(got.origins[rows], got.directions[rows], slots[:, 13:16],
                                     slots[:, 16:19], offset + slot)
                for slot in picked
            ]
            tie = (((got.key[rows] ^ twin[rows]) & ~cand_bits) == 0) & (
                entries[0] == entries[1]) & (entries[0] < kernels.INF) & (
                picked[0] < count) & (picked[1] < count)
            ties = int(tie.sum())
        twin_differ = int(mismatch.sum()) - ties
    print(
        f"[{label}] {kernel} key column: {differ} of {got.key.shape[0]} lanes differ from the "
        f"plain version's; on the {walked} lanes that walked for a candidate, {twin_differ} "
        f"differ from mesh_sort_keys of the launch's outputs but exact entry ties ({ties} "
        f"ties, met in the packet's octant order)"
    )
    check(differ == 0, f"{kernel}: {differ} keys differ from the plain version's")
    check(twin_differ == 0, f"{kernel}: {twin_differ} live keys differ from mesh_sort_keys")
    return {"key_lanes_differ": differ, "key_twin_lanes": walked, "key_entry_ties": ties}


def bounce_kernel_vs_plain(kernel: str, scene_name: str, device) -> tuple[float, float]:
    """Phase 3 for a per-bounce kernel: every launch of a wavefront frame
    of frame 30 at CHECK_SIDE x CHECK_SIDE x CHECK_SAMPLES spp, 4 bounces."""
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed

    trace = Trace(kernel, scene_name, 30, device)
    origins, directions, seed = frame_rays_and_seed(
        scene_camera(scene_name, 30, device), 30,
        width=CHECK_SIDE, height=CHECK_SIDE, samples=CHECK_SAMPLES,
    )
    launches: list = []
    trace.run(origins, directions, seed, BOUNCES, on_launch=launches.append)
    check(len(launches) >= 2 and launches[-1].live < origins.shape[0],
          f"{kernel} {scene_name}: no later bounce with a dead tail")
    results = [check_bounce("3", trace, launch, seed) for launch in launches]
    return min(r["fraction"] for r in results), max(r["err"] for r in results)


def job_frames(path: MainPath):
    """The job of a main path and the frames the path renders."""
    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.render.scene import scene_for_job_name

    job = BlenderJob.load_from_file(REPO / path.job_file)
    check(scene_for_job_name(job.job_name) == path.scene, f"{job.job_name} is not {path.scene}")
    frames = list(job.frame_indices())[:path.frames]
    check(len(frames) == path.frames, f"expected {path.frames} frames of {job.job_name}")
    return job, frames


def frame_input_parity(device) -> None:
    """Phase 3's check that the card renders from the CPU's inputs: for
    every frame of every main path, the scene, the camera, the mesh
    instances and the primary rays of the three ray builders
    (``render/parity.py`` ``frame_inputs``) at the main paths' 512x512, the
    flattened builder at 2 samples (the first two of its 8: its rays are
    sample-major), on the card against the CPU's, bit for bit: no element
    may differ."""
    from tpu_render_cluster_torch.render import parity

    frames = sorted({(path.scene, frame) for path in PATHS for frame in job_frames(path)[1]})
    differing: dict[str, int] = {}
    elements = 0
    for scene_name, frame in frames:
        card, host = (
            parity.frame_inputs(scene_name, frame, where, width=WIDTH, height=HEIGHT, samples=2)
            for where in (device, "cpu")
        )
        for name, count in parity.differing_elements(card, host).items():
            differing[name] = differing.get(name, 0) + count
        elements += sum(t.numel() for t in host.values())
    total = sum(differing.values())
    scenes = sorted({scene_name for scene_name, _ in frames})
    print(
        f"[3] frame inputs on the card vs the CPU, bit for bit: {len(frames)} frames of "
        f"{scenes}, {len(differing)} kinds of tensor, {elements} elements: {total} differ"
        + ("" if total == 0 else f" ({ {k: v for k, v in differing.items() if v} })")
    )
    check(total == 0, f"{total} elements of the frame inputs differ between the card and the CPU")


def pool_launch_roles(launches, window) -> dict:
    """The launches of one window that phase 3 checks, by role: the first;
    for each boundary between frames f - 1 and f, the first launch whose
    live lanes hold frame f and an earlier one, at more than one bounce
    depth where a launch does (the last boundary is the role "mixed"); the
    last launch (the drain, every primary served)."""
    import torch

    spans = []  # (lowest fid, highest fid, bounce depths) of each launch's live lanes
    for launch in launches:
        live = int(launch.live)
        check(live > 0, f"launch {launch.iteration} runs no lane")
        fid, bounce = launch.state[5][:live], launch.state[7][:live]
        lo, hi, b_lo, b_hi = torch.stack([fid.min(), fid.max(), bounce.min(), bounce.max()]).tolist()
        spans.append((lo, hi, b_hi > b_lo))
    roles = {"first": 0}
    frames = len(window.frames)
    for f in range(1, frames):
        holding = [i for i, (lo, hi, _) in enumerate(spans) if lo < f <= hi]
        check(bool(holding), f"no launch holds lanes of frames {f - 1} and {f}")
        mixed = [i for i in holding if spans[i][2]]
        roles["mixed" if f == frames - 1 else f"frames {f - 1}-{f}"] = (mixed or holding)[0]
    roles["drain"] = len(launches) - 1
    return roles


def pool_functions(kernel: str):
    """(wrapper, plain version) of a pool kernel; a mesh one's at its
    variant (``..._tlas``: the TLAS one)."""
    import functools

    from tpu_render_cluster_torch.render import kernels

    base = kernel.removesuffix("_tlas")
    wrapper, plain = getattr(kernels, base), getattr(kernels, f"{base}_reference")
    if base != "pool_mesh_bounce":
        return wrapper, plain
    options = {"use_tlas": kernel in TLAS_KERNELS}
    return functools.partial(wrapper, **options), functools.partial(plain, **options)


def pool_kernel_vs_plain(path: MainPath, device) -> dict:
    """Phase 3 for a pool kernel: each window of its main path's frames at
    the main path's size, iterated one step at a time, each launch's input
    kept; the launches of ``pool_launch_roles`` through the kernel and its
    plain version on all the pool's lanes (the plain version counting the
    work); then one chunk of the loop body under
    set_sync_debug_mode("error"). Returns the first window's launches and
    states, for phase 5."""
    import torch

    from tpu_render_cluster_torch.render import kernels, raypool

    kernel = path.kernel
    _, frames = job_frames(path)
    cap = raypool.RAYPOOL_FRAMES
    wrapper, plain = pool_functions(kernel)
    results = []
    for start in range(0, len(frames), cap):
        window = raypool.PoolWindow(
            path.scene, frames[start:start + cap], width=WIDTH, height=HEIGHT, samples=SAMPLES,
            max_bounces=BOUNCES, device=device, use_tlas=path.use_tlas,
        )
        states, launches = [], []
        state = window.initial_state()
        while bool(window.more(state)):
            states.append(state)
            state = window.iteration(state, len(launches), launches.append)
        check(int(state.counters[0]) == window.total, f"{kernel}: the window served {int(state.counters[0])}")
        roles = pool_launch_roles(launches, window)
        picked = {}
        for role, index in roles.items():
            same = [p for p in picked.values() if p["index"] == index]
            if same:  # a launch that fills two roles is checked once
                picked[role] = same[0]
                continue
            launch = launches[index]
            live = int(launch.live)
            got = wrapper(window.ops, *launch.state, live, total_bounces=BOUNCES)
            stats: dict = {}
            out: list = []
            plain_ms = cuda_ms(
                lambda: out.append(plain(window.ops, *launch.state, live, total_bounces=BOUNCES, stats=stats)), 1
            )
            result = {**bounce_agreement(got, out[0]), "plain_ms": plain_ms}
            budget = max(1, round(0.001 * window.pool))
            fids = sorted(set(launch.state[5][:live].unique().tolist()))
            bounces = launch.state[7][:live].unique().numel()
            print(
                f"[3] {kernel} vs plain, {path.scene} window of frames {window.frames[0]}-"
                f"{window.frames[-1]}, {role} launch (iteration {index} of {len(launches)}; live "
                f"{live} of {window.pool}, frame ids {fids}, {bounces} bounce depth(s)): "
                f"{result['fraction']:.6f} of lanes within 1e-4 ({result['bad']} not), "
                f"{result['alive_bad']} alive differ, {result['bit_equal']:.6f} bit-equal, max abs "
                f"err {result['err']:.3g}"
            )
            check(all(torch.isfinite(t).all().item() for t in got[:4]), f"{kernel}: non-finite state")
            check(result["bad"] <= budget and result["alive_bad"] <= budget,
                  f"{kernel} {role} launch: past the budget of {budget} lanes")
            check(not got.alive[live:].any().item(), f"{kernel}: a lane past the live count lives")
            ordered = kernel in ORDERED_KERNELS and kernels.walks_ordered(window.ops.meshes[0].bvh)
            if kernel in GROUP_KERNELS or ordered:
                check(result["bit_equal"] == 1.0 and result["alive_bad"] == 0,
                      f"{kernel} {role} launch: not bit-equal to its plain version")
            if ordered:
                stacked = (kernels.pool_tlas_operands(window.ops).slots
                           if kernel in TLAS_KERNELS else window.ops.instances)
                check_passes("3", kernel, window.ops.meshes[0], launch.state, live, None, got,
                             stacked, per_frame=window.ops.per_frame)
            if kernel in TLAS_KERNELS:
                pool_tlas = kernels.pool_tlas_operands(window.ops)
                result.update(check_keys(
                    "3", kernel, got, out[0], live, True, pool_tlas.slots, pool_tlas.key_window,
                    fid=launch.state[5], per_frame=window.ops.per_frame,
                ))
            picked[role] = {"index": index, "live": live, "stats": stats, **result}
        if start == 0:
            first = {"window": window, "picked": picked,
                     "launches": {i: launches[i] for i in roles.values()},
                     "states": {i: states[i] for i in roles.values()}}
        results.extend({p["index"]: p for p in picked.values()}.values())
        del states, launches

    if kernel in GROUP_KERNELS:
        results.append(unsorted_pool_vs_plain(kernel, first, device))

    # No host read inside the loop body: one chunk under the sync check.
    window = first["window"]
    state = window.iteration(window.initial_state(), 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for index in range(1, 1 + raypool.CHECK_EVERY):
            state = window.iteration(state, index)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"[3] {kernel}: {raypool.CHECK_EVERY} iterations of the pool's loop body ran under "
          f"set_sync_debug_mode('error') without a synchronizing call")
    return {
        **first, "checked_launches": len(results),
        "agree": min(r["fraction"] for r in results),
        "max_abs_err": max(r["err"] for r in results),
    }


def unsorted_pool_vs_plain(kernel: str, first: dict, device) -> dict:
    """Phase 3 for the group-walk pool kernel: the first window's mixed
    launch with its lanes given frame ids 0-7 at random (each its frame's
    seed) and shuffled, so that every block holds lanes of all 8 frames
    and reads the frame tables from global memory, through the kernel and
    its plain version on all the pool's lanes, bit for bit."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    window = first["window"]
    launch = first["launches"][first["picked"]["mixed"]["index"]]
    generator = torch.Generator(device=device).manual_seed(8)
    pool = window.pool
    fid = torch.randint(0, len(window.frames), (pool,), generator=generator, device=device,
                        dtype=torch.int32)
    state = list(launch.state)
    state[5], state[6] = fid, window.seeds[fid.long()]
    perm = torch.randperm(pool, generator=generator, device=device)
    state = [t[perm] for t in state]
    wrapper, plain = pool_functions(kernel)
    got = wrapper(window.ops, *state, pool, total_bounces=BOUNCES)
    out: list = []
    plain_ms = cuda_ms(lambda: out.append(plain(window.ops, *state, pool, total_bounces=BOUNCES)), 1)
    result = {**bounce_agreement(got, out[0]), "plain_ms": plain_ms}
    per_block = 256 // kernels.POOL_GROUP
    blocks = state[5][: pool // per_block * per_block].reshape(-1, per_block)
    frames_per_block = min(int(row.unique().numel()) for row in blocks[:64])
    print(
        f"[3] {kernel} vs plain, unsorted launch (the mixed launch's lanes shuffled, frame ids "
        f"0-{len(window.frames) - 1} at random; at least {frames_per_block} frames in each of the "
        f"first 64 blocks of {per_block} lanes): {result['bit_equal']:.6f} bit-equal, "
        f"{result['alive_bad']} alive differ, max abs err {result['err']:.3g}"
    )
    check(result["bit_equal"] == 1.0 and result["alive_bad"] == 0,
          f"{kernel} unsorted launch: not bit-equal to its plain version")
    pool_tlas = kernels.pool_tlas_operands(window.ops)
    result.update(check_keys(
        "3", kernel, got, out[0], pool, True, pool_tlas.slots, pool_tlas.key_window,
        fid=state[5], per_frame=window.ops.per_frame,
    ))
    # Every packet carries all 8 frames: the vote's frame skip saves nothing.
    check_passes("3", kernel, window.ops.meshes[0], state, pool, None, got, pool_tlas.slots,
                 per_frame=window.ops.per_frame)
    first["unsorted"] = state  # for phase 7
    return result


def narrow_bounce_vs_plain(kernel: str, device) -> tuple[float, float]:
    """Phase 3 for the group-walk per-bounce kernel at a main path's narrow
    launch: the last (narrowest) launch of a 512x512 8 spp wavefront frame
    of the deep scene, through the kernel (at the group size its width
    takes) and its plain version on all its rays, bit for bit."""
    scene = PATHS[2].scene
    trace = Trace(kernel, scene, 1, device)
    rays = frame_rays(scene, 1, device)
    launches: list = []
    trace.run(*rays, BOUNCES, on_launch=launches.append)
    result = check_bounce("3", trace, launches[-1], rays[2])
    return result["fraction"], result["err"]


def drive_main_path(path: MainPath, device) -> dict:
    """Phase 4 for one path: its first frames through the backend, with the
    launch counts zeroed just before and read just after."""
    import numpy as np
    import torch
    from PIL import Image

    from tpu_render_cluster_torch.render import compaction, kernels, raypool
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    job, frames = job_frames(path)
    pool = path.kernel in POOLS
    label = path.scene
    if path.wavefront is not None:
        label += f" (wavefront={path.wavefront})"
    if pool:
        label += " (ray pool" + ("" if path.raypool is None else f", raypool={path.raypool}") + ")"
    if path.bounce_scan:
        label += " (bounce scan, per instance)" if path.per_instance else " (bounce scan)"
    if path.use_tlas is False:
        label += " (flat, use_tlas=False)"
    wavefront = path.kernel not in MEGAKERNELS and not pool and not path.bounce_scan
    log: list = []  # (bounce, live, bucket) of each wavefront launch
    pool_log: list = []  # the host's iteration index of each pool launch
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as base:
        backend = TorchRaytraceBackend(
            width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES,
            base_directory=base, wavefront=path.wavefront, raypool=path.raypool,
            on_launch=lambda launch: log.append(tuple(launch[:3])),
            on_iteration=lambda launch: pool_log.append(launch.iteration),
            bounce_scan=path.bounce_scan, per_instance=path.per_instance, use_tlas=path.use_tlas,
        )
        check(backend.device.type == "cuda", f"backend chose {backend.device}")
        if not pool and not path.bounce_scan:
            check(compaction.wavefront_active(path.scene, mode=path.wavefront) == wavefront,
                  f"{label}: the backend does not pick the {path.kernel} tier")
        # A pool path hints the frames queued behind each frame; the others
        # hint none, as a worker with one frame queued at a time would (the
        # scan paths take no pool whatever the hint).
        check(path.bounce_scan or raypool.raypool_active(
                  path.scene, mode=path.raypool, frames_ahead=int(pool)) == pool,
              f"{label}: the backend's choice of the ray pool")
        backend.warm(job.job_name)
        torch.cuda.synchronize()
        kernels.reset_counts()
        log.clear()
        pool_log.clear()
        backend.pool_stats.clear()
        started = time.perf_counter()
        timings = []
        for index, frame in enumerate(frames):
            if pool:  # the worker queue's hint: this job's frames queued behind
                backend.note_upcoming_frames(job, tuple(frames[index + 1:]))
            timings.append(asyncio.run(backend.render_frame(job, frame)))
        path_s = time.perf_counter() - started
        launches = dict(kernels.counts)
        windows = list(backend.pool_stats)
        print(f"[4] main path: {len(frames)} frames of {job.job_name} in {path_s:.4f} s; counts {launches}")
        if path.bounce_scan:  # each unit kernel once per sample and bounce (and instance)
            expected_launches = len(frames) * SAMPLES * BOUNCES
        else:
            expected_launches = len(log) if wavefront else len(pool_log) if pool else len(frames)
        check(expected_launches >= len(frames), f"{label}: {len(log)} wavefront launches")
        for name, count in launches.items():
            expected = expected_launches * path.launches_per_step(name) if name in path.launched else 0
            check(count == expected, f"{job.job_name}: {name} ran {count} times, not {expected}")
        if wavefront:
            starts = [i for i, entry in enumerate(log) if entry[0] == 0] + [len(log)]
            first_frame = log[:starts[1]]
            print(
                f"[4] {label}: the driver launched {len(log)} bounces over {len(frames)} frames "
                f"(= the {path.kernel} launches); frame {frames[0]}'s (bounce, live, bucket): "
                f"{first_frame}; live rays per bounce over the frames: "
                + ", ".join(
                    f"{b}: {statistics.mean(e[1] for e in log if e[0] == b):.1f}"
                    for b in sorted({e[0] for e in log})
                )
            )
        if pool:
            iterations = sum(w.iterations for w in windows)
            served = sum(w.served for w in windows)
            print(
                f"[4] {label}: {len(windows)} pool windows, iterations {[w.iterations for w in windows]} "
                f"(= the {path.kernel} launches, {len(pool_log)}), served {served}, live lanes "
                f"summed {[w.live_sum for w in windows]}, host reads per window "
                f"{[w.host_reads for w in windows]}, mean live share of the pool "
                f"{[round(w.live_sum / (w.iterations * raypool.raypool_width(WIDTH * HEIGHT * SAMPLES)), 4) for w in windows]}"
            )
            check(iterations == len(pool_log), f"{label}: {iterations} iterations, {len(pool_log)} launches")
            check(served == len(frames) * WIDTH * HEIGHT * SAMPLES, f"{label}: served {served}")
            check(len(windows) == -(-len(frames) // raypool.RAYPOOL_FRAMES),
                  f"{label}: {len(windows)} windows")

        outputs = sorted((Path(base) / "blender-projects").rglob("*.png"))
        check(len(outputs) == len(frames), f"{len(outputs)} PNGs for {len(frames)} frames")
        images = []
        for output in outputs:
            pixels = np.array(Image.open(output))
            check(pixels.shape == (HEIGHT, WIDTH, 3), f"{output.name}: {pixels.shape}")
            check(pixels.astype(np.float32).std() > 5.0, f"{output.name} is flat")
            images.append(torch.from_numpy(pixels))

        # Two frames again under the profiler, for the card's idle share (a
        # pool path: one window, in pool_record).
        profiled_frames: list = []

        def two_frames():
            profiled_frames[:] = [asyncio.run(backend.render_frame(job, f)) for f in frames[:2]]

        # A per-instance scan frame runs about 140,000 device operations: its
        # idle share comes from one smaller frame (per_instance_record).
        frame_profile = (
            None if pool or path.per_instance
            else profiled(two_frames, path.launched, f"{label} frames")
        )
        if frame_profile is not None:
            render_ms = sum(
                (t.finished_rendering_at - t.started_rendering_at) * 1e3 for t in profiled_frames
            )
            own = ", ".join(f"{k} {v:.3f}" for k, v in frame_profile["per_kernel"].items())
            print(
                f"[6] {label}, 2 frames under the profiler: wall {frame_profile['wall_ms']:.3f} "
                f"ms, device busy {frame_profile['device_ms']:.3f} ms "
                f"({frame_profile['kernels']} device operations; {own} "
                f"ms); device idle {1 - frame_profile['device_ms'] / frame_profile['wall_ms']:.4f} "
                f"of the frames, {1 - frame_profile['device_ms'] / render_ms:.4f} of their render "
                f"phases ({render_ms:.3f} ms)"
            )
    return {
        "path": path, "label": label, "frames": frames, "timings": timings, "path_s": path_s,
        "launches": (
            {name: launches[name] for name in path.launched} if path.bounce_scan
            else launches[path.kernel]
        ),
        "pass_launches": {name: launches[name] for name in PASSES},
        "images": images, "windows": windows, "frame_profile": frame_profile,
    }


def tlas_vs_flat(run: dict, device) -> dict:
    """Phase 4 for a TLAS main path: frame 1 through the path's tier with
    the TLAS kernels and again with the flat ones (``use_tlas=False``) on
    the card, ray for ray (a pool path: the linear images of a window of
    its first two frames), within atol 1e-5, the bit-equal share printed."""
    import torch

    from tpu_render_cluster_torch.render import raypool

    path, frame = run["path"], run["frames"][0]
    if path.kernel in POOLS:
        got, want = (
            torch.stack(raypool.render_batch_raypool(
                path.scene, run["frames"][:2], width=WIDTH, height=HEIGHT, samples=SAMPLES,
                max_bounces=BOUNCES, device=device, use_tlas=use_tlas,
            )[0])
            for use_tlas in (None, False)
        )
        what = f"frames {run['frames'][:2]} of a pool window, linear images"
    else:
        rays = frame_rays(path.scene, frame, device)
        got, want = (
            Trace(kernel, path.scene, frame, device).run(*rays, BOUNCES)
            for kernel in (path.kernel, path.kernel.removesuffix("_tlas"))
        )
        what = f"frame {frame}, radiance per ray"
    err = (got - want).abs().max().item()
    bit_equal = (got == want).all(dim=-1).float().mean().item()
    print(
        f"[4] {run['label']} {what}: TLAS ({path.kernel}) vs flat "
        f"({path.kernel.removesuffix('_tlas')}) on the card: max abs err {err:.3g}, "
        f"{bit_equal:.6f} bit-equal"
    )
    check(err <= 1e-5, f"{run['label']}: TLAS and flat differ by {err}")
    return {"max_abs_err": err, "bit_equal_share": bit_equal}


def frame_rays(scene_name: str, frame: int, device):
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed

    return frame_rays_and_seed(
        scene_camera(scene_name, frame, device), frame, width=WIDTH, height=HEIGHT, samples=SAMPLES
    )


def to_image(radiance):
    from tpu_render_cluster_torch.render.integrator import tonemap

    return tonemap(
        radiance.reshape(SAMPLES, HEIGHT * WIDTH, 3).mean(dim=0).reshape(HEIGHT, WIDTH, 3)
    ).cpu()


def within_one(image, expected) -> float:
    return ((image.int() - expected.int()).abs() <= 1).float().mean().item()


def frame_vs_plain(run: dict, device) -> tuple[Trace, tuple, dict, float]:
    """Frame 1 of a megakernel's main path against the plain version's
    render of it. Returns the frame's (trace, rays, work counters, the
    plain version's ms on the card for this frame, its work counting
    included)."""
    import torch

    frame, scene_name, kernel = run["frames"][0], run["path"].scene, run["path"].kernel
    trace = Trace(kernel, scene_name, frame, device)
    rays = frame_rays(scene_name, frame, device)
    stats: dict = {}
    result: list = []
    plain_ms = cuda_ms(lambda: result.append(trace.plain(*rays, BOUNCES, stats)), 1)
    plain = result[0]
    within = within_one(run["images"][0], to_image(plain))
    print(f"[4] {scene_name} frame {frame} vs plain-version render: {within:.6f} of uint8 values within 1")
    check(within >= 0.995, f"{scene_name}: main-path frame disagrees with the plain version ({within})")
    fraction, bad, err = agreement(trace.run(*rays, BOUNCES), plain)
    torch.cuda.synchronize()
    print(f"[4] {scene_name} frame {frame} rays, kernel vs plain: {fraction:.6f} within 1e-4 ({bad} not), max abs err {err:.3g}")
    check(fraction >= 0.999, f"{scene_name}: main-path rays disagree ({fraction})")
    return trace, rays, stats, plain_ms


def wavefront_frame_checks(run: dict, reference_images, device) -> dict:
    """Frame 1 of a wavefront main path. The radiance against the masked
    tier on the same rays (the deep path: the masked deep loop, which runs
    the same kernel per ray and should agree to the bit; the sphere path:
    the sphere megakernel), the PNG against the megakernel's render (the
    deep path: the mesh megakernel called directly on the frame's rays; the
    sphere path: its main path's PNGs), and every launch of the frame
    against the plain per-bounce version on SUBSET rays drawn from it, the
    plain version counting their work. Returns the frame's trace, rays,
    launches and the per-launch work counters and plain ms."""
    import torch

    frame, path = run["frames"][0], run["path"]
    trace = Trace(path.kernel, path.scene, frame, device)
    rays = frame_rays(path.scene, frame, device)
    launches: list = []
    wavefront = trace.run(*rays, BOUNCES, on_launch=launches.append)
    if trace.mesh is not None:
        masked = trace.masked(*rays, BOUNCES)
        megakernel = trace.kernels.trace_paths_fused_mesh(
            trace.scene, trace.mesh, *rays, max_bounces=BOUNCES
        )
        within = within_one(run["images"][0], to_image(megakernel))
        print(f"[4] {path.scene} frame {frame}: main-path PNG vs the mesh megakernel's render: {within:.6f} of uint8 values within 1")
        check(within >= 0.995, f"{path.scene}: main-path frame disagrees with row 3 ({within})")
        fraction, bad, err = agreement(wavefront, masked)
        bit_equal = (wavefront == masked).all(dim=1).float().mean().item()
        print(f"[4] {path.scene} frame {frame} rays, wavefront vs masked deep loop: {fraction:.6f} within 1e-4 ({bad} not), {bit_equal:.6f} bit-equal, max abs err {err:.3g}")
        check(fraction >= 0.999, f"{path.scene}: wavefront and masked deep loop disagree ({fraction})")
    else:
        masked = trace.kernels.trace_paths_fused(trace.scene, *rays, max_bounces=BOUNCES)
        fraction, bad, err = agreement(wavefront, masked)
        print(f"[4] {path.scene} frame {frame} rays, wavefront (sphere_bounce) vs trace_fused: {fraction:.6f} within 1e-4 ({bad} not), max abs err {err:.3g}")
        check(fraction >= 0.999, f"{path.scene}: wavefront and megakernel disagree ({fraction})")
        for index, (image, expected) in enumerate(zip(run["images"], reference_images)):
            within = within_one(image, expected)
            print(f"[4] {run['label']} frame {run['frames'][index]} PNG vs the trace_fused path's: {within:.6f} of uint8 values within 1")
            check(within >= 0.995, f"{run['label']}: PNG disagrees with trace_fused's ({within})")
    generator = torch.Generator(device=device).manual_seed(frame)
    work, plain_ms, errors = [], [], []
    block = 256 if trace.mesh is None or trace.use_tlas else trace.kernels.BVH_BLOCK_R
    for launch in launches:
        rows = packet_rows(launch.bucket, block, SUBSET, generator, device)
        stats: dict = {}
        result = check_bounce("4", trace, launch, rays[2], rows=rows, stats=stats)
        plain_ms.append(result["plain_ms"])
        errors.append(result["err"])
        work.append((stats, rows.numel()))
    return {
        "trace": trace, "rays": rays, "launches": launches, "work": work,
        "plain_ms": plain_ms, "max_abs_err": max(errors),
    }


def bound(stats: dict, bytes_moved: float, scale: float = 1.0,
          sphere_operations: float | None = None) -> dict:
    """The least time of the work counted by a plain version, times
    ``scale``, that moves ``bytes_moved``: the larger of its operations over
    the float32 peak and its bytes over the memory rate. ``sphere_operations``,
    when given, replaces the path-trace counters' sphere and shading work
    (a unit kernel's own count).

    A mesh kernel's instance search is counted two ways. "flat": every
    world-AABB test of the kernels' per-thread sweep over the instance
    table (for a TLAS kernel: K tests per search, what the flat sweep would
    test). "needed": what the search needs, about 2 ceil(log2 K) box tests
    of a two-level walk per ray that searches the K instances (a TLAS
    kernel's entry walk for the key is one more search per lane that
    walks it), plus the instances entered as counted. The bound is the
    needed count's, the lower; the flat one and the world-AABB tests' share
    of it are kept beside it, and for a TLAS kernel "walk": the box tests
    its walks made as counted (nodes, leaf slots, the entry walk's). A
    sphere kernel has one count."""
    if sphere_operations is None:
        sphere_operations = (
            OPS_NEAREST_SPHERE * stats["spheres"] * stats["alive_lane_bounces"]
            + OPS_SHADE_HIT * stats["hit_lane_bounces"]
            + OPS_SHADOW_SPHERE * stats["shadow_sphere_tests"]
        )
    rest = scale * (
        sphere_operations
        + OPS_SLAB * stats.get("node_tests", 0)
        + OPS_INSTANCE_WALK * stats.get("instance_walks", 0)
        + OPS_TRIANGLE * stats.get("triangle_tests", 0)
    )
    bytes_ms = bytes_moved / MEMORY_BYTES_PER_S * 1e3

    def least(operations):
        ops_ms = operations / FP32_PEAK_FLOPS * 1e3
        return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")

    if "instances" not in stats:
        bound_ms, bound_by = least(rest)
        return {"ms": bound_ms, "by": bound_by, "operations": rest, "bytes": bytes_moved,
                "flat_ms": None, "world_aabb_share": None, "walk_ms": None}
    searches = stats["broadphase_rays"] + stats.get("entry_rays", 0)
    walk_ms = None
    if "tlas_node_tests" in stats:
        flat_search = scale * OPS_SLAB * stats["instances"] * searches
        walked = stats["world_aabb_tests"] + stats["tlas_node_tests"] + stats["entry_tests"]
        walk_ms = least(rest + scale * OPS_SLAB * walked)[0]
    else:
        flat_search = scale * OPS_SLAB * stats["world_aabb_tests"]
    tests_per_search = max(1, 2 * math.ceil(math.log2(stats["instances"])))
    needed_search = scale * OPS_SLAB * tests_per_search * searches
    bound_ms, bound_by = least(rest + needed_search)
    return {
        "ms": bound_ms, "by": bound_by, "operations": rest + needed_search, "bytes": bytes_moved,
        "flat_ms": least(rest + flat_search)[0],
        "world_aabb_share": flat_search / (rest + flat_search), "walk_ms": walk_ms,
    }


def describe_bound(b: dict) -> str:
    text = f"bound {b['ms']:.4f} ms by {b['by']} ({b['operations'] / 1e9:.3f} GFLOP, {b['bytes'] / 1e6:.2f} MB"
    if b["flat_ms"] is not None:
        text += (
            f"; with the flat instance sweep {b['flat_ms']:.4f} ms, of whose operations the "
            f"world-AABB tests are {b['world_aabb_share']:.3f}"
        )
    if b["walk_ms"] is not None:
        text += f"; with the box tests the TLAS walks made {b['walk_ms']:.4f} ms"
    return text + ")"


def phase_times(run: dict, device, breakdown: bool = True) -> None:
    """Phase 5's host-clock numbers for one path: per-frame phases over the
    job, and one frame split further (each step fenced by a synchronize;
    "scene+camera" includes the frame's mesh instances; "trace" is the
    megakernel's wrapper or the whole wavefront driver)."""
    import torch

    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.image_io import write_image
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed

    timings, path = run["timings"], run["path"]
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    print(
        f"[5] {run['label']} main path per frame (median ms): loading "
        f"{med([t.finished_loading_at - t.started_process_at for t in timings]):.3f}, render "
        f"{med([t.finished_rendering_at - t.started_rendering_at for t in timings]):.3f}, save "
        f"{med([t.file_saving_finished_at - t.file_saving_started_at for t in timings]):.3f}, total "
        f"{med([t.exited_process_at - t.started_process_at for t in timings]):.3f}; "
        f"{len(timings) / run['path_s']:.3f} frames/s over the job"
    )
    if not breakdown:
        return
    steps: dict[str, list[float]] = {
        "scene+camera": [], "rays": [], "trace": [], "mean+tonemap+copy": [], "png": []
    }
    with tempfile.TemporaryDirectory(prefix="chip-smoke-png-") as scratch:
        for frame in run["frames"][:5]:
            marks = [time.perf_counter()]
            trace = Trace(path.kernel, path.scene, frame, device)  # scene and mesh
            camera = scene_camera(path.scene, frame, device)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            rays = frame_rays_and_seed(camera, frame, width=WIDTH, height=HEIGHT, samples=SAMPLES)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            radiance = trace.run(*rays, BOUNCES)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            pixels = to_image(radiance).numpy()
            marks.append(time.perf_counter())
            write_image(Path(scratch) / f"f{frame}.png", pixels, "PNG")
            marks.append(time.perf_counter())
            for key, a, b in zip(steps, marks, marks[1:]):
                steps[key].append((b - a) * 1e3)
    print(
        f"[5] {run['label']} one frame, median ms: "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in steps.items())
    )


def megakernel_record(run: dict, device, agree: float, max_abs_err: float, build_s: float) -> dict:
    """Phases 4-6 after the main path for a megakernel: frame 1 against its
    plain version, the phase times, and the kernel's timings and bound."""
    kernel = run["path"].kernel
    trace, rays, stats, plain_ms = frame_vs_plain(run, device)
    phase_times(run, device)
    kernel_call = lambda: trace.run(*rays, BOUNCES)  # noqa: E731
    # The median of 10 batches of 20 calls: the card's clocks vary with
    # the idle time before a batch.
    cuda_ms(kernel_call, 3)
    batches = [cuda_ms(kernel_call, 20) for _ in range(10)]
    kernel_ms = statistics.median(batches)
    wrapper_host_ms = host_ms(kernel_call, 20)
    # Windows of 5 calls, profiled up to six times: a long profile of 20
    # calls missed launches (PRs 7-10 read "not measured" for row 3 TLAS).
    kernel_only_ms = alone_ms(kernel_call, kernel, f"{kernel} calls")
    if kernel_only_ms is not None:
        print(f"[6] {kernel}, windows of 5 wrapper calls under the profiler: the kernel alone "
              f"{kernel_only_ms:.4f} ms per call")
    n_rays = rays[0].shape[0]
    least = bound(stats, n_rays * MEGAKERNEL_RAY_BYTES)
    print(
        f"[5] {kernel} at {n_rays} rays, {run['path'].scene}: {kernel_ms:.4f} ms "
        f"(median of 10 batches of 20 calls: {', '.join(f'{b:.4f}' for b in batches)}; "
        f"host {wrapper_host_ms:.4f} ms per call); plain version {plain_ms:.3f} ms; "
        f"{describe_bound(least)}; work: {stats}"
    )
    return {
        "name": kernel,
        "route": "cuda",
        "source": f"tpu_render_cluster_torch/render/csrc/{kernel}.cu",
        "replaces": REPLACES[kernel],
        "launches": run["launches"],
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": least["ms"],
        "bound_by": least["by"],
        "library_ms": None,
        "bound_flat_sweep_ms": least["flat_ms"],
        "bound_walk_ms": least["walk_ms"],
        "world_aabb_share": least["world_aabb_share"],
        "host_ms": wrapper_host_ms,
        "kernel_only_ms": kernel_only_ms,
        "agree_fraction_min": agree,
        "tolerance": TOLERANCE[kernel],
        "build_s": build_s,
    }


def bounce_record(run: dict, checked: dict, device, agree: float, max_abs_err: float,
                  build_s: float) -> dict:
    """Phases 5-6 for a per-bounce kernel on frame 1 of its main path: the
    kernel at every launch width (CUDA events, the median of 5 batches of
    5 calls), the compaction before that launch, the estimated bound of
    each launch (its plain version's work counters on SUBSET rays, scaled
    to the launch), and the mesh megakernel on the same frame."""
    import torch

    from tpu_render_cluster_torch.render import compaction

    kernel, trace, rays = run["path"].kernel, checked["trace"], checked["rays"]
    seed = rays[2]
    phase_times(run, device)
    # The compaction's input before each bounce: the primary rays, then the
    # previous launch's output; under TLAS with the keys it sorts by: bounce
    # 0's computed in the compaction (initial_mesh_sort_keys), later ones
    # the previous launch's key column.
    n0 = rays[0].shape[0]
    before = (
        rays[0], rays[1], torch.ones((n0, 3), device=device),
        torch.ones(n0, dtype=torch.bool, device=device),
        torch.arange(n0, dtype=torch.int32, device=device),
    )
    keys = None

    def compact(before, keys):
        if trace.use_tlas and keys is None:
            keys = trace.kernels.initial_mesh_sort_keys(trace.mesh, before[0], before[1], before[3])
        return compaction.compact(*before, trace.mesh, keys)

    ray_bytes = BOUNCE_RAY_BYTES + KEY_BYTES * trace.use_tlas
    per_launch = []
    for launch, (stats, drawn), plain_ms in zip(checked["launches"], checked["work"], checked["plain_ms"]):
        call = lambda launch=launch: trace.bounce(launch.state, launch.live, seed, launch.bounce)  # noqa: E731
        cuda_ms(call, 2)
        launch_ms = statistics.median(cuda_ms(call, 5) for _ in range(5))
        launch_host_ms = host_ms(call, 5)
        compact_ms = statistics.median(
            cuda_ms(lambda: compact(before, keys), 3) for _ in range(3)
        )
        least = bound(stats, launch.bucket * ray_bytes, scale=launch.bucket / drawn)
        alone = profiled(
            lambda: [call() for _ in range(5)], kernel, f"{kernel} bounce {launch.bounce} calls"
        )
        groups = {}
        if kernel in GROUP_KERNELS:
            groups = bounce_groups(trace, launch, seed, alone, least["ms"])
        step = call()
        before = (step.origins, step.directions, step.throughput, step.alive, launch.state[4])
        keys = step.key
        per_launch.append({**groups,
            "bounce": launch.bounce, "live": launch.live, "bucket": launch.bucket,
            "ms": launch_ms, "host_ms": launch_host_ms,
            "kernel_only_ms": None if alone is None else alone["kernel_ms"] / 5,
            "compaction_ms": compact_ms, "bound_ms": least["ms"], "bound_by": least["by"],
            "bound_flat_sweep_ms": least["flat_ms"], "bound_walk_ms": least["walk_ms"],
            "world_aabb_share": least["world_aabb_share"],
            "plain_ms": plain_ms, "plain_rays": drawn,
        })
        print(
            f"[5] {kernel} bounce {launch.bounce}, {launch.bucket} lanes ({launch.live} live): "
            f"{launch_ms:.4f} ms per launch (host {launch_host_ms:.4f} ms per call); compaction "
            f"before it {compact_ms:.4f} ms; {describe_bound(least)}, an estimate from the "
            f"work counted on {drawn} rays drawn from the launch, scaled by "
            f"{launch.bucket / drawn:.2f}; plain version on the {drawn} rays {plain_ms:.3f} ms; "
            f"work: {stats}"
        )
        if alone is not None:
            print(
                f"[6] {kernel} bounce {launch.bounce}, 5 wrapper calls under the profiler: the "
                f"kernel alone {alone['kernel_ms'] / 5:.4f} ms per call; all device work "
                f"{alone['device_ms'] / 5:.4f} ms per call ({alone['kernels'] / 5:.1f} device "
                f"operations per call)"
            )
    first = per_launch[0]
    wrapper_host_ms, kernel_only_ms = first["host_ms"], first["kernel_only_ms"]
    frame_ms = sum(p["ms"] for p in per_launch)
    alone = [p["kernel_only_ms"] for p in per_launch]
    frame_kernel_only_ms = None if None in alone else sum(alone)
    frame_compaction_ms = sum(p["compaction_ms"] for p in per_launch)
    frame_bound_ms = sum(p["bound_ms"] for p in per_launch)
    print(
        f"[5] {kernel} over frame {run['frames'][0]} of {run['label']}: {len(per_launch)} launches, "
        f"{frame_ms:.4f} ms of kernel ({frame_kernel_only_ms} alone), {frame_compaction_ms:.4f} ms "
        f"of compaction, bound {frame_bound_ms:.4f} ms (estimate)"
    )
    if trace.mesh is not None:
        megakernel = lambda: trace.kernels.trace_paths_fused_mesh(  # noqa: E731
            trace.scene, trace.mesh, *rays, max_bounces=BOUNCES, use_tlas=trace.use_tlas
        )
        cuda_ms(megakernel, 1)
        mega_ms = statistics.median(cuda_ms(megakernel, 3) for _ in range(3))
        masked = lambda: trace.masked(*rays, BOUNCES)  # noqa: E731
        cuda_ms(masked, 1)
        masked_ms = statistics.median(cuda_ms(masked, 2) for _ in range(3))
        wavefront_ms = statistics.median(cuda_ms(lambda: trace.run(*rays, BOUNCES), 2) for _ in range(3))
        print(
            f"[5] {run['path'].scene} frame {run['frames'][0]}, whole trace on the card (CUDA "
            f"events, comparison only; the dispatch stays the reference's): wavefront driver "
            f"{wavefront_ms:.4f} ms, masked deep loop {masked_ms:.4f} ms, mesh megakernel "
            f"(trace_fused_mesh{'_tlas' if trace.use_tlas else ''}) {mega_ms:.4f} ms"
        )
    return {
        "name": kernel,
        "route": "cuda",
        "source": f"tpu_render_cluster_torch/render/csrc/{kernel}.cu",
        "replaces": REPLACES[kernel],
        "launches": run["launches"],
        "max_abs_err": max(max_abs_err, checked["max_abs_err"]),
        "ms": first["ms"],
        "plain_ms": first["plain_ms"],
        "plain_rays": first["plain_rays"],
        "bound_ms": first["bound_ms"],
        "bound_by": first["bound_by"],
        "bound_flat_sweep_ms": first["bound_flat_sweep_ms"],
        "bound_walk_ms": first["bound_walk_ms"],
        "world_aabb_share": first["world_aabb_share"],
        "bound_is_estimate": f"work counted on {first['plain_rays']} rays drawn from the launch, scaled to it",
        "library_ms": None,
        "rays": first["bucket"],
        "host_ms": wrapper_host_ms,
        "kernel_only_ms": kernel_only_ms,
        "frame_ms": frame_ms,
        "frame_kernel_only_ms": frame_kernel_only_ms,
        "frame_bound_ms": frame_bound_ms,
        **{key: first[key] for key in ("group", "blocks_per_sm", "shared_bytes",
                                       "bound_share_alone") if key in first},
        "frame_compaction_ms": frame_compaction_ms,
        "per_launch": per_launch,
        "agree_fraction_min": agree,
        "tolerance": TOLERANCE[kernel],
        "build_s": build_s,
    }


def occupancy_entry(name: str, argtypes: list, packet: int | None = None):
    """The kernel's ``<name>_occupancy`` C entry: the blocks of its group-G
    kernel resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
    a TLAS kernel's in its build for ``packet`` (None: the default)."""
    import ctypes

    from tpu_render_cluster_torch.render import kernels

    entry = getattr(kernels._library(name, packet), f"{name}_occupancy")
    entry.argtypes = argtypes
    entry.restype = ctypes.c_int
    return entry


def bounce_occupancy(mesh, group: int, quant: int = 0, packet: int | None = None) -> dict:
    """Resident blocks per SM of ``mesh_bounce_tlas`` (its build for
    ``packet``) at group size ``group`` and node format ``quant`` on
    ``mesh``'s tables, and its dynamic shared memory (the staged bytes a
    block)."""
    import ctypes

    from tpu_render_cluster_torch.render import kernels

    triangles, bounds, _ = kernels._bvh_operands(mesh.bvh)
    shared = ctypes.c_int()
    query = occupancy_entry("mesh_bounce_tlas",
                            [ctypes.c_int] * 6 + [ctypes.c_void_p] + [ctypes.c_int], packet)
    blocks = query(group, mesh.instances.translation.shape[0], triangles.shape[0],
                   bounds.shape[0], kernels.tlas_frame(mesh).node_bounds.shape[0],
                   int(kernels.walks_ordered(mesh.bvh)), ctypes.addressof(shared), quant)
    check(blocks > 0, f"mesh_bounce_tlas_occupancy at G {group} failed ({blocks})")
    return {"blocks_per_sm": blocks, "shared_bytes": shared.value}


def pool_occupancy(ops, group: int, quant: int = 0, packet: int | None = None) -> dict:
    """Resident blocks per SM of ``pool_mesh_bounce_tlas`` (its build for
    ``packet``) at group size ``group`` and node format ``quant`` on the
    pool window ``ops``, its dynamic shared memory and the frames a block
    stages at most (-1: none, the BVH is not staged either)."""
    import ctypes

    from tpu_render_cluster_torch.render import kernels

    frames = len(ops.spheres.tables)
    triangles, bounds, _ = kernels._bvh_operands(ops.meshes[0].bvh)
    tlas_nodes = kernels.pool_tlas_operands(ops).links.shape[0] // frames
    shared, staged = ctypes.c_int(), ctypes.c_int()
    query = occupancy_entry("pool_mesh_bounce_tlas",
                            [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2 + [ctypes.c_int], packet)
    blocks = query(group, ops.spheres.per_frame, frames, ops.per_frame, triangles.shape[0],
                   bounds.shape[0], tlas_nodes, int(kernels.walks_ordered(ops.meshes[0].bvh)),
                   ctypes.addressof(shared), ctypes.addressof(staged), quant)
    check(blocks > 0, f"pool_mesh_bounce_tlas_occupancy at G {group} failed ({blocks})")
    return {"blocks_per_sm": blocks, "shared_bytes": shared.value, "staged_frames": staged.value}


def instance_occupancy(name: str, mesh, group: int) -> dict:
    """Resident blocks per SM of instance unit kernel ``name`` at group size
    ``group`` on ``mesh``'s tables, and its dynamic shared memory."""
    import ctypes

    from tpu_render_cluster_torch.render import kernels

    triangles, bounds, _ = kernels._bvh_operands(mesh.bvh)
    shared = ctypes.c_int()
    query = occupancy_entry(name, [ctypes.c_int] * 4 + [ctypes.c_void_p])
    blocks = query(group, mesh.instances.translation.shape[0], triangles.shape[0],
                   bounds.shape[0], ctypes.addressof(shared))
    check(blocks > 0, f"{name}_occupancy at G {group} failed ({blocks})")
    return {"blocks_per_sm": blocks, "shared_bytes": shared.value}


def instance_groups(name: str, launches: list, label: str) -> list[dict]:
    """Phase 5 for an instance unit kernel (rows 7, 8) at each of
    ``launches`` (one per bounce): the group size it takes (row 7: by its
    width; row 8: 0, each warp's pick for its batch) and the blocks resident
    per SM, printed beside the one-thread kernel's times (EARLIER, at
    262,144 rays). (The sweep over every G, kept in PERF.md from earlier
    runs, is left out to make room for phase 9.)"""
    from tpu_render_cluster_torch.render import kernels

    out = []
    for bounce, (args, _) in enumerate(launches):
        rays = args[1].shape[0]
        group = (kernels.OCCLUDED_GROUP if name == "occluded_instances"
                 else kernels.instance_group(rays, kernels.thread_slots(0)))
        occupancy = instance_occupancy(name, args[0], group)
        earlier = EARLIER[name][bounce] if rays == WIDTH * HEIGHT else None
        out.append({"bounce": bounce, "rays": rays, "group": group, **occupancy})
        print(
            f"[5] {name} {label} bounce {bounce} ({rays} rays): G {group}, "
            f"{occupancy['blocks_per_sm']} resident blocks per SM ({occupancy['shared_bytes']} "
            f"bytes of shared memory); the one-thread kernel (PERF.md) "
            f"{'n/a' if earlier is None else f'{earlier[0]} ms, alone {earlier[1]}'}"
        )
    return out


def bounce_groups(trace: Trace, launch, seed, alone, bound_ms: float) -> dict:
    """Phase 5 for a launch of the group-walk per-bounce kernel: the group
    size its width takes, the blocks resident per SM and its share of the
    bound, printed beside the earlier kernel's time (the sweep over every G,
    kept in PERF.md from earlier runs, is left out to make room for phase
    9)."""
    from tpu_render_cluster_torch.render import kernels

    kernel = trace.kernel
    group = kernels.bounce_group(launch.bucket, kernels.thread_slots(0))
    occupancy = bounce_occupancy(trace.mesh, group)
    alone_ms = None if alone is None else alone["kernel_ms"] / 5
    earlier_ms, earlier_alone_ms = EARLIER[kernel][launch.bounce]
    share = None if alone_ms is None else bound_ms / alone_ms
    print(
        f"[5] {kernel} bounce {launch.bounce} ({launch.bucket} lanes): G {group}, "
        f"{occupancy['blocks_per_sm']} resident blocks per SM ({occupancy['shared_bytes']} bytes "
        f"of shared memory), alone {alone_ms} ms, {share} of its bound; the one-thread kernel "
        f"(PERF.md) {earlier_ms} ms, alone {earlier_alone_ms}"
    )
    return {"group": group, **occupancy, "bound_share_alone": share}


def pool_record(run: dict, checked: dict, runs: dict, device, build_s: float) -> dict:
    """Phases 4-6 for a pool kernel after its main path: the path's first
    window again through the pool, each frame against the wavefront tier's
    image of the frame, and the PNGs against the megakernel's; the per-frame
    phases and frames/s beside the wavefront path's; the kernel at the three
    launches of phase 3 beside the whole iteration around it (the glue:
    sort, refill, scatter, the masked updates), each launch's bound from
    the plain version's counters; the card's idle share over one window."""
    from tpu_render_cluster_torch.render import compaction, raypool

    path, frames = run["path"], run["frames"]
    kernel = path.kernel
    mesh_variant = {} if kernel == "pool_sphere_bounce" else {"use_tlas": path.use_tlas}
    first_window = frames[:raypool.RAYPOOL_FRAMES]
    images, _ = raypool.render_batch_raypool(
        path.scene, first_window, width=WIDTH, height=HEIGHT, samples=SAMPLES,
        max_bounces=BOUNCES, device=device, **mesh_variant,
    )
    wavefront = compaction.render_frame_wavefront(
        path.scene, frames[0], width=WIDTH, height=HEIGHT, samples=SAMPLES,
        max_bounces=BOUNCES, device=device, **mesh_variant,
    )
    errs, bit_equal = [], []
    for frame, image in zip(first_window, images):
        if frame != frames[0]:
            wavefront = compaction.render_frame_wavefront(
                path.scene, frame, width=WIDTH, height=HEIGHT, samples=SAMPLES,
                max_bounces=BOUNCES, device=device, **mesh_variant,
            )
        errs.append((image - wavefront).abs().max().item())
        bit_equal.append((image == wavefront).all(dim=-1).float().mean().item())
        print(f"[4] {run['label']} frame {frame}, linear image vs the wavefront tier's: max abs err {errs[-1]:.3g}, {bit_equal[-1]:.6f} of pixels bit-equal")
        check(errs[-1] <= 1e-5, f"{run['label']}: frame {frame} differs from the wavefront's by {errs[-1]}")
    err = max(errs)
    if kernel != "pool_sphere_bounce":
        megakernel = "trace_fused_mesh_tlas" if kernel in TLAS_KERNELS else "trace_fused_mesh"
        trace = Trace(megakernel, path.scene, frames[0], device)
        reference = [to_image(trace.run(*frame_rays(path.scene, frames[0], device), BOUNCES))]
        against = "the mesh megakernel's render"
    else:
        reference = runs["trace_fused"]["images"]
        against = "the trace_fused path's"
    for index, (image, expected) in enumerate(zip(run["images"], reference)):
        within = within_one(image, expected)
        print(f"[4] {run['label']} frame {frames[index]} PNG vs {against}: {within:.6f} of uint8 values within 1")
        check(within >= 0.995, f"{run['label']}: PNG disagrees with {against} ({within})")
    phase_times(run, device, breakdown=False)
    other = runs[{"pool_mesh_bounce": "mesh_bounce", "pool_mesh_bounce_tlas": "mesh_bounce_tlas"}
                 .get(kernel, "sphere_bounce")]
    pool_fps = len(frames) / run["path_s"]
    wavefront_fps = len(other["frames"]) / other["path_s"]
    print(f"[5] {run['label']}: {pool_fps:.3f} frames/s over the job, the wavefront path ({other['label']}) {wavefront_fps:.3f} in this run")

    window, states, launches = checked["window"], checked["states"], checked["launches"]
    wrapper = pool_functions(kernel)[0]
    per_launch = {}
    for role in ("first", "mixed", "drain"):
        picked = checked["picked"][role]
        index = picked["index"]
        launch = launches[index]
        call = lambda launch=launch: wrapper(  # noqa: E731
            window.ops, *launch.state, launch.live, total_bounces=BOUNCES
        )
        cuda_ms(call, 2)
        launch_ms = statistics.median(cuda_ms(call, 5) for _ in range(5))
        step = lambda index=index: window.iteration(states[index], index)  # noqa: E731
        cuda_ms(step, 2)
        iteration_ms = statistics.median(cuda_ms(step, 5) for _ in range(5))
        alone = profiled(lambda: [call() for _ in range(20)], kernel, f"{kernel} {role} launch calls")
        least = bound(picked["stats"], window.pool * (POOL_RAY_BYTES + KEY_BYTES * window.tlas))
        per_launch[role] = {
            "iteration": index, "live": picked["live"], "ms": launch_ms,
            "kernel_only_ms": None if alone is None else alone["kernel_ms"] / 20,
            "iteration_ms": iteration_ms, "glue_ms": iteration_ms - launch_ms,
            "bound_ms": least["ms"], "bound_by": least["by"],
            "bound_flat_sweep_ms": least["flat_ms"], "bound_walk_ms": least["walk_ms"],
            "world_aabb_share": least["world_aabb_share"],
            "plain_ms": picked["plain_ms"],
        }
        print(
            f"[5] {kernel} {role} launch (iteration {index}, {picked['live']} of {window.pool} lanes "
            f"live): {launch_ms:.4f} ms per call; the whole iteration {iteration_ms:.4f} ms, so "
            f"{iteration_ms - launch_ms:.4f} ms of glue (sort, refill, scatter, masking); "
            f"{describe_bound(least)}; plain version {picked['plain_ms']:.3f} ms; work: {picked['stats']}"
        )
        if alone is not None:
            print(f"[6] {kernel} {role} launch, 20 calls under the profiler: the kernel alone {alone['kernel_ms'] / 20:.4f} ms per call")
    windows = run["windows"]
    iterations = sum(w.iterations for w in windows)
    print(f"[5] {kernel}: {iterations / len(frames):.2f} launches per frame ({iterations} over the path's {len(frames)} frames)")
    carried = frames_per_packet(kernel, checked) if kernel != "pool_sphere_bounce" else None
    if carried is not None:
        print(f"[5] {kernel}: frames per walked packet at the first window's checked launches "
              f"(the vote pass votes only their rows): {json.dumps(carried)}")
    window_profile = profiled(
        lambda: raypool.render_batch_raypool(
            path.scene, first_window, width=WIDTH, height=HEIGHT, samples=SAMPLES,
            max_bounces=BOUNCES, device=device, **mesh_variant,
        ),
        kernel, f"{run['label']} one window",
    )
    idle = window_alone_ms = None
    if window_profile is not None:
        idle = 1 - window_profile["device_ms"] / window_profile["wall_ms"]
        window_alone_ms = window_profile["kernel_ms"] / window_profile["seen"]
        print(
            f"[6] {run['label']}, one window of {len(first_window)} frames under the profiler: wall "
            f"{window_profile['wall_ms']:.3f} ms, device busy {window_profile['device_ms']:.3f} ms "
            f"({window_profile['kernels']} device operations; {kernel} {window_profile['kernel_ms']:.3f} "
            f"ms over {window_profile['seen']} launches, {window_alone_ms:.4f} ms per launch alone); "
            f"device idle {idle:.4f}"
        )
    mixed = per_launch["mixed"]
    groups = {}
    if kernel in GROUP_KERNELS:
        from tpu_render_cluster_torch.render import kernels

        occupancy = pool_occupancy(window.ops, kernels.POOL_GROUP)
        earlier_ms, earlier_alone_ms = EARLIER[kernel]["mixed"]
        alone = window_alone_ms if window_alone_ms is not None else mixed["kernel_only_ms"]
        share = None if alone is None else mixed["bound_ms"] / alone
        frame_ms = None if window_alone_ms is None else window_alone_ms * iterations / len(frames)
        groups = {"group": kernels.POOL_GROUP, **occupancy, "bound_share_alone": share,
                  "frame_kernel_only_ms": frame_ms}
        print(
            f"[5] {kernel}: G {kernels.POOL_GROUP}, {occupancy['blocks_per_sm']} resident blocks "
            f"per SM ({occupancy['shared_bytes']} bytes of shared memory, up to "
            f"{occupancy['staged_frames']} frames staged a block); mixed launch {mixed['ms']:.4f} "
            f"ms, window mean alone {window_alone_ms} ms, {share} of its bound, {frame_ms} ms a "
            f"frame alone; the one-thread kernel (PERF.md) {earlier_ms} ms, window mean alone "
            f"{earlier_alone_ms}"
        )
    return {
        **groups,
        "name": kernel,
        "route": "cuda",
        "source": f"tpu_render_cluster_torch/render/csrc/{kernel}.cu",
        "replaces": REPLACES[kernel],
        "launches": run["launches"],
        "max_abs_err": checked["max_abs_err"],
        "ms": mixed["ms"],
        "plain_ms": mixed["plain_ms"],
        "bound_ms": mixed["bound_ms"],
        "bound_by": mixed["bound_by"],
        "library_ms": None,
        "bound_flat_sweep_ms": mixed["bound_flat_sweep_ms"],
        "bound_walk_ms": mixed["bound_walk_ms"],
        "world_aabb_share": mixed["world_aabb_share"],
        "rays": window.pool,
        "kernel_only_ms": mixed["kernel_only_ms"],
        "window_kernel_only_ms": window_alone_ms,
        "glue_ms": mixed["glue_ms"],
        "per_launch": per_launch,
        "launches_per_frame": iterations / len(frames),
        "frames_per_s": pool_fps,
        "wavefront_frames_per_s": wavefront_fps,
        "window_idle_share": idle,
        "host_reads_per_window": [w.host_reads for w in windows],
        "frames_per_packet": carried,
        "window_vs_wavefront_max_abs_err": err,
        "window_bit_equal_share_min": min(bit_equal),
        "checked_launches": checked["checked_launches"],
        "agree_fraction_min": checked["agree"],
        "tolerance": TOLERANCE[kernel],
        "build_s": build_s,
    }


def frames_per_packet(kernel: str, checked: dict) -> dict:
    """Per checked launch of a mesh pool kernel's first window (first, each
    frame boundary, the mixed launch, the drain), the mean and the most
    frames that a walked packet's lanes carry: the frames whose rows its
    vote pass votes."""
    from tpu_render_cluster_torch.render import kernels

    window = checked["window"]
    block = kernels.TLAS_BLOCK_R if kernel in TLAS_KERNELS else kernels.BVH_BLOCK_R
    counts = {}
    for role, picked in checked["picked"].items():
        launch = checked["launches"][picked["index"]]
        carried = kernels.carried_frames(launch.state[5], block, len(window.frames)).sum(dim=1)
        walked = carried[: -(-int(launch.live) // block)].float()
        counts[role] = {"mean": walked.mean().item(), "max": int(walked.max())}
    return counts


@contextlib.contextmanager
def unit_wrappers(replace):
    """Each unit-kernel wrapper of ``kernels`` replaced by ``replace(name,
    wrapper)`` while the block runs. The scan tier's callers
    (``render/integrator.py``, ``render/geometry.py``, ``render/mesh.py``)
    look the wrappers up on the module at every call."""
    from tpu_render_cluster_torch.render import kernels

    saved = {name: getattr(kernels, name) for name in UNIT_KERNELS}
    try:
        for name, wrapper in saved.items():
            setattr(kernels, name, replace(name, wrapper))
        yield
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)


def recording(log: list, keep: int | None = None):
    """The wrappers, each launch also logged as (name, arguments, outputs);
    with ``keep``, only the first ``keep`` launches of each kernel."""

    def replace(name, wrapper):
        def record(*args):
            out = wrapper(*args)
            if keep is None or sum(entry[0] == name for entry in log) < keep:
                log.append((name, args, out))
            return out

        return record

    return unit_wrappers(replace)


def plain_versions():
    """The scan tier with its four geometry queries through the unit
    kernels' plain versions, on the card."""
    from tpu_render_cluster_torch.render import kernels

    return unit_wrappers(lambda name, _wrapper: getattr(kernels, f"{name}_reference"))


def unit_agreement(name: str, args: tuple, got, stats: dict | None = None) -> dict:
    """One unit-kernel launch ``name(*args) -> got`` against its plain
    version on the same inputs (on the card, counting the work into
    ``stats``): the rays outside the tolerance (``TOLERANCE[name]``) and the
    budget they may use, the bit-equal share, the max abs error (of t; of
    the 0/1 any-hit) and the plain version's ms."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    out: list = []
    plain_ms = cuda_ms(
        lambda: out.append(getattr(kernels, f"{name}_reference")(*args, stats=stats)), 1
    )
    expected = out[0]
    rays = args[1].shape[0]
    if name.startswith("intersect"):
        t_close = torch.isclose(got[0], expected[0], **(
            {"rtol": 2e-5, "atol": 2e-4} if name == "intersect_spheres" else {"rtol": 1e-4, "atol": 1e-4}
        ))
        seed = 1e29 if name == "intersect_spheres" else args[3]
        hit = expected[0] < seed
        ids_differ = hit & torch.stack([a != b for a, b in zip(got[1:], expected[1:])]).any(dim=0)
        equal = torch.stack([a == b for a, b in zip(got, expected)]).all(dim=0)
        err = (got[0] - expected[0]).abs().max().item()
        bad, budget = int((~t_close | ids_differ).sum()), 0
        if name == "intersect_mesh":  # t on every ray, the row but exact ties
            bad, budget = int(ids_differ.sum()), max(1, round(0.001 * rays))
            check(bool(t_close.all()), f"{name}: t outside 1e-4 on {int((~t_close).sum())} rays")
    else:
        equal = got == expected
        err = float(not bool(equal.all()))
        bad = int((~equal).sum())
        budget = max(1, round(0.001 * rays)) if name == "occluded_mesh" else 0
    if name in INSTANCE_UNITS:  # every output bit-equal on every lane
        bad, budget = int((~equal).sum()), 0
    return {
        "rays": rays, "bad": bad, "budget": budget, "bit_equal": equal.float().mean().item(),
        "err": err, "plain_ms": plain_ms,
    }


def unit_bound(name: str, stats: dict, rays: int) -> dict:
    """The least time of one unit-kernel launch's work, as counted by its
    plain version: every real sphere tested per ray (nearest hit), the
    sphere tests up to each ray's first occluder (any-hit), or the mesh
    walk's counters (an instance search counted as a two-level walk; one
    BVH: its node and triangle tests). The any-hits over the instances or
    one BVH read a lane's origin and direction only where it walks
    (``already`` unset); any other lane reads and writes its one byte."""
    bytes_moved = rays * UNIT_RAY_BYTES[name]
    if name == "intersect_spheres":
        operations = OPS_NEAREST_SPHERE * stats["spheres"] * stats["rays"]
    elif name == "occluded_spheres":
        operations = OPS_ANY_HIT_SPHERE * stats["sphere_tests"]
    else:
        operations = 0.0
    if name == "occluded_instances":
        bytes_moved += 24 * stats["broadphase_rays"]
    elif name == "occluded_mesh":
        bytes_moved += 24 * stats["walking_rays"]
    return bound(stats, bytes_moved, sphere_operations=operations)


def scan_kernels_vs_plain(path: MainPath, device) -> dict:
    """Phase 3 for a scan path's unit kernels: frame 1 of its job through the
    scan tier at CHECK_SIDE x CHECK_SIDE x CHECK_SAMPLES spp, every launch
    of each unit kernel again through its plain version on the launch's own
    inputs (the per-instance scan's single-BVH kernels: every launch of the
    first sample, BOUNCES x DEEP_INSTANCES each). Returns per kernel the
    launches checked, the lowest agreeing share and the max abs error."""
    import torch

    from tpu_render_cluster_torch.render import integrator

    _, frames = job_frames(path)
    log: list = []
    keep = BOUNCES * DEEP_INSTANCES if path.per_instance else None
    with recording(log, keep=keep):
        integrator.render_frame(
            path.scene, frames[0], width=CHECK_SIDE, height=CHECK_SIDE, samples=CHECK_SAMPLES,
            max_bounces=BOUNCES, device=device, bounce_scan=True, per_instance=path.per_instance,
        )
    torch.cuda.synchronize()
    results: dict[str, list] = {name: [] for name in path.launched}
    for name, args, got in log:
        result = unit_agreement(name, args, got)
        check(result["bad"] <= result["budget"],
              f"{name} on {path.scene}: {result['bad']} rays outside the tolerance, budget {result['budget']}")
        results[name].append(result)
    summary = {}
    for name, checked in results.items():
        launches = CHECK_SAMPLES * BOUNCES * path.launches_per_step(name)
        check(len(checked) == min(launches, keep or launches), f"{name}: {len(checked)} launches in the scan")
        summary[name] = {
            "launches": len(checked),
            "agree": min(1 - r["bad"] / r["rays"] for r in checked),
            "max_abs_err": max(r["err"] for r in checked),
        }
        print(
            f"[3] {name} vs plain, {path.scene} frame {frames[0]} through the bounce scan at "
            f"{CHECK_SIDE}x{CHECK_SIDE}x{CHECK_SAMPLES} spp: "
            f"{'every launch' if len(checked) == launches else 'every launch of sample 0'} ({len(checked)}, "
            f"{checked[0]['rays']} rays each); worst {max(r['bad'] for r in checked)} rays outside "
            f"the tolerance (budget {checked[0]['budget']}), lowest bit-equal share "
            f"{min(r['bit_equal'] for r in checked):.6f}, max abs err {summary[name]['max_abs_err']:.3g}"
        )
    return summary


def scan_breakdown(run: dict, device) -> dict[str, float]:
    """Phase 5's split of one frame of a scan path, each step fenced by a
    synchronize: scene+camera (and instances), the samples' jittered rays,
    their traces (``trace_paths_scan``: the unit kernels and the eager glue
    around them), mean+tonemap+copy, png. Returns each step's median ms."""
    import torch

    from tpu_render_cluster_torch.render import integrator, rng
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.image_io import write_image
    from tpu_render_cluster_torch.render.mesh import scene_mesh_set
    from tpu_render_cluster_torch.render.scene import build_scene

    scene_name = run["path"].scene
    steps: dict[str, list[float]] = {
        "scene+camera": [], "rays": [], "trace": [], "mean+tonemap+copy": [], "png": []
    }
    with tempfile.TemporaryDirectory(prefix="chip-smoke-png-") as scratch:
        for frame in run["frames"][:3]:
            marks = [time.perf_counter()]
            scene = build_scene(scene_name, frame, device)
            camera = scene_camera(scene_name, frame, device)
            mesh = scene_mesh_set(scene_name, frame, device=device)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            keys = rng.fold_in(integrator.tile_base_key(frame, 0, 0), torch.arange(SAMPLES)).to(device)
            rays = [
                integrator.sample_jitter_rays(
                    camera, keys[s], width=WIDTH, height=HEIGHT, y0=0, x0=0,
                    tile_height=HEIGHT, tile_width=WIDTH,
                )
                for s in range(SAMPLES)
            ]
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            total = sum(
                integrator.trace_paths_scan(
                    scene, *rays[s], rng.split(keys[s])[1], max_bounces=BOUNCES, mesh=mesh,
                    per_instance=run["path"].per_instance,
                )
                for s in range(SAMPLES)
            )
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            pixels = integrator.tonemap((total / SAMPLES).reshape(HEIGHT, WIDTH, 3)).cpu().numpy()
            marks.append(time.perf_counter())
            write_image(Path(scratch) / f"f{frame}.png", pixels, "PNG")
            marks.append(time.perf_counter())
            for key, a, b in zip(steps, marks, marks[1:]):
                steps[key].append((b - a) * 1e3)
    medians = {k: statistics.median(v) for k, v in steps.items()}
    print(
        f"[5] {run['label']} one frame, median ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in medians.items())
    )
    return medians


def scan_record(run: dict, runs: dict, device) -> dict[str, dict]:
    """Phases 4-6 for a scan path after its run: frame 1 against the scan
    tier's plain render on the card; the per-frame phases, a frame's split
    and frames/s beside the megakernel and wavefront paths of this run;
    each unit kernel at the launches of frame 1's first sample on the main
    path's shapes (262,144 rays): its ms per launch at each bounce (CUDA
    events), the host time of a call, its time alone (profiler), its bound
    from the plain version's counters on the bounce-0 launch and that plain
    version's ms. Returns those numbers per kernel."""
    import torch

    from tpu_render_cluster_torch.render import integrator, kernels

    path, frames = run["path"], run["frames"]

    def render(side: int = WIDTH, samples: int = SAMPLES):
        return integrator.render_frame(
            path.scene, frames[0], width=side, height=side, samples=samples,
            max_bounces=BOUNCES, device=device, bounce_scan=True,
        )

    # The deep scan's plain render at PLAIN_SCAN_SIDE and PLAIN_SCAN_SAMPLES,
    # against the kernels' render of the same frame; the sphere scan's at
    # the main path's size, against its PNG.
    size = (PLAIN_SCAN_SIDE, PLAIN_SCAN_SAMPLES) if path.scene.endswith("-mesh") else (WIDTH, SAMPLES)
    out: list = []
    with plain_versions():
        plain_frame_ms = cuda_ms(lambda: out.append(render(*size)), 1)
    plain_image = integrator.tonemap(out[0]).cpu()
    image = run["images"][0] if size == (WIDTH, SAMPLES) else integrator.tonemap(render(*size)).cpu()
    within = within_one(image, plain_image)
    print(
        f"[4] {run['label']} frame {frames[0]}"
        f"{': PNG' if size == (WIDTH, SAMPLES) else f' at {size[0]}x{size[0]}, {size[1]} spp: the kernels render'} "
        f"vs the scan tier's render with the plain versions on the card ({plain_frame_ms:.1f} ms): "
        f"{within:.6f} of uint8 values within 1, "
        f"{(image == plain_image).float().mean().item():.6f} bit-equal"
    )
    check(within >= 0.995, f"{run['label']}: frame disagrees with the plain scan render ({within})")
    other = runs["trace_fused" if path.scene == "04_very-simple" else "mesh_bounce_tlas"]
    mean_diff = (run["images"][0].float() - other["images"][0].float()).abs().mean().item()
    print(
        f"[4] {run['label']} frame {frames[0]} vs the {other['label']} path's PNG (other random "
        f"numbers: threefry against the kernels' PCG; reported, not checked): mean |uint8 "
        f"difference| {mean_diff:.3f}"
    )
    phase_times(run, device, breakdown=False)
    scan_breakdown(run, device)
    scan_fps = len(frames) / run["path_s"]
    compared = ", ".join(
        f"{runs[key]['label']} {len(runs[key]['frames']) / runs[key]['path_s']:.3f}"
        for key in (("trace_fused", "sphere_bounce") if path.scene == "04_very-simple"
                    else ("mesh_bounce_tlas", "pool_mesh_bounce_tlas"))
    )
    print(f"[5] {run['label']}: {scan_fps:.3f} frames/s over the job; in this run {compared}")

    log: list = []
    with recording(log, keep=BOUNCES):
        render()
    torch.cuda.synchronize()
    record = {}
    for name in path.launched:
        launches = [(args, got) for entry, args, got in log if entry == name]
        wrapper = getattr(kernels, name)
        per_bounce = []
        for bounce, (args, _) in enumerate(launches):
            call = lambda args=args: wrapper(*args)  # noqa: E731
            cuda_ms(call, 3)
            per_bounce.append(statistics.median(cuda_ms(call, 20) for _ in range(10 if bounce == 0 else 3)))
        # The kernel alone at each bounce: windows of 5 calls seen whole.
        per_bounce_alone = [
            alone_ms(lambda args=args: wrapper(*args), name, f"{name} bounce {b} ({path.scene})")
            for b, (args, _) in enumerate(launches)
        ]
        args, got = launches[0]
        stats: dict = {}
        result = unit_agreement(name, args, got, stats=stats)
        check(result["bad"] <= result["budget"], f"{name} bounce 0 at full size: {result['bad']} rays")
        call = lambda args=args: wrapper(*args)  # noqa: E731
        wrapper_host_ms = host_ms(call, 20)
        least = unit_bound(name, stats, result["rays"])
        kernel_only_ms = per_bounce_alone[0]
        # The mean alone over every launch of the two profiled frames.
        frame_profile = run["frame_profile"]
        frames_alone_ms = (
            None if frame_profile is None
            else frame_profile["per_kernel"][name] / (2 * SAMPLES * BOUNCES)
        )
        print(
            f"[5] {name} on {path.scene} frame {frames[0]}, sample 0, {result['rays']} rays per "
            f"launch: {', '.join(f'bounce {b} {ms:.4f}' for b, ms in enumerate(per_bounce))} ms per "
            f"launch (CUDA events; bounce 0 the median of 10 batches of 20); host "
            f"{wrapper_host_ms:.4f} ms per call; alone "
            + ", ".join(f"bounce {b} {'not measured' if ms is None else f'{ms:.4f}'}"
                        for b, ms in enumerate(per_bounce_alone))
            + f" ms (the mean over the two profiled frames' launches "
            f"{'not measured' if frames_alone_ms is None else f'{frames_alone_ms:.4f} ms'}); plain "
            f"version {result['plain_ms']:.3f} ms; {describe_bound(least)}; work: {stats}"
        )
        record[name] = {
            "path": run["label"], "scene": path.scene, "rays": result["rays"],
            "launches": run["launches"][name],
            "launches_per_frame": run["launches"][name] / len(run["frames"]),
            "ms": per_bounce[0], "per_bounce_ms": per_bounce, "host_ms": wrapper_host_ms,
            "kernel_only_ms": kernel_only_ms, "per_bounce_kernel_only_ms": per_bounce_alone,
            "frames_kernel_only_ms": frames_alone_ms,
            "plain_ms": result["plain_ms"],
            "bound_ms": least["ms"], "bound_by": least["by"],
            "bound_flat_sweep_ms": least["flat_ms"], "world_aabb_share": least["world_aabb_share"],
            "max_abs_err": result["err"], "frames_per_s": scan_fps,
        }
        if name in INSTANCE_UNITS:
            record[name]["groups"] = instance_groups(name, launches, f"{WIDTH}x{HEIGHT}")
            if kernel_only_ms is not None:
                record[name]["bound_share_alone"] = least["ms"] / kernel_only_ms
    kernel_frame_ms = SAMPLES * sum(statistics.mean(r["per_bounce_ms"]) for r in record.values())
    print(
        f"[5] {run['label']}: the unit kernels take about {kernel_frame_ms:.3f} ms of a frame "
        f"({SAMPLES} samples x the launches of sample 0); the rest of the trace is the eager glue"
    )
    return record


def per_instance_record(run: dict, runs: dict, device) -> dict[str, dict]:
    """Phases 4-6 for the per-instance scan path after its run: frame 1
    against the instanced scan's frame 1 (rows 7 and 8) of this run; the
    per-frame phases, a frame's split and frames/s beside the instanced
    scan's; rows 9 and 10 at the DEEP_INSTANCES launches of bounce 0 of
    frame 1's first sample (262,144 rays each): ms per call (CUDA events,
    the mean over those launches), host ms per call, alone (profiler), and
    the bound and the plain version's ms of instance 0's launch (alone:
    windows of 6 calls, each profiled up to six times, the mean over the
    launches of the windows seen whole); the card's
    idle share over one 128x128 frame at 2 spp under the profiler (a
    512x512 frame runs about 140,000 device operations). The path's frames
    are not rendered with the plain versions: the plain walks take seconds
    per launch."""
    import torch

    from tpu_render_cluster_torch.render import integrator, kernels

    path, frames = run["path"], run["frames"]
    instanced = runs[INSTANCED_SCAN]
    image, other = run["images"][0], instanced["images"][0]
    within = within_one(image, other)
    print(
        f"[4] {run['label']} frame {frames[0]} PNG vs the {instanced['label']} path's (rows 7 "
        f"and 8), this run: {within:.6f} of uint8 values within 1, "
        f"{(image == other).float().mean().item():.6f} bit-equal"
    )
    check(within >= 0.995, f"{run['label']}: frame disagrees with the instanced scan's ({within})")
    phase_times(run, device, breakdown=False)
    split = scan_breakdown(run, device)
    fps = len(frames) / run["path_s"]
    instanced_fps = len(instanced["frames"]) / instanced["path_s"]
    print(f"[5] {run['label']}: {fps:.3f} frames/s over the job; in this run {instanced['label']} {instanced_fps:.3f}")

    def render(side: int = WIDTH, samples: int = SAMPLES):
        return integrator.render_frame(
            path.scene, frames[0], width=side, height=side, samples=samples,
            max_bounces=BOUNCES, device=device, bounce_scan=True, per_instance=True,
        )

    small = profiled(
        lambda: render(128, 2), path.launched, f"{run['label']} one 128x128 frame at 2 spp"
    )
    if small is not None:
        own = ", ".join(f"{k} {v:.3f}" for k, v in small["per_kernel"].items())
        print(
            f"[6] {run['label']}, one 128x128 frame at 2 spp under the profiler (a 512x512 "
            f"frame at {SAMPLES} spp runs about 140,000 device operations, too many to "
            f"profile here): wall {small['wall_ms']:.3f} ms, device busy {small['device_ms']:.3f} "
            f"ms ({small['kernels']} device operations; {own} ms); device idle "
            f"{1 - small['device_ms'] / small['wall_ms']:.4f}"
        )
    log: list = []
    with recording(log, keep=DEEP_INSTANCES):  # bounce 0 of sample 0
        render()
    torch.cuda.synchronize()
    record = {}
    for name in BVH_UNITS:
        launches = [(args, got) for entry, args, got in log if entry == name]
        check(len(launches) == DEEP_INSTANCES, f"{name}: {len(launches)} launches at bounce 0")
        wrapper = getattr(kernels, name)
        calls = lambda wrapper=wrapper, launches=launches: [wrapper(*a) for a, _ in launches]  # noqa: E731
        cuda_ms(calls, 1)
        ms = statistics.median(cuda_ms(calls, 3) for _ in range(5)) / DEEP_INSTANCES
        call_host_ms = host_ms(calls, 3) / DEEP_INSTANCES
        args, got = launches[0]
        stats: dict = {}
        result = unit_agreement(name, args, got, stats=stats)
        check(result["bad"] <= result["budget"], f"{name} at full size: {result['bad']} rays")
        least = unit_bound(name, stats, result["rays"])
        # Windows of 6 of the 48 calls, each profiled up to six times, as
        # phase 6's windows (one window of all 48 missed launches); the mean
        # over the launches of the windows seen whole.
        windows = [launches[i:i + 6] for i in range(0, DEEP_INSTANCES, 6)]
        profiles = [
            profiled(lambda window=window: [wrapper(*a) for a, _ in window], name,
                     f"{name}, bounce-0 calls {6 * i}-{6 * i + len(window) - 1}", tries=6)
            for i, window in enumerate(windows)
        ]
        seen = [p for p in profiles if p is not None]
        kernel_only_ms = (sum(p["kernel_ms"] for p in seen) / sum(p["launched"] for p in seen)
                          if seen else None)
        print(f"[6] {name}: {len(seen)} of {len(windows)} windows of the bounce-0 calls seen "
              f"whole ({sum(p['launched'] for p in seen)} of {DEEP_INSTANCES} launches)")
        frame_alone_ms = (
            None if small is None
            else small["per_kernel"][name] / (2 * BOUNCES * DEEP_INSTANCES)
        )
        print(
            f"[5] {name} on {path.scene} frame {frames[0]}, sample 0, bounce 0, {result['rays']} "
            f"rays per launch: {ms:.4f} ms per launch (CUDA events, the mean over the "
            f"{DEEP_INSTANCES} launches, median of 5 batches); host {call_host_ms:.4f} ms per "
            f"call; alone {'not measured' if kernel_only_ms is None else f'{kernel_only_ms:.4f} ms'} "
            f"(the mean over the 128x128 frame's launches "
            f"{'not measured' if frame_alone_ms is None else f'{frame_alone_ms:.4f} ms'}); plain "
            f"version {result['plain_ms']:.3f} ms (instance 0); {describe_bound(least)}; work "
            f"(instance 0): {stats}"
        )
        record[name] = {
            "path": run["label"], "scene": path.scene, "rays": result["rays"],
            "launches": run["launches"][name],
            "launches_per_frame": run["launches"][name] / len(frames),
            "ms": ms, "per_bounce_ms": [ms], "host_ms": call_host_ms,
            "kernel_only_ms": kernel_only_ms, "frames_kernel_only_ms": frame_alone_ms,
            "plain_ms": result["plain_ms"],
            "bound_ms": least["ms"], "bound_by": least["by"],
            "bound_flat_sweep_ms": least["flat_ms"], "world_aabb_share": least["world_aabb_share"],
            "max_abs_err": result["err"], "frames_per_s": fps,
        }
    # Per launch: the kernel alone where the profiler saw it, else the call.
    alone = all(r["kernel_only_ms"] is not None for r in record.values())
    per_launch = sum(r["kernel_only_ms"] if alone else r["ms"] for r in record.values())
    kernel_ms = SAMPLES * BOUNCES * DEEP_INSTANCES * per_launch
    print(
        f"[5] {run['label']}: rows 9 and 10 take about {kernel_ms:.3f} ms of a frame's "
        f"{split['trace']:.3f} ms trace ({SAMPLES * BOUNCES * DEEP_INSTANCES} launches of each at "
        f"bounce 0's mean {'alone' if alone else 'per call'}); the glue (object-space "
        f"transforms, gathers, selects) about {1 - kernel_ms / split['trace']:.3f} of it"
    )
    return record


def unit_entry(name: str, records: dict, runs: dict, checks: dict, build_s: float) -> dict:
    """The kernels line's entry of a unit kernel: its numbers on the scan
    path of UNIT_SCENE[name] that times it (rows 11 and 12 on
    04_very-simple's 64 spheres, the deep scan's beside them), its launches
    summed over every scan path."""
    timed = {key: numbers[name] for key, numbers in records.items() if name in numbers}
    main = next(r for r in timed.values() if r["scene"] == UNIT_SCENE[name])
    checked = [c[name] for c in checks.values() if name in c]
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"tpu_render_cluster_torch/render/csrc/{name}.cu",
        "replaces": REPLACES[name],
        "launches": sum(
            run["launches"].get(name, 0) for run in runs.values() if run["path"].bounce_scan
        ),
        "launches_per_frame": main["launches_per_frame"],
        "max_abs_err": max([r["max_abs_err"] for r in timed.values()] + [c["max_abs_err"] for c in checked]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        **{key: main[key] for key in (
            "scene", "rays", "per_bounce_ms", "host_ms", "kernel_only_ms", "frames_kernel_only_ms",
            "bound_flat_sweep_ms", "world_aabb_share", "per_bounce_kernel_only_ms",
            "bound_share_alone", "groups",
        ) if key in main},
        "by_path": {
            r["path"]: {k: r[k] for k in (
                "launches", "launches_per_frame", "ms", "kernel_only_ms", "frames_kernel_only_ms", "plain_ms", "bound_ms",
                "frames_per_s",
            )}
            for r in timed.values()
        },
        "agree_fraction_min": min(c["agree"] for c in checked),
        "tolerance": TOLERANCE[name],
        "build_s": build_s,
    }
    return entry


# -- the tile paths (tiled work units (frame, tile) through the backend) -------

TILE_GRID = (2, 2)
# The lane kernel reads a 4-byte lane row more than the positional one.
LANE_RAY_BYTES = MEGAKERNEL_RAY_BYTES + 4


class TilePath(NamedTuple):
    kernel: str  # the kernel the path launches
    job_file: str
    scene: str
    frames: int
    hint: bool  # the worker queue's hint before each unit (the pool)
    whole: str  # the whole-frame main path the stitched frames are held against


TILE_PATHS = [
    TilePath("trace_fused_lanes", SPHERE_JOB, "04_very-simple", 2, False, "trace_fused"),
    TilePath("mesh_bounce_tlas", DEEP_JOB, "03_physics-2-mesh", 2, False, "mesh_bounce_tlas"),
    TilePath("pool_mesh_bounce_tlas", DEEP_JOB, "03_physics-2-mesh", 4, True, "mesh_bounce_tlas"),
    TilePath("mesh_bounce_tlas", MESH_JOB, "02_physics-mesh", 2, False, "trace_fused_mesh_tlas"),
]


def tile_regions() -> list[tuple[int, int, int, int]]:
    from tpu_render_cluster_torch.jobs.tiles import tile_bounds

    return [
        tile_bounds(tile, TILE_GRID, width=WIDTH, height=HEIGHT)
        for tile in range(TILE_GRID[0] * TILE_GRID[1])
    ]


def stitch(tiles_of_frame) -> "torch.Tensor":
    """[H, W, C] from a frame's tile images, in tile order."""
    import torch

    first = tiles_of_frame[0]
    out = torch.zeros((HEIGHT, WIDTH, first.shape[-1]), dtype=first.dtype, device=first.device)
    for (y0, x0, th, tw), image in zip(tile_regions(), tiles_of_frame):
        out[y0:y0 + th, x0:x0 + tw] = image
    return out


def lane_kernel_vs_plain(device) -> float:
    """Phase 3 for the lane kernel: frame 7 of 04_very-simple at
    CHECK_SIDE x CHECK_SIDE x CHECK_SAMPLES spp, the rays and whole-frame
    lanes of one interior tile (tile 3 of the 2x2 grid: its lanes do not
    start at 0), at 1 and 4 bounces: bit for bit against its plain version,
    and, with lanes 0..R-1, bit for bit against the positional kernel.
    Returns the max abs error."""
    import torch

    from tpu_render_cluster_torch.jobs.tiles import tile_bounds
    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import region_rays_and_seed
    from tpu_render_cluster_torch.render.scene import build_scene

    scene = build_scene("04_very-simple", 7, device)
    y0, x0, th, tw = tile_bounds(3, TILE_GRID, width=CHECK_SIDE, height=CHECK_SIDE)
    origins, directions, lanes, seed = region_rays_and_seed(
        scene_camera("04_very-simple", 7, device), 7, width=CHECK_SIDE, height=CHECK_SIDE,
        samples=CHECK_SAMPLES, y0=y0, x0=x0, tile_height=th, tile_width=tw,
    )
    check(int(lanes.min()) > 0, "the checked tile's lanes start at 0")
    arange = torch.arange(origins.shape[0], dtype=torch.int32, device=device)
    max_err = 0.0
    for max_bounces in (1, 4):
        got = kernels.trace_paths_fused(
            scene, origins, directions, seed, max_bounces=max_bounces, lane=lanes
        )
        expected = kernels.trace_paths_fused_reference(
            scene, origins, directions, seed, max_bounces=max_bounces, lane=lanes
        )
        positional = kernels.trace_paths_fused(
            scene, origins, directions, seed, max_bounces=max_bounces
        )
        on_arange = kernels.trace_paths_fused(
            scene, origins, directions, seed, max_bounces=max_bounces, lane=arange
        )
        torch.cuda.synchronize()
        err = (got - expected).abs().max().item()
        differ = int((got != expected).any(dim=1).sum())
        arange_differ = int((on_arange != positional).any(dim=1).sum())
        print(
            f"[3] trace_fused_lanes vs plain, 04_very-simple tile 3 of {CHECK_SIDE}x{CHECK_SIDE}x"
            f"{CHECK_SAMPLES} spp (lanes {int(lanes.min())}..{int(lanes.max())}), {max_bounces} "
            f"bounce(s): {differ} of {got.shape[0]} rays differ, max abs err {err:.3g}; with lanes "
            f"0..R-1 vs trace_fused: {arange_differ} rays differ"
        )
        check(torch.isfinite(got).all().item() and got.max().item() > 0.1, "lane kernel: bad radiance")
        check(differ == 0, f"trace_fused_lanes: {differ} rays differ from the plain version")
        check(arange_differ == 0, f"trace_fused_lanes on lanes 0..R-1: {arange_differ} rays differ")
        max_err = max(max_err, err)
    return max_err


def drive_tile_path(path: TilePath, runs: dict, device) -> dict:
    """Phase 4 for a tile path: ``path.frames`` frames of the job with a
    2x2 tile grid, every (frame, tile) unit through the backend in the
    worker queue's order (frame-major, tile-minor), the counts zeroed just
    before and read just after: the path's kernel alone, once per tile (the
    lane kernel), per wavefront bounce or per pool iteration, no plain
    version. The tile PNGs are stitched as the master's assembler stitches
    them and held against the whole-frame main path's PNGs of the same
    frames."""
    import numpy as np
    import torch
    from PIL import Image

    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.jobs.tiles import WorkUnit
    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.image_io import output_path_for_tile
    from tpu_render_cluster_torch.utils.paths import parse_with_base_directory_prefix
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    whole_job, frames = job_frames(MainPath(path.kernel, path.job_file, path.scene, path.frames, None))
    job = BlenderJob.from_dict({**whole_job.to_dict(), "tiles": list(TILE_GRID)})
    label = f"{path.scene} tiles {TILE_GRID[0]}x{TILE_GRID[1]} ({'ray pool' if path.hint else path.kernel})"
    units = [WorkUnit(frame, tile) for frame in frames for tile in range(len(tile_regions()))]
    log: list = []
    pool_log: list = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tiles-") as base:
        backend = TorchRaytraceBackend(
            width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES, base_directory=base,
            on_launch=lambda launch: log.append(tuple(launch[:3])),
            on_iteration=lambda launch: pool_log.append(launch.iteration),
        )
        # Warm: one tile of frame 1 through the tier, outside the counts.
        warm = BlenderJob.from_dict({**job.to_dict(), "output_directory_path": f"{base}/warm"})
        if path.hint:
            backend.note_upcoming_frames(warm, (WorkUnit(frames[1], 0),))
        asyncio.run(backend.render_frame(warm, frames[0], 0))
        backend.note_upcoming_frames(warm, ())
        backend._raypool_cache.clear()
        torch.cuda.synchronize()
        kernels.reset_counts()
        log.clear()
        pool_log.clear()
        backend.pool_stats.clear()
        timings = []
        started = time.perf_counter()
        for index, unit in enumerate(units):
            if path.hint:  # the worker queue's hint: the units queued behind this one
                backend.note_upcoming_frames(job, tuple(units[index + 1:]))
            timings.append(asyncio.run(backend.render_frame(job, unit.frame_index, unit.tile)))
        path_s = time.perf_counter() - started
        launches = dict(kernels.counts)
        windows = list(backend.pool_stats)
        print(f"[4] tile path: {len(units)} units of {job.job_name} in {path_s:.4f} s; counts {launches}")
        if path.hint:  # one launch per pool iteration
            expected = len(pool_log)
        elif log:  # one per wavefront bounce
            expected = len(log)
        elif path.kernel == "trace_fused_lanes":  # one per tile
            expected = len(units)
        else:  # the masked region loop: one per tile and bounce
            expected = len(units) * BOUNCES
        check(path.hint or expected >= len(units), f"{label}: {expected} launches for {len(units)} units")
        launched = kernels.launch_names(path.kernel)
        for name, count in launches.items():
            want = expected if name in launched else 0
            check(count == want, f"{label}: {name} ran {count} times, not {want}")
        if path.kernel == "trace_fused_lanes":
            check(not log and not pool_log, f"{label}: a wavefront or pool launch")
        if path.hint:
            served = sum(w.served for w in windows)
            print(
                f"[4] {label}: {len(windows)} pool windows (one per tile), iterations "
                f"{[w.iterations for w in windows]}, served {served}"
            )
            check(len(windows) == len(tile_regions()), f"{label}: {len(windows)} windows")
            check(served == len(frames) * WIDTH * HEIGHT * SAMPLES, f"{label}: served {served}")
        elif log:
            print(f"[4] {label}: {len(log)} wavefront launches over {len(units)} tiles")

        output_directory = parse_with_base_directory_prefix(job.output_directory_path, Path(base))
        stitched = []
        for frame in frames:
            tiles_of_frame = []
            for tile, (_, _, th, tw) in enumerate(tile_regions()):
                file = output_path_for_tile(
                    output_directory, job.output_file_name_format, job.output_file_format,
                    frame, tile, TILE_GRID,
                )
                pixels = np.array(Image.open(file))
                check(pixels.shape == (th, tw, 3), f"{file.name}: {pixels.shape}")
                tiles_of_frame.append(torch.from_numpy(pixels))
            stitched.append(stitch(tiles_of_frame))
        whole = runs[path.whole]
        for frame, image in zip(frames, stitched):
            if frame not in whole["frames"]:
                continue
            expected_png = whole["images"][whole["frames"].index(frame)]
            within = within_one(image, expected_png)
            equal = (image == expected_png).all(dim=-1).float().mean().item()
            print(
                f"[4] {label} frame {frame}: stitched PNG vs {whole['label']}'s: {within:.6f} of "
                f"uint8 values within 1, {equal:.6f} of pixels bit-equal"
            )
            if path.scene == "02_physics-mesh" or path.hint:
                check(within >= 0.995, f"{label}: stitched frame {frame} disagrees ({within})")
            else:
                check(equal == 1.0, f"{label}: stitched frame {frame} is not the whole frame's")

        # The card's idle share over frame 1's tiles, under the profiler (a
        # pool path: its 4 windows of the frames).
        def frame_tiles():
            for index, unit in enumerate(units if path.hint else units[:len(tile_regions())]):
                if path.hint:
                    backend.note_upcoming_frames(job, tuple(units[index + 1:]))
                asyncio.run(backend.render_frame(job, unit.frame_index, unit.tile))

        profile = profiled(frame_tiles, path.kernel, f"{label} frame tiles")
        idle = None
        if profile is not None:
            idle = 1 - profile["device_ms"] / profile["wall_ms"]
            print(
                f"[6] {label}, {'all units' if path.hint else 'frame 1' + chr(39) + 's tiles'} under "
                f"the profiler: wall {profile['wall_ms']:.3f} ms, device busy "
                f"{profile['device_ms']:.3f} ms ({profile['kernels']} device operations); device "
                f"idle {idle:.4f}"
            )
    return {
        "path": path, "label": label, "frames": frames, "units": units, "timings": timings,
        "path_s": path_s, "launches": launches[path.kernel], "stitched": stitched,
        "windows": windows, "idle": idle,
    }


def tile_linear_checks(run: dict, device) -> dict:
    """Phase 4's linear check of a tile path: the region renders of the
    path's tier stitched, against the whole-frame render of the same tier
    on the card (the lane kernel's tiles against the positional kernel's
    frame, the wavefront's against the wavefront's: bit for bit; the 02
    masked region loop against the mesh megakernel: the bit-equal share
    printed; the pool's windows of the frames, one per tile, against the
    wavefront's frames 1-2 within atol 1e-5 and against the whole-frame
    pool window of the same frames bit for bit)."""
    import torch

    from tpu_render_cluster_torch.render import compaction, integrator, raypool

    path, frames = run["path"], run["frames"]
    options = dict(width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES, device=device)
    regions = tile_regions()
    if path.hint:
        per_tile = [
            raypool.render_batch_raypool(path.scene, frames, region=region, **options)[0]
            for region in regions
        ]
        got = [stitch([tiles[i] for tiles in per_tile]) for i in range(len(frames))]
        pool_whole = raypool.render_batch_raypool(path.scene, frames, **options)[0]
        wavefront = [compaction.render_frame_wavefront(path.scene, f, **options) for f in frames[:2]]
        pool_equal = [(g == w).all(dim=-1).float().mean().item() for g, w in zip(got, pool_whole)]
        errs = [(g - w).abs().max().item() for g, w in zip(got, wavefront)]
        shares = [(g == w).all(dim=-1).float().mean().item() for g, w in zip(got, wavefront)]
        print(
            f"[4] {run['label']}: stitched linear frames {frames} vs the whole-frame pool window: "
            f"bit-equal shares {pool_equal}; frames {frames[:2]} vs the whole wavefront frames: max "
            f"abs err {errs}, bit-equal shares {shares}"
        )
        check(min(pool_equal) == 1.0, f"{run['label']}: stitched pool tiles differ from the pool's frames")
        check(max(errs) <= 1e-5, f"{run['label']}: stitched pool tiles differ from the wavefront by {max(errs)}")
        return {"max_abs_err": max(errs), "bit_equal_share": min(shares)}
    errs, shares = [], []
    for frame in frames:
        if path.kernel == "mesh_bounce_tlas" and path.scene == "03_physics-2-mesh":
            whole = compaction.render_frame_wavefront(path.scene, frame, **options)
            tiles = [
                compaction.render_region_wavefront(
                    path.scene, frame, y0=y0, x0=x0, tile_height=th, tile_width=tw, **options
                )
                for y0, x0, th, tw in regions
            ]
        else:  # the masked tier: whole frames through the megakernels
            whole = integrator.render_frame(path.scene, frame, **options)
            tiles = [
                integrator.render_frame_region(
                    path.scene, frame, y0=y0, x0=x0, tile_height=th, tile_width=tw, **options
                )
                for y0, x0, th, tw in regions
            ]
        got = stitch(tiles)
        errs.append((got - whole).abs().max().item())
        shares.append((got == whole).all(dim=-1).float().mean().item())
    print(
        f"[4] {run['label']}: stitched linear frames {frames} vs the whole frames on the card: max "
        f"abs err {errs}, bit-equal shares {shares}"
    )
    if path.scene != "02_physics-mesh":
        check(max(errs) == 0.0, f"{run['label']}: stitched linear frames are not the whole frames")
    return {"max_abs_err": max(errs), "bit_equal_share": min(shares)}


def tile_times(run: dict, runs: dict, device) -> dict:
    """Phase 5 for a tile path: per-tile render and save ms (median over
    the units), the rays of one tile (``region_rays_and_seed``, fenced)
    beside a whole frame's, and the tiled job's frames/s beside the
    whole-frame path's of this run."""
    import torch

    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed, region_rays_and_seed

    path, timings = run["path"], run["timings"]
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    render_ms = med([t.finished_rendering_at - t.started_rendering_at for t in timings])
    save_ms = med([t.file_saving_finished_at - t.file_saving_started_at for t in timings])
    camera = scene_camera(path.scene, run["frames"][0], device)
    y0, x0, th, tw = tile_regions()[0]
    region = lambda: region_rays_and_seed(  # noqa: E731
        camera, run["frames"][0], width=WIDTH, height=HEIGHT, samples=SAMPLES, y0=y0, x0=x0,
        tile_height=th, tile_width=tw,
    )
    whole = lambda: frame_rays_and_seed(  # noqa: E731
        camera, run["frames"][0], width=WIDTH, height=HEIGHT, samples=SAMPLES
    )
    def fenced_ms(fn) -> float:
        torch.cuda.synchronize()
        started = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - started) * 1e3

    fenced_ms(region)
    rays_ms, whole_rays_ms = (statistics.median(fenced_ms(fn) for _ in range(5)) for fn in (region, whole))
    fps = len(run["frames"]) / run["path_s"]
    other = runs[path.whole]
    whole_fps = len(other["frames"]) / other["path_s"]
    print(
        f"[5] {run['label']}: per tile (median over {len(timings)} units) render "
        f"{render_ms:.3f} ms, save (PNG) {save_ms:.3f} ms; a tile's rays {rays_ms:.3f} ms, a "
        f"whole frame's {whole_rays_ms:.3f} ms; {fps:.3f} frames/s over the tiled job on one "
        f"worker, the whole-frame path ({other['label']}) {whole_fps:.3f} in this run"
    )
    return {
        "tile_render_ms": render_ms, "tile_save_ms": save_ms, "tile_rays_ms": rays_ms,
        "whole_rays_ms": whole_rays_ms, "frames_per_s": fps, "whole_frames_per_s": whole_fps,
    }


def lane_kernel_record(run: dict, device, max_abs_err: float, build_s: float) -> dict:
    """Phases 5-6 for the lane kernel at the tile path's shape (tile 0 of
    frame 1: 256x256 x 8 spp = 524,288 rays): its wrapper's calls (CUDA
    events, the median of 10 batches of 20) beside the positional kernel on
    the same rays, the kernel alone under the profiler, the plain version
    on the card, and the bound from the plain version's work counters at 40
    bytes a ray."""
    import torch

    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import region_rays_and_seed
    from tpu_render_cluster_torch.render.scene import build_scene

    frame = run["frames"][0]
    scene = build_scene("04_very-simple", frame, device)
    y0, x0, th, tw = tile_regions()[0]
    origins, directions, lanes, seed = region_rays_and_seed(
        scene_camera("04_very-simple", frame, device), frame, width=WIDTH, height=HEIGHT,
        samples=SAMPLES, y0=y0, x0=x0, tile_height=th, tile_width=tw,
    )
    call = lambda: kernels.trace_paths_fused(  # noqa: E731
        scene, origins, directions, seed, max_bounces=BOUNCES, lane=lanes
    )
    positional = lambda: kernels.trace_paths_fused(  # noqa: E731
        scene, origins, directions, seed, max_bounces=BOUNCES
    )
    cuda_ms(call, 3)
    batches = [cuda_ms(call, 20) for _ in range(10)]
    positional_batches = [cuda_ms(positional, 20) for _ in range(10)]
    kernel_ms, positional_ms = statistics.median(batches), statistics.median(positional_batches)
    wrapper_host_ms = host_ms(call, 20)
    kernel_only_ms = alone_ms(call, "trace_fused_lanes", "trace_fused_lanes calls")
    stats: dict = {}
    out: list = []
    plain_ms = cuda_ms(lambda: out.append(kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=BOUNCES, lane=lanes, stats=stats
    )), 1)
    check(torch.equal(call(), out[0]), "trace_fused_lanes differs from its plain version on the tile")
    n_rays = origins.shape[0]
    least = bound(stats, n_rays * LANE_RAY_BYTES)
    print(
        f"[5] trace_fused_lanes at {n_rays} rays (tile 0 of {run['label']}): {kernel_ms:.4f} ms "
        f"(median of 10 batches of 20 calls: {', '.join(f'{b:.4f}' for b in batches)}; host "
        f"{wrapper_host_ms:.4f} ms per call); trace_fused on the same rays {positional_ms:.4f} ms; "
        f"plain version {plain_ms:.3f} ms (bit-equal); {describe_bound(least)}; work: {stats}"
    )
    if kernel_only_ms is not None:
        print(f"[6] trace_fused_lanes, windows of 5 wrapper calls under the profiler: the kernel "
              f"alone {kernel_only_ms:.4f} ms per call")
    return {
        "name": "trace_fused_lanes",
        "route": "cuda",
        "source": "tpu_render_cluster_torch/render/csrc/trace_fused_lanes.cu",
        "replaces": REPLACES["trace_fused_lanes"],
        "launches": run["launches"],
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": least["ms"],
        "bound_by": least["by"],
        "library_ms": None,
        "rays": n_rays,
        "positional_ms": positional_ms,
        "host_ms": wrapper_host_ms,
        "kernel_only_ms": kernel_only_ms,
        "tolerance": "bit-equal to the plain version; on lanes 0..R-1 bit-equal to trace_fused",
        "build_s": build_s,
    }


# -- the octant-ordered walk's passes ----------------------------------------


@contextlib.contextmanager
def walk_order(ordered: bool):
    """The wrappers' walk order for the block: ordered, as every scene's BVH
    carries octant tables (the default), or the canonical order, as for a
    BVH without them (``kernels.walks_ordered`` answers False meanwhile)."""
    from tpu_render_cluster_torch.render import kernels

    saved = kernels.walks_ordered
    if not ordered:
        kernels.walks_ordered = lambda bvh: False
    try:
        yield
    finally:
        kernels.walks_ordered = saved


def deep_launches(kernel: str, device):
    """(trace, rays, launches) of frame 1 of the deep wavefront path through
    ``kernel``: its four launches, bounce 0's its whole width (2,097,152
    lanes)."""
    scene = PATHS[2].scene
    frame = job_frames(PATHS[2])[1][0]
    trace = Trace(kernel, scene, frame, device)
    rays = frame_rays(scene, frame, device)
    launches: list = []
    trace.run(*rays, BOUNCES, on_launch=launches.append)
    return trace, rays, launches


def pass_records(runs: dict, device, build_s: float) -> list[dict]:
    """Phases 5-6 for the ordered walk's two passes at the deep wavefront's
    bounce-0 launch (row 4 TLAS's widest): the vote over its 8,192 packets
    of 256 lanes and 48 slots, and the key pass on the launch's outputs;
    each wrapper on CUDA events, alone under the profiler, its plain version
    on the card, and its bound from the work these inputs need."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    trace, rays, launches = deep_launches("mesh_bounce_tlas", device)
    launch = launches[0]
    state, live = launch.state, launch.live
    slots = kernels.tlas_frame(trace.mesh).slots
    lanes, k = state[0].shape[0], slots.shape[0]
    packets = -(-lanes // kernels.TLAS_BLOCK_R)
    out = trace.bounce(state, live, rays[2], launch.bounce)
    vote = lambda: kernels.packet_votes(state[1], slots, live, block=kernels.TLAS_BLOCK_R)  # noqa: E731
    plain_vote = lambda: kernels.packet_votes_reference(  # noqa: E731
        state[1], slots, live, block=kernels.TLAS_BLOCK_R
    )
    key = lambda: kernels.entry_keys(  # noqa: E731
        trace.mesh, out.origins, out.directions, out.alive, live, launch.bounce,
        total_bounces=BOUNCES,
    )
    stats: dict = {}
    plain_key = lambda: kernels.entry_keys_reference(  # noqa: E731
        trace.mesh, out.origins, out.directions, out.alive, live, launch.bounce,
        total_bounces=BOUNCES, stats=stats,
    )
    records = []
    for name, call, plain, ops, moved in (
        ("packet_octants", vote, plain_vote,
         lambda: lanes * (k * OPS_VOTE_ROW + OPS_VOTE_WORLD),
         lambda: lanes * VOTE_RAY_BYTES + packets * (k + 1)),
        ("mesh_entry_keys", key, plain_key,
         lambda: OPS_SLAB * stats["entry_tests"] + lanes * OPS_VOTE_WORLD,
         lambda: lanes * KEY_PASS_RAY_BYTES),
    ):
        cuda_ms(call, 2)
        ms = statistics.median(cuda_ms(call, 5) for _ in range(5))
        plain_ms = cuda_ms(plain, 1)
        stats.clear()  # the work of one plain call, counted below
        got, want = call(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        err = max(int((a.long() - b.long()).abs().max()) for a, b in pairs if a is not None)
        check(err == 0, f"{name}: differs from its plain version at the deep bounce-0 launch")
        alone = alone_ms(call, name, f"{name} at the deep bounce-0 launch")
        ops_ms = ops() / FP32_PEAK_FLOPS * 1e3
        bytes_ms = moved() / MEMORY_BYTES_PER_S * 1e3
        launched = sum(run.get("pass_launches", {}).get(name, 0) for run in runs.values())
        print(
            f"[5] {name} at {lanes} lanes ({packets} packets, {k} slots): {ms:.4f} ms per call, "
            f"alone {alone}; plain version {plain_ms:.3f} ms; bound {max(ops_ms, bytes_ms):.4f} "
            f"ms by {'operations' if ops_ms >= bytes_ms else 'bytes'} ({ops() / 1e9:.3f} GFLOP, "
            f"{moved() / 1e6:.2f} MB); {launched} launches on the main paths, "
            f"{PASS_CHECKS[name]} held to the plain version in phases 3-4"
        )
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"tpu_render_cluster_torch/render/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launched,
            "max_abs_err": float(err),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "kernel_only_ms": alone,
            "rays": lanes,
            "checked_launches": PASS_CHECKS[name],
            "tolerance": TOLERANCE[name],
            "build_s": build_s,
        })
    return records


def backend_fps(path: MainPath, frames: int, device) -> dict:
    """``frames`` frames of a main path's job through a fresh backend (a
    pool path with the queue's hint before each: one window), timed on the
    host: frames/s and the median render ms."""
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    job, all_frames = job_frames(path)
    chosen = all_frames[:frames]
    pool = path.kernel in POOLS
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ab-") as base:
        backend = TorchRaytraceBackend(
            width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES,
            base_directory=base, wavefront=path.wavefront, raypool=path.raypool,
            use_tlas=path.use_tlas,
        )
        backend.warm(job.job_name)
        import torch

        torch.cuda.synchronize()
        timings = []
        started = time.perf_counter()
        for index, frame in enumerate(chosen):
            if pool:
                backend.note_upcoming_frames(job, tuple(chosen[index + 1:]))
            timings.append(asyncio.run(backend.render_frame(job, frame)))
        elapsed = time.perf_counter() - started
    render = [(t.finished_rendering_at - t.started_rendering_at) * 1e3 for t in timings]
    return {"fps": len(chosen) / elapsed, "render_ms": statistics.median(render)}


# -- 7. the redesigned kernels, and the ordered walk against the canonical --

# The kernels redesigned for Hopper in earlier slices: the vote pass and
# row 3 TLAS, then row 1 in both its modes (ROW1), which chip_ab.py times
# against the builds of the sources they replaced, as it does the key pass
# (phase 7's key_pass_times).
REDESIGNED = ("packet_octants", "trace_fused_mesh_tlas")
ROW1 = ("trace_fused", "trace_fused_lanes")


def row1_resources(frame_rays: int, tile_rays: int) -> dict:
    """Row 1's ptxas lines (of this process's build) in both modes, its
    resident blocks per SM and the persistent grid of a whole frame's
    launch and of a tile's (the kernels' ``*_occupancy`` C entries)."""
    import ctypes

    from tpu_render_cluster_torch.render import _build

    resources = {}
    for name, rays in zip(ROW1, (frame_rays, tile_rays)):
        grid = ctypes.c_int()
        per_sm = occupancy_entry(name, [ctypes.c_int, ctypes.c_void_p])(
            rays, ctypes.addressof(grid))
        check(per_sm > 0, f"{name}_occupancy failed ({per_sm})")
        resources[name] = {
            "ptxas": _build.resource_lines(_build.build_logs.get(name, "")),
            "blocks_per_sm": per_sm, "rays": rays, "grid_blocks": grid.value,
        }
    print(f"[7] row 1 registers, spills, resident blocks and grid: {json.dumps(resources)}")
    return resources


def key_pass_launches(device, frames: int = 1) -> list[dict]:
    """Every ``mesh_bounce_tlas`` launch of the deep wavefront path's first
    ``frames`` frames whole and of tile 0 of its frame 1 (a 2x2 grid: the
    region's rays, their whole-frame lanes as RNG counters): per launch its
    label, its frame or tile (``unit``), the mesh, the bounce's outputs
    (with the key column of the port's key pass), the live count, the
    bounce and the lanes."""
    from tpu_render_cluster_torch.render import compaction
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import region_rays_and_seed

    path = PATHS[2]
    chosen = job_frames(path)[1][:frames]
    jobs = [(f"03 frame {frame}", Trace("mesh_bounce_tlas", path.scene, frame, device),
             frame_rays(path.scene, frame, device), None) for frame in chosen]
    y0, x0, th, tw = tile_regions()[0]
    origins, directions, lanes, seed = region_rays_and_seed(
        scene_camera(path.scene, chosen[0], device), chosen[0], width=WIDTH, height=HEIGHT,
        samples=SAMPLES, y0=y0, x0=x0, tile_height=th, tile_width=tw,
    )
    jobs.append((f"03 frame {chosen[0]} tile 0",
                 Trace("mesh_bounce_tlas", path.scene, chosen[0], device),
                 (origins, directions, seed), lanes))
    out = []
    for unit, trace, (origins, directions, seed), lanes in jobs:
        launches: list = []
        compaction.trace_paths_wavefront(
            trace.scene, origins, directions, seed, max_bounces=BOUNCES, mesh=trace.mesh,
            on_launch=launches.append, use_tlas=True, rng_lanes=lanes,
        )
        for launch in launches:
            out.append({
                "label": f"{unit} bounce {launch.bounce}", "unit": unit, "mesh": trace.mesh,
                "out": trace.bounce(launch.state, launch.live, seed, launch.bounce),
                "live": int(launch.live), "bounce": launch.bounce,
                "lanes": launch.state[0].shape[0],
            })
    return out


def key_pass_times(device) -> dict:
    """Phase 7 for the key pass (``mesh_entry_keys``) at row 4 TLAS's four
    launches of a deep wavefront frame and the four of a deep wavefront
    tile: each launch's keys exactly against its plain version and the key
    column the bounce's wrapper wrote, whether it runs persistent blocks,
    its resident blocks per SM, staged bytes and its grid (the kernel's
    ``mesh_entry_keys_occupancy`` entry), its wrapper on CUDA events (the
    median of 3 batches of 5) and the kernel alone."""
    import ctypes

    import torch

    from tpu_render_cluster_torch.render import kernels

    query = occupancy_entry("mesh_entry_keys",
                            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int])
    results = {}
    for launch in key_pass_launches(device):
        out, mesh = launch["out"], launch["mesh"]
        args = (mesh, out.origins, out.directions, out.alive, launch["live"], launch["bounce"])
        call = lambda args=args: kernels.entry_keys(*args, total_bounces=BOUNCES)  # noqa: E731
        got = call()
        plain = kernels.entry_keys_reference(*args, total_bounces=BOUNCES)
        torch.cuda.synchronize()
        differ = {"plain": int((got != plain).sum()), "bounce": int((got != out.key).sum())}
        check(not any(differ.values()), f"mesh_entry_keys {launch['label']}: keys differ "
                                        f"({differ})")
        frame = kernels.tlas_frame(mesh)
        persistent, shared, grid = (ctypes.c_int() for _ in range(3))
        blocks = query(launch["lanes"], frame.slots.shape[0], frame.node_bounds.shape[0],
                       ctypes.addressof(persistent), ctypes.addressof(shared),
                       ctypes.addressof(grid), 0)
        check(blocks > 0, f"mesh_entry_keys_occupancy failed ({blocks})")
        cuda_ms(call, 2)
        result = {
            "lanes": launch["lanes"], "live": launch["live"],
            "persistent": bool(persistent.value), "blocks_per_sm": blocks,
            "shared_bytes": shared.value, "grid_blocks": grid.value,
            "ms": statistics.median(cuda_ms(call, 5) for _ in range(3)),
            "alone_ms": alone_ms(call, "mesh_entry_keys", f"[7] mesh_entry_keys "
                                                          f"{launch['label']}"),
        }
        results[launch["label"]] = result
        print(f"[7] mesh_entry_keys {launch['label']}: {json.dumps(result)}")
    units: dict = {}
    for label, result in results.items():
        units.setdefault(label.rsplit(" bounce ", 1)[0], []).append(result["alone_ms"])
    for unit, values in units.items():
        total = None if None in values else sum(values)
        print(f"[7] mesh_entry_keys alone over the launches of {unit}: {total}")
    return results


def vote_bound(lanes: int, block: int, rows: int, voted, world: bool, frames: bool) -> dict:
    """The vote pass's least time on a launch of ``lanes`` lanes in packets
    of ``block``: 21 flops a lane and row voted (``voted`` [P], the rows
    each packet votes) and 3 a lane for the world vote, against 12 bytes of
    directions a lane (and 4 of frame id with ``frames``) and a byte a
    packet and row of the ``rows`` (and its world octant)."""
    ops = OPS_VOTE_ROW * block * int(voted.sum()) + OPS_VOTE_WORLD * lanes * world
    moved = lanes * (VOTE_RAY_BYTES + 4 * frames) + voted.shape[0] * (rows + world)
    ops_ms, bytes_ms = ops / FP32_PEAK_FLOPS * 1e3, moved / MEMORY_BYTES_PER_S * 1e3
    return {"ms": max(ops_ms, bytes_ms), "by": "operations" if ops_ms >= bytes_ms else "bytes"}


def vote_launches(pool_first: dict, device) -> list[dict]:
    """The vote pass's launches that phase 7 times: row 4 TLAS's four of
    frame 1 of the deep wavefront (every row, with the world vote) and the
    pool's first window's (first, each frame boundary, the mixed launch,
    the drain, and the mixed launch shuffled over all 8 frames; the rows of
    each packet's frames, no world vote). Each: the arguments of
    ``kernels.packet_votes`` (``args``, ``options``) and its label."""
    from tpu_render_cluster_torch.render import kernels

    launches = []
    block = kernels.TLAS_BLOCK_R
    trace, rays, deep = deep_launches("mesh_bounce_tlas", device)
    slots = kernels.tlas_frame(trace.mesh).slots
    for launch in deep:
        launches.append({
            "label": f"row 4 TLAS bounce {launch.bounce}",
            "args": (launch.state[1], slots, int(launch.live)),
            "options": {"block": block, "world": True},
        })
    window = pool_first["window"]
    stacked = kernels.pool_tlas_operands(window.ops).slots
    roles = {}  # a launch that fills two roles is timed once
    for role, picked in pool_first["picked"].items():
        roles.setdefault(picked["index"], (role, picked))
    pool_states = [(role, pool_first["launches"][index].state, int(picked["live"]))
                   for index, (role, picked) in roles.items()]
    pool_states.append(("unsorted (8 frames a packet)", pool_first["unsorted"],
                        window.pool))
    for role, state, live in pool_states:
        launches.append({
            "label": f"row 6 TLAS {role}", "args": (state[1], stacked, live),
            "options": {"block": block, "world": False, "frames": state[5],
                        "per_frame": window.ops.per_frame},
        })
    return launches


def vote_rows(launch: dict, device) -> dict:
    """The rows a launch of ``vote_launches`` votes, the frames its walked
    packets carry, and its bound from the rows voted beside the bound of
    every row's vote; ``carried`` [P, frames] (None without frame ids)."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    directions, table, live = launch["args"]
    options = launch["options"]
    block, world = options["block"], options["world"]
    packets = -(-directions.shape[0] // block)
    walked = torch.arange(packets, device=device) * block < live
    if "frames" in options:
        per_frame = options["per_frame"]
        carried = (kernels.carried_frames(options["frames"], block, table.shape[0] // per_frame)
                   & walked[:, None])
        voted = carried.sum(dim=1) * per_frame
        per_packet = carried.sum(dim=1)[walked].float()
    else:
        carried, per_packet = None, None
        voted = walked.long() * table.shape[0]
    return {
        "carried": carried,
        "lanes": directions.shape[0], "live": live, "rows": table.shape[0],
        "rows_voted_mean": voted[walked].float().mean().item() if walked.any() else 0.0,
        "frames_per_packet_mean": None if per_packet is None else per_packet.mean().item(),
        "frames_per_packet_max": None if per_packet is None else int(per_packet.max()),
        "bound": vote_bound(directions.shape[0], block, table.shape[0], voted, world,
                            carried is not None),
        "bound_every_row": vote_bound(directions.shape[0], block, table.shape[0],
                                      walked.long() * table.shape[0], world, False),
    }


def vote_times(pool_first: dict, device) -> dict:
    """Phase 7 for the vote pass: on each launch of ``vote_launches`` the
    kernel exactly against its plain version, the rows it votes and its
    bound (``vote_rows``), its wrapper on CUDA events (the median of 3
    batches of 5) and the kernel alone."""
    from tpu_render_cluster_torch.render import kernels

    results = {}
    for launch in vote_launches(pool_first, device):
        args, options = launch["args"], launch["options"]
        call = lambda args=args, options=options: kernels.packet_votes(*args, **options)  # noqa: E731
        got = call()
        plain = kernels.packet_votes_reference(*args, **options)
        differ = sum(int((a != b).sum()) for a, b in zip(got, plain) if a is not None)
        check(differ == 0, f"packet_octants {launch['label']}: {differ} votes differ from plain")
        result = vote_rows(launch, device)
        del result["carried"]
        cuda_ms(call, 2)
        result["ms"] = statistics.median(cuda_ms(call, 5) for _ in range(3))
        result["alone_ms"] = alone_ms(call, "packet_octants", f"[7] packet_octants "
                                                              f"{launch['label']}")
        results[launch["label"]] = result
        print(f"[7] packet_octants {launch['label']}: {json.dumps(result)}")
    return results


def redesign_resources(pool_first: dict, device) -> dict:
    """Each redesigned kernel's ptxas lines and its resident blocks per SM
    at phase 7's launches (row 3 TLAS on 02's tables in the default walk
    order, with its dynamic shared memory; the vote at 48 rows and at the
    pool's stacked rows)."""
    import ctypes

    from tpu_render_cluster_torch.render import _build, kernels

    mesh = Trace("trace_fused_mesh_tlas", PATHS[1].scene, 1, device).mesh
    triangles, bounds, _ = kernels._bvh_operands(mesh.bvh)
    shared = ctypes.c_int()
    query = occupancy_entry("trace_fused_mesh_tlas",
                            [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int])
    mega_blocks = query(mesh.instances.translation.shape[0], triangles.shape[0], bounds.shape[0],
                        kernels.tlas_frame(mesh).node_bounds.shape[0],
                        int(kernels.walks_ordered(mesh.bvh)), ctypes.addressof(shared), 0)
    vote_query = occupancy_entry("packet_octants", [ctypes.c_int] * 2)
    stacked = kernels.pool_tlas_operands(pool_first["window"].ops).slots
    blocks = {
        "trace_fused_mesh_tlas": {"02 ordered": mega_blocks, "shared_bytes": shared.value},
        "packet_octants": {"48 rows": vote_query(kernels.TLAS_BLOCK_R, 48),
                           f"{stacked.shape[0]} rows": vote_query(kernels.TLAS_BLOCK_R,
                                                                  stacked.shape[0])},
    }
    resources = {}
    for name in REDESIGNED:
        check(all(b > 0 for b in blocks[name].values()), f"{name}_occupancy failed")
        resources[name] = {"ptxas": _build.resource_lines(_build.build_logs.get(name, "")),
                           "blocks_per_sm": blocks[name]}
        print(f"[7] {name} registers, spills, resident blocks: {json.dumps(resources[name])}")
    return resources


def octant_ab(pool_inputs: dict, device) -> dict:
    """Phase 7: the octant-ordered walk against the canonical order in this
    one run, in turns (ordered, canonical, canonical, ordered): each of the
    six kernels of rows 3, 4 and 6 alone under the profiler (windows of 5
    calls) and its wrapper on CUDA events at the widths of PERF.md section
    6 (rows 3: frame 1 of the 02 path, 2,097,152 rays, and row 3 TLAS at
    frame 2 too; rows 4: bounce 0 of frame 1 of the deep wavefront; rows 6:
    the mixed launch of the pool path's first window, 65,536 lanes), with
    the passes alone on the ordered turns; and frames/s of the 02 path, the
    deep wavefront and the deep pool, 2 frames each a turn (4 before the
    node-format phase took its time)."""
    from tpu_render_cluster_torch.render import kernels

    calls = []  # (label, kernel, call)
    mesh_path = PATHS[1]
    frames = job_frames(mesh_path)[1]
    for kernel, frame in (("trace_fused_mesh_tlas", frames[0]), ("trace_fused_mesh_tlas",
                                                                 frames[1]),
                          ("trace_fused_mesh", frames[0])):
        trace = Trace(kernel, mesh_path.scene, frame, device)
        rays = frame_rays(mesh_path.scene, frame, device)
        label = kernel if frame == frames[0] else f"{kernel} 02 frame {frame}"
        calls.append((label, kernel, lambda trace=trace, rays=rays: trace.run(*rays, BOUNCES)))
    occupancy = {}
    for kernel in ("mesh_bounce_tlas", "mesh_bounce"):
        trace, rays, launches = deep_launches(kernel, device)
        launch = launches[0]
        calls.append((kernel, kernel, lambda trace=trace, launch=launch, seed=rays[2]: trace.bounce(
            launch.state, launch.live, seed, launch.bounce
        )))
        if kernel == "mesh_bounce_tlas":
            group = kernels.bounce_group(launch.bucket, kernels.thread_slots(device.index or 0))
            for ordered in (True, False):
                with walk_order(ordered):
                    occupancy[f"{kernel} {'ordered' if ordered else 'canonical'}"] = {
                        "group": group, **bounce_occupancy(trace.mesh, group)}
    for kernel in ("pool_mesh_bounce_tlas", "pool_mesh_bounce"):
        first = pool_inputs[kernel]
        window = first["window"]
        launch = first["launches"][first["picked"]["mixed"]["index"]]
        wrapper, _ = pool_functions(kernel)
        calls.append((kernel, kernel, lambda wrapper=wrapper, ops=window.ops, launch=launch: wrapper(
            ops, *launch.state, int(launch.live), total_bounces=BOUNCES
        )))
        if kernel == "pool_mesh_bounce_tlas":
            for ordered in (True, False):
                with walk_order(ordered):
                    occupancy[f"{kernel} {'ordered' if ordered else 'canonical'}"] = {
                        "group": kernels.POOL_GROUP,
                        **pool_occupancy(window.ops, kernels.POOL_GROUP)}
    print(f"[7] resident blocks per SM and staged bytes, ordered and canonical: "
          f"{json.dumps(occupancy)}")
    result = {}
    for label, kernel, call in calls:
        turns = []
        for ordered in (True, False, False, True):
            with walk_order(ordered):
                cuda_ms(call, 2)
                ms = statistics.median(cuda_ms(call, 5) for _ in range(3))
                names = kernels.launch_names(kernel, ordered)
                profile = profiled(lambda: [call() for _ in range(5)], names,
                                   f"[7] {label} {'ordered' if ordered else 'canonical'}",
                                   tries=6)
            alone = None if profile is None else profile["per_kernel"][kernel] / 5
            passes = None if profile is None or not ordered else {
                name: profile["per_kernel"][name] / 5 for name in names[1:]
            }
            turns.append({"ordered": ordered, "ms": ms, "alone_ms": alone, "passes_ms": passes})
        pick = lambda ordered, key: [t[key] for t in turns if t["ordered"] == ordered]  # noqa: E731
        mean = lambda xs: None if None in xs else statistics.mean(xs)  # noqa: E731
        result[label] = {
            "ordered_ms": mean(pick(True, "ms")), "canonical_ms": mean(pick(False, "ms")),
            "ordered_alone_ms": mean(pick(True, "alone_ms")),
            "canonical_alone_ms": mean(pick(False, "alone_ms")),
            "passes_alone_ms": [t["passes_ms"] for t in turns if t["ordered"]],
            "turns": turns,
        }
        print(f"[7] {label}, ordered against canonical in turns: {json.dumps(result[label])}")
    two = [result["trace_fused_mesh_tlas"], result[f"trace_fused_mesh_tlas 02 frame {frames[1]}"]]
    for order in ("ordered", "canonical"):
        values = [r[f"{order}_alone_ms"] for r in two]
        result["trace_fused_mesh_tlas"][f"two_frames_{order}_alone_ms"] = (
            None if None in values else statistics.mean(values))
    fps = {}
    for path in (PATHS[1], PATHS[2], PATHS[4]):
        turns = []
        for ordered in (True, False, False, True):
            with walk_order(ordered):
                turns.append({"ordered": ordered, **backend_fps(path, 2, device)})
        fps[path.kernel] = {
            "ordered_fps": statistics.mean(t["fps"] for t in turns if t["ordered"]),
            "canonical_fps": statistics.mean(t["fps"] for t in turns if not t["ordered"]),
            "turns": turns,
        }
        print(f"[7] {path.scene} ({path.kernel}) frames/s, ordered against canonical, 2 frames a "
              f"turn: {json.dumps(fps[path.kernel])}")
    return {"kernels": result, "frames_per_s": fps, "occupancy": occupancy}


# -- 8. the wire: a port worker process serving the C++ master -------------

# The C++ master's build line (native/master_daemon.cpp:14-16), into the
# ignored build directory of the port's kernels.
MASTER_SOURCES = ("native/master_daemon.cpp", "native/wscodec.cpp")


class WireJob(NamedTuple):
    job_name: str  # also the scene
    frames: int
    strategy: str  # the [frame_distribution_strategy] table's lines
    kernels: tuple[str, ...]  # what the worker must launch for it
    # The in-process render takes the hints the worker's queue gives: none
    # for the first frame, which starts rendering before the master's next
    # add arrives, then the rest of the job for each later frame.
    hint: bool
    # The node format: the worker's TRC_BVH_QUANT, the in-process
    # backend's ``quant`` (its PNGs then bit-equal to the worker's).
    quant: int = 0
    # The worker's --sharding, the in-process backend's ``sharding``.
    sharding: str | None = None
    # More of the worker's environment (phase 11's job: the TLAS tiers), in
    # which the in-process render runs too.
    env: tuple[tuple[str, str], ...] = ()


WIRE_JOBS = [
    WireJob("04_very-simple", 10, 'strategy_type = "naive-fine"', ("trace_fused",), False),
    # The master's add RPCs come one at a time, so frame 1 starts alone (the
    # wavefront) and the frames added while it renders wait on the worker's
    # queue, whose hint pools them.
    WireJob(
        "03_physics-2-mesh", 4, 'strategy_type = "eager-naive-coarse"\ntarget_queue_size = 4',
        ("mesh_bounce_tlas", "mesh_entry_keys", "pool_mesh_bounce_tlas", "packet_octants"), True,
    ),
    # The same job on a worker started with TRC_BVH_QUANT=1 in its
    # environment (the reference's way of choosing the tier): the quantized
    # kernels' launches in its snapshot.
    WireJob(
        "03_physics-2-mesh", 4, 'strategy_type = "eager-naive-coarse"\ntarget_queue_size = 4',
        ("mesh_bounce_tlas[q1]", "mesh_entry_keys[q1]", "pool_mesh_bounce_tlas[q1]",
         "packet_octants"), True, quant=1,
    ),
    # The sphere job on a worker started with --sharding tile: its mesh the
    # one card, a band a frame, one row 1 launch a frame.
    WireJob("04_very-simple", 4, 'strategy_type = "naive-fine"', ("trace_fused",), False,
            sharding="tile"),
]
WIRE_MASTER_TIMEOUT_S, WIRE_WORKER_TIMEOUT_S = 300, 60
WIRE_PHASES = {
    "load": ("started_process_at", "finished_loading_at"),
    "render": ("started_rendering_at", "finished_rendering_at"),
    "save": ("file_saving_started_at", "file_saving_finished_at"),
    "total": ("started_process_at", "exited_process_at"),
}


def write_wire_job(job: WireJob, directory: Path) -> Path:
    path = directory / f"{job.job_name}.toml"
    path.write_text("\n".join([
        f'job_name = "{job.job_name}"',
        'job_description = "chip_smoke wire phase"',
        'project_file_path = "%BASE%/project.blend"',
        'render_script_path = "%BASE%/script.py"',
        "frame_range_from = 1",
        f"frame_range_to = {job.frames}",
        "wait_for_number_of_workers = 1",
        f'output_directory_path = "{directory / "frames"}"',
        'output_file_name_format = "rendered-####"',
        'output_file_format = "PNG"',
        "",
        "[frame_distribution_strategy]",
        job.strategy,
        "",
    ]))
    return path


def in_process_frames(job: WireJob, job_path: Path, directory: Path) -> dict:
    """The wire job's frames through ``TorchRaytraceBackend`` in this
    process, on the card, through the same tiers as the worker (the 03 job
    with the hints its queue gives): the PNGs' pixels by frame, the frames/s
    of the loop, timed on the host after a warm-up, the kernel launches and
    the pool's cache hits."""
    import numpy as np
    import torch
    from PIL import Image

    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.obs import get_registry
    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    spec = BlenderJob.load_from_file(job_path)
    spec = BlenderJob.from_dict(
        {**spec.to_dict(), "output_directory_path": str(directory / "expected")}
    )
    frames = list(spec.frame_indices())
    with environment(dict(job.env)):
        backend = TorchRaytraceBackend(
            width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES,
            base_directory=directory, quant=job.quant, sharding=job.sharding,
        )
        backend.warm(job.job_name)
        torch.cuda.synchronize()
        backend.pool_stats.clear()
        hits = get_registry().counter(
            "render_raypool_cache_hits_total",
            "Frames served from the ray-pool rendered-ahead cache",
        )
        hits_before = hits.value()
        kernels.reset_counts()
        started = time.perf_counter()
        for index, frame in enumerate(frames):
            if job.hint:
                backend.note_upcoming_frames(spec, tuple(frames[index + 1:]) if index else ())
            asyncio.run(backend.render_frame(spec, frame))
        fps = len(frames) / (time.perf_counter() - started)
    launches = {k: v for k, v in kernels.counts.items() if v}
    windows = [w.served // (WIDTH * HEIGHT * SAMPLES) for w in backend.pool_stats]
    print(f"[8] {wire_label(job)} in process: {len(frames)} frames, {fps:.4f} frames/s, "
          f"pool windows of {windows} frames, launches {launches}")
    pixels = {
        frame: np.array(Image.open(directory / "expected" / f"rendered-{frame:04d}.png"))
        for frame in frames
    }
    return {"pixels": pixels, "fps": fps, "launches": launches,
            "hits": int(hits.value() - hits_before)}


def wire_run(job: WireJob, master_binary: Path, job_path: Path, directory: Path) -> dict:
    """One C++ master and one port worker process (default device: the card)
    on a free localhost port, each under ``wait(timeout=...)``, killed on
    any failure. Returns the raw trace and the worker's metrics snapshot."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    results, base = directory / "results", directory / "worker"
    logs = {name: directory / f"{name}.log" for name in ("master", "worker")}
    commands = {
        "master": [
            str(master_binary), "--host", "127.0.0.1", "--port", str(port),
            "run-job", str(job_path), "--resultsDirectory", str(results),
        ],
        "worker": [
            sys.executable, "-m", "tpu_render_cluster_torch.worker.main",
            "--masterServerHost", "127.0.0.1", "--masterServerPort", str(port),
            "--baseDirectory", str(base), "--backend", "torch-raytrace",
            "--renderSize", f"{WIDTH}x{HEIGHT}", "--renderSamples", str(SAMPLES),
            "--warmScene", job.job_name,
            *(("--sharding", job.sharding) if job.sharding else ()),
        ],
    }
    processes: dict[str, subprocess.Popen] = {}
    codes: dict[str, object] = {}
    try:
        for name, command in commands.items():
            with logs[name].open("w") as out:
                env = {**os.environ, "PYTHONPATH": str(REPO)}
                if name == "worker" and job.quant:
                    env["TRC_BVH_QUANT"] = str(job.quant)
                if name == "worker":
                    env.update(dict(job.env))
                processes[name] = subprocess.Popen(
                    command, cwd=REPO, stdout=out, stderr=subprocess.STDOUT, env=env,
                )
        codes["master"] = processes["master"].wait(timeout=WIRE_MASTER_TIMEOUT_S)
        codes["worker"] = processes["worker"].wait(timeout=WIRE_WORKER_TIMEOUT_S)
    except subprocess.TimeoutExpired as error:
        codes["timeout"] = str(error)
    finally:
        for process in processes.values():
            if process.poll() is None:
                process.kill()
                process.wait(timeout=30)
    if codes != {"master": 0, "worker": 0}:
        for name, log in logs.items():
            print(f"[8] {job.job_name} {name} log, last lines:\n"
                  + "\n".join(log.read_text().splitlines()[-30:]), file=sys.stderr)
    check(codes == {"master": 0, "worker": 0}, f"{job.job_name} over the wire: {codes}")
    (raw,) = results.glob("*_raw-trace.json")
    (metrics,) = (base / "obs").glob("worker-*_metrics.json")
    return {"raw": json.loads(raw.read_text()), "snapshot": json.loads(metrics.read_text())}


def wire_checks(job: WireJob, run: dict, expected: dict, frames_directory: Path) -> dict:
    """One wire job's checks: the master's raw trace holds one worker trace
    with the job's frames; the worker launched exactly what the in-process
    render of the same tiers launched (04: ``trace_fused`` once a frame; 03:
    the wavefront's ``mesh_bounce_tlas`` and ``mesh_entry_keys`` once a
    bounce of frame 1, the vote once a launch of either TLAS walk) and took
    as many frames from the pool's cache; every PNG it wrote against the
    in-process render (04 bit for bit, the pooled 03 within phase 4's pool
    check: >= 99.5% of uint8 values within 1)."""
    import numpy as np
    from PIL import Image

    pixels = expected["pixels"]
    (trace,) = run["raw"]["worker_traces"].values()
    units = trace["frame_render_traces"]
    check(sorted(u["frame_index"] for u in units) == sorted(pixels),
          f"{job.job_name}: the worker trace holds frames {[u['frame_index'] for u in units]}")
    master = run["raw"]["master_trace"]
    wall = master["job_finish_time"] - master["job_start_time"]
    medians = {
        phase: statistics.median((u["details"][end] - u["details"][begin]) * 1e3 for u in units)
        for phase, (begin, end) in WIRE_PHASES.items()
    }
    counts = {k: v for k, v in run["snapshot"]["kernel_launches"].items() if v}
    check(sorted(counts) == sorted(job.kernels),
          f"{job.job_name}: the worker launched {counts}, not just {job.kernels}")
    check(counts == expected["launches"],
          f"{job.job_name}: the worker launched {counts}, the in-process render "
          f"of the same tiers {expected['launches']}")
    if job.hint:
        from tpu_render_cluster_torch.render.kernels import packet_name, quant_name

        packet = int(dict(job.env).get("TRC_TLAS_BLOCK", 256))
        row4, row6 = (counts[packet_name(quant_name(k, job.quant), packet)]
                      for k in ("mesh_bounce_tlas", "pool_mesh_bounce_tlas"))
        check(counts[packet_name(quant_name("mesh_entry_keys", job.quant), packet)] == row4
              <= BOUNCES and counts[packet_name("packet_octants", packet)] == row4 + row6,
              f"{job.job_name}: launches {counts} are not frame 1's wavefront and one "
              f"vote a walk")
    else:
        check(counts == {"trace_fused": len(pixels)},
              f"{job.job_name}: launches {counts}, not trace_fused once a frame")
    hits = run["snapshot"]["metrics"].get("render_raypool_cache_hits_total")
    hits = int(sum(hits["series"].values())) if hits else 0
    check(hits == expected["hits"] and (hits >= 1 if job.hint else hits == 0),
          f"{job.job_name}: {hits} frames served from the pool's cache, "
          f"{expected['hits']} in process")
    equal, within = {}, {}
    for frame, want in sorted(pixels.items()):
        got = np.array(Image.open(frames_directory / f"rendered-{frame:04d}.png"))
        check(got.shape == (HEIGHT, WIDTH, 3), f"{job.job_name} frame {frame}: {got.shape}")
        equal[frame] = float((got == want).mean())
        within[frame] = float((np.abs(got.astype(int) - want.astype(int)) <= 1).mean())
        if job.hint and not job.quant and not job.env:
            check(within[frame] >= 0.995, f"{job.job_name} frame {frame}: {within[frame]} within 1")
        else:
            check(equal[frame] == 1.0, f"{job.job_name} frame {frame}: {equal[frame]} bit-equal")
    return {
        "frames": len(units), "master_wall_s": wall, "wire_fps": len(units) / wall,
        "phase_median_ms": medians, "launches": counts, "raypool_cache_hits": hits,
        "bit_equal_share": equal, "within_one_share": within,
    }


def wire_label(job: WireJob) -> str:
    return (job.job_name + (f" (TRC_BVH_QUANT={job.quant})" if job.quant else "")
            + (f" (--sharding {job.sharding})" if job.sharding else "")
            + "".join(f" ({name}={value})" for name, value in job.env))


@contextlib.contextmanager
def environment(values: dict):
    """``os.environ`` with ``values`` set, as it was again afterwards."""
    saved = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def wire_phase(card: str) -> dict:
    """Phase 8: each wire job served by the unmodified C++ master to a port
    worker process on the card, its PNGs held against the in-process
    backend's renders, its launches read from the worker's snapshot."""
    from tpu_render_cluster_torch.render import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    master_binary = _build.BUILD_DIR / "trc-master"
    started = time.perf_counter()
    compiler = subprocess.Popen(
        ["g++", "-std=gnu++17", "-O2", "-pthread", "-o", str(master_binary),
         *(str(REPO / source) for source in MASTER_SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    summary: dict = {"card": card, "jobs": {}, "launches": {}}
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-wire-") as scratch:
            directories = {
                wire_label(job): Path(scratch) / f"{job.job_name}-q{job.quant}-{job.sharding}"
                for job in WIRE_JOBS
            }
            expected = {}
            for job in WIRE_JOBS:  # the in-process renders, while g++ runs
                directory = directories[wire_label(job)]
                directory.mkdir()
                job_path = write_wire_job(job, directory)
                expected[wire_label(job)] = in_process_frames(job, job_path, directory)
            output, _ = compiler.communicate(timeout=600)
            check(compiler.returncode == 0, f"g++ on the C++ master failed:\n{output}")
            print(f"[8] built {master_binary.relative_to(REPO)} with g++ "
                  f"({time.perf_counter() - started:.1f} s, beside the in-process renders)")
            for job in WIRE_JOBS:
                directory = directories[wire_label(job)]
                run = wire_run(job, master_binary, directory / f"{job.job_name}.toml", directory)
                in_process_fps = expected[wire_label(job)]["fps"]
                result = wire_checks(job, run, expected[wire_label(job)], directory / "frames")
                result["in_process_fps"] = in_process_fps
                summary["jobs"][wire_label(job)] = result
                for kernel, count in result["launches"].items():
                    summary["launches"][kernel] = summary["launches"].get(kernel, 0) + count
                print(
                    f"[8] {wire_label(job)} over the wire (C++ master, one port worker process): "
                    f"{result['frames']} frames in {result['master_wall_s']:.4f} s of the master's "
                    f"job, {result['wire_fps']:.4f} frames/s; in process {in_process_fps:.4f} "
                    f"frames/s; worker phase medians (ms) {json.dumps(result['phase_median_ms'])}; "
                    f"launches {result['launches']}; pool cache hits "
                    f"{result['raypool_cache_hits']}; PNGs vs the in-process renders: bit-equal "
                    f"share {list(result['bit_equal_share'].values())}, within 1 "
                    f"{list(result['within_one_share'].values())}"
                )
    finally:
        if compiler.poll() is None:
            compiler.kill()
            compiler.wait(timeout=30)
    print(f"[8] wire phase on {card}: {json.dumps(summary)}")
    return summary


# -- 9. the node formats: the reference's TRC_BVH_QUANT tiers ----------------

# The quantized node formats (kernels.QUANT_TIERS); tier 0 is the fp32 one.
QUANTS = (1, 2)
QUANT_TOLERANCE = (
    "at node format 1 and 2 bit-equal to the plain version at the same format on every output "
    "of every lane (radiance; state outputs, alive, key and hit columns; the key pass's keys)"
)
# Phase 9's checks at a small shape: QUANT_SIDE x QUANT_SIDE x
# CHECK_SAMPLES rays a frame (a 2-frame pool window of 16,384 lanes).
QUANT_SIDE = 64
# The reference's budget of the packed carried state (tests/test_bvhq.py):
# a wavefront or pool image at tier 1 or 2 against the same tier at 0.
PACKED_MAE, PACKED_UINT8 = 1e-3, 2


def quant_equal(label: str, got, want) -> None:
    """Every output of a launch (a tensor or a state's fields) equal to
    the bit."""
    import torch

    fields = got._fields if hasattr(got, "_fields") else ("out",)
    pairs = zip(fields, got, want) if hasattr(got, "_fields") else [("out", got, want)]
    for name, have, expected in pairs:
        if have is None and expected is None:
            continue
        check(have is not None and expected is not None and torch.equal(have, expected),
              f"{label}: {name} differs on "
              f"{'?' if have is None or expected is None else int((have != expected).sum())} "
              f"values")


def quant_tier(label: str, resolved: int, quant: int) -> int:
    """The node format a launch resolved to must be the one asked for (the
    degrade rule would fall back to 0 silently otherwise)."""
    print(f"[9] {label}: node format {quant} asked, {resolved} resolved")
    check(resolved == quant, f"{label}: node format {resolved}, not {quant}")
    return resolved


def quant_kernel_checks(device) -> dict:
    """Phase 9's kernels against their plain versions at node formats 1 and
    2 (the counts read after each launch name the tier) on every lane of
    QUANT_SIDE x QUANT_SIDE x CHECK_SAMPLES rays: row 3 TLAS on frame 1 of
    02 (4 bounces); row 4 TLAS with its vote and key passes on every launch
    of a deep wavefront frame (the hit column, the key pass fed it, the
    votes); the flat rows at one format each (row 3 at 1, row 4 at 2 on
    bounces 0 and 1, row 6 at 1 on the mixed launch of a 2-frame deep pool
    window) and the canonical walk of a ``median``, ``wide=2`` build (row 4
    TLAS at 1 on bounces 0 and 1, its key from the kernel's epilogue); and
    the quantized TLAS words the card computes against the CPU's. Returns
    the launches checked and the plain versions' work counters of row 3
    TLAS's launch at formats 1 and 2, for its bound (format 0's: phase 5's,
    on the kernels line)."""
    import torch

    from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.mesh import scene_mesh_set
    from tpu_render_cluster_torch.render.scene import build_scene

    mesh_scene, deep = PATHS[1].scene, PATHS[2].scene
    checked: dict[str, int] = {}
    counters: dict[str, dict] = {}
    # The earlier phases' cached blocks slow the plain versions' allocations.
    torch.cuda.empty_cache()

    def rays(name):
        return integrator.frame_rays_and_seed(scene_camera(name, 1, device), 1, width=QUANT_SIDE,
                                              height=QUANT_SIDE, samples=CHECK_SAMPLES)

    def launched(name, quant, expected=1):
        got = kernels.counts.get(kernels.quant_name(name, quant), 0)
        check(got == expected, f"{name} at format {quant}: {got} launches, not {expected}")

    # A frame's TLAS quantized on the card holds the words the CPU computes
    # (tests/test_torch_bvhq.py holds those to the reference's).
    for name in (mesh_scene, deep):
        card_mesh = scene_mesh_set(name, 1, device=device)
        host_mesh = scene_mesh_set(name, 1, device="cpu")
        for quant in QUANTS:
            for ordered in (False, True):
                card_table = kernels.tlas_quant_table(card_mesh, quant, ordered)
                host_table = kernels.tlas_quant_table(host_mesh, quant, ordered)
                check(torch.equal(card_table.words.cpu(), host_table.words)
                      and torch.equal(card_table.grid, host_table.grid),
                      f"{name}: the card's TLAS words at format {quant} are not the CPU's")

    # Row 3 TLAS (and flat at format 1) on frame 1 of 02.
    scene = build_scene(mesh_scene, 1, device)
    o, d, seed = rays(mesh_scene)
    mesh = scene_mesh_set(mesh_scene, 1, device=device)
    for quant in QUANTS:
        for tlas in (True, False) if quant == 1 else (True,):
            name = "trace_fused_mesh_tlas" if tlas else "trace_fused_mesh"
            label = f"{name} at format {quant}"
            quant_tier(label, kernels.mesh_quant(mesh, quant, tlas), quant)
            kernels.reset_counts()
            got = kernels.trace_paths_fused_mesh(scene, mesh, o, d, seed, max_bounces=BOUNCES,
                                                 use_tlas=tlas, quant=quant)
            launched(name, quant)
            stats: dict = {}
            want = kernels.trace_paths_fused_mesh_reference(
                scene, mesh, o, d, seed, max_bounces=BOUNCES, use_tlas=tlas, quant=quant,
                stats=stats)
            torch.cuda.synchronize()
            quant_equal(label, got, want)
            checked[label] = checked.get(label, 0) + 1
            if tlas:
                counters[f"{name} {quant}"] = {"stats": stats, "rays": o.shape[0]}

    # Row 4 on every launch of a deep wavefront frame: TLAS at each format
    # (ordered: the vote, the bounce with its hit column, the key pass), the
    # flat kernel at 2, and the canonical walk of a median build at 1.
    scene = build_scene(deep, 1, device)
    o, d, seed = rays(deep)
    cases = [(quant, True, "sah", 4) for quant in QUANTS]
    cases += [(2, False, "sah", 4), (1, True, "median", 2)]
    for quant, tlas, builder, wide in cases:
        mesh = scene_mesh_set(deep, 1, builder, wide, device)
        name = "mesh_bounce_tlas" if tlas else "mesh_bounce"
        ordered = kernels.walks_ordered(mesh.bvh)
        label = f"{name} at format {quant} ({builder}, wide {wide})"
        quant_tier(label, kernels.mesh_quant(mesh, quant, tlas), quant)
        launches: list = []
        compaction.trace_paths_wavefront(scene, o, d, seed, max_bounces=BOUNCES, mesh=mesh,
                                         on_launch=launches.append, use_tlas=tlas, quant=quant)
        # The flat kernel and the canonical walk: bounces 0 and 1.
        for launch in launches[:4 if (tlas and builder == "sah") else 2]:
            args = (*launch.state, launch.live, seed, launch.bounce)
            kernels.reset_counts()
            hits: list = []
            got = kernels.mesh_bounce(scene, mesh, *args, total_bounces=BOUNCES, use_tlas=tlas,
                                      quant=quant, _hits=hits)
            for kernel in kernels.launch_names(name, ordered, quant):
                check(kernels.counts.get(kernel) == 1, f"{label}: {kernel} not launched once")
            plain_hits: list = []
            want = kernels.mesh_bounce_reference(
                scene, mesh, *args, total_bounces=BOUNCES, use_tlas=tlas, quant=quant,
                _hits=plain_hits)
            torch.cuda.synchronize()
            quant_equal(f"{label} bounce {launch.bounce}", got, want)
            if tlas and ordered:
                quant_equal(f"{label} bounce {launch.bounce} hits", hits[0], plain_hits[0])
                table = kernels.tlas_frame(mesh).slots
                votes = kernels.packet_votes(launch.state[1], table, launch.live,
                                             block=kernels.TLAS_BLOCK_R)
                plain_votes = kernels.packet_votes_reference(launch.state[1], table, launch.live,
                                                             block=kernels.TLAS_BLOCK_R)
                for have, expected in zip(votes, plain_votes):
                    check(have is None or torch.equal(have, expected), f"{label}: votes differ")
                keys = kernels.entry_keys(mesh, got.origins, got.directions, got.alive,
                                          launch.live, launch.bounce, total_bounces=BOUNCES,
                                          quant=quant, hits=hits[0])
                plain_keys = kernels.entry_keys_reference(
                    mesh, got.origins, got.directions, got.alive, launch.live, launch.bounce,
                    total_bounces=BOUNCES, quant=quant, hits=hits[0])
                quant_equal(f"{label} bounce {launch.bounce} key pass", keys, plain_keys)
                quant_equal(f"{label} bounce {launch.bounce} key pass vs the launch's key",
                            keys, got.key)
                checked[kernels.quant_name("mesh_entry_keys", quant)] = checked.get(
                    kernels.quant_name("mesh_entry_keys", quant), 0) + 1
            checked[label] = checked.get(label, 0) + 1

    # The flat row 6 at format 1 on the mixed launch of a 2-frame deep
    # window (row 6 TLAS: at the main width, quant_main_checks).
    window = raypool.PoolWindow(deep, [1, 2], width=QUANT_SIDE, height=QUANT_SIDE,
                                samples=CHECK_SAMPLES, max_bounces=BOUNCES, device=device,
                                use_tlas=False, quant=1)
    label = "pool_mesh_bounce at format 1"
    quant_tier(label, kernels.pool_quant(window.mesh_ops, 1, False), 1)
    launches = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    launch = launches[pool_launch_roles(launches, window)["mixed"]]
    live = int(launch.live)
    kernels.reset_counts()
    got = kernels.pool_mesh_bounce(window.ops, *launch.state, live, total_bounces=BOUNCES,
                                   use_tlas=False, quant=1)
    launched("pool_mesh_bounce", 1)
    want = kernels.pool_mesh_bounce_reference(window.ops, *launch.state, live,
                                              total_bounces=BOUNCES, use_tlas=False, quant=1)
    torch.cuda.synchronize()
    quant_equal(f"{label} mixed launch", got, want)
    checked[label] = 1
    print(f"[9] node formats: launches held bit-equal to their plain versions: "
          f"{json.dumps(checked)}")
    return {"checked": checked, "counters": counters}


def quant_main_checks(device, pool_first: dict) -> dict:
    """Phase 9's kernels against their plain versions at node formats 1 and
    2 at the main paths' widths, the group size, persistence and windows
    of the main path's launches: row 4 TLAS at the deep wavefront's
    bounce-0 launch (2,097,152 lanes; the bounce is the same at every
    format) on every lane, its plain version on SUBSET of them drawn as
    whole packets (a lane's result depends on its packet's votes alone),
    the hit column too, and the key pass fed that hit column on every lane
    (its persistent blocks) against its plain version and the launch's key
    column; row 6 TLAS on every lane of the first, mixed and last launches
    of phase 3's first deep window (8 frames, 65,536 lanes; phase 3's
    inputs), its stacked TLAS quantized on the card against the CPU's
    words. Returns the launches checked, the plain versions' work counters
    of row 4 TLAS (the drawn lanes) and row 6 TLAS (the mixed launch) for
    the bounds, and the inputs, for ``quant_times``."""
    import ctypes

    import torch

    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.mesh import scene_mesh_set
    from tpu_render_cluster_torch.render.scene import build_scene

    deep = PATHS[2].scene
    checked: dict[str, int] = {}
    counters: dict[str, dict] = {}
    trace, rays, launches = deep_launches("mesh_bounce_tlas", device)
    launch, mesh, seed = launches[0], trace.mesh, rays[2]
    lanes = launch.bucket
    check(launch.bounce == 0 and lanes == WIDTH * HEIGHT * SAMPLES,
          f"the deep bounce-0 launch holds {lanes} lanes")
    group = kernels.bounce_group(lanes, kernels.thread_slots(device.index or 0))
    generator = torch.Generator(device=device).manual_seed(16)
    rows = packet_rows(lanes, kernels.TLAS_BLOCK_R, SUBSET, generator, device)
    drawn = tuple(t[rows] for t in launch.state)
    drawn_live = int((rows < launch.live).sum())
    frame = kernels.tlas_frame(mesh)
    query = occupancy_entry("mesh_entry_keys",
                            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int])
    for quant in QUANTS:
        label = f"mesh_bounce_tlas at format {quant}, the deep bounce-0 launch"
        quant_tier(label, kernels.mesh_quant(mesh, quant, True), quant)
        kernels.reset_counts()
        hits: list = []
        got = kernels.mesh_bounce(trace.scene, mesh, *launch.state, launch.live, seed, 0,
                                  total_bounces=BOUNCES, quant=quant, _hits=hits)
        for kernel in kernels.launch_names("mesh_bounce_tlas", True, quant):
            check(kernels.counts.get(kernel) == 1, f"{label}: {kernel} not launched once")
        stats: dict = {}
        plain_hits: list = []
        want = kernels.mesh_bounce_reference(
            trace.scene, mesh, *drawn, drawn_live, seed, 0, total_bounces=BOUNCES, quant=quant,
            stats=stats, _hits=plain_hits)
        torch.cuda.synchronize()
        quant_equal(f"{label} (G {group}, {rows.numel()} lanes drawn)",
                    type(got)(*(t[rows] for t in got)), want)
        quant_equal(f"{label} hits", hits[0][rows], plain_hits[0])
        counters[f"mesh_bounce_tlas {quant}"] = {"stats": stats, "rays": rows.numel()}
        checked[label] = 1
        persistent, staged, grid = (ctypes.c_int() for _ in range(3))
        blocks = query(lanes, frame.slots.shape[0], frame.node_bounds.shape[0],
                       ctypes.addressof(persistent), ctypes.addressof(staged),
                       ctypes.addressof(grid), quant)
        check(blocks > 0 and bool(persistent.value),
              f"mesh_entry_keys at format {quant} and {lanes} lanes: not persistent ({blocks})")
        args = (mesh, got.origins, got.directions, got.alive, launch.live, 0)
        keys = kernels.entry_keys(*args, total_bounces=BOUNCES, quant=quant, hits=hits[0])
        plain_keys = kernels.entry_keys_reference(*args, total_bounces=BOUNCES, quant=quant,
                                                  hits=hits[0])
        torch.cuda.synchronize()
        key_label = f"mesh_entry_keys at format {quant}, the deep bounce-0 launch"
        quant_equal(key_label, keys, plain_keys)
        quant_equal(f"{key_label} vs the launch's key column", keys, got.key)
        checked[kernels.quant_name("mesh_entry_keys", quant)] = 1
        print(f"[9] {label}: G {group}, {lanes} lanes through the kernel, {rows.numel()} drawn "
              f"for its plain version, bit-equal with the hit column; the key pass persistent "
              f"({grid.value} blocks), its {lanes} keys bit-equal to its plain version's and the "
              f"launch's")

    window = pool_first["window"]
    frames = window.frames
    host_ops = kernels.pool_mesh_operands([build_scene(deep, f) for f in frames],
                                          [scene_mesh_set(deep, f) for f in frames])
    for quant in QUANTS:
        label = f"pool_mesh_bounce_tlas at format {quant}, the deep main window"
        quant_tier(label, kernels.pool_quant(window.ops, quant, True), quant)
        card_table = kernels.pool_tlas_quant(window.ops, quant)
        host_table = kernels.pool_tlas_quant(host_ops, quant)
        check(torch.equal(card_table.words.cpu(), host_table.words)
              and torch.equal(card_table.grid, host_table.grid),
              f"{label}: the card's stacked TLAS words are not the CPU's")
        done = set()
        for role in ("first", "mixed", "drain"):
            index = pool_first["picked"][role]["index"]
            if index in done:
                continue
            done.add(index)
            step = pool_first["launches"][index]
            live = int(step.live)
            kernels.reset_counts()
            got = kernels.pool_mesh_bounce(window.ops, *step.state, live, total_bounces=BOUNCES,
                                           quant=quant)
            check(kernels.counts.get(kernels.quant_name("pool_mesh_bounce_tlas", quant)) == 1,
                  f"{label}: not launched once")
            stats = {}
            want = kernels.pool_mesh_bounce_reference(
                window.ops, *step.state, live, total_bounces=BOUNCES, quant=quant,
                stats=stats if role == "mixed" else None)
            torch.cuda.synchronize()
            quant_equal(f"{label} {role} launch ({live} of {window.pool} lanes live)", got, want)
            if role == "mixed":
                counters[f"pool_mesh_bounce_tlas {quant}"] = {"stats": stats, "rays": live}
            checked[label] = checked.get(label, 0) + 1
        print(f"[9] {label}: {len(done)} launches of {len(frames)} frames, every lane bit-equal "
              f"to the plain version; the stacked TLAS words the CPU's")
    return {"checked": checked, "counters": counters,
            "inputs": {"trace": trace, "launch": launch, "seed": seed}}


def quant_staged_bytes(device, quant: int, pool_ops) -> dict:
    """The staged bytes a block (and resident blocks per SM) of rows 3, 4
    and 6 TLAS and the key pass at node format ``quant``, on the main
    paths' tables (02's for row 3, the deep scene's for the others; row 4
    and the key pass at the deep wavefront's bounce-0 width; row 6 on the
    first deep window's ``pool_ops``)."""
    import ctypes

    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.mesh import scene_mesh_set

    out = {}
    mesh = scene_mesh_set(PATHS[1].scene, 1, device=device)
    triangles, bounds, _ = kernels._bvh_operands(mesh.bvh)
    shared = ctypes.c_int()
    query = occupancy_entry("trace_fused_mesh_tlas",
                            [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int])
    blocks = query(mesh.instances.translation.shape[0], triangles.shape[0], bounds.shape[0],
                   kernels.tlas_frame(mesh).node_bounds.shape[0],
                   int(kernels.walks_ordered(mesh.bvh)), ctypes.addressof(shared), quant)
    check(blocks > 0, f"trace_fused_mesh_tlas_occupancy at format {quant} failed ({blocks})")
    out["trace_fused_mesh_tlas"] = {"blocks_per_sm": blocks, "shared_bytes": shared.value}
    deep = scene_mesh_set(PATHS[2].scene, 1, device=device)
    lanes = WIDTH * HEIGHT * SAMPLES
    group = kernels.bounce_group(lanes, kernels.thread_slots(device.index or 0))
    out["mesh_bounce_tlas"] = {"group": group, **bounce_occupancy(deep, group, quant)}
    frame = kernels.tlas_frame(deep)
    persistent, staged, grid = (ctypes.c_int() for _ in range(3))
    query = occupancy_entry("mesh_entry_keys",
                            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int])
    blocks = query(lanes, frame.slots.shape[0], frame.node_bounds.shape[0],
                   ctypes.addressof(persistent), ctypes.addressof(staged),
                   ctypes.addressof(grid), quant)
    check(blocks > 0, f"mesh_entry_keys_occupancy at format {quant} failed ({blocks})")
    out["mesh_entry_keys"] = {"blocks_per_sm": blocks, "shared_bytes": staged.value,
                              "persistent": bool(persistent.value)}
    out["pool_mesh_bounce_tlas"] = {"group": kernels.POOL_GROUP,
                                    **pool_occupancy(pool_ops, kernels.POOL_GROUP, quant)}
    return out


def quant_frame_checks(device, pool_ops) -> dict:
    """Phase 9's whole frames through ``TorchRaytraceBackend`` at 512x512, 8
    spp, 4 bounces, each with its resolved node format (the launches' count
    names) and staged bytes a block: 02 at formats 1 and 2 bit-equal to 0;
    the deep wavefront and the deep pool at 1 and 2 within the reference's
    budget of the packed carried state against 0 (linear MAE < 1e-3, uint8
    within 2); and a ``median``, ``wide=1`` and a ``sah``, ``wide=8`` build's
    frame of 02 and of the deep scene (the masked tier) bit-equal to the
    default build's."""
    import torch

    from tpu_render_cluster_torch.render import compaction, integrator, kernels
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    mesh_scene, deep = PATHS[1].scene, PATHS[2].scene
    size = dict(width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES)
    result: dict = {"formats": {}, "builds": {}}

    def tiers_launched():
        names = sorted(k for k, v in kernels.counts.items() if v)
        return names, sorted({int(n.split("[q")[1][0]) if "[q" in n else 0 for n in names
                              if n.split("[")[0] in kernels.QUANT_KERNELS})

    base = {}
    for quant in (0, *QUANTS):
        backend = TorchRaytraceBackend(device=device, quant=quant, **size)
        entry: dict = {"tiers": backend.tiers(), "staged": quant_staged_bytes(device, quant, pool_ops)}
        kernels.reset_counts()
        image = backend._renderer(mesh_scene)(1)
        torch.cuda.synchronize()
        entry["02"], formats = tiers_launched()
        check(formats == [quant], f"02 at format {quant}: launched {entry['02']}")
        kernels.reset_counts()
        linear = compaction.render_frame_wavefront(deep, 1, device=device, **size,
                                                   **backend.tiers())
        entry["03 wavefront"], formats = tiers_launched()
        check(formats == [quant], f"the deep wavefront at format {quant}: {entry['03 wavefront']}")
        kernels.reset_counts()
        window = backend._render_window(deep, [1, 2])
        entry["03 pool"], formats = tiers_launched()
        check(formats == [quant], f"the deep pool at format {quant}: {entry['03 pool']}")
        if quant == 0:
            base = {"02": image, "wavefront": linear, "pool": window}
        else:
            check(torch.equal(image, base["02"]), f"02 at format {quant} differs from format 0")
            budget = {}
            for key, have, want in [("wavefront", linear, base["wavefront"]),
                                    *[(f"pool frame {i + 1}", h, w)
                                      for i, (h, w) in enumerate(zip(window, base["pool"]))]]:
                mae = (have - want).abs().mean().item()
                delta = (integrator.tonemap(have).int() - integrator.tonemap(want).int()).abs()
                budget[key] = {"mae": mae, "uint8_max": int(delta.max()),
                               "bit_equal_share": float((have == want).float().mean())}
                check(mae < PACKED_MAE and budget[key]["uint8_max"] <= PACKED_UINT8,
                      f"{key} at format {quant}: MAE {mae}, uint8 {budget[key]['uint8_max']}")
            entry["against_format_0"] = budget
        result["formats"][quant] = entry
        print(f"[9] frames at node format {quant}: {json.dumps(entry)}")
    for name in (mesh_scene, deep):
        frames = {}
        for builder, wide in ((None, None), ("median", 1), ("sah", 8)):
            backend = TorchRaytraceBackend(device=device, wavefront="off", bvh_builder=builder,
                                           bvh_wide=wide, **size)
            frames[builder, wide] = backend._renderer(name)(1)
        default = frames[None, None]
        for (builder, wide), image in frames.items():
            check(torch.equal(image, default), f"{name} ({builder}, wide {wide}) differs")
        result["builds"][name] = ["sah 4 (default)", "median 1", "sah 8"]
    print(f"[9] masked frames of 02 and the deep scene: the median, wide=1 and the sah, wide=8 "
          f"builds bit-equal to the default build's")
    return result


def quant_times(device, pool_first: dict, counters: dict, inputs: dict) -> dict:
    """Phase 9's times: rows 3, 4 and 6 TLAS (with row 4's key pass) alone
    under the profiler at node formats 0, 1 and 2 in turns (0, 1, 2, 2, 1,
    0), at the main paths' widths: row 3 TLAS on frame 1 of 02 (2,097,152
    rays), row 4 TLAS at the deep wavefront's bounce-0 launch (2,097,152
    lanes, ``inputs``), row 6 TLAS at the mixed launch of phase 3's first
    deep window (65,536 lanes); each beside its bound from the plain
    version's counters at that format (row 3: phase 9's small check
    launch; rows 4 and 6: ``quant_main_checks``'), scaled to the timed
    width."""
    import statistics as stats_module

    from tpu_render_cluster_torch.render import kernels

    trace = Trace("trace_fused_mesh_tlas", PATHS[1].scene, 1, device)
    rays02 = frame_rays(PATHS[1].scene, 1, device)
    deep_trace, bounce0, deep_seed = inputs["trace"], inputs["launch"], inputs["seed"]
    window = pool_first["window"]
    mixed = pool_first["launches"][pool_first["picked"]["mixed"]["index"]]
    rows = {
        "trace_fused_mesh_tlas": (lambda q: kernels.trace_paths_fused_mesh(
            trace.scene, trace.mesh, *rays02, max_bounces=BOUNCES, quant=q), 1,
            rays02[0].shape[0], MEGAKERNEL_RAY_BYTES),
        "mesh_bounce_tlas": (lambda q: kernels.mesh_bounce(
            deep_trace.scene, deep_trace.mesh, *bounce0.state, bounce0.live, deep_seed, 0,
            total_bounces=BOUNCES, quant=q), 2, bounce0.bucket, BOUNCE_RAY_BYTES + KEY_BYTES),
        "pool_mesh_bounce_tlas": (lambda q: kernels.pool_mesh_bounce(
            window.ops, *mixed.state, int(mixed.live), total_bounces=BOUNCES, quant=q), 1,
            int(mixed.live), POOL_RAY_BYTES + KEY_BYTES),
    }
    out: dict = {}
    for row, (call, kernels_a_call, width, ray_bytes) in rows.items():
        names = (row, "mesh_entry_keys") if row == "mesh_bounce_tlas" else (row,)
        turns = []
        for quant in (0, 1, 2, 2, 1, 0):
            once = lambda q=quant: call(q)  # noqa: E731
            cuda_ms(once, 2)
            ms = stats_module.median(cuda_ms(once, 5) for _ in range(3))
            profile = profiled(lambda: [once() for _ in range(5)], names,
                               f"[9] {row} at format {quant}", tries=6,
                               launches=5 * len(names))
            turns.append({"quant": quant, "ms": ms, "alone_ms": None if profile is None else {
                name: profile["per_kernel"][name] / 5 for name in names}})
        entry = {"width": width, "turns": turns}
        for quant in (0, *QUANTS):
            mine = [t for t in turns if t["quant"] == quant]
            alone = [t["alone_ms"] for t in mine]
            entry[quant] = {
                "ms": stats_module.mean(t["ms"] for t in mine),
                "alone_ms": None if None in alone else {
                    name: stats_module.mean(a[name] for a in alone) for name in names},
            }
            if row == "mesh_bounce_tlas":
                # The key pass moves a lane's origin, direction, alive and key,
                # and on a quantized format reads its hit slot too.
                key_bytes = width * (KEY_PASS_RAY_BYTES + (4 if quant else 0))
                entry[quant]["key_pass_bound_ms"] = key_bytes / MEMORY_BYTES_PER_S * 1e3
            counted = counters.get(f"{row} {quant}")
            if counted is not None:
                scale = width / counted["rays"]
                least = bound(counted["stats"], width * ray_bytes, scale)
                entry[quant]["bound_ms"] = least["ms"]
                entry[quant]["bound_by"] = least["by"]
                entry[quant]["node_tests_per_ray"] = (
                    counted["stats"].get("node_tests", 0) / counted["rays"])
        out[row] = entry
        print(f"[9] {row} at node formats 0, 1, 2 (alone ms under the profiler, in turns; the "
              f"bound scaled from the check launch's counters): {json.dumps(entry)}")
    return out


def quant_phase(card: str, device, pool_first: dict, processes: list | None = None) -> dict:
    """Phase 9: the node formats, checked, framed and timed (the worker at
    format 1 runs in phase 8, ``WIRE_JOBS``). ``processes``: check processes
    started with it (``CheckProcess``), the first its checks at QUANT_SIDE
    (``quant``), all joined before its times; without them those checks
    run here."""
    started = time.perf_counter()
    if processes is None:
        checks = quant_kernel_checks(device)
        print(f"[9] kernel checks at {QUANT_SIDE}x{QUANT_SIDE} in "
              f"{time.perf_counter() - started:.1f} s")
    main = quant_main_checks(device, pool_first)
    print(f"[9] kernel checks at the main widths in {time.perf_counter() - started:.1f} s")
    frames = quant_frame_checks(device, pool_first["window"].ops)
    print(f"[9] frames in {time.perf_counter() - started:.1f} s")
    if processes is not None:
        checks = processes[0].wait()
        for process in processes[1:]:
            process.wait()
        print(f"[9] kernel checks at {QUANT_SIDE}x{QUANT_SIDE} and phase 11's kernel checks "
              f"({len(processes)} processes beside the above) joined in "
              f"{time.perf_counter() - started:.1f} s")
    times = quant_times(device, pool_first, {**checks["counters"], **main["counters"]},
                        main["inputs"])
    print(f"[9] node-format times on {card} in {time.perf_counter() - started:.1f} s")
    checked = dict(checks["checked"])
    for label, count in main["checked"].items():
        checked[label] = checked.get(label, 0) + count
    return {"checked": checked, "frames": frames, "times": times}


# -- 10. sharding: the multi-GPU slice on one card ---------------------------

# The sharded paths of phase 10 (a): each scene's job through the backend
# with ``sharding`` set, its PNGs held against the default path's of the
# same frames; the launches a sharded frame must make (the deep scene:
# the masked deep loop, a launch of row 4 TLAS and its passes a bounce).
SHARDED_PATHS = (
    ("04_very-simple", SPHERE_JOB, 2, {"trace_fused": 1}),
    ("02_physics-mesh", MESH_JOB, 2, {"trace_fused_mesh_tlas": 1}),
    ("03_physics-2-mesh", DEEP_JOB, 1,
     {"mesh_bounce_tlas": BOUNCES, "mesh_entry_keys": BOUNCES, "packet_octants": BOUNCES}),
)
SHARDS = 4  # phase 10 (b): an n-shard decomposition on the one card
# Phase 10 (b)'s bounces by scene: the deep scene's plain per-bounce walk
# takes about 3 s a launch on an H100 whatever its width (a Python sweep),
# and its 4 bands at 4 bounces took 51 s; at 2 they cover bounce 0 (the
# broadphase keys) and a launch sorted by the kernel's key column.
DECOMPOSITION_BOUNCES = {"03_physics-2-mesh": 2}
SHARDING_TOLERANCE = (
    "a one-card mesh's PNGs bit-equal to the default paths'; each of 4 shards and their "
    "composition bit-equal to the same rendered with the plain versions on the card (row 1, "
    "and rows 3 and 4 TLAS on the octant-ordered walk; else >= 99.9% of rays within 1e-4)"
)


@contextlib.contextmanager
def plain_tracing():
    """The integrator's kernel calls (rows 1, 3 and 4) through the plain
    versions, on the tensors' device."""
    from tpu_render_cluster_torch.render import kernels

    names = ("trace_paths_fused", "trace_paths_fused_mesh", "mesh_bounce")
    saved = {name: getattr(kernels, name) for name in names}
    try:
        for name in names:
            setattr(kernels, name, getattr(kernels, f"{name}_reference"))
        yield
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)


def backend_frames(scene: str, job_file: str, frames: int, **options) -> dict:
    """The first ``frames`` frames of a job through a fresh backend on the
    card after its warm-up, the counts zeroed just before and read just
    after: the PNGs' pixels, frames/s on the host and the launches, and
    every wavefront or pool launch the backend reported."""
    import numpy as np
    import torch
    from PIL import Image

    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    job = BlenderJob.load_from_file(REPO / job_file)
    chosen = list(job.frame_indices())[:frames]
    reported: list = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as base:
        backend = TorchRaytraceBackend(
            width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES,
            base_directory=base, on_launch=reported.append, on_iteration=reported.append,
            **options,
        )
        backend.warm(job.job_name)
        torch.cuda.synchronize()
        kernels.reset_counts()
        reported.clear()
        started = time.perf_counter()
        for frame in chosen:
            asyncio.run(backend.render_frame(job, frame))
        elapsed = time.perf_counter() - started
        launches = {k: v for k, v in kernels.counts.items() if v}
        outputs = sorted((Path(base) / "blender-projects").rglob("*.png"))
        check(len(outputs) == len(chosen), f"{scene} {options}: {len(outputs)} PNGs")
        pixels = [np.array(Image.open(output)) for output in outputs]
    return {"pixels": pixels, "fps": len(chosen) / elapsed, "launches": launches,
            "reported": len(reported), "frames": chosen}


def sharded_backend_checks(card: str, runs: dict | None) -> dict:
    """Phase 10 (a): each scene's frames through the backend on a one-card
    mesh, ``sharding`` tile and spp, held bit for bit against the default
    path's frames rendered here (the deep scene's: the masked deep loop,
    ``wavefront="off"``), and against phase 4's where it ran; no wavefront
    or pool launch, and the launches of one masked frame each frame."""
    import numpy as np

    defaults = {"04_very-simple": "trace_fused", "02_physics-mesh": "trace_fused_mesh_tlas"}
    result: dict = {}
    for scene, job_file, frames, per_frame in SHARDED_PATHS:
        default = backend_frames(scene, job_file, frames, wavefront="off", raypool="off")
        earlier = (runs or {}).get(defaults.get(scene), {}).get("images")
        result[scene] = {"default_fps": [default["fps"]]}
        for mode in ("tile", "spp"):
            # The pool and the wavefront forced on: sharding still takes neither.
            got = backend_frames(scene, job_file, frames, sharding=mode, wavefront="force",
                                 raypool="force")
            expected = {name: count * frames for name, count in per_frame.items()}
            check(got["launches"] == expected and got["reported"] == 0,
                  f"{scene} sharding={mode}: launches {got['launches']} (expected {expected}), "
                  f"{got['reported']} wavefront or pool launches reported")
            for index, (image, want) in enumerate(zip(got["pixels"], default["pixels"])):
                check(image.shape == (HEIGHT, WIDTH, 3) and image.astype(np.float32).std() > 5.0,
                      f"{scene} sharding={mode} frame {got['frames'][index]}: {image.shape}")
                check(np.array_equal(image, want),
                      f"{scene} sharding={mode} frame {got['frames'][index]}: not the default "
                      f"path's PNG")
                if earlier is not None:
                    check(np.array_equal(image, earlier[index].numpy()),
                          f"{scene} sharding={mode}: not phase 4's PNG")
            result[scene][mode] = {"fps": got["fps"], "launches": got["launches"],
                                   "pixels": got["pixels"]}
            print(f"[10] {scene} sharding={mode}, one-card mesh: {frames} frames at "
                  f"{got['fps']:.4f} frames/s (the default path before it {default['fps']:.4f}); "
                  f"launches {got['launches']}, none of the wavefront or pool; PNGs bit-equal "
                  f"to the default path's{' and to phase 4' + chr(39) + 's' if earlier is not None else ''}; "
                  f"{card}")
        # The default path again: its frames/s before and after the sharded
        # ones bracket the host's drift in this call.
        again = backend_frames(scene, job_file, frames, wavefront="off", raypool="off")
        check(all(np.array_equal(a, b) for a, b in zip(again["pixels"], default["pixels"])),
              f"{scene}: the default path's PNGs changed between its two runs")
        result[scene]["default_fps"].append(again["fps"])
        print(f"[10] {scene} default path, frames/s before and after the sharded runs: "
              f"{result[scene]['default_fps']}; {card}")
    return result


def shard_decomposition_checks(card: str, device) -> dict:
    """Phase 10 (b): a SHARDS-shard decomposition on the one card at phase
    3's check size, through the per-shard function: tile bands and spp
    subsets of 04 and 02, bands of the deep scene; each shard and the
    composed frame against the same rendered with the plain versions."""
    import torch

    from tpu_render_cluster_torch.parallel import sharded_render
    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.mesh import scene_mesh_set

    frame = 2
    cases = [("04_very-simple", "tile"), ("04_very-simple", "spp"), ("02_physics-mesh", "tile"),
             ("02_physics-mesh", "spp"), ("03_physics-2-mesh", "tile")]
    result: dict = {}
    for scene, mode in cases:
        started = time.perf_counter()
        plan = sharded_render.shard_plan(mode, SHARDS, height=CHECK_SIDE, samples=CHECK_SAMPLES)
        bounces = DECOMPOSITION_BOUNCES.get(scene, BOUNCES)
        options = dict(width=CHECK_SIDE, height=CHECK_SIDE, max_bounces=bounces, device=device)
        kernels.reset_counts()
        shards = [sharded_render.render_shard(scene, frame, shard, **options) for shard in plan]
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.counts.items() if v}
        check(not any(name.endswith("_reference") for name in launches),
              f"{scene} {mode}: a plain version ran in the kernels' shards ({launches})")
        with plain_tracing():
            plain = [sharded_render.render_shard(scene, frame, shard, **options) for shard in plan]
        mesh = scene_mesh_set(scene, frame, device=device)
        exact = mesh is None or kernels.walks_ordered(mesh.bvh)
        shares = []
        for index, (got, want) in enumerate(zip(shards + [sharded_render.compose(mode, shards)],
                                                plain + [sharded_render.compose(mode, plain)])):
            label = f"{scene} {mode} " + (f"shard {index}" if index < SHARDS else "composed")
            check(torch.isfinite(got).all().item(), f"{label}: non-finite radiance")
            fraction, bad, err = agreement(got.reshape(-1, 3), want.reshape(-1, 3))
            bit_equal = torch.equal(got, want)
            shares.append(fraction)
            if exact:
                check(bit_equal, f"{label}: not bit-equal to the plain versions (max abs err {err})")
            else:
                check(fraction >= 0.999, f"{label}: {fraction} of rays within 1e-4")
        result[f"{scene} {mode}"] = {"launches": launches, "within_1e-4": min(shares),
                                     "bit_equal": exact, "bounces": bounces,
                                     "s": time.perf_counter() - started}
        print(f"[10] {scene} {mode}, {SHARDS} shards at {CHECK_SIDE}x{CHECK_SIDE}x{CHECK_SAMPLES} "
              f"spp, {bounces} bounces, on one card: launches {launches}; every shard and the composed frame "
              f"{'bit-equal to' if exact else 'within 1e-4 of'} the plain versions' "
              f"({time.perf_counter() - started:.1f} s); {card}")
    return result


def nccl_group_checks(card: str, expected: dict) -> dict:
    """Phase 10 (c): a ``torch.distributed`` group of this one process over
    NCCL on a free localhost port; ``render_frame_sharded`` in both modes
    on 04 frame 1 (the collectives run) bit-equal to (a)'s PNG."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_render_cluster_torch.parallel import mesh, sharded_render
    from tpu_render_cluster_torch.render.integrator import tonemap

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    started = time.perf_counter()
    check(mesh.initialize_multihost(f"127.0.0.1:{port}", 1, 0) is True, "no process group")
    result: dict = {}
    try:
        check(dist.get_backend() == "nccl", f"the group runs {dist.get_backend()}")
        for mode in ("tile", "spp"):
            linear = sharded_render.render_frame_sharded(
                "04_very-simple", 1, width=WIDTH, height=HEIGHT, samples=SAMPLES,
                max_bounces=BOUNCES, mode=mode,
            )
            image = tonemap(linear).cpu().numpy()
            check(np.array_equal(image, expected[mode]["pixels"][0]),
                  f"04 frame 1 sharding={mode} in an NCCL group: not (a)'s PNG")
            result[mode] = "bit-equal"
    finally:
        dist.destroy_process_group()
    result["s"] = time.perf_counter() - started
    print(f"[10] an NCCL group of one process (tcp://127.0.0.1:{port}): 04 frame 1 in tile and "
          f"spp mode bit-equal to (a)'s PNGs, in {result['s']:.1f} s; {card}")
    return result


def sharding_phase(card: str, device, runs: dict | None = None) -> dict:
    """Phase 10: the sharded renderer on the one card, (a)-(c) (the wire
    worker started with ``--sharding tile`` runs in phase 8,
    ``WIRE_JOBS``)."""
    started = time.perf_counter()
    backend = sharded_backend_checks(card, runs)
    print(f"[10] (a) in {time.perf_counter() - started:.1f} s")
    decompositions = shard_decomposition_checks(card, device)
    print(f"[10] (b) in {time.perf_counter() - started:.1f} s")
    group = nccl_group_checks(card, backend["04_very-simple"])
    summary = {
        "card": card, "tolerance": SHARDING_TOLERANCE,
        "one_card_mesh": {
            scene: {"default_fps": r["default_fps"],
                    **{mode: {"fps": r[mode]["fps"], "launches": r[mode]["launches"]}
                       for mode in ("tile", "spp")}}
            for scene, r in backend.items()
        },
        "decompositions": decompositions, "nccl_group": group,
        "s": time.perf_counter() - started,
    }
    print(f"[10] sharding phase on {card}: {json.dumps(summary)}")
    return summary


# -- 11. the TLAS tiers: the reference's TRC_TLAS_BLOCK, TRC_TLAS_LEAF,
# TRC_RAYPOOL_FRAMES and TRC_RAYPOOL_WIDTH ----------------------------------

# The TLAS kernels' packets built beside the default 256 (one library a
# width, ``_build.variant``) and the leaves run at the default packet: phase
# 11's (packet, leaf) configurations.
TIER_PACKETS = (128, 512, 1024)
TIER_LEAVES = (1, 8, 16)
TIER_CONFIGS = (*((packet, 4) for packet in TIER_PACKETS), *((256, leaf) for leaf in TIER_LEAVES))
# The kernels of the TLAS packet: their sources and the TPU kernel each
# replaces (the width a build of the same source).
TIER_KERNELS = ("trace_fused_mesh_tlas", "mesh_bounce_tlas", "mesh_entry_keys", "packet_octants",
                "pool_mesh_bounce_tlas")
TIER_TOLERANCE = (
    "bit-equal to the plain version at the same packet and leaf on every output of every lane "
    "of the main-width launch (max_abs_err: the largest difference measured over the float "
    "outputs; integer and boolean outputs equal)"
)
# Phase 11's pool windows beside the per-width ones: TRC_RAYPOOL_FRAMES=16
# over 16 frames, and TRC_RAYPOOL_WIDTH at twice the default width.
TIER_POOL_FRAMES = 16
TIER_POOL_WIDTH = 2 * 64 * 1024
# One short 03 job to a worker started with the TLAS tiers in its
# environment; its PNGs and launches against the in-process render's there.
TIER_WIRE_JOB = WireJob(
    "03_physics-2-mesh", 4, 'strategy_type = "eager-naive-coarse"\ntarget_queue_size = 4',
    ("mesh_bounce_tlas[p128]", "mesh_entry_keys[p128]", "pool_mesh_bounce_tlas[p128]",
     "packet_octants[p128]"), True, env=(("TRC_TLAS_BLOCK", "128"), ("TRC_TLAS_LEAF", "8")),
)


class WidthBuilds:
    """The width builds of the TLAS kernels (``_build.packet_variants``),
    started in a thread of their own: phases 3-8 use none of them.
    ``wait`` joins it, checks that every one was built and prints ptxas's
    lines of each; it returns the seconds the builds took. ``stop`` ends
    the nvcc processes that still run and joins the thread."""

    def __init__(self) -> None:
        import threading

        from tpu_render_cluster_torch.render import _build

        self.names = _build.packet_variants()
        self.error: BaseException | None = None
        self.libraries: dict = {}
        self.processes: list = []
        self.seconds = 0.0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        from tpu_render_cluster_torch.render import _build

        started = time.perf_counter()
        try:
            self.libraries = _build.build(self.names, processes=self.processes)
        except BaseException as error:  # noqa: BLE001 - raised in wait()
            self.error = error
        self.seconds = time.perf_counter() - started

    def stop(self) -> None:
        from tpu_render_cluster_torch.render import _build

        while self.thread.is_alive():  # the thread may still be starting nvcc
            for process in list(self.processes):
                _build.end(process)
            self.thread.join(timeout=1)

    def wait(self) -> float:
        from tpu_render_cluster_torch.render import _build

        self.thread.join()
        if self.error is not None:
            raise self.error
        check(sorted(self.libraries) == sorted(self.names),
              f"width builds {sorted(self.libraries)} != {sorted(self.names)}")
        print(f"[11] built {self.names} in {self.seconds:.2f} s, beside phases 3-8")
        for name in self.names:
            for line in _build.resource_lines(_build.build_logs.get(name, "")):
                print(f"    {name}: {line}")
        return self.seconds


def tier_label(packet: int, leaf: int) -> str:
    return f"packet {packet}, leaf {leaf}"


# The MeshSets and pool operands of each leaf, built once (``tier_meshes``).
_TIER_MESHES: dict = {}


def tier_meshes(device, leaf: int, window) -> dict:
    """The main paths' frame-1 MeshSets of 02 and the deep scene, and the
    first deep pool window's operands, at TLAS leaf ``leaf`` (the default
    leaf's: the window's own), built once per leaf and window."""
    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.mesh import scene_mesh_set
    from tpu_render_cluster_torch.render.scene import build_scene

    key = (leaf, id(window))
    if key in _TIER_MESHES:
        return _TIER_MESHES[key][1]
    mesh_scene, deep = PATHS[1].scene, PATHS[2].scene
    ops = window.ops
    if leaf != kernels.TLAS_LEAF:
        ops = kernels.pool_mesh_operands(
            [build_scene(deep, f, device) for f in window.frames],
            [scene_mesh_set(deep, f, device=device, leaf=leaf) for f in window.frames])
    meshes = {"02": scene_mesh_set(mesh_scene, 1, device=device, leaf=leaf),
              "deep": scene_mesh_set(deep, 1, device=device, leaf=leaf), "pool": ops}
    _TIER_MESHES[key] = (window, meshes)  # the window held: its id is not reused
    return meshes


def tier_equal(label: str, got, want) -> float:
    """``quant_equal`` of a launch against its plain version, and the
    largest absolute difference over their float outputs, measured (0.0
    when they are equal to the bit)."""
    if isinstance(got, tuple) and not hasattr(got, "_fields"):  # a tuple of outputs
        return max(tier_equal(f"{label}, output {index}", have, expected)
                   for index, (have, expected) in enumerate(zip(got, want)))
    pairs = list(zip(got, want)) if hasattr(got, "_fields") else [(got, want)]
    err = 0.0
    for have, expected in pairs:
        if have is not None and expected is not None and have.is_floating_point():
            err = max(err, (have.double() - expected.double()).abs().max().item())
    print(f"[11] {label}: max abs err {err!r}")
    quant_equal(label, got, want)
    return err


def tier_inputs(device, pool_first: dict) -> dict:
    """Phase 11's launches at the main paths' widths: the deep wavefront's
    bounce-0 launch (2,097,152 lanes), 02 frame 1's rays (2,097,152) and
    the mixed launch of phase 3's first deep window (8 frames, 65,536
    lanes)."""
    trace, rays, launches = deep_launches("mesh_bounce_tlas", device)
    launch = launches[0]
    check(launch.bounce == 0 and launch.bucket == WIDTH * HEIGHT * SAMPLES,
          f"the deep bounce-0 launch holds {launch.bucket} lanes")
    return {"trace": trace, "launch": launch, "seed": rays[2],
            "trace02": Trace("trace_fused_mesh_tlas", PATHS[1].scene, 1, device),
            "rays02": frame_rays(PATHS[1].scene, 1, device), "window": pool_first["window"],
            "mixed": pool_first["launches"][pool_first["picked"]["mixed"]["index"]]}


def tier_config_check(device, inputs: dict, packet: int, leaf: int) -> dict:
    """Phase 11's kernels against their plain versions at one (packet,
    leaf), on every lane of ``tier_inputs``' launches: row 4 TLAS, the vote
    and the key pass at the deep bounce 0, row 6 TLAS on the mixed pool
    launch, row 3 TLAS on 02 frame 1. The plain versions run each launch as
    one chunk. Each launch counts under its width's name. Returns, per
    kernel, the measured max abs error, the plain version's ms and work
    counters (for the bounds), and the launches checked."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    trace, launch, seed = inputs["trace"], inputs["launch"], inputs["seed"]
    trace02, rays02, mixed = inputs["trace02"], inputs["rays02"], inputs["mixed"]
    lanes, live6 = launch.bucket, int(mixed.live)
    label = tier_label(packet, leaf)
    checked: dict[str, int] = {}

    def launched(kernel):
        for name in kernels.launch_names(kernel, True, 0, packet):
            got = kernels.counts.get(name, 0)
            check(got == 1, f"{name}: {got} launches, not 1")
            checked[name] = checked.get(name, 0) + 1

    started = time.perf_counter()
    meshes = tier_meshes(device, leaf, inputs["window"])
    deep_mesh = meshes["deep"]
    entry: dict = {}
    # Row 4 TLAS, its vote and its key pass.
    kernels.reset_counts()
    got = kernels.mesh_bounce(trace.scene, deep_mesh, *launch.state, launch.live, seed, 0,
                              total_bounces=BOUNCES, tlas_block=packet)
    launched("mesh_bounce_tlas")
    stats: dict = {}
    out: list = []
    ms = cuda_ms(lambda: out.append(kernels.mesh_bounce_reference(
        trace.scene, deep_mesh, *launch.state, launch.live, seed, 0, total_bounces=BOUNCES,
        tlas_block=packet, stats=stats, chunk_rays=lanes)), 1)
    err = tier_equal(f"mesh_bounce_tlas at {label}", got, out[0])
    entry["mesh_bounce_tlas"] = {"plain_ms": ms, "plain_rays": lanes, "stats": stats, "err": err}
    del out
    slots = kernels.tlas_frame(deep_mesh).slots
    votes = kernels.packet_votes(launch.state[1], slots, launch.live, block=packet)
    out = []
    ms = cuda_ms(lambda: out.append(kernels.packet_votes_reference(
        launch.state[1], slots, launch.live, block=packet)), 1)
    err = tier_equal(f"packet_octants at {label}", tuple(votes), tuple(out[0]))
    entry["packet_octants"] = {"plain_ms": ms, "plain_rays": lanes, "slots": slots.shape[0],
                               "err": err}
    key_stats: dict = {}
    args = (deep_mesh, got.origins, got.directions, got.alive, launch.live, 0)
    keys = kernels.entry_keys(*args, total_bounces=BOUNCES, tlas_block=packet)
    out = []
    ms = cuda_ms(lambda: out.append(kernels.entry_keys_reference(
        *args, total_bounces=BOUNCES, tlas_block=packet, stats=key_stats)), 1)
    err = max(tier_equal(f"mesh_entry_keys at {label}", keys, out[0]),
              tier_equal(f"mesh_entry_keys at {label} vs the launch's key column", keys,
                         got.key))
    entry["mesh_entry_keys"] = {"plain_ms": ms, "plain_rays": lanes, "stats": key_stats,
                                "err": err}
    del got, keys, out
    # Row 6 TLAS on the mixed launch.
    kernels.reset_counts()
    got6 = kernels.pool_mesh_bounce(meshes["pool"], *mixed.state, live6, total_bounces=BOUNCES,
                                    tlas_block=packet)
    launched("pool_mesh_bounce_tlas")
    stats6: dict = {}
    out = []
    ms = cuda_ms(lambda: out.append(kernels.pool_mesh_bounce_reference(
        meshes["pool"], *mixed.state, live6, total_bounces=BOUNCES, tlas_block=packet,
        stats=stats6)), 1)
    err = tier_equal(f"pool_mesh_bounce_tlas at {label}, the mixed launch", got6, out[0])
    entry["pool_mesh_bounce_tlas"] = {"plain_ms": ms, "plain_rays": live6, "stats": stats6,
                                      "err": err}
    del got6, out
    # Row 3 TLAS on 02 frame 1.
    kernels.reset_counts()
    got3 = kernels.trace_paths_fused_mesh(trace02.scene, meshes["02"], *rays02,
                                          max_bounces=BOUNCES, tlas_block=packet)
    launched("trace_fused_mesh_tlas")
    rays3 = rays02[0].shape[0]
    stats3: dict = {}
    out = []
    ms = cuda_ms(lambda: out.append(kernels.trace_paths_fused_mesh_reference(
        trace02.scene, meshes["02"], *rays02, max_bounces=BOUNCES, tlas_block=packet,
        stats=stats3, chunk_rays=rays3)), 1)
    err = tier_equal(f"trace_fused_mesh_tlas at {label}, 02 frame 1", got3, out[0])
    check(bool(torch.isfinite(got3).all()), f"trace_fused_mesh_tlas at {label}: not finite")
    entry["trace_fused_mesh_tlas"] = {"plain_ms": ms, "plain_rays": rays3, "stats": stats3,
                                      "err": err}
    del got3, out
    torch.cuda.empty_cache()
    print(f"[11] {label}: rows 3, 4 and 6 TLAS, the vote and the key pass bit-equal to their "
          f"plain versions on every lane at the main widths ({lanes} lanes at the deep bounce "
          f"0; the mixed pool launch's {live6} lanes; 02 frame 1's {rays3} rays) in "
          f"{time.perf_counter() - started:.1f} s")
    return {"entry": entry, "checked": checked}


# Checks that run in processes of their own (``CheckProcess``), started
# at phase 9: phase 9's checks at QUANT_SIDE and phase 11's kernel checks,
# TIER_CONFIGS shared among TIER_CHECK_PROCESSES. The plain walks are bound
# by the host's Python, one core each, so side by side they take the time
# of the longest while the parent runs phase 9's checks at the main widths;
# all are joined before phase 9's times. Their plain versions' ms are
# taken so, beside each other.
CHECK_FLAG = "--checks"
TIER_CHECK_PROCESSES = 3


def check_process(job: str) -> int:
    """``chip_smoke.py --checks JOB`` on the card: ``quant`` runs
    ``quant_kernel_checks``; ``tier P:L,...`` runs ``tier_config_check`` at
    each (packet, leaf) on this process's own ``tier_inputs`` (phase 3's
    first deep window made again). The result as one JSON line, last."""
    import torch

    device = torch.device("cuda", 0)
    if job == "quant":
        result = quant_kernel_checks(device)
    else:
        inputs = tier_inputs(device, first_deep_window(device))
        result = []
        for config in job.split()[1].split(","):
            packet, leaf = (int(v) for v in config.split(":"))
            result.append({"packet": packet, "leaf": leaf,
                           **tier_config_check(device, inputs, packet, leaf)})
    print(json.dumps({"check_result": result}))
    return 0


class CheckProcess:
    """``check_process(job)`` in a process of its own, started here; its
    output goes to a file of its own (a pipe the parent does not read while
    it renders would stall it once full). ``wait`` joins it, prints its
    output, fails the run if it failed and returns (and keeps, as
    ``result``) its result; ``stop`` ends it if it still runs."""

    def __init__(self, job: str) -> None:
        self.job = job
        self.result = None
        self.output = tempfile.TemporaryFile("w+")
        self.process = subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), CHECK_FLAG, job], cwd=REPO,
            stdout=self.output, stderr=subprocess.STDOUT, text=True,
        )

    def wait(self):
        if self.result is None:
            self.process.wait(timeout=900)
            self.output.seek(0)
            lines = self.output.read().strip().splitlines()
            print("\n".join(lines[:-1]))
            check(self.process.returncode == 0 and bool(lines)
                  and lines[-1].startswith('{"check_result"'),
                  f"the check process {self.job!r} exited {self.process.returncode}:\n"
                  + "\n".join(lines[-40:]))
            self.result = json.loads(lines[-1])["check_result"]
        return self.result

    def stop(self) -> None:
        if self.process.poll() is None:
            self.process.kill()
            self.process.wait()
        self.output.close()


def tier_check_processes() -> list[CheckProcess]:
    """Phase 11's kernel checks, ``TIER_CONFIGS`` shared among
    TIER_CHECK_PROCESSES processes, started now."""
    shares = [TIER_CONFIGS[i::TIER_CHECK_PROCESSES] for i in range(TIER_CHECK_PROCESSES)]
    return [CheckProcess("tier " + ",".join(f"{packet}:{leaf}" for packet, leaf in share))
            for share in shares]


def tier_check_results(processes: list[CheckProcess]) -> tuple[dict, dict]:
    """The joined processes' results by (packet, leaf), and the launches
    they checked."""
    plain: dict = {}
    checked: dict[str, int] = {}
    for process in processes:
        for result in process.wait():
            plain[(result["packet"], result["leaf"])] = result["entry"]
            for name, count in result["checked"].items():
                checked[name] = checked.get(name, 0) + count
    check(sorted(plain) == sorted(TIER_CONFIGS), f"phase 11 checked {sorted(plain)}")
    return plain, checked


def tier_pass_times(device, inputs: dict, plain: dict) -> None:
    """The vote's and the key pass's wrappers alone on CUDA events at each
    (packet, leaf), at the deep bounce 0 (``timed_ms``), into ``plain``."""
    from tpu_render_cluster_torch.render import kernels

    launch, seed = inputs["launch"], inputs["seed"]
    for packet, leaf in TIER_CONFIGS:
        deep_mesh = tier_meshes(device, leaf, inputs["window"])["deep"]
        got = kernels.mesh_bounce(inputs["trace"].scene, deep_mesh, *launch.state, launch.live,
                                  seed, 0, total_bounces=BOUNCES, tlas_block=packet)
        slots = kernels.tlas_frame(deep_mesh).slots
        entry = plain[(packet, leaf)]
        entry["packet_octants"]["ms"] = timed_ms(lambda: kernels.packet_votes(
            launch.state[1], slots, launch.live, block=packet))
        entry["mesh_entry_keys"]["ms"] = timed_ms(lambda: kernels.entry_keys(
            deep_mesh, got.origins, got.directions, got.alive, launch.live, 0,
            total_bounces=BOUNCES, tlas_block=packet))


def timed_ms(call) -> float:
    """A wrapper's ms per call on CUDA events: the median of 3 runs of 5
    calls after 2 warm-up calls."""
    cuda_ms(call, 2)
    return statistics.median(cuda_ms(call, 5) for _ in range(3))


def tier_resources(device, inputs: dict) -> dict:
    """Per kernel of the TLAS packet and (packet, leaf): the staged bytes a
    block, which route its tables take (staged in shared memory or read
    from global memory), the resident blocks per SM (the ``*_occupancy`` C
    entries of the width's library) and ptxas's registers and spills (the
    width's build), at the main paths' tables: 02's for row 3, the deep
    scene's for row 4 and the key pass (its bounce-0 width), the first deep
    window's for row 6, the deep scene's 48 slots for the vote."""
    import ctypes

    from tpu_render_cluster_torch.render import _build, kernels

    lanes = inputs["launch"].bucket
    group = kernels.bounce_group(lanes, kernels.thread_slots(device.index or 0))
    out: dict = {}
    configs = [(p, 4) for p in (128, 256, 512, 1024)] + [(256, 1), (256, 8), (256, 16)]
    for packet, leaf in configs:
        meshes = tier_meshes(device, leaf, inputs["window"])
        ptxas = {name: _build.resource_lines(_build.build_logs.get(_build.variant(name, packet), ""))
                 for name in TIER_KERNELS}
        row3 = meshes["02"]
        triangles, bounds, _ = kernels._bvh_operands(row3.bvh)
        k3 = row3.instances.translation.shape[0]
        m3 = kernels.tlas_frame(row3).node_bounds.shape[0]
        shared = ctypes.c_int()
        query = occupancy_entry("trace_fused_mesh_tlas",
                                [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int], packet)
        blocks = query(k3, triangles.shape[0], bounds.shape[0], m3, 1, ctypes.addressof(shared), 0)
        check(blocks > 0, f"trace_fused_mesh_tlas_occupancy at packet {packet} failed ({blocks})")
        # The state of a packet and (a BVH of more than one node) the
        # per-instance vote's counts and octants: the bytes a block takes
        # whether or not it stages its tables.
        words = 2 if packet == 1024 else 1
        floor = packet_state_bytes(packet)
        if bounds.shape[0] > 1:
            floor += -(-((4 * words + 1) * k3) // 16) * 16
        row4 = bounce_occupancy(meshes["deep"], group, 0, packet)
        deep_frame = kernels.tlas_frame(meshes["deep"])
        persistent, staged, grid = (ctypes.c_int() for _ in range(3))
        query = occupancy_entry("mesh_entry_keys",
                                [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int], packet)
        key_blocks = query(lanes, deep_frame.slots.shape[0], deep_frame.node_bounds.shape[0],
                           ctypes.addressof(persistent), ctypes.addressof(staged),
                           ctypes.addressof(grid), 0)
        check(key_blocks > 0, f"mesh_entry_keys_occupancy at packet {packet} failed ({key_blocks})")
        vote = occupancy_entry("packet_octants", [ctypes.c_int] * 2)
        row6 = pool_occupancy(meshes["pool"], kernels.POOL_GROUP, 0, packet)
        vote_bytes = -(-4 * 22 * deep_frame.slots.shape[0] // 16) * 16
        out[tier_label(packet, leaf)] = {
            "trace_fused_mesh_tlas": {
                "blocks_per_sm": blocks, "shared_bytes": shared.value,
                "route": "tables staged" if shared.value > floor else "tables from global memory",
                "packet_state_bytes": packet_state_bytes(packet), "tlas_nodes": m3,
                "ptxas": ptxas["trace_fused_mesh_tlas"]},
            "mesh_bounce_tlas": {**row4, "group": group,
                                 "route": "tables staged" if row4["shared_bytes"] else
                                 "tables from global memory",
                                 "tlas_nodes": deep_frame.node_bounds.shape[0],
                                 "ptxas": ptxas["mesh_bounce_tlas"]},
            "mesh_entry_keys": {"blocks_per_sm": key_blocks, "shared_bytes": staged.value,
                                "grid": grid.value,
                                "route": "persistent, the eight octant tables staged"
                                if persistent.value else "a block a packet, its octant staged",
                                "ptxas": ptxas["mesh_entry_keys"]},
            "packet_octants": {"blocks_per_sm": vote(packet, deep_frame.slots.shape[0]),
                               "shared_bytes": vote_bytes, "route": "instance rows staged",
                               "ptxas": ptxas["packet_octants"]},
            "pool_mesh_bounce_tlas": {**row6, "group": kernels.POOL_GROUP,
                                      "route": f"{row6['staged_frames']} frames staged"
                                      if row6["staged_frames"] >= 0 else
                                      "tables from global memory",
                                      "ptxas": ptxas["pool_mesh_bounce_tlas"]},
        }
        print(f"[11] resources at {tier_label(packet, leaf)}: "
              f"{json.dumps(out[tier_label(packet, leaf)])}")
    return out


def packet_state_bytes(packet: int) -> int:
    """``sizeof(PacketState)`` of ``trace_fused_mesh_tlas.cu`` at ``packet``
    lanes, rounded to 16: origin, direction, throughput and radiance (12
    bytes each a lane), alive (1), the live mask (a bit) and the packet's
    index."""
    return -(-(49 * packet + packet // 8 + 4) // 16) * 16


def tier_frames(device) -> dict:
    """Phase 11's main path through ``TorchRaytraceBackend`` at 512x512, 8
    spp, 4 bounces, the tiers set in the environment as a worker takes them
    (``TRC_TLAS_BLOCK``, ``TRC_TLAS_LEAF``): at each (packet, leaf) of
    ``TIER_CONFIGS``, 02 frame 1 (row 3 TLAS), the deep wavefront's frame 1
    (row 4 TLAS, its vote and key pass) and the deep pool over frames 1-2
    (row 6 TLAS and its vote); then, at the default TLAS tiers, a pool
    window at ``TRC_RAYPOOL_FRAMES=16`` over frames 1-16 and one at
    ``TRC_RAYPOOL_WIDTH`` twice the default over frames 1-2. The counts are
    zeroed just before each backend render and read just after it, before
    any comparison render, and must be exactly the render's: one row 3
    launch; BOUNCES each of row 4, its vote and its key pass; a row 6 launch
    and a vote each pool iteration; under the packet's names. Only these
    counts are returned, summed per name, for the kernels line. Each image
    is then held against the masked deep loop (the region path over the
    whole frame for 02), or the wavefront for a pool frame, rendered in
    the same environment. Tolerances (PERF.md section 2): a frame against
    the masked deep loop >= 99.5% of uint8 values within 1 (the bit-equal
    share printed), a pool frame against the wavefront within atol 1e-5."""
    import torch

    from tpu_render_cluster_torch.render import compaction, integrator, kernels, raypool
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    mesh_scene, deep = PATHS[1].scene, PATHS[2].scene
    size = dict(width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES)
    result: dict = {}
    launches: dict[str, int] = {}

    def within_one(image, reference) -> dict:
        delta = (image.int() - reference.int()).abs()
        return {"within_one": float((delta <= 1).float().mean()),
                "bit_equal": float((delta == 0).float().mean())}

    def pool_vs_wavefront(label, images, frames) -> float:
        err = 0.0
        for frame, image in zip(frames, images):
            want = compaction.render_frame_wavefront(deep, frame, device=device, **size)
            err = max(err, (image - want).abs().max().item())
        check(err <= 1e-5, f"{label}: the pool's frames differ from the wavefront's by {err}")
        return err

    def counted(label, render, expected):
        """``render()``'s result, its launches (counted from 0 just before
        it, read just after) exactly ``expected(result)``."""
        kernels.reset_counts()
        out = render()
        torch.cuda.synchronize()
        got = {k: v for k, v in kernels.counts.items() if v}
        want = expected(out)
        check(got == want, f"{label}: launches {got}, not {want}")
        return out, got

    def pool_window(label, backend, frames):
        backend.pool_stats.clear()
        images, got = counted(
            label, lambda: backend._render_window(deep, frames),
            lambda _: dict.fromkeys(
                kernels.launch_names("pool_mesh_bounce_tlas", True, 0, kernels.tlas_block_r()),
                sum(w.iterations for w in backend.pool_stats)))
        return images, list(backend.pool_stats), got

    started = time.perf_counter()
    for packet, leaf in TIER_CONFIGS:
        label = tier_label(packet, leaf)
        tiers = {"TRC_TLAS_BLOCK": str(packet), "TRC_TLAS_LEAF": str(leaf)}
        entry: dict = {}
        with environment(tiers):
            check(integrator.resolve_tlas_config() == (leaf, packet),
                  f"{label}: the environment resolves to {integrator.resolve_tlas_config()}")
            backend = TorchRaytraceBackend(device=device, **size)
            row3 = kernels.packet_name("trace_fused_mesh_tlas", packet)
            image02, got02 = counted(f"02 at {label}", lambda: backend._renderer(mesh_scene)(1),
                                     lambda _: {row3: 1})
            image03, got03 = counted(
                f"the 03 wavefront at {label}", lambda: backend._renderer(deep)(1),
                lambda _: dict.fromkeys(kernels.launch_names("mesh_bounce_tlas", True, 0, packet),
                                        BOUNCES))
            window, stats, got_pool = pool_window(f"the pool at {label}", backend, [1, 2])
            for got in (got02, got03, got_pool):
                for name, count in got.items():
                    if packet != kernels.TLAS_BLOCK_R:
                        launches[name] = launches.get(name, 0) + count
            deep_loop = integrator.tonemap(integrator.render_frame_region(
                mesh_scene, 1, y0=0, x0=0, tile_height=HEIGHT, tile_width=WIDTH, device=device,
                **size))
            entry["02"] = within_one(image02, deep_loop)
            masked = integrator.tonemap(integrator.render_frame(deep, 1, device=device, **size))
            entry["03 wavefront"] = within_one(image03, masked)
            for key in ("02", "03 wavefront"):
                check(entry[key]["within_one"] >= 0.995,
                      f"{key} at {label}: {entry[key]} against the masked deep loop")
            entry["03 pool, max abs err vs the wavefront"] = pool_vs_wavefront(
                f"the pool at {label}", window, [1, 2])
        entry["launches"] = {**got02, **got03, **{f"pool: {k}": v for k, v in got_pool.items()}}
        entry["pool_iterations"] = stats[0].iterations
        result[label] = entry
        print(f"[11] frames at {label}: {json.dumps(entry)}")
    backend = TorchRaytraceBackend(device=device, **size)
    with environment({"TRC_RAYPOOL_FRAMES": str(TIER_POOL_FRAMES)}):
        frames = list(range(1, TIER_POOL_FRAMES + 1))
        images, stats, got = pool_window(f"TRC_RAYPOOL_FRAMES={TIER_POOL_FRAMES}", backend,
                                         frames)
    check(len(stats) == 1 and stats[0].served == TIER_POOL_FRAMES * WIDTH * HEIGHT * SAMPLES,
          f"TRC_RAYPOOL_FRAMES={TIER_POOL_FRAMES}: windows {[w.served for w in stats]}")
    err = pool_vs_wavefront(f"the {TIER_POOL_FRAMES}-frame window", images, frames)
    result["TRC_RAYPOOL_FRAMES=16"] = {"windows": 1, "iterations": stats[0].iterations,
                                       "max_abs_err": err, "launches": got}
    with environment({"TRC_RAYPOOL_WIDTH": str(TIER_POOL_WIDTH)}):
        check(raypool.raypool_width(WIDTH * HEIGHT * SAMPLES) == TIER_POOL_WIDTH,
              "TRC_RAYPOOL_WIDTH is not the pool's width")
        images, stats, got = pool_window(f"TRC_RAYPOOL_WIDTH={TIER_POOL_WIDTH}", backend, [1, 2])
    check(stats[0].refill_log[0] == TIER_POOL_WIDTH,
          f"TRC_RAYPOOL_WIDTH={TIER_POOL_WIDTH}: the first refill took {stats[0].refill_log[0]}")
    err = pool_vs_wavefront("the double-width window", images, [1, 2])
    result[f"TRC_RAYPOOL_WIDTH={TIER_POOL_WIDTH}"] = {"iterations": stats[0].iterations,
                                                      "max_abs_err": err, "launches": got}
    print(f"[11] the tiers' main path in {time.perf_counter() - started:.1f} s: pools "
          f"{json.dumps({k: v for k, v in result.items() if k.startswith('TRC_')})}; "
          f"the backend's launches at packets other than 256 {launches}")
    for kernel in TIER_KERNELS:
        for packet in TIER_PACKETS:
            name = kernels.packet_name(kernel, packet)
            check(launches.get(name, 0) > 0, f"{name} was not launched on phase 11's path")
    return {"frames": result, "launches": launches}


def tier_times(device, inputs: dict) -> dict:
    """Each kernel of the TLAS packet alone under the profiler (windows of
    5 calls) and its wrapper on CUDA events, at the main paths' widths
    (row 4 TLAS with its vote and key pass at the deep bounce-0 launch, row
    6 TLAS with its vote at the mixed pool launch, row 3 TLAS on 02 frame
    1), in turns: packets 128, 256, 512, 1024, 1024, 512, 256, 128 at leaf
    4, then leaves 1, 16, 16, 1 at packet 256."""
    from tpu_render_cluster_torch.render import kernels

    trace, launch, seed = inputs["trace"], inputs["launch"], inputs["seed"]
    trace02, rays02, mixed = inputs["trace02"], inputs["rays02"], inputs["mixed"]
    live6 = int(mixed.live)
    turns = [(p, 4) for p in (128, 256, 512, 1024, 1024, 512, 256, 128)]
    turns += [(256, 1), (256, 16), (256, 16), (256, 1)]
    meshes = {leaf: tier_meshes(device, leaf, inputs["window"]) for leaf in (1, 4, 16)}
    rows = {
        "trace_fused_mesh_tlas": lambda p, m: kernels.trace_paths_fused_mesh(
            trace02.scene, m["02"], *rays02, max_bounces=BOUNCES, tlas_block=p),
        "mesh_bounce_tlas": lambda p, m: kernels.mesh_bounce(
            trace.scene, m["deep"], *launch.state, launch.live, seed, 0, total_bounces=BOUNCES,
            tlas_block=p),
        "pool_mesh_bounce_tlas": lambda p, m: kernels.pool_mesh_bounce(
            m["pool"], *mixed.state, live6, total_bounces=BOUNCES, tlas_block=p),
    }
    passes = {"trace_fused_mesh_tlas": (), "mesh_bounce_tlas": ("packet_octants",
                                                                "mesh_entry_keys"),
              "pool_mesh_bounce_tlas": ("packet_octants",)}
    out: dict = {}
    for row, call in rows.items():
        names = (row, *passes[row])
        measured: dict = {}
        for packet, leaf in turns:
            once = lambda p=packet, m=meshes[leaf]: call(p, m)  # noqa: E731
            cuda_ms(once, 2)
            ms = statistics.median(cuda_ms(once, 5) for _ in range(3))
            profile = profiled(lambda: [once() for _ in range(5)], names,
                               f"[11] {row} at {tier_label(packet, leaf)}", tries=6,
                               launches=5 * len(names))
            alone = None if profile is None else {n: profile["per_kernel"][n] / 5 for n in names}
            measured.setdefault(tier_label(packet, leaf), []).append({"ms": ms, "alone_ms": alone})
        entry = {}
        for label, runs in measured.items():
            alone = [r["alone_ms"] for r in runs]
            entry[label] = {
                "ms": statistics.mean(r["ms"] for r in runs),
                "alone_ms": None if None in alone else {
                    n: statistics.mean(a[n] for a in alone) for n in names},
                "turns": runs,
            }
        out[row] = entry
        print(f"[11] {row} (with {list(passes[row]) or 'no pass'}) alone ms under the profiler "
              f"and wrapper ms on CUDA events, in turns: "
              f"{json.dumps({k: {'ms': v['ms'], 'alone_ms': v['alone_ms']} for k, v in entry.items()})}")
    return out


def tier_wire(card: str) -> dict:
    """The TLAS tiers over the wire: ``TIER_WIRE_JOB`` served by the C++
    master (phase 8's build, or built here by its line) to a port worker
    process started with
    ``TRC_TLAS_BLOCK=128 TRC_TLAS_LEAF=8``; its PNGs bit-equal to, and its
    launch map equal to, the in-process render's in the same environment."""
    from tpu_render_cluster_torch.render import _build

    master_binary = _build.BUILD_DIR / "trc-master"
    if not master_binary.is_file():  # phase 11 alone: phase 8's build line
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = subprocess.run(
            ["g++", "-std=gnu++17", "-O2", "-pthread", "-o", str(master_binary),
             *(str(REPO / source) for source in MASTER_SOURCES)],
            capture_output=True, text=True, timeout=600,
        )
        check(compiler.returncode == 0, f"g++ on the C++ master failed:\n{compiler.stdout}"
                                        f"{compiler.stderr}")
    job = TIER_WIRE_JOB
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tiers-") as scratch:
        directory = Path(scratch)
        job_path = write_wire_job(job, directory)
        expected = in_process_frames(job, job_path, directory)
        run = wire_run(job, master_binary, job_path, directory)
        result = wire_checks(job, run, expected, directory / "frames")
    result["in_process_fps"] = expected["fps"]
    print(f"[11] {wire_label(job)} over the wire (C++ master, one port worker process): "
          f"{result['frames']} frames, {result['wire_fps']:.4f} frames/s (in process "
          f"{expected['fps']:.4f}); launches {result['launches']}, as in process; PNGs "
          f"bit-equal share {list(result['bit_equal_share'].values())}; {card}")
    return result


def tier_bound(kernel: str, plain: dict, width: int) -> dict:
    """The least time of ``kernel``'s work at ``width`` lanes, from its
    plain version's counters on ``plain['plain_rays']`` of them (scaled), as
    phases 5 and 9 count it."""
    if kernel == "packet_octants":
        k = plain["slots"]
        ops_ms = width * (k * OPS_VOTE_ROW + OPS_VOTE_WORLD) / FP32_PEAK_FLOPS * 1e3
        bytes_ms = width * VOTE_RAY_BYTES / MEMORY_BYTES_PER_S * 1e3
        return {"ms": max(ops_ms, bytes_ms), "by": "operations" if ops_ms >= bytes_ms else "bytes"}
    if kernel == "mesh_entry_keys":
        ops_ms = (OPS_SLAB * plain["stats"]["entry_tests"] + width * OPS_VOTE_WORLD) \
            / FP32_PEAK_FLOPS * 1e3
        bytes_ms = width * KEY_PASS_RAY_BYTES / MEMORY_BYTES_PER_S * 1e3
        return {"ms": max(ops_ms, bytes_ms), "by": "operations" if ops_ms >= bytes_ms else "bytes"}
    ray_bytes = {"trace_fused_mesh_tlas": MEGAKERNEL_RAY_BYTES,
                 "mesh_bounce_tlas": BOUNCE_RAY_BYTES + KEY_BYTES,
                 "pool_mesh_bounce_tlas": POOL_RAY_BYTES + KEY_BYTES}[kernel]
    least = bound(plain["stats"], width * ray_bytes, width / plain["plain_rays"])
    return {"ms": least["ms"], "by": least["by"]}


def tier_records(checks: dict, times: dict, launches: dict, build_s: float) -> list[dict]:
    """The kernels line's entries of the width builds (``<kernel>[p<P>]``):
    launches on phase 11's path (the backend's renders alone), the max abs
    error measured against the plain version on every lane, the wrapper's
    ms and the kernel alone at the main width, the plain version's ms (in
    one of ``TIER_CHECK_PROCESSES`` processes side by side), and the bound."""
    from tpu_render_cluster_torch.render import kernels

    inputs = checks["inputs"]
    widths = {"trace_fused_mesh_tlas": inputs["rays02"][0].shape[0],
              "mesh_bounce_tlas": inputs["launch"].bucket,
              "mesh_entry_keys": inputs["launch"].bucket,
              "packet_octants": inputs["launch"].bucket,
              "pool_mesh_bounce_tlas": int(inputs["mixed"].live)}
    timed_by = {"trace_fused_mesh_tlas": "trace_fused_mesh_tlas",
                "mesh_bounce_tlas": "mesh_bounce_tlas", "mesh_entry_keys": "mesh_bounce_tlas",
                "packet_octants": "mesh_bounce_tlas",
                "pool_mesh_bounce_tlas": "pool_mesh_bounce_tlas"}
    records = []
    for kernel in TIER_KERNELS:
        for packet in TIER_PACKETS:
            label = tier_label(packet, 4)
            plain = checks["plain"][(packet, 4)][kernel]
            timed = times[timed_by[kernel]][label]
            least = tier_bound(kernel, plain, widths[kernel])
            alone = None if timed["alone_ms"] is None else timed["alone_ms"][kernel]
            records.append({
                "name": kernels.packet_name(kernel, packet),
                "route": "cuda",
                "source": f"tpu_render_cluster_torch/render/csrc/{kernel}.cu",
                "replaces": REPLACES[kernel],
                "launches": launches.get(kernels.packet_name(kernel, packet), 0),
                "max_abs_err": plain["err"],
                "ms": timed["ms"] if kernel == timed_by[kernel] else plain["ms"],
                "plain_ms": plain["plain_ms"],
                "bound_ms": least["ms"],
                "bound_by": least["by"],
                "library_ms": None,
                "kernel_only_ms": alone,
                "packet": packet,
                "rays": widths[kernel],
                "plain_rays": plain["plain_rays"],
                "plain_processes": TIER_CHECK_PROCESSES,
                "tolerance": TIER_TOLERANCE,
                "build_s": build_s,
            })
    return records


def first_deep_window(device) -> dict:
    """Phase 3's first deep pool window (frames 1-8 at the main size),
    iterated, its launches kept and picked by role: what phase 11 takes
    when it runs alone."""
    from tpu_render_cluster_torch.render import raypool

    path = next(p for p in PATHS if p.kernel == "pool_mesh_bounce_tlas")
    frames = job_frames(path)[1][:raypool.RAYPOOL_FRAMES]
    window = raypool.PoolWindow(path.scene, frames, width=WIDTH, height=HEIGHT, samples=SAMPLES,
                                max_bounces=BOUNCES, device=device)
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    roles = pool_launch_roles(launches, window)
    return {"window": window, "launches": launches,
            "picked": {role: {"index": index} for role, index in roles.items()}}


def tier_phase(card: str, device, pool_first: dict, build_s: float,
               processes: list | None = None) -> dict:
    """Phase 11: the TLAS tiers, checked (``processes``: its kernel checks,
    ``tier_check_processes``, started earlier; else started here, beside
    its frames and wire job), framed, over the wire and timed (alone:
    ``tier_phase(card, device, first_deep_window(device), 0.0)``)."""
    started = time.perf_counter()
    own = processes is None
    if own:
        processes = tier_check_processes()
    try:
        inputs = tier_inputs(device, pool_first)
        resources = tier_resources(device, inputs)
        frames = tier_frames(device)
        print(f"[11] frames in {time.perf_counter() - started:.1f} s")
        wire = tier_wire(card)
        print(f"[11] the wire job in {time.perf_counter() - started:.1f} s")
        plain, checked = tier_check_results(processes)
    finally:
        if own:
            for process in processes:
                process.stop()
    print(f"[11] kernel checks ({TIER_CHECK_PROCESSES} processes) joined in "
          f"{time.perf_counter() - started:.1f} s")
    tier_pass_times(device, inputs, plain)
    times = tier_times(device, inputs)
    print(f"[11] times on {card} in {time.perf_counter() - started:.1f} s")
    checks = {"plain": plain, "checked": checked, "inputs": inputs}
    records = tier_records(checks, times, frames["launches"], build_s)
    widths = {kernel: record["rays"] for kernel, record in
              zip(TIER_KERNELS, records[::len(TIER_PACKETS)])}
    bounds = {tier_label(packet, leaf): {
        kernel: tier_bound(kernel, checks["plain"][(packet, leaf)][kernel], widths[kernel])
        for kernel in TIER_KERNELS} for packet, leaf in TIER_CONFIGS}
    print(f"[11] bounds at the main widths (the plain versions' counters at each packet and "
          f"leaf, scaled): {json.dumps(bounds)}")
    return {"records": records, "resources": resources, "frames": frames["frames"],
            "bounds": bounds,
            "wire": {k: wire[k] for k in ("launches", "wire_fps", "in_process_fps",
                                          "bit_equal_share")},
            "times": {row: {label: {"ms": v["ms"], "alone_ms": v["alone_ms"]}
                            for label, v in entry.items()} for row, entry in times.items()},
            "checked": checks["checked"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    if sys.argv[1:2] == [CHECK_FLAG]:  # one of the check processes of phases 9 and 11
        return check_process(sys.argv[2])

    from tpu_render_cluster_torch.render import _build

    device = torch.device("cuda", 0)
    script_started = time.perf_counter()

    # -- 1. the card --------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build every kernel from csrc/ ------------------------------------
    started = time.perf_counter()
    libraries = _build.build()
    build_s = time.perf_counter() - started
    print(f"[2] built {sorted(libraries)} in {build_s:.2f} s")
    expected = sorted(
        {kernel for path in PATHS for kernel in path.launched} | {p.kernel for p in TILE_PATHS}
    )
    check(sorted(libraries) == expected, f"kernels {sorted(libraries)} != {expected}")
    for name in sorted(libraries):
        for line in _build.resource_lines(_build.build_logs[name]):
            print(f"    {name}: {line}")
    # The TLAS kernels' other packet widths (phase 11), one nvcc each, built
    # while phases 3-8 run; phase 9 waits for them. No nvcc outlives the run.
    width_builds = WidthBuilds()
    try:
        return phases(card, device, build_s, width_builds, script_started)
    finally:
        width_builds.stop()


def phases(card: str, device, build_s: float, width_builds: WidthBuilds,
           script_started: float) -> int:
    """Phases 3-11, after the card and the default builds; the contract's
    last lines."""
    import torch

    from tpu_render_cluster_torch.render import _build

    # -- 3. the frames' inputs, and each kernel against its plain version ----
    frame_input_parity(device)
    checks = {
        "trace_fused": ("04_very-simple", "03_physics-2"),
        "trace_fused_mesh": ("02_physics-mesh", "03_physics-2-mesh"),
        "trace_fused_mesh_tlas": ("02_physics-mesh", "03_physics-2-mesh"),
        "mesh_bounce": ("03_physics-2-mesh",),
        "mesh_bounce_tlas": ("03_physics-2-mesh",),
        "sphere_bounce": ("04_very-simple", "03_physics-2"),
    }
    agree: dict[str, float] = {}
    max_abs_err: dict[str, float] = {}
    pool_checks = {}
    pool_inputs = {}  # the first windows of the pool paths, for phase 7
    scan_checks = {}
    for path in PATHS:
        started = time.perf_counter()
        if path.kernel in POOLS:
            pool_checks[path.kernel] = pool_kernel_vs_plain(path, device)
            pool_inputs[path.kernel] = pool_checks[path.kernel]
        elif path.bounce_scan:
            scan_checks[path.kernel] = scan_kernels_vs_plain(path, device)
        else:
            continue
        print(f"[3] {path.kernel} checked in {time.perf_counter() - started:.1f} s")
    started = time.perf_counter()
    lane_err = lane_kernel_vs_plain(device)
    print(f"[3] trace_fused_lanes checked in {time.perf_counter() - started:.1f} s")
    for kernel, scene_names in checks.items():
        started = time.perf_counter()
        compare = kernel_vs_plain if kernel in MEGAKERNELS else bounce_kernel_vs_plain
        results = [compare(kernel, name, device) for name in scene_names]
        if kernel in GROUP_KERNELS:
            results.append(narrow_bounce_vs_plain(kernel, device))
        print(f"[3] {kernel} checked in {time.perf_counter() - started:.1f} s")
        agree[kernel] = min(r[0] for r in results)
        max_abs_err[kernel] = max(r[1] for r in results)

    # -- 4. the main paths, 5. their timings, 6. the profiler ----------------
    record = {"kernels": []}
    runs = {}
    scan_records = {}
    for path in PATHS:
        started = time.perf_counter()
        run = drive_main_path(path, device)
        runs[path.kernel] = run
        if path.per_instance:
            scan_records[path.kernel] = per_instance_record(run, runs, device)
        elif path.bounce_scan:
            scan_records[path.kernel] = scan_record(run, runs, device)
        elif path.kernel in MEGAKERNELS:
            entry = megakernel_record(run, device, agree[path.kernel], max_abs_err[path.kernel], build_s)
        elif path.kernel in POOLS:
            entry = pool_record(run, pool_checks.pop(path.kernel), runs, device, build_s)
        else:
            checked = wavefront_frame_checks(run, runs["trace_fused"]["images"], device)
            entry = bounce_record(
                run, checked, device, agree[path.kernel], max_abs_err[path.kernel], build_s
            )
        if path.kernel in TLAS_KERNELS:
            entry["tlas_vs_flat"] = tlas_vs_flat(run, device)
        if not path.bounce_scan:
            record["kernels"].append(entry)
        print(f"[5] {run['label']} path phases 4-6 in {time.perf_counter() - started:.1f} s")
    record["kernels"] += [
        unit_entry(name, scan_records, runs, scan_checks, build_s) for name in UNIT_KERNELS
    ]
    tile_summary = []
    for path in TILE_PATHS:
        started = time.perf_counter()
        run = drive_tile_path(path, runs, device)
        linear = tile_linear_checks(run, device)
        times = tile_times(run, runs, device)
        if path.kernel == "trace_fused_lanes":
            record["kernels"].append(lane_kernel_record(run, device, lane_err, build_s))
        tile_summary.append({
            "path": run["label"], "kernel": path.kernel, "frames": run["frames"],
            "units": len(run["units"]), "launches": run["launches"], "idle_share": run["idle"],
            **linear, **times,
        })
        print(f"[5] {run['label']} tile path phases 4-6 in {time.perf_counter() - started:.1f} s")
    print(f"[5] tile paths: {json.dumps(tile_summary)}")
    record["kernels"] += pass_records(runs, device, build_s)

    # -- 7. the redesigned kernels; the ordered walk against the canonical ----
    started = time.perf_counter()
    pool_first = pool_inputs["pool_mesh_bounce_tlas"]
    resources = redesign_resources(pool_first, device)
    tile_rays = next(e for e in record["kernels"] if e["name"] == "trace_fused_lanes")["rays"]
    resources.update(row1_resources(WIDTH * HEIGHT * SAMPLES, tile_rays))
    votes = vote_times(pool_first, device)
    keys = key_pass_times(device)
    resources["mesh_entry_keys"] = {
        "ptxas": _build.resource_lines(_build.build_logs.get("mesh_entry_keys", "")),
        "launches": {label: {k: r[k] for k in ("persistent", "blocks_per_sm", "shared_bytes",
                                                "grid_blocks")}
                     for label, r in keys.items()},
    }
    print(f"[7] mesh_entry_keys registers and spills: "
          f"{json.dumps(resources['mesh_entry_keys']['ptxas'])}")
    ab = octant_ab(pool_inputs, device)
    for entry in record["kernels"]:
        if entry["name"] in resources:
            entry["resources"] = resources[entry["name"]]
        if entry["name"] == "packet_octants":
            entry["phase_7_launches"] = votes
        if entry["name"] == "mesh_entry_keys":
            entry["phase_7_launches"] = keys
        if entry["name"] in ab["kernels"]:
            entry["octant_ab"] = ab["kernels"][entry["name"]]
    print(f"[7] phase 7 in {time.perf_counter() - started:.1f} s: "
          f"{json.dumps(ab['frames_per_s'])}")

    # -- 8. the wire: the C++ master and a port worker process ---------------
    started = time.perf_counter()
    wire = wire_phase(card)
    for entry in record["kernels"]:
        if entry["name"] in wire["launches"]:
            entry["wire_launches"] = wire["launches"][entry["name"]]
    print(f"[8] phase 8 in {time.perf_counter() - started:.1f} s")

    # -- 9. the node formats (the reference's TRC_BVH_QUANT tiers) ----------
    started = time.perf_counter()
    build_s += width_builds.wait()  # phase 11's processes load the width builds
    quant_process = CheckProcess("quant")
    tier_processes = tier_check_processes()
    try:
        formats = quant_phase(card, device, pool_first, [quant_process, *tier_processes])
    finally:
        for process in (quant_process, *tier_processes):
            process.stop()
    keys_alone = {
        quant: {"alone_ms": (formats["times"]["mesh_bounce_tlas"][quant]["alone_ms"] or {}).get(
            "mesh_entry_keys")}
        for quant in (0, *QUANTS)
    }
    for entry in record["kernels"]:
        name = entry["name"]
        if name in formats["times"]:
            entry["node_formats"] = formats["times"][name]
        elif name == "mesh_entry_keys":
            entry["node_formats"] = keys_alone
        checked = {label: n for label, n in formats["checked"].items()
                   if label.split(" ")[0].split("[")[0] == name}
        if checked:
            entry["node_format_checks"] = {"tolerance": QUANT_TOLERANCE, "launches": checked}
    print(f"[9] phase 9 in {time.perf_counter() - started:.1f} s")

    # -- 10. sharding: a one-card mesh, 4-shard decompositions, NCCL -------
    started = time.perf_counter()
    sharding = sharding_phase(card, device, runs)
    for entry in record["kernels"]:
        sharded = {
            f"{scene} {mode}": result[mode]["launches"][entry["name"]]
            for scene, result in sharding["one_card_mesh"].items() for mode in ("tile", "spp")
            if entry["name"] in result[mode]["launches"]
        }
        if sharded:
            entry["sharded_launches"] = sharded
    print(f"[10] phase 10 in {time.perf_counter() - started:.1f} s")

    # -- 11. the TLAS tiers (the reference's TRC_TLAS_BLOCK, TRC_TLAS_LEAF,
    # TRC_RAYPOOL_FRAMES, TRC_RAYPOOL_WIDTH) ---------------------------------
    started = time.perf_counter()
    tiers = tier_phase(card, device, pool_first, build_s, tier_processes)
    record["kernels"] += tiers["records"]
    for entry in record["kernels"]:
        if entry["name"] in TIER_KERNELS:
            entry["tiers"] = {"resources": {label: r[entry["name"]]
                                            for label, r in tiers["resources"].items()}}
            timed = "mesh_bounce_tlas" if entry["name"] in ("packet_octants",
                                                            "mesh_entry_keys") else entry["name"]
            entry["tiers"]["times"] = tiers["times"][timed]
    print(f"[11] TLAS tiers on {card}: {json.dumps({k: v for k, v in tiers.items() if k != 'records'})}")
    print(f"[11] phase 11 in {time.perf_counter() - started:.1f} s")

    print(f"[5] chip_smoke phases 1-11 in {time.perf_counter() - script_started:.1f} s")
    print(json.dumps(record))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
