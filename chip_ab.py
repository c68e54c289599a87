"""Time a redesigned kernel against the build of the sources it replaced,
in one run on one CUDA GPU. Two modes, each bound to one parent commit:

- ``row1``: row 1, the sphere path-trace megakernel, in both its modes
  (``csrc/trace_fused.cu``, whole frames, and ``csrc/trace_fused_lanes.cu``,
  one launch a tile), against commit 66abd34's ``csrc/``;
- ``keys``: the octant-ordered walk's key pass (``csrc/mesh_entry_keys.cu``,
  after each ordered ``mesh_bounce_tlas`` launch) against commit 9ef44af's
  ``csrc/``.

Usage (from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit):

    mkdir -p .chip_scratch/parent_csrc .chip_scratch/parent_csrc_9ef44af
    git archive 66abd34 tpu_render_cluster_torch/render/csrc \\
        | tar -x --strip-components=3 -C .chip_scratch/parent_csrc
    git archive 9ef44af tpu_render_cluster_torch/render/csrc \\
        | tar -x --strip-components=3 -C .chip_scratch/parent_csrc_9ef44af
    python3 chip_ab.py row1 .chip_scratch/parent_csrc [--variant NAME=CSRC ...] \\
        [--fps-tree PARENT_CHECKOUT]
    python3 chip_ab.py keys .chip_scratch/parent_csrc_9ef44af [--variant NAME=CSRC ...] \\
        [--fps-tree PARENT_CHECKOUT]

The earlier C entries take no work counter, so the script binds them only
to the sources it was written for, checked by their sha256, and refuses
others. A ``--variant`` is another
``csrc/`` directory whose kernels take the port's C entries (a design
variant under test); it is built and timed beside the others. Each build
uses the port's nvcc flags. ``row1``:

- bit-equal on every ray, new against earlier (and each variant against
  new): row 1 on frames 1 and 2 of the 04_very-simple job at 512x512 x 8
  spp, the lane mode on all four 256x256 tiles of frame 1 (a 2x2 grid),
  both at max_bounces 0, 1 and 4; the new kernels against their plain
  versions on frame 1 and on each tile at the same bounces;
- each mode timed (row 1 on frame 1, 2,097,152 rays; the lane mode on tile
  0, 524,288 rays; 4 bounces) in turns earlier, new, variants..., variants
  reversed, new, earlier: its wrapper on CUDA events (the median of 3
  batches of 5) and the kernel alone under the profiler (windows of 5
  calls), and the means of each side's turns;
- each build's ptxas lines, and each build with a work counter its
  resident blocks per SM and the grid of a frame's and a tile's launch;
- with ``--fps-tree`` (the parent commit's ``git archive``, unpacked into
  an ignored directory), the 04 whole-frame and tiled paths' frames/s of
  both checkouts through the backend, in turns parent, new, new, parent,
  twice, each in a fresh process (``TREE_FPS``);
- the share of the nearest sweeps' lane-slots that the one-thread-a-ray
  schedule spent on finished paths on frame 1: from each ray's path length
  (the bounces it starts alive, from the plain per-bounce sphere version
  on the card), a warp of 32 consecutive rays running as long as its
  longest path.

``keys``, on every ``mesh_bounce_tlas`` launch of frames 1 and 2 of the
03_physics-2-mesh wavefront path at 512x512 x 8 spp and of tile 0 of its
frame 1 (a 2x2 grid, the region path):

- every key equal on every lane: the new kernel's to its plain version's
  and to the key column the bounce's wrapper wrote, the earlier build's and
  each variant's to the new kernel's;
- each build's ptxas lines, the new build's (and each variant's) resident
  blocks per SM, staged bytes and grid at each launch of frame 1 and the
  tile;
- each launch timed in turns as ``row1``'s, and per frame and tile the sum
  over its launches;
- with ``--fps-tree``, the 03 wavefront whole-frame and tiled paths'
  frames/s of both checkouts, as ``row1``'s for 04.

Prints the card's name and power limit, a ``[ab]`` line a measurement, and
as its last line one JSON object of all of them. Exits non-zero on a failed
check and without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

# The sources the earlier entries below are bound to.
EARLIER_SHA256 = {
    "trace_fused.cu": "3546ad44f2e59465c9c82cf8220d3c4ebba4a43a8c71e8fabe5b46f55e9b8a9b",
    "trace_fused_lanes.cu": "2babfbbc55ca52bedfdc37f54377b24fbe0f3d6fe495943be6b0c1f5670d308e",
    "trace_fused.cuh": "dc7a4c7e6d7583c13a0821b474eecad396e0fd9c1e4b2fb660afd52ee2cacd79",
    "path_common.cuh": "3be1d00b5e296855a5a7842d704bd840db3b9364b3f7010bd3813d3a1d48212e",
}
_P, _I = ctypes.c_void_p, ctypes.c_int
EARLIER_ARGTYPES = {
    # origins, directions, n_rays, spheres, n_spheres, params, seed,
    # max_bounces, radiance, stream
    "trace_fused": [_P, _P, _I, _P, _I, _P, _I, _I, _P, _P],
    # the same with the lane row after the directions
    "trace_fused_lanes": [_P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _P],
}
# The key pass's: its source at commit 9ef44af and the headers it includes.
KEYS_EARLIER_SHA256 = {
    "mesh_entry_keys.cu": "9532569d1d8a287c55c1fd9cf83600e5cb7aced68ff72ca7a2e0171be63d4a08",
    "mesh_common.cuh": "cacb63a9a13d07e8729974d73c275e8036a1eeb620d191bc41fa58fd064a986a",
    "path_common.cuh": "3be1d00b5e296855a5a7842d704bd840db3b9364b3f7010bd3813d3a1d48212e",
}
KEYS_EARLIER_ARGTYPES = {
    # origins, directions, alive, n_rays, live_count, slots, n_instances,
    # tlas_bounds, tlas_links, tlas_nodes, key_window, bounce,
    # total_bounces, keys, stream
    "mesh_entry_keys": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _I, _I, _P, _P],
}
# The occupancy entries of the port's builds.
OCCUPANCY_ARGTYPES = {
    "trace_fused": [_I, _P],
    "trace_fused_lanes": [_I, _P],
    # n_rays, n_instances, tlas_nodes, then whether the launch runs
    # persistent blocks, its shared bytes and its grid, and the node format
    "mesh_entry_keys": [_I, _I, _I, _P, _P, _P, _I],
}
BOUNCE_SET = (0, 1, 4)
THREADS = 256  # the earlier kernels' block
# Run in a checkout's root (its own chip_smoke.py and package): frames/s of
# chip_smoke's main path PATHS[PATH_INDEX] (4 whole frames through the backend,
# chip_smoke's backend_fps) and of its tiled job (2 frames of 2x2 tiles: 04
# one lane-mode launch a tile, the 03 wavefront its region path), as one
# JSON line.
TREE_FPS = """
import asyncio, json, tempfile, time
import torch
import chip_smoke as smoke
from tpu_render_cluster_torch.jobs.models import BlenderJob
from tpu_render_cluster_torch.jobs.tiles import WorkUnit
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend
whole = smoke.backend_fps(smoke.PATHS[PATH_INDEX], 4, torch.device("cuda", 0))
job, frames = smoke.job_frames(smoke.PATHS[PATH_INDEX])
tiled = BlenderJob.from_dict({**job.to_dict(), "tiles": list(smoke.TILE_GRID)})
units = [WorkUnit(f, t) for f in frames[:2] for t in range(len(smoke.tile_regions()))]
with tempfile.TemporaryDirectory(prefix="chip-ab-tiles-") as base:
    backend = TorchRaytraceBackend(width=smoke.WIDTH, height=smoke.HEIGHT, samples=smoke.SAMPLES,
                                   max_bounces=smoke.BOUNCES, base_directory=base)
    warm = BlenderJob.from_dict({**tiled.to_dict(), "output_directory_path": f"{base}/warm"})
    asyncio.run(backend.render_frame(warm, frames[0], 0))
    torch.cuda.synchronize()
    started = time.perf_counter()
    for unit in units:
        asyncio.run(backend.render_frame(tiled, unit.frame_index, unit.tile))
    elapsed = time.perf_counter() - started
print(json.dumps({"whole_fps": whole["fps"], "tiled_fps": 2 / elapsed}))
"""


def build(directories: dict, argtypes: dict, names: tuple[str, ...]) -> dict:
    """The kernels ``names`` of each ``csrc/`` directory (side -> directory),
    one nvcc each, all at once: side -> name -> (its C launch entry, its
    occupancy entry or None, ptxas's resource lines). ``argtypes``: side ->
    the C entries' argument types."""
    from tpu_render_cluster_torch.render import _build

    jobs = {}
    for side, directory in directories.items():
        out = directory / "build"
        out.mkdir(parents=True, exist_ok=True)
        for name in names:
            jobs[side, name] = (out / f"lib{name}.so", subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
                 str(directory / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
    built: dict = {side: {} for side in directories}
    for (side, name), (library_path, job) in jobs.items():
        log, _ = job.communicate()
        smoke.check(job.returncode == 0, f"{directories[side]}/{name}.cu did not build:\n{log}")
        library = ctypes.CDLL(str(library_path))
        entry = getattr(library, f"{name}_launch")
        entry.argtypes = argtypes[side][name]
        entry.restype = ctypes.c_int
        occupancy = getattr(library, f"{name}_occupancy", None)
        if occupancy is not None:
            occupancy.argtypes = OCCUPANCY_ARGTYPES[name]
            occupancy.restype = ctypes.c_int
        built[side][name] = (entry, occupancy, _build.resource_lines(log))
    return built


def check_earlier(directory: Path, digests: dict) -> None:
    for name, digest in digests.items():
        path = directory / name
        smoke.check(path.is_file() and hashlib.sha256(path.read_bytes()).hexdigest() == digest,
                    f"{path}: not the source that chip_ab.py's earlier entries are bound to")


def register_blocks(lines: list[str], threads: int) -> int | None:
    """Blocks of ``threads`` threads an SM's 65,536 registers hold at the
    largest register count of a ptxas report (allocated 8 a thread at a
    time)."""
    counts = [int(m.group(1)) for line in lines for m in [re.search(r"Used (\d+) registers", line)]
              if m]
    return 65536 // (-(-max(counts) // 8) * 8 * threads) if counts else None


def bound_call(entry, counted: bool, scene, origins, directions, seed, max_bounces, lane=None):
    """One launch of a built kernel (``counted``: with a work counter, the
    port's C entry; else the earlier one), as the port's wrapper makes it."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    spheres, params = kernels._sphere_operands(scene)
    origins, directions, radiance, stream = kernels._ray_operands(origins, directions)
    rays = (origins.data_ptr(), directions.data_ptr())
    if lane is not None:
        rays += (lane.contiguous().data_ptr(),)
    counter = ()
    if counted:
        counter = (torch.empty((1,), dtype=torch.int32, device=origins.device).data_ptr(),)
    status = entry(*rays, origins.shape[0], spheres.data_ptr(), spheres.shape[0],
                   params.data_ptr(), int(seed), int(max_bounces), radiance.data_ptr(), *counter,
                   stream)
    smoke.check(status == 0, f"a built row 1 kernel failed ({status})")
    return radiance


def shapes(device) -> dict:
    """Row 1's inputs: frames 1 and 2 of the 04 job whole, and frame 1's
    four tiles with their whole-frame lanes; label -> (kernel, scene,
    origins, directions, seed, lane)."""
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import region_rays_and_seed
    from tpu_render_cluster_torch.render.scene import build_scene

    path = smoke.PATHS[0]
    frames = smoke.job_frames(path)[1][:2]
    out = {}
    for frame in frames:
        scene = build_scene(path.scene, frame, device)
        out[f"04 frame {frame}"] = ("trace_fused", scene,
                                    *smoke.frame_rays(path.scene, frame, device), None)
    scene = build_scene(path.scene, frames[0], device)
    camera = scene_camera(path.scene, frames[0], device)
    for tile, (y0, x0, th, tw) in enumerate(smoke.tile_regions()):
        origins, directions, lanes, seed = region_rays_and_seed(
            camera, frames[0], width=smoke.WIDTH, height=smoke.HEIGHT, samples=smoke.SAMPLES,
            y0=y0, x0=x0, tile_height=th, tile_width=tw,
        )
        out[f"04 frame {frames[0]} tile {tile}"] = ("trace_fused_lanes", scene, origins,
                                                    directions, seed, lanes)
    return out


def sides_of(built: dict, variants: dict) -> dict:
    """Per side, ``call(kernel, scene, origins, directions, seed, lane,
    max_bounces)``: the earlier build, the port's wrapper, each variant."""
    from tpu_render_cluster_torch.render import kernels

    def port(kernel, scene, o, d, seed, lane, bounces):
        return kernels.trace_paths_fused(scene, o, d, seed, max_bounces=bounces, lane=lane)

    def of(builds, counted):
        return lambda kernel, scene, o, d, seed, lane, bounces: bound_call(
            builds[kernel][0], counted, scene, o, d, seed, bounces, lane)

    sides = {"earlier": of(built, False), "new": port}
    for name, builds in variants.items():
        sides[name] = of(builds, True)
    return sides


def check_bits(sides: dict, inputs: dict) -> dict:
    """Every side bit-equal on every ray at max_bounces 0, 1 and 4 (the
    earlier and each variant against the new), the new against its plain
    version; rays that differ per label and bounce count."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    result = {}
    for label, (kernel, scene, o, d, seed, lane) in inputs.items():
        for bounces in BOUNCE_SET:
            new = sides["new"](kernel, scene, o, d, seed, lane, bounces)
            plain = kernels.trace_paths_fused_reference(scene, o, d, seed, max_bounces=bounces,
                                                        lane=lane)
            differ = {"plain": int((new != plain).any(dim=1).sum())}
            for side, call in sides.items():
                if side != "new":
                    got = call(kernel, scene, o, d, seed, lane, bounces)
                    differ[side] = int((got != new).any(dim=1).sum())
            torch.cuda.synchronize()
            smoke.check(torch.isfinite(new).all().item(), f"{kernel} {label}: non-finite radiance")
            result[f"{label}, {bounces} bounce(s)"] = differ
            print(f"[ab] {kernel} {label}, {bounces} bounce(s), {o.shape[0]} rays: rays differing "
                  f"from the new kernel's: {json.dumps(differ)}")
            smoke.check(not any(differ.values()), f"{kernel} {label} at {bounces} bounce(s): "
                                                  f"not bit-equal ({differ})")
    return result


def in_turns(kernel: str, label: str, calls: dict) -> dict:
    """``calls`` (one launch each, "earlier", "new" and any variants) in
    turns earlier, new, variants..., the variants reversed, new, earlier:
    per turn the call on CUDA events (the median of 3 batches of 5) and
    the kernel alone (windows of 5 calls under the profiler); the means of
    each side's turns (None: not measured)."""
    middle = [side for side in calls if side not in ("earlier", "new")]
    order = ["earlier", "new", *middle, *reversed(middle), "new", "earlier"]
    turns = []
    for side in order:
        call = calls[side]
        smoke.cuda_ms(call, 2)
        ms = statistics.median(smoke.cuda_ms(call, 5) for _ in range(3))
        alone = smoke.alone_ms(call, kernel, f"[ab] {kernel} {label} {side}",
                               counted=side == "new")
        turns.append({"side": side, "ms": ms, "alone_ms": alone})
    result = {"turns": turns}
    for side in calls:
        for key in ("ms", "alone_ms"):
            values = [t[key] for t in turns if t["side"] == side]
            result[f"{side}_{key}"] = None if None in values else statistics.mean(values)
    return result


def timings(sides: dict, inputs: dict) -> dict:
    """Row 1 on frame 1 and the lane mode on tile 0, 4 bounces, in turns."""
    results = {}
    for label in (next(iter(inputs)), next(k for k in inputs if k.endswith("tile 0"))):
        kernel, scene, o, d, seed, lane = inputs[label]
        calls = {side: (lambda call=call: call(kernel, scene, o, d, seed, lane, smoke.BOUNCES))
                 for side, call in sides.items()}
        results[label] = {"kernel": kernel, "rays": o.shape[0],
                          **in_turns(kernel, label, calls)}
        print(f"[ab] {kernel} {label}: {json.dumps(results[label])}")
    return results


def wasted_share(scene, origins, directions, seed) -> dict:
    """Frame 1's path lengths (the bounces each ray starts alive, from the
    plain per-bounce sphere version) and the share of the nearest sweeps'
    lane-slots that a warp of 32 consecutive rays, running as long as its
    longest path, spends on finished paths."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    rays = origins.shape[0]
    device = origins.device
    state = (origins, directions, torch.ones_like(origins),
             torch.ones((rays,), dtype=torch.bool, device=device))
    lane = torch.arange(rays, dtype=torch.int32, device=device)
    lengths = torch.zeros((rays,), dtype=torch.int64, device=device)
    alive_share = []
    for bounce in range(smoke.BOUNCES):
        alive = state[3]
        alive_share.append(alive.float().mean().item())
        lengths += alive
        out = kernels.sphere_bounce_reference(scene, *state, lane, rays, seed, bounce,
                                              total_bounces=smoke.BOUNCES)
        state = (out.origins, out.directions, out.throughput, out.alive)
    pad = -rays % 32
    warps = torch.nn.functional.pad(lengths, (0, pad)).view(-1, 32)
    needed = int(lengths.sum())
    issued = 32 * int(warps.max(dim=1).values.sum())
    return {
        "rays": rays, "alive_share_by_bounce": alive_share, "needed_lane_sweeps": needed,
        "one_thread_a_ray_lane_slots": issued, "wasted_share": 1.0 - needed / issued,
        "needed_sweeps_per_ray": needed / rays, "issued_sweeps_per_ray": issued / rays,
    }


def frames_per_s(parent_tree: Path, path: int, name: str) -> dict:
    """The whole-frame and tiled frames/s of chip_smoke's main path
    ``PATHS[path]`` (``name``) in the parent's checkout and in this one
    (``TREE_FPS``, a fresh process in each checkout's root) in turns parent,
    new, new, parent, twice; each side's turns and their range, the host's
    spread."""
    trees = {"earlier": parent_tree.resolve(), "new": smoke.REPO}
    turns = []
    for side in ("earlier", "new", "new", "earlier") * 2:
        done = subprocess.run([sys.executable, "-c", TREE_FPS.replace("PATH_INDEX", str(path))],
                              cwd=trees[side], capture_output=True, text=True, timeout=600)
        smoke.check(done.returncode == 0, f"frames/s in {trees[side]} failed:\n{done.stderr}")
        turns.append({"side": side, **json.loads(done.stdout.strip().splitlines()[-1])})
    result = {"turns": turns}
    for side in trees:
        for key in ("whole_fps", "tiled_fps"):
            values = [t[key] for t in turns if t["side"] == side]
            result[f"{side}_{key}"] = {"mean": statistics.mean(values), "min": min(values),
                                       "max": max(values)}
    print(f"[ab] {name} frames/s, whole and tiled, parent and new in turns: {json.dumps(result)}")
    return result


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def builds_of(args, digests: dict, earlier_argtypes: dict, names: tuple[str, ...]):
    """Checks the earlier sources and builds them, the new ones (for their
    ptxas report and occupancy; the port's wrappers launch their own build)
    and each ``--variant``: (earlier, {"new": ..., variant: ...})."""
    from tpu_render_cluster_torch.render import _build, kernels

    check_earlier(args.earlier, digests)
    directories = {"earlier": args.earlier, "new": _build.CSRC_DIR}
    directories.update((name, Path(directory)) for name, _, directory in
                       (spec.partition("=") for spec in args.variant))
    builds = build(directories, {side: earlier_argtypes if side == "earlier" else
                                 kernels._LAUNCH_ARGTYPES for side in directories}, names)
    return builds.pop("earlier"), builds


def row1_main(args) -> int:
    import torch

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    built, builds = builds_of(args, EARLIER_SHA256, EARLIER_ARGTYPES, smoke.ROW1)
    variants = {side: b for side, b in builds.items() if side != "new"}
    inputs = shapes(device)
    frame_rays = inputs[next(iter(inputs))][2].shape[0]
    tile_rays = inputs[next(k for k in inputs if k.endswith("tile 0"))][2].shape[0]
    resources = {}
    for name, rays in zip(smoke.ROW1, (frame_rays, tile_rays)):
        resources[name] = {"earlier": {
            "ptxas": built[name][2],
            "register_limited_blocks_per_sm": register_blocks(built[name][2], THREADS)}}
        for side, sources in builds.items():
            occupancy, grid = sources[name][1], ctypes.c_int()
            resources[name][side] = {
                "ptxas": sources[name][2],
                "blocks_per_sm": None if occupancy is None else occupancy(
                    rays, ctypes.addressof(grid)),
                "rays": rays, "grid_blocks": grid.value}
        print(f"[ab] {name} ptxas, resident blocks and grid: {json.dumps(resources[name])}")
    sides = sides_of(built, variants)
    frame = inputs[next(iter(inputs))]
    result = {
        "card": card,
        "resources": resources,
        "one_thread_a_ray_schedule": wasted_share(frame[1], *frame[2:5]),
    }
    print(f"[ab] one-thread-a-ray schedule on frame 1: "
          f"{json.dumps(result['one_thread_a_ray_schedule'])}")
    result["bit_equal"] = check_bits(sides, inputs)
    result["timings"] = timings(sides, inputs)
    if args.fps_tree is not None:
        result["frames_per_s"] = frames_per_s(args.fps_tree, 0, "04")
    print(json.dumps(result))
    return 0


# ---------------------------------------------------------------------------
# The key pass (csrc/mesh_entry_keys.cu) against commit 9ef44af's build


def key_launches(device) -> list[dict]:
    """Every ``mesh_bounce_tlas`` launch of frames 1 and 2 of the 03
    wavefront path whole and of tile 0 of its frame 1
    (``smoke.key_pass_launches``), frame 2's marked ``second``."""
    launches = smoke.key_pass_launches(device, frames=2)
    second = f"03 frame {smoke.job_frames(smoke.PATHS[2])[1][1]}"
    for launch in launches:
        launch["second"] = launch["unit"] == second
    return launches


def key_call(entry, counted: bool, launch: dict):
    """One launch of a built key pass (``counted``: the port's C entry, with
    a work counter; else the earlier one) on a launch's outputs, as the
    port's wrapper makes it; the key column."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    mesh, out = launch["mesh"], launch["out"]
    device = out.origins.device
    frame = kernels.tlas_frame(mesh)
    k = frame.slots.shape[0]
    rays = out.origins.shape[0]
    key = torch.empty((rays,), dtype=torch.int32, device=device)
    live = kernels._live_tensor(launch["live"], device)
    stream = torch.cuda.current_stream(device).cuda_stream
    # A build of this package's ABI: the work counter, then the node format
    # (fp32: tier 0, no grid, no hit column).
    walk = (kernels._work_counter(device, stream).data_ptr(), 0, None, None) if counted else ()
    status = entry(
        out.origins.data_ptr(), out.directions.data_ptr(), out.alive.data_ptr(), rays,
        live.data_ptr(), frame.slots.data_ptr(), k, frame.octant_node_bounds.data_ptr(),
        kernels.tlas_octant_links(k, device).data_ptr(), frame.node_bounds.shape[0],
        frame.key_window.data_ptr(), launch["bounce"], smoke.BOUNCES, key.data_ptr(), *walk,
        stream,
    )
    smoke.check(status == 0, f"a built key pass failed ({status})")
    return key


def key_sides(built: dict, variants: dict) -> dict:
    """Per side, ``call(launch)``: the earlier build, the port's wrapper,
    each variant."""
    from tpu_render_cluster_torch.render import kernels

    def port(launch):
        out = launch["out"]
        return kernels.entry_keys(launch["mesh"], out.origins, out.directions, out.alive,
                                  launch["live"], launch["bounce"], total_bounces=smoke.BOUNCES)

    sides = {"earlier": lambda launch: key_call(built["mesh_entry_keys"][0], False, launch),
             "new": port}
    for name, builds in variants.items():
        sides[name] = (lambda launch, entry=builds["mesh_entry_keys"][0]:
                       key_call(entry, True, launch))
    return sides


def check_keys(sides: dict, launches: list[dict]) -> dict:
    """Every side's key column equal on every lane to the new kernel's (the
    earlier build, each variant), the new kernel's equal to its plain
    version and to the key column the bounce's wrapper wrote; differing
    lanes per launch."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    result = {}
    for launch in launches:
        out = launch["out"]
        new = sides["new"](launch)
        plain = kernels.entry_keys_reference(launch["mesh"], out.origins, out.directions,
                                             out.alive, launch["live"], launch["bounce"],
                                             total_bounces=smoke.BOUNCES)
        differ = {"plain": int((new != plain).sum()), "bounce": int((new != out.key).sum())}
        for side, call in sides.items():
            if side != "new":
                differ[side] = int((call(launch) != new).sum())
        torch.cuda.synchronize()
        result[launch["label"]] = differ
        print(f"[ab] mesh_entry_keys {launch['label']}, {launch['lanes']} lanes, live "
              f"{launch['live']}: lanes differing from the new kernel's: {json.dumps(differ)}")
        smoke.check(not any(differ.values()), f"mesh_entry_keys {launch['label']}: not "
                                              f"bit-equal ({differ})")
    return result


def key_timings(sides: dict, launches: list[dict]) -> dict:
    """Each launch in turns (``in_turns``), then per frame and the tile the
    sum over its launches of each side's means."""
    results = {}
    for launch in launches:
        calls = {side: (lambda call=call, launch=launch: call(launch))
                 for side, call in sides.items()}
        results[launch["label"]] = {"lanes": launch["lanes"], "live": launch["live"],
                                    **in_turns("mesh_entry_keys", launch["label"], calls)}
        print(f"[ab] mesh_entry_keys {launch['label']}: {json.dumps(results[launch['label']])}")
    totals = {}
    for launch in launches:
        unit, timing = launch["unit"], results[launch["label"]]
        for side in sides:
            for key in ("ms", "alone_ms"):
                name = f"{side}_{key}"
                totals.setdefault(unit, {}).setdefault(name, 0.0)
                value = timing[name]
                if value is None or totals[unit][name] is None:
                    totals[unit][name] = None
                else:
                    totals[unit][name] += value
    print(f"[ab] mesh_entry_keys summed over each frame's and the tile's launches: "
          f"{json.dumps(totals)}")
    return {"launches": results, "sums": totals}


def key_resources(built: dict, builds: dict, launches: list[dict]) -> dict:
    """Each build's ptxas lines; each build with the port's C entries its
    resident blocks per SM, staged bytes and grid at each launch of frame 1
    and the tile (the ``mesh_entry_keys_occupancy`` entry)."""
    from tpu_render_cluster_torch.render import kernels

    resources = {"earlier": {
        "ptxas": built["mesh_entry_keys"][2],
        "register_limited_blocks_per_sm": register_blocks(built["mesh_entry_keys"][2], THREADS)}}
    for side, sources in builds.items():
        _, occupancy, lines = sources["mesh_entry_keys"]
        per_launch = {}
        for launch in launches:
            if occupancy is None or launch["second"]:
                continue
            frame = kernels.tlas_frame(launch["mesh"])
            persistent, staged, grid = (ctypes.c_int() for _ in range(3))
            blocks = occupancy(launch["lanes"], frame.slots.shape[0], frame.node_bounds.shape[0],
                               ctypes.addressof(persistent), ctypes.addressof(staged),
                               ctypes.addressof(grid), 0)
            per_launch[launch["label"]] = {"persistent": bool(persistent.value),
                                           "blocks_per_sm": blocks,
                                           "shared_bytes": staged.value,
                                           "grid_blocks": grid.value}
        resources[side] = {"ptxas": lines, "launches": per_launch}
    print(f"[ab] mesh_entry_keys ptxas, resident blocks, staged bytes and grid: "
          f"{json.dumps(resources)}")
    return resources


def keys_main(args) -> int:
    import torch

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    built, builds = builds_of(args, KEYS_EARLIER_SHA256, KEYS_EARLIER_ARGTYPES,
                              ("mesh_entry_keys",))
    variants = {side: b for side, b in builds.items() if side != "new"}
    launches = key_launches(device)
    sides = key_sides(built, variants)
    result = {"card": card, "resources": key_resources(built, builds, launches)}
    result["bit_equal"] = check_keys(sides, launches)
    result["timings"] = key_timings(sides, launches)
    if args.fps_tree is not None:
        result["frames_per_s"] = frames_per_s(args.fps_tree, 2, "03 wavefront")
    print(json.dumps(result))
    return 0


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    modes = parser.add_subparsers(dest="mode", required=True)
    for mode, parent in (("row1", "66abd34"), ("keys", "9ef44af")):
        sub = modes.add_parser(mode, help=f"against commit {parent}'s csrc/")
        sub.add_argument("earlier", type=Path)
        sub.add_argument("--variant", action="append", default=[], metavar="NAME=CSRC")
        sub.add_argument("--fps-tree", type=Path, metavar="PARENT_CHECKOUT",
                         help="the parent commit's checkout: also the frames/s in turns")
    args = parser.parse_args(argv)
    return row1_main(args) if args.mode == "row1" else keys_main(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
