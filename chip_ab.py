"""Time the two kernels last redesigned for Hopper against the builds of the
sources they replaced, in one run on one CUDA GPU: the packet vote
(``csrc/packet_octants.cu``) and row 3 TLAS (``csrc/trace_fused_mesh_tlas.cu``).

Usage (from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit; the earlier sources are those of commit a5c1792):

    mkdir -p .chip_scratch/parent_csrc
    git archive a5c1792 tpu_render_cluster_torch/render/csrc \\
        | tar -x --strip-components=3 -C .chip_scratch/parent_csrc
    python3 chip_ab.py .chip_scratch/parent_csrc

The earlier C entries differ from the port's (the vote takes no frame ids,
the megakernel no work counter), so the script binds them only to the
sources it was written for, checked by their sha256, and refuses others.
Each is built with the port's nvcc flags. Then, at the widths of PERF.md
section 6:

- the vote at row 4 TLAS's four launches of a deep wavefront frame and at
  the deep pool's first window's launches of ``chip_smoke.pool_launch_roles``
  and its 8-frame shuffled launch: the new kernel exactly against its plain
  version and against the earlier one on the rows it votes (the earlier
  votes every row), with the rows voted and the bound (``chip_smoke.vote_rows``);
- row 3 TLAS at frames 1 and 2 of the 02 path in both walk orders, bit-equal
  to the earlier kernel on every ray;
- each call in turns earlier, new, new, earlier: its wrapper on CUDA events
  (the median of 3 batches of 5) and the kernel alone under the profiler
  (windows of 5 calls), and the means of each side's two turns;
- both kernels' ptxas lines, earlier and new, with the new one's resident
  blocks per SM (``chip_smoke.redesign_resources``).

Prints the card's name and power limit, a ``[ab]`` line a measurement, and
as its last line one JSON object of all of them. Exits non-zero on a failed
check and without CUDA.
"""

from __future__ import annotations

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
    "packet_octants.cu": "9efdc96bc374ea8e1d617e7981054ca9692d54847a501f5bfe59d17ecf4e9659",
    "trace_fused_mesh_tlas.cu": "f520ca0dd172b778c88df4954e87fc96a368a8ea38efe30c4b6a7bf33f848c1e",
    "mesh_common.cuh": "b10f0200a614241bc45164313a6d2c693555a1aa662b116df57c0a7ead90f7fe",
    "path_common.cuh": "3be1d00b5e296855a5a7842d704bd840db3b9364b3f7010bd3813d3a1d48212e",
}
_P, _I = ctypes.c_void_p, ctypes.c_int
EARLIER_ARGTYPES = {
    # directions, n_rays, live count, block, instances, n_instances,
    # tlas_out, slot_out, stream
    "packet_octants": [_P, _I, _P, _I, _P, _I, _P, _P, _P],
    # origins, directions, n_rays, spheres, n_spheres, params, instances,
    # n_instances, triangles, n_tri_rows, node bounds and links, n_nodes,
    # TLAS bounds and links, n_tlas_nodes, ordered, seed, max_bounces,
    # radiance, stream
    "trace_fused_mesh_tlas": [_P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I,
                              _I, _I, _P, _P],
}


def build_earlier(directory: Path) -> dict:
    """The earlier builds of the two kernels, one nvcc each, at once: name
    -> (its C launch entry, ptxas's resource lines)."""
    from tpu_render_cluster_torch.render import _build

    for name, digest in EARLIER_SHA256.items():
        path = directory / name
        smoke.check(path.is_file() and hashlib.sha256(path.read_bytes()).hexdigest() == digest,
                    f"{path}: not the source that chip_ab.py's earlier entries are bound to")
    out = directory / "build"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {
        name: subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(directory / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in smoke.REDESIGNED
    }
    built = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        smoke.check(job.returncode == 0, f"the earlier {name}.cu did not build:\n{log}")
        entry = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), f"{name}_launch")
        entry.argtypes = EARLIER_ARGTYPES[name]
        entry.restype = ctypes.c_int
        built[name] = (entry, _build.resource_lines(log))
    return built


def register_blocks(lines: list[str], threads: int) -> int | None:
    """Blocks of ``threads`` threads an SM's 65,536 registers hold at the
    largest register count of a ptxas report (allocated 8 a thread at a
    time)."""
    counts = [int(m.group(1)) for line in lines for m in [re.search(r"Used (\d+) registers", line)]
              if m]
    return 65536 // (-(-max(counts) // 8) * 8 * threads) if counts else None


def earlier_votes(entry, directions, table, live: int, block: int, world: bool):
    """The earlier vote pass: every row voted."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    device = directions.device
    directions = directions.contiguous()
    packets = -(-directions.shape[0] // block)
    tlas_out = torch.empty((packets,), dtype=torch.uint8, device=device) if world else None
    slot_out = torch.empty((packets, table.shape[0]), dtype=torch.uint8, device=device)
    status = entry(
        directions.data_ptr(), directions.shape[0],
        kernels._live_tensor(live, device).data_ptr(), block, table.data_ptr(), table.shape[0],
        kernels._pointer(tlas_out), slot_out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    smoke.check(status == 0, f"the earlier packet_octants failed ({status})")
    return tlas_out, slot_out


def earlier_megakernel(entry, scene, mesh, origins, directions, seed):
    """The earlier TLAS megakernel on one launch's rays."""
    from tpu_render_cluster_torch.render import kernels

    spheres, params = kernels._sphere_operands(scene)
    origins, directions, radiance, stream = kernels._ray_operands(origins, directions)
    ordered = kernels.walks_ordered(mesh.bvh)
    status = entry(
        origins.data_ptr(), directions.data_ptr(), origins.shape[0], spheres.data_ptr(),
        spheres.shape[0], params.data_ptr(), *kernels._mesh_tables(mesh, True, ordered),
        int(ordered), int(seed), smoke.BOUNCES, radiance.data_ptr(), stream,
    )
    smoke.check(status == 0, f"the earlier trace_fused_mesh_tlas failed ({status})")
    return radiance


def in_turns(kernel: str, label: str, calls: dict) -> dict:
    """``calls`` ("earlier" and "new", one launch each) in turns earlier,
    new, new, earlier: per turn the call on CUDA events (the median of 3
    batches of 5) and the kernel alone (windows of 5 calls under the
    profiler); the means of each side's two turns (None: not measured)."""
    turns = []
    for side in ("earlier", "new", "new", "earlier"):
        call = calls[side]
        smoke.cuda_ms(call, 2)
        ms = statistics.median(smoke.cuda_ms(call, 5) for _ in range(3))
        alone = smoke.alone_ms(call, kernel, f"[ab] {kernel} {label} {side}",
                               counted=side == "new")
        turns.append({"side": side, "ms": ms, "alone_ms": alone})
    result = {"turns": turns}
    for side in ("earlier", "new"):
        for key in ("ms", "alone_ms"):
            values = [t[key] for t in turns if t["side"] == side]
            result[f"{side}_{key}"] = None if None in values else statistics.mean(values)
    return result


def pool_first(device) -> dict:
    """The deep pool path's first window at the main path's size, iterated
    to its end: its launches of ``chip_smoke.pool_launch_roles`` and the
    mixed launch with its lanes given frame ids 0-7 at random (each its
    frame's seed) and shuffled, as ``chip_smoke.vote_launches`` takes them."""
    import torch

    from tpu_render_cluster_torch.render import raypool

    path = smoke.PATHS[4]
    _, frames = smoke.job_frames(path)
    window = raypool.PoolWindow(
        path.scene, frames[:raypool.RAYPOOL_FRAMES], width=smoke.WIDTH, height=smoke.HEIGHT,
        samples=smoke.SAMPLES, max_bounces=smoke.BOUNCES, device=device, use_tlas=path.use_tlas,
    )
    launches: list = []
    state = window.initial_state()
    while bool(window.more(state)):
        state = window.iteration(state, len(launches), launches.append)
    roles = smoke.pool_launch_roles(launches, window)
    picked = {role: {"index": index, "live": int(launches[index].live)}
              for role, index in roles.items()}
    generator = torch.Generator(device=device).manual_seed(8)
    mixed = list(launches[roles["mixed"]].state)
    fid = torch.randint(0, len(window.frames), (window.pool,), generator=generator,
                        device=device, dtype=torch.int32)
    mixed[5], mixed[6] = fid, window.seeds[fid.long()]
    perm = torch.randperm(window.pool, generator=generator, device=device)
    return {"window": window, "picked": picked,
            "launches": {i: launches[i] for i in roles.values()},
            "unsorted": [t[perm] for t in mixed]}


def vote_ab(built: dict, first: dict, device) -> dict:
    """The vote pass on each launch of ``chip_smoke.vote_launches``: exact
    against its plain version and the earlier kernel (on the rows it
    votes; 0 elsewhere), its rows and bound, and the turns."""
    import torch

    from tpu_render_cluster_torch.render import kernels

    entry = built["packet_octants"][0]
    results = {}
    for launch in smoke.vote_launches(first, device):
        args, options = launch["args"], launch["options"]
        directions, table, live = args
        block, world = options["block"], options["world"]
        new = lambda args=args, options=options: kernels.packet_votes(*args, **options)  # noqa: E731
        old = lambda d=directions, t=table, live=live, world=world: earlier_votes(  # noqa: E731
            entry, d, t, live, block, world)
        got, plain, earlier = new(), kernels.packet_votes_reference(*args, **options), old()
        differ = sum(int((a != b).sum()) for a, b in zip(got, plain) if a is not None)
        smoke.check(differ == 0, f"packet_octants {launch['label']}: {differ} votes differ "
                                 f"from plain")
        result = smoke.vote_rows(launch, device)
        carried = result.pop("carried")
        mask = (torch.ones_like(got[1], dtype=torch.bool) if carried is None else
                carried[:, torch.arange(table.shape[0], device=device) // options["per_frame"]])
        differ = int((got[1] != torch.where(mask, earlier[1], 0)).sum())
        if world:
            differ += int((got[0] != earlier[0]).sum())
        smoke.check(differ == 0, f"packet_octants {launch['label']}: {differ} votes differ from "
                                 f"the earlier kernel's on the rows voted")
        result.update(in_turns("packet_octants", launch["label"], {"earlier": old, "new": new}))
        results[launch["label"]] = result
        print(f"[ab] packet_octants {launch['label']}: {json.dumps(result)}")
    return results


def megakernel_ab(built: dict, device) -> dict:
    """Row 3 TLAS at frames 1 and 2 of the 02 path (2,097,152 rays each) in
    both walk orders: bit-equal to the earlier kernel, and the turns; the
    two frames' means alone."""
    import torch

    entry = built["trace_fused_mesh_tlas"][0]
    path = smoke.PATHS[1]
    results = {}
    for ordered in (True, False):
        order = "ordered" if ordered else "canonical"
        for frame in smoke.job_frames(path)[1][:2]:
            trace = smoke.Trace("trace_fused_mesh_tlas", path.scene, frame, device)
            rays = smoke.frame_rays(path.scene, frame, device)
            label = f"02 frame {frame} {order}"
            with smoke.walk_order(ordered):
                new = lambda trace=trace, rays=rays: trace.run(*rays, smoke.BOUNCES)  # noqa: E731
                old = lambda trace=trace, rays=rays: earlier_megakernel(  # noqa: E731
                    entry, trace.scene, trace.mesh, *rays)
                differ = int((new() != old()).any(dim=1).sum())
                torch.cuda.synchronize()
                smoke.check(differ == 0, f"trace_fused_mesh_tlas {label}: {differ} rays differ "
                                         f"from the earlier kernel's")
                results[label] = in_turns("trace_fused_mesh_tlas", label,
                                          {"earlier": old, "new": new})
            print(f"[ab] trace_fused_mesh_tlas {label}: {json.dumps(results[label])}")
        for side in ("earlier", "new"):
            values = [r[f"{side}_alone_ms"] for label, r in results.items()
                      if label.endswith(order)]
            results[f"two frames' mean, {order}, {side} alone ms"] = (
                None if None in values else statistics.mean(values))
    return results


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    if len(argv) != 1:
        print("usage: python3 chip_ab.py EARLIER_CSRC", file=sys.stderr)
        return 2

    from tpu_render_cluster_torch.render import _build

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    built = build_earlier(Path(argv[0]))
    _build.build()
    first = pool_first(device)
    resources = smoke.redesign_resources(first, device)
    for name, threads in (("packet_octants", 256), ("trace_fused_mesh_tlas", 256)):
        lines = built[name][1]
        resources[name]["earlier"] = {
            "ptxas": lines, "register_limited_blocks_per_sm": register_blocks(lines, threads)}
        print(f"[ab] {name} ptxas, earlier: {json.dumps(resources[name]['earlier'])}")
    result = {
        "card": card,
        "resources": resources,
        "packet_octants": vote_ab(built, first, device),
        "trace_fused_mesh_tlas": megakernel_ab(built, device),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
