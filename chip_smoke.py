"""Drive the PyTorch port on one CUDA GPU and check every kernel of its paths.

Usage (from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit):

    python3 chip_smoke.py

Two main paths, one per kernel: whole frames of the sphere scene
04_very-simple through ``trace_fused`` and of the mesh scene
02_physics-mesh through ``trace_fused_mesh``. Phases, each of which raises
(exit code 1) if its check fails:
1. the card: name and power limit as nvidia-smi reports them;
2. build every CUDA source of the port with nvcc (sm_90a), one nvcc per
   source, all at once, timed;
3. each kernel against its plain PyTorch version on the card at 128x128,
   4 spp, 1 and 4 bounces, at the tolerances of tests/test_torch_kernels.py
   and tests/test_torch_kernels_mesh.py (the mesh kernel also on the deep
   icosphere tree of 03_physics-2-mesh, called directly);
4. each main path: the first 10 frames of a job file loaded through the
   port's job model and rendered by TorchRaytraceBackend at 512x512, 8 spp,
   4 bounces. The launch counts are zeroed just before each path and read
   just after: its kernel must have launched once per frame and no plain
   version run. Every PNG must decode with non-trivial content, and frame 1
   must match the plain version's render of the same frame;
5. timings: each path's per-frame phases and frames/s, a breakdown of one
   frame, and each kernel's time (its wrapper's calls, CUDA events, the
   median of 10 batches of 20) beside its bound, its plain version's time
   and the host time of one wrapper call;
6. under torch.profiler (reported, not checked: the numbers read "not
   measured" where the profiler sees no device time): each kernel's own
   device time apart from its wrapper's set-up kernels, and the card's
   idle share over two frames of each main path.

Prints a ``{"kernels": [...]}`` line, then the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Without CUDA, or
without the port beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, SAMPLES, BOUNCES = 512, 512, 8, 4
# Published H100 SXM peaks (dense): float32 outside the tensor cores, and
# device memory bandwidth.
FP32_PEAK_FLOPS = 67e12
MEMORY_BYTES_PER_S = 3.35e12
# Operations per unit of work of the megakernels, counted from their CUDA
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
OPS_SHADE_HIT = 200
OPS_SLAB = 25
OPS_INSTANCE_WALK = 48
OPS_TRIANGLE = 54

PATHS = {
    # kernel -> (job file, scene)
    "trace_fused": (
        "blender-projects/04_very-simple/04_very-simple_demo_10f-1w.toml", "04_very-simple"
    ),
    "trace_fused_mesh": (
        "blender-projects/02_physics/02_physics-mesh_240f-4w_tpu-batch_tpu-raytrace.toml",
        "02_physics-mesh",
    ),
}
REPLACES = {
    "trace_fused": "tpu_render_cluster/render/pallas_kernels.py:901",
    "trace_fused_mesh": "tpu_render_cluster/render/pallas_kernels.py:3205",
}
TOLERANCE = {
    "trace_fused": "rtol=atol=1e-4 per ray; all rays at 1 bounce, >=99.9% at 4",
    "trace_fused_mesh": (
        "rtol=atol=1e-4 per ray; at 1 bounce all but max(1, round(0.001 R)) edge-tie rays, "
        ">=99.9% at 4"
    ),
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


def device_time(fn, kernel_symbol: str) -> dict | None:
    """One run of ``fn`` under torch.profiler (CUPTI): its wall ms, the
    summed device ms of every kernel it ran, and that of the kernels whose
    name holds ``kernel_symbol``. None where the profiler records no device
    time (then these numbers are not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as trace:
        started = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - started) * 1e3
    events = [e for e in trace.key_averages() if e.self_device_time_total > 0]
    if not events:
        return None
    return {
        "wall_ms": wall_ms,
        "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
        "kernel_ms": sum(e.self_device_time_total for e in events if kernel_symbol in e.key) / 1e3,
        "kernels": sum(e.count for e in events),
    }


def profiled(fn, kernel_symbol: str, label: str) -> dict | None:
    """``device_time`` that reports, and does not raise, when the
    profiler cannot trace the card."""
    try:
        result = device_time(fn, kernel_symbol)
    except Exception as error:  # noqa: BLE001 - the profiler is optional here
        print(f"[6] {label}: profiler failed ({type(error).__name__}: {error}); not measured")
        return None
    if result is None:
        print(f"[6] {label}: the profiler recorded no device time; not measured")
    return result


class Trace:
    """One kernel's wrapper and plain version, bound to a scene's inputs."""

    def __init__(self, kernel: str, scene_name: str, frame: int, device):
        from tpu_render_cluster_torch.render import kernels
        from tpu_render_cluster_torch.render.mesh import scene_mesh_set
        from tpu_render_cluster_torch.render.scene import build_scene

        self.kernels = kernels
        self.kernel = kernel
        self.scene = build_scene(scene_name, frame, device)
        self.mesh = None
        if kernel == "trace_fused_mesh":
            # Any mesh, also one past the dispatch bound (a direct call).
            self.mesh = scene_mesh_set(scene_name, frame, device=device)

    def run(self, origins, directions, seed, max_bounces):
        if self.mesh is None:
            return self.kernels.trace_paths_fused(
                self.scene, origins, directions, seed, max_bounces=max_bounces
            )
        return self.kernels.trace_paths_fused_mesh(
            self.scene, self.mesh, origins, directions, seed, max_bounces=max_bounces
        )

    def plain(self, origins, directions, seed, max_bounces, stats=None):
        if self.mesh is None:
            return self.kernels.trace_paths_fused_reference(
                self.scene, origins, directions, seed, max_bounces=max_bounces, stats=stats
            )
        return self.kernels.trace_paths_fused_mesh_reference(
            self.scene, self.mesh, origins, directions, seed, max_bounces=max_bounces,
            stats=stats,
        )


def kernel_vs_plain(kernel: str, scene_name: str, device) -> tuple[float, float]:
    """Phase 3 for one kernel and scene: (lowest agreeing fraction, max abs
    error) over 1 and 4 bounces at 128x128x4 spp."""
    import torch

    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed

    frame = 7 if kernel == "trace_fused" else 30
    trace = Trace(kernel, scene_name, frame, device)
    origins, directions, seed = frame_rays_and_seed(
        scene_camera(scene_name, frame, device), frame, width=128, height=128, samples=4
    )
    agree_min, max_err = 1.0, 0.0
    for max_bounces in (1, 4):
        got = trace.run(origins, directions, seed, max_bounces)
        expected = trace.plain(origins, directions, seed, max_bounces)
        torch.cuda.synchronize()
        fraction, bad, err = agreement(got, expected)
        bit_equal = (got == expected).all(dim=1).float().mean().item()
        print(
            f"[3] {kernel} vs plain, {scene_name}, 128x128x4 spp, {max_bounces} bounce(s): "
            f"{fraction:.6f} of rays within 1e-4 ({bad} not), {bit_equal:.6f} bit-equal, "
            f"max abs err {err:.3g}"
        )
        check(torch.isfinite(got).all().item(), f"non-finite radiance ({kernel}, {scene_name})")
        if max_bounces == 4:
            check(fraction >= 0.999, f"{kernel} {scene_name} 4 bounces: {fraction} < 0.999")
        elif kernel == "trace_fused":
            check(bad == 0, f"{kernel} {scene_name} 1 bounce: {bad} rays disagree")
        else:
            budget = max(1, round(0.001 * got.shape[0]))
            check(bad <= budget, f"{kernel} {scene_name} 1 bounce: {bad} rays > budget {budget}")
        agree_min = min(agree_min, fraction)
        max_err = max(max_err, err)
    return agree_min, max_err


def drive_main_path(kernel: str, device) -> dict:
    """Phase 4 for one path: the first 10 frames of its job through the
    backend, with the launch counts zeroed just before and read just after."""
    import numpy as np
    import torch
    from PIL import Image

    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.render import kernels
    from tpu_render_cluster_torch.render.scene import scene_for_job_name
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

    job_file, scene_name = PATHS[kernel]
    job = BlenderJob.load_from_file(REPO / job_file)
    check(scene_for_job_name(job.job_name) == scene_name, f"{job.job_name} is not {scene_name}")
    frames = list(job.frame_indices())[:10]
    check(len(frames) == 10, f"expected 10 frames of {job.job_name}, got {len(frames)}")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as base:
        backend = TorchRaytraceBackend(
            width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES,
            base_directory=base,
        )
        check(backend.device.type == "cuda", f"backend chose {backend.device}")
        backend.warm(job.job_name)
        torch.cuda.synchronize()
        kernels.reset_counts()
        started = time.perf_counter()
        timings = [asyncio.run(backend.render_frame(job, f)) for f in frames]
        path_s = time.perf_counter() - started
        launches = dict(kernels.counts)
        print(f"[4] main path: {len(frames)} frames of {job.job_name} in {path_s:.4f} s; counts {launches}")
        for name, count in launches.items():
            expected = len(frames) if name == kernel else 0
            check(count == expected, f"{job.job_name}: {name} ran {count} times, not {expected}")

        outputs = sorted((Path(base) / "blender-projects").rglob("*.png"))
        check(len(outputs) == len(frames), f"{len(outputs)} PNGs for {len(frames)} frames")
        for path in outputs:
            pixels = np.array(Image.open(path))
            check(pixels.shape == (HEIGHT, WIDTH, 3), f"{path.name}: {pixels.shape}")
            check(pixels.astype(np.float32).std() > 5.0, f"{path.name} is flat")
        first = torch.from_numpy(np.array(Image.open(outputs[0])))

        # Two frames again under the profiler, for the card's idle share.
        profiled_frames: list = []
        frame_profile = profiled(
            lambda: profiled_frames.extend(
                asyncio.run(backend.render_frame(job, f)) for f in frames[:2]
            ),
            f"{kernel}_kernel", f"{scene_name} frames",
        )
        if frame_profile is not None:
            render_ms = sum(
                (t.finished_rendering_at - t.started_rendering_at) * 1e3 for t in profiled_frames
            )
            print(
                f"[6] {scene_name}, 2 frames under the profiler: wall {frame_profile['wall_ms']:.3f} "
                f"ms, device busy {frame_profile['device_ms']:.3f} ms "
                f"({frame_profile['kernels']} kernels; megakernel {frame_profile['kernel_ms']:.3f} "
                f"ms); device idle {1 - frame_profile['device_ms'] / frame_profile['wall_ms']:.4f} "
                f"of the frames, {1 - frame_profile['device_ms'] / render_ms:.4f} of their render "
                f"phases ({render_ms:.3f} ms)"
            )
    return {
        "scene": scene_name, "frames": frames, "timings": timings, "path_s": path_s,
        "launches": launches[kernel], "first": first,
    }


def frame_vs_plain(kernel: str, run: dict, device) -> tuple[Trace, tuple, dict, float]:
    """Frame 1 of a main path against the plain version's render of it.
    Returns the frame's (trace, rays, work counters, the plain version's
    ms on the card for this frame, its work counting included)."""
    import torch

    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed, tonemap

    frame, scene_name = run["frames"][0], run["scene"]
    trace = Trace(kernel, scene_name, frame, device)
    rays = frame_rays_and_seed(
        scene_camera(scene_name, frame, device), frame, width=WIDTH, height=HEIGHT, samples=SAMPLES
    )
    stats: dict = {}
    result: list = []
    plain_ms = cuda_ms(lambda: result.append(trace.plain(*rays, BOUNCES, stats)), 1)
    plain = result[0]
    image = plain.reshape(SAMPLES, HEIGHT * WIDTH, 3).mean(dim=0).reshape(HEIGHT, WIDTH, 3)
    diff = (run["first"].int() - tonemap(image).cpu().int()).abs()
    within = (diff <= 1).float().mean().item()
    print(f"[4] {scene_name} frame {frame} vs plain-version render: {within:.6f} of uint8 values within 1")
    check(within >= 0.995, f"{scene_name}: main-path frame disagrees with the plain version ({within})")
    fraction, bad, err = agreement(trace.run(*rays, BOUNCES), plain)
    torch.cuda.synchronize()
    print(f"[4] {scene_name} frame {frame} rays, kernel vs plain: {fraction:.6f} within 1e-4 ({bad} not), max abs err {err:.3g}")
    check(fraction >= 0.999, f"{scene_name}: main-path rays disagree ({fraction})")
    return trace, rays, stats, plain_ms


def bound(stats: dict, rays: int) -> tuple[float, str, float, float]:
    """(bound ms, "operations" or "bytes", operations, bytes) of the work
    counted by a plain version."""
    operations = (
        OPS_NEAREST_SPHERE * stats["spheres"] * stats["alive_lane_bounces"]
        + OPS_SHADE_HIT * stats["hit_lane_bounces"]
        + OPS_SHADOW_SPHERE * stats["shadow_sphere_tests"]
        + OPS_SLAB * (stats.get("world_aabb_tests", 0) + stats.get("node_tests", 0))
        + OPS_INSTANCE_WALK * stats.get("instance_walks", 0)
        + OPS_TRIANGLE * stats.get("triangle_tests", 0)
    )
    bytes_moved = rays * (3 + 3 + 3) * 4  # origins, directions in; radiance out
    ops_ms = operations / FP32_PEAK_FLOPS * 1e3
    bytes_ms = bytes_moved / MEMORY_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes"), operations, bytes_moved


def phase_times(kernel: str, run: dict, device) -> None:
    """Phase 5's host-clock numbers for one path: per-frame phases over the
    job, and one frame split further (each step fenced by a synchronize;
    "scene+camera" includes the frame's mesh instances)."""
    import torch

    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.image_io import write_image
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed, tonemap

    timings, scene_name = run["timings"], run["scene"]
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    print(
        f"[5] {scene_name} main path per frame (median ms): loading "
        f"{med([t.finished_loading_at - t.started_process_at for t in timings]):.3f}, render "
        f"{med([t.finished_rendering_at - t.started_rendering_at for t in timings]):.3f}, save "
        f"{med([t.file_saving_finished_at - t.file_saving_started_at for t in timings]):.3f}, total "
        f"{med([t.exited_process_at - t.started_process_at for t in timings]):.3f}; "
        f"{len(timings) / run['path_s']:.3f} frames/s over the job"
    )
    breakdown: dict[str, list[float]] = {
        "scene+camera": [], "rays": [], "kernel": [], "mean+tonemap+copy": [], "png": []
    }
    with tempfile.TemporaryDirectory(prefix="chip-smoke-png-") as scratch:
        for frame in run["frames"][:5]:
            marks = [time.perf_counter()]
            trace = Trace(kernel, scene_name, frame, device)  # scene and mesh
            camera = scene_camera(scene_name, frame, device)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            rays = frame_rays_and_seed(camera, frame, width=WIDTH, height=HEIGHT, samples=SAMPLES)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            radiance = trace.run(*rays, BOUNCES)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            pixels = tonemap(
                radiance.reshape(SAMPLES, HEIGHT * WIDTH, 3).mean(dim=0).reshape(HEIGHT, WIDTH, 3)
            ).cpu().numpy()
            marks.append(time.perf_counter())
            write_image(Path(scratch) / f"f{frame}.png", pixels, "PNG")
            marks.append(time.perf_counter())
            for key, a, b in zip(breakdown, marks, marks[1:]):
                breakdown[key].append((b - a) * 1e3)
    print(
        f"[5] {scene_name} one frame, median ms: "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in breakdown.items())
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1

    from tpu_render_cluster_torch.render import _build

    device = torch.device("cuda", 0)

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
    check(sorted(libraries) == sorted(PATHS), f"kernels {sorted(libraries)} != {sorted(PATHS)}")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {name}: {line.strip()}")

    # -- 3. each kernel against its plain version on the card ---------------
    checks = {
        "trace_fused": ("04_very-simple", "03_physics-2"),
        "trace_fused_mesh": ("02_physics-mesh", "03_physics-2-mesh"),
    }
    agree: dict[str, float] = {}
    max_abs_err: dict[str, float] = {}
    for kernel, scene_names in checks.items():
        started = time.perf_counter()
        results = [kernel_vs_plain(kernel, name, device) for name in scene_names]
        print(f"[3] {kernel} checked in {time.perf_counter() - started:.1f} s")
        agree[kernel] = min(r[0] for r in results)
        max_abs_err[kernel] = max(r[1] for r in results)

    # -- 4. the main paths, 5. their timings ----------------------------------
    record = {"kernels": []}
    for kernel in PATHS:
        started = time.perf_counter()
        run = drive_main_path(kernel, device)
        trace, rays, stats, plain_ms = frame_vs_plain(kernel, run, device)
        phase_times(kernel, run, device)
        kernel_call = lambda: trace.run(*rays, BOUNCES)  # noqa: E731
        # The median of 10 batches of 20 calls: the card's clocks vary with
        # the idle time before a batch.
        cuda_ms(kernel_call, 3)
        batches = [cuda_ms(kernel_call, 20) for _ in range(10)]
        kernel_ms = statistics.median(batches)
        wrapper_host_ms = host_ms(kernel_call, 20)
        call_profile = profiled(
            lambda: [kernel_call() for _ in range(20)], f"{kernel}_kernel", f"{kernel} calls"
        )
        kernel_only_ms = None
        if call_profile is not None:
            kernel_only_ms = call_profile["kernel_ms"] / 20
            print(
                f"[6] {kernel}, 20 wrapper calls under the profiler: the kernel alone "
                f"{kernel_only_ms:.4f} ms per call; all device work "
                f"{call_profile['device_ms'] / 20:.4f} ms per call "
                f"({call_profile['kernels'] / 20:.1f} kernels per call)"
            )
        n_rays = rays[0].shape[0]
        bound_ms, bound_by, operations, bytes_moved = bound(stats, n_rays)
        print(
            f"[5] {kernel} at {n_rays} rays, {run['scene']}: {kernel_ms:.4f} ms "
            f"(median of 10 batches of 20 calls: {', '.join(f'{b:.4f}' for b in batches)}; "
            f"host {wrapper_host_ms:.4f} ms per call); plain version {plain_ms:.3f} ms; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({operations / 1e9:.3f} GFLOP, "
            f"{bytes_moved / 1e6:.2f} MB); work: {stats}"
        )
        record["kernels"].append({
            "name": kernel,
            "route": "cuda",
            "source": f"tpu_render_cluster_torch/render/csrc/{kernel}.cu",
            "replaces": REPLACES[kernel],
            "launches": run["launches"],
            "max_abs_err": max_abs_err[kernel],
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "host_ms": wrapper_host_ms,
            "kernel_only_ms": kernel_only_ms,
            "agree_fraction_min": agree[kernel],
            "tolerance": TOLERANCE[kernel],
            "build_s": build_s,
        })
        print(f"[5] {kernel} path phases 4-5 in {time.perf_counter() - started:.1f} s")

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
