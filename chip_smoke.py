"""Drive the PyTorch port on one CUDA GPU and check every kernel of its path.

Usage (from the repository root, on a machine with an NVIDIA H100 and the
CUDA toolkit):

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) if its check fails:
1. the card: name and power limit as nvidia-smi reports them;
2. build every CUDA source of the port with nvcc (sm_90a), timed;
3. each kernel against its plain PyTorch version on the card, at the
   shapes and tolerances of tests/test_torch_kernels.py;
4. the main path: a 10-frame job of 04_very-simple loaded through the
   port's job model and rendered by TorchRaytraceBackend at 512x512,
   8 spp, 4 bounces; the launch counts are zeroed just before and read
   just after, and every PNG must decode with non-trivial content; frame 1
   must match the plain version's render of the same frame;
5. timings: the per-phase times of the main path, a breakdown of one
   frame, the kernel's time beside its bound and the plain version's time.

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
JOB_FILE = REPO / "blender-projects/04_very-simple/04_very-simple_demo_10f-1w.toml"
WIDTH, HEIGHT, SAMPLES, BOUNCES = 512, 512, 8, 4
# Published H100 SXM peaks (dense): float32 outside the tensor cores, and
# device memory bandwidth.
FP32_PEAK_FLOPS = 67e12
MEMORY_BYTES_PER_S = 3.35e12
# Operations per unit of work of the path-trace megakernel, counted from
# csrc/trace_fused.cu (an FMA counts 2): a nearest-hit sphere test (two
# 3-dots, the quadratic, sqrt, two roots, selects: 26), a shadow-ray
# sphere test (one 3-dot, the quadratic, sqrt, compares: 17), and the
# shading of one hit (ray dots, plane test, hit point, normal, emission,
# NEE set-up and direct term, PCG hashes, cos/sin, tangent frame and new
# direction: about 200).
OPS_NEAREST_SPHERE = 26
OPS_SHADOW_SPHERE = 17
OPS_SHADE_HIT = 200


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"chip_smoke check failed: {message}")


def agreement(got, expected) -> tuple[float, float]:
    """(fraction of rays whose 3 channels agree at rtol=atol=1e-4,
    max abs error over all values)."""
    import torch

    close = torch.isclose(got, expected, rtol=1e-4, atol=1e-4).all(dim=1)
    return close.float().mean().item(), (got - expected).abs().max().item()


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1

    import numpy as np
    from PIL import Image

    from tpu_render_cluster_torch.jobs.models import BlenderJob
    from tpu_render_cluster_torch.render import _build, kernels
    from tpu_render_cluster_torch.render.camera import scene_camera
    from tpu_render_cluster_torch.render.image_io import write_image
    from tpu_render_cluster_torch.render.integrator import frame_rays_and_seed, tonemap
    from tpu_render_cluster_torch.render.scene import build_scene
    from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

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
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {name}: {line.strip()}")

    # -- 3. kernel vs plain version on the card ------------------------------
    agree_min, max_abs_err = 1.0, 0.0
    for name in ("04_very-simple", "03_physics-2"):
        scene = build_scene(name, 7, device)
        camera = scene_camera(name, 7, device)
        origins, directions, seed = frame_rays_and_seed(
            camera, 7, width=128, height=128, samples=4
        )
        for max_bounces in (1, 4):
            got = kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=max_bounces)
            expected = kernels.trace_paths_fused_reference(
                scene, origins, directions, seed, max_bounces=max_bounces
            )
            torch.cuda.synchronize()
            fraction, err = agreement(got, expected)
            bit_equal = (got == expected).all(dim=1).float().mean().item()
            print(
                f"[3] trace_fused vs plain, {name}, 128x128x4 spp, {max_bounces} bounce(s): "
                f"{fraction:.6f} of rays within 1e-4, {bit_equal:.6f} bit-equal, "
                f"max abs err {err:.3g}"
            )
            check(torch.isfinite(got).all().item(), f"non-finite radiance ({name})")
            need = 1.0 if max_bounces == 1 else 0.999
            check(fraction >= need, f"{name} {max_bounces} bounces: {fraction} < {need}")
            agree_min = min(agree_min, fraction)
            max_abs_err = max(max_abs_err, err)

    # -- 4. the main path: a job through the port's backend --------------------
    job = BlenderJob.load_from_file(JOB_FILE)
    frames = list(job.frame_indices())
    check(len(frames) == 10, f"expected a 10-frame job, got {len(frames)}")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as base:
        backend = TorchRaytraceBackend(
            width=WIDTH, height=HEIGHT, samples=SAMPLES, max_bounces=BOUNCES,
            base_directory=base,
        )
        check(backend.device.type == "cuda", f"backend chose {backend.device}")
        backend.warm(job.job_name)
        torch.cuda.synchronize()
        kernels.reset_counts()
        path_started = time.perf_counter()
        timings = [asyncio.run(backend.render_frame(job, f)) for f in frames]
        path_s = time.perf_counter() - path_started
        launches = dict(kernels.counts)
        print(f"[4] main path: {len(frames)} frames of {job.job_name} in {path_s:.3f} s; counts {launches}")
        check(launches["trace_fused"] == len(frames), f"kernel launches {launches}")
        check(launches["trace_fused_reference"] == 0, f"plain-version calls {launches}")

        outputs = sorted((Path(base) / "blender-projects").rglob("*.png"))
        check(len(outputs) == len(frames), f"{len(outputs)} PNGs for {len(frames)} frames")
        images = {}
        for path in outputs:
            pixels = torch.from_numpy(np.array(Image.open(path)))
            check(tuple(pixels.shape) == (HEIGHT, WIDTH, 3), f"{path.name}: {tuple(pixels.shape)}")
            check(pixels.float().std().item() > 5.0, f"{path.name} is flat")
            images[path.name] = pixels
        first = images[outputs[0].name]

    # Frame 1 of the main path against the plain version's render of it.
    scene = build_scene("04_very-simple", frames[0], device)
    camera = scene_camera("04_very-simple", frames[0], device)
    origins, directions, seed = frame_rays_and_seed(
        camera, frames[0], width=WIDTH, height=HEIGHT, samples=SAMPLES
    )
    stats: dict = {}
    plain = kernels.trace_paths_fused_reference(
        scene, origins, directions, seed, max_bounces=BOUNCES, stats=stats
    )
    plain_image = tonemap(plain.reshape(SAMPLES, HEIGHT * WIDTH, 3).mean(dim=0).reshape(HEIGHT, WIDTH, 3)).cpu()
    diff = (first.int() - plain_image.int()).abs()
    within = (diff <= 1).float().mean().item()
    print(f"[4] frame {frames[0]} vs plain-version render: {within:.6f} of uint8 values within 1")
    check(within >= 0.995, f"main-path frame disagrees with the plain version ({within})")
    kernel_radiance = kernels.trace_paths_fused(scene, origins, directions, seed, max_bounces=BOUNCES)
    frame_fraction, frame_err = agreement(kernel_radiance, plain)
    print(f"[4] frame {frames[0]} rays, kernel vs plain: {frame_fraction:.6f} within 1e-4, max abs err {frame_err:.3g}")
    check(frame_fraction >= 0.999, f"main-path rays disagree ({frame_fraction})")

    # -- 5. timings ---------------------------------------------------------------
    loading = [t.finished_loading_at - t.started_process_at for t in timings]
    rendering = [t.finished_rendering_at - t.started_rendering_at for t in timings]
    saving = [t.file_saving_finished_at - t.file_saving_started_at for t in timings]
    total = [t.exited_process_at - t.started_process_at for t in timings]
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    print(
        f"[5] main path per frame (median ms): loading {med(loading):.3f}, render "
        f"{med(rendering):.3f}, save {med(saving):.3f}, total {med(total):.3f}; "
        f"{len(frames) / path_s:.3f} frames/s over the job"
    )

    kernel_call = lambda: kernels.trace_paths_fused(  # noqa: E731
        scene, origins, directions, seed, max_bounces=BOUNCES
    )
    plain_call = lambda: kernels.trace_paths_fused_reference(  # noqa: E731
        scene, origins, directions, seed, max_bounces=BOUNCES
    )
    cuda_ms(kernel_call, 3)
    kernel_ms = cuda_ms(kernel_call, 20)
    plain_ms = cuda_ms(plain_call, 2)
    kernel_ms_again = cuda_ms(kernel_call, 20)

    rays = origins.shape[0]
    spheres = stats["spheres"]
    operations = (
        OPS_NEAREST_SPHERE * spheres * stats["alive_lane_bounces"]
        + OPS_SHADE_HIT * stats["hit_lane_bounces"]
        + OPS_SHADOW_SPHERE * stats["shadow_sphere_tests"]
    )
    bytes_moved = rays * (3 + 3 + 3) * 4  # origins, directions in; radiance out
    ops_ms = operations / FP32_PEAK_FLOPS * 1e3
    bytes_ms = bytes_moved / MEMORY_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(
        f"[5] trace_fused at {rays} rays, {spheres} spheres: {kernel_ms:.4f} ms "
        f"(again {kernel_ms_again:.4f}); plain version {plain_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms ({operations / 1e9:.3f} GFLOP -> {ops_ms:.4f} ms, "
        f"{bytes_moved / 1e6:.2f} MB -> {bytes_ms:.4f} ms); work: {stats}"
    )

    # One frame's phases, each fenced by a synchronize.
    breakdown: dict[str, list[float]] = {
        "scene+camera": [], "rays": [], "kernel": [], "mean+tonemap+copy": [], "png": []
    }
    with tempfile.TemporaryDirectory(prefix="chip-smoke-png-") as scratch:
        for frame in frames[:5]:
            marks = [time.perf_counter()]
            scene_f = build_scene("04_very-simple", frame, device)
            camera_f = scene_camera("04_very-simple", frame, device)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            o, d, s = frame_rays_and_seed(camera_f, frame, width=WIDTH, height=HEIGHT, samples=SAMPLES)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            radiance = kernels.trace_paths_fused(scene_f, o, d, s, max_bounces=BOUNCES)
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
        "[5] one frame, median ms: "
        + ", ".join(f"{k} {statistics.median(v):.3f}" for k, v in breakdown.items())
    )

    record = {
        "kernels": [
            {
                "name": "trace_fused",
                "route": "cuda",
                "source": "tpu_render_cluster_torch/render/csrc/trace_fused.cu",
                "replaces": "tpu_render_cluster/render/pallas_kernels.py:901",
                "launches": launches["trace_fused"],
                "max_abs_err": max_abs_err,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": None,
                "agree_fraction_min": agree_min,
                "tolerance": "rtol=atol=1e-4 per ray; all rays at 1 bounce, >=99.9% at 4",
                "build_s": build_s,
            }
        ]
    }
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
