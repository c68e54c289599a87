"""The render path's kernels and their plain PyTorch versions.

Counterpart of ``tpu_render_cluster/render/pallas_kernels.py``. Slice 1
holds one kernel: the sphere path-trace megakernel that replaces the TPU's
``_trace_fused`` in its positional-counter mode, written in CUDA C++ for
Hopper (``csrc/trace_fused.cu``, built by ``_build.py``).

``trace_paths_fused`` launches the kernel for CUDA tensors, and raises if
it cannot. For CPU tensors it runs ``trace_paths_fused_reference``, the
plain version that repeats the reference's masked bounce loop operation for
operation; there is no fallback from one to the other. ``counts`` records
kernel launches and plain-version calls, so a run can show which one the
main path went through.

RNG: a counter-based PCG hash of (lane, bounce, seed), the same portable
integer hash the TPU kernel uses, so the kernel and the plain version draw
the reference's random numbers bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from tpu_render_cluster_torch.render.fp32 import INV_PI, dot3, fma
from tpu_render_cluster_torch.render.rng import MASK32
from tpu_render_cluster_torch.render.scene import Scene

EPS = 1e-3
INF = 1e30
MAX_SPHERES = 128  # the kernel's shared-memory sphere table
_SPHERE_ALIGN = 8  # the reference pads the sphere count to a multiple of 8

# Kernel launches ("trace_fused") and plain-version calls
# ("trace_fused_reference") since the last reset_counts().
counts = {"trace_fused": 0, "trace_fused_reference": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation on uint32 words held in int64 (wraps mod 2^32)."""
    state = (x * 747796405 + 2891336453) & MASK32
    shift = (state >> 28) + 4
    word = (((state >> shift) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def uniform_from_hash(h: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 in [0, 1) from its top 24 bits."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


class SphereTable(NamedTuple):
    """The scene as both versions consume it, spheres padded to 8."""

    centers: torch.Tensor  # [N, 3]
    r2: torch.Tensor  # [N] radius^2, 0 for pad slots (never hit)
    csq: torch.Tensor  # [N] |c|^2
    radius: torch.Tensor  # [N]
    albedo: torch.Tensor  # [N, 3]
    emission: torch.Tensor  # [N, 3]
    dc_sun: torch.Tensor  # [N] c . sun
    sun_direction: torch.Tensor  # [3]
    sun_color: torch.Tensor
    sky_horizon: torch.Tensor
    sky_zenith: torch.Tensor
    plane_albedo_a: torch.Tensor
    plane_albedo_b: torch.Tensor


def sphere_table(scene: Scene) -> SphereTable:
    """Pad the spheres to a multiple of 8 and precompute |c|^2 and c . sun,
    as the reference's wrapper does (``_trace_fused``)."""
    n = scene.centers.shape[0]
    if n > MAX_SPHERES:
        raise ValueError(
            f"Scene has {n} spheres; the trace_fused kernel takes at most {MAX_SPHERES}."
        )
    pad = -(-n // _SPHERE_ALIGN) * _SPHERE_ALIGN - n
    centers = torch.nn.functional.pad(scene.centers, (0, 0, 0, pad))
    radius = torch.nn.functional.pad(scene.radii, (0, pad))
    sun = scene.sun_direction
    return SphereTable(
        centers=centers,
        r2=radius * radius,
        csq=dot3(centers, centers),
        radius=radius,
        albedo=torch.nn.functional.pad(scene.albedo, (0, 0, 0, pad)),
        emission=torch.nn.functional.pad(scene.emission, (0, 0, 0, pad)),
        dc_sun=dot3(centers, sun.expand_as(centers)),
        sun_direction=sun,
        sun_color=scene.sun_color,
        sky_horizon=scene.sky_horizon,
        sky_zenith=scene.sky_zenith,
        plane_albedo_a=scene.plane_albedo_a,
        plane_albedo_b=scene.plane_albedo_b,
    )


def _check_inputs(scene: Scene, origins: torch.Tensor, directions: torch.Tensor, seed) -> None:
    if not -(2**31) <= int(seed) < 2**31:
        raise ValueError(f"seed {seed} is not an int32")
    if origins.ndim != 2 or origins.shape[1] != 3 or origins.shape != directions.shape:
        raise ValueError(
            f"origins and directions must both be [R, 3]; got "
            f"{tuple(origins.shape)} and {tuple(directions.shape)}"
        )
    for name, tensor in (("origins", origins), ("directions", directions)):
        if tensor.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensor.dtype}")
    devices = {origins.device, directions.device, scene.centers.device}
    if len(devices) != 1:
        raise ValueError(f"rays and scene must share one device, got {devices}")


def trace_paths_fused(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
) -> torch.Tensor:
    """Path-trace each ray through the whole bounce loop; radiance ``[R, 3]``.

    ``seed`` is the frame's int32 trace seed (``integrator.trace_seed``);
    ray ``i``'s random numbers come from lane ``i``. CUDA tensors go to the
    kernel, CPU tensors to the plain version.
    """
    _check_inputs(scene, origins, directions, seed)
    if origins.device.type == "cuda":
        return _launch_trace_fused(scene, origins, directions, seed, max_bounces)
    if origins.device.type == "cpu":
        return trace_paths_fused_reference(
            scene, origins, directions, seed, max_bounces=max_bounces
        )
    raise ValueError(f"Unsupported device {origins.device}")


def _launch_trace_fused(scene, origins, directions, seed, max_bounces):
    from tpu_render_cluster_torch.render import _build

    library = _build.load("trace_fused")
    launch = library.trace_fused_launch
    launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    launch.restype = ctypes.c_int
    library.trace_fused_error_string.argtypes = [ctypes.c_int]
    library.trace_fused_error_string.restype = ctypes.c_char_p

    table = sphere_table(scene)
    n_padded = table.centers.shape[0]
    zero = torch.zeros_like(table.csq)
    spheres = torch.stack(
        [
            table.centers[:, 0], table.centers[:, 1], table.centers[:, 2], table.r2,
            table.csq, table.dc_sun, table.radius, zero,
            table.albedo[:, 0], table.albedo[:, 1], table.albedo[:, 2], zero,
            table.emission[:, 0], table.emission[:, 1], table.emission[:, 2], zero,
        ],
        dim=1,
    ).contiguous()
    params = torch.cat(
        [
            table.sun_direction, table.sun_color, table.sky_horizon,
            table.sky_zenith, table.plane_albedo_a, table.plane_albedo_b,
        ]
    ).to(torch.float32).contiguous()
    origins = origins.contiguous()
    directions = directions.contiguous()
    rays = origins.shape[0]
    if rays >= 2**31:
        raise ValueError(f"{rays} rays exceed the kernel's int32 lane index")
    radiance = torch.empty((rays, 3), dtype=torch.float32, device=origins.device)
    stream = torch.cuda.current_stream(origins.device).cuda_stream
    status = launch(
        origins.data_ptr(), directions.data_ptr(), rays,
        spheres.data_ptr(), n_padded, params.data_ptr(),
        int(seed), int(max_bounces), radiance.data_ptr(), stream,
    )
    if status != 0:
        message = library.trace_fused_error_string(status).decode()
        raise RuntimeError(f"trace_fused launch failed: CUDA error {status} ({message})")
    counts["trace_fused"] += 1
    return radiance


def trace_paths_fused_reference(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    chunk_rays: int = 32768,
    stats: dict | None = None,
) -> torch.Tensor:
    """The plain PyTorch version of the megakernel, on any device.

    It repeats the reference's masked loop (every lane runs every bounce
    under an ``alive`` mask) over chunks of rays: a whole frame's
    ``[rays, spheres]`` intermediates would take about 0.5 GB each. Lanes
    keep their global index, so chunking changes no result.

    ``stats``, when given, receives the work this input needs, counted the
    way the kernel does it: lane-bounces alive, lanes that hit, and sphere
    tests of the shadow rays (which stop at the first occluder).
    """
    _check_inputs(scene, origins, directions, seed)
    counts["trace_fused_reference"] += 1
    table = sphere_table(scene)
    seed_word = int(seed) & MASK32
    out = torch.empty_like(origins)
    if stats is not None:
        for key in ("alive_lane_bounces", "hit_lane_bounces", "shadow_sphere_tests"):
            stats.setdefault(key, 0)
        stats["spheres"] = table.centers.shape[0]
    for start in range(0, origins.shape[0], chunk_rays):
        stop = min(start + chunk_rays, origins.shape[0])
        out[start:stop] = _reference_chunk(
            table, origins[start:stop], directions[start:stop], start,
            seed_word, max_bounces, stats,
        )
    return out


def _reference_chunk(table, o, d, lane_start, seed_word, max_bounces, stats):
    device = o.device
    rays = o.shape[0]
    n = table.centers.shape[0]
    c = table.centers
    r2, csq, radius, dc_sun = table.r2, table.csq, table.radius, table.dc_sun
    sun = table.sun_direction
    sphere_index = torch.arange(n, device=device)
    lane = torch.arange(lane_start, lane_start + rays, dtype=torch.int64, device=device)
    plane_normal = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)

    throughput = torch.ones((rays, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((rays, 3), dtype=torch.float32, device=device)
    alive = torch.ones((rays, 1), dtype=torch.float32, device=device)

    def sphere_dots(points):  # [R, N]: c . points, as dot3 sums it
        return fma(
            c[:, 2], points[:, 2:3],
            fma(c[:, 1], points[:, 1:2], c[:, 0] * points[:, 0:1]),
        )

    for bounce in range(max_bounces):
        # -- nearest sphere hit -------------------------------------------
        dc = sphere_dots(d)
        oc = sphere_dots(o)
        od = dot3(o, d)[:, None]
        o_sq = dot3(o, o)[:, None]
        oc_dot_d = dc - od
        oc_sq = o_sq - 2.0 * oc + csq
        disc = fma(oc_dot_d, oc_dot_d, -(oc_sq - r2))
        valid = (disc > 0.0) & (r2 > 0.0)
        sqrt_disc = torch.sqrt(torch.clamp_min(disc, 0.0))
        t0 = oc_dot_d - sqrt_disc
        t1 = oc_dot_d + sqrt_disc
        t_all = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, INF))
        t_all = torch.where(valid, t_all, INF)
        t_sphere = t_all.min(dim=1, keepdim=True).values
        idx = torch.where(t_all == t_sphere, sphere_index, n).min(dim=1).values
        idx = torch.clamp_max(idx, n - 1)

        # -- ground plane y = 0 -------------------------------------------
        d_y = d[:, 1:2]
        o_y = o[:, 1:2]
        denom = torch.where(torch.abs(d_y) < 1e-8, 1e-8, d_y)
        t_plane = -o_y / denom
        t_plane = torch.where((t_plane > EPS) & (torch.abs(d_y) >= 1e-8), t_plane, INF)
        is_plane = (t_plane < t_sphere).to(torch.float32)
        t = torch.minimum(t_sphere, t_plane)
        hit = (t < INF).to(torch.float32)

        # -- sky on escape ------------------------------------------------
        blend = torch.clamp(d_y, 0.0, 1.0)
        sun_cos_dir = dot3(d, sun)[:, None]
        sun_disc = torch.where(sun_cos_dir > 0.9995, 8.0, 0.0)
        sky = fma(1.0 - blend, table.sky_horizon, blend * table.sky_zenith)
        sky = sky + sun_disc * table.sun_color
        radiance = radiance + throughput * sky * (alive * (1.0 - hit))

        if stats is not None:
            stats["alive_lane_bounces"] += int(alive.sum())
            stats["hit_lane_bounces"] += int((alive * hit).sum())
        alive = alive * hit
        p = fma(d, t, o)

        c_hit = c[idx]
        r_hit = radius[idx][:, None]
        sphere_normal = (p - c_hit) / torch.clamp_min(r_hit, 1e-6)
        normal = is_plane * plane_normal + (1.0 - is_plane) * sphere_normal

        checker = torch.remainder(
            torch.floor(p[:, 0:1]).to(torch.int32) + torch.floor(p[:, 2:3]).to(torch.int32),
            2,
        )
        checker_rgb = torch.where(checker == 0, table.plane_albedo_a, table.plane_albedo_b)
        albedo = is_plane * checker_rgb + (1.0 - is_plane) * table.albedo[idx]
        emission = (1.0 - is_plane) * table.emission[idx]
        radiance = radiance + throughput * emission * alive

        # -- sun NEE: one any-hit shadow test ------------------------------
        shadow_o = fma(normal, EPS * 4.0, p)
        oc_s = sphere_dots(shadow_o)
        od_s = dot3(shadow_o, sun)[:, None]
        osq_s = dot3(shadow_o, shadow_o)[:, None]
        ocd_s = dc_sun - od_s
        ocsq_s = osq_s - 2.0 * oc_s + csq
        disc_s = fma(ocd_s, ocd_s, -(ocsq_s - r2))
        valid_s = (disc_s > 0.0) & (r2 > 0.0)
        t1_s = ocd_s + torch.sqrt(torch.clamp_min(disc_s, 0.0))
        occluders = valid_s & (t1_s > EPS)
        shadowed = occluders.any(dim=1, keepdim=True).to(torch.float32)
        cos_sun = torch.clamp_min(dot3(normal, sun)[:, None], 0.0)
        if stats is not None:
            tested = (alive > 0.5) & (cos_sun > 0.0)
            first = torch.where(
                occluders.any(dim=1, keepdim=True),
                occluders.to(torch.int8).argmax(dim=1, keepdim=True) + 1,
                n,
            )
            stats["shadow_sphere_tests"] += int(first[tested].sum())
        direct = albedo * table.sun_color * (cos_sun * (1.0 - shadowed) * alive) * INV_PI
        radiance = fma(throughput, direct, radiance)

        # -- continue the path: cosine-weighted resample ------------------
        throughput = throughput * (alive * albedo + (1.0 - alive))
        counter = (lane * (2 * max_bounces + 2) + 2 * bounce) & MASK32
        u1 = uniform_from_hash(pcg_hash(counter ^ seed_word))[:, None]
        u2 = uniform_from_hash(pcg_hash(((counter + 1) & MASK32) ^ seed_word))[:, None]
        r = torch.sqrt(u1)
        phi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=device) * u2
        # cos and sin correctly rounded to float32 (through float64), as the
        # kernel computes them: the libraries' float32 versions differ in
        # the last bit for a few percent of angles.
        x = r * torch.cos(phi.double()).float()
        y = r * torch.sin(phi.double()).float()
        z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
        nx, ny, nz = normal[:, 0:1], normal[:, 1:2], normal[:, 2:3]
        helper_x = torch.where(torch.abs(nx) > 0.9, 0.0, 1.0)
        helper_y = 1.0 - helper_x
        tangent = torch.cat([helper_y * nz, -helper_x * nz, helper_x * ny - helper_y * nx], dim=1)
        tangent = tangent / torch.clamp_min(torch.sqrt(dot3(tangent, tangent))[:, None], 1e-8)
        tx, ty, tz = tangent[:, 0:1], tangent[:, 1:2], tangent[:, 2:3]
        bitangent = torch.cat(
            [fma(ny, tz, -(nz * ty)), fma(nz, tx, -(nx * tz)), fma(nx, ty, -(ny * tx))], dim=1
        )
        new_d = fma(z, normal, fma(x, tangent, y * bitangent))
        new_o = shadow_o
        # where-select (not multiply-mask): dead lanes keep their old
        # finite state, so no inf * 0 can poison later bounces.
        live = alive > 0.5
        o = torch.where(live, new_o, o)
        d = torch.where(live, new_d, d)
    return radiance
