"""Whole-frame path tracing: primary rays, the kernels, tonemapping.

Port of the masked tier of ``tpu_render_cluster/render/integrator.py`` for
whole frames of the sphere and mesh scenes. A frame's samples ride the ray
axis (the reference's flattened-samples branch of ``render_tile``): every
sample's jittered camera rays are traced together, then averaged per pixel
and tonemapped. ``trace_paths`` dispatches as the reference does: sphere
scenes and shallow meshes take ONE launch of a path-trace megakernel; a
deep mesh (past the mesh megakernel's walk bound) takes the per-bounce
mesh kernel once per bounce, the rays re-sorted by a coherence key between
bounces (``_ray_sort_order``), dead lanes at the tail.

Regions (one tile of a frame, the cluster's tiled work unit):
``region_rays_and_seed`` gives a region's rows of the whole frame's rays
with their whole-frame lanes, and ``render_frame_region`` traces them with
those lanes as RNG counters (``trace_paths(rng_lanes=)``: the sphere
megakernel's lane mode, or for any mesh the masked deep loop), so a
stitched grid of regions equals the whole frame bit for bit.
``render_frame(tile_size=)`` is the reference's other, local tiling, where
each tile draws its own RNG root.

RNG: the jitter and the kernel's trace seed derive from the reference's
``jax.random`` key schedule, reproduced bit for bit by ``render/rng.py``.
The keys are a handful of words and are derived on the host; only the
bulk jitter bits are drawn on the render device.

``bounce_scan=True`` takes instead the reference's per-bounce scan renderer,
its tier wherever Pallas is off (``TRC_PALLAS=0``, every backend but a
TPU): samples one after another, each traced by ``trace_paths_scan``, one
``_shade_bounce`` per bounce in eager tensor code around four launches of
the unit kernels (the sphere nearest hit and any-hit, the instanced nearest
hit and any-hit), and threefry random numbers for the cosine resample, so
it reproduces the reference's own CPU render. With ``per_instance=True`` as
well, the two mesh queries take the reference's own CPU structure, a scan
over the instances, each instance one launch of the single-BVH unit kernels
(``intersect_mesh``, ``occluded_mesh``) in place of one instanced launch.

The BVH tiers (the reference's ``TRC_TLAS``, ``TRC_BVH_QUANT``,
``TRC_BVH_BUILDER`` and ``TRC_BVH_WIDE``) resolve at one site,
``resolve_bvh_config``: an argument left None takes its environment tier.
The renderer factories, the wavefront, the pool and the backend resolve
them once per renderer or window, into their cache keys; below them every
function takes concrete values and reads no environment. The BLAS build
(``builder``, ``wide``) goes to ``scene_mesh_set``; the node format
(``quant``) to the mesh kernels, whose images it leaves bit for bit as they
are (the masked tier carries float32 throughput at every tier). The TLAS
tiers (the reference's ``TRC_TLAS_LEAF`` and ``TRC_TLAS_BLOCK``) are
environment tiers alone, as the reference's: they resolve beside them, at
the same sites and into the same keys, through ``resolve_tlas_config``; the
leaf (``tlas_leaf``) goes to ``scene_mesh_set`` (the frame's TLAS and
whether the field takes it), the packet (``tlas_block``) to the TLAS kernels.
"""

from __future__ import annotations

import functools
import math

import torch

from tpu_render_cluster_torch import resolve_device
from tpu_render_cluster_torch.render import geometry, kernels, rng
from tpu_render_cluster_torch.render.camera import Camera, camera_rays, scene_camera
from tpu_render_cluster_torch.render.fp32 import dot3
from tpu_render_cluster_torch.render.mesh import (
    MeshSet,
    bvh_builder,
    bvh_wide,
    intersect_instances,
    occluded_instances,
    scene_mesh_set,
)
from tpu_render_cluster_torch.render.scene import Scene, build_scene


def _int32(value) -> int:
    """``jnp.asarray(value).astype(int32)`` of a frame index or offset."""
    return int(torch.as_tensor(value, dtype=torch.float32).to(torch.int32))


def tile_base_key(frame, y0, x0) -> torch.Tensor:
    """The (frame, y0, x0)-derived RNG root every tile render uses."""
    key = rng.fold_in(rng.PRNGKey(917), _int32(frame))
    key = rng.fold_in(key, int(y0))
    return rng.fold_in(key, int(x0))


def tile_trace_key(base_key: torch.Tensor) -> torch.Tensor:
    """The path-trace key for a tile (sample index -1 = the trace stream,
    disjoint from every per-sample jitter stream)."""
    return rng.fold_in(base_key, -1)


def trace_seed(key: torch.Tensor) -> int:
    """The int32 seed of the megakernel's counter PCG: the key's last word."""
    return int(rng.as_int32(rng.key_data(key).reshape(-1)[-1]))


def sample_jitter_rays(
    camera: Camera, key, *, width, height, y0, x0, tile_height, tile_width
):
    """One sample's jittered primary rays for a tile (``key`` may carry a
    leading batch of sample keys; the rays then carry it too)."""
    jitter_key = rng.split(key)[..., 0, :]
    jitter = rng.uniform(
        jitter_key.to(camera.origin.device), (tile_height * tile_width, 2)
    )
    return camera_rays(
        camera, width, height, y0=y0, x0=x0,
        tile_height=tile_height, tile_width=tile_width, jitter=jitter,
    )


def flat_sample_rays(
    camera: Camera, base_key, *, width, height, y0, x0, tile_height,
    tile_width, samples,
):
    """All samples' rays flattened onto the ray axis ([S * n, 3] x 2),
    sample-major: ray ``s * n + pixel``."""
    n = tile_height * tile_width
    sample_keys = rng.fold_in(base_key, torch.arange(samples))
    origins, directions = sample_jitter_rays(
        camera, sample_keys, width=width, height=height, y0=y0, x0=x0,
        tile_height=tile_height, tile_width=tile_width,
    )
    return (
        origins.reshape(samples * n, 3).contiguous(),
        directions.reshape(samples * n, 3),
    )


def frame_rays_and_seed(camera: Camera, frame, *, width, height, samples):
    """A full frame's flattened primary rays + its kernel trace seed."""
    base_key = tile_base_key(frame, 0, 0)
    origins, directions = flat_sample_rays(
        camera, base_key, width=width, height=height, y0=0, x0=0,
        tile_height=height, tile_width=width, samples=samples,
    )
    return origins, directions, trace_seed(tile_trace_key(base_key))


def region_pixel_indices(*, y0, x0, tile_height, tile_width, width, device="cpu"):
    """Row-major whole-frame pixel indices of one region ([th*tw] int32)."""
    ys = torch.arange(tile_height, dtype=torch.int32, device=device)[:, None] + int(y0)
    xs = torch.arange(tile_width, dtype=torch.int32, device=device)[None, :] + int(x0)
    return (ys * width + xs).reshape(-1)


def region_lane_map(
    *, y0, x0, tile_height, tile_width, width, height, samples, device="cpu"
):
    """Local region-ray index -> whole-frame lane ([samples*th*tw] int32):
    sample-major over row-major pixels, ``s*H*W + y*W + x``, the layout of
    ``flat_sample_rays`` over the whole frame. The region renderers and the
    pool's region mode all take their RNG counters from here."""
    pix = region_pixel_indices(
        y0=y0, x0=x0, tile_height=tile_height, tile_width=tile_width, width=width,
        device=device,
    )
    samples_base = torch.arange(samples, dtype=torch.int32, device=device)[:, None]
    return (samples_base * (height * width) + pix[None, :]).reshape(-1)


def region_rays_and_seed(
    camera: Camera, frame, *, width, height, samples, y0, x0, tile_height, tile_width,
):
    """One region's rows of the whole frame's flattened primary rays, their
    whole-frame lanes (``region_lane_map``) and the frame's trace seed.

    The region inherits the whole frame's RNG: per sample the whole frame's
    jitter is drawn and sliced to the region's pixels, and the camera rays
    are built from the same global pixel coordinates, so the rays equal the
    whole frame's rows bit for bit. Traced with these lanes as RNG counters
    they give the whole frame's radiance on the region's pixels (a tile
    render that draws its own RNG root is ``render_tile``)."""
    base_key = tile_base_key(frame, 0, 0)
    device = camera.origin.device
    pix = region_pixel_indices(
        y0=y0, x0=x0, tile_height=tile_height, tile_width=tile_width, width=width,
        device=device,
    )
    sample_keys = rng.fold_in(base_key, torch.arange(samples))
    jitter_keys = rng.split(sample_keys)[..., 0, :].to(device)
    # The whole frame's jitter of each sample, sliced to the region.
    jitter = rng.uniform(jitter_keys, (height * width, 2))[:, pix.to(torch.int64)]
    origins, directions = camera_rays(
        camera, width, height, y0=y0, x0=x0, tile_height=tile_height,
        tile_width=tile_width, jitter=jitter,
    )
    n = tile_height * tile_width
    lanes = region_lane_map(
        y0=y0, x0=x0, tile_height=tile_height, tile_width=tile_width, width=width,
        height=height, samples=samples, device=device,
    )
    return (
        origins.reshape(samples * n, 3).contiguous(),
        directions.reshape(samples * n, 3),
        lanes,
        trace_seed(tile_trace_key(base_key)),
    )


def _cosine_sample_hemisphere(normals: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions [R, 3] about unit normals [R, 3], from
    the threefry uniforms ``uniform(key, (2, R))``."""
    u1, u2 = rng.uniform(key, (2, normals.shape[0]))
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    # cos and sin correctly rounded to float32 (through float64) on every
    # device: the libraries' float32 versions differ in the last bit.
    x = (r * torch.cos(phi.double()).float())[:, None]
    y = (r * torch.sin(phi.double()).float())[:, None]
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))[:, None]
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    # The tangent frame: cross(helper, n) with helper (0, 1, 0) where |n_x|
    # > 0.9, else (1, 0, 0), normalised; the bitangent cross(n, tangent).
    hx = torch.where(torch.abs(nx) > 0.9, 0.0, 1.0)
    hy = 1.0 - hx
    tangent = torch.stack([hy * nz, -(hx * nz), hx * ny - hy * nx], dim=1)
    tx, ty, tz = tangent[:, 0], tangent[:, 1], tangent[:, 2]
    tangent = tangent / torch.sqrt(tx * tx + ty * ty + tz * tz)[:, None]
    tx, ty, tz = tangent[:, 0], tangent[:, 1], tangent[:, 2]
    bitangent = torch.stack([ny * tz - nz * ty, nz * tx - nx * tz, nx * ty - ny * tx], dim=1)
    return x * tangent + y * bitangent + z * normals


@functools.lru_cache(maxsize=8)
def _up(device: torch.device) -> torch.Tensor:
    """(0, 1, 0) on ``device``, copied there once: a copy from host memory
    would make the host wait for the card at every bounce."""
    return torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=device)


def _check_per_instance(per_instance: bool, bounce_scan: bool) -> None:
    if per_instance and not bounce_scan:
        raise ValueError(
            "per_instance=True selects the scan renderer's per-instance mesh queries; "
            "it needs bounce_scan=True (the other tiers have no instance query)"
        )


def _shade_bounce(
    scene: Scene, state, key: torch.Tensor, mesh: MeshSet | None = None,
    per_instance: bool = False,
):
    """One bounce of the scan renderer over every lane ``state`` = (origins,
    directions, throughput [R, 3], alive [R] bool): the new (origins,
    directions, throughput), this bounce's radiance contribution [R, 3]
    (from zero) and alive. Dead lanes keep their state and add nothing.

    The geometry queries are the unit kernels: the sphere nearest hit and
    any-hit, and for a mesh scene the instanced nearest hit, seeded with
    the sphere/plane t, and the instanced any-hit, which skips the lanes
    whose answer cannot matter (``per_instance``: both as a scan over the
    instances). The mesh walks see dead lanes as rays parked at 1e7 heading
    up, which miss every instance.
    """
    origins, directions, throughput, alive = state
    t, sphere_index, is_plane = geometry.intersect_scene(scene, origins, directions)
    up = _up(origins.device)
    mesh_closer = None
    if mesh is not None:
        parked = ~alive[:, None]
        t_mesh, mesh_normals, mesh_albedo = intersect_instances(
            mesh,
            torch.where(parked, 1e7, origins),
            torch.where(parked, up, directions),
            init_t=torch.where(alive, t, geometry.INF), per_instance=per_instance,
        )
        # A mesh miss returns the seed, which the strict < reads as not closer.
        mesh_closer = alive & (t_mesh < t)
        t = torch.minimum(t, t_mesh)
        is_plane = is_plane & ~mesh_closer
    hit = t < geometry.INF

    # Escaped rays pick up the sky and die.
    radiance = throughput * geometry.sky_color(scene, directions) * (alive & ~hit)[:, None]
    alive = alive & hit
    points = origins + directions * t[:, None]
    sphere_index = sphere_index.to(torch.int64)
    sphere_normals = (points - scene.centers[sphere_index]) / torch.clamp_min(
        scene.radii[sphere_index][:, None], 1e-6
    )
    plane = is_plane[:, None]
    normals = torch.where(plane, up, sphere_normals)
    albedo = torch.where(plane, geometry.checker_albedo(scene, points), scene.albedo[sphere_index])
    emission = torch.where(plane, 0.0, scene.emission[sphere_index])
    if mesh_closer is not None:
        closer = mesh_closer[:, None]
        normals = torch.where(closer, mesh_normals, normals)
        albedo = torch.where(closer, mesh_albedo, albedo)
        emission = torch.where(closer, 0.0, emission)
    radiance = radiance + throughput * emission * alive[:, None]

    # Sun next-event estimation: one shadow ray toward the delta light.
    cos_sun = torch.clamp_min(dot3(normals, scene.sun_direction), 0.0)
    shadow_origin = points + normals * geometry.EPS * 4.0
    sun_dir = scene.sun_direction.expand_as(normals)
    in_shadow = kernels.occluded_spheres(scene, shadow_origin, sun_dir)
    if mesh is not None:
        # Lanes already shadowed, dead or facing away from the sun do not
        # walk; their spurious True is multiplied by cos_sun * alive = 0.
        in_shadow = occluded_instances(
            mesh, shadow_origin, sun_dir, already=in_shadow | ~alive | (cos_sun <= 0.0),
            per_instance=per_instance,
        )
    direct = albedo * scene.sun_color * (cos_sun * ~in_shadow * alive)[:, None] / math.pi
    radiance = radiance + throughput * direct

    # Continue the path: cosine sample (BRDF/pi * cos / pdf == albedo).
    throughput = throughput * torch.where(alive[:, None], albedo, 1.0)
    new_directions = _cosine_sample_hemisphere(normals, key)
    live = alive[:, None]
    origins = torch.where(live, shadow_origin, origins)
    directions = torch.where(live, new_directions, directions)
    return origins, directions, throughput, radiance, alive


def trace_paths_scan(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    key: torch.Tensor,
    *,
    max_bounces: int,
    mesh: MeshSet | None = None,
    per_instance: bool = False,
) -> torch.Tensor:
    """Trace one sample per ray through the reference's bounce scan;
    radiance [R, 3]. ``key`` is the sample's threefry trace key: bounce
    ``b`` draws its resample from ``split(key, max_bounces)[b]``. Every
    lane runs every bounce under its ``alive`` mask, in place: no sorting,
    the contribution summed per lane. ``per_instance``: the mesh queries
    as a scan over the instances (``_shade_bounce``)."""
    n = origins.shape[0]
    device = origins.device
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    keys = rng.split(key.to(device), max_bounces)
    for bounce in range(max_bounces):
        origins, directions, throughput, contribution, alive = _shade_bounce(
            scene, (origins, directions, throughput, alive), keys[bounce], mesh, per_instance
        )
        radiance = radiance + contribution
    return radiance


def ray_sort_key(
    origins: torch.Tensor,
    directions: torch.Tensor,
    alive: torch.Tensor,
    mesh: MeshSet | None = None,
) -> torch.Tensor:
    """The reference's coherence key of each ray ([R] int64 holding the
    uint32 key; torch's CPU lacks uint32 operations): direction octant in
    bits 0-2, the 5-bit-per-axis Morton cell of ``origin + direction`` in
    bits 3-17, the ray's first-entered instance (``instance_entry_candidates``,
    K for none, clamped to 13 bits) in bits 18-30, and the dead flag in bit
    31, so sorting by it puts every dead lane after every live one."""
    candidate = torch.zeros(origins.shape[0], dtype=torch.int64, device=origins.device)
    if mesh is not None:
        table = kernels.instance_operands(mesh)
        candidate = kernels.instance_entry_candidates(
            origins, directions, table[:, 13:16], table[:, 16:19]
        )
    point = origins + directions
    lo = point.min(dim=0).values
    span = torch.clamp_min(point.max(dim=0).values - lo, 1e-6)
    cell = ((point - lo) / span * 31.999).to(torch.int64)  # 5 bits per axis

    def part1by2(v):  # spread 5 bits to every third position
        v = (v | (v << 8)) & 0x0300F
        v = (v | (v << 4)) & 0x030C3
        return (v | (v << 2)) & 0x09249

    morton = part1by2(cell[:, 0]) | (part1by2(cell[:, 1]) << 1) | (part1by2(cell[:, 2]) << 2)
    octant = (
        (directions[:, 0] > 0).to(torch.int64)
        | ((directions[:, 1] > 0).to(torch.int64) << 1)
        | ((directions[:, 2] > 0).to(torch.int64) << 2)
    )
    dead = (~alive).to(torch.int64) << 31
    return (torch.clamp_max(candidate, 0x1FFF) << 18) | (morton << 3) | octant | dead


def _ray_sort_order(origins, directions, alive, mesh=None) -> torch.Tensor:
    """The permutation that sorts the rays by ``ray_sort_key``, stably (as
    ``jnp.argsort``): rays of a packet then mostly want the same instance
    first and share an origin cell and octant, and dead lanes go last."""
    return torch.argsort(ray_sort_key(origins, directions, alive, mesh), stable=True)


def resolve_tlas_config(tlas_leaf=None, tlas_block=None) -> tuple[int, int]:
    """The TLAS tiers as concrete values: ``(tlas_leaf, tlas_block)``, each
    argument left None taken from its environment tier (``TRC_TLAS_LEAF``,
    clamped to [1, 16]; ``TRC_TLAS_BLOCK``, snapped to a power of two in
    [128, 1024]: ``kernels.tlas_leaf_size``, ``kernels.tlas_block_r``, the
    reference's resolvers). A given value (an internal driver's, as
    ``raypool.PoolWindow`` takes them, after the reference's
    ``_raypool_batch``) is taken as it is and must be one the kernels take
    (a leaf of 1 to 16, a packet of ``kernels.TLAS_PACKETS``): any other
    raises. Resolved beside ``resolve_bvh_config``, at the same sites and
    into the same cache keys."""
    leaf = kernels.tlas_leaf_size() if tlas_leaf is None else int(tlas_leaf)
    if not 1 <= leaf <= kernels.TLAS_LEAF_MAX:
        raise ValueError(f"a TLAS leaf holds 1 to {kernels.TLAS_LEAF_MAX} instances, not {leaf}")
    block = kernels.tlas_block_r() if tlas_block is None else kernels.tlas_packet(tlas_block)
    return leaf, block


def resolve_bvh_config(use_tlas=None, quant=None, builder=None, wide=None):
    """The BVH tiers as concrete values: ``(use_tlas, quant, builder,
    wide)``, each argument left None taken from its environment tier
    (``TRC_TLAS``, ``TRC_BVH_QUANT``, ``TRC_BVH_BUILDER``, ``TRC_BVH_WIDE``)
    with the reference's clamps (``integrator.py:708-726``). The one site
    the factories, drivers and the backend resolve them through, so an
    environment change between calls takes a fresh cache key."""
    return (
        kernels.tlas_enabled() if use_tlas is None else bool(use_tlas),
        kernels.bvh_quant_mode() if quant is None else max(0, min(int(quant), 2)),
        bvh_builder() if builder is None else str(builder),
        bvh_wide() if wide is None else max(1, min(int(wide), 8)),
    )


def trace_paths(
    scene: Scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed: int,
    *,
    max_bounces: int,
    mesh: MeshSet | None = None,
    use_tlas: bool | None = None,
    rng_lanes: torch.Tensor | None = None,
    quant: int = 0,
    tlas_block: int = kernels.TLAS_BLOCK_R,
) -> torch.Tensor:
    """Trace one sample per ray through the whole bounce loop; radiance
    [R, 3]. The reference's dispatch: no mesh -> the sphere megakernel; a
    mesh within the walk bound -> the mesh megakernel; a deeper mesh ->
    the per-bounce mesh kernel under the masked deep loop. ``use_tlas``
    (None: ``kernels.use_tlas_for``) picks the mesh kernels' TLAS variant,
    ``quant`` their node format, ``tlas_block`` its packet (the leaf is the
    mesh's).

    ``rng_lanes`` (int32 [R]) gives each ray its RNG counter, the region
    path's whole-frame lanes: the sphere megakernel then runs in its lane
    mode, and every mesh scene, within the walk bound or not, takes the
    masked deep loop, whose per-bounce kernel reads lanes (the reference's
    routing: its mesh megakernel has no lane mode)."""
    if mesh is None:
        return kernels.trace_paths_fused(
            scene, origins, directions, seed, max_bounces=max_bounces, lane=rng_lanes
        )
    if rng_lanes is None and kernels.mesh_megakernel_eligible(mesh):
        return kernels.trace_paths_fused_mesh(
            scene, mesh, origins, directions, seed, max_bounces=max_bounces, use_tlas=use_tlas,
            quant=quant, tlas_block=tlas_block,
        )
    return _trace_paths_deep(
        scene, mesh, origins, directions, seed, max_bounces, use_tlas, rng_lanes, quant,
        tlas_block,
    )


def _trace_paths_deep(
    scene, mesh, origins, directions, seed, max_bounces, use_tlas=None, rng_lanes=None, quant=0,
    tlas_block=kernels.TLAS_BLOCK_R,
):
    """The reference's masked deep loop: per bounce, re-sort the rays by the
    coherence key (dead lanes to the tail) with ONE packed [n, 12] gather
    of the travelling state, count the live lanes, and launch the
    per-bounce kernel over every lane; the carried original lane unsorts
    the radiance at the end, and is the RNG counter too unless
    ``rng_lanes`` gives the counters: then ``rng_lanes`` at the carried
    lanes. The live count stays on
    the device: the loop never waits for the card. Under the TLAS variant
    (``integrator.py:475-525`` of the reference) bounce 0 sorts by
    ``kernels.initial_mesh_sort_keys`` and every later bounce by the key
    column the previous launch wrote; the flat variant sorts by
    ``ray_sort_key``. Both sorts are stable, as ``jnp.argsort``. ``quant``
    is the kernel's node format; the loop carries float32 throughput at
    every tier, as the reference's (``integrator.py:478-521``); ``tlas_block``
    the TLAS kernel's packet."""
    n = origins.shape[0]
    device = origins.device
    throughput = torch.ones((n, 3), dtype=torch.float32, device=device)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=device)
    alive = torch.ones((n,), dtype=torch.bool, device=device)
    lane = torch.arange(n, dtype=torch.int32, device=device)
    tlas = kernels.use_tlas_for(mesh.instances.translation.shape[0], use_tlas,
                                kernels.mesh_leaf(mesh))
    keys = kernels.initial_mesh_sort_keys(mesh, origins, directions, alive) if tlas else None
    for bounce in range(max_bounces):
        if tlas:
            order = torch.argsort(keys, stable=True)
        else:
            order = _ray_sort_order(origins, directions, alive, mesh)
        packed = torch.cat([origins, directions, throughput, radiance], dim=1)[order]
        origins, directions = packed[:, 0:3], packed[:, 3:6]
        throughput, radiance = packed[:, 6:9], packed[:, 9:12]
        alive, lane = alive[order], lane[order]
        counter = lane if rng_lanes is None else rng_lanes[lane]
        live = alive.sum(dtype=torch.int32)
        step = kernels.mesh_bounce(
            scene, mesh, origins, directions, throughput, alive, counter, live, seed, bounce,
            total_bounces=max_bounces, use_tlas=tlas, quant=quant, tlas_block=tlas_block,
        )
        origins, directions, throughput, alive = (
            step.origins, step.directions, step.throughput, step.alive
        )
        keys = step.key
        radiance = radiance + step.contribution
    return torch.zeros_like(radiance).index_copy_(0, lane.to(torch.int64), radiance)


def render_tile(
    scene: Scene,
    camera: Camera,
    frame,
    y0: int,
    x0: int,
    *,
    width: int,
    height: int,
    tile_height: int,
    tile_width: int,
    samples: int = 8,
    max_bounces: int = 4,
    mesh: MeshSet | None = None,
    bounce_scan: bool = False,
    per_instance: bool = False,
    use_tlas: bool | None = None,
    quant: int = 0,
    key_x0: int | None = None,
    tlas_block: int = kernels.TLAS_BLOCK_R,
) -> torch.Tensor:
    """Render a tile; returns [tile_height, tile_width, 3] linear radiance.

    The RNG key derives from (frame, y0, x0, sample); ``key_x0``, where
    given, takes the place of ``x0`` in the key only, not in the pixel
    columns (the sharded renderer's spp subsets: a shard tag). By default the
    reference's flattened-samples branch: all samples are traced in one
    launch and averaged per pixel. ``bounce_scan`` takes its per-sample
    branch instead: sample ``s`` draws its jitter from ``fold_in(base_key,
    s)`` and traces through ``trace_paths_scan`` with that key's second
    split, and the samples' radiance is summed, then divided by ``samples``.
    ``per_instance`` (with ``bounce_scan`` only) walks the instances one
    by one. ``use_tlas``, ``quant`` and ``tlas_block`` go to ``trace_paths``
    (the scan has no TLAS variant and no node format).
    """
    _check_per_instance(per_instance, bounce_scan)
    n = tile_height * tile_width
    base_key = tile_base_key(frame, y0, x0 if key_x0 is None else key_x0)
    if bounce_scan:
        device = camera.origin.device
        sample_keys = rng.fold_in(base_key, torch.arange(samples)).to(device)
        total = torch.zeros((n, 3), dtype=torch.float32, device=device)
        for sample in range(samples):
            key = sample_keys[sample]
            origins, directions = sample_jitter_rays(
                camera, key, width=width, height=height, y0=y0, x0=x0,
                tile_height=tile_height, tile_width=tile_width,
            )
            total = total + trace_paths_scan(
                scene, origins, directions, rng.split(key)[1], max_bounces=max_bounces,
                mesh=mesh, per_instance=per_instance,
            )
        return (total / samples).reshape(tile_height, tile_width, 3)
    origins, directions = flat_sample_rays(
        camera, base_key, width=width, height=height, y0=y0, x0=x0,
        tile_height=tile_height, tile_width=tile_width, samples=samples,
    )
    radiance = trace_paths(
        scene, origins, directions, trace_seed(tile_trace_key(base_key)),
        max_bounces=max_bounces, mesh=mesh, use_tlas=use_tlas, quant=quant,
        tlas_block=tlas_block,
    )
    image = radiance.reshape(samples, n, 3).mean(dim=0)
    return image.reshape(tile_height, tile_width, 3)


def render_frame(
    scene_name: str,
    frame_index: int,
    *,
    width: int = 512,
    height: int = 512,
    samples: int = 8,
    max_bounces: int = 4,
    tile_size: int | None = None,
    device: str | torch.device | None = None,
    bounce_scan: bool = False,
    per_instance: bool = False,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
) -> torch.Tensor:
    """Render a whole frame; returns [H, W, 3] linear radiance on ``device``
    (``bounce_scan``: through the per-bounce scan renderer; ``per_instance``
    as well: its mesh queries as a scan over the instances; ``use_tlas``,
    ``quant``, ``builder``, ``wide``: the BVH tiers, None for the
    environment's, ``resolve_bvh_config``; the TLAS tiers the environment's,
    ``resolve_tlas_config``).

    ``tile_size``: the reference's local tiling, one ``render_tile`` per
    ``tile_size`` square (smaller at the right and bottom edges), each with
    its own RNG root ``tile_base_key(frame, y0, x0)``, concatenated. The
    image differs from the untiled one in its noise, not its content."""
    device = resolve_device(device)
    use_tlas, quant, builder, wide = resolve_bvh_config(use_tlas, quant, builder, wide)
    tlas_leaf, tlas_block = resolve_tlas_config()
    scene = build_scene(scene_name, frame_index, device)
    camera = scene_camera(scene_name, frame_index, device)
    mesh = scene_mesh_set(scene_name, frame_index, builder, wide, device, tlas_leaf)
    tile = functools.partial(
        render_tile, scene, camera, frame_index, width=width, height=height,
        samples=samples, max_bounces=max_bounces, mesh=mesh, bounce_scan=bounce_scan,
        per_instance=per_instance, use_tlas=use_tlas, quant=quant, tlas_block=tlas_block,
    )
    if tile_size is None:
        return tile(0, 0, tile_height=height, tile_width=width)
    rows = [
        torch.cat(
            [
                tile(y0, x0, tile_height=min(tile_size, height - y0),
                     tile_width=min(tile_size, width - x0))
                for x0 in range(0, width, tile_size)
            ],
            dim=1,
        )
        for y0 in range(0, height, tile_size)
    ]
    return torch.cat(rows, dim=0)


def tonemap(image: torch.Tensor) -> torch.Tensor:
    """Linear -> display: Reinhard + gamma 2.2, uint8."""
    mapped = image / (1.0 + image)
    srgb = torch.pow(torch.clamp(mapped, 0.0, 1.0), 1.0 / 2.2)
    return (srgb * 255.0 + 0.5).to(torch.uint8)


@functools.lru_cache(maxsize=32)
def _fused_frame_renderer(
    scene_name: str, width: int, height: int, samples: int, max_bounces: int,
    device: torch.device, bounce_scan: bool, per_instance: bool, use_tlas: bool, quant: int,
    builder: str, wide: int, tlas_leaf: int, tlas_block: int,
):
    def render(frame: int) -> torch.Tensor:
        scene = build_scene(scene_name, frame, device)
        camera = scene_camera(scene_name, frame, device)
        linear = render_tile(
            scene, camera, frame, 0, 0,
            width=width, height=height, tile_height=height, tile_width=width,
            samples=samples, max_bounces=max_bounces,
            mesh=scene_mesh_set(scene_name, frame, builder, wide, device, tlas_leaf),
            bounce_scan=bounce_scan, per_instance=per_instance, use_tlas=use_tlas, quant=quant,
            tlas_block=tlas_block,
        )
        return tonemap(linear)

    return render


def fused_frame_renderer(
    scene_name: str,
    width: int,
    height: int,
    samples: int,
    max_bounces: int,
    device: str | torch.device | None = None,
    bounce_scan: bool = False,
    per_instance: bool = False,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
):
    """A cached ``frame -> uint8 [H, W, 3]`` callable for one scene/config.

    The image stays on ``device``: the caller copies it back when it needs
    the pixels. The device resolves here (CUDA unless ``cpu`` is asked
    for) and is part of the cache key, as are ``bounce_scan`` (the
    per-bounce scan renderer in place of the kernel dispatch of
    ``trace_paths``), ``per_instance`` (the scan's mesh queries walked
    instance by instance; needs ``bounce_scan``) and the BVH tiers
    ``use_tlas``, ``quant``, ``builder`` and ``wide``, resolved here
    (``resolve_bvh_config``: None takes the environment's), with the
    environment's TLAS tiers (``resolve_tlas_config``), so renderers of
    distinct tiers live side by side.
    """
    _check_per_instance(per_instance, bounce_scan)
    return _fused_frame_renderer(
        scene_name, width, height, samples, max_bounces, resolve_device(device),
        bool(bounce_scan), bool(per_instance), *resolve_bvh_config(use_tlas, quant, builder, wide),
        *resolve_tlas_config(),
    )


fused_frame_renderer.cache_clear = _fused_frame_renderer.cache_clear


@functools.lru_cache(maxsize=64)
def _fused_region_renderer(
    scene_name: str, width: int, height: int, tile_height: int, tile_width: int,
    samples: int, max_bounces: int, device: torch.device, bounce_scan: bool,
    per_instance: bool, use_tlas: bool, quant: int, builder: str, wide: int, tlas_leaf: int,
    tlas_block: int,
):
    def render(frame: int, y0: int, x0: int) -> torch.Tensor:
        scene = build_scene(scene_name, frame, device)
        camera = scene_camera(scene_name, frame, device)
        mesh = scene_mesh_set(scene_name, frame, builder, wide, device, tlas_leaf)
        origins, directions, lanes, seed = region_rays_and_seed(
            camera, frame, width=width, height=height, samples=samples, y0=y0, x0=x0,
            tile_height=tile_height, tile_width=tile_width,
        )
        if bounce_scan:
            # The scan draws its random numbers by shape (threefry), not by
            # lane: the region gets its own stream, so it matches the whole
            # frame statistically, not bit for bit (the reference's
            # Pallas-off branch).
            radiance = trace_paths_scan(
                scene, origins, directions, tile_trace_key(tile_base_key(frame, 0, 0)),
                max_bounces=max_bounces, mesh=mesh, per_instance=per_instance,
            )
        else:
            radiance = trace_paths(
                scene, origins, directions, seed, max_bounces=max_bounces, mesh=mesh,
                use_tlas=use_tlas, rng_lanes=lanes, quant=quant, tlas_block=tlas_block,
            )
        n = tile_height * tile_width
        return radiance.reshape(samples, n, 3).mean(dim=0).reshape(tile_height, tile_width, 3)

    return render


def fused_region_renderer(
    scene_name: str,
    width: int,
    height: int,
    tile_height: int,
    tile_width: int,
    samples: int,
    max_bounces: int,
    device: str | torch.device | None = None,
    bounce_scan: bool = False,
    per_instance: bool = False,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
):
    """A cached ``(frame, y0, x0) -> [th, tw, 3] linear`` region renderer,
    one per tile shape and device: every tile position and frame of a grid
    shares it.

    The region traces the whole frame's rays and RNG restricted to its
    pixels (``region_rays_and_seed``), so a stitched grid of regions equals
    the whole-frame render bit for bit: sphere scenes through the lane mode
    of the sphere megakernel, mesh scenes through the masked deep loop with
    the lanes as RNG counters. ``bounce_scan`` (and ``per_instance``) take
    the scan renderer over the region's rays instead. The result is linear,
    not tonemapped. The BVH and TLAS tiers resolve as ``fused_frame_renderer``'s.
    """
    _check_per_instance(per_instance, bounce_scan)
    return _fused_region_renderer(
        scene_name, width, height, tile_height, tile_width, samples, max_bounces,
        resolve_device(device), bool(bounce_scan), bool(per_instance),
        *resolve_bvh_config(use_tlas, quant, builder, wide),
        *resolve_tlas_config(),
    )


fused_region_renderer.cache_clear = _fused_region_renderer.cache_clear


def render_frame_region(
    scene_name: str,
    frame_index: int,
    *,
    y0: int,
    x0: int,
    tile_height: int,
    tile_width: int,
    width: int = 512,
    height: int = 512,
    samples: int = 8,
    max_bounces: int = 4,
    device: str | torch.device | None = None,
    bounce_scan: bool = False,
    per_instance: bool = False,
    use_tlas: bool | None = None,
    quant: int | None = None,
    builder: str | None = None,
    wide: int | None = None,
) -> torch.Tensor:
    """Render one region of a frame; [tile_height, tile_width, 3] linear on
    ``device``, the whole frame's pixels there (``fused_region_renderer``)."""
    return fused_region_renderer(
        scene_name, width, height, tile_height, tile_width, samples, max_bounces, device,
        bounce_scan=bounce_scan, per_instance=per_instance, use_tlas=use_tlas, quant=quant,
        builder=builder, wide=wide,
    )(frame_index, y0, x0)
