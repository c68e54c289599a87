"""The group walk of the TLAS per-bounce and pool kernels, as a torch model,
against the plain version's sequential walk, bit for bit.

``csrc/mesh_common.cuh``'s ``GroupTlas`` walks one ray with G threads of a
warp (G = 1, 2, 4, 8): the same node sequence as the one-thread walk, each
leaf's work split over the G threads strided (a BLAS leaf's triangle rows,
a TLAS leaf's slots' world-box tests), each thread keeping its first
minimum of the leaf against the group's best t, the group reducing by
(t, slot, row) before the next node test, a leaf's slots entered in order
against the best t so far; the entry walk reduces by (entry, slot). The
CUDA kernels run only on a GPU (``tests/test_torch_tlas_group_cuda.py``);
``GroupWalk`` below repeats that schedule with the plain version's own
arithmetic (``kernels._MeshWalk``'s leaf, slab and object-space transform),
so these tests check the schedule: the nearest hit (t, slot, triangle row)
and the entry walk's candidate equal ``_MeshWalk.nearest_rows`` and
``_MeshWalk.entry_candidates`` to the bit for every G.

Rays: the bounce-0 and bounce-2 launches of a 32x24 wavefront frame (1 spp)
of ``02_physics-mesh`` and ``03_physics-2-mesh``, each walk seeded with no
hit and with half its nearest hit's distance (the seed culls); and exact
ties built on purpose: a BVH leaf whose first two triangle rows are equal,
rays aimed at the midpoints of edges two triangles share, and a slot table
whose slots 0 and 1 hold the same instance (equal world boxes, so equal
entry distances and equal hits). Tolerance: none, every output to the bit.
Also the per-bounce kernel's group policy (``kernels.bounce_group``) and the
wrappers' ``_group`` check.

The flat sweep of the scan's instance kernels (``csrc/intersect_instances.cu``,
``csrc/occluded_instances.cu``: ``GroupFlat``, one leaf of K slots walked as
a TLAS leaf's) is modelled the same way (``GroupWalk.flat_nearest_rows``,
``flat_occluded``, with the any-hit kernel's compaction of a warp's walking
lanes, ``warp_schedule``) and held to ``_MeshWalk.nearest_rows`` and
``_MeshWalk.occluded`` bit for bit at every G: on the rays of every bounce
of a 32x24 scan frame of ``03_physics-2-mesh`` with their own seeds and
``already`` masks, on built exact ties (two slots holding one instance, two
equal rows of one leaf), with K = 47 and K = 3 (a ragged last chunk, K < G),
and with ``already`` all set, none set and mixed, also under the any-hit
kernel's default, each warp's pick of G for its batch (``warp_group``); and
the nearest-hit kernel's group policy (``kernels.instance_group``).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.render import compaction, integrator, kernels
from tpu_render_cluster_torch.render.kernels import INF, _MeshWalk, _sweep, _to_object, _winv
from tpu_render_cluster_torch.render.mesh import cached_tlas_topology, scene_mesh_set, tlas_node_bounds
from tpu_render_cluster_torch.render.scene import build_scene

GROUPS = (1, 2, 4, 8)
SCENES = ("02_physics-mesh", "03_physics-2-mesh")
WIDTH, HEIGHT, BOUNCES, FRAME = 32, 24, 4, 7


def _box(row, o, inv):
    """A slot's world-box test without its limit: (reached, near), as
    ``kernels._slab`` computes it (the box is hit when reached and
    near < limit)."""
    t_lo = (row[13:16] - o) * inv
    t_hi = (row[16:19] - o) * inv
    near = torch.minimum(t_lo, t_hi)
    far = torch.maximum(t_lo, t_hi)
    tnear = torch.maximum(torch.maximum(near[:, 0], near[:, 1]), near[:, 2])
    tfar = torch.minimum(torch.minimum(far[:, 0], far[:, 1]), far[:, 2])
    return tfar >= torch.clamp_min(tnear, 0.0), tnear


def _least(candidates):
    """The lexicographically least of the group's candidates (tuples of
    [n] tensors), the reduction the group's shuffles make."""
    best = candidates[0]
    for other in candidates[1:]:
        take = torch.zeros_like(best[0], dtype=torch.bool)
        tie = torch.ones_like(take)
        for have, want in zip(best, other):
            take |= tie & (want < have)
            tie &= want == have
        best = tuple(torch.where(take, want, have) for have, want in zip(best, other))
    return best


class GroupWalk:
    """A model of ``GroupTlas<G>`` over one frame's TLAS walk (``walk``,
    a ``_MeshWalk`` built with ``use_tlas=True``)."""

    def __init__(self, walk: _MeshWalk, group: int):
        self.walk, self.group = walk, group

    def _blas_nearest(self, o, d, best, slot):
        """The group's BLAS walk of rays entering ``slot`` (object space
        ``o``/``d`` [n, 3]); ``best`` = [t, slot, row] [n] tensors, updated
        in place."""
        walk, group = self.walk, self.group

        def on_leaf(node, pos):
            hit, t = walk._leaf(node, o[pos], d[pos])
            t = torch.where(hit, t, INF)
            width = t.shape[1]
            mine = []
            for rank in range(group):
                own = tuple(b[pos] for b in best)
                cols = torch.arange(rank, width, group)
                if cols.numel():
                    part = t[:, cols]
                    t_min = part.min(dim=1).values
                    first = torch.where(part == t_min[:, None], cols, width).min(dim=1).values
                    better = t_min < own[0]
                    own = (
                        torch.where(better, t_min, own[0]),
                        torch.where(better, slot, own[1]),
                        torch.where(better, walk.first[node] + first, own[2]),
                    )
                mine.append(own)
            for b, value in zip(best, _least(mine)):
                b[pos] = value

        walk._walk(o, _winv(d), best[0], on_leaf, None)

    def _tlas(self, o, inv, limit, on_leaf):
        tlas = self.walk.tlas
        _sweep(tlas.bounds_min, tlas.bounds_max, tlas.count, tlas.children, o, inv, limit,
               on_leaf, None, "tlas_node_tests")

    def nearest_rows(self, o, d, seed_t):
        """(t, slot (-1: none), triangle row) [n], as ``nearest_rows``."""
        walk, group = self.walk, self.group
        n = o.shape[0]
        best = [seed_t.clone(), torch.full((n,), -1, dtype=torch.int64),
                torch.zeros((n,), dtype=torch.int64)]
        inv = _winv(d)

        def on_leaf(node, pos):
            first = walk.tlas.first[node]
            self._slots_nearest(first, first + walk.tlas.count[node], pos, o, d, inv, best)

        self._tlas(o, inv, best[0], on_leaf)
        return tuple(best)

    def _slots_nearest(self, first, end, pos, o, d, inv, best):
        """Slots [first, end) for the rays ``pos`` (``group_slots_nearest``):
        each chunk's box tests, one slot a thread, then its slots in order
        against the best t so far."""
        walk = self.walk
        for chunk in range(first, end, self.group):
            tests = [(k, *_box(walk.table[k], o[pos], inv[pos]))
                     for k in range(chunk, min(chunk + self.group, end))]
            for k, reached, near in tests:
                enter = pos[reached & (near < best[0][pos])]
                if enter.numel() == 0:
                    continue
                row = walk.table[k]
                part = [b[enter].clone() for b in best]
                self._blas_nearest(_to_object(row, o[enter], shift=True),
                                   _to_object(row, d[enter], shift=False), part, k)
                for b, value in zip(best, part):
                    b[enter] = value

    def flat_nearest_rows(self, o, d, seed_t):
        """``GroupFlat<G>::nearest``: the flat sweep as one leaf of all K
        slots; (t, instance (-1: none), triangle row) [n]."""
        n = o.shape[0]
        best = [seed_t.clone(), torch.full((n,), -1, dtype=torch.int64),
                torch.zeros((n,), dtype=torch.int64)]
        self._slots_nearest(0, self.walk.table.shape[0], torch.arange(n), o, d, _winv(d), best)
        return tuple(best)

    def _blas_occluded(self, o, d):
        """``group_blas_occluded`` of object-space rays [n, 3]: each thread
        tests its strided rows of a leaf up to its first hit, and the walk
        ends on the group's any-vote."""
        walk, group = self.walk, self.group
        limit = torch.full((o.shape[0],), INF)

        def on_leaf(node, pos):
            hit, _ = walk._leaf(node, o[pos], d[pos])
            votes = [hit[:, rank::group].any(dim=1) for rank in range(group)]
            found = torch.stack(votes).any(dim=0)
            limit[pos[found]] = -INF

        walk._walk(o, _winv(d), limit, on_leaf, None)
        return limit == -INF

    def flat_occluded(self, o, d, already):
        """``occluded_instances``' kernel: ``already`` lanes 1 without a
        walk; the others, in the order ``warp_schedule`` hands them to the
        groups, through ``GroupFlat<G>::occluded`` along their own
        direction, ending at their first occluder."""
        walk, group = self.walk, self.group
        order = warp_schedule(already, group)
        occluded = already.clone()
        inv = _winv(d)
        k_count = walk.table.shape[0]
        for chunk in range(0, k_count, group):
            tests = [(k, *_box(walk.table[k], o[order], inv[order]))
                     for k in range(chunk, min(chunk + group, k_count))]
            for k, reached, near in tests:
                enter = order[reached & (near < INF) & ~occluded[order]]
                if enter.numel() == 0:
                    continue
                row = walk.table[k]
                found = self._blas_occluded(_to_object(row, o[enter], shift=True),
                                            _to_object(row, d[enter], shift=False))
                occluded[enter[found]] = True
        return occluded

    def entry_candidates(self, o, d):
        """The entry walk's slot [n] (K: none), as ``entry_candidates``."""
        walk, group = self.walk, self.group
        n = o.shape[0]
        best = [torch.full((n,), INF), torch.full((n,), walk.table.shape[0], dtype=torch.int64)]
        inv = _winv(d)

        def on_leaf(node, pos):
            first = walk.tlas.first[node]
            end = first + walk.tlas.count[node]
            mine = []
            for rank in range(group):
                own_e, own_k = best[0][pos], best[1][pos]
                for k in range(first + rank, end, group):
                    reached, near = _box(walk.table[k], o[pos], inv[pos])
                    entry = torch.clamp_min(near, 0.0)
                    better = reached & (entry < own_e)
                    own_e = torch.where(better, entry, own_e)
                    own_k = torch.where(better, k, own_k)
                mine.append((own_e, own_k))
            best[0][pos], best[1][pos] = _least(mine)

        self._tlas(o, inv, best[0], on_leaf)
        return best[1]


def nth_set_bit(mask: int, n: int) -> int:
    """``occluded_instances.cu``'s search for the n-th (from 0) set bit."""
    position = 0
    width = 16
    while width > 0:
        low = mask & ((1 << width) - 1)
        below = bin(low).count("1")
        if n >= below:
            n -= below
            mask >>= width
            position += width
        else:
            mask = low
        width >>= 1
    return position


def warp_schedule(already: torch.Tensor, group: int) -> torch.Tensor:
    """The walking rays (``already`` unset) in the order the any-hit
    kernel's warps hand them to their groups: a warp takes 32 lanes,
    numbers its walkers by ballot, and its 32 / G groups take walker
    ``base + g`` for base = 0, 32 / G, ... (ray start + nth_set_bit)."""
    order = []
    rays = already.shape[0]
    for start in range(0, rays, 32):
        lanes = (~already[start:start + 32]).tolist()
        mask = sum(1 << i for i, walks in enumerate(lanes) if walks)
        walking = bin(mask).count("1")
        for base in range(0, walking, 32 // group):
            for taken in range(base, min(base + 32 // group, walking)):
                order.append(start + nth_set_bit(mask, taken))
    return torch.tensor(order, dtype=torch.int64)


def warp_group(n_walking: int) -> int:
    """The any-hit kernel's default group size for a warp's batch (its G =
    0): the largest G that takes the batch's walking rays in one round."""
    return 1 if n_walking > 16 else 2 if n_walking > 8 else 4 if n_walking > 4 else 8


def adaptive_occluded(walk: _MeshWalk, o, d, already) -> torch.Tensor:
    """The any-hit kernel's default: each batch of 32 rays walked by groups
    of ``warp_group`` of its walking rays."""
    groups = torch.ones(already.shape[0], dtype=torch.int64)
    for start in range(0, already.shape[0], 32):
        groups[start:start + 32] = warp_group(int((~already[start:start + 32]).sum()))
    out = already.clone()
    for group in GROUPS:
        batch = groups == group
        if batch.any():
            out[batch] = GroupWalk(walk, group).flat_occluded(o, d, already | ~batch)[batch]
    return out


def _assert_walks_agree(walk: _MeshWalk, o, d, seeds=None) -> None:
    """Every G's group walk against the sequential walk, to the bit: the
    nearest hit with no seed and with half its own distance as the seed,
    and the entry candidate."""
    unseeded = walk.nearest_rows(o, d, torch.full((o.shape[0],), INF), None)
    hit = unseeded[1] >= 0
    assert hit.any()
    seeded_t = torch.where(hit, unseeded[0] * 0.5, INF) if seeds is None else seeds
    seeded = walk.nearest_rows(o, d, seeded_t, None)
    entry = walk.entry_candidates(o, d, None)
    for group in GROUPS:
        model = GroupWalk(walk, group)
        for seed_t, expected in ((torch.full((o.shape[0],), INF), unseeded), (seeded_t, seeded)):
            got = model.nearest_rows(o, d, seed_t)
            for have, want in zip(got, expected):
                assert torch.equal(have, want), f"G={group}: the nearest hit differs"
        assert torch.equal(model.entry_candidates(o, d), entry), f"G={group}: the entry differs"


def _launch_rays(name: str):
    """The bounce-0 and bounce-2 launches' rays of a 32x24 wavefront frame."""
    scene = build_scene(name, FRAME, "cpu")
    mesh = scene_mesh_set(name, FRAME, device="cpu")
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(name, FRAME, "cpu"), FRAME, width=WIDTH, height=HEIGHT, samples=1
    )
    launches: list = []
    compaction.trace_paths_wavefront(
        scene, origins, directions, seed, max_bounces=BOUNCES, mesh=mesh,
        on_launch=launches.append,
    )
    return mesh, {launch.bounce: launch.state[:2] for launch in launches}


@pytest.mark.parametrize("bounce", [0, 2])
@pytest.mark.parametrize("name", SCENES)
def test_group_walk_matches_sequential_walk(name, bounce):
    mesh, rays = _launch_rays(name)
    walk = _MeshWalk.build(mesh, use_tlas=True)
    o, d = rays[bounce]
    misses = walk.nearest_rows(o, d, torch.full((o.shape[0],), INF), None)[1] < 0
    assert misses.any() and not misses.all()
    _assert_walks_agree(walk, o, d)


def _world_point(row, x):
    """Object-space points [n, 3] of an instance-table ``row`` in world
    space: t + s R x (``_to_object`` inverted)."""
    rot = row[0:9].reshape(3, 3)
    return row[9:12] + (x @ rot.T) / row[12]


def _aimed_rays(walk: _MeshWalk, slots, local, normals):
    """World rays toward object-space points ``local`` [n, 3] of instances
    ``slots`` [n], each from 2 units off its face along the face's normal
    (turned away from the mesh's centre), so that it meets that face first."""
    out = torch.where((normals * local).sum(dim=1, keepdim=True) < 0, -normals, normals)
    starts = torch.stack([_world_point(walk.table[k], p[None, :])[0]
                          for k, p in zip(slots, local + 2.0 * out)])
    targets = torch.stack([_world_point(walk.table[k], p[None, :])[0]
                           for k, p in zip(slots, local)])
    d = targets - starts
    return starts, d / torch.linalg.norm(d, dim=1, keepdim=True)


def test_group_walk_exact_ties():
    """Ties built on purpose: a leaf's first two triangle rows equal (both
    rows hit at the same t, on different threads of a group), rays at the
    midpoints of edges two triangles share, and two slots holding one
    instance (equal world boxes and hits): the lowest row and slot win, as
    in the sequential walk."""
    rng = np.random.default_rng(909)
    mesh = scene_mesh_set("03_physics-2-mesh", FRAME, device="cpu")
    walk = _MeshWalk.build(mesh, use_tlas=True)
    # Slot 1 becomes a copy of slot 0; the TLAS node boxes are rebuilt.
    table = walk.table.clone()
    table[1] = table[0]
    lo, hi = tlas_node_bounds(cached_tlas_topology(table.shape[0], kernels.TLAS_LEAF),
                              table[:, 13:16], table[:, 16:19])
    tlas = walk.tlas._replace(bounds_min=lo, bounds_max=hi)
    # A leaf of at least two rows gets its second row equal to its first.
    leaf = next(n for n, c in enumerate(walk.count) if c >= 2)
    first = walk.first[leaf]
    v0, e1, e2, normal = (t.clone() for t in (walk.v0, walk.e1, walk.e2, walk.normal))
    for column in (v0, e1, e2, normal):
        column[first + 1] = column[first]
    tied = walk._replace(table=table, tlas=tlas, v0=v0, e1=e1, e2=e2, normal=normal)
    # Targets: the duplicated triangle's centroid, and midpoints of its
    # edges and of edges of other rows (each edge of a closed mesh is
    # shared by two triangles), on slots 0 and 1 and a few others.
    rows = torch.as_tensor(rng.integers(0, v0.shape[0], 24))
    rows[:8] = first
    weights = torch.tensor([[1 / 3, 1 / 3], [0.5, 0.0], [0.0, 0.5], [0.5, 0.5]])
    local = torch.cat([v0[rows] + w[0] * e1[rows] + w[1] * e2[rows] for w in weights])
    faces = normal[rows].repeat(len(weights), 1)
    slots = torch.as_tensor(rng.integers(0, table.shape[0], local.shape[0]))
    slots[: local.shape[0] // 2] = torch.arange(local.shape[0] // 2) % 2
    o, d = _aimed_rays(tied, slots, local, faces)
    _assert_walks_agree(tied, o, d)
    hits = tied.nearest_rows(o, d, torch.full((o.shape[0],), INF), None)
    assert (hits[1] >= 0).sum() >= o.shape[0] // 2  # most aimed rays hit
    assert ((hits[1] == 0) & (hits[2] == first)).sum() >= 4  # the duplicated row's tie occurs
    assert not (hits[1] == 1).any()  # slot 1 ties slot 0 everywhere and loses
    assert not ((hits[1] == 0) & (hits[2] == first + 1)).any()  # the second row loses
    assert (tied.entry_candidates(o, d, None) == 0).any()  # the slots' entry tie occurs


@pytest.mark.parametrize(
    "rays,group",
    [(2_097_152, 1), (1_048_576, 1), (524_288, 1), (270_336, 1), (262_144, 2), (131_072, 4),
     (67_584, 4), (65_536, 8), (4_096, 8), (1, 8)],
)
def test_bounce_group_policy(rays, group):
    """G = 1 at a full-width bounce of 512x512x8; G > 1 below an H100's
    270,336 thread slots (132 SMs x 2,048), the smallest G that reaches
    them, at most 8."""
    assert kernels.bounce_group(rays, 132 * 2048) == group


def test_group_argument_checked_and_cpu_unchanged():
    """``_group`` takes 1, 2, 4 or 8; on CPU tensors the plain version runs
    and the argument changes nothing."""
    name = "03_physics-2-mesh"
    scene = build_scene(name, FRAME, "cpu")
    mesh = scene_mesh_set(name, FRAME, device="cpu")
    origins, directions, seed = integrator.frame_rays_and_seed(
        integrator.scene_camera(name, FRAME, "cpu"), FRAME, width=8, height=8, samples=1
    )
    n = origins.shape[0]
    state = (origins, directions, torch.ones((n, 3)), torch.ones((n,), dtype=torch.bool),
             torch.arange(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="_group"):
        kernels.mesh_bounce(scene, mesh, *state, n, seed, 0, total_bounces=BOUNCES, _group=3)
    with pytest.raises(ValueError, match="_group"):
        kernels.intersect_instances(mesh, origins, directions, torch.full((n,), INF), _group=0)
    already = torch.zeros((n,), dtype=torch.bool)
    with pytest.raises(ValueError, match="_group"):
        kernels.occluded_instances(mesh, origins, directions, already, _group=16)
    assert torch.equal(
        kernels.occluded_instances(mesh, origins, directions, already, _group=0),
        kernels.occluded_instances(mesh, origins, directions, already),
    )
    kernels.reset_counts()
    plain = kernels.mesh_bounce(scene, mesh, *state, n, seed, 0, total_bounces=BOUNCES)
    grouped = kernels.mesh_bounce(scene, mesh, *state, n, seed, 0, total_bounces=BOUNCES, _group=8)
    assert kernels.counts["mesh_bounce_tlas_reference"] == 2
    for have, want in zip(grouped, plain):
        assert torch.equal(have, want)


# -- the flat sweep of the scan's instance kernels ---------------------------


def _assert_flat_walks_agree(walk: _MeshWalk, o, d, seed_t, already) -> None:
    """Every G's flat group walk against the sequential flat sweep, to the
    bit: the nearest hit unseeded and seeded with ``seed_t``, and the
    any-hit along the rays' own directions under ``already``."""
    n = o.shape[0]
    expected = {
        "unseeded": walk.nearest_rows(o, d, torch.full((n,), INF), None),
        "seeded": walk.nearest_rows(o, d, seed_t, None),
    }
    shadow = walk.occluded(o, already, None, directions=d)
    for group in GROUPS:
        model = GroupWalk(walk, group)
        for label, seeds in (("unseeded", torch.full((n,), INF)), ("seeded", seed_t)):
            got = model.flat_nearest_rows(o, d, seeds)
            for have, want in zip(got, expected[label]):
                assert torch.equal(have, want), f"G={group}: the {label} nearest hit differs"
        got = model.flat_occluded(o, d, already)
        assert torch.equal(got, shadow), f"G={group}: the any-hit differs"
    assert torch.equal(adaptive_occluded(walk, o, d, already), shadow), "the warps' pick differs"


@functools.cache
def _scan_launches():
    """The instanced unit kernels' inputs at every bounce of a 32x24 scan
    frame (1 spp) of 03_physics-2-mesh on the CPU: {bounce: (intersect's
    (origins, directions, init_t), occluded's (origins, directions,
    already))}, and the frame's mesh."""
    log = {"intersect_instances": [], "occluded_instances": []}
    saved = {name: getattr(kernels, name) for name in log}

    def recorder(name):
        def record(mesh, *args):
            log[name].append((mesh, args))
            return saved[name](mesh, *args)
        return record

    try:
        for name in log:
            setattr(kernels, name, recorder(name))
        integrator.render_frame("03_physics-2-mesh", FRAME, width=WIDTH, height=HEIGHT,
                                samples=1, max_bounces=BOUNCES, device="cpu", bounce_scan=True)
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)
    mesh = log["intersect_instances"][0][0]
    launches = {b: (log["intersect_instances"][b][1], log["occluded_instances"][b][1])
                for b in range(BOUNCES)}
    return mesh, launches


@pytest.mark.parametrize("bounce", range(BOUNCES))
def test_flat_group_walk_matches_sequential_sweep(bounce):
    """The scan's own launches: bounce 0's camera rays seeded with the
    sphere/plane hits, the later bounces' with parked dead lanes; the
    any-hit under the scan's ``already`` (shadowed by a sphere, dead, or
    facing away from the sun)."""
    mesh, launches = _scan_launches()
    walk = _MeshWalk.build(mesh)
    (o, d, seed_t), (so, sun, already) = launches[bounce]
    _assert_flat_walks_agree(walk, o, d, seed_t, torch.zeros_like(already))
    _assert_flat_walks_agree(walk, so, sun, seed_t, already)


def _flat_tied_walk():
    """The flat sweep of 03's frame with instance 1 a copy of instance 0
    (equal world boxes and hits) and a BVH leaf's second row equal to its
    first, with the leaf's first row."""
    mesh = scene_mesh_set("03_physics-2-mesh", FRAME, device="cpu")
    walk = _MeshWalk.build(mesh)
    table = walk.table.clone()
    table[1] = table[0]
    leaf = next(n for n, c in enumerate(walk.count) if c >= 2)
    first = walk.first[leaf]
    v0, e1, e2, normal = (t.clone() for t in (walk.v0, walk.e1, walk.e2, walk.normal))
    for column in (v0, e1, e2, normal):
        column[first + 1] = column[first]
    return walk._replace(table=table, v0=v0, e1=e1, e2=e2, normal=normal), first


def test_flat_group_walk_exact_ties():
    """Ties built on purpose: two instances hit at the same t (slot 1 a copy
    of slot 0, so slot 0 wins) and two equal rows of one leaf, which land on
    different threads of a group (the first row wins), and the midpoints of
    edges two triangles share."""
    rng = np.random.default_rng(910)
    tied, first = _flat_tied_walk()
    rows = torch.as_tensor(rng.integers(0, tied.v0.shape[0], 24))
    rows[:8] = first
    weights = torch.tensor([[1 / 3, 1 / 3], [0.5, 0.0], [0.0, 0.5], [0.5, 0.5]])
    local = torch.cat([tied.v0[rows] + w[0] * tied.e1[rows] + w[1] * tied.e2[rows]
                       for w in weights])
    faces = tied.normal[rows].repeat(len(weights), 1)
    slots = torch.as_tensor(rng.integers(0, tied.table.shape[0], local.shape[0]))
    slots[: local.shape[0] // 2] = torch.arange(local.shape[0] // 2) % 2
    o, d = _aimed_rays(tied, slots, local, faces)
    n = o.shape[0]
    hits = tied.nearest_rows(o, d, torch.full((n,), INF), None)
    already = torch.as_tensor(rng.random(n) < 0.3)
    _assert_flat_walks_agree(tied, o, d, torch.where(hits[1] >= 0, hits[0] * 1.5, INF), already)
    assert (hits[1] >= 0).sum() >= n // 2  # most aimed rays hit
    assert ((hits[1] == 0) & (hits[2] == first)).sum() >= 4  # the duplicated row's tie occurs
    assert not (hits[1] == 1).any()  # slot 1 ties slot 0 everywhere and loses
    assert not ((hits[1] == 0) & (hits[2] == first + 1)).any()  # the second row loses


@pytest.mark.parametrize("k_count", [47, 3])
def test_flat_group_walk_ragged_and_small_tables(k_count):
    """K = 47 (a ragged last chunk at G = 2, 4, 8) and K = 3 (fewer slots
    than a group of 4 or 8 has threads), on bounce 0 and bounce 1 rays."""
    mesh, launches = _scan_launches()
    walk = _MeshWalk.build(mesh)
    walk = walk._replace(table=walk.table[:k_count])
    for bounce in (0, 1):
        (o, d, seed_t), (so, sun, already) = launches[bounce]
        hits = walk.nearest_rows(o, d, torch.full((o.shape[0],), INF), None)
        assert (hits[1] >= 0).any()
        _assert_flat_walks_agree(walk, o, d, seed_t, already)


@pytest.mark.parametrize("mode", ["all", "none", "mixed"])
def test_flat_any_hit_already(mode):
    """``already`` all set (no lane walks, every output 1), none set (every
    lane walks) and mixed at random, on bounce 0's shadow rays."""
    mesh, launches = _scan_launches()
    walk = _MeshWalk.build(mesh)
    (o, d, seed_t), (so, sun, scan_already) = launches[0]
    n = so.shape[0]
    already = {
        "all": torch.ones(n, dtype=torch.bool),
        "none": torch.zeros(n, dtype=torch.bool),
        "mixed": torch.as_tensor(np.random.default_rng(911).random(n) < 0.7),
    }[mode]
    for group in GROUPS:
        assert warp_schedule(already, group).numel() == int((~already).sum())
    _assert_flat_walks_agree(walk, so, sun, seed_t, already)
    if mode == "all":
        assert walk.occluded(so, already, None, directions=sun).all()


def test_warp_schedule_takes_each_walker_once():
    """The warp's numbering of its walkers (ballot, the n-th set bit), on
    every mask of a few bits and on random ones: each walking lane once, in
    lane order."""
    rng = np.random.default_rng(912)
    masks = [0, 1, 1 << 31, 0xFFFFFFFF, 0x80000001, 0x55555555] + list(
        rng.integers(0, 2**32, 64, dtype=np.uint64)
    )
    for mask in masks:
        mask = int(mask)
        lanes = [i for i in range(32) if mask >> i & 1]
        assert [nth_set_bit(mask, n) for n in range(len(lanes))] == lanes
    already = torch.as_tensor(rng.random(100) < 0.5)
    for group in GROUPS:
        assert warp_schedule(already, group).tolist() == (~already).nonzero()[:, 0].tolist()


@pytest.mark.parametrize(
    "rays,group",
    [(2_097_152, 1), (262_144, 1), (135_168, 1), (131_072, 2), (65_536, 4), (33_792, 4),
     (16_384, 8), (1, 8)],
)
def test_instance_group_policy(rays, group):
    """The nearest-hit instance kernel's group size on an H100's 270,336
    thread slots: G = 1 for a 512x512 scan sample (262,144 rays), G = 4 for
    a 256x256 one (65,536 rays); the smallest G whose rays x G reach half
    the slots. The any-hit's default is each warp's pick (G = 0)."""
    assert kernels.instance_group(rays, 132 * 2048) == group
    assert kernels.OCCLUDED_GROUP == 0


@pytest.mark.parametrize(
    "walking,group", [(32, 1), (17, 1), (16, 2), (9, 2), (8, 4), (5, 4), (4, 8), (1, 8)]
)
def test_warp_group_takes_the_batch_in_one_round(walking, group):
    """The any-hit kernel's pick for a warp's batch: one round of its 32 / G
    groups takes every walking ray, with the largest such G."""
    assert warp_group(walking) == group
    assert walking <= 32 // group and (group == 8 or walking > 32 // (2 * group))
