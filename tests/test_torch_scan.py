"""The per-bounce scan renderer (``bounce_scan=True``) against the JAX
package's own CPU renderer: its XLA bounce scan, with ``TRC_PALLAS`` unset.

The reference's ``trace_paths`` is compiled with ``jax.jit``, as its
``render_tile`` compiles it, and run on the same rays and threefry key as
the port's ``trace_paths_scan``. The port's four geometry queries run
through the unit kernels' plain versions here (CPU tensors); the CUDA
kernels are held against those on a GPU by tests/test_torch_kernels_cuda.py.

Tolerances:
- ``trace_paths``: rtol = atol = 1e-4 per ray over its three channels, on
  every ray but an edge-tie budget of max(1, round(0.001 R)) (a ray on a
  checker-cell edge or a shared triangle edge may take either side; see
  ROADMAP.md, queue 3), at 1 and 4 bounces;
- whole frames (``render_frame`` and PNGs served through
  ``harness.local.run_local_job``): at least 99.5% of uint8 channel values
  within 1, as tests/test_torch_frame.py.
"""

from __future__ import annotations

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_backend import _job
from tests.test_torch_mesh import reference_mesh_arrays
from tpu_render_cluster.harness.local import run_local_job
from tpu_render_cluster.jobs.models import DistributionStrategy
from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster.render import mesh as ref_mesh
from tpu_render_cluster.render import scene as ref_scene
from tpu_render_cluster_torch.jobs.models import BlenderJob as PortJob
from tpu_render_cluster_torch.render import integrator, kernels
from tpu_render_cluster_torch.render import mesh as port_mesh
from tpu_render_cluster_torch.render import scene as port_scene
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

FRAME, SIDE = 30, 24


@pytest.fixture
def xla_reference(monkeypatch):
    """The reference with Pallas off: its XLA scan on the CPU. The switch
    is read when a function is traced, so compiled programs are dropped
    before and after."""
    from tpu_render_cluster.render.integrator import fused_frame_renderer

    monkeypatch.delenv("TRC_PALLAS", raising=False)
    jax.clear_caches()
    fused_frame_renderer.cache_clear()
    yield
    jax.clear_caches()
    fused_frame_renderer.cache_clear()


def _key_words(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _inputs(name: str):
    """(reference scene, reference mesh set, port scene, port mesh, one
    sample's jittered rays and its trace key) of frame 30."""
    scene = ref_scene.build_scene(name, FRAME)
    mesh_set = ref_mesh.scene_mesh_set(name, FRAME, "sah", 4)
    key = jax.random.fold_in(ref_integrator.tile_base_key(jnp.float32(FRAME), 0, 0), 1)
    origins, directions = ref_integrator.sample_jitter_rays(
        ref_camera.scene_camera(name, FRAME), key, width=SIDE, height=SIDE, y0=0, x0=0,
        tile_height=SIDE, tile_width=SIDE,
    )
    port = port_scene.scene_from_arrays({k: np.asarray(v) for k, v in scene._asdict().items()}, "cpu")
    port_set = (
        None if mesh_set is None
        else port_mesh.mesh_from_arrays(*reference_mesh_arrays(mesh_set), "cpu")
    )
    return scene, mesh_set, port, port_set, np.array(origins), np.array(directions), jax.random.split(key)[1]


def _scan_counts(calls: int, mesh: bool) -> dict[str, int]:
    """``kernels.counts`` after ``calls`` calls of each plain geometry query
    of the scan (the instance queries on a mesh scene only) and nothing
    else."""
    queries = ("intersect_spheres", "occluded_spheres")
    if mesh:
        queries += ("intersect_instances", "occluded_instances")
    return {k: calls * (k.removesuffix("_reference") in queries and k.endswith("_reference"))
            for k in kernels.counts}


@pytest.mark.parametrize("max_bounces", [1, 4])
@pytest.mark.parametrize("name", ["04_very-simple", "03_physics-2-mesh"])
def test_scan_trace_paths_matches_reference(xla_reference, name, max_bounces):
    scene, mesh_set, port, port_set, origins, directions, key = _inputs(name)
    trace = jax.jit(
        lambda s, o, d, k, m: ref_integrator.trace_paths(s, o, d, k, max_bounces=max_bounces, mesh=m)
    )
    expected = np.asarray(trace(scene, origins, directions, key, mesh_set))
    kernels.reset_counts()
    got = integrator.trace_paths_scan(
        port, torch.from_numpy(origins), torch.from_numpy(directions), _key_words(key),
        max_bounces=max_bounces, mesh=port_set,
    ).numpy()
    # One call of each geometry query per bounce, the plain versions, and
    # none of the path-trace kernels.
    assert kernels.counts == _scan_counts(max_bounces, mesh=mesh_set is not None)
    assert got.shape == expected.shape and np.isfinite(got).all()
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    assert (~close).sum() <= max(1, round(0.001 * close.size)), np.flatnonzero(~close)
    assert got.max() > 0.1


def test_cosine_sample_hemisphere_matches_reference():
    """The resample's threefry uniforms are the reference's bit for bit; the
    directions within 1e-6."""
    rng = np.random.default_rng(4)
    normals = rng.normal(size=(777, 3))
    normals[:100, 0] = 5.0  # |n_x| > 0.9: the other helper axis
    normals = (normals / np.linalg.norm(normals, axis=1, keepdims=True)).astype(np.float32)
    key = jax.random.PRNGKey(99)
    expected = np.asarray(jax.jit(ref_integrator._cosine_sample_hemisphere)(normals, key))
    got = integrator._cosine_sample_hemisphere(torch.from_numpy(normals), _key_words(key)).numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-6)
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert ((got * normals).sum(axis=1) >= -1e-6).all()


def _match(got: np.ndarray, expected: np.ndarray) -> float:
    assert got.shape == expected.shape and got.dtype == np.uint8 == expected.dtype
    return float((np.abs(got.astype(np.int32) - expected.astype(np.int32)) <= 1).mean())


@pytest.mark.parametrize("name", ["04_very-simple", "03_physics-2-mesh"])
def test_scan_frame_matches_reference_cpu_render(xla_reference, name):
    side, samples = 16, 2
    expected = np.asarray(
        ref_integrator.tonemap(
            ref_integrator.render_frame(name, 3, width=side, height=side, samples=samples)
        )
    )
    kernels.reset_counts()
    linear = integrator.render_frame(
        name, 3, width=side, height=side, samples=samples, device="cpu", bounce_scan=True
    )
    assert kernels.counts == _scan_counts(samples * 4, mesh=name.endswith("-mesh"))
    got = integrator.tonemap(linear).numpy()
    assert _match(got, expected) >= 0.995
    assert got.std() > 5.0


def test_frame_renderer_caches_the_scan_apart():
    scan = integrator.fused_frame_renderer("04_very-simple", 8, 8, 1, 1, "cpu", bounce_scan=True)
    again = integrator.fused_frame_renderer("04_very-simple", 8, 8, 1, 1, "cpu", bounce_scan=True)
    default = integrator.fused_frame_renderer("04_very-simple", 8, 8, 1, 1, "cpu")
    assert scan is again and scan is not default
    kernels.reset_counts()
    scan(1)
    assert kernels.counts == _scan_counts(1, mesh=False)


@pytest.mark.parametrize("options", [{}, {"wavefront": "force"}, {"raypool": "force"}])
def test_backend_bounce_scan_takes_neither_wavefront_nor_pool(tmp_path, options):
    """As the reference without Pallas: neither tier, whatever its option."""
    backend = TorchRaytraceBackend(
        device="cpu", width=8, height=8, samples=1, max_bounces=2, base_directory=tmp_path,
        bounce_scan=True, **options,
    )
    job = PortJob.from_dict(_job(DistributionStrategy.eager_naive_coarse(1), frames=3).to_dict())
    backend.note_upcoming_frames(job, (2, 3))
    kernels.reset_counts()
    asyncio.run(backend.render_frame(job, 1))
    assert kernels.counts == _scan_counts(2, mesh=False)
    assert not backend.pool_stats


def test_two_scan_workers_serve_a_job_like_the_reference(tmp_path, xla_reference):
    """Two port workers on the scan tier through the JAX package's harness;
    each PNG against the JAX renderer's own CPU render of the frame."""
    from tpu_render_cluster.render.integrator import fused_frame_renderer

    width, height, samples, bounces = 24, 16, 2, 4
    job = _job(DistributionStrategy.eager_naive_coarse(2), frames=3)
    backends = [
        TorchRaytraceBackend(
            device="cpu", width=width, height=height, samples=samples, max_bounces=bounces,
            base_directory=tmp_path, bounce_scan=True,
        )
        for _ in range(2)
    ]
    _master_trace, worker_traces = run_local_job(job, backends, timeout=300.0)
    rendered = [t for _name, trace in worker_traces for t in trace.frame_render_traces]
    assert sorted(t.frame_index for t in rendered) == [1, 2, 3]
    render = fused_frame_renderer("04_very-simple", width, height, samples, bounces)
    for frame in (1, 2, 3):
        image = np.asarray(Image.open(tmp_path / "frames" / f"rendered-{frame:05d}.png"))
        assert _match(image, np.asarray(render(frame))) >= 0.995
