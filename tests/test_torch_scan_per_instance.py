"""The per-bounce scan renderer with its per-instance mesh queries
(``bounce_scan=True, per_instance=True``) against the JAX package's own CPU
renderer: its XLA bounce scan with ``TRC_PALLAS`` unset, whose mesh queries
are exactly that scan over the instances.

As tests/test_torch_scan.py: the reference's ``trace_paths`` compiled with
``jax.jit`` on the same rays and threefry key as the port's
``trace_paths_scan``; whole frames against its CPU ``render_frame``; port
workers through ``harness.local.run_local_job``. The port's walks run
through their plain versions here (CPU tensors).

Tolerances, those of tests/test_torch_scan.py: per ray rtol = atol = 1e-4
over the three channels on every ray but an edge-tie budget of max(1,
round(0.001 R)), at 1 and 4 bounces; whole frames at least 99.5% of uint8
channel values within 1.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_backend import _job
from tests.test_torch_scan import _inputs, _key_words, _match, xla_reference  # noqa: F401
from tpu_render_cluster.harness.local import run_local_job
from tpu_render_cluster.jobs.models import DistributionStrategy
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster_torch.render import integrator, kernels
from tpu_render_cluster_torch.worker.backends.torch_raytrace import TorchRaytraceBackend

NAME = "03_physics-2-mesh"


def _walk_counts(steps: int, instances: int = 48) -> dict[str, int]:
    """``kernels.counts`` after ``steps`` sample-bounces of the per-instance
    scan on the CPU: one plain single-BVH walk of each kind per instance,
    one plain sphere query of each kind, nothing else."""
    per_step = {
        "intersect_mesh_reference": instances, "occluded_mesh_reference": instances,
        "intersect_spheres_reference": 1, "occluded_spheres_reference": 1,
    }
    return {k: steps * per_step.get(k, 0) for k in kernels.counts}


@pytest.mark.parametrize("max_bounces", [1, 4])
def test_per_instance_scan_matches_reference(xla_reference, max_bounces):  # noqa: F811
    import jax

    scene, mesh_set, port, port_set, origins, directions, key = _inputs(NAME)
    trace = jax.jit(
        lambda s, o, d, k, m: ref_integrator.trace_paths(s, o, d, k, max_bounces=max_bounces, mesh=m)
    )
    expected = np.asarray(trace(scene, origins, directions, key, mesh_set))
    kernels.reset_counts()
    got = integrator.trace_paths_scan(
        port, torch.from_numpy(origins), torch.from_numpy(directions), _key_words(key),
        max_bounces=max_bounces, mesh=port_set, per_instance=True,
    ).numpy()
    assert kernels.counts == _walk_counts(max_bounces)
    assert got.shape == expected.shape and np.isfinite(got).all()
    close = np.isclose(got, expected, rtol=1e-4, atol=1e-4).all(axis=1)
    assert (~close).sum() <= max(1, round(0.001 * close.size)), np.flatnonzero(~close)
    assert got.max() > 0.1


def test_per_instance_frame_matches_reference_cpu_render(xla_reference):  # noqa: F811
    side, samples = 24, 2
    expected = np.asarray(
        ref_integrator.tonemap(
            ref_integrator.render_frame(NAME, 3, width=side, height=side, samples=samples)
        )
    )
    kernels.reset_counts()
    linear = integrator.render_frame(
        NAME, 3, width=side, height=side, samples=samples, device="cpu", bounce_scan=True,
        per_instance=True,
    )
    assert kernels.counts == _walk_counts(samples * 4)
    got = integrator.tonemap(linear).numpy()
    assert _match(got, expected) >= 0.995
    assert got.std() > 5.0


def test_per_instance_worker_serves_a_deep_job_like_the_reference(tmp_path, xla_reference):  # noqa: F811
    """A port worker on the per-instance scan serves a 2-frame deep-mesh
    job through the JAX package's harness; each PNG against the JAX
    renderer's own CPU render of the frame."""
    from tpu_render_cluster.render.integrator import fused_frame_renderer

    width, height, samples, bounces = 16, 12, 1, 2
    job = _job(DistributionStrategy.eager_naive_coarse(1), frames=2, workers=1,
               name="03_physics-2-mesh_torch-port")
    backend = TorchRaytraceBackend(
        device="cpu", width=width, height=height, samples=samples, max_bounces=bounces,
        base_directory=tmp_path, bounce_scan=True, per_instance=True,
    )
    kernels.reset_counts()
    _master_trace, worker_traces = run_local_job(job, [backend], timeout=300.0)
    rendered = [t for _name, trace in worker_traces for t in trace.frame_render_traces]
    assert sorted(t.frame_index for t in rendered) == [1, 2]
    assert kernels.counts["intersect_mesh_reference"] >= 2 * samples * bounces * 48
    assert kernels.counts["intersect_instances_reference"] == 0
    render = fused_frame_renderer(NAME, width, height, samples, bounces)
    for frame in (1, 2):
        image = np.asarray(Image.open(tmp_path / "frames" / f"rendered-{frame:05d}.png"))
        assert _match(image, np.asarray(render(frame))) >= 0.995
