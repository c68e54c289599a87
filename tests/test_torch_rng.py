"""The port's threefry twin against ``jax.random`` (bit for bit), and the
frame's primary rays + trace seed against the reference integrator.

Tolerances: keys, bits and uniforms must be identical (the twin is
integer arithmetic plus an exact bit-cast). Rays are float32 arithmetic
that the reference evaluates through XLA's fused ops; they must agree
within 1e-6 (a few float32 ulps at unit scale).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_render_cluster.render import camera as ref_camera
from tpu_render_cluster.render import integrator as ref_integrator
from tpu_render_cluster_torch.render import camera as port_camera
from tpu_render_cluster_torch.render import integrator as port_integrator
from tpu_render_cluster_torch.render import rng


def _words(key: torch.Tensor) -> np.ndarray:
    return key.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 917, 2**31 - 1, -5])
def test_prng_key_bit_exact(seed):
    np.testing.assert_array_equal(_words(rng.PRNGKey(seed)), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [-1, 0, 7, 2**30])
def test_fold_in_bit_exact(data):
    key = jax.random.PRNGKey(917)
    expected = np.asarray(jax.random.fold_in(key, jnp.int32(data)))
    np.testing.assert_array_equal(_words(rng.fold_in(rng.PRNGKey(917), data)), expected)


def test_fold_in_batched_matches_vmap():
    key = jax.random.fold_in(jax.random.PRNGKey(917), 3)
    expected = np.asarray(jax.vmap(lambda s: jax.random.fold_in(key, s))(jnp.arange(5)))
    port_key = rng.fold_in(rng.PRNGKey(917), 3)
    np.testing.assert_array_equal(_words(rng.fold_in(port_key, torch.arange(5))), expected)


@pytest.mark.parametrize("num", [2, 5])
def test_split_bit_exact(num):
    key = jax.random.fold_in(jax.random.PRNGKey(917), 11)
    expected = np.asarray(jax.random.split(key, num))
    got = rng.split(rng.fold_in(rng.PRNGKey(917), 11), num)
    np.testing.assert_array_equal(_words(got), expected)


@pytest.mark.parametrize("shape", [(1,), (37, 2), (1000, 2), (3, 5, 7)])
def test_uniform_bit_exact(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(917), jnp.int32(-1))
    expected = np.asarray(jax.random.uniform(key, shape))
    got = rng.uniform(rng.fold_in(rng.PRNGKey(917), -1), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, expected)


def test_uniform_batched_keys_match_vmap():
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(917), s))(jnp.arange(3))
    expected = np.asarray(
        jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (11, 2)))(keys)
    )
    port_keys = rng.fold_in(rng.PRNGKey(917), torch.arange(3))
    got = rng.uniform(rng.split(port_keys)[..., 0, :], (11, 2)).numpy()
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("frame", [0, 1, 240])
def test_key_schedule_and_trace_seed(frame):
    ref_key = ref_integrator.tile_base_key(jnp.float32(frame), 0, 0)
    port_key = port_integrator.tile_base_key(frame, 0, 0)
    np.testing.assert_array_equal(_words(port_key), np.asarray(jax.random.key_data(ref_key)))
    ref_seed = int(ref_integrator.trace_seed(ref_integrator.tile_trace_key(ref_key)))
    assert port_integrator.trace_seed(port_integrator.tile_trace_key(port_key)) == ref_seed


@pytest.mark.parametrize("frame", [1, 7, 240])
def test_frame_rays_and_seed_match_reference(frame):
    width, height, samples = 16, 12, 3
    camera = ref_camera.scene_camera("01_simple-animation", frame)
    origins, directions, seed = ref_integrator.frame_rays_and_seed(
        camera, jnp.float32(frame), width=width, height=height, samples=samples
    )
    port_cam = port_camera.camera_from_arrays(
        {k: np.asarray(v) for k, v in camera._asdict().items()}, "cpu"
    )
    port_o, port_d, port_seed = port_integrator.frame_rays_and_seed(
        port_cam, frame, width=width, height=height, samples=samples
    )
    assert port_seed == int(seed)
    assert port_o.shape == (samples * width * height, 3)
    np.testing.assert_allclose(port_o.numpy(), np.asarray(origins), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_d.numpy(), np.asarray(directions), rtol=0, atol=1e-6)
