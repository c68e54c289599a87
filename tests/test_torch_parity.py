"""The helpers that hold the card's frame inputs to the CPU's
(``render/parity.py``, ``scene.on_device``, ``fp32.sqrt``), on the CPU. The
card's side is in tests/test_torch_bvh_cuda.py.

Exact throughout: these helpers compare and round bits.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tpu_render_cluster_torch.render import fp32, parity
from tpu_render_cluster_torch.render.camera import scene_camera, scene_camera_on
from tpu_render_cluster_torch.render.scene import (
    SCENE_NAMES,
    build_mesh_instances,
    build_scene,
    mesh_instances_on,
    on_device,
    scene_on,
)


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_frame_inputs_name_every_tensor(name):
    inputs = parity.frame_inputs(name, 3, "cpu", width=8, height=6, samples=2)
    mesh = name.endswith("-mesh")
    assert any(k.startswith("instances.") for k in inputs) == mesh
    assert inputs["flat_sample_rays.origins"].shape == (2 * 48, 3)
    assert inputs["sample_jitter_rays.directions"].shape == (48, 3)
    assert inputs["camera_rays.directions"].shape == (48, 3)
    again = parity.frame_inputs(name, 3, "cpu", width=8, height=6, samples=2)
    assert set(parity.differing_elements(inputs, again).values()) == {0}


def test_differing_elements_counts_bits():
    a = {"x": torch.tensor([0.0, 1.0, 2.0]), "n": torch.tensor([1, 2])}
    b = {"x": torch.tensor([-0.0, 1.0, float(np.nextafter(np.float32(2), np.float32(3)))]),
         "n": torch.tensor([1, 3])}
    assert parity.differing_elements(a, b) == {"x": 2, "n": 1}
    assert parity.differing_elements(a, {"x": torch.zeros(2), "n": b["n"]})["x"] == 3
    with pytest.raises(ValueError):
        parity.differing_elements(a, {"x": a["x"]})


def test_op_differences_sees_only_device_operations():
    """On the CPU nothing runs elsewhere: no operation to recheck."""
    assert parity.op_differences(scene_on, "03_physics-2-mesh", 3, "cpu") == {}


def test_builders_compute_on_the_host():
    """The public builders equal their arithmetic carried out on the CPU,
    bit for bit, and ``on_device`` leaves CPU tensors as they are."""
    name, frame = "03_physics-2-mesh", 11
    for public, on in (
        (build_scene(name, frame), scene_on(name, frame, "cpu")),
        (scene_camera(name, frame), scene_camera_on(name, frame, "cpu")),
        (build_mesh_instances(name, frame), mesh_instances_on(name, frame, "cpu")),
    ):
        assert set(parity.differing_elements(public._asdict(), on._asdict()).values()) == {0}
    scene = scene_on(name, frame, "cpu")
    assert on_device(scene, "cpu") is scene


def test_fp32_sqrt_is_correctly_rounded():
    rng = np.random.default_rng(0)
    values = np.concatenate([
        rng.random(200_000, dtype=np.float32) * 3,
        rng.integers(0, 0x7F800000, 200_000, dtype=np.int64).astype(np.int32).view(np.float32),
        np.array([0.0, 1.0, 4.0, 2.0, np.float32(1e-38)], np.float32),
    ])
    got = fp32.sqrt(torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(values).view(np.int32))
