"""Procedural scenes as structure-of-arrays tensors.

Port of ``tpu_render_cluster/render/scene.py`` for every family: a ground
plane, a set of spheres padded with radius 0, a sun and a sky, each a
closed-form function of the frame index. The two mesh families
(``02_physics-mesh``, ``03_physics-2-mesh``) add rigid instances of one
shared mesh (``build_mesh_instances``; the BVH is in ``mesh.py``). The
arithmetic follows the reference expression by expression in float32, so
the arrays agree to rounding.

A frame's arrays are computed on the host whatever the render device, and
copied to the device in one transfer (``on_device``): on the card, PyTorch's
float32 sin, cos, log, pow and clamp, and its division by a Python number
(a multiplication by the reciprocal there), give other bits than on the CPU
for some inputs (``render/parity.py`` lists them), and the card must render
from the same scene as the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Scene(NamedTuple):
    """Structure-of-arrays scene with static shapes (pads with radius=0)."""

    centers: torch.Tensor  # [N, 3] float32
    radii: torch.Tensor  # [N] float32, 0 = unused slot
    albedo: torch.Tensor  # [N, 3] float32
    emission: torch.Tensor  # [N, 3] float32
    # Ground plane y=0 with a checkerboard albedo.
    plane_albedo_a: torch.Tensor  # [3]
    plane_albedo_b: torch.Tensor  # [3]
    # Sun (delta directional light).
    sun_direction: torch.Tensor  # [3], unit, points TOWARD the sun
    sun_color: torch.Tensor  # [3]
    # Sky gradient colors.
    sky_horizon: torch.Tensor  # [3]
    sky_zenith: torch.Tensor  # [3]


SCENE_NAMES = (
    "04_very-simple",
    "01_simple-animation",
    "02_physics-mesh",
    "02_physics",
    "03_physics-2-mesh",
    "03_physics-2",
)
MESH_SCENE_NAMES = ("02_physics-mesh", "03_physics-2-mesh")

_FPS = 24.0
_GRAVITY = 9.81
_F32 = torch.float32


def _vec(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=_F32, device=device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _default_lighting(device) -> dict:
    return dict(
        plane_albedo_a=_vec([0.85, 0.85, 0.85], device),
        plane_albedo_b=_vec([0.25, 0.3, 0.35], device),
        sun_direction=_normalize(_vec([0.4, 0.8, 0.3], device)),
        sun_color=_vec([2.7, 2.5, 2.2], device),
        sky_horizon=_vec([0.65, 0.75, 0.9], device),
        sky_zenith=_vec([0.15, 0.3, 0.6], device),
    )


def _pad_spheres(centers, radii, albedo, emission, size: int) -> tuple:
    n = centers.shape[0]
    if n > size:
        raise ValueError(f"Scene has {n} spheres, exceeds pad size {size}.")
    pad = size - n
    return (
        torch.nn.functional.pad(centers, (0, 0, 0, pad)),
        torch.nn.functional.pad(radii, (0, pad)),
        torch.nn.functional.pad(albedo, (0, 0, 0, pad)),
        torch.nn.functional.pad(emission, (0, 0, 0, pad)),
    )


def _grid_colors(n: int, device) -> torch.Tensor:
    """Deterministic pleasant albedos (golden-ratio hue walk)."""
    indices = torch.arange(n, dtype=_F32, device=device)
    hue = torch.remainder(indices * 0.61803398875, 1.0)
    # Cheap HSV->RGB with fixed s/v.
    h6 = hue * 6.0
    x = 1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0)
    zeros = torch.zeros_like(hue)
    ones = torch.ones_like(hue)
    sector = torch.remainder(torch.floor(h6).to(torch.int32), 6)

    def select(choices, default):  # jnp.select: the first true condition wins
        out = default
        for k in reversed(range(len(choices))):
            out = torch.where(sector == k, choices[k], out)
        return out

    r = select([ones, x, zeros, zeros, x], ones)
    g = select([x, ones, ones, x, zeros], zeros)
    b = select([zeros, zeros, x, ones, ones], x)
    rgb = torch.stack([r, g, b], dim=-1)
    return 0.25 + 0.65 * rgb


def _very_simple(frame, device, n_spheres: int = 64, pad: int = 64):
    """Static sphere grid (the 04_very-simple workhorse scene)."""
    del frame  # static
    side = int(np.ceil(np.sqrt(n_spheres)))
    index = torch.arange(n_spheres, device=device)
    gx = (index % side).to(_F32) - (side - 1) / 2.0
    gz = torch.div(index, side, rounding_mode="floor").to(_F32) - (side - 1) / 2.0
    radius = torch.full((n_spheres,), 0.45, dtype=_F32, device=device)
    centers = torch.stack([gx * 1.2, radius, gz * 1.2], dim=-1)
    albedo = _grid_colors(n_spheres, device)
    emission = torch.zeros((n_spheres, 3), dtype=_F32, device=device)
    # One emissive sphere so indirect light is visible.
    emission[0] = _vec([4.0, 3.6, 3.0], device)
    return _pad_spheres(centers, radius, albedo, emission, pad)


def _simple_animation(frame, device, n_spheres: int = 24, pad: int = 32):
    """Spheres orbiting a center column, phase-shifted per sphere."""
    t = frame / _FPS
    index = torch.arange(n_spheres, dtype=_F32, device=device)
    phase = index * (2.0 * math.pi / n_spheres)
    ring = 1.0 + torch.remainder(index, 3.0)
    angle = phase + t * (0.8 + 0.15 * torch.remainder(index, 3.0))
    y = 0.5 + 0.3 * torch.sin(t * 2.0 + phase * 2.0) + 0.35 * torch.remainder(index, 3.0)
    centers = torch.stack(
        [ring * 1.4 * torch.cos(angle), y, ring * 1.4 * torch.sin(angle)], dim=-1
    )
    radii = torch.full((n_spheres,), 0.35, dtype=_F32, device=device)
    albedo = _grid_colors(n_spheres, device)
    emission = torch.zeros((n_spheres, 3), dtype=_F32, device=device)
    emission[0] = _vec([5.0, 4.5, 3.5], device)
    return _pad_spheres(centers, radii, albedo, emission, pad)


def _physics(frame, device, n_spheres: int, pad: int, *, chaos: float):
    """Falling-and-bouncing spheres with closed-form ballistic motion."""
    t = frame / _FPS
    index = torch.arange(n_spheres, dtype=_F32, device=device)
    # Deterministic pseudo-random spread from the index.
    u1 = torch.remainder(index * 0.7548776662, 1.0)
    u2 = torch.remainder(index * 0.5698402909, 1.0)
    u3 = torch.remainder(index * 0.3819660113, 1.0)
    radius = 0.25 + 0.15 * u3
    x = (u1 - 0.5) * 8.0 + chaos * 0.5 * torch.sin(12.0 * u2)
    z = (u2 - 0.5) * 8.0 + chaos * 0.5 * torch.cos(12.0 * u1)
    h0 = 3.0 + 5.0 * u3  # drop height
    drop_delay = u1 * 2.0 * chaos
    tau = torch.clamp_min(t - drop_delay, 0.0)

    y = _ballistic_height(tau, h0) + radius
    centers = torch.stack([x, y, z], dim=-1)
    albedo = _grid_colors(n_spheres, device)
    emission = torch.zeros((n_spheres, 3), dtype=_F32, device=device)
    return _pad_spheres(centers, radius, albedo, emission, pad)


def _ballistic_height(t, h0, *, restitution: float = 0.7):
    """Closed-form bounce height at time t for a drop from h0 (see _physics)."""
    e = restitution
    log_e = torch.log(torch.tensor(e, dtype=_F32, device=t.device))
    v0 = torch.sqrt(2.0 * _GRAVITY * h0)
    t_fall = torch.sqrt(2.0 * h0 / _GRAVITY)
    in_fall = t < t_fall
    fall_y = h0 - 0.5 * _GRAVITY * t**2
    s = t - t_fall
    denom = 2.0 * v0 / (_GRAVITY * (1.0 - e))
    ratio = torch.clamp(1.0 - s / denom, 1e-6, 1.0)
    k = torch.clamp(torch.floor(torch.log(ratio) / log_e), 0.0, 40.0)
    elapsed = denom * (1.0 - e**k)
    local = s - elapsed
    vk = v0 * e**k
    bounce_y = torch.clamp_min(vk * local - 0.5 * _GRAVITY * local**2, 0.0)
    settled = vk < 0.15
    return torch.where(in_fall, fall_y, torch.where(settled, 0.0, bounce_y))


def _frame_tensor(frame, device) -> torch.Tensor:
    return torch.as_tensor(frame, dtype=_F32, device=device)


def on_device(fields: tuple, device: str | torch.device) -> tuple:
    """A NamedTuple of float32 host tensors on ``device``, in one copy: the
    tensors are packed into one pinned buffer, each from a 16-byte boundary
    (the kernels read tables as float4), copied without making the host
    wait, and split into views of the copy. The values stay the host's bit
    for bit."""
    device = torch.device(device)
    if device.type == "cpu":
        return fields
    parts, starts, start = [], [], 0
    for tensor in fields:
        if tensor.dtype != _F32:
            raise TypeError(f"on_device packs float32 tensors, got {tensor.dtype}")
        pad = -tensor.numel() % 4
        parts += [tensor.reshape(-1), torch.zeros(pad, dtype=_F32)]
        starts.append(start)
        start += tensor.numel() + pad
    copy = torch.cat(parts).pin_memory().to(device, non_blocking=True)
    return type(fields)(*(
        copy[at:at + tensor.numel()].view(tensor.shape) for at, tensor in zip(starts, fields)
    ))


def build_scene(name: str, frame, device: str | torch.device = "cpu") -> Scene:
    """Build the scene tensors for one frame on ``device`` (computed on the
    host, see ``on_device``)."""
    return on_device(scene_on(name, frame, "cpu"), device)


def scene_on(name: str, frame, device: str | torch.device) -> Scene:
    """``build_scene``'s arithmetic carried out on ``device`` itself."""
    frame = _frame_tensor(frame, device)
    if name == "04_very-simple":
        spheres = _very_simple(frame, device)
    elif name == "01_simple-animation":
        spheres = _simple_animation(frame, device)
    elif name == "02_physics":
        spheres = _physics(frame, device, 48, 64, chaos=0.0)
    elif name == "02_physics-mesh":
        # A handful of spheres accompany the boxes of build_mesh_instances.
        spheres = _physics(frame, device, 12, 16, chaos=0.0)
    elif name == "03_physics-2":
        spheres = _physics(frame, device, 96, 128, chaos=1.0)
    elif name == "03_physics-2-mesh":
        spheres = _physics(frame, device, 16, 16, chaos=1.0)
    else:
        raise ValueError(f"Unknown scene: {name!r} (have {SCENE_NAMES})")
    centers, radii, albedo, emission = spheres
    return Scene(centers, radii, albedo, emission, **_default_lighting(device))


def mesh_kind_for_scene(name: str) -> str | None:
    """Which cached object-space BVH a mesh scene uses (None = no mesh)."""
    if name == "02_physics-mesh":
        return "box"
    if name == "03_physics-2-mesh":
        return "icosphere"
    return None


def build_mesh_instances(name: str, frame, device: str | torch.device = "cpu"):
    """The mesh instances of a mesh scene's frame, else ``None``.

    02_physics-mesh: 24 tumbling boxes dropped ballistically;
    03_physics-2-mesh: 48 smaller icospheres with a chaotic spread. Only
    the rigid transforms depend on the frame. Computed on the host, see
    ``on_device``.
    """
    if name not in MESH_SCENE_NAMES:
        return None
    return on_device(mesh_instances_on(name, frame, "cpu"), device)


def mesh_instances_on(name: str, frame, device: str | torch.device):
    """``build_mesh_instances``' arithmetic carried out on ``device``
    itself (a mesh scene only)."""
    from tpu_render_cluster_torch.render.mesh import MeshInstances, rotation_y

    t = _frame_tensor(frame, device) / _FPS
    k = 48 if name == "03_physics-2-mesh" else 24
    index = torch.arange(k, dtype=_F32, device=device)
    u1 = torch.remainder(index * 0.7548776662, 1.0)
    u2 = torch.remainder(index * 0.5698402909, 1.0)
    u3 = torch.remainder(index * 0.3819660113, 1.0)
    if name == "03_physics-2-mesh":
        size = 0.45 + 0.35 * u3
        x = (u1 - 0.5) * 9.0 + 0.5 * torch.sin(12.0 * u2)
        z = (u2 - 0.5) * 9.0 + 0.5 * torch.cos(12.0 * u1)
        h0 = 2.0 + 5.0 * u3
        tau = torch.clamp_min(t - u1 * 2.0, 0.0)
    else:
        size = 0.6 + 0.5 * u3
        x = (u1 - 0.5) * 7.0
        z = (u2 - 0.5) * 7.0
        h0 = 2.5 + 4.0 * u3
        tau = torch.clamp_min(t - u1 * 1.5, 0.0)
    y = _ballistic_height(tau, h0) + size * 0.5
    rotation = rotation_y(tau * (0.6 + 2.0 * u2) + u1 * 6.28)
    return MeshInstances(
        rotation=rotation,
        translation=torch.stack([x, y, z], dim=-1),
        albedo=_grid_colors(k, device),
        scale=size,
    )


def scene_from_arrays(arrays: dict[str, np.ndarray], device) -> Scene:
    """A ``Scene`` from named arrays, e.g. a reference scene's fields as
    numpy (``{k: np.asarray(v) for k, v in scene._asdict().items()}``)."""
    return Scene(
        **{
            field: torch.as_tensor(np.array(arrays[field], dtype=np.float32), device=device)
            for field in Scene._fields
        }
    )


def scene_for_job_name(job_name: str) -> str:
    """Map a job name to a scene family.

    Covers the reference TOML convention ("01-simple-animation_...",
    "04_very-simple_...") and the generated grid labels ("01sa_...",
    "02ph_...", "03ph2_...", "04vs_..."): the two-digit project number
    prefix is unique across families.
    """
    # Exact family-name prefixes first, longest first, so
    # "02_physics-mesh_x" doesn't fall through to "02_physics".
    for name in sorted(SCENE_NAMES, key=len, reverse=True):
        if job_name.startswith(name):
            return name
    # Two-digit project prefixes map to the classic (non-mesh) families.
    for name in SCENE_NAMES:
        if name.endswith("-mesh"):
            continue
        if job_name.startswith(name.split("_", 1)[0]):
            return name
    return "04_very-simple"
