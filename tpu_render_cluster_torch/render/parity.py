"""The card against the host: a frame's inputs, and the operations that differ.

``frame_inputs`` gathers what a frame's render starts from: the scene, the
camera, the mesh instances and the primary rays of each ray builder
(``camera_rays``, ``flat_sample_rays``, ``sample_jitter_rays``). Called for
the card and for the CPU, ``differing_elements`` counts, tensor by tensor,
the elements whose bits differ; the renderers need 0 everywhere.

``op_differences`` runs a function on one device and repeats each torch
operation it makes on the CPU, from the same inputs copied there, counting
the elements each operation gives differently: the operations that differ
by themselves, whatever their inputs did.

Run on a machine with a CUDA GPU, ``python -m
tpu_render_cluster_torch.render.parity`` prints, for every scene family,
the operations of the scene, camera and instance arithmetic that differ
when carried out on the card (the renderers carry it out on the host and
copy the result), and those of the ray builders on the card.
"""

from __future__ import annotations

import sys

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map

from tpu_render_cluster_torch.render import integrator, rng
from tpu_render_cluster_torch.render.camera import camera_rays, scene_camera, scene_camera_on
from tpu_render_cluster_torch.render.scene import (
    SCENE_NAMES,
    build_mesh_instances,
    build_scene,
    mesh_instances_on,
    scene_on,
)


def frame_inputs(scene_name: str, frame: int, device, *, width: int, height: int,
                 samples: int) -> dict[str, torch.Tensor]:
    """The named tensors a frame's render starts from, on ``device``: the
    scene, camera and instance fields, and the rays of the three ray
    builders at ``width`` x ``height`` (``samples`` for the flattened one;
    the per-sample one's sample 0)."""
    device = torch.device(device)
    out = {f"scene.{k}": v for k, v in build_scene(scene_name, frame, device)._asdict().items()}
    camera = scene_camera(scene_name, frame, device)
    out.update({f"camera.{k}": v for k, v in camera._asdict().items()})
    instances = build_mesh_instances(scene_name, frame, device)
    if instances is not None:
        out.update({f"instances.{k}": v for k, v in instances._asdict().items()})
    out["camera_rays.origins"], out["camera_rays.directions"] = camera_rays(camera, width, height)
    origins, directions, seed = integrator.frame_rays_and_seed(
        camera, frame, width=width, height=height, samples=samples
    )
    out["flat_sample_rays.origins"], out["flat_sample_rays.directions"] = origins, directions
    out["trace_seed"] = torch.tensor(seed)
    key = rng.fold_in(integrator.tile_base_key(frame, 0, 0), 0).to(device)
    out["sample_jitter_rays.origins"], out["sample_jitter_rays.directions"] = (
        integrator.sample_jitter_rays(
            camera, key, width=width, height=height, y0=0, x0=0, tile_height=height,
            tile_width=width,
        )
    )
    return out


def _bits(tensor: torch.Tensor) -> torch.Tensor:
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.float32:
        return tensor.contiguous().view(torch.int32)
    return tensor


def differing_elements(got: dict[str, torch.Tensor], expected: dict[str, torch.Tensor]) -> dict[str, int]:
    """Per name, the elements whose bits differ (a tensor of another shape
    or type counts every element)."""
    if got.keys() != expected.keys():
        raise ValueError(f"different tensors: {sorted(got.keys() ^ expected.keys())}")
    counts = {}
    for name, tensor in got.items():
        a, b = _bits(tensor), _bits(expected[name])
        counts[name] = int((a != b).sum()) if a.shape == b.shape and a.dtype == b.dtype else a.numel()
    return counts


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, torch.device) and value.type != "cpu":
        return torch.device("cpu")
    if isinstance(value, str) and value.startswith("cuda"):
        return "cpu"
    return value


class _HostRecheck(TorchFunctionMode):
    """Each torch operation again on the CPU, its results compared."""

    def __init__(self) -> None:
        super().__init__()
        self.found: dict[str, dict[str, int]] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        host_args, host_kwargs = tree_map(_to_host, (args, kwargs))
        out = func(*args, **kwargs)
        host_out = func(*host_args, **host_kwargs)
        name = getattr(func, "__qualname__", None) or getattr(func, "__name__", repr(func))
        in_place = name.endswith("_") and not name.endswith("__")
        if in_place or name.endswith("__setitem__"):  # compare the first argument
            out, host_out = args[0], host_args[0]
        pairs = [
            (a, b) for a, b in zip(*(t if isinstance(t, (tuple, list)) else (t,) for t in (out, host_out)))
            if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.device.type != "cpu"
        ]
        differ = sum(
            int((_bits(a) != _bits(b)).sum()) if a.shape == b.shape else a.numel() for a, b in pairs
        )
        if pairs:
            entry = self.found.setdefault(name, {"calls": 0, "differing_calls": 0, "elements": 0})
            entry["calls"] += 1
            entry["differing_calls"] += int(differ > 0)
            entry["elements"] += differ
        return out


def op_differences(fn, *args, **kwargs) -> dict[str, dict[str, int]]:
    """Run ``fn`` and repeat each torch operation it makes on the CPU:
    per operation (by name) its calls on a non-CPU device, the calls whose
    results differ from the CPU's on the same inputs, and the elements
    that differ."""
    with _HostRecheck() as mode:
        fn(*args, **kwargs)
    return mode.found


def main() -> int:
    if not torch.cuda.is_available():
        print("parity: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    builders = {"scene": scene_on, "camera": scene_camera_on, "instances": mesh_instances_on}
    for scene_name in SCENE_NAMES:
        for frame in (1, 7, 30, 77, 240):
            for label, build in builders.items():
                if label == "instances" and not scene_name.endswith("-mesh"):
                    continue
                found = op_differences(build, scene_name, frame, device)
                fields = differing_elements(
                    build(scene_name, frame, device)._asdict(),
                    build(scene_name, frame, "cpu")._asdict(),
                )
                print(
                    f"{scene_name} frame {frame}, {label} computed on the card: "
                    f"{sum(v['calls'] for v in found.values())} operations; differing "
                    f"{ {k: v for k, v in found.items() if v['elements']} or 'none'}; fields "
                    f"differing {({k: v for k, v in fields.items() if v}) or 'none'}"
                )
            found = op_differences(
                integrator.frame_rays_and_seed, scene_camera(scene_name, frame, device), frame,
                width=64, height=48, samples=2,
            )
            print(
                f"{scene_name} frame {frame}, rays on the card from the host's camera: "
                f"{sum(v['calls'] for v in found.values())} operations; differing "
                f"{ {k: v for k, v in found.items() if v['elements']} or 'none'}"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
