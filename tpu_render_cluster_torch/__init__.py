"""PyTorch + CUDA port of the render farm's compute plane.

The JAX package ``tpu_render_cluster`` stays the reference; this package
holds its own copies of every module it needs and imports nothing of it.
It renders whole frames of the sphere scenes through the path-trace
megakernel (``render/csrc/trace_fused.cu``), of the mesh scenes whose mesh
fits the mesh megakernel (``render/csrc/trace_fused_mesh.cu``), and of the
deeper mesh scenes through the per-bounce mesh kernel
(``render/csrc/mesh_bounce.cu``), under the masked deep loop or the
wavefront driver (``render/compaction.py``, which also takes sphere scenes
through ``render/csrc/sphere_bounce.cu``). Several frames of one scene
render together in the device-resident ray pool (``render/raypool.py``)
through ``render/csrc/pool_mesh_bounce.cu`` and
``render/csrc/pool_sphere_bounce.cu``.

A worker process (``python -m tpu_render_cluster_torch.worker.main``)
serves these renders to an unmodified master over the reference's wire
protocol (``protocol/``, ``transport/``, ``worker/``).

Entry points run on the GPU. They take the CPU only when the caller asks
for it explicitly (``device="cpu"``), as the CPU tests do; without a GPU
and without that request they raise instead of continuing on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "1.0.0"

# The protocol version exchanged during the handshake: the reference's
# (``tpu_render_cluster/__init__.py``), which the master checks.
PROTOCOL_VERSION = __version__


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``cpu`` is asked for.

    ``None`` means the current CUDA device. A CUDA request without a usable
    GPU raises; the CPU is never chosen on the caller's behalf.
    """
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cpu":
        return resolved
    if resolved.type != "cuda":
        raise ValueError(f"Unsupported device {resolved}: use 'cuda' or 'cpu'.")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available. The port runs on the GPU; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU."
        )
    if resolved.index is None:
        resolved = torch.device("cuda", torch.cuda.current_device())
    return resolved


__all__ = ["PROTOCOL_VERSION", "resolve_device"]
