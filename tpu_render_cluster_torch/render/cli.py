"""Standalone render CLI: render one frame of a scene to a file.

Usage:
  python -m tpu_render_cluster_torch.render.cli --scene 04_very-simple \
      --frame 1 --width 256 --height 256 --samples 4 --out frame.png

Sphere scenes and the mesh scenes (``02_physics-mesh``, and
``03_physics-2-mesh`` through the masked deep loop); ``--obj`` (user
meshes) is not ported yet. Runs on the GPU; ``--device cpu`` runs the plain PyTorch
versions on the CPU instead. Prints the same ``RESULTS=`` phase-timing line as the
reference CLI, which worker daemons parse.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="trc-render-torch")
    parser.add_argument("--scene", default="04_very-simple")
    parser.add_argument("--frame", type=int, default=1)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--height", type=int, default=512)
    parser.add_argument("--samples", type=int, default=8)
    parser.add_argument("--bounces", type=int, default=4)
    parser.add_argument("--out", required=True)
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu; without a GPU only an explicit cpu runs",
    )
    args = parser.parse_args(argv)

    from tpu_render_cluster_torch import resolve_device
    from tpu_render_cluster_torch.render.image_io import write_image
    from tpu_render_cluster_torch.render.integrator import render_frame, tonemap

    device = resolve_device(args.device)
    loaded_at = time.time()  # imports + device set-up = "project load"
    linear = render_frame(
        args.scene,
        args.frame,
        width=args.width,
        height=args.height,
        samples=args.samples,
        max_bounces=args.bounces,
        device=device,
    )
    pixels = tonemap(linear).cpu().numpy()  # waits for the device
    finished_rendering_at = time.time()
    path = Path(args.out)
    write_image(path, pixels, path.suffix.lstrip(".").upper() or "PNG")
    saved_at = time.time()
    print(
        f"Rendered {args.scene} frame {args.frame} "
        f"({args.width}x{args.height}, {args.samples} spp, {device}) "
        f"in {finished_rendering_at - loaded_at:.2f} s -> {path}"
    )
    # Phase-timing contract consumed by worker daemons (same shape as the
    # Blender timing script, scripts/render-timing-script.py, plus explicit
    # save timestamps since we know them exactly).
    print(
        "RESULTS="
        + json.dumps(
            {
                "project_loaded_at": loaded_at,
                "project_started_rendering_at": loaded_at,
                "project_finished_rendering_at": finished_rendering_at,
                "file_saving_started_at": finished_rendering_at,
                "file_saving_finished_at": saved_at,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
