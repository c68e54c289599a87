"""Image output: frame-placeholder expansion + PNG/JPEG writing.

Own copy of the reference's ``render/image_io.py``.
The ``#####`` placeholder convention matches the reference's render script
(reference: scripts/render-timing-script.py:69-79): the run of ``#`` is
replaced by the zero-padded frame number.
"""

from __future__ import annotations

import os
import re
import tempfile
from pathlib import Path

import numpy as np

from tpu_render_cluster_torch.jobs.tiles import tile_rc

_HASH_RUN = re.compile(r"#+")

_FORMAT_EXTENSIONS = {
    "PNG": ".png",
    "JPEG": ".jpg",
    "JPG": ".jpg",
    "BMP": ".bmp",
    "TIFF": ".tif",
}


def format_frame_placeholders(name_format: str, frame_number: int) -> str:
    """Replace the run of '#' with the zero-padded frame number."""
    match = _HASH_RUN.search(name_format)
    if match is None:
        return f"{name_format}{frame_number}"
    width = match.end() - match.start()
    return (
        name_format[: match.start()]
        + str(frame_number).rjust(width, "0")
        + name_format[match.end():]
    )


def output_path_for_frame(
    output_directory: Path, name_format: str, file_format: str, frame_number: int
) -> Path:
    extension = _FORMAT_EXTENSIONS.get(file_format.upper(), ".png")
    return output_directory / (
        format_frame_placeholders(name_format, frame_number) + extension
    )


def output_path_for_tile(
    output_directory: Path,
    name_format: str,
    file_format: str,
    frame_number: int,
    tile: int,
    grid: tuple[int, int],
) -> Path:
    """Where one tile of a tiled frame lands: the frame's own output path
    with a ``.tile_r{row}c{col}`` infix, always ``.png``. Tiles are
    lossless whatever the job's format: a JPEG tile would be quantised
    twice, once here and once when the master encodes the stitched frame.
    The master's assembler finds the tiles by exactly this name."""
    frame_path = output_path_for_frame(output_directory, name_format, file_format, frame_number)
    row, col = tile_rc(tile, grid)
    return frame_path.with_name(f"{frame_path.stem}.tile_r{row}c{col}.png")


def write_image(path: Path, pixels: np.ndarray, file_format: str = "PNG") -> None:
    """Write a [H, W, 3] uint8 array; falls back to PNG for unknown formats.

    Atomic (write-temp-then-rename): a reader never sees a torn file.
    """
    from PIL import Image

    image_format = file_format.upper()
    if image_format == "JPG":
        image_format = "JPEG"
    if image_format not in _FORMAT_EXTENSIONS:
        image_format = "PNG"
    path.parent.mkdir(parents=True, exist_ok=True)
    image = Image.fromarray(np.asarray(pixels))
    fd, tmp_name = tempfile.mkstemp(
        prefix=f".{path.name}.", suffix=".tmp", dir=path.parent
    )
    try:
        with os.fdopen(fd, "wb") as f:
            if image_format == "JPEG":
                # reference script: quality=90
                image.save(f, image_format, quality=90)
            else:
                image.save(f, image_format)
        os.replace(tmp_name, path)
    except BaseException:
        try:
            os.unlink(tmp_name)
        except OSError:
            pass
        raise
