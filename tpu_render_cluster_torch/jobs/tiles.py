"""The sub-frame work unit: ``(frame_index, tile)``.

The port's own copy of the reference's ``jobs/tiles.py``: the unit key and
the tile geometry that the master, the worker queue and the renderer's
region paths all normalise through.

Conventions:

- ``tile is None`` means the whole frame, the pre-tiling work unit.
- A tiled job carries a grid ``(rows, cols)``; tiles are indexed row-major
  ``0 .. rows*cols - 1``. Tile pixel bounds come from the grid and the
  render resolution (``tile_bounds``); the wire carries only the grid and
  the index.
"""

from __future__ import annotations

import os
from typing import NamedTuple

# Grid ceiling: a 16x16 grid already turns one frame into 256 units.
MAX_TILE_GRID_DIM = 16


class WorkUnit(NamedTuple):
    """One schedulable unit of work: a frame, or one tile of a frame."""

    frame_index: int
    tile: int | None = None  # None = the whole frame

    @property
    def is_tiled(self) -> bool:
        return self.tile is not None

    @property
    def sort_key(self) -> tuple[int, int]:
        """Total order that never compares ``None`` to an int."""
        return (self.frame_index, -1 if self.tile is None else self.tile)

    @property
    def label(self) -> str:
        """Log label: ``"12"`` for a frame, ``"12/t03"`` for a tile."""
        if self.tile is None:
            return str(self.frame_index)
        return f"{self.frame_index}/t{self.tile:02d}"


def parse_tile_grid(text: str) -> tuple[int, int]:
    """Parse a grid: ``"2x2"``, ``"2,3"``, or ``"4"`` (square)."""
    cleaned = text.strip().lower().replace("x", ",")
    parts = [p for p in cleaned.split(",") if p.strip()]
    if len(parts) == 1:
        rows = cols = int(parts[0])
    elif len(parts) == 2:
        rows, cols = int(parts[0]), int(parts[1])
    else:
        raise ValueError(f"Unparseable tile grid: {text!r} (want ROWSxCOLS)")
    validate_tile_grid((rows, cols))
    return rows, cols


def env_tile_grid() -> tuple[int, int] | None:
    """The ``TRC_TILE_GRID`` default grid for jobs loaded from TOML files
    that name none. Read at job load time only, never while decoding a
    job sent over the wire."""
    value = (os.environ.get("TRC_TILE_GRID") or "").strip()
    if not value or value in ("0", "off", "none", "1", "1x1"):
        return None
    return parse_tile_grid(value)


def validate_tile_grid(grid: tuple[int, int]) -> None:
    rows, cols = grid
    if rows < 1 or cols < 1:
        raise ValueError(f"tile grid dimensions must be >= 1, got {rows}x{cols}")
    if rows > MAX_TILE_GRID_DIM or cols > MAX_TILE_GRID_DIM:
        raise ValueError(
            f"tile grid {rows}x{cols} exceeds the {MAX_TILE_GRID_DIM}x"
            f"{MAX_TILE_GRID_DIM} ceiling"
        )


def tile_rc(tile: int, grid: tuple[int, int]) -> tuple[int, int]:
    """Row-major (row, col) of a tile index within the grid."""
    rows, cols = grid
    if not (0 <= tile < rows * cols):
        raise ValueError(f"tile {tile} outside the {rows}x{cols} grid")
    return tile // cols, tile % cols


def tile_pixel_fraction(
    tile: int | None,
    grid: tuple[int, int] | None,
    *,
    width: int | None = None,
    height: int | None = None,
) -> float:
    """Fraction of the frame's pixels a tile covers (1.0 = whole frame):
    exact with the resolution, else ``1 / (rows * cols)``, which every
    tile of the even split is within one pixel per axis of."""
    if tile is None or grid is None:
        return 1.0
    rows, cols = grid
    if width is not None and height is not None:
        _, _, tile_height, tile_width = tile_bounds(tile, grid, width=width, height=height)
        total = width * height
        return (tile_height * tile_width) / total if total else 1.0
    return 1.0 / (rows * cols)


def unit_pixel_fraction(
    unit: WorkUnit,
    grid: tuple[int, int] | None,
    *,
    width: int | None = None,
    height: int | None = None,
) -> float:
    """``tile_pixel_fraction`` keyed by a WorkUnit."""
    return tile_pixel_fraction(unit.tile, grid, width=width, height=height)


def tile_bounds(
    tile: int, grid: tuple[int, int], *, width: int, height: int
) -> tuple[int, int, int, int]:
    """Pixel bounds ``(y0, x0, tile_height, tile_width)`` of a tile.

    An even split at ``floor(i*H/rows)`` boundaries: tiles differ by at
    most one pixel per axis and the grid covers the frame exactly.
    """
    row, col = tile_rc(tile, grid)
    rows, cols = grid
    y0 = row * height // rows
    y1 = (row + 1) * height // rows
    x0 = col * width // cols
    x1 = (col + 1) * width // cols
    return y0, x0, y1 - y0, x1 - x0
