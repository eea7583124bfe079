"""Tile rectangles: static Python geometry (ref tile_utils/utils.py:69-99)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BBox:
    """A latent-space tile rectangle: origin (x, y), size (w, h)."""

    x: int
    y: int
    w: int
    h: int
