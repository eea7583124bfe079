"""Tile and region rectangles: static Python geometry (ref
tile_utils/utils.py:36-99; the port's copy of ``mdu_tpu/utils/bbox.py``)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum


class BlendMode(str, Enum):
    """Region layer type (ref tile_utils/utils.py:36-39)."""

    FOREGROUND = "Foreground"
    BACKGROUND = "Background"


@dataclass(frozen=True)
class BBox:
    """A latent-space tile rectangle: origin (x, y), size (w, h)."""

    x: int
    y: int
    w: int
    h: int


@dataclass(frozen=True)
class RegionSpec:
    """Region prompt control settings in relative [0, 1] coordinates (the
    reference's ``BBoxSettings`` without ``enable``: a disabled region is
    not passed in)."""

    x: float
    y: float
    w: float
    h: float
    prompt: str = ""
    neg_prompt: str = ""
    blend_mode: BlendMode = BlendMode.BACKGROUND
    feather_ratio: float = 0.2
    seed: int = -1

    def validate(self) -> bool:
        """ref tile_utils/utils.py:61."""
        return not (self.x > 1.0 or self.y > 1.0 or self.w <= 0.0 or self.h <= 0.0)

    def to_bbox(self, latent_w: int, latent_h: int) -> "RegionBBox":
        """The latent-space bbox: floor for the origin, ceil for the size,
        clamped into the canvas (ref abstractdiffusion.py:207-214)."""
        x = max(0, int(self.x * latent_w))
        y = max(0, int(self.y * latent_h))
        w = min(latent_w - x, math.ceil(self.w * latent_w))
        h = min(latent_h - y, math.ceil(self.h * latent_h))
        return RegionBBox(x=x, y=y, w=w, h=h, prompt=self.prompt,
                          neg_prompt=self.neg_prompt, blend_mode=self.blend_mode,
                          feather_ratio=max(0.0, min(1.0, self.feather_ratio)),
                          seed=self.seed)


@dataclass(frozen=True)
class RegionBBox(BBox):
    """A resolved region bbox (ref CustomBBox, tile_utils/utils.py:84-99)."""

    prompt: str = ""
    neg_prompt: str = ""
    blend_mode: BlendMode = BlendMode.BACKGROUND
    feather_ratio: float = 0.2
    seed: int = -1
