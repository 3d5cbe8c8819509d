"""Tiling engine for processing large images in overlapping tiles (the port's
own copy of vision_tpu/image/tiling.py; numpy only).

Mirrors the reference tile_layout / tile_scale / tile_merge exactly
(src/visp/image.cpp:609-693, include/visp/image.h:184-208): aligned
overlapping tiles, linear-ramp blend weights in the overlap regions, and a
scale mapping used by ESRGAN 4x upscaling.

``EsrganModel.compute`` (models/esrgan.py) runs the tiles in batches on the
card; this module holds the host-side layout math and the merge.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.errors import raise_error
from .image import Image, ImageFormat

__all__ = ["TileLayout", "tile_scale", "tile_merge", "tile_weights"]


def _div_ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class TileLayout:
    image_extent: tuple[int, int]
    overlap: tuple[int, int]
    n_tiles: tuple[int, int]
    tile_size: tuple[int, int]

    def __init__(self, extent: tuple[int, int], max_tile_size: int, overlap: int, align: int = 16):
        self.image_extent = (extent[0], extent[1])
        self.overlap = (overlap, overlap)
        nt = (_div_ceil(extent[0], max_tile_size), _div_ceil(extent[1], max_tile_size))
        self.n_tiles = nt
        ext_overlap = (extent[0] + (nt[0] - 1) * overlap, extent[1] + (nt[1] - 1) * overlap)
        ts = (_div_ceil(ext_overlap[0], nt[0]), _div_ceil(ext_overlap[1], nt[1]))
        self.tile_size = (_div_ceil(ts[0], align) * align, _div_ceil(ts[1], align) * align)

    def start(self, coord: tuple[int, int], pad: tuple[int, int] = (0, 0)) -> tuple[int, int]:
        off = (
            coord[0] * (self.tile_size[0] - self.overlap[0]),
            coord[1] * (self.tile_size[1] - self.overlap[1]),
        )
        return (
            off[0] + (0 if coord[0] == 0 else pad[0]),
            off[1] + (0 if coord[1] == 0 else pad[1]),
        )

    def end(self, coord: tuple[int, int], pad: tuple[int, int] = (0, 0)) -> tuple[int, int]:
        s = self.start(coord)
        off = (s[0] + self.tile_size[0], s[1] + self.tile_size[1])
        off = (
            off[0] - (0 if coord[0] == self.n_tiles[0] - 1 else pad[0]),
            off[1] - (0 if coord[1] == self.n_tiles[1] - 1 else pad[1]),
        )
        return (min(off[0], self.image_extent[0]), min(off[1], self.image_extent[1]))

    def size(self, coord: tuple[int, int]) -> tuple[int, int]:
        s, e = self.start(coord), self.end(coord)
        return (e[0] - s[0], e[1] - s[1])

    def total(self) -> int:
        return self.n_tiles[0] * self.n_tiles[1]

    def coord(self, index: int) -> tuple[int, int]:
        return (index % self.n_tiles[0], index // self.n_tiles[0])


def tile_scale(o: TileLayout, scale: int) -> TileLayout:
    scaled = TileLayout.__new__(TileLayout)
    scaled.image_extent = (o.image_extent[0] * scale, o.image_extent[1] * scale)
    scaled.overlap = (o.overlap[0] * scale, o.overlap[1] * scale)
    scaled.n_tiles = o.n_tiles
    scaled.tile_size = (o.tile_size[0] * scale, o.tile_size[1] * scale)
    return scaled


def _axis_weights(layout: TileLayout, coord: tuple[int, int], axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-pixel blend (weight, coverage) along one axis for a tile
    (reference tile_merge weight logic, image.cpp:669-691). Not yet
    normalized: tile_weights divides by (coverage + 1)."""
    beg = layout.start(coord)[axis]
    end = layout.end(coord)[axis]
    pad_beg = layout.start(coord, layout.overlap)[axis]
    pad_end = layout.end(coord, layout.overlap)[axis]
    ov = layout.overlap[axis]
    idx = np.arange(beg, end)
    w = np.ones(end - beg, np.float32)
    cov = np.zeros(end - beg, np.float32)
    lo = idx < pad_beg
    w[lo] = ov - (pad_beg - idx[lo]) + 1
    cov[lo] = ov
    hi = idx >= pad_end
    w[hi] = ov - (idx[hi] - pad_end)
    cov[hi] = ov
    return w, cov


def tile_weights(layout: TileLayout, coord: tuple[int, int]) -> np.ndarray:
    """(h, w) normalized blend weights for the in-bounds region of a tile."""
    wx, covx = _axis_weights(layout, coord, 0)
    wy, covy = _axis_weights(layout, coord, 1)
    weight = wy[:, None] * wx[None, :]
    norm = (covx[None, :] + 1.0) * (covy[:, None] + 1.0)
    # reference: where the weight is 0 the tile value overwrites dst, which
    # is zero there by contract, so a zero blend gives the same sum
    blend = np.where(weight > 0, weight / norm, 0.0)
    return blend.astype(np.float32)


def tile_merge(tile: Image, dst: Image, tile_coord: tuple[int, int], layout: TileLayout) -> None:
    """Accumulate one tile into dst with overlap blending. Both rgb_f32;
    dst must start zero-initialized (reference image.cpp:655-693)."""
    if tile.format != ImageFormat.rgb_f32 or dst.format != ImageFormat.rgb_f32:
        raise_error("tile_merge takes rgb_f32 images (got {} and {})", tile.format, dst.format)
    beg = layout.start(tile_coord)
    end = layout.end(tile_coord)
    h, w = end[1] - beg[1], end[0] - beg[0]
    blend = tile_weights(layout, tile_coord)[:, :, None]
    region = tile.data[:h, :w, :]
    dst.data[beg[1]:end[1], beg[0]:end[0], :] += blend * region
