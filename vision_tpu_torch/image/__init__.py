"""Image layer — containers, conversions, resizes and the tiling engine (a
numpy copy of the host-side parts of vision_tpu/image that the ported slices
use; the native filters wait for their queue item)."""

from .image import (
    Image,
    ImageFormat,
    image_alloc,
    image_f32_to_u8,
    image_load_array,
    image_normalize,
    image_scale,
    image_set_alpha,
    image_u8_to_f32,
    preprocess_scale_method,
)
from .tiling import TileLayout, tile_merge, tile_scale, tile_weights

__all__ = [
    "Image",
    "ImageFormat",
    "image_alloc",
    "image_f32_to_u8",
    "image_load_array",
    "image_normalize",
    "image_scale",
    "image_set_alpha",
    "image_u8_to_f32",
    "preprocess_scale_method",
    "TileLayout",
    "tile_merge",
    "tile_scale",
    "tile_weights",
]
