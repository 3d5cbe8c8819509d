"""Image layer — containers, conversions and resizes (a numpy copy of the
host-side parts of vision_tpu/image that the ported slices use; the native
filters and tiling wait for their slices)."""

from .image import (
    Image,
    ImageFormat,
    image_normalize,
    image_scale,
    image_u8_to_f32,
    preprocess_scale_method,
)

__all__ = [
    "Image",
    "ImageFormat",
    "image_normalize",
    "image_scale",
    "image_u8_to_f32",
    "preprocess_scale_method",
]
