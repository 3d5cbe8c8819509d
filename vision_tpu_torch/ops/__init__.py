from .nn import (
    attention,
    attention_core,
    attention_route,
    conv_2d,
    conv_transpose_2d,
    gelu,
    layer_norm,
    layer_norm_direct,
    linear,
    patch_embed,
    relu,
)
from .preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_u8
from .resize import resize_nhwc

__all__ = [
    "attention",
    "attention_core",
    "attention_route",
    "conv_2d",
    "conv_transpose_2d",
    "gelu",
    "layer_norm",
    "layer_norm_direct",
    "linear",
    "patch_embed",
    "relu",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "normalize_u8",
    "resize_nhwc",
]
