"""Device-side input preprocessing (a port of vision_tpu/ops/preprocess.py).

The u8 pixels cross to the device raw (4x less host->device traffic than
f32) and the cast + normalize runs there.
"""

from __future__ import annotations

import torch

from ..core.graph import device_cache

__all__ = ["normalize_u8", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@device_cache(maxsize=16)
def _channel_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """Per-channel constants as an f32 tensor on ``device``, made once."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize_u8(x: torch.Tensor, mean=None, std=None, dtype=torch.bfloat16) -> torch.Tensor:
    """(N, H, W, C) uint8 -> normalized float: ((x/255) - mean) / std, in f32,
    then cast to ``dtype``."""
    xf = x.float() * (1.0 / 255.0)
    if mean is not None:
        xf = xf - _channel_constant(tuple(mean), x.device)
    if std is not None:
        xf = xf / _channel_constant(tuple(std), x.device)
    return xf.to(dtype)
