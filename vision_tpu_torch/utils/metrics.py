"""Image quality metrics for the CLI's ``compare``: ``psnr`` and ``ssim``,
the port of vision_tpu/utils/metrics.py:38-86, in f32 with PyTorch on the
CPU. The mask, depth and detection metrics wait for the evaluator."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["psnr", "ssim"]


def psnr(a, b, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over all elements (inf for equal)."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    mse = torch.mean((a - b) ** 2)
    return float(10.0 * torch.log10(max_val**2 / mse))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(r**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def ssim(a, b, max_val: float = 1.0, window: int = 11, sigma: float = 1.5) -> float:
    """Mean structural similarity (Wang et al. 2004 standard settings:
    11x11 gaussian window sigma=1.5, K1=0.01, K2=0.03, 'valid' windows).

    Inputs are NHWC (or HWC) float images; channels are treated
    independently and averaged. The separable gaussian runs as two
    depthwise convs, as in the JAX package."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    if a.ndim == 3:
        a, b = a[None], b[None]
    if a.ndim != 4:
        raise ValueError(f"ssim expects HWC or NHWC images, got {tuple(a.shape)}")
    c = a.shape[-1]
    k = torch.from_numpy(_gaussian_kernel(window, sigma))
    kh = k.reshape(1, 1, window, 1).repeat(c, 1, 1, 1)
    kw = k.reshape(1, 1, 1, window).repeat(c, 1, 1, 1)

    def blur(x):
        x = x.permute(0, 3, 1, 2)
        x = F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)
        return x.permute(0, 2, 3, 1)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a**2
    var_b = blur(b * b) - mu_b**2
    cov = blur(a * b) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(torch.mean(s))
