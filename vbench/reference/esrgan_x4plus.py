"""Plain reference of RealESRGAN_x4plus, the RRDBNet of
github.com/xinntao/Real-ESRGAN (``inference_realesrgan.py``: num_feat 64,
num_grow_ch 32, num_block 23, scale 4), in float32 PyTorch, written from the
published architecture. It imports nothing of the program.

Weights are the converted GGUF names of the "old-arch" checkpoint
(``model.0`` the first conv, ``model.1.sub.{i}.RDB{r}.conv{j}.0`` the dense
blocks, ``model.1.sub.{n}`` the trunk conv, ``model.3`` / ``model.6`` the
upsampling convs, ``model.8`` the HR conv, ``model.10`` the last conv).

u8 pixels in, divided by 255; each residual dense block is five 3x3 convs,
conv1-4 with leaky ReLU 0.2 on the concatenation of its input and the
features so far, x + 0.2 * conv5; an RRDB is x + 0.2 * RDB3(RDB2(RDB1(x)));
after the trunk conv and its skip, log2(scale) x (nearest 2x, conv, leaky
ReLU), the HR conv with leaky ReLU and the last conv. The served answer is
the output clamped to [0, 1], times 255, truncated to u8, alpha 255.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, exact_matmul

__all__ = ["forward", "expected_u8"]


def forward(w: dict, x_u8: torch.Tensor, cfg: dict, precision: str = "f32") -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, H * scale, W * scale, 3) float32."""
    p = Precision(precision)
    nb, scale = cfg["num_block"], cfg["scale"]

    def conv(name, t):
        return p.conv2d(t, w[f"{name}.weight"], w[f"{name}.bias"], 1, 1)

    def lrelu(t):
        return F.leaky_relu(t, 0.2)

    def rdb(base, x):
        feats = [x]
        for j in range(1, 5):
            feats.append(lrelu(conv(f"{base}.conv{j}.0", torch.cat(feats, 1))))
        return x + 0.2 * conv(f"{base}.conv5.0", torch.cat(feats, 1))

    x = x_u8.permute(0, 3, 1, 2).float() / 255.0
    feat = conv("model.0", x)
    h = feat
    for i in range(nb):
        y = h
        for r in (1, 2, 3):
            y = rdb(f"model.1.sub.{i}.RDB{r}", y)
        h = h + 0.2 * y
    h = feat + conv(f"model.1.sub.{nb}", h)
    seq = 2
    for _ in range(int(math.log2(scale))):
        h = lrelu(conv(f"model.{seq + 1}", F.interpolate(h, scale_factor=2, mode="nearest")))
        seq += 3
    h = conv(f"model.{seq + 2}", lrelu(conv(f"model.{seq}", h)))
    return h.permute(0, 2, 3, 1)


@torch.no_grad()
def expected_u8(w: dict, x_u8: torch.Tensor, cfg: dict, precision: str = "f32") -> torch.Tensor:
    """The served answer's pixels, (N, H * scale, W * scale, 4) uint8:
    clamp to [0, 1], times 255, truncated; alpha 255."""
    with exact_matmul():
        y = forward(w, x_u8, cfg, precision)
    rgb = (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.full((*rgb.shape[:3], 1), 255, dtype=torch.uint8, device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)
