"""DINOv2 ViT backbone (HF transformers naming) — a port of
vision_tpu/models/dino.py.

Reference backbone: src/visp/arch/dino.{cpp,h}. Patch embed + cls token +
bicubic-interpolated position encodings for arbitrary resolution
(dino.cpp:10-30), pre-norm blocks with LayerScale (dino.cpp:48-50), and an
arbitrary set of intermediate layer outputs, each passed through the final
layernorm (dino.cpp:92-110).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.gguf import GGUFFile
from ..core.params import Params
from ..ops import attention, gelu, layer_norm, linear, patch_embed, resize_nhwc
from ..ops.debug import capture

__all__ = ["DinoParams", "dino_detect_params", "dino_get_intermediate_layers", "prepare_tokens"]


@dataclass(frozen=True)
class DinoParams:
    patch_size: int = 14
    embed_dim: int = 384
    n_heads: int = 6
    n_layers: int = 12


def dino_detect_params(file: GGUFFile) -> DinoParams:
    """GGUF keys dino.* (reference dino.cpp:119-126)."""
    return DinoParams(
        patch_size=file.get_int("dino.patch_size"),
        embed_dim=file.get_int("dino.embed_dim"),
        n_heads=file.get_int("dino.n_heads"),
        n_layers=file.get_int("dino.n_layers"),
    )


def interpolate_pos_encoding(p: Params, n_tokens: int, w: int, h: int, patch_size: int):
    """Bicubic-resample patch position embeddings to the input resolution
    (reference dino.cpp:10-30). pos_embed: (1, N+1, C)."""
    pos_embed = p.weight("position_embeddings")
    n = pos_embed.shape[1] - 1
    n_patch = n_tokens - 1
    if n_patch == n and w == h:
        return pos_embed
    class_embed = pos_embed[:, :1]
    patch_pos = pos_embed[:, 1:]
    dim = pos_embed.shape[2]
    tw, th = w // patch_size, h // patch_size
    sqrt_n = int(math.sqrt(n) + 0.01)
    grid = patch_pos.reshape(1, sqrt_n, sqrt_n, dim)
    grid = resize_nhwc(grid, (th, tw), "bicubic", align_corners=False)
    grid = grid.reshape(1, th * tw, dim)
    return torch.cat([class_embed, grid], dim=1)


def prepare_tokens(p: Params, x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Patchify + cls token + pos encoding (reference dino.cpp:32-46).
    x: (N, H, W, 3) -> (N, T+1, C)."""
    n, h, w, _ = x.shape
    emb = patch_embed(p["patch_embeddings"], x, patch_size)
    b, hp, wp, c = emb.shape
    tokens = emb.reshape(b, hp * wp, c)
    cls = p.weight("cls_token").expand(b, 1, c).to(tokens.dtype)
    tokens = torch.cat([cls, tokens], dim=1)
    pos = interpolate_pos_encoding(p, tokens.shape[1], w, h, patch_size)
    return tokens + pos.to(tokens.dtype)


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def self_attention(p: Params, x: torch.Tensor, n_heads: int, flash: bool = False) -> torch.Tensor:
    """Separate q/k/v projections (HF Dinov2 layout; reference dino.cpp:57-74).

    The non-flash path is the JAX package's einsum form on (B, T, H, hd)
    views: logits in the input dtype with an f32 softmax. The flash path
    keeps (B, H, T, hd) for attention_core, whose "cuda" route is the
    hand-written kernel."""
    b, t, c = x.shape
    hd = c // n_heads
    scale = 1.0 / math.sqrt(hd)

    if flash:
        def project(pp):
            return linear(pp, x).reshape(b, t, n_heads, hd).permute(0, 2, 1, 3)

        q = project(p["attention.query"])
        k = project(p["attention.key"])
        v = project(p["attention.value"])
        return attention(p["output.dense"], q, k, v, None, scale, flash=flash)

    proj = lambda pp: linear(pp, x).reshape(b, t, n_heads, hd)  # noqa: E731
    q = proj(p["attention.query"])
    k = proj(p["attention.key"])
    v = proj(p["attention.value"])
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, c)
    return linear(p["output.dense"], o)


def layer(p: Params, x: torch.Tensor, dp: DinoParams, flash: bool = False) -> torch.Tensor:
    """Pre-norm block with LayerScale (reference dino.cpp:76-89)."""
    attn = layer_norm(p["norm1"], x, 1e-6)
    attn = self_attention(p["attention"], attn, dp.n_heads, flash)
    x = x + attn * p["layer_scale1"].weight("lambda1")
    ffn = layer_norm(p["norm2"], x, 1e-6)
    ffn = mlp(p["mlp"], ffn)
    return x + ffn * p["layer_scale2"].weight("lambda1")


def dino_get_intermediate_layers(p: Params, x: torch.Tensor, layers, dp: DinoParams, flash: bool = False):
    """(reference dino_get_intermediate_layers, dino.cpp:92-115). Returns a
    list of (N, T+1, C) outputs, each final-layernormed."""
    tokens = prepare_tokens(p["embeddings"], x, dp.patch_size)
    outputs = []
    enc = p["encoder.layer"]
    want = set(int(i) for i in layers)
    for i in range(dp.n_layers):
        tokens = layer(enc[i], tokens, dp, flash)
        if i in want:
            out = layer_norm(p["layernorm"], tokens, 1e-6)
            capture(f"dino_layer_{i}", out)
            outputs.append(out)
    return outputs
