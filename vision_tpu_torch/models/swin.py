"""SWIN transformer v1 backbone (tiny + large presets) — a port of
vision_tpu/models/swin.py.

Reference: src/visp/arch/swin.{cpp,h}: shifted-window attention blocks with
relative-position-bias lookup tables and shift masks, patch-merging
downsampling, 4 layer-normed feature pyramid outputs.

The relative-position index and the shifted-window masks are numpy shape
functions, cached; each mask is copied to the device once per (w, h, window,
device) and stays there. Every block's attention goes through ops/nn.py
``attention_windows``, so on the card it is one launch of the window kernel
(csrc/window_attention.cu): the relative-position bias shared by all
windows, and in every second (shifted) block the per-window shift mask.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..core.errors import raise_error
from ..core.gguf import GGUFFile
from ..core.params import Params
from ..ops import attention_windows, gelu, layer_norm, linear, patch_embed

__all__ = [
    "SwinLayerParams",
    "SwinParams",
    "SWIN_T_PARAMS",
    "SWIN_L_PARAMS",
    "swin_detect_params",
    "swin_encode",
    "compute_attention_mask",
    "relative_position_bias",
]

SWIN_N_LAYERS = 4


@dataclass(frozen=True)
class SwinLayerParams:
    depth: int
    n_heads: int
    n_features: int


@dataclass(frozen=True)
class SwinParams:
    embed_dim: int
    window_size: int
    layers: tuple[SwinLayerParams, ...]


SWIN_T_PARAMS = SwinParams(
    embed_dim=96,
    window_size=7,
    layers=(
        SwinLayerParams(2, 3, 96),
        SwinLayerParams(2, 6, 192),
        SwinLayerParams(6, 12, 384),
        SwinLayerParams(2, 24, 768),
    ),
)

SWIN_L_PARAMS = SwinParams(
    embed_dim=192,
    window_size=12,
    layers=(
        SwinLayerParams(2, 6, 192),
        SwinLayerParams(2, 12, 384),
        SwinLayerParams(18, 24, 768),
        SwinLayerParams(2, 48, 1536),
    ),
)


def swin_detect_params(file: GGUFFile) -> SwinParams:
    """(reference swin_detect_params, swin.cpp:292-301). Beyond the two
    reference presets, explicit configs written by the converter for
    non-preset checkpoints (swin.window/depths/num_heads/dims) are read."""
    embed_dim = file.get_int("swin.embed_dim")
    if file.get_string("swin.config", "") == "custom":
        depths = [int(v) for v in file.get_array("swin.depths")]
        heads = [int(v) for v in file.get_array("swin.num_heads")]
        dims = [int(v) for v in file.get_array("swin.dims")]
        return SwinParams(
            embed_dim=embed_dim,
            window_size=file.get_int("swin.window"),
            layers=tuple(SwinLayerParams(d, h, c) for d, h, c in zip(depths, heads, dims)),
        )
    if embed_dim == 96:
        return SWIN_T_PARAMS
    if embed_dim == 192:
        return SWIN_L_PARAMS
    raise_error("Unsupported Swin Transformer embed dim: {}", embed_dim)


@lru_cache(maxsize=32)
def _relative_position_index(window: int) -> np.ndarray:
    """(reference compute_relative_position_index, swin.cpp:26-37):
    bias[query i, key j] = table[(yi-yj+n-1)*(2n-1) + (xi-xj+n-1)]."""
    n = window
    coords = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"), 0)  # (2, n, n): y, x
    flat = coords.reshape(2, -1)  # (2, n*n)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N): coord[i] - coord[j]
    y = rel[0] + n - 1
    x = rel[1] + n - 1
    return (y * (2 * n - 1) + x).astype(np.int32)  # (N, N), [i0, i1]


@lru_cache(maxsize=64)
def compute_attention_mask(w: int, h: int, window: int) -> np.ndarray:
    """Shifted-window attention mask, 0 / -inf, shape (n_windows, N, N)
    (reference compute_attention_mask, swin.cpp:163-210). Patches in
    different shift zones of edge windows must not attend to each other."""
    n = window
    shift = window // 2
    nw_x = (w + n - 1) // n
    nw_y = (h + n - 1) // n
    w_pad, h_pad = nw_x * n, nw_y * n
    # global coordinate zone id per padded pixel
    zone_y = (np.arange(h_pad) < h_pad - shift).astype(np.int32)
    zone_x = (np.arange(w_pad) < w_pad - shift).astype(np.int32)
    mask = np.zeros((nw_y * nw_x, n * n, n * n), np.float32)
    for iw_y in range(nw_y):
        for iw_x in range(nw_x):
            if iw_y < nw_y - 1 and iw_x < nw_x - 1:
                continue
            zy = zone_y[iw_y * n : (iw_y + 1) * n]
            zx = zone_x[iw_x * n : (iw_x + 1) * n]
            zid = (zy[:, None] * 2 + zx[None, :]).reshape(-1)  # (N,)
            different = zid[:, None] != zid[None, :]
            mask[iw_y * nw_x + iw_x][different] = float("-inf")
    mask.setflags(write=False)  # shared by every caller of the cache
    return mask


@lru_cache(maxsize=64)
def _device_mask(w: int, h: int, window: int, device: torch.device) -> torch.Tensor:
    """compute_attention_mask as a float32 tensor on ``device``, made once."""
    return torch.tensor(compute_attention_mask(w, h, window), device=device)


@lru_cache(maxsize=32)
def _device_index(window: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_relative_position_index(window).reshape(-1).astype(np.int64)).to(device)


def relative_position_bias(p: Params, window: int, n_heads: int) -> torch.Tensor:
    """(1, heads, N, N) additive bias from the learned table, contiguous
    (reference swin.cpp:72-78)."""
    table = p.weight("relative_position_bias_table")  # ((2n-1)^2, heads)
    n = window * window
    bias = table[_device_index(window, table.device)].reshape(n, n, n_heads)
    return bias.permute(2, 0, 1).contiguous()[None]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nw, win*win, C); input must be padded
    (reference swin.cpp:48-56)."""
    b, h, w, c = x.shape
    if h % window or w % window:
        raise ValueError(f"window_partition: extent {(h, w)} is not padded to the window {window}")
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b * (h // window) * (w // window), window * window, c)


def window_reverse(x: torch.Tensor, w: int, h: int, window: int) -> torch.Tensor:
    """(reference swin.cpp:58-67)."""
    c = x.shape[-1]
    b = x.shape[0] // ((w // window) * (h // window))
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def window_attention(p: Params, x: torch.Tensor, mask, n_heads: int, window: int) -> torch.Tensor:
    """Window attention with relative position bias + optional shift mask
    (reference swin.cpp:69-97). x: (B_windows, N, C); mask: (nw, N, N)
    float32 tensor on x's device, or None. The bias and the mask go to
    ``attention_windows`` apart: the kernel adds both in f32."""
    c = x.shape[-1]
    bias = relative_position_bias(p, window, n_heads)  # (1, heads, N, N)
    scale = 1.0 / math.sqrt(c / n_heads)
    return attention_windows(p, x, n_heads, 2, bias, scale, window_mask=mask)


@dataclass(frozen=True)
class BlockParams:
    n_heads: int
    window_size: int
    w: int
    h: int
    shift: int


def block(p: Params, x: torch.Tensor, mask, bp: BlockParams) -> torch.Tensor:
    """Shifted-window transformer block (reference swin.cpp:99-141).
    x: (B, T, C) with T == w*h; mask: the layer's shift mask (used when
    ``bp.shift`` > 0)."""
    b, t, c = x.shape
    w, h, window, shift = bp.w, bp.h, bp.window_size, bp.shift
    if t != w * h:
        raise ValueError(f"swin block: {t} tokens for a {w}x{h} grid")
    shortcut = x
    x = layer_norm(p["norm1"], x).reshape(b, h, w, c)
    pad_r = (window - w % window) % window
    pad_b = (window - h % window) % window
    if pad_r or pad_b:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    x = window_partition(x, window)
    x = window_attention(p["attn"], x, mask if shift > 0 else None, bp.n_heads, window)
    x = window_reverse(x, w + pad_r, h + pad_b, window)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    if pad_r or pad_b:
        x = x[:, :h, :w, :]
    x = x.reshape(b, t, c) + shortcut
    return x + mlp(p["mlp"], layer_norm(p["norm2"], x))


def patch_merging(p: Params, x: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """2x2 strided concat + norm + reduction (reference swin.cpp:143-161)."""
    b, t, c = x.shape
    if t != w * h or w % 2 or h % 2:
        raise ValueError(f"patch_merging: {t} tokens for a {w}x{h} grid (both must be even)")
    x = x.reshape(b, h, w, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
    x = layer_norm(p["norm"], x.reshape(b, t // 4, 4 * c))
    return linear(p["reduction"], x)


def layer(p: Params, x: torch.Tensor, w: int, h: int, lp: SwinLayerParams, window: int, down: bool):
    """(reference swin.cpp:223-244). Returns (x_out, w, h, x_down, w_d, h_d)."""
    mask = _device_mask(w, h, window, x.device)
    for i in range(lp.depth):
        bp = BlockParams(lp.n_heads, window, w, h, 0 if i % 2 == 0 else window // 2)
        x = block(p["blocks"][i], x, mask, bp)
    if down:
        x_down = patch_merging(p["downsample"], x, w, h)
        return x, w, h, x_down, (w + 1) // 2, (h + 1) // 2
    return x, w, h, x, w, h


def swin_encode(p: Params, x: torch.Tensor, sp: SwinParams) -> list[torch.Tensor]:
    """Full 4-stage encoder -> 4 layer-normed NHWC feature maps
    (reference swin::encode, swin.cpp:246-266). x: (B, H, W, 3)."""
    x = patch_embed(p["patch_embed"], x, 4)
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp * wp, c)
    outs = []
    w, h = wp, hp
    for i in range(SWIN_N_LAYERS):
        down = i < SWIN_N_LAYERS - 1
        x_out, w_out, h_out, x, w, h = layer(p["layers"][i], x, w, h, sp.layers[i], sp.window_size, down)
        out = layer_norm(p[f"norm{i}"], x_out)
        outs.append(out.reshape(b, h_out, w_out, sp.layers[i].n_features))
    return outs
