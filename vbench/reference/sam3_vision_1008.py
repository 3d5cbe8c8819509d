"""Plain reference of SAM 3's image encoder (github.com/facebookresearch/sam3,
huggingface.co/facebook/sam3: the vision backbone of ``config.json``), the
RoPE ViT trunk and its FPN neck, in float32 PyTorch. It imports nothing of
the program.

Input: (N, S, S, 3) u8 pixels at the image size S (1008), mapped to
[-1, 1] as (x / 255 - 0.5) * 2. The trunk, in spatial token order:

- a patch conv (patch 14, with bias) to the hidden size D, then the
  absolute position table, pretrained at pretrain_image_size / patch (24 x
  24) and tiled over the 72 x 72 grid, then a layer norm;
- num_hidden_layers pre-LN blocks, x + attn(ln1(x)), then x + mlp(ln2(x)).
  Attention has num_attention_heads heads of D / heads, q, k, v and o
  projections with biases, scale 1 / sqrt(head dim), and 2D axial RoPE on q
  and k: the first half of a head's dims in adjacent pairs rotated by the
  token's column, the second half by its row, pair j at frequency
  rope_theta^(-4j / head dim). The layers in global_attn_indexes attend over
  all tokens, their positions scaled by window / grid (24 / 72); the others
  attend inside non-overlapping window x window windows, their positions
  those inside the window. The MLP is fc1 (D -> intermediate_size), GELU,
  fc2.
- the neck, on the trunk's (N, 72, 72, D): level 0 a transposed conv (k 2,
  stride 2, D -> D/2), GELU, a transposed conv (D/2 -> D/4); level 1 one
  transposed conv (D -> D/2); level 2 nothing; level 3 a 2 x 2 max pool;
  then each level a 1 x 1 conv to fpn_hidden_size and a 3 x 3 conv (pad 1).
  The four levels, (N, 288, 288, 256), (N, 144, 144, 256), (N, 72, 72,
  256) and (N, 36, 36, 256), are the served answer; the neck's sine
  position encodings are not.

Departures from the published description, each as vision.cpp's
``sam3.h`` runs the converted checkpoint and the program follows it:

- GELU in its tanh form (the published modules use the exact erf form);
- layer norms with eps 1e-5;
- no class token: the converted position table holds the 24 x 24 patch
  rows only;
- the global layers here attend in blocks of queries (``QUERY_BLOCK``), the
  same function computed in parts so that a 1008 px image fits.

The served answer is compared as an integer view (``expected_u8``): the
four levels flattened (NHWC) and concatenated, each divided by its step
(``cfg["check"]["steps"]``, powers of two, so that the division is exact
in float16 and float32 alike), rounded half to even and clipped to
``VIEW_MAX``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, exact_matmul

__all__ = ["forward", "expected_u8", "view", "QUERY_BLOCK", "VIEW_MAX"]

QUERY_BLOCK = 1728  # queries a block in a global layer: a third of 5184, 0.57 GB of f32 logits an image
VIEW_MAX = 32752  # the view's clip, the largest float16 value inside int16's range
LN_EPS = 1e-5


def _rope(t: torch.Tensor, px: torch.Tensor, py: torch.Tensor, theta: float) -> torch.Tensor:
    """2D axial RoPE on t (B, T, heads, hd) at token positions px, py (T,)
    float64: pairs (2j, 2j + 1) of the first half rotated by px * f_j, of
    the second half by py * f_j, f_j = theta^(-4j / hd)."""
    hd = t.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, 2, dtype=torch.float64) / (hd // 2))  # (hd / 4,)
    ang = torch.cat([px[:, None] * freqs, py[:, None] * freqs], dim=1)  # (T, hd / 2), one angle a pair
    cos = torch.cos(ang).to(torch.float32).to(t.device)[:, None]
    sin = torch.sin(ang).to(torch.float32).to(t.device)[:, None]
    a, b = t[..., 0::2], t[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(t.shape)


def _grid_positions(rows: int, cols: int, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Column and row of each token of a rows x cols grid in row-major
    order, times ``scale``, float64 on the CPU."""
    r = torch.arange(rows, dtype=torch.float64).repeat_interleave(cols)
    c = torch.arange(cols, dtype=torch.float64).repeat(rows)
    return c * scale, r * scale


def _layer_norm(t, w, name):
    return F.layer_norm(t, (t.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)


def _gelu(t):
    return F.gelu(t, approximate="tanh")


def _attention(p: Precision, w: dict, base: str, t: torch.Tensor, px, py, heads: int, theta: float,
               block: int) -> torch.Tensor:
    """Self-attention of t (B, T, D) with RoPE at positions px, py; queries
    in blocks of ``block``."""
    b, n, d = t.shape
    hd = d // heads

    def proj(name):
        return p.linear(t, w[f"{base}.{name}.weight"], w[f"{base}.{name}.bias"]).reshape(b, n, heads, hd)

    q = _rope(proj("q_proj"), px, py, theta).transpose(1, 2)  # (B, heads, T, hd)
    k = _rope(proj("k_proj"), px, py, theta).transpose(1, 2)
    v = proj("v_proj").transpose(1, 2)
    scale = 1.0 / math.sqrt(hd)
    kt = k.transpose(-1, -2)
    outs = []
    for s in range(0, n, block):
        logits = p.matmul(q[:, :, s:s + block], kt) * scale
        outs.append(p.matmul(torch.softmax(logits, dim=-1), v))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, n, d)
    return p.linear(o, w[f"{base}.o_proj.weight"], w[f"{base}.o_proj.bias"])


def _conv_t(p: Precision, t, w, name):
    return F.conv_transpose2d(p.q(t), p.q(w[f"{name}.weight"]), w[f"{name}.bias"], stride=2)


def forward(w: dict, x_u8: torch.Tensor, cfg: dict, precision: str = "f32") -> list[torch.Tensor]:
    """(N, S, S, 3) uint8 -> the four FPN levels, (N, H, W, fpn) float32."""
    p = Precision(precision)
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    size, patch, win = cfg["image_size"], cfg["patch_size"], cfg["window_size"]
    theta = float(cfg["rope_theta"])
    n, h, wd, _ = x_u8.shape
    if (h, wd) != (size, size):
        raise ValueError(f"sam3 reference: input {wd}x{h}, the configuration's image is {size}x{size}")
    g = size // patch
    pre = cfg["pretrain_image_size"] // patch
    e = "det.ve.backbone"

    x = (x_u8.float() / 255.0 - 0.5) * 2.0
    t = p.conv2d(x.permute(0, 3, 1, 2), w[f"{e}.embeddings.patch_embeddings.projection.weight"],
                 w[f"{e}.embeddings.patch_embeddings.projection.bias"], stride=patch)
    t = t.permute(0, 2, 3, 1)  # (N, g, g, D)
    pos = w[f"{e}.embeddings.position_embeddings"].reshape(pre, pre, d)
    reps = -(-g // pre)
    t = t + pos.repeat(reps, reps, 1)[:g, :g]
    t = _layer_norm(t, w, f"{e}.layer_norm")

    nw = g // win
    wx, wy = _grid_positions(win, win, 1.0)
    gx, gy = _grid_positions(g, g, win / g)
    for i in range(cfg["num_hidden_layers"]):
        base = f"{e}.layers.{i}"
        y = _layer_norm(t, w, f"{base}.layer_norm1")
        if i in cfg["global_attn_indexes"]:
            y = _attention(p, w, f"{base}.attention", y.reshape(n, g * g, d), gx, gy, heads, theta, QUERY_BLOCK)
            y = y.reshape(n, g, g, d)
        else:  # spatial windows, row by row, and back
            y = y.reshape(n, nw, win, nw, win, d).permute(0, 1, 3, 2, 4, 5).reshape(n * nw * nw, win * win, d)
            y = _attention(p, w, f"{base}.attention", y, wx, wy, heads, theta, win * win)
            y = y.reshape(n, nw, nw, win, win, d).permute(0, 1, 3, 2, 4, 5).reshape(n, g, g, d)
        t = t + y
        y = _layer_norm(t, w, f"{base}.layer_norm2")
        y = p.linear(_gelu(p.linear(y, w[f"{base}.mlp.fc1.weight"], w[f"{base}.mlp.fc1.bias"])),
                     w[f"{base}.mlp.fc2.weight"], w[f"{base}.mlp.fc2.bias"])
        t = t + y

    c = t.permute(0, 3, 1, 2)  # (N, D, g, g)
    f = "det.ve.neck.fpn_layers"
    ins = [_conv_t(p, _gelu(_conv_t(p, c, w, f"{f}.0.scale_layers.0")), w, f"{f}.0.scale_layers.2"),
           _conv_t(p, c, w, f"{f}.1.scale_layers.0"), c, F.max_pool2d(c, 2, 2)]
    levels = []
    for i, lv in enumerate(ins):
        lv = p.conv2d(lv, w[f"{f}.{i}.proj1.weight"], w[f"{f}.{i}.proj1.bias"])
        lv = p.conv2d(lv, w[f"{f}.{i}.proj2.weight"], w[f"{f}.{i}.proj2.bias"], 1, 1)
        levels.append(lv.permute(0, 2, 3, 1))
    return levels


def view(levels, steps) -> torch.Tensor:
    """The integer view of four levels (N, H, W, C): each flattened per image,
    divided by its step, rounded half to even, clipped to +-VIEW_MAX, the
    four concatenated: (N, values) int16."""
    n = levels[0].shape[0]
    parts = [(lv.float().reshape(n, -1) / s).round().clamp(-VIEW_MAX, VIEW_MAX) for lv, s in zip(levels, steps)]
    return torch.cat(parts, dim=1).to(torch.int16)


@torch.no_grad()
def expected_u8(w: dict, x_u8: torch.Tensor, cfg: dict, precision: str = "f32") -> torch.Tensor:
    """The served answer's integer view (:func:`view`), (N, values) int16;
    ``precision`` "fp8" is the control."""
    with exact_matmul():
        levels = forward(w, x_u8, cfg, precision)
    return view(levels, cfg["check"]["steps"])
