"""SAM3 (the reference's work-in-progress scope: CLIP BPE tokenizer, 24-layer
CLIP text encoder, RoPE ViT vision encoder, FPN neck; no decoder yet) — a
port of vision_tpu/models/sam3.py.

Reference: src/visp/arch/sam3.h.

  * tokenizer: lowercase + regex pre-tokenization, char split with the
    </w> end-of-word marker, rank-ordered BPE merges, padding-aware causal
    mask (sam3.h:80-216); vocabulary and merges come from GGUF string
    arrays. Pure Python, as in the JAX package.
  * text encoder: token + position embeddings, pre-LN blocks of 16 heads,
    final layer norm, optional text projection (sam3.h:219-288). Its
    masked attention takes the naive route (f32 logits), as the JAX
    package's does: neither passes the flash flag to it.
  * vision encoder: 1008 px / patch 14 ViT, 32 layers, 28 of them window
    layers (24x24 windows) and 4 global ones, tiled absolute position
    embeddings and 2D RoPE: x positions rotate the first half of head_dim,
    y positions the second (sam3.h:291-515). The window layers run the JAX
    package's einsum form (logits rounded to x's type, f32 softmax); the
    global layers, 5184 tokens at head dim 80, go through ``attention``,
    whose "cuda" route is the hand-written flash kernel on the card.
  * FPN neck: 4 scale branches (x4 / x2 / x1 / x0.5) with 1x1 + 3x3
    projections and host-computed sine position embeddings (sam3.h:517-613).

With a ``mesh`` (parallel/) both encoders run tensor-parallel
(SAM3_TP_RULES, as the JAX package's ``sam3_shard_vision``). The JAX
package's window-major scan trunk (``vision_transformer_scan`` and its
weight packing) and the sequence- and pipeline-parallel trunks that need it
(mesh ``sp`` / ``pp`` > 1) wait for their queue item: ``encode_vision``
runs the spatial trunk.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import BuildFlag, Device, backend_init
from ..core.gguf import GGUFFile, model_load
from ..core.graph import device_cache
from ..core.params import Params
from ..core.weights import cast_float_params, load_weights, params_from_numpy
from ..core.errors import raise_error
from ..parallel.runner import mesh_entries
from ..parallel.sharding import SAM3_TP_RULES, mesh_params, mesh_shape
from ..image import Image, ImageFormat, image_scale, image_u8_to_f32, preprocess_scale_method
from ..ops import attention, attention_core, conv_2d, conv_transpose_2d, gelu, layer_norm, linear, max_pool_2d
from ..parallel.tp import gather_for, local_heads
from .mobile_sam import window_partition, window_reverse

__all__ = [
    "ClipTextTokens",
    "ClipTokenizer",
    "clip_tokenizer_init",
    "clip_encode_text",
    "encode_text",
    "Sam3VitParams",
    "apply_rope_2d",
    "rope_attention",
    "vision_layer",
    "vision_transformer",
    "sine_position_embedding",
    "fpn_layer",
    "VisionOutput",
    "vision_neck",
    "encode_vision",
    "sam3_process_input",
    "Sam3Model",
    "sam3_load_model",
]

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# CLIP BPE tokenizer (reference sam3.h:80-216)
# ---------------------------------------------------------------------------

_PRETOKENIZE = re.compile(r"[a-zA-Z]+|[0-9]|[^\s\da-zA-Z]+")


class ClipTextTokens(NamedTuple):
    token_ids: np.ndarray  # (max_tokens,) int32
    attention_mask: np.ndarray  # (max_tokens, max_tokens) float32 0/-inf


@dataclass
class ClipTokenizer:
    vocab: dict[str, int]
    bpe_rank: dict[tuple[str, str], int]
    bos_token_id: int = 49406
    eos_token_id: int = 49407
    pad_token_id: int = 49407
    unk_token_id: int = 49407

    def apply_bpe(self, tokens: list[str]) -> list[str]:
        """Greedy lowest-rank merge loop (reference sam3.h:117-144)."""
        while len(tokens) > 1:
            best_rank, best_idx = None, -1
            for i in range(len(tokens) - 1):
                r = self.bpe_rank.get((tokens[i], tokens[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_idx = r, i
            if best_idx < 0:
                break
            tokens = (
                tokens[:best_idx]
                + [tokens[best_idx] + tokens[best_idx + 1]]
                + tokens[best_idx + 2 :]
            )
        return tokens

    def tokenize(self, text: str, max_tokens: int) -> ClipTextTokens:
        """(reference clip_tokenizer::tokenize, sam3.h:146-192). Rows past
        EOS attend to 0..EOS, so no row of the mask is all -inf."""
        ids = np.full(max_tokens, self.pad_token_id, np.int32)
        mask = np.full((max_tokens, max_tokens), NEG_INF, np.float32)

        def fill(row, cols=None):
            cols = row + 1 if cols is None else cols
            mask[row, :cols] = 0.0

        i = 0
        ids[i] = self.bos_token_id
        fill(i)
        i += 1
        if text:
            for word in _PRETOKENIZE.findall(text.lower()):
                chars = [c for c in word[:-1]] + [word[-1] + "</w>"]
                for tok in self.apply_bpe(chars):
                    ids[i] = self.vocab.get(tok, self.unk_token_id)
                    fill(i)
                    i += 1
                    if i >= max_tokens - 1:
                        break
                if i >= max_tokens - 1:
                    break
        ids[i] = self.eos_token_id
        fill(i)
        for row in range(i + 1, max_tokens):
            fill(row, i + 1)
        return ClipTextTokens(ids, mask)


def clip_tokenizer_init(file: GGUFFile) -> ClipTokenizer:
    """(reference clip_tokenizer_init, sam3.h:195-216)."""
    tokens = file.get_array("tokenizer.ggml.tokens")
    merges = file.get_array("tokenizer.ggml.merges")
    vocab = {t: i for i, t in enumerate(tokens)}
    rank = {}
    for i, m in enumerate(merges):
        a, _, b = m.partition(" ")
        rank[(a, b)] = i
    return ClipTokenizer(
        vocab=vocab,
        bpe_rank=rank,
        bos_token_id=file.get_int("tokenizer.ggml.bos_token_id", 49406),
        eos_token_id=file.get_int("tokenizer.ggml.eos_token_id", 49407),
        pad_token_id=file.get_int("tokenizer.ggml.padding_token_id", 49407),
        unk_token_id=file.get_int("tokenizer.ggml.unknown_token_id", 49407),
    )


# ---------------------------------------------------------------------------
# CLIP text encoder (reference sam3.h:219-288)
# ---------------------------------------------------------------------------


def clip_text_embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    tok = p.weight("token_embedding.weight")[ids.long()]
    pos = p.weight("position_embedding.weight")[: ids.shape[-1]]
    return tok + pos


def clip_attention(p: Params, x: torch.Tensor, mask: torch.Tensor, n_heads: int = 16) -> torch.Tensor:
    """With tp-sharded q/k/v (SAM3_TP_RULES) this rank attends over its own
    heads, and the heads are gathered before the replicated out_proj."""
    b, t, c = x.shape
    hd = c // n_heads
    n_heads = local_heads(p["q_proj"], n_heads)

    def proj(pp):
        return linear(pp, x).reshape(b, t, n_heads, hd).permute(0, 2, 1, 3)

    q, k, v = proj(p["q_proj"]), proj(p["k_proj"]), proj(p["v_proj"])
    o = attention_core(q, k, v, mask, 1.0 / math.sqrt(hd)).permute(0, 2, 1, 3).reshape(b, t, n_heads * hd)
    return linear(p["out_proj"], gather_for(o, p["q_proj"], p["out_proj"]))


def clip_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def clip_encoder_layer(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = x + clip_attention(p["self_attn"], layer_norm(p["layer_norm1"], x), mask)
    return x + clip_mlp(p["mlp"], layer_norm(p["layer_norm2"], x))


def clip_encode_text(p: Params, ids: torch.Tensor, mask: torch.Tensor, n_layers: int = 24) -> torch.Tensor:
    """(reference clip_encode_text, sam3.h:277-282). ids: (B, T); mask: the
    tokenizer's (T, T) 0/-inf mask, added to the f32 logits."""
    x = clip_text_embed(p["embeddings"], ids)
    for i in range(n_layers):
        x = clip_encoder_layer(p["encoder"]["layers"][i], x, mask)
    return layer_norm(p["final_layer_norm"], x)


def encode_text(p: Params, ids: torch.Tensor, mask: torch.Tensor, n_layers: int = 24) -> torch.Tensor:
    """(reference encode_text, sam3.h:284-288). Text projection is optional
    (the converter skips it, convert.py convert_sam3)."""
    x = clip_encode_text(p["te.text_model"], ids, mask, n_layers)
    if p.has("text_projection.weight"):
        x = linear(p["text_projection"], x)
    return x


# ---------------------------------------------------------------------------
# Vision encoder (reference sam3.h:291-515)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sam3VitParams:
    image_size: int = 1008
    patch_size: int = 14
    window_size: int = 24
    n_layers: int = 32
    n_heads: int = 16
    global_attn_indexes: tuple[int, ...] = (7, 15, 23, 31)
    scale_factors: tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)


def vision_embed(p: Params, image: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Patch conv + tiled abs position embeddings (sam3.h:313-338).
    image: (B, H, W, 3) -> (B, hp, wp, C). The table is added in x's type,
    tiled when the patch grid differs from the table's side."""
    x = conv_2d(p["patch_embeddings.projection"], image, patch_size)
    b, hp, wp, c = x.shape
    pos = p.weight("position_embeddings")  # (1, n, C) or (n, C)
    pos = pos.reshape(-1, pos.shape[-1])
    pre = int(math.sqrt(pos.shape[0]) + 0.5)
    grid = pos.reshape(pre, pre, c)
    if (wp, hp) != (pre, pre):
        grid = grid.repeat((hp + pre - 1) // pre, (wp + pre - 1) // pre, 1)[:hp, :wp]
    return x + grid[None].to(x.dtype)


@lru_cache(maxsize=32)
def _rope_tables(n_pos: int, n_rows: int, head_dim: int, scale: float):
    """cos/sin tables for 2D RoPE in row-major token order: x positions for
    the first half of head_dim, y for the second (sam3.h:391-438)."""
    pos = np.arange(n_pos)
    px = (pos % n_rows).astype(np.float64) * scale
    py = (pos // n_rows).astype(np.float64) * scale
    return _rope_tables_pos(px, py, head_dim)


def _rope_tables_pos(px: np.ndarray, py: np.ndarray, head_dim: int):
    """cos/sin tables for explicit (possibly permuted) token positions,
    built in float64 and stored as float32."""
    base = 10000.0
    d2 = head_dim // 2
    freqs = base ** (-np.arange(0, d2, 2, dtype=np.float64) / d2)
    ang_x = px.astype(np.float64)[:, None] * freqs[None, :]
    ang_y = py.astype(np.float64)[:, None] * freqs[None, :]
    return (
        np.cos(ang_x).astype(np.float32),
        np.sin(ang_x).astype(np.float32),
        np.cos(ang_y).astype(np.float32),
        np.sin(ang_y).astype(np.float32),
    )


@device_cache(maxsize=64)
def _rope_tensors(n_pos: int, n_rows: int, head_dim: int, scale: float, device: torch.device,
                  dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """_rope_tables on ``device`` in ``dtype`` (cast from the f32 tables, as
    the JAX package casts them to x's type), made once per key."""
    return tuple(torch.from_numpy(a).to(device).to(dtype) for a in _rope_tables(n_pos, n_rows, head_dim, scale))


def _rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs (ggml ROPE_TYPE_NORMAL). x: (..., T, d)."""
    x0 = x[..., 0::2]
    x1 = x[..., 1::2]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(x.shape)


def _apply_rope_tables(x: torch.Tensor, tables, layout: str) -> torch.Tensor:
    """Apply RoPE from (cx, sx, cy, sy) (T, hd/4) tables in x's type and on
    its device. Layout 'bhtd' takes x (B, heads, T, hd), 'bthd' x (B, T,
    heads, hd), the tables broadcast over the heads axis."""
    hd = x.shape[-1]
    cx, sx, cy, sy = tables
    if layout != "bhtd":
        cx, sx, cy, sy = (t[:, None] for t in (cx, sx, cy, sy))
    first = _rotate_pairs(x[..., : hd // 2], cx, sx)
    second = _rotate_pairs(x[..., hd // 2 :], cy, sy)
    return torch.cat([first, second], dim=-1)


def apply_rope_2d(x: torch.Tensor, n_rows: int, scale: float = 1.0, layout: str = "bhtd") -> torch.Tensor:
    """2D RoPE. layout 'bhtd': x is (B, heads, T, head_dim); layout 'bthd':
    x is (B, T, heads, head_dim), the transpose-free attention layout."""
    t = x.shape[-2] if layout == "bhtd" else x.shape[1]
    return _apply_rope_tables(x, _rope_tensors(t, n_rows, x.shape[-1], scale, x.device, x.dtype), layout)


def rope_attention(p: Params, x: torch.Tensor, n_heads: int, n_rows: int, scale: float,
                   flash: bool = False) -> torch.Tensor:
    """(reference rope_attention, sam3.h:440-455). x: (B, T, C).

    Window layers (flash=False) run the JAX package's einsum form: q, k and
    v stay (B, T, H, hd), RoPE broadcasts over the heads, the logits are
    rounded to x's type (the scale too) before an f32 softmax, and the
    probabilities are cast back to x's type for P V. Global layers
    (flash=True) keep (B, H, T, hd) for ``attention``, whose "cuda" route
    is the flash kernel on a CUDA tensor."""
    b, t, c = x.shape
    hd = c // n_heads
    # with tp-sharded q/k/v this rank attends over its own heads; the
    # row-parallel o_proj sums the heads over the tp group
    n_heads = local_heads(p["q_proj"], n_heads)

    if flash:
        def proj(pp):
            return linear(pp, x).reshape(b, t, n_heads, hd).permute(0, 2, 1, 3)

        q, k, v = proj(p["q_proj"]), proj(p["k_proj"]), proj(p["v_proj"])
        q = apply_rope_2d(q, n_rows, scale)
        k = apply_rope_2d(k, n_rows, scale)
        return attention(p["o_proj"], q, k, v, None, 1.0 / math.sqrt(hd), flash=flash)

    def proj(pp):
        return linear(pp, x).reshape(b, t, n_heads, hd)

    q, k, v = proj(p["q_proj"]), proj(p["k_proj"]), proj(p["v_proj"])
    q = apply_rope_2d(q, n_rows, scale, layout="bthd")
    k = apply_rope_2d(k, n_rows, scale, layout="bthd")
    # the scale rounded to x's type first, as the JAX package's jnp.asarray(s, x.dtype)
    s = torch.tensor(1.0 / math.sqrt(hd), dtype=x.dtype).item()
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, n_heads * hd)
    return linear(p["o_proj"], o)


def vision_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def _vision_layer_tokens(p: Params, x: torch.Tensor, n_heads: int, n_rows: int, rope_scale: float,
                         flash: bool = False) -> torch.Tensor:
    """Pre-norm attention + MLP on token tensors (B*, T, C): a global
    layer's body (vision_layer), and the JAX package's scan trunk's."""
    y = layer_norm(p["layer_norm1"], x)
    y = rope_attention(p["attention"], y, n_heads, n_rows, rope_scale, flash=flash)
    x = x + y
    return x + vision_mlp(p["mlp"], layer_norm(p["layer_norm2"], x))


def vision_layer(p: Params, x: torch.Tensor, window_size: int, n_heads: int, n_rows: int, rope_scale: float,
                 flash: bool = False) -> torch.Tensor:
    """(reference vision_layer, sam3.h:457-483). x: (B, h, w, C). A window
    layer normalizes, then partitions (zero-padded windows); a global layer
    (window_size 0) runs on the (B, h*w, C) view."""
    b, h, w, c = x.shape
    if window_size <= 0:
        y = _vision_layer_tokens(p, x.reshape(b, h * w, c), n_heads, n_rows, rope_scale, flash=flash)
        return y.reshape(b, h, w, c)
    y = window_partition(layer_norm(p["layer_norm1"], x), window_size)
    y = rope_attention(p["attention"], y, n_heads, n_rows, rope_scale, flash=flash)
    x = x + window_reverse(y, w, h, window_size)
    return x + vision_mlp(p["mlp"], layer_norm(p["layer_norm2"], x))


def vision_transformer(p: Params, image: torch.Tensor, vp: Sam3VitParams, flash: bool = False) -> torch.Tensor:
    """(reference vision_transformer, sam3.h:485-515).
    image: (B, H, W, 3) -> (B, hp, wp, C). ``flash`` routes the global
    layers (5184 tokens at 1008 px) to attention's flash route."""
    x = vision_embed(p["embeddings"], image, vp.patch_size)
    x = layer_norm(p["layer_norm"], x)
    n_rows_global = image.shape[2] // vp.patch_size
    scale_global = float(vp.window_size) / float(vp.image_size // vp.patch_size)
    for i in range(vp.n_layers):
        is_global = i in vp.global_attn_indexes
        window = 0 if is_global else vp.window_size
        n_rows = n_rows_global if is_global else vp.window_size
        scale = scale_global if is_global else 1.0
        x = vision_layer(p["layers"][i], x, window, vp.n_heads, n_rows, scale, flash=is_global and flash)
    return x


# ---------------------------------------------------------------------------
# FPN neck (reference sam3.h:517-613)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=16)
def sine_position_embedding(width: int, height: int, n_pos_feats: int, normalize: bool = True) -> np.ndarray:
    """(reference sine_position_embedding, sam3.h:524-563).
    Returns (height, width, 2*n_pos_feats) f32: y features then x features."""
    temperature, scale, eps = 10000.0, 2.0 * math.pi, 1e-6
    k = np.arange(n_pos_feats)
    dim_t = temperature ** (2.0 * (k // 2) / n_pos_feats)
    y = np.arange(1, height + 1, dtype=np.float64)
    x = np.arange(1, width + 1, dtype=np.float64)
    if normalize:
        y = y / (height + eps) * scale
        x = x / (width + eps) * scale
    yv = y[:, None] / dim_t[None, :]  # (H, F)
    xv = x[:, None] / dim_t[None, :]  # (W, F)
    y_feat = np.where(k % 2 == 0, np.sin(yv), np.cos(yv))  # (H, F)
    x_feat = np.where(k % 2 == 0, np.sin(xv), np.cos(xv))  # (W, F)
    out = np.empty((height, width, 2 * n_pos_feats), np.float32)
    out[:, :, :n_pos_feats] = y_feat[:, None, :]
    out[:, :, n_pos_feats:] = x_feat[None, :, :]
    return out


@device_cache(maxsize=16)
def _sine_position_tensor(width: int, height: int, n_pos_feats: int, device: torch.device) -> torch.Tensor:
    """sine_position_embedding as an f32 tensor on ``device``, uploaded once
    per extent (85 MB at the x4 level of a 1008 px image)."""
    return torch.from_numpy(sine_position_embedding(width, height, n_pos_feats)).to(device)


def fpn_layer(p: Params, x: torch.Tensor, index: int) -> torch.Tensor:
    """(reference fpn_layer, sam3.h:566-587)."""
    if index == 0:
        x = conv_transpose_2d(p["scale_layers"][0], x, 2)
        x = gelu(x)
        x = conv_transpose_2d(p["scale_layers"][2], x, 2)
    elif index == 1:
        x = conv_transpose_2d(p["scale_layers"][0], x, 2)
    elif index == 3:
        x = max_pool_2d(x, 2, 2)
    x = conv_2d(p["proj1"], x, 1, 0)
    return conv_2d(p["proj2"], x, 1, 1)


class VisionOutput(NamedTuple):
    fpn_hidden_states: list
    fpn_position_encoding: list


def vision_neck(p: Params, x: torch.Tensor) -> VisionOutput:
    """(reference vision_neck, sam3.h:589-602). x: (B, h, w, C)."""
    hidden, pe = [], []
    for i in range(4):
        h = fpn_layer(p["fpn_layers"][i], x, i)
        hidden.append(h)
        pe.append(_sine_position_tensor(h.shape[2], h.shape[1], h.shape[3] // 2, h.device))
    return VisionOutput(hidden, pe)


def encode_vision(p: Params, image: torch.Tensor, vp: Sam3VitParams = Sam3VitParams(),
                  flash: bool = False) -> VisionOutput:
    """(reference encode_vision, sam3.h:604-613): the spatial trunk, then
    the neck. image: (B, H, W, 3) in the model's type."""
    return vision_neck(p["neck"], vision_transformer(p["backbone"], image, vp, flash=flash))


def sam3_process_input(img: Image, image_size: int = 1008) -> np.ndarray:
    """Resize to the model's square input, map to [-1, 1] (sam3.h:619-622)."""
    resized = image_scale(img, (image_size, image_size), preprocess_scale_method())
    out = image_u8_to_f32(resized, ImageFormat.rgb_f32, offset=(-0.5,) * 4, scale=(2.0,) * 4)
    return out.data


def sam3_heads(vp: Sam3VitParams, text_heads: int = 16):
    """``shard_params``' ``heads``: the head count of a SAM3 attention
    weight (vision ``.attention.``, text ``.self_attn.``), None for any
    other."""

    def heads(name: str) -> int | None:
        if ".attention." in name:
            return vp.n_heads
        return text_heads if ".self_attn." in name else None

    return heads


class Sam3Model:
    """High-level handle for the work-in-progress SAM3 scope: tokenizer,
    text encoder, vision encoder and neck (no mask decoder yet, matching
    the reference).

    ``params``: torch tensors under the GGUF names (``det.ve.*``,
    ``det.te.*``) on ``device``; floats are cast to the device's float
    policy here, once. The text depth is counted from the weights, the
    flash route read from ``device.flags``, and both encoders run on
    ``device``.

    ``mesh``: a (dp, tp) mesh of parallel/ (every rank builds the model from
    its own copy of the weights): the vision and text attentions and MLPs
    are tp-sharded (SAM3_TP_RULES, whole heads a rank), and every rank of
    the mesh runs each encode (rank 0 calls, the other ranks follow,
    parallel/runner.py). ``sp`` or ``pp`` > 1 raises: they need the scan
    trunk."""

    def __init__(self, params: dict[str, torch.Tensor], tokenizer: ClipTokenizer, max_tokens: int, device: Device,
                 vp: Sam3VitParams | None = None, mesh=None):
        self.params = cast_float_params(params, device.preferred_float_type)
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.device = device
        self.dtype = device.preferred_float_type
        self.flash = bool(device.flags & BuildFlag.flash_attention)
        self.vp = vp or Sam3VitParams()
        self.mesh = mesh
        # the text depth from the weights, not hardcoded (reduced checkpoints)
        n_text = 0
        while any(k.startswith(f"det.te.text_model.encoder.layers.{n_text}.") for k in params):
            n_text += 1
        self.n_text_layers = n_text
        if mesh is not None:
            shape = mesh_shape(mesh)
            if shape["sp"] > 1 or shape["pp"] > 1:
                raise_error(
                    "SAM3 sequence / pipeline parallelism (mesh sp {} / pp {}) needs the window-major scan "
                    "trunk (vision_transformer_scan), which the port has not taken yet",
                    shape["sp"], shape["pp"],
                )
            self.params = mesh_params(self.params, mesh, device, SAM3_TP_RULES, heads=sam3_heads(self.vp))
        self._calls = mesh_entries(self, mesh, encode_text=self._encode_text, encode_vision=self._encode_vision)

    def encode_text(self, text: str) -> torch.Tensor:
        """One prompt -> (1, max_tokens, C) in the model's type, on its
        device."""
        toks = self.tokenizer.tokenize(text, self.max_tokens)
        dev = self.device.torch_device
        ids = torch.from_numpy(toks.token_ids[None]).to(dev)
        mask = torch.from_numpy(toks.attention_mask).to(dev)
        return self._calls["encode_text"](ids, mask)

    def _encode_text(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """:meth:`encode_text` of tokenized input: ``ids`` (1, t) int32 and
        ``mask`` (t, t) f32 on the device (the exported form, export.py)."""
        with torch.inference_mode():
            return encode_text(Params(self.params)["det"], ids, mask, n_layers=self.n_text_layers)

    def encode_vision(self, image: Image) -> tuple[torch.Tensor, ...]:
        """One image at any extent -> the four FPN levels, (1, 4s, 4s, 256)
        down to (1, s/2, s/2, 256) for s = image_size / patch_size."""
        x = sam3_process_input(image, self.vp.image_size)
        x = torch.from_numpy(x[None]).to(self.device.torch_device, self.dtype)
        return self._calls["encode_vision"](x)

    def _encode_vision(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """:meth:`encode_vision` of processed images: ``x`` (N, s, s, 3) in
        the model's type on the device (the exported form, export.py)."""
        with torch.inference_mode():
            return tuple(encode_vision(Params(self.params)["det.ve"], x, self.vp, flash=self.flash).fpn_hidden_states)


def sam3_load_model(filepath: str, device: Device | None = None, mesh=None) -> Sam3Model:
    """Load a SAM3 GGUF onto ``device`` (default: the CUDA device; without
    one, backend_init raises). Quantized tensors expand to floats at load:
    there is no ``keep_quantized`` path, as in the JAX package. ``mesh``:
    tp-shard the weights over a mesh of parallel/ (SAM3_TP_RULES)."""
    device = device or backend_init()
    file = model_load(filepath)
    tokenizer = clip_tokenizer_init(file)
    max_tokens = file.get_int("sam3.tokenizer.max_length", 32)
    params = params_from_numpy(load_weights(file, as_numpy=True), device.torch_device, device.preferred_float_type)
    return Sam3Model(params, tokenizer, max_tokens, device, mesh=mesh)
