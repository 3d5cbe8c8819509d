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

The vision trunk runs in WINDOW-MAJOR token order whenever the patch grid
divides into windows (always at 1008 px: 72 = 3 x 24), as the JAX package's
``vision_transformer_scan`` does: one permute in after the embedding and
one out before the neck, a window partition that is a free view, and the
global layers attending over the window-major tokens with RoPE tables
permuted to match. The 28 window layers' weights are stacked once
(``sam3_pack_vision_weights``; ``Sam3Model`` then drops their flat copies)
and each run of window layers loops over per-layer views of the stack. The
spatial trunk (``vision_transformer``) stays for grids that do not divide.

With a ``mesh`` (parallel/) both encoders run tensor-parallel
(SAM3_TP_RULES; the stack column- or row-sharded one axis right,
``sam3_shard_vision``). A mesh ``sp`` axis > 1 runs the trunk
sequence-parallel: each sp rank keeps its share of the windows through the
window layers with no communication, and in each global layer attends with
its own queries against the keys and values all-gathered over sp (on the
card through the flash kernel, whose Tq may differ from Tk). A ``pp`` axis
is the pipeline trunk's (``encode_vision_pipelined`` over
``parallel/pipeline.py``): uniform stages of window layers and a global
layer, each pp rank holding only its stages' weights
(``sam3_pipeline_weights``); ``Sam3Model``'s own encodes replicate over pp,
as the JAX package's programs do.
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
from ..core.graph import ForwardGraphs, device_cache
from ..core.params import Params
from ..core.weights import cast_float_params, load_weights, params_from_numpy
from ..core.errors import raise_error
from ..parallel.runner import mesh_entries
from ..parallel.sharding import SAM3_TP_RULES, mesh_params, mesh_shape
from ..image import Image, ImageFormat, image_scale, image_u8_to_f32, preprocess_scale_method
from ..ops import (attention, attention_core, attention_route, conv_2d, conv_transpose_2d, gelu, layer_norm, linear,
                   max_pool_2d)
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
    "vision_transformer_scan",
    "vision_transformer_pp",
    "vision_trunk",
    "sam3_window_runs",
    "sam3_pack_vision_weights",
    "sam3_shard_vision",
    "sam3_pipeline_weights",
    "window_layers",
    "sine_position_embedding",
    "fpn_layer",
    "VisionOutput",
    "vision_levels",
    "vision_neck",
    "encode_vision",
    "encode_vision_pipelined",
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


def _einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The JAX package's window form of attention on (B, T, H, hd) q and
    (B, Tk, H, hd) k and v: the logits rounded to q's type (the scale too)
    before an f32 softmax, the probabilities cast back for P V. Returns (B,
    T, H, hd)."""
    # the scale rounded to q's type first, as the JAX package's jnp.asarray(s, x.dtype)
    s = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype).item()
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * s
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def rope_attention(p: Params, x: torch.Tensor, n_heads: int, n_rows: int, scale: float,
                   flash: bool = False, tables=None) -> torch.Tensor:
    """(reference rope_attention, sam3.h:440-455). x: (B, T, C).

    Window layers (flash=False) run the JAX package's einsum form
    (:func:`_einsum_attention`): q, k and v stay (B, T, H, hd) and RoPE
    broadcasts over the heads. Global layers (flash=True) keep (B, H, T,
    hd) for ``attention``, whose "cuda" route is the flash kernel on a CUDA
    tensor. ``tables`` overrides the RoPE tables (cx, sx, cy, sy), each (T,
    hd/4) on x's device in x's type: the window-major trunk's permuted
    positions."""
    b, t, c = x.shape
    hd = c // n_heads
    # with tp-sharded q/k/v this rank attends over its own heads; the
    # row-parallel o_proj sums the heads over the tp group
    n_heads = local_heads(p["q_proj"], n_heads)

    if flash:
        def proj(pp):
            return linear(pp, x).reshape(b, t, n_heads, hd).permute(0, 2, 1, 3)

        q, k, v = proj(p["q_proj"]), proj(p["k_proj"]), proj(p["v_proj"])
        if tables is None:
            q, k = apply_rope_2d(q, n_rows, scale), apply_rope_2d(k, n_rows, scale)
        else:
            q, k = _apply_rope_tables(q, tables, "bhtd"), _apply_rope_tables(k, tables, "bhtd")
        return attention(p["o_proj"], q, k, v, None, 1.0 / math.sqrt(hd), flash=flash)

    def proj(pp):
        return linear(pp, x).reshape(b, t, n_heads, hd)

    q, k, v = proj(p["q_proj"]), proj(p["k_proj"]), proj(p["v_proj"])
    if tables is None:
        q, k = apply_rope_2d(q, n_rows, scale, layout="bthd"), apply_rope_2d(k, n_rows, scale, layout="bthd")
    else:
        q, k = _apply_rope_tables(q, tables, "bthd"), _apply_rope_tables(k, tables, "bthd")
    return linear(p["o_proj"], _einsum_attention(q, k, v).reshape(b, t, n_heads * hd))


def vision_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def _vision_layer_tokens(p: Params, x: torch.Tensor, n_heads: int, n_rows: int, rope_scale: float,
                         flash: bool = False, tables=None) -> torch.Tensor:
    """Pre-norm attention + MLP on token tensors (B*, T, C): the layer body
    of the spatial trunk's global layers (vision_layer) and of every layer
    of the window-major trunks."""
    y = layer_norm(p["layer_norm1"], x)
    y = rope_attention(p["attention"], y, n_heads, n_rows, rope_scale, flash=flash, tables=tables)
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
# The window-major trunk (JAX vision_tpu/models/sam3.py:405-765)
# ---------------------------------------------------------------------------
#
# The spatial trunk above partitions (B, h, w, C) into windows and back in
# every one of the 28 window layers: 56 copies of the whole activation at
# 1008^2. The window-major trunk keeps the activation as (B*nw, win^2, C)
# from the embedding to the neck: a window layer's partition is a view,
# and a global layer attends over the window-major tokens as they are
# (attention does not depend on the order of the tokens), with RoPE tables
# whose rows follow that order. The window layers' weights are stacked into
# (n_window_layers, ...) tensors, and each run of window layers loops over
# per-layer views of the stack (the JAX package's lax.scan over it).

_SAM3_LAYER_LEAVES = tuple(
    f"{mod}.{leaf}"
    for mod in ("layer_norm1", "layer_norm2", "attention.q_proj", "attention.k_proj",
                "attention.v_proj", "attention.o_proj", "mlp.fc1", "mlp.fc2")
    for leaf in ("weight", "bias")
)
# Sam3Model keeps its stack in its params under det.ve.backbone.<WINDOW_STACK>.<leaf>
WINDOW_STACK = "window_stack"


def sam3_window_runs(vp: Sam3VitParams) -> list[tuple[str, int, int]]:
    """Trunk schedule: [("win", start, count) | ("glb", layer_idx, 1), ...]
    where start/count index the stacked window-layer arrays."""
    runs: list[tuple[str, int, int]] = []
    w = 0
    for i in range(vp.n_layers):
        if i in vp.global_attn_indexes:
            runs.append(("glb", i, 1))
        else:
            if runs and runs[-1][0] == "win":
                runs[-1] = ("win", runs[-1][1], runs[-1][2] + 1)
            else:
                runs.append(("win", w, 1))
            w += 1
    return runs


def _window_layer_indexes(vp: Sam3VitParams) -> list[int]:
    return [i for i in range(vp.n_layers) if i not in vp.global_attn_indexes]


def sam3_pack_vision_weights(params: dict, vp: Sam3VitParams = Sam3VitParams(), prefix: str = "backbone.") -> dict:
    """Stack the window layers' weights into (n_window_layers, ...) tensors
    for the window-major trunk: one ``torch.stack`` a leaf, on the weights'
    device. ``params`` holds flat dotted names (unplaced tensors); the
    embeddings, norms, global layers and the neck stay in it (the stack only
    adds copies). Returns {leaf: stacked tensor}, leaves as
    ``_SAM3_LAYER_LEAVES`` names them."""
    win_idx = _window_layer_indexes(vp)
    return {leaf: torch.stack([params[f"{prefix}layers.{i}.{leaf}"] for i in win_idx]) for leaf in _SAM3_LAYER_LEAVES}


_STACK_COLUMN = re.compile(r"(q_proj|k_proj|v_proj|fc1)\.(weight|bias)$")
_STACK_ROW = re.compile(r"(o_proj|fc2)\.weight$")


def _stack_tp_dim(leaf: str, shape: tuple, tp: int, n_heads: int) -> int | None:
    """The dimension of a stacked leaf sharded over tp: SAM3_TP_RULES' one
    axis right (q/k/v/fc1 column-parallel on dim 1, o_proj/fc2 row-parallel
    on dim 2), where it divides and an attention's heads divide over tp."""
    if tp <= 1 or (leaf.startswith("attention.") and n_heads % tp):
        return None
    if _STACK_COLUMN.search(leaf) and shape[1] % tp == 0:
        return 1
    if _STACK_ROW.search(leaf) and shape[2] % tp == 0:
        return 2
    return None


def _shard_stack(win_stack: dict, mesh, vp: Sam3VitParams) -> dict:
    """The stacked window weights placed on ``mesh``: a leaf _stack_tp_dim
    shards is a DTensor of this rank's shard, the rest stay whole."""
    from torch.distributed.tensor import DTensor, Shard

    from ..parallel.sharding import mesh_tp, replicate

    tp = mesh_tp(mesh)
    rank = mesh.get_local_rank("tp") if tp > 1 and mesh.get_coordinate() is not None else 0
    out = {}
    for leaf, v in win_stack.items():
        dim = _stack_tp_dim(leaf, tuple(v.shape), tp, vp.n_heads)
        if dim is None:
            out[leaf] = v
            continue
        placements = replicate(mesh)
        placements[mesh.mesh_dim_names.index("tp")] = Shard(dim)
        out[leaf] = DTensor.from_local(v.chunk(tp, dim)[rank].contiguous(), mesh, placements, run_check=False)
    return out


def sam3_shard_vision(params: dict, win_stack: dict, mesh, vp: Sam3VitParams = Sam3VitParams()):
    """Place SAM3 weights on a mesh of parallel/ (every rank passes its own
    full copy and keeps its shard). The flat params get Megatron tp through
    SAM3_TP_RULES (column-parallel q/k/v and fc1, row-parallel o_proj and
    fc2: one all-reduce over tp after each); the stacked window weights get
    the same shards one axis right (the leading axis is the layer). As
    ``mesh_params`` leaves them: tp-sharded tensors are DTensors, the rest
    the rank's plain tensors. Returns ``(params, win_stack)`` re-placed."""
    from ..parallel.sharding import local_params, mesh_tp, shard_params

    if mesh_tp(mesh) == 1:
        placed = dict(params)
    else:
        placed = local_params(shard_params(params, mesh, SAM3_TP_RULES, heads=sam3_heads(vp)))
    return placed, _shard_stack(win_stack, mesh, vp)


def window_layers(win_stack: dict) -> list[dict]:
    """Per-layer views of the stacked window weights: [{leaf: layer i's
    tensor}] in stack order. A tp-sharded leaf's view is a DTensor of its
    layer (the shard one axis left), so that ``linear`` sees its placement.
    A caller that encodes many images makes these once (each DTensor view
    is built on the host, one a leaf a layer)."""
    from torch.distributed.tensor import DTensor, Shard

    from ..parallel.tp import is_dtensor

    n = next(iter(win_stack.values())).shape[0]
    layers: list[dict] = [{} for _ in range(n)]
    for leaf, v in win_stack.items():
        if is_dtensor(v):
            placements = [Shard(pl.dim - 1) if pl.is_shard() else pl for pl in v.placements]
            views = [DTensor.from_local(t, v.device_mesh, placements, run_check=False) for t in v.to_local().unbind(0)]
        else:
            views = v.unbind(0)
        for layer, t in zip(layers, views):
            layer[leaf] = t
    return layers


def _window_major_positions(nwh: int, nww: int, win: int) -> tuple[np.ndarray, np.ndarray]:
    """The grid column and row of every token in window-major order (image
    windows row by row, then each window's tokens row by row)."""
    ii, jj, rr, ss = np.meshgrid(np.arange(nwh), np.arange(nww), np.arange(win), np.arange(win), indexing="ij")
    return (jj * win + ss).reshape(-1), (ii * win + rr).reshape(-1)


@device_cache(maxsize=16)
def _window_major_tables(nwh: int, nww: int, win: int, head_dim: int, scale: float, device: torch.device,
                         dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """The global layers' RoPE tables (cx, sx, cy, sy), (nwh*nww*win^2,
    hd/4) each: full-grid positions times ``scale`` in window-major token
    order (JAX sam3.py:552-561), on ``device`` in ``dtype``, made once per
    key."""
    px, py = _window_major_positions(nwh, nww, win)
    tables = _rope_tables_pos(px.astype(np.float64) * scale, py.astype(np.float64) * scale, head_dim)
    return tuple(torch.from_numpy(a).to(device).to(dtype) for a in tables)


@device_cache(maxsize=16)
def _window_rows(nwh: int, nww: int, win: int, head_dim: int, scale: float, first: int, count: int,
                 device: torch.device, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    """The rows of _window_major_tables of ``count`` windows from window
    ``first`` of a (B*nw)-window batch (window g is window g % nw of its
    image): a sequence-parallel rank's tokens."""
    nw, tok = nwh * nww, win * win
    rows = ((np.arange(first, first + count) % nw)[:, None] * tok + np.arange(tok)[None]).reshape(-1)
    index = torch.from_numpy(rows).to(device)
    return tuple(t.index_select(0, index) for t in _window_major_tables(nwh, nww, win, head_dim, scale, device, dtype))


def _to_windows(x: torch.Tensor, win: int) -> torch.Tensor:
    """(B, hp, wp, C) -> window-major (B*nw, win*win, C): the trunk's one permute in."""
    b, hp, wp, c = x.shape
    x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (hp // win) * (wp // win), win * win, c)


def _from_windows(x: torch.Tensor, b: int, hp: int, wp: int, win: int) -> torch.Tensor:
    """Window-major (B*nw, win*win, C) -> (B, hp, wp, C): the one permute out."""
    c = x.shape[-1]
    x = x.reshape(b, hp // win, wp // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, c)


def _sp_axis(mesh) -> int:
    return 1 if mesh is None else mesh_shape(mesh)["sp"]


def _gather_sp(x: torch.Tensor, group, sp: int) -> torch.Tensor:
    """x's rows (its leading axis) all-gathered over the sp group, in sp order."""
    import torch.distributed as dist

    out = x.new_empty((x.shape[0] * sp, *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _sp_global_layer(p: Params, x: torch.Tensor, n_heads: int, tables, group, sp: int, nw: int, first: int,
                     kernel: bool) -> torch.Tensor:
    """One global layer on a sequence-parallel rank's windows x (n, tok, C),
    windows ``first``..``first + n - 1`` of the (B*nw)-window batch: q, k
    and v of its own tokens, RoPE with its rows of the tables, K and V
    all-gathered over sp, and each image's queries against that image's
    keys (a shard may hold windows of two images). ``kernel``: attend
    through the flash kernel (Tq, the image's queries on this rank, differs
    from Tk), else in the einsum form."""
    n, tok, c = x.shape
    hd = c // n_heads
    a = p["attention"]
    heads = local_heads(a["q_proj"], n_heads)
    y = layer_norm(p["layer_norm1"], x).reshape(1, n * tok, c)

    def proj(pp):
        return linear(pp, y).reshape(1, n * tok, heads, hd)

    q = _apply_rope_tables(proj(a["q_proj"]), tables, "bthd")
    k = _apply_rope_tables(proj(a["k_proj"]), tables, "bthd")
    v = proj(a["v_proj"])
    # every rank's K and V: (B*nw*tok, heads, hd) in window order, one image a block of nw*tok rows
    k_all = _gather_sp(k.reshape(n * tok, heads, hd), group, sp).reshape(-1, nw * tok, heads, hd)
    v_all = _gather_sp(v.reshape(n * tok, heads, hd), group, sp).reshape(-1, nw * tok, heads, hd)
    if kernel:
        from ..ops.cuda.flash_attention import flash_attention

        k_all, v_all = (t.permute(0, 2, 1, 3).contiguous() for t in (k_all, v_all))
    outs = []
    for img in range(first // nw, (first + n - 1) // nw + 1):
        lo, hi = max(first, img * nw) - first, min(first + n, (img + 1) * nw) - first
        qs = q[:, lo * tok:hi * tok]
        if kernel:
            o = flash_attention(qs.permute(0, 2, 1, 3).contiguous(), k_all[img:img + 1], v_all[img:img + 1],
                                scale=1.0 / math.sqrt(hd))
            outs.append(o.permute(0, 2, 1, 3))
        else:
            outs.append(_einsum_attention(qs, k_all[img:img + 1], v_all[img:img + 1]))
    o = torch.cat(outs, 1).reshape(1, n * tok, heads * hd)
    x = x + linear(a["o_proj"], o).reshape(n, tok, c)
    return x + vision_mlp(p["mlp"], layer_norm(p["layer_norm2"], x))


def vision_transformer_scan(p: Params, win_stack, image: torch.Tensor, vp: Sam3VitParams, flash: bool = False,
                            mesh=None) -> torch.Tensor:
    """The window-major trunk (see the block comment above): the same math
    as vision_transformer, for a patch grid that divides into whole windows
    (true at the canonical 1008 px / 14 / 24 geometry). image: (B, H, W, 3)
    -> (B, hp, wp, C). ``win_stack``: the stacked window weights
    (sam3_pack_vision_weights, placed by sam3_shard_vision), or their
    per-layer views (window_layers).

    ``mesh`` with an ``sp`` axis > 1 runs the trunk SEQUENCE-PARALLEL, the
    single-image latency axis: every rank of the mesh calls it with the
    same images; each sp rank keeps B*nw/sp windows through the window
    layers with no communication, and each global layer attends with the
    rank's own queries against K and V all-gathered over sp (with
    ``flash``, on the flash route that the whole layer's attention takes:
    the kernel on a CUDA tensor; the JAX package turns flash off there only
    for want of an SPMD rule for its Pallas call). The trunk's output is
    all-gathered over sp
    once, before the neck, which every rank runs whole. sp must divide B*nw
    (9 windows at 1008 px, batch 1: sp in {3, 9}). Composes with tp (local
    heads; the row-parallel products all-reduce over tp only)."""
    x = vision_embed(p["embeddings"], image, vp.patch_size)
    x = layer_norm(p["layer_norm"], x)
    b, hp, wp, c = x.shape
    win = vp.window_size
    if hp % win or wp % win:
        raise_error("vision_transformer_scan: a {}x{} patch grid does not divide into {}x{} windows", hp, wp, win, win)
    nwh, nww = hp // win, wp // win
    nw, tok = nwh * nww, win * win
    x = _to_windows(x, win)
    sp = _sp_axis(mesh)
    first = 0
    if sp > 1:
        if (b * nw) % sp:
            raise ValueError(
                f"sequence parallelism needs sp ({sp}) to divide batch*windows "
                f"({b}*{nw}); at the canonical 1008 px geometry (9 windows, batch 1) "
                "use sp in {3, 9} — on a power-of-2 slice build a sub-mesh, e.g. "
                "make_mesh(6, tp=2, sp=3) on 8 chips (the rest stay idle or serve dp)"
            )
        group = mesh.get_group("sp")
        n_loc = b * nw // sp
        first = mesh.get_local_rank("sp") * n_loc
        x = x[first:first + n_loc]

    # window layers: in-window positions (the standard tables); global
    # layers: full-grid positions in window-major order
    scale_global = float(win) / float(vp.image_size // vp.patch_size)
    hd = c // vp.n_heads
    if sp > 1:
        tables = _window_rows(nwh, nww, win, hd, scale_global, first, x.shape[0], x.device, x.dtype)
        # the route the whole layer's attention_core takes: the flash kernel on
        # a CUDA tensor (at its head dims), its plain version on a CPU one
        kernel = flash and attention_route(nw * tok, False, True, True, hd if x.is_cuda else None) == "cuda"
    else:
        tables = _window_major_tables(nwh, nww, win, hd, scale_global, x.device, x.dtype)
    layers = win_stack if isinstance(win_stack, list) else window_layers(win_stack)
    for kind, a, n in sam3_window_runs(vp):
        if kind == "win":
            for layer in layers[a:a + n]:
                x = _vision_layer_tokens(Params(layer), x, vp.n_heads, win, 1.0)
        elif sp > 1:
            x = _sp_global_layer(p["layers"][a], x, vp.n_heads, tables, group, sp, nw, first, kernel)
        else:
            t = _vision_layer_tokens(p["layers"][a], x.reshape(b, nw * tok, c), vp.n_heads, 0, 0.0, flash=flash,
                                     tables=tables)
            x = t.reshape(b * nw, tok, c)
    if sp > 1:
        x = _gather_sp(x, group, sp)
    return _from_windows(x, b, hp, wp, win)


def _sam3_stage_layout(vp: Sam3VitParams, pp_size: int):
    """Validate that the trunk decomposes into pp-shardable uniform stages;
    returns (n_stages, stages_per_rank, window_layers_per_stage,
    global_layer_indexes)."""
    runs = sam3_window_runs(vp)
    wins = [r for r in runs if r[0] == "win"]
    glbs = [r[1] for r in runs if r[0] == "glb"]
    if not (
        wins
        and len(wins) == len(glbs)
        and all(r[2] == wins[0][2] for r in wins)
        and [k for k, _, _ in runs] == ["win", "glb"] * len(glbs)
    ):
        raise ValueError(f"trunk is not uniform (win^k glb)* stages: {runs}")
    n_stages = len(glbs)
    if n_stages % pp_size:
        raise ValueError(f"{n_stages} stages not divisible by mesh pp={pp_size}")
    return n_stages, n_stages // pp_size, wins[0][2], glbs


def sam3_pipeline_weights(p: Params, win_stack: dict | None, vp: Sam3VitParams, mesh) -> dict:
    """Build and place the stage-stacked trunk weights of the pipeline path:
    win (pp, s_per, per, ...) and glb (pp, s_per, ...), each a DTensor whose
    leading stage axis is sharded over ``pp`` (parallel.pipeline.
    stage_sharding), so that a rank materializes ONLY its own (1, s_per,
    per, ...) and (1, s_per, ...) slices: the HBM-scaling contract that
    lets pp carry trunks larger than one card. ``p``: the backbone Params
    view (its dotted ``layers.{i}`` weights); ``win_stack``: the stacked
    window weights (this rank's slices are copied out of them), or None to
    stack this rank's window layers straight from ``p``'s flat weights,
    never the whole stack."""
    from torch.distributed.tensor import DTensor

    from ..parallel.pipeline import stage_sharding

    pp = mesh_shape(mesh)["pp"]
    _, s_per, per, glbs = _sam3_stage_layout(vp, pp)
    k = mesh.get_local_rank("pp") if mesh.get_coordinate() is not None else 0
    sh = stage_sharding(mesh)

    def place(t: torch.Tensor):
        return DTensor.from_local(t.unsqueeze(0).contiguous(), mesh, sh, run_check=False)

    win_idx = _window_layer_indexes(vp)[k * s_per * per:(k + 1) * s_per * per]
    win = {}
    for leaf in _SAM3_LAYER_LEAVES:
        if win_stack is not None:
            mine = win_stack[leaf][k * s_per * per:(k + 1) * s_per * per].clone()
        else:
            mine = torch.stack([p["layers"][i].weight(leaf) for i in win_idx])
        win[leaf] = place(mine.reshape(s_per, per, *mine.shape[1:]))
    glb = {leaf: place(torch.stack([p["layers"][gi].weight(leaf) for gi in glbs[k * s_per:(k + 1) * s_per]]))
           for leaf in _SAM3_LAYER_LEAVES}
    return {"win": win, "glb": glb}


def vision_transformer_pp(p: Params, win_stack: dict | None, images: torch.Tensor, vp: Sam3VitParams, mesh,
                          flash: bool = False, stage_weights: dict | None = None) -> torch.Tensor:
    """PIPELINE-PARALLEL trunk: GPipe over the window-major trunk's uniform
    stages of ``per`` window layers and one global layer (4 x (7 + 1) at
    ViT-H scale). Each rank of the mesh's ``pp`` axis holds n_stages/pp
    stages' weights (parallel.pipeline.pipeline_apply) and the images flow
    through as microbatches, one activation hand-off a stage step. This is
    the axis that fits trunks LARGER than one card; where the weights fit,
    dp has no bubble (b images fill b + pp - 1 steps here). The same math
    as vision_transformer_scan; the embedding and the neck run on every
    rank. Every rank of the mesh calls it with the same images.

    Pass ``stage_weights`` from :func:`sam3_pipeline_weights` so that each
    rank holds only its stages; with only ``win_stack`` the stage stacks
    are built in the call from the whole stack."""
    from ..parallel.pipeline import pipeline_apply

    pp = mesh_shape(mesh)["pp"]
    _, s_per, per, glbs = _sam3_stage_layout(vp, pp)
    x = vision_embed(p["embeddings"], images, vp.patch_size)
    x = layer_norm(p["layer_norm"], x)
    b, hp, wp, c = x.shape
    win = vp.window_size
    if hp % win or wp % win:
        raise_error("vision_transformer_pp: a {}x{} patch grid does not divide into {}x{} windows", hp, wp, win, win)
    nw, tok = (hp // win) * (wp // win), win * win
    x = _to_windows(x, win).reshape(b, nw, tok, c)
    scale_global = float(win) / float(vp.image_size // vp.patch_size)
    tables = _window_major_tables(hp // win, wp // win, win, c // vp.n_heads, scale_global, x.device, x.dtype)

    if stage_weights is not None:
        lead = {tuple(v.shape)[:1] for t in stage_weights.values() for v in t.values()}
        if lead != {(pp,)}:
            raise ValueError(f"stage_weights leading dims {lead} != mesh pp {pp}")
        weights = stage_weights
    else:
        if win_stack is None:
            raise ValueError("vision_transformer_pp needs stage_weights or win_stack")
        weights = {
            "win": {k: v.reshape(pp, s_per, per, *v.shape[1:]) for k, v in win_stack.items()},
            "glb": {leaf: torch.stack([p["layers"][gi].weight(leaf) for gi in glbs]).reshape(
                pp, s_per, *p["layers"][glbs[0]].weight(leaf).shape) for leaf in _SAM3_LAYER_LEAVES},
        }

    def stage_fn(w, xx):  # xx: one image's (nw, tok, C); w: this rank's (s_per, per, ...) and (s_per, ...) slices
        for s in range(s_per):
            for layer in window_layers({k: v[s] for k, v in w["win"].items()}):
                xx = _vision_layer_tokens(Params(layer), xx, vp.n_heads, win, 1.0)
            t = _vision_layer_tokens(Params({k: v[s] for k, v in w["glb"].items()}), xx.reshape(1, nw * tok, c),
                                     vp.n_heads, 0, 0.0, flash=flash, tables=tables)
            xx = t.reshape(nw, tok, c)
        return xx

    x = pipeline_apply(stage_fn, weights, x, mesh)
    return _from_windows(x.reshape(b * nw, tok, c), b, hp, wp, win)


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


def vision_levels(p: Params, x: torch.Tensor) -> list[torch.Tensor]:
    """The neck's four feature levels of trunk output x (B, h, w, C): (B,
    4h, 4w, C') down to (B, h/2, w/2, C'), without their position
    encodings."""
    return [fpn_layer(p["fpn_layers"][i], x, i) for i in range(4)]


def vision_neck(p: Params, x: torch.Tensor) -> VisionOutput:
    """(reference vision_neck, sam3.h:589-602). x: (B, h, w, C)."""
    hidden = vision_levels(p, x)
    pe = [_sine_position_tensor(h.shape[2], h.shape[1], h.shape[3] // 2, h.device) for h in hidden]
    return VisionOutput(hidden, pe)


def vision_trunk(p: Params, image: torch.Tensor, vp: Sam3VitParams = Sam3VitParams(), flash: bool = False,
                 win_stack=None, mesh=None) -> torch.Tensor:
    """The trunk of :func:`encode_vision`. image: (B, H, W, 3) in the
    model's type -> (B, hp, wp, C). With ``win_stack`` (stacked window
    weights, or their per-layer views: vision_transformer_scan) and a patch
    grid that divides into windows the trunk is the window-major one, else
    the spatial one. ``mesh`` with an ``sp`` axis > 1 runs the trunk
    sequence-parallel, which needs the window-major trunk."""
    hp, wp = image.shape[1] // vp.patch_size, image.shape[2] // vp.patch_size
    if win_stack is not None and hp % vp.window_size == 0 and wp % vp.window_size == 0:
        return vision_transformer_scan(p, win_stack, image, vp, flash=flash, mesh=mesh)
    if _sp_axis(mesh) > 1:
        raise ValueError(
            "sequence parallelism (mesh sp axis) requires the scan trunk: "
            "pass win_stack and a window-divisible patch grid"
        )
    return vision_transformer(p, image, vp, flash=flash)


def encode_vision(p: Params, image: torch.Tensor, vp: Sam3VitParams = Sam3VitParams(), flash: bool = False,
                  win_stack=None, mesh=None) -> VisionOutput:
    """(reference encode_vision, sam3.h:604-613): the trunk
    (:func:`vision_trunk`), then the neck."""
    return vision_neck(p["neck"], vision_trunk(p["backbone"], image, vp, flash, win_stack, mesh))


def encode_vision_pipelined(p: Params, images: torch.Tensor, vp: Sam3VitParams = Sam3VitParams(),
                            flash: bool = False, win_stack: dict | None = None, mesh=None,
                            stage_weights: dict | None = None) -> VisionOutput:
    """Batched encode_vision with the trunk pipeline-parallel over the
    mesh's ``pp`` axis (vision_transformer_pp). ``images``: (B, H, W, 3);
    B is the microbatch count (B >= pp keeps the bubble small). For each
    rank to hold only its stages' weights pass ``stage_weights``, built
    once with :func:`sam3_pipeline_weights`."""
    if mesh is None or (win_stack is None and stage_weights is None):
        raise ValueError(
            "encode_vision_pipelined needs a mesh with a pp axis and "
            "stage_weights (sam3_pipeline_weights) or win_stack"
        )
    x = vision_transformer_pp(p["backbone"], win_stack, images, vp, mesh, flash=flash, stage_weights=stage_weights)
    return vision_neck(p["neck"], x)


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
    ``device``. The vision trunk is the window-major one when the model's
    patch grid divides into windows (always at 1008 px): at its first use
    (at construction under a mesh) the window layers' weights are stacked
    under ``det.ve.backbone.window_stack.*`` and their flat copies dropped
    from ``self.params`` (a new dict; the caller's is never changed), so
    that they are not held twice. Built from the vision weights alone (no
    ``det.te.*``, ``tokenizer`` None) it serves ``forward_u8`` and
    ``encode_vision``, and ``encode_text`` raises.

    ``mesh``: a mesh of parallel/ (every rank builds the model from its own
    copy of the weights): the vision and text attentions and MLPs are
    tp-sharded (SAM3_TP_RULES and the stack one axis right, whole heads a
    rank; sam3_shard_vision), an ``sp`` axis > 1 runs the vision trunk
    sequence-parallel (sp must divide the windows: 9 at 1008 px), a ``pp``
    axis replicates the encodes (encode_vision_pipelined is the pipeline
    trunk), and every rank of the mesh runs each encode (rank 0 calls, the
    other ranks follow, parallel/runner.py)."""

    def __init__(self, params: dict[str, torch.Tensor], tokenizer: ClipTokenizer | None, max_tokens: int,
                 device: Device, vp: Sam3VitParams | None = None, mesh=None):
        from ..parallel.sharding import MESH_AXES

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
        grid = self.vp.image_size // self.vp.patch_size
        self.scan = grid % self.vp.window_size == 0  # sam3_process_input's square resize fixes the grid
        self._layers = None
        if mesh is not None:
            # stacked before placement: the flat window copies are never placed
            stack = self._vision_stack()
            pre = f"det.ve.backbone.{WINDOW_STACK}."
            flat = mesh_params({k: v for k, v in self.params.items() if not k.startswith(pre)}, mesh, device,
                               SAM3_TP_RULES, heads=sam3_heads(self.vp))
            if stack is not None:
                flat.update({pre + leaf: v for leaf, v in _shard_stack(stack, mesh, self.vp).items()})
            self.params = flat
        self.graphs = ForwardGraphs(self._forward_u8, device.torch_device)
        self._calls = mesh_entries(self, mesh, axes=MESH_AXES, encode_text=self._encode_text,
                                   encode_vision=self._encode_vision, forward_u8=self.graphs)

    def _vision_stack(self) -> dict | None:
        """The stacked window weights ({leaf: (n_window_layers, ...)}) from
        ``self.params``, stacked there first if they are not yet (the JAX
        package's Sam3Model._vision_stack); None where the patch grid does
        not divide into windows (the spatial trunk, flat weights)."""
        if not self.scan:
            return None
        pre = f"det.ve.backbone.{WINDOW_STACK}."
        if pre + _SAM3_LAYER_LEAVES[0] not in self.params:
            with torch.inference_mode(False):
                stack = sam3_pack_vision_weights(self.params, self.vp, prefix="det.ve.backbone.")
            dropped = {f"det.ve.backbone.layers.{i}.{leaf}" for i in _window_layer_indexes(self.vp)
                       for leaf in _SAM3_LAYER_LEAVES}
            self.params = {k: v for k, v in self.params.items() if k not in dropped}
            self.params.update({pre + leaf: v for leaf, v in stack.items()})
        return {leaf: self.params[pre + leaf] for leaf in _SAM3_LAYER_LEAVES}

    def _window_layers(self) -> list[dict] | None:
        """Per-layer views of the stack, made once for ``self.params`` (a
        tp-sharded view is a DTensor built on the host); under a
        fake-tensor trace (torch.export) made anew, so that no view of the
        trace is kept."""
        from torch._guards import detect_fake_mode

        stack = self._vision_stack()
        if stack is None:
            return None
        if detect_fake_mode() is not None:
            return window_layers(stack)
        if self._layers is None or self._layers[0] is not self.params:
            self._layers = (self.params, window_layers(stack))
        return self._layers[1]

    def encode_text(self, text: str) -> torch.Tensor:
        """One prompt -> (1, max_tokens, C) in the model's type, on its
        device."""
        if self.tokenizer is None or not self.n_text_layers:
            raise_error("Sam3Model.encode_text: this model holds no text encoder (no det.te.* weights or no "
                        "tokenizer); build it from a checkpoint with both")
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
        layers = self._window_layers()
        with torch.inference_mode():
            return tuple(encode_vision(Params(self.params)["det.ve"], x, self.vp, flash=self.flash, win_stack=layers,
                                       mesh=self.mesh).fpn_hidden_states)

    def forward_u8(self, x_u8: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(N, s, s, 3) uint8 images at the model's input size s (resized
        beforehand, as :func:`sam3_process_input` resizes) -> the four FPN
        levels, (N, 4g, 4g, C) down to (N, g/2, g/2, C) for g = s /
        patch_size, float16 on the model's device. The [-1, 1] mapping of
        :func:`sam3_process_input` runs on the device, so for the same
        pixels the levels are :meth:`encode_vision`'s, cast to float16 (which
        holds bfloat16 exactly from 2^-14 to 65504). Runs under
        ``torch.inference_mode``, entered here because the mode is
        thread-local and servers call this from their own worker thread. On
        the card each input shape runs as one CUDA graph, captured at its
        first call and replayed after (core/graph.py); the result is a copy
        that the caller keeps."""
        return self._calls["forward_u8"](x_u8)

    def _forward_u8(self, x_u8: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """The eager forward that :meth:`forward_u8` captures (the reference of its tests)."""
        with torch.inference_mode(False):
            layers = self._window_layers()
        with torch.inference_mode():
            x = x_u8.to(self.device.torch_device, non_blocking=True).float()
            # sam3_process_input's (x / 255 - 0.5) * 2, in its order, in f32
            x = ((x / 255.0 - 0.5) * 2.0).to(self.dtype)
            p = Params(self.params)["det.ve"]
            trunk = vision_trunk(p["backbone"], x, self.vp, self.flash, layers, self.mesh)
            return tuple(h.to(torch.float16) for h in vision_levels(p["neck"], trunk))


def sam3_load_model(filepath: str, device: Device | None = None, mesh=None) -> Sam3Model:
    """Load a SAM3 GGUF onto ``device`` (default: the CUDA device; without
    one, backend_init raises). Quantized tensors expand to floats at load:
    there is no ``keep_quantized`` path, as in the JAX package. ``mesh``: a
    mesh of parallel/ (Sam3Model: tp-sharded weights, an sp axis that runs
    the vision trunk sequence-parallel, pp replicated)."""
    device = device or backend_init()
    file = model_load(filepath)
    tokenizer = clip_tokenizer_init(file)
    max_tokens = file.get_int("sam3.tokenizer.max_length", 32)
    params = params_from_numpy(load_weights(file, as_numpy=True), device.torch_device, device.preferred_float_type)
    return Sam3Model(params, tokenizer, max_tokens, device, mesh=mesh)
