"""MobileSAM — promptable segmentation (TinyViT encoder + SAM decoder), a port
of vision_tpu/models/mobile_sam.py.

Reference: src/visp/arch/mobile-sam.{cpp,h}, high-level path
src/visp/vision.cpp:24-95.

  * TinyViT image encoder: conv stem, MBConv stage, three windowed-attention
    stages with precomputed relative-bias tables (``attention_biases_indexed``,
    baked at conversion), patch merging with the stride-1-vs-2 trick keyed
    off channel count, 256x64x64 neck. Every window attention runs
    ops/nn.py ``attention_windows``: the hand-written CUDA kernel
    (ops/cuda/window_attention.py) on the card.
  * prompt encoder: random-Fourier positional encoding of points/boxes.
  * mask decoder: two-way transformer, 4x conv-transpose upscaling,
    hypernetwork MLPs -> mask logits + IoU head.
  * pre/post: resize-longest-side to 1024 (host, stb), normalize on the
    device; masks upsample twice bilinearly and threshold at 0 on the host.

PyTorch runs eagerly, so :class:`SamModel` needs no program cache. Types
follow the JAX package: the prompts are f32 (the positional encoding computes
in f32) while the weights and the image embedding are in the device type, so
on the card the decoder's queries stay f32 and its keys bf16, and masks and
IoU come out f32. Int8-resident weights (``keep_quantized``, core/quant.py)
dequantize at each use, in ``decode`` too. Meshes wait for their queue item.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import BuildFlag, Device, backend_init
from ..core.gguf import GGUFFile, model_load
from ..core.params import Params
from ..core.quant import is_quant
from ..core.weights import cast_float_params, load_weights, params_from_numpy, unpermute_cwhn
from ..image import (
    Image,
    ImageFormat,
    image_load_array,
    image_scale,
    image_u8_to_f32,
    preprocess_scale_method,
)
from ..ops import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    attention_core,
    attention_windows,
    conv_2d,
    conv_2d_depthwise,
    conv_transpose_2d,
    gelu,
    layer_norm,
    linear,
    normalize_u8,
    relu,
)

__all__ = [
    "SamParams",
    "TinyVitLayer",
    "TinyVitParams",
    "SamPrediction",
    "tiny_vit",
    "sam_encode_image",
    "sam_encode_points",
    "sam_encode_box",
    "sam_predict_mask",
    "sam_process_input_u8",
    "sam_process_input",
    "sam_process_point",
    "sam_process_box",
    "sam_process_mask",
    "resize_longest_side",
    "fixup_weights",
    "SamModel",
    "sam_load_model",
]


@dataclass(frozen=True)
class SamParams:
    image_size: int = 1024
    mask_size: int = 256


@dataclass(frozen=True)
class TinyVitLayer:
    resolution: int
    embed_dim: int
    depth: int
    num_heads: int
    window_size: int
    downsample: bool


@dataclass(frozen=True)
class TinyVitParams:
    """Hardcoded 4-stage TinyViT-5M config (reference mobile-sam.h:16-38)."""

    img_size: int = 1024
    layers: tuple[TinyVitLayer, ...] = (
        TinyVitLayer(256, 64, 2, 2, 7, True),
        TinyVitLayer(128, 128, 2, 4, 7, True),
        TinyVitLayer(64, 160, 6, 5, 14, True),
        TinyVitLayer(64, 320, 2, 10, 7, False),
    )


# ---------------------------------------------------------------------------
# TinyViT encoder (reference mobile-sam.cpp:15-208)
# ---------------------------------------------------------------------------


def conv_2d_bn(p: Params, x, stride: int = 1, pad: int = 0):
    """Conv with BN fused at conversion (reference mobile-sam.cpp:15-18)."""
    return conv_2d(p["c"], x, stride, pad)


def conv_2d_dw_bn(p: Params, x, stride: int = 1, pad: int = 0):
    return conv_2d_depthwise(p["c"], x, stride, pad)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nw, win*win, C) with zero pad (mobile-sam.cpp:25-44).
    The padded tokens are real keys of their window: nothing masks them."""
    b, h, w, c = x.shape
    ph = (window - h % window) % window
    pw = (window - w % window) % window
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    nh, nw = (h + ph) // window, (w + pw) // window
    x = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, window * window, c)


def window_reverse(x: torch.Tensor, w: int, h: int, window: int) -> torch.Tensor:
    """Inverse of window_partition (mobile-sam.cpp:46-65)."""
    ph = (window - h % window) % window
    pw = (window - w % window) % window
    nh, nw = (h + ph) // window, (w + pw) // window
    b = x.shape[0] // (nh * nw)
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h + ph, w + pw, c)
    return x[:, :h, :w, :]


def patch_embed(p: Params, x):
    """Conv stem (mobile-sam.cpp:71-76)."""
    x = conv_2d_bn(p["seq"][0], x, 2, 1)
    x = gelu(x)
    return conv_2d_bn(p["seq"][2], x, 2, 1)


def mb_conv(p: Params, x):
    """MBConv block (mobile-sam.cpp:78-92)."""
    shortcut = x
    x = gelu(conv_2d_bn(p["conv1"], x))
    x = gelu(conv_2d_dw_bn(p["conv2"], x, 1, 1))
    x = conv_2d_bn(p["conv3"], x)
    return gelu(x + shortcut)


def patch_merging(p: Params, x):
    """Downsample; stride trick keyed off channel count (mobile-sam.cpp:94-113).
    x: (B, H, W, C) -> (B, T, C_out)."""
    x = gelu(conv_2d_bn(p["conv1"], x))
    c_out = p["conv2"].weight("c.weight").shape[0]
    stride = 1 if c_out in (320, 448, 576) else 2
    x = gelu(conv_2d_dw_bn(p["conv2"], x, stride, 1))
    x = conv_2d_bn(p["conv3"], x)
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def mlp(p: Params, x):
    """LN + fc1 + gelu + fc2 (mobile-sam.cpp:115-122)."""
    x = layer_norm(p["norm"], x)
    return linear(p["fc2"], gelu(linear(p["fc1"], x)))


def attention_rel_bias(p: Params, x, dim: int, n_heads: int, flash: bool = False):
    """Windowed attention with precomputed relative bias (mobile-sam.cpp:124-132).
    x: (B, T, C); bias ``attention_biases_indexed``: (heads, T, T), shared
    by all windows. ``flash`` is accepted for API parity: the windowed route
    is the window kernel whatever the flag."""
    del flash
    scale = 1.0 / math.sqrt(dim / n_heads)
    bias = p.weight("attention_biases_indexed")  # (H, T, T)
    x = layer_norm(p["norm"], x)
    return attention_windows(p, x, n_heads, 1, bias[None], scale)


def tiny_vit_block(p: Params, x, resolution: int, dim: int, num_heads: int, window: int, flash=False):
    """(reference mobile-sam.cpp:134-161). x: (B, T, C)."""
    b, t, c = x.shape
    h = w = resolution
    res_x = x
    x = window_partition(x.reshape(b, h, w, c), window)
    x = attention_rel_bias(p["attn"], x, dim, num_heads, flash)
    x = window_reverse(x, w, h, window)
    x = x.reshape(b, t, c) + res_x
    y = conv_2d_dw_bn(p["local_conv"], x.reshape(b, h, w, c), 1, 1)
    x = y.reshape(b, t, c)
    return x + mlp(p["mlp"], x)


def conv_layer(p: Params, x, lp: TinyVitLayer):
    for i in range(lp.depth):
        x = mb_conv(p["blocks"][i], x)
    return patch_merging(p["downsample"], x)


def basic_layer(p: Params, x, lp: TinyVitLayer, flash=False):
    for i in range(lp.depth):
        x = tiny_vit_block(p["blocks"][i], x, lp.resolution, lp.embed_dim, lp.num_heads, lp.window_size, flash)
    if lp.downsample:
        b, t, c = x.shape
        x = patch_merging(p["downsample"], x.reshape(b, lp.resolution, lp.resolution, c))
    return x


def tiny_vit(p: Params, x, tp: TinyVitParams = TinyVitParams(), flash: bool = False):
    """TinyViT encoder -> (B, R, R, 256) embedding, R = final-stage
    resolution (64 for the production 1024 geometry; mobile-sam.cpp:185-208)."""
    x = patch_embed(p["patch_embed"], x)
    x = conv_layer(p["layers"][0], x, tp.layers[0])
    for i in range(1, len(tp.layers)):
        x = basic_layer(p["layers"][i], x, tp.layers[i], flash)
    b, t, c = x.shape
    res = tp.layers[-1].resolution
    x = conv_2d(p["neck"][0], x.reshape(b, res, res, c))
    x = layer_norm(p["neck"][1], x)
    x = conv_2d(p["neck"][2], x, 1, 1)
    return layer_norm(p["neck"][3], x)


def sam_encode_image(params: Params, image, p: SamParams = SamParams(), flash: bool = False,
                     tp: TinyVitParams = TinyVitParams()):
    """``tp``: encoder geometry; only the production 1024 default gives the
    64x64 embedding the prompt decoder takes."""
    return tiny_vit(params["enc"], image, tp, flash)


# ---------------------------------------------------------------------------
# Prompt encoder (reference mobile-sam.cpp:214-288)
# ---------------------------------------------------------------------------


def resize_longest_side(extent: tuple[int, int], target: int) -> float:
    return float(target) / float(max(extent))


def _transform_coord(v: int, scale: float, image_size: int) -> float:
    return 2.0 * ((float(v) * scale + 0.5) / float(image_size)) - 1.0


def sam_process_point(point, extent, p: SamParams = SamParams()) -> np.ndarray:
    scale = resize_longest_side(extent, p.image_size)
    x = _transform_coord(point[0], scale, p.image_size)
    y = _transform_coord(point[1], scale, p.image_size)
    return np.array([[x, y], [0.0, 0.0]], np.float32)


def sam_process_box(top_left, bottom_right, extent, p: SamParams = SamParams()) -> np.ndarray:
    scale = resize_longest_side(extent, p.image_size)
    t = lambda v: _transform_coord(v, scale, p.image_size)  # noqa: E731
    return np.array([[t(top_left[0]), t(top_left[1])], [t(bottom_right[0]), t(bottom_right[1])]], np.float32)


def position_embedding_random(p: Params, coords: torch.Tensor) -> torch.Tensor:
    """coords (..., 2) @ gaussian matrix -> [sin, cos], in f32
    (mobile-sam.cpp:238-248)."""
    pe = p.weight("positional_encoding_gaussian_matrix")  # (2, 128)
    c = torch.matmul(coords.float(), pe.float())
    c = 2.0 * math.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def embed_points_batch(p: Params, coords: torch.Tensor) -> torch.Tensor:
    """(P, n+1, 2) coords, the last of each a sentinel -> (P, n+1, 256)
    (mobile-sam.cpp:250-266; the JAX package's vmap written out)."""
    count = coords.shape[1] - 1
    x = position_embedding_random(p["pe_layer"], coords)
    fg = x[:, :count] + p.weight("point_embeddings.1.weight").to(x.dtype)
    sentinel = p.weight("not_a_point_embed.weight").to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
    return torch.cat([fg, sentinel], dim=1)


def embed_box_batch(p: Params, coords: torch.Tensor) -> torch.Tensor:
    """(P, 2, 2) corners -> (P, 2, 256) (mobile-sam.cpp:268-284)."""
    x = position_embedding_random(p["pe_layer"], coords)
    c1 = x[:, 0:1] + p.weight("point_embeddings.2.weight").to(x.dtype)
    c2 = x[:, 1:2] + p.weight("point_embeddings.3.weight").to(x.dtype)
    return torch.cat([c1, c2], dim=1)


def embed_points(p: Params, coords: torch.Tensor) -> torch.Tensor:
    """(n+1, 2) coords, last is sentinel -> (1, n+1, 256)."""
    return embed_points_batch(p, coords[None])


def embed_box(p: Params, coords: torch.Tensor) -> torch.Tensor:
    """(2, 2) corners -> (1, 2, 256)."""
    return embed_box_batch(p, coords[None])


def sam_encode_points(params: Params, coords):
    return embed_points(params["prompt_encoder"], coords)


def sam_encode_box(params: Params, coords):
    return embed_box(params["prompt_encoder"], coords)


# ---------------------------------------------------------------------------
# Mask decoder (reference mobile-sam.cpp:294-478)
# ---------------------------------------------------------------------------


def mlp_block(p: Params, x):
    return linear(p["lin2"], relu(linear(p["lin1"], x)))


def decoder_attention(p: Params, q, k, v, n_heads: int):
    """Projected multi-head attention (mobile-sam.cpp:307-319). No flash
    flag, as in the JAX package: the naive route, whatever T."""
    q = linear(p["q_proj"], q)
    k = linear(p["k_proj"], k)
    v = linear(p["v_proj"], v)
    b, tq, c = q.shape
    hd = c // n_heads
    to_heads = lambda z: z.reshape(b, z.shape[1], n_heads, hd).transpose(1, 2)  # noqa: E731
    out = attention_core(to_heads(q), to_heads(k), to_heads(v), None, 1.0 / math.sqrt(hd))
    return linear(p["out_proj"], out.transpose(1, 2).reshape(b, tq, c))


def two_way_attention_block(p: Params, queries, keys, query_pe, key_pe, n_heads, skip_first_layer_pe):
    """(reference mobile-sam.cpp:321-362)."""
    if skip_first_layer_pe:
        queries = decoder_attention(p["self_attn"], queries, queries, queries, n_heads)
    else:
        q = queries + query_pe
        queries = queries + decoder_attention(p["self_attn"], q, q, queries, n_heads)
    queries = layer_norm(p["norm1"], queries)

    q = queries + query_pe
    k = keys + key_pe
    queries = queries + decoder_attention(p["cross_attn_t2i"], q, k, keys, n_heads)
    queries = layer_norm(p["norm2"], queries)

    queries = queries + mlp_block(p["mlp"], queries)
    queries = layer_norm(p["norm3"], queries)

    q = queries + query_pe
    keys = keys + decoder_attention(p["cross_attn_i2t"], k, q, queries, n_heads)
    keys = layer_norm(p["norm4"], keys)
    return queries, keys


def two_way_transformer(p: Params, image_embedding, image_pe, point_embedding, depth, n_heads):
    """(reference mobile-sam.cpp:364-395). image_embedding: (B, H, W, C)."""
    b, h, w, c = image_embedding.shape
    keys = image_embedding.reshape(b, h * w, c)
    image_pe = image_pe.reshape(1, h * w, c) if image_pe.ndim != 3 else image_pe
    queries = point_embedding
    for i in range(depth):
        queries, keys = two_way_attention_block(
            p["layers"][i], queries, keys, point_embedding, image_pe, n_heads, i == 0
        )
    q = queries + point_embedding
    k = keys + image_pe
    queries = queries + decoder_attention(p["final_attn_t2i"], q, k, keys, n_heads)
    queries = layer_norm(p["norm_final_attn"], queries)
    return queries, keys


def upscale_outputs(p: Params, x):
    """2x conv-transpose ladder (mobile-sam.cpp:397-405)."""
    x = conv_transpose_2d(p[0], x, 2)
    x = gelu(layer_norm(p[1], x))
    return gelu(conv_transpose_2d(p[3], x, 2))


def hypernetwork_mlp(p: Params, x, num_layers: int):
    for i in range(num_layers):
        x = linear(p["layers"][i], x)
        if i < num_layers - 1:
            x = relu(x)
    return x


class SamPrediction(NamedTuple):
    masks: torch.Tensor  # (B, 4, mask, mask) logits, f32
    iou: torch.Tensor  # (B, 4)


def predict_masks(p: Params, image_embeddings, sparse_prompt, dense_prompt) -> SamPrediction:
    """(reference sam::predict_masks, mobile-sam.cpp:418-478).
    image_embeddings: (1 or B, 64, 64, 256); sparse_prompt: (B, n, 256);
    dense_prompt broadcastable to (B, 64, 64, 256)."""
    num_heads, depth, num_mask_tokens = 8, 2, 4
    bsz = sparse_prompt.shape[0]
    output_tokens = torch.cat([p.weight("iou_token.weight"), p.weight("mask_tokens.weight")], dim=0)
    output_tokens = output_tokens[None].expand(bsz, *output_tokens.shape)
    tokens = torch.cat([output_tokens.to(sparse_prompt.dtype), sparse_prompt], dim=1)

    src = image_embeddings.expand(bsz, *image_embeddings.shape[1:])
    src = src + dense_prompt.to(src.dtype).reshape(1, 1, 1, -1)
    image_pe = p.weight("dense_positional_embedding")  # (64, 64, 256)
    image_pe = image_pe.reshape(1, -1, image_pe.shape[-1]).to(src.dtype)

    hs, out = two_way_transformer(p["transformer"], src, image_pe, tokens, depth, num_heads)
    iou_token_out = hs[:, 0]
    mask_tokens_out = hs[:, 1 : num_mask_tokens + 1]

    b, hw, c = out.shape
    g = int(math.sqrt(hw))
    upscaled = upscale_outputs(p["output_upscaling"], out.reshape(b, g, g, c))
    b2, h2, w2, c2 = upscaled.shape
    upscaled = upscaled.reshape(b2, h2 * w2, c2)

    mlps = p["output_hypernetworks_mlps"]
    hyper_in = torch.stack(
        [hypernetwork_mlp(mlps[i], mask_tokens_out[:, i], 3) for i in range(num_mask_tokens)], dim=1
    )  # (B, 4, c2)
    masks = torch.matmul(hyper_in.float(), upscaled.float().transpose(1, 2))
    masks = masks.reshape(b2, num_mask_tokens, h2, w2)

    iou_pred = hypernetwork_mlp(p["iou_prediction_head"], iou_token_out, 3)
    return SamPrediction(masks, iou_pred)


def sam_predict_mask(params: Params, image_embed, prompt_embed) -> SamPrediction:
    dense = params["prompt_encoder"].weight("no_mask_embed.weight")
    return predict_masks(params["dec"], image_embed, prompt_embed, dense)


def best_masks(pred: SamPrediction) -> torch.Tensor:
    """The mask of the highest IoU among the first three predictions, one
    per prompt (reference vision.cpp:80-84), chosen where the masks lie:
    (B, 4, H, W) -> (B, H, W) f32."""
    idx = torch.argmax(pred.iou[:, :3], dim=1)
    return pred.masks[torch.arange(pred.masks.shape[0], device=idx.device), idx].float()


# ---------------------------------------------------------------------------
# Pre/post processing (reference mobile-sam.cpp:480-583, vision.cpp:54-95)
# ---------------------------------------------------------------------------


def sam_process_input_u8(image: Image, p: SamParams = SamParams()) -> np.ndarray:
    """Resize longest side to 1024 + replicate-pad, still uint8.
    Normalization runs on the device (ops/preprocess.py)."""
    scale = resize_longest_side(image.extent, p.image_size)
    if scale != 1.0:
        target = (int(image.extent[0] * scale + 0.5), int(image.extent[1] * scale + 0.5))
        image = image_scale(image, target, preprocess_scale_method())
    a = image.to_rgb_u8()
    # replicate-pad to square (matches image_u8_to_f32's clamped tiled reads)
    ys = np.minimum(np.arange(p.image_size), a.shape[0] - 1)
    xs = np.minimum(np.arange(p.image_size), a.shape[1] - 1)
    return np.ascontiguousarray(a[np.ix_(ys, xs)])


def sam_process_input(image: Image, p: SamParams = SamParams()) -> np.ndarray:
    """Resize longest side to 1024, pad bottom/right, ImageNet normalize
    (host-side f32 variant, reference mobile-sam.cpp:533-547)."""
    scale = resize_longest_side(image.extent, p.image_size)
    if scale != 1.0:
        target = (int(image.extent[0] * scale + 0.5), int(image.extent[1] * scale + 0.5))
        image = image_scale(image, target, preprocess_scale_method())
    out = image_u8_to_f32(
        image,
        ImageFormat.rgb_f32,
        offset=tuple(-m for m in IMAGENET_MEAN),
        scale=tuple(1.0 / s for s in IMAGENET_STD),
        dst_extent=(p.image_size, p.image_size),
    )
    return out.data


def sam_process_mask(masks: np.ndarray, index: int, target_extent, p: SamParams = SamParams()) -> Image:
    """Double bilinear upsample + threshold (reference mobile-sam.cpp:557-583)."""
    from ..image.image import _bilinear_resize_f32

    mask = masks[index][:, :, None].astype(np.float32)  # (256, 256, 1)
    scaled_full = _bilinear_resize_f32(mask, (p.image_size, p.image_size))
    scale = resize_longest_side(target_extent, p.image_size)
    sw = int(target_extent[0] * scale + 0.5)
    sh = int(target_extent[1] * scale + 0.5)
    out = _bilinear_resize_f32(scaled_full[:sh, :sw], target_extent)
    return image_load_array((out[:, :, 0] > 0.0).astype(np.uint8) * 255, ImageFormat.alpha_u8)


# ---------------------------------------------------------------------------
# High-level model (reference sam_model + sam_encode/sam_compute)
# ---------------------------------------------------------------------------


def fixup_weights(file: GGUFFile, params: dict) -> dict:
    """Undo converter layout choices for whcn files (convert.py convert_sam):
    local_conv weights are ALWAYS stored cwhn; neck.0/neck.2 follow the
    conv2d_weights list (torch layout in whcn files, handled generically).
    cwhn files were un-permuted generically, "torch" files are canonical.
    ``params``: host numpy arrays and quantized residents, as
    ``load_weights(..., as_numpy=True)`` returns them."""
    if file.tensor_layout in ("cwhn", "torch"):
        return params
    out = dict(params)
    for name, a in params.items():
        if "local_conv" in name and a.ndim == 4 and name.endswith("weight"):
            out[name] = a.unpermute_cwhn(name) if is_quant(a) else unpermute_cwhn(name, a)
    return out


class SamModel:
    """High-level handle (reference sam_model, vision.cpp:24-95).

    ``params``: torch tensors under the GGUF names; floats are cast to the
    device's float policy here, positional tables included (the JAX package's
    ``SamModel.__init__`` casts them too), and moved nowhere: pass them on
    the device, as :func:`sam_load_model` does. ``tiny_vit``: encoder
    geometry; only the production 1024 default feeds the 64x64 decoder."""

    def __init__(self, params: dict[str, torch.Tensor], p: SamParams, device: Device,
                 tiny_vit: TinyVitParams = TinyVitParams()):
        self.p = p
        self.device = device
        self.tiny_vit = tiny_vit
        self.dtype = device.preferred_float_type
        self.flash = bool(device.flags & BuildFlag.flash_attention)
        self.params = cast_float_params(params, self.dtype)
        self.image_extent: tuple[int, int] | None = None
        self.embed: torch.Tensor | None = None

    def encode_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """(N, 1024, 1024, 3) uint8 -> (N, 64, 64, 256) embeddings in the
        model dtype, on the model's device. Runs under
        ``torch.inference_mode``, entered here because the mode is
        thread-local and servers call this from their own worker thread."""
        with torch.inference_mode():
            x = x_u8.to(self.device.torch_device, non_blocking=True)
            x = normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, self.dtype)
            return sam_encode_image(Params(self.params), x, self.p, flash=self.flash, tp=self.tiny_vit)

    def decode(self, embeds: torch.Tensor, coords: np.ndarray, kind: str) -> SamPrediction:
        """Prompt encode + mask decode. embeds: (1 or P, 64, 64, 256) on the
        device; coords: (P, 2, 2) processed prompts; kind: "point" or "box"."""
        c = torch.from_numpy(np.asarray(coords, np.float32)).to(self.device.torch_device)
        return (self._dec_point if kind == "point" else self._dec_box)(embeds, c)

    def _dec_point(self, embeds: torch.Tensor, coords: torch.Tensor) -> SamPrediction:
        """:meth:`decode` of point prompts with the coords a (P, 2, 2) f32
        tensor on the device (the exported form, export.py)."""
        with torch.inference_mode():
            pp = Params(self.params)
            return sam_predict_mask(pp, embeds, embed_points_batch(pp["prompt_encoder"], coords))

    def _dec_box(self, embeds: torch.Tensor, coords: torch.Tensor) -> SamPrediction:
        """:meth:`decode` of box prompts with the coords a (P, 2, 2) f32
        tensor on the device (the exported form, export.py)."""
        with torch.inference_mode():
            pp = Params(self.params)
            return sam_predict_mask(pp, embeds, embed_box_batch(pp["prompt_encoder"], coords))

    def encode(self, image: Image) -> None:
        """Run the encoder; the embedding stays on the device (reference
        sam_encode, vision.cpp:36-52)."""
        self.image_extent = image.extent
        self.embed = self.encode_u8(torch.from_numpy(sam_process_input_u8(image, self.p)[None]))

    def encode_batch(self, images: list[Image]) -> torch.Tensor:
        """Encode a batch of images in one forward. Returns the
        (N, R, R, 256) embeddings on the device (R = 64 for the production
        geometry)."""
        x = np.stack([sam_process_input_u8(img, self.p) for img in images])
        return self.encode_u8(torch.from_numpy(x))

    def _masks(self, coords: np.ndarray, kind: str) -> list[Image]:
        if self.embed is None:
            raise RuntimeError("Missing image embeds, call encode() first")
        pred = self.decode(self.embed, coords, kind)
        masks = pred.masks.float().cpu().numpy()
        ious = pred.iou.float().cpu().numpy()
        return [
            sam_process_mask(masks[b], int(np.argmax(ious[b, :3])), self.image_extent, self.p)
            for b in range(masks.shape[0])
        ]

    def compute(self, point=None, box=None) -> Image:
        """Predict a mask for a point or box prompt (vision.cpp:54-95)."""
        if point is not None:
            coords = sam_process_point(point, self.image_extent, self.p)
            return self._masks(coords[None], "point")[0]
        coords = sam_process_box(box[0], box[1], self.image_extent, self.p)
        return self._masks(coords[None], "box")[0]

    def compute_batch(self, points=None, boxes=None) -> list[Image]:
        """Predict masks for many prompts on the encoded image in one decoder
        call (the decoder batches over prompts; the reference loops one
        prompt per compute, vision.cpp:54-95)."""
        if points is not None:
            coords = np.stack([sam_process_point(p, self.image_extent, self.p) for p in points])
            return self._masks(coords, "point")
        coords = np.stack([sam_process_box(b[0], b[1], self.image_extent, self.p) for b in boxes])
        return self._masks(coords, "box")


def sam_load_model(filepath: str, device: Device | None = None, keep_quantized: bool | None = None) -> SamModel:
    """Load a MobileSAM GGUF onto ``device`` (default: the CUDA device;
    without one, backend_init raises). Every float, the positional tables
    included, lands in the device's float type, which is where the JAX
    package's tables end up too (its loader keeps them f32 and its SamModel
    then casts them).

    ``keep_quantized``: block-quantized tensors stay int8-resident on the
    device and dequantize at each use (core/quant.py) — defaults to the
    device's ``keep_quantized`` build flag (``VISP_KEEP_QUANT``). Positional
    tables dequantize at load and stay full precision, as in the JAX
    package."""
    device = device or backend_init()
    if keep_quantized is None:
        keep_quantized = bool(device.flags & BuildFlag.keep_quantized)
    file = model_load(filepath)
    params = fixup_weights(file, load_weights(file, as_numpy=True, keep_quantized=keep_quantized))
    params = {k: v.dequant().numpy() if is_quant(v) and "positional" in k else v for k, v in params.items()}
    params = params_from_numpy(params, device.torch_device, device.preferred_float_type)
    return SamModel(params, SamParams(), device)
