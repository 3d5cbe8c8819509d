"""BiRefNet — dichotomous image segmentation (SWIN backbone, deformable-ASPP
decoder, dual-scale encoding) — a port of vision_tpu/models/birefnet.py.

Reference: src/visp/arch/birefnet.{cpp,h}, high-level path
src/visp/vision.cpp:97-135:

  * encoder: SWIN on the full image AND a half-scale image; per-level
    channel concat of the upscaled low branch, plus a pyramid concat into
    the deepest level (birefnet.cpp:43-73)
  * decoder: squeeze block; 4 stages of basic_decoder_block (conv_in +
    deformable-ASPP + conv_out) with gdt attention gating, lateral 1x1s and
    multi-scale image-patch injection (image_to_patches, birefnet.cpp:153-247)
  * deformable conv v2 via ops/deform.py
  * dynamic resolution: extent snapped to multiples of ``image_multiple``
    with a memory clamp from the device's ``max_alloc``
    (birefnet_image_extent, birefnet.cpp:288-305)

On the card a forward runs two hand-written kernels: every SWIN block's
window attention (48 launches at SWIN-L: 24 blocks per scale, the 24
shifted ones with the per-window mask) and the fused deformable conv (20
launches: 5 decoder blocks x 4 deformable ASPP branches, each with its
bias, BatchNorm and ReLU, written into one buffer per ASPP). The
bounded deformable conv is used only under ``BuildFlag.deform_shift``
(off by default; core/device.py says why). Weight names follow the
reference converter's renames. Int8-resident weights (``keep_quantized``,
core/quant.py) dequantize at each use, SWIN-L's once for each of the two
scales. Meshes wait for their queue item; PyTorch runs eagerly, so there
is no per-extent program cache.
"""

from __future__ import annotations

import math
import re
from collections import ChainMap
from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import BuildFlag, Device, backend_init
from ..core.errors import raise_error
from ..core.gguf import GGUFFile, model_load
from ..core.graph import ForwardGraphs, shape_bucket
from ..core.params import Params
from ..core.quant import is_quant
from ..core.weights import cast_float_params, load_weights, params_from_numpy, unpermute_cwhn
from ..image import (
    Image,
    ImageFormat,
    image_f32_to_u8,
    image_scale,
    image_u8_to_f32,
    preprocess_scale_method,
)
from ..ops import IMAGENET_MEAN, IMAGENET_STD, conv_2d, normalize_u8, relu, resize_nhwc, sigmoid
from ..ops.cuda.deform_conv import weight_layout
from ..ops.deform import deform_conv_2d_fused
from .swin import SwinParams, swin_detect_params, swin_encode

__all__ = [
    "BirefnetParams",
    "birefnet_detect_params",
    "birefnet_image_extent",
    "birefnet_batch_extent",
    "birefnet_predict",
    "BirefnetModel",
    "birefnet_load_model",
    "birefnet_compute",
    "birefnet_process_input",
    "birefnet_process_output",
]

DEFORM_SHIFT_BOUND = 2  # the bound BirefnetModel uses under BuildFlag.deform_shift
# the deformable ASPP branches' conv weights (deformable_conv_2d_block's
# "conv.weight"), which BirefnetModel lays out once for the fused kernel
_DEFORM_WEIGHT = re.compile(r"\.aspp(1|_deforms\.\d+)\.conv\.conv\.weight$")


@dataclass(frozen=True)
class BirefnetParams:
    image_size: int = 1024
    image_multiple: int = 32
    image_extent: tuple[int, int] = (1024, 1024)
    encoder: SwinParams = None


def birefnet_image_extent(input_extent, p: BirefnetParams, max_alloc: int) -> tuple[int, int]:
    """(reference birefnet_image_extent, birefnet.cpp:288-305)."""
    if p.image_size != -1:
        return (p.image_size, p.image_size)
    w, h = input_extent
    req = w * h * 240 * 4
    if req > max_alloc:
        scale = math.sqrt(max_alloc / req)
        w = max(1, int(w * scale) - p.image_multiple)
        h = max(1, int(h * scale) - p.image_multiple)
    return shape_bucket((w, h), p.image_multiple)


def birefnet_batch_extent(input_extents, p: BirefnetParams, max_alloc: int) -> tuple[int, int]:
    """Shared processing extent for a fused batch: the elementwise max of
    the per-image capped extents, RE-capped (a wide image and a tall image
    each within the area budget combine to a bucket that is not)."""
    extents = [birefnet_image_extent(e, p, max_alloc) for e in input_extents]
    return birefnet_image_extent((max(e[0] for e in extents), max(e[1] for e in extents)), p, max_alloc)


def birefnet_detect_params(file: GGUFFile, dynamic_extent=(0, 0), max_alloc: int = 1 << 62) -> BirefnetParams:
    if file.arch != "birefnet":
        raise_error("Architecture expected to be 'birefnet', but was '{}' ({})", file.arch, file.path)
    p = BirefnetParams(
        image_size=file.get_int("birefnet.image_size"),
        image_multiple=file.get_int("birefnet.image_multiple"),
        encoder=swin_detect_params(file),
    )
    if p.image_size != -1 or dynamic_extent[0] > 0:
        extent = birefnet_image_extent(dynamic_extent, p, max_alloc)
    else:
        extent = p.image_extent
    return BirefnetParams(p.image_size, p.image_multiple, extent, p.encoder)


# -- encoder (reference birefnet.cpp:20-73) --


def _upscale_to(x: torch.Tensor, target_hw) -> torch.Tensor:
    return resize_nhwc(x, tuple(target_hw), "bilinear", align_corners=True)


def encode(p: Params, x: torch.Tensor, sp: SwinParams) -> list[torch.Tensor]:
    """Dual-scale SWIN encode + concat (birefnet.cpp:43-73)."""
    xs = swin_encode(p["bb"], x, sp)
    _, h, w, _ = x.shape
    x_low = resize_nhwc(x, (h // 2, w // 2), "bilinear", align_corners=True)
    xs_low = swin_encode(p["bb"], x_low, sp)
    for i in range(4):
        xs[i] = torch.cat([xs[i], _upscale_to(xs_low[i], xs[i].shape[1:3])], dim=-1)
    h3, w3 = xs[3].shape[1:3]  # every pyramid level downsamples to level-3 dims
    xs[3] = torch.cat([_upscale_to(xs[0], (h3, w3)), _upscale_to(xs[1], (h3, w3)), _upscale_to(xs[2], (h3, w3)),
                       xs[3]], dim=-1)
    return xs


# -- decoder (reference birefnet.cpp:79-248) --


def deformable_conv_2d_block(p: Params, x: torch.Tensor, stride: int = 1, pad: int = 0,
                             shift_bound: int | None = None, *, scale=None, shift=None, relu: bool = False,
                             out=None) -> torch.Tensor:
    """offset/modulator convs + deform conv (birefnet.cpp:83-91), the conv's
    bias and the caller's ``act(scale * y + shift)`` in the kernel's
    epilogue, written into ``out`` when given. ``shift_bound`` selects the
    bounded-offset form (deform_conv_2d_shift). The weight's layout for the
    kernel is ``conv.weight_layout`` where the model made one, else the
    call makes it."""
    offset = conv_2d(p["offset"], x, stride, pad)
    modulator = 2.0 * sigmoid(conv_2d(p["modulator"], x, stride, pad))
    return deform_conv_2d_fused(x, p.weight("conv.weight"), offset, modulator, stride, pad, shift_bound,
                                bias=p.find("conv.bias"), scale=scale, shift=shift, relu=relu, out=out,
                                layout=p.find("conv.weight_layout"))


def global_avg_pool(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(birefnet.cpp:93-107)."""
    m = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
    return relu(conv_2d(p[1], m))


def aspp_module_deformable(p: Params, x: torch.Tensor, padding: int = 0, shift_bound: int | None = None,
                           out=None) -> torch.Tensor:
    """relu(batch_norm_2d(deformable conv)), the BatchNorm's fused scale
    and shift and the ReLU in the deform kernel's epilogue (one rounding)."""
    bn = p["bn"]
    if bn.find("running_mean") is not None or bn.find("running_var") is not None:
        raise_error("batch norm was not fused at conversion (running stats present)")
    return deformable_conv_2d_block(p["conv"], x, 1, padding, shift_bound, scale=bn.weight("weight"),
                                    shift=bn.weight("bias"), relu=True, out=out)


def aspp_deformable(p: Params, x: torch.Tensor, shift_bound: int | None = None) -> torch.Tensor:
    """(birefnet.cpp:116-137). The four deformable branches write their
    channels of one (B, H, W, 5 * C) buffer through the kernel's epilogue,
    and the global-pool branch is copied into the last C: no concatenation.
    When autograd records (training: ``Params.records_grad``) each branch
    returns a fresh tensor and the five are concatenated instead (autograd
    cannot differentiate writes into a shared buffer); the values are the
    same."""
    kernel_sizes = (1, 3, 7)
    b, h, w, _ = x.shape
    if p.records_grad(x):
        branches = [aspp_module_deformable(p["aspp1"], x, 0, shift_bound)]
        branches += [aspp_module_deformable(p["aspp_deforms"][i], x, kernel_sizes[i] // 2, shift_bound)
                     for i in range(3)]
        branches.append(_upscale_to(global_avg_pool(p["global_avg_pool"], x), (h, w)))
        return relu(conv_2d(p["conv1"], torch.cat(branches, dim=-1)))
    c = p["aspp1"]["conv"].weight("conv.weight").shape[0]
    buf = torch.empty((b, h, w, 5 * c), dtype=x.dtype, device=x.device)
    aspp_module_deformable(p["aspp1"], x, 0, shift_bound, out=buf[..., :c])
    for i in range(3):
        aspp_module_deformable(p["aspp_deforms"][i], x, kernel_sizes[i] // 2, shift_bound,
                               out=buf[..., (i + 1) * c : (i + 2) * c])
    buf[..., 4 * c :] = _upscale_to(global_avg_pool(p["global_avg_pool"], x), (h, w))
    return relu(conv_2d(p["conv1"], buf))


def basic_decoder_block(p: Params, x: torch.Tensor, shift_bound: int | None = None) -> torch.Tensor:
    """(birefnet.cpp:139-145)."""
    x = relu(conv_2d(p["conv_in"], x, 1, 1))
    x = aspp_deformable(p["dec_att"], x, shift_bound)
    return conv_2d(p["conv_out"], x, 1, 1)


def simple_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    return conv_2d(p["conv_out"], conv_2d(p["conv1"], x, 1, 1), 1, 1)


def image_to_patches(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """'b (hg h) (wg w) c -> b h w (c hg wg)' (birefnet.cpp:153-162,
    matching BiRefNet's image2patches rearrange)."""
    b, h, w, c = x.shape
    if h % out_h or w % out_w:
        raise ValueError(f"image_to_patches: grid {(out_h, out_w)} does not divide the image {(h, w)}")
    gh, gw = h // out_h, w // out_w
    x = x.reshape(b, gh, out_h, gw, out_w, c).permute(0, 2, 4, 5, 1, 3)  # (b, h, w, c, gh, gw)
    return x.reshape(b, out_h, out_w, c * gh * gw)


def gdt_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    return relu(conv_2d(p[0], x, 1, 1))


def decode(p: Params, image: torch.Tensor, features, shift_bound: int | None = None) -> torch.Tensor:
    """4-stage FPN decoder with patch injection and gdt gating
    (reference birefnet::decode, birefnet.cpp:170-248)."""
    x1, x2, x3, x4 = features

    def inject(feat, blk_name):
        patches = simple_conv(p[blk_name], image_to_patches(image, feat.shape[1], feat.shape[2]))
        return torch.cat([feat, patches], dim=-1)

    def gate(x, i):
        return x * sigmoid(conv_2d(p[f"gdt_convs_attn_{i}"][0], gdt_conv(p[f"gdt_convs_{i}"], x)))

    x4 = inject(x4, "ipt_blk5")
    p4 = gate(basic_decoder_block(p["block4"], x4, shift_bound), 4)

    x3l = conv_2d(p["lateral_block4.conv"], x3)
    _p3 = inject(_upscale_to(p4, x3l.shape[1:3]) + x3l, "ipt_blk4")
    p3 = gate(basic_decoder_block(p["block3"], _p3, shift_bound), 3)

    x2l = conv_2d(p["lateral_block3.conv"], x2)
    _p2 = inject(_upscale_to(p3, x2l.shape[1:3]) + x2l, "ipt_blk3")
    p2 = gate(basic_decoder_block(p["block2"], _p2, shift_bound), 2)

    x1l = conv_2d(p["lateral_block2.conv"], x1)
    _p1 = inject(_upscale_to(p2, x1l.shape[1:3]) + x1l, "ipt_blk2")
    _p1 = _upscale_to(basic_decoder_block(p["block1"], _p1, shift_bound), image.shape[1:3])
    _p1 = torch.cat([_p1, simple_conv(p["ipt_blk1"], image)], dim=-1)
    return sigmoid(conv_2d(p["conv_out1"][0], _p1))


def birefnet_predict(params: Params, image: torch.Tensor, p: BirefnetParams,
                     deform_bound: int | None = None) -> torch.Tensor:
    """(reference birefnet_predict, birefnet.cpp:252-261).
    image: (N, H, W, 3) normalized -> (N, H, W, 1) mask in [0,1]."""
    features = encode(params, image, p.encoder)
    features[3] = basic_decoder_block(params["squeeze_module"][0], features[3], deform_bound)
    return decode(params["decoder"], image, features, deform_bound)


def fixup_weights(file: GGUFFile, params: dict) -> dict:
    """patch_embed conv is always stored cwhn (convert.py convert_birefnet).
    Applies to whcn converter files only — cwhn files were un-permuted
    generically, "torch" files are fully canonical. ``params``: host numpy
    arrays and quantized residents, as ``load_weights(..., as_numpy=True)``
    returns them."""
    if file.tensor_layout in ("cwhn", "torch"):
        return params
    out = dict(params)
    for name, a in params.items():
        if "patch_embed" in name and a.ndim == 4 and name.endswith("weight"):
            out[name] = a.unpermute_cwhn(name) if is_quant(a) else unpermute_cwhn(name, a)
    return out


def deform_layouts(params: dict, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The deformable convs' weights of ``params`` as the fused kernel reads
    them for x of type ``dtype`` (``weight_layout``, from the dequantized
    weight where it is int8-resident), under ``<weight name>_layout``."""
    return {f"{k}_layout": weight_layout(v.dequant() if is_quant(v) else v, dtype)
            for k, v in params.items() if _DEFORM_WEIGHT.search(k)}


class BirefnetModel:
    """High-level handle (reference birefnet_model, vision.cpp:97-135).

    ``params``: torch tensors under the GGUF names; floats are cast to the
    device's float policy here (they are moved nowhere: pass them on the
    device, as :func:`birefnet_load_model` does)."""

    def __init__(self, params: dict[str, torch.Tensor], p: BirefnetParams, device: Device):
        self.p = p
        self.device = device
        self.dtype = device.preferred_float_type
        self.deform_bound = DEFORM_SHIFT_BOUND if device.flags & BuildFlag.deform_shift else None
        self.params = cast_float_params(params, self.dtype)
        # the deformable convs' weights as the fused kernel reads them, made
        # here once instead of at each of a forward's 20 calls (from the
        # dequantized weight where it is int8-resident)
        self.deform_layouts = deform_layouts(self.params, self.dtype)
        self.graphs = ForwardGraphs(self._forward_u8, device.torch_device)

    def forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 at a processed extent -> (N, H, W, 1) mask in the
        model dtype, on the model's device: ImageNet normalization on the
        device, then the prediction. Runs under ``torch.inference_mode``,
        entered here because the mode is thread-local and servers call this
        from their own worker thread. On the card each input shape runs as one
        CUDA graph, captured at its first call and replayed after
        (core/graph.py); the result is a copy that the caller keeps."""
        return self.graphs(x_u8)

    def _forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """The eager forward that :meth:`forward_u8` captures (the reference of its tests)."""
        with torch.inference_mode():
            x = x_u8.to(self.device.torch_device, non_blocking=True)
            x = normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, self.dtype)
            params = Params(ChainMap(self.deform_layouts, self.params))
            return birefnet_predict(params, x, self.p, deform_bound=self.deform_bound)

    def compute(self, image: Image) -> Image:
        """One image -> alpha u8 mask at the image's extent."""
        return self.compute_batch([image])[0]

    def compute_batch(self, images: list[Image]) -> list[Image]:
        """Predict masks for a batch of images in ONE forward. All images
        share one processed extent bucket (the largest request's)."""
        extent = birefnet_batch_extent([img.extent for img in images], self.p, self.device.max_alloc)
        arrs = [(img if img.extent == extent else image_scale(img, extent, preprocess_scale_method())).to_rgb_u8()
                for img in images]
        masks = self.forward_u8(torch.from_numpy(np.stack(arrs))).float().cpu().numpy()
        return [birefnet_process_output(m, img.extent) for m, img in zip(masks, images)]


def birefnet_process_input(image: Image, p: BirefnetParams) -> np.ndarray:
    """Resize to the inference extent + ImageNet normalize, host-side f32
    (reference birefnet_process_input, birefnet.cpp:263-274). The
    BirefnetModel path normalizes on the device instead and only uses this
    modular form for reference-compatible pipelines."""
    if image.extent != p.image_extent:
        image = image_scale(image, p.image_extent, preprocess_scale_method())
    out = image_u8_to_f32(
        image,
        ImageFormat.rgb_f32,
        offset=tuple(-m for m in IMAGENET_MEAN),
        scale=tuple(1.0 / s for s in IMAGENET_STD),
    )
    return out.data


def birefnet_process_output(mask: np.ndarray, target_extent: tuple[int, int]) -> Image:
    """(H, W) or (H, W, 1) f32 sigmoid mask -> alpha u8 at the original
    extent (reference birefnet_process_output, birefnet.cpp:276-286)."""
    if mask.ndim == 2:
        mask = mask[:, :, None]
    out = Image(np.ascontiguousarray(mask.astype(np.float32)), ImageFormat.alpha_f32)
    if out.extent != tuple(target_extent):
        out = image_scale(out, tuple(target_extent), preprocess_scale_method())
    return image_f32_to_u8(out, ImageFormat.alpha_u8)


def birefnet_load_model(filepath: str, device: Device | None = None, dynamic_extent=(0, 0)) -> BirefnetModel:
    """Load a BiRefNet GGUF onto ``device`` (default: the CUDA device;
    without one, backend_init raises). With the device's ``keep_quantized``
    flag (``VISP_KEEP_QUANT``) block-quantized tensors stay int8-resident and
    dequantize at each use (core/quant.py); without it they expand at load."""
    device = device or backend_init()
    file = model_load(filepath)
    p = birefnet_detect_params(file, dynamic_extent, device.max_alloc)
    keep_q = bool(device.flags & BuildFlag.keep_quantized)
    params = fixup_weights(file, load_weights(file, as_numpy=True, keep_quantized=keep_q))
    params = params_from_numpy(params, device.torch_device, device.preferred_float_type)
    return BirefnetModel(params, p, device)


def birefnet_compute(model: BirefnetModel, image: Image) -> Image:
    return model.compute(image)
