"""MI-GAN inpainting (a StyleGAN2-like encoder and synthesis ladder) — a port
of vision_tpu/models/migan.py.

Reference: src/visp/arch/migan.{cpp,h}, src/visp/vision.cpp:170-203:

  * ``lrelu_agc`` — leaky ReLU, gain, clamp (migan.cpp:17-26);
  * ``downsample_2d`` — a fixed smoothing filter as a depthwise conv, stride 2;
  * ``upsample_2d`` — nearest 2x times ``filter_const``, a depthwise 4x4
    filter at pad 2, cropped right and bottom (migan.cpp:32-51);
  * ``separable_conv_2d`` — depthwise + 1x1 with optional activation,
    resampling and noise (migan.cpp:53-84); the noise is a baked constant
    times a learned strength;
  * the encoder (fromrgb, then the ladder b{res} .. b4, collecting skip
    features) and the synthesis (b4 .. b{res} with skip adds and to-rgb
    accumulation);
  * pre/post: image and mask -> 4 channels [alpha - 0.5, alpha * (2 rgb -
    1)] (migan.cpp:142-157), on the card in :meth:`MiganModel.forward_u8`;
    output * 0.5 + 0.5 -> u8 with the mask as alpha (vision.cpp:197-203).

Every op is a depthwise or 1x1 conv, a nearest upsample or an elementwise
pass, in PyTorch, as the JAX package leaves them to XLA: no Pallas kernel
fits this model, so its path launches no hand-written kernel. Weight names
match the original MI-GAN checkpoints (convert.py:482-497); int8-resident
weights (``keep_quantized``, core/quant.py) dequantize at each use, one
dequant kernel a weight on the card. With a ``mesh`` (parallel/) the
(image, mask) batch splits over dp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core.device import BuildFlag, Device, backend_init
from ..core.errors import raise_error
from ..core.gguf import GGUFFile, model_load
from ..core.graph import ForwardGraphs
from ..core.params import Params
from ..core.weights import cast_float_params, load_weights
from ..parallel.runner import mesh_entries
from ..image import (
    Image,
    ImageFormat,
    image_f32_to_u8,
    image_load_array,
    image_scale,
    image_set_alpha,
    preprocess_scale_method,
)
from ..ops import conv_2d, conv_2d_depthwise, leaky_relu, resize_nhwc

__all__ = [
    "MiganParams",
    "migan_detect_params",
    "lrelu_agc",
    "downsample_2d",
    "upsample_2d",
    "separable_conv_2d",
    "encode",
    "synthesis",
    "migan_generate",
    "migan_process_input",
    "migan_process_output",
    "MiganModel",
    "migan_load_model",
    "migan_compute",
]

_SQRT2 = 1.4142135623


@dataclass(frozen=True)
class MiganParams:
    resolution: int = 256
    invert_mask: bool = True


def migan_detect_params(file: GGUFFile) -> MiganParams:
    if file.arch != "migan":
        raise_error("Architecture expected to be 'migan', but was '{}' ({})", file.arch, file.path)
    return MiganParams(resolution=file.get_int("migan.image_size"))


def lrelu_agc(x: torch.Tensor, alpha: float = 0.2, gain: float = 1.0, clamp: float = 0.0) -> torch.Tensor:
    x = leaky_relu(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp != 0.0:
        x = torch.clamp(x, -clamp, clamp)
    return x


def downsample_2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    return conv_2d_depthwise(p["filter"], x, stride=2, pad=1)


def upsample_2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """nearest 2x * filter_const -> depthwise 4x4 pad 2 -> crop r/b
    (reference migan.cpp:32-51)."""
    _, h, w, _ = x.shape
    x = resize_nhwc(x, (h * 2, w * 2), "nearest")
    x = x * p.weight("filter_const")[None, :, :, None].to(x.dtype)
    x = conv_2d_depthwise(p["filter"], x, stride=1, pad=2)
    return x[:, :-1, :-1, :]


def separable_conv_2d(p: Params, x: torch.Tensor, activation=False, downsample=False, upsample=False,
                      noise=False) -> torch.Tensor:
    """Depthwise + pointwise conv pair with optional resampling and noise
    (reference migan.cpp:53-84)."""
    k = p["conv1"].weight("weight").shape[2]
    x = conv_2d_depthwise(p["conv1"], x, stride=1, pad=k // 2)
    if activation:
        x = lrelu_agc(x, 0.2, _SQRT2, 256)
    if downsample:
        x = downsample_2d(p["downsample"], x)
    x = conv_2d(p["conv2"], x)
    if upsample:
        x = upsample_2d(p["upsample"], x)
    if noise:
        n = p.weight("noise_const") * p.weight("noise_strength")
        x = x + n[None, :, :, None].to(x.dtype)
    if activation:
        x = lrelu_agc(x, 0.2, _SQRT2, 256)
    return x


def from_rgb(p: Params, x: torch.Tensor) -> torch.Tensor:
    return lrelu_agc(conv_2d(p["fromrgb"], x), 0.2, _SQRT2, 256)


def encoder_block(p: Params, x: torch.Tensor, downsample=False):
    feat = separable_conv_2d(p["conv1"], x, activation=True)
    x = separable_conv_2d(p["conv2"], feat, activation=True, downsample=downsample)
    return x, feat


def encode(p: Params, x: torch.Tensor, res: int):
    """Encoder ladder res -> 4 (reference migan.cpp:96-109). Returns the
    4x4 features and the skip features, largest first."""
    n = int(math.log2(res)) - 1
    assert (1 << (n + 1)) == res
    x = from_rgb(p[f"b{res}"], x)
    feats = []
    for i in range(n - 1):
        x, f = encoder_block(p[f"b{res >> i}"], x, downsample=True)
        feats.append(f)
    x, f = encoder_block(p["b4"], x)
    feats.append(f)
    return x, feats


def synthesis_block(p: Params, x: torch.Tensor, feat, img, upsample=False, noise=False):
    """(reference migan.cpp:111-125)."""
    x = separable_conv_2d(p["conv1"], x, activation=True, upsample=upsample, noise=noise)
    x = x + feat
    x = separable_conv_2d(p["conv2"], x, activation=True, noise=noise)
    if img is not None:
        img = upsample_2d(p["upsample"], img)
    y = conv_2d(p["torgb"], x)
    img = y if img is None else img + y
    return x, img


def synthesis(p: Params, x: torch.Tensor, feats, res: int) -> torch.Tensor:
    """Synthesis ladder 4 -> res (reference migan.cpp:127-140)."""
    n = int(math.log2(res)) - 1
    x, img = synthesis_block(p["b4"], x, feats[n - 1], None)
    for i in range(n - 2, -1, -1):
        x, img = synthesis_block(p[f"b{res >> i}"], x, feats[i], img, upsample=True, noise=True)
    return img


def migan_generate(params: Params, image: torch.Tensor, p: MiganParams) -> torch.Tensor:
    """Full generator: (N, res, res, 4) -> (N, res, res, 3)
    (reference migan_generate, migan.cpp:166-170)."""
    x, feats = encode(params["encoder"], image, p.resolution)
    return synthesis(params["synthesis"], x, feats, p.resolution)


def migan_process_input(image: Image, mask: Image, p: MiganParams) -> np.ndarray:
    """image + mask -> (res, res, 4) = [alpha - 0.5, alpha * (2 rgb - 1)]
    (reference migan_process_input, migan.cpp:142-157, 181-205)."""
    res = (p.resolution, p.resolution)
    if image.extent != res:
        image = image_scale(image, res, preprocess_scale_method())
    if mask.extent != res:
        mask = image_scale(mask, res, preprocess_scale_method())
    rgb = image.load_f32x4()[:, :, :3]
    alpha = mask.load_f32x4()[:, :, :1]
    if p.invert_mask:
        alpha = 1.0 - alpha
    color = alpha * (rgb * 2.0 - 1.0)
    return np.concatenate([alpha - 0.5, color], axis=2).astype(np.float32)


def _mask_u8(mask: np.ndarray) -> np.ndarray:
    """A mask's first channel as u8: float masks are [0, 1] and are scaled (a
    bare u8 cast would truncate them to 0 and 1)."""
    m = mask[:, :, :1]
    if np.issubdtype(m.dtype, np.floating):
        m = (np.clip(m, 0.0, 1.0) * 255.0).astype(np.uint8)
    return m


def migan_process_output(raw: np.ndarray, image: Image, mask: Image) -> Image:
    """Raw generator output (res, res, 3) in [-1, 1] -> rgba u8 at the
    original extent with the mask injected as alpha (reference
    migan_process_output, migan.cpp:197-206 + vision.cpp:183-203)."""
    out_img = Image(np.ascontiguousarray(raw.astype(np.float32)), ImageFormat.rgb_f32)
    if out_img.extent != image.extent:
        out_img = image_scale(out_img, image.extent, preprocess_scale_method())
    result = image_f32_to_u8(out_img, ImageFormat.rgba_u8, scale=0.5, offset=0.5)
    mask_r = mask if mask.extent == image.extent else image_scale(mask, image.extent, preprocess_scale_method())
    image_set_alpha(result, image_load_array(_mask_u8(mask_r.data), ImageFormat.alpha_u8))
    return result


class MiganModel:
    """High-level handle (reference migan_model + migan_compute,
    vision.cpp:172-205).

    ``params``: torch tensors under the GGUF names; floats are cast to the
    device's float policy here (they are moved nowhere: pass them on the
    device, as :func:`migan_load_model` does).

    ``mesh``: a dp mesh of parallel/ (every rank builds the model from its
    own copy of the weights; no weight matches a tp rule, so they are
    replicated, as in the JAX package): ``forward_u8`` splits its batch
    over dp (rank 0 calls, the other ranks follow, parallel/runner.py),
    each rank replaying its own CUDA graph per shard shape."""

    def __init__(self, params: dict[str, torch.Tensor], p: MiganParams, device: Device, mesh=None):
        self.p = p
        self.device = device
        self.dtype = device.preferred_float_type
        self.mesh = mesh
        self.params = cast_float_params(params, self.dtype)
        self.graphs = ForwardGraphs(self._forward_u8, device.torch_device)
        self._calls = mesh_entries(self, mesh, forward_u8=self.graphs)

    def forward_u8(self, image_u8: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
        """(N, res, res, 3) uint8 image and (N, res, res, 1) uint8 mask -> the
        generator's raw (N, res, res, 3) output in [-1, 1], in the model's type
        on its device. The preprocess runs there in f32, as the JAX package's
        ``_migan_program``: [alpha - 0.5, alpha * (2 rgb - 1)] with alpha = 1 -
        mask / 255 (``invert_mask``), one cast. Runs under
        ``torch.inference_mode``, entered here because the mode is thread-local
        and servers call this from their own worker thread. On the card each
        input shape pair runs as one CUDA graph, captured at its first call and
        replayed after (core/graph.py); the result is a copy that the caller
        keeps."""
        return self._calls["forward_u8"](image_u8, mask_u8)

    def _forward_u8(self, image_u8: torch.Tensor, mask_u8: torch.Tensor) -> torch.Tensor:
        """The eager forward that :meth:`forward_u8` captures (the reference of its tests)."""
        dev = self.device.torch_device
        with torch.inference_mode():
            rgb = image_u8.to(dev, non_blocking=True).float() / 255.0
            alpha = mask_u8.to(dev, non_blocking=True).float() / 255.0
            if self.p.invert_mask:
                alpha = 1.0 - alpha
            x = torch.cat([alpha - 0.5, alpha * (rgb * 2.0 - 1.0)], -1).to(self.dtype)
            return migan_generate(Params(self.params), x, self.p)

    def compute(self, image: Image, mask: Image) -> Image:
        res = (self.p.resolution, self.p.resolution)
        img_r = image if image.extent == res else image_scale(image, res, preprocess_scale_method())
        mask_r = mask if mask.extent == res else image_scale(mask, res, preprocess_scale_method())
        y = self.forward_u8(torch.from_numpy(img_r.to_rgb_u8()[None]), torch.from_numpy(_mask_u8(mask_r.data)[None]))
        return migan_process_output(y[0].float().cpu().numpy(), image, mask)


def migan_load_model(filepath: str, device: Device | None = None, mesh=None) -> MiganModel:
    """Load an MI-GAN GGUF onto ``device`` (default: the CUDA device; without
    one, backend_init raises). With the device's ``keep_quantized`` flag
    (``VISP_KEEP_QUANT``) block-quantized tensors stay int8-resident and
    dequantize at each use (core/quant.py); without it they expand at load.
    ``mesh``: replicate the weights over a dp mesh of parallel/ (quantized
    residency is single-card only; a mesh forces dequant)."""
    device = device or backend_init()
    file = model_load(filepath)
    p = replace(migan_detect_params(file), invert_mask=True)
    keep_q = bool(device.flags & BuildFlag.keep_quantized) and mesh is None
    params = load_weights(file, device, keep_quantized=keep_q)
    return MiganModel(params, p, device, mesh=mesh)


def migan_compute(model: MiganModel, image: Image, mask: Image) -> Image:
    return model.compute(image, mask)
