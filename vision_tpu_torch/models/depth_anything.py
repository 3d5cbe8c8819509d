"""Depth-Anything V2 (DINOv2 backbone + DPT fusion neck + depth head) — a
port of vision_tpu/models/depth_anything.py.

Reference: src/visp/arch/depth-anything.{cpp,h}, high-level path in
src/visp/vision.cpp:137-168. Per-layer reassemble (1x1 projection + resize
convs x4/x2/1/÷2), fusion stages with residual convs and align-corners
bilinear upsampling, conv head; dynamic input sizing snaps the short side to
>= 518 and multiples of 14 (depthany_image_extent,
depth-anything.cpp:112-117); output is min-max normalized and resized back.

PyTorch runs eagerly, so :class:`DepthAnythingModel` needs no per-extent
program cache: ``forward_u8`` is one batched forward at whatever extent it is
given; int8-resident weights (``keep_quantized``, core/quant.py) dequantize
at each use. With a ``mesh`` (parallel/) the batch splits over dp and the
DINOv2 attentions and MLPs over tp.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import BuildFlag, Device, backend_init
from ..core.gguf import GGUFFile, model_load
from ..core.graph import ForwardGraphs, shape_bucket, snap_to_multiple
from ..core.params import Params
from ..core.quant import is_quant
from ..core.weights import cast_float_params, load_weights, params_from_numpy, unpermute_cwhn
from ..parallel.runner import mesh_entries
from ..parallel.sharding import mesh_params, mesh_tp
from ..image import (
    Image,
    ImageFormat,
    image_normalize,
    image_scale,
    preprocess_scale_method,
)
from ..ops import IMAGENET_MEAN, IMAGENET_STD, conv_2d, conv_transpose_2d, normalize_u8, relu, resize_nhwc
from .dino import DinoParams, dino_detect_params, dino_get_intermediate_layers

__all__ = [
    "DepthAnythingParams",
    "depthany_detect_params",
    "depthany_image_extent",
    "depthany_predict",
    "depthany_process_output",
    "DepthAnythingModel",
    "depthany_load_model",
    "depthany_compute",
]


@dataclass(frozen=True)
class DepthAnythingParams:
    dino: DinoParams = DinoParams()
    image_size: int = 518
    image_multiple: int = 14
    max_depth: float = 1.0
    feature_layers: tuple[int, ...] = (2, 5, 8, 11)


def depthany_detect_params(file: GGUFFile) -> DepthAnythingParams:
    return DepthAnythingParams(
        dino=dino_detect_params(file),
        image_size=file.get_int("depthanything.image_size"),
        max_depth=file.get_float("depthanything.max_depth", 1.0),
        feature_layers=tuple(int(i) for i in file.get_array("depthanything.feature_layers")),
    )


def depthany_image_extent(extent: tuple[int, int], p: DepthAnythingParams) -> tuple[int, int]:
    """Snap to short side >= image_size and multiples of 14
    (reference depthany_image_extent, depth-anything.cpp:112-117)."""
    min_side = min(extent)
    tgt_side = max(p.image_size, snap_to_multiple(min_side, p.image_multiple))
    target = (extent[0] * tgt_side // min_side, extent[1] * tgt_side // min_side)
    return shape_bucket(target, p.image_multiple)


# -- DPT neck (reference depth-anything.cpp:12-103) --


def residual_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    out = relu(x)
    out = conv_2d(p["convolution1"], out, 1, 1)
    out = relu(out)
    out = conv_2d(p["convolution2"], out, 1, 1)
    return x + out


def feature_fusion(p: Params, x0: torch.Tensor, x1: torch.Tensor | None = None, size=None) -> torch.Tensor:
    """(reference dpt::feature_fusion, depth-anything.cpp:24-42)."""
    x = x0
    if x1 is not None:
        x = x + residual_conv(p["residual_layer1"], x1)
    x = residual_conv(p["residual_layer2"], x)
    if size is None:
        size = (x.shape[1] * 2, x.shape[2] * 2)
    x = resize_nhwc(x, tuple(size), "bilinear", align_corners=True)
    return conv_2d(p["projection"], x)


def neck(p: Params, features, patch_w: int, patch_h: int) -> torch.Tensor:
    """Reassemble + fuse the 4 backbone layers (depth-anything.cpp:44-83).
    features: list of (N, T+1, C) token tensors."""
    layers = []
    reassemble = p["reassemble_stage.layers"]
    for i in range(4):
        x = features[i][:, 1:]  # drop cls token
        b, t, c = x.shape
        x = x.reshape(b, patch_h, patch_w, c)
        x = conv_2d(reassemble[i]["projection"], x)  # 1x1
        if i == 0:
            x = conv_transpose_2d(reassemble[i]["resize"], x, 4)
        elif i == 1:
            x = conv_transpose_2d(reassemble[i]["resize"], x, 2)
        elif i == 3:
            x = conv_2d(reassemble[i]["resize"], x, 2, 1)
        layers.append(x)

    convs = p["convs"]
    layers = [conv_2d(convs[i], layers[i], 1, 1) for i in range(4)]

    fusion = p["fusion_stage.layers"]
    fused = feature_fusion(fusion[0], layers[3], None, layers[2].shape[1:3])
    fused = feature_fusion(fusion[1], fused, layers[2], layers[1].shape[1:3])
    fused = feature_fusion(fusion[2], fused, layers[1], layers[0].shape[1:3])
    fused = feature_fusion(fusion[3], fused, layers[0])
    return fused


def head(p: Params, x: torch.Tensor, w: int, h: int, max_depth: float) -> torch.Tensor:
    """(reference dpt::head, depth-anything.cpp:85-101)."""
    out = conv_2d(p["conv1"], x, 1, 1)
    out = resize_nhwc(out, (h, w), "bilinear", align_corners=True)
    out = conv_2d(p["conv2"], out, 1, 1)
    out = relu(out)
    out = conv_2d(p["conv3"], out)
    out = relu(out)
    if max_depth != 1.0:
        out = out * max_depth
    return out


def depthany_predict(params: Params, image: torch.Tensor, p: DepthAnythingParams, flash: bool = False) -> torch.Tensor:
    """Full depth model (reference depthany_predict, depth-anything.cpp:105-110).
    image: (N, H, W, 3) normalized -> (N, H, W, 1) depth."""
    n, h, w, _ = image.shape
    w_patch, h_patch = w // p.dino.patch_size, h // p.dino.patch_size
    feats = dino_get_intermediate_layers(params["backbone"], image, p.feature_layers, p.dino, flash)
    fused = neck(params["neck"], feats, w_patch, h_patch)
    return head(params["head"], fused, w, h, p.max_depth)


def fixup_weights(file: GGUFFile, params: dict) -> dict:
    """Undo the converter's arch-specific layout choices
    (scripts/convert.py convert_depth_anything): `patch_embeddings` and
    non-fusion `projection` conv weights are stored pre-permuted (cwhn) even
    in whcn files; `resize` transpose convs are always torch layout.
    ``params``: host numpy arrays and quantized residents, as
    ``load_weights(..., as_numpy=True)`` returns them."""
    if file.tensor_layout in ("cwhn", "torch"):
        # cwhn: generic unpermute already handled everything; torch:
        # every tensor is torch-canonical
        return params
    out = dict(params)
    for name, a in params.items():
        if a.ndim == 4 and name.endswith("weight") and (
            "patch_embeddings" in name or ("projection" in name and "fusion" not in name)
        ):
            out[name] = a.unpermute_cwhn(name) if is_quant(a) else unpermute_cwhn(name, a)
    return out


class DepthAnythingModel:
    """High-level handle (reference depthany_model, vision.cpp:137-168).

    ``params``: torch tensors under the GGUF names; floats are cast to the
    device's float policy here (they are moved nowhere: pass them on the
    device, as :func:`depthany_load_model` does).

    ``mesh``: a (dp, tp) mesh of parallel/ (every rank builds the model from
    its own copy of the weights): DINOv2's q / k / v / output.dense and fc1 / fc2 are tp-sharded
    (DEFAULT_TP_RULES, whole heads a rank); ``forward_u8`` splits its batch over dp
    (rank 0 calls, the other ranks follow, parallel/runner.py), each rank
    replaying its own CUDA graph per shard shape (eagerly where tp > 1)."""

    def __init__(self, params: dict[str, torch.Tensor], p: DepthAnythingParams, device: Device, mesh=None):
        self.p = p
        self.device = device
        self.dtype = device.preferred_float_type
        self.flash = bool(device.flags & BuildFlag.flash_attention)
        self.mesh = mesh
        self.params = cast_float_params(params, self.dtype)
        if mesh is not None:
            heads = lambda name: p.dino.n_heads if ".attention." in name else None  # noqa: E731
            self.params = mesh_params(self.params, mesh, device, heads=heads)
        self.graphs = ForwardGraphs(self._forward_u8, device.torch_device)
        # tp > 1 runs eagerly: an all-reduce inside a capture needs every
        # tp rank to capture the same key together
        local = self.graphs if mesh_tp(mesh) == 1 else self._forward_u8
        self._calls = mesh_entries(self, mesh, forward_u8=local)

    def forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 at a snapped extent -> (N, H, W, 1) raw depth in
        the model dtype, on the model's device. Runs under
        ``torch.inference_mode``, entered here because the mode is thread-local
        and servers call this from their own worker thread. On the card each
        input shape runs as one CUDA graph, captured at its first call and
        replayed after (core/graph.py); the result is a copy that the caller
        keeps."""
        return self._calls["forward_u8"](x_u8)

    def _forward_u8(self, x_u8: torch.Tensor) -> torch.Tensor:
        """The eager forward that :meth:`forward_u8` captures (the reference of its tests)."""
        with torch.inference_mode():
            x = x_u8.to(self.device.torch_device, non_blocking=True)
            x = normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, self.dtype)
            return depthany_predict(Params(self.params), x, self.p, flash=self.flash)

    def compute(self, image: Image) -> Image:
        extent = depthany_image_extent(image.extent, self.p)
        img = image if image.extent == extent else image_scale(image, extent, preprocess_scale_method())
        y = self.forward_u8(torch.from_numpy(img.to_rgb_u8()[None]))
        return depthany_process_output(y[0].float().cpu().numpy(), image.extent)


def depthany_process_output(depth: np.ndarray, target_extent: tuple[int, int]) -> Image:
    """(H, W) or (H, W, 1) raw depth -> min-max normalized alpha f32 at the
    original extent (reference depthany_process_output,
    depth-anything.cpp:142-149)."""
    if depth.ndim == 2:
        depth = depth[:, :, None]
    out = Image(np.ascontiguousarray(depth.astype(np.float32)), ImageFormat.alpha_f32)
    out = image_normalize(out)
    if out.extent != tuple(target_extent):
        out = image_scale(out, tuple(target_extent), preprocess_scale_method())
    return out


def depthany_load_model(filepath: str, device: Device | None = None, mesh=None) -> DepthAnythingModel:
    """Load a Depth-Anything V2 GGUF onto ``device`` (default: the CUDA
    device; without one, backend_init raises). With the device's
    ``keep_quantized`` flag (``VISP_KEEP_QUANT``) block-quantized tensors
    stay int8-resident and dequantize at each use (core/quant.py). ``mesh``:
    place the weights on a mesh of parallel/ for multi-card serving
    (quantized residency is single-card only; a mesh forces dequant)."""
    device = device or backend_init()
    keep_q = bool(device.flags & BuildFlag.keep_quantized) and mesh is None
    file = model_load(filepath)
    p = depthany_detect_params(file)
    params = fixup_weights(file, load_weights(file, as_numpy=True, keep_quantized=keep_q))
    params = params_from_numpy(params, device.torch_device, device.preferred_float_type)
    return DepthAnythingModel(params, p, device, mesh=mesh)


def depthany_compute(model: DepthAnythingModel, image: Image) -> Image:
    return model.compute(image)
