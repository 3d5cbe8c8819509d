"""SAM 3's image encoder at 1008 px served by the program: its weights, its
server, and how a request and its answer look.

The weights are the vision backbone's and the neck's under the converted
GGUF names (``det.ve.*``, the names and shapes of the program's random SAM3
weights at the published widths), each linear and conv drawn at
``1 / sqrt(fan_in)`` so that a layer keeps its input's spread, layer norms
at one and zero, small biases, and the 24 x 24 position table at
``position_std`` (the file's ``weights`` and ``assumed``). They are handed
as float32 to a vision-only ``Sam3Model``, which casts them to the card's
bfloat16, and again, drawn anew from the seed, to the reference.

The answer is a tuple of four float16 feature levels, not an image: the
check reads them through the reference's integer view (``reference.view``)
at the configuration's steps, which :func:`build` binds into
``result_pixels`` from the run's configuration (the harness loads this
module anew for every run, and reads ``result_pixels`` after ``build``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from vbench.reference.sam3_vision_1008 import VIEW_MAX

__all__ = ["weight_specs", "build", "request", "result_pixels", "warm"]


def weight_specs(cfg: dict) -> list:
    d, mlp, fpn = cfg["hidden_size"], cfg["intermediate_size"], cfg["fpn_hidden_size"]
    patch, pre = cfg["patch_size"], cfg["pretrain_image_size"] // cfg["patch_size"]
    w = cfg["weights"]
    specs = []

    def weight(name, shape, fan_in, out):
        specs.append((f"{name}.weight", shape, 1.0 / math.sqrt(fan_in), 0.0))
        specs.append((f"{name}.bias", (out,), w["bias_std"], 0.0))

    def conv(name, ci, co, k):
        weight(name, (co, ci, k, k), ci * k * k, co)

    def conv_t(name, ci, co):  # (in, out, 2, 2) at stride 2: one tap an output pixel
        weight(name, (ci, co, 2, 2), ci, co)

    def lin(name, ci, co):
        weight(name, (co, ci), ci, co)

    def ln(name, c):
        specs.append((f"{name}.weight", (c,), 0.0, 1.0))
        specs.append((f"{name}.bias", (c,), 0.0, 0.0))

    b = "det.ve.backbone"
    conv(f"{b}.embeddings.patch_embeddings.projection", 3, d, patch)
    specs.append((f"{b}.embeddings.position_embeddings", (pre * pre, d), w["position_std"], 0.0))
    ln(f"{b}.layer_norm", d)
    for i in range(cfg["num_hidden_layers"]):
        base = f"{b}.layers.{i}"
        ln(f"{base}.layer_norm1", d)
        ln(f"{base}.layer_norm2", d)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            lin(f"{base}.attention.{proj}", d, d)
        lin(f"{base}.mlp.fc1", d, mlp)
        lin(f"{base}.mlp.fc2", mlp, d)
    f = "det.ve.neck.fpn_layers"
    conv_t(f"{f}.0.scale_layers.0", d, d // 2)
    conv_t(f"{f}.0.scale_layers.2", d // 2, d // 4)
    conv_t(f"{f}.1.scale_layers.0", d, d // 2)
    for i, ci in enumerate((d // 4, d // 2, d, d)):
        conv(f"{f}.{i}.proj1", ci, fpn, 1)
        conv(f"{f}.{i}.proj2", fpn, fpn, 3)
    return specs


def build(weights: dict, cfg: dict, device: str):
    """The served path: a vision-only ``Sam3Model`` behind ``Sam3Server``;
    binds the run's steps into ``result_pixels``."""
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.models.sam3 import Sam3Model, Sam3VitParams
    from vision_tpu_torch.serve import Sam3Server

    global result_pixels
    steps = [float(s) for s in cfg["check"]["steps"]]
    if any(math.frexp(s)[0] != 0.5 for s in steps):
        raise ValueError(f"sam3 config: the view's steps {steps} must be powers of two")
    result_pixels = functools.partial(_view, steps=steps)
    vp = Sam3VitParams(image_size=cfg["image_size"], patch_size=cfg["patch_size"], window_size=cfg["window_size"],
                       n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
                       global_attn_indexes=tuple(cfg["global_attn_indexes"]),
                       scale_factors=tuple(cfg["scale_factors"]))
    model = Sam3Model(weights, None, 0, backend_init(device), vp=vp)
    return Sam3Server(model, **cfg["server"])


def request(pixels):
    from vision_tpu_torch.image import Image, ImageFormat

    return Image(pixels, ImageFormat.rgb_u8)


def _view(levels, steps) -> np.ndarray:
    """The served levels' integer view, (values,) int16, equal to the
    reference's ``view``: each level scaled by 1 / step in float16 (exact,
    the step a power of two), rounded half to even and clipped to
    +-VIEW_MAX in place, then cast into its slice of the view. One float16
    copy of a level at a time and no float32 copy: it runs on a client
    thread inside the timed window."""
    out = torch.empty(sum(lv.size for lv in levels), dtype=torch.int16)
    at = 0
    for lv, step in zip(levels, steps):
        scaled = torch.from_numpy(lv).reshape(-1).mul(1.0 / step).round_().clamp_(-VIEW_MAX, VIEW_MAX)
        out[at:at + scaled.numel()].copy_(scaled)
        at += scaled.numel()
    return out.numpy()


def result_pixels(result) -> np.ndarray:
    """The served answer's integer view; :func:`build` binds the run's
    steps (``_view``)."""
    raise RuntimeError("sam3 config: build() binds the view's steps into result_pixels first")


def warm(server, extent) -> None:
    server.warmup(tuple(extent))
