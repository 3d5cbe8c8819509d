"""Random full-size parameter sets for benchmarking and dry-runs (a numpy
copy of the parts of vision_tpu/models/random_weights.py that the ported
slices use: same seeds, same arrays).

There are no model checkpoints in the build environment (zero egress), so
benchmarks and compile validation use randomly initialized weights with the
exact production shapes/names — performance is weight-value independent.
Shapes mirror the reference's converted GGUF layout (SURVEY.md M1/M5).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["random_depth_anything_params"]


class _Builder:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.p: dict[str, np.ndarray] = {}

    def w(self, name, *shape, scale=None):
        if scale is None:
            fan_in = shape[1] if len(shape) >= 2 else shape[0]
            if len(shape) == 4:
                fan_in = shape[1] * shape[2] * shape[3]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        self.p[name] = (self.rng.standard_normal(shape) * scale).astype(np.float32)

    def b(self, name, n):
        self.p[name] = np.zeros(n, np.float32)

    def conv(self, name, ci, co, k, bias=True):
        self.w(f"{name}.weight", co, ci, k, k)
        if bias:
            self.b(f"{name}.bias", co)

    def dwconv(self, name, c, k, bias=True):
        self.w(f"{name}.weight", c, 1, k, k)
        if bias:
            self.b(f"{name}.bias", c)

    def convT(self, name, ci, co, k, bias=True):
        self.w(f"{name}.weight", ci, co, k, k)
        if bias:
            self.b(f"{name}.bias", co)

    def lin(self, name, ci, co, bias=True):
        self.w(f"{name}.weight", co, ci)
        if bias:
            self.b(f"{name}.bias", co)

    def ln(self, name, c):
        self.p[f"{name}.weight"] = np.ones(c, np.float32)
        self.p[f"{name}.bias"] = np.zeros(c, np.float32)

    def scale_shift(self, name, c):
        self.p[f"{name}.weight"] = (np.ones(c) + self.rng.standard_normal(c) * 0.02).astype(np.float32)
        self.p[f"{name}.bias"] = np.zeros(c, np.float32)


def random_depth_anything_params(variant: str = "small", seed: int = 0) -> dict[str, np.ndarray]:
    """Depth-Anything V2 weight dict (HF naming under backbone./neck./head.)."""
    dims = {
        "small": (384, 6, 12, (48, 96, 192, 384)),
        "base": (768, 12, 12, (96, 192, 384, 768)),
        # reduced config for structural tests (serving/batching): the full
        # "small" graph costs minutes of XLA-CPU compile per shape bucket
        "test": (64, 2, 4, (16, 32, 48, 64)),
    }
    dim, heads, layers, feat_ch = dims[variant]
    B = _Builder(seed)
    grid = 518 // 14
    B.p["backbone.embeddings.cls_token"] = np.zeros((1, 1, dim), np.float32)
    B.p["backbone.embeddings.position_embeddings"] = (
        B.rng.standard_normal((1, grid * grid + 1, dim)) * 0.02
    ).astype(np.float32)
    B.conv("backbone.embeddings.patch_embeddings.projection", 3, dim, 14)
    for i in range(layers):
        base = f"backbone.encoder.layer.{i}"
        B.ln(f"{base}.norm1", dim)
        B.ln(f"{base}.norm2", dim)
        for qkv in ("query", "key", "value"):
            B.lin(f"{base}.attention.attention.{qkv}", dim, dim)
        B.lin(f"{base}.attention.output.dense", dim, dim)
        B.p[f"{base}.layer_scale1.lambda1"] = np.full(dim, 1.0, np.float32)
        B.p[f"{base}.layer_scale2.lambda1"] = np.full(dim, 1.0, np.float32)
        B.lin(f"{base}.mlp.fc1", dim, dim * 4)
        B.lin(f"{base}.mlp.fc2", dim * 4, dim)
    B.ln("backbone.layernorm", dim)
    fusion_ch = {"small": 64, "base": 128, "test": 32}[variant]
    for i, fc in enumerate(feat_ch):
        lay = f"neck.reassemble_stage.layers.{i}"
        B.conv(f"{lay}.projection", dim, fc, 1)
        if i == 0:
            B.convT(f"{lay}.resize", fc, fc, 4)
        elif i == 1:
            B.convT(f"{lay}.resize", fc, fc, 2)
        elif i == 3:
            B.conv(f"{lay}.resize", fc, fc, 3)
        B.conv(f"neck.convs.{i}", fc, fusion_ch, 3, bias=False)
    for i in range(4):
        fl = f"neck.fusion_stage.layers.{i}"
        for r in (1, 2):
            B.conv(f"{fl}.residual_layer{r}.convolution1", fusion_ch, fusion_ch, 3)
            B.conv(f"{fl}.residual_layer{r}.convolution2", fusion_ch, fusion_ch, 3)
        B.conv(f"{fl}.projection", fusion_ch, fusion_ch, 1)
    B.conv("head.conv1", fusion_ch, fusion_ch // 2, 3)
    B.conv("head.conv2", fusion_ch // 2, 32, 3)
    B.conv("head.conv3", 32, 1, 1)
    return B.p


