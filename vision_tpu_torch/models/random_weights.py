"""Random full-size parameter sets for benchmarking and dry-runs (a numpy
copy of the parts of vision_tpu/models/random_weights.py that the ported
slices use: same seeds, same arrays).

There are no model checkpoints in the build environment (zero egress), so
benchmarks and compile validation use randomly initialized weights with the
exact production shapes/names — performance is weight-value independent.
Shapes mirror the reference's converted GGUF layout (SURVEY.md M1/M5).
"""

from __future__ import annotations

import itertools
import math

import numpy as np

__all__ = [
    "random_mobile_sam_params",
    "random_esrgan_params",
    "random_depth_anything_params",
    "random_birefnet_params",
    "random_sam3_vision_params",
    "random_migan_params",
    "random_yolov9t_params",
]


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


def _attention_bias_indexed(rng, heads: int, window: int) -> np.ndarray:
    points = list(itertools.product(range(window), range(window)))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            offsets.setdefault(off, len(offsets))
            idxs.append(offsets[off])
    table = rng.standard_normal((heads, len(offsets))).astype(np.float32) * 0.02
    idx = np.asarray(idxs, np.int64).reshape(window * window, window * window)
    return table[:, idx]


def random_mobile_sam_params(seed: int = 0) -> dict[str, np.ndarray]:
    """Full TinyViT-5M MobileSAM weight dict (GGUF names, torch shapes)."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def w(name, *shape, scale=None):
        if scale is None:
            fan_in = shape[1] if len(shape) >= 2 else shape[0]
            if len(shape) == 4:
                fan_in = shape[1] * shape[2] * shape[3]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        p[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def b(name, n):
        p[name] = np.zeros(n, np.float32)

    def conv_bn(name, ci, co, k):
        w(f"{name}.c.weight", co, ci, k, k)
        b(f"{name}.c.bias", co)

    def dw_bn(name, c, k=3):
        w(f"{name}.c.weight", c, 1, k, k)
        b(f"{name}.c.bias", c)

    def ln(name, c):
        p[f"{name}.weight"] = np.ones(c, np.float32)
        p[f"{name}.bias"] = np.zeros(c, np.float32)

    def lin(name, ci, co):
        w(f"{name}.weight", co, ci)
        b(f"{name}.bias", co)

    # --- encoder (TinyViT-5M) ---
    dims = [64, 128, 160, 320]
    depths = [2, 2, 6, 2]
    heads = [2, 4, 5, 10]
    windows = [7, 7, 14, 7]

    conv_bn("enc.patch_embed.seq.0", 3, dims[0] // 2, 3)
    conv_bn("enc.patch_embed.seq.2", dims[0] // 2, dims[0], 3)

    # stage 0: MBConv
    for i in range(depths[0]):
        base = f"enc.layers.0.blocks.{i}"
        hid = dims[0] * 4
        conv_bn(f"{base}.conv1", dims[0], hid, 1)
        dw_bn(f"{base}.conv2", hid)
        conv_bn(f"{base}.conv3", hid, dims[0], 1)
    conv_bn("enc.layers.0.downsample.conv1", dims[0], dims[1], 1)
    dw_bn("enc.layers.0.downsample.conv2", dims[1])
    conv_bn("enc.layers.0.downsample.conv3", dims[1], dims[1], 1)

    for stage in (1, 2, 3):
        d = dims[stage]
        for i in range(depths[stage]):
            base = f"enc.layers.{stage}.blocks.{i}"
            ln(f"{base}.attn.norm", d)
            lin(f"{base}.attn.qkv", d, 3 * d)
            lin(f"{base}.attn.proj", d, d)
            p[f"{base}.attn.attention_biases_indexed"] = _attention_bias_indexed(
                rng, heads[stage], windows[stage]
            )
            dw_bn(f"{base}.local_conv", d)
            ln(f"{base}.mlp.norm", d)
            lin(f"{base}.mlp.fc1", d, d * 4)
            lin(f"{base}.mlp.fc2", d * 4, d)
        if stage < 3:
            nd = dims[stage + 1]
            conv_bn(f"enc.layers.{stage}.downsample.conv1", d, nd, 1)
            dw_bn(f"enc.layers.{stage}.downsample.conv2", nd)
            conv_bn(f"enc.layers.{stage}.downsample.conv3", nd, nd, 1)

    w("enc.neck.0.weight", 256, dims[3], 1, 1)
    ln("enc.neck.1", 256)
    w("enc.neck.2.weight", 256, 256, 3, 3)
    ln("enc.neck.3", 256)

    # --- prompt encoder ---
    w("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix", 2, 128, scale=1.0)
    for i in range(4):
        w(f"prompt_encoder.point_embeddings.{i}.weight", 1, 256)
    w("prompt_encoder.not_a_point_embed.weight", 1, 256)
    w("prompt_encoder.no_mask_embed.weight", 1, 256)

    # --- mask decoder ---
    w("dec.iou_token.weight", 1, 256)
    w("dec.mask_tokens.weight", 4, 256)
    for i in range(2):
        base = f"dec.transformer.layers.{i}"
        for attn, inner in (("self_attn", 256), ("cross_attn_t2i", 128), ("cross_attn_i2t", 128)):
            lin(f"{base}.{attn}.q_proj", 256, inner)
            lin(f"{base}.{attn}.k_proj", 256, inner)
            lin(f"{base}.{attn}.v_proj", 256, inner)
            lin(f"{base}.{attn}.out_proj", inner, 256)
        for n in (1, 2, 3, 4):
            ln(f"{base}.norm{n}", 256)
        lin(f"{base}.mlp.lin1", 256, 2048)
        lin(f"{base}.mlp.lin2", 2048, 256)
    lin("dec.transformer.final_attn_t2i.q_proj", 256, 128)
    lin("dec.transformer.final_attn_t2i.k_proj", 256, 128)
    lin("dec.transformer.final_attn_t2i.v_proj", 256, 128)
    lin("dec.transformer.final_attn_t2i.out_proj", 128, 256)
    ln("dec.transformer.norm_final_attn", 256)
    w("dec.output_upscaling.0.weight", 256, 64, 2, 2)
    b("dec.output_upscaling.0.bias", 64)
    ln("dec.output_upscaling.1", 64)
    w("dec.output_upscaling.3.weight", 64, 32, 2, 2)
    b("dec.output_upscaling.3.bias", 32)
    for i in range(4):
        lin(f"dec.output_hypernetworks_mlps.{i}.layers.0", 256, 256)
        lin(f"dec.output_hypernetworks_mlps.{i}.layers.1", 256, 256)
        lin(f"dec.output_hypernetworks_mlps.{i}.layers.2", 256, 32)
    lin("dec.iou_prediction_head.layers.0", 256, 256)
    lin("dec.iou_prediction_head.layers.1", 256, 256)
    lin("dec.iou_prediction_head.layers.2", 256, 4)

    # dense positional embedding baked from the gaussian matrix
    # (reference convert.py:265-282)
    g = p["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    h = wdt = 64
    ye = (np.arange(h, dtype=np.float32)[:, None] + 0.5) / h
    xe = (np.arange(wdt, dtype=np.float32)[None, :] + 0.5) / wdt
    coords = np.stack(np.broadcast_arrays(xe, ye), axis=-1)  # (64, 64, 2)
    proj = (2 * coords - 1) @ g * (2 * np.pi)
    p["dec.dense_positional_embedding"] = np.concatenate(
        [np.sin(proj), np.cos(proj)], axis=-1
    ).astype(np.float32)
    return p


def random_esrgan_params(seed: int = 0, nf: int = 64, nb: int = 23, gc: int = 32) -> dict[str, np.ndarray]:
    """RealESRGAN-x4 RRDBNet weight dict (old-arch names)."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def conv(name, ci, co, k=3):
        scale = 0.2 / math.sqrt(ci * k * k)
        p[f"{name}.weight"] = (rng.standard_normal((co, ci, k, k)) * scale).astype(np.float32)
        p[f"{name}.bias"] = np.zeros(co, np.float32)

    conv("model.0", 3, nf)
    for i in range(nb):
        for r in (1, 2, 3):
            base = f"model.1.sub.{i}.RDB{r}"
            for j in range(1, 5):
                conv(f"{base}.conv{j}.0", nf + (j - 1) * gc, gc)
            conv(f"{base}.conv5.0", nf + 4 * gc, nf)
    conv(f"model.1.sub.{nb}", nf, nf)
    conv("model.3", nf, nf)
    conv("model.6", nf, nf)
    conv("model.8", nf, nf)
    conv("model.10", nf, 3)
    return p


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


def random_migan_params(resolution: int = 512, seed: int = 0) -> dict[str, np.ndarray]:
    """MI-GAN generator weight dict (original checkpoint naming)."""
    B = _Builder(seed)
    nf = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32}

    def sep(name, ci, co, res_out, down=False, up=False, noise=False):
        B.dwconv(f"{name}.conv1", ci, 3, bias=False)
        if down:
            B.dwconv(f"{name}.downsample.filter", ci, 3, bias=False)
        B.conv(f"{name}.conv2", ci, co, 1)
        if up:
            B.dwconv(f"{name}.upsample.filter", co, 4, bias=False)
            B.p[f"{name}.upsample.filter_const"] = np.full((res_out * 2, res_out * 2), 4.0, np.float32)
        if noise:
            out_res = res_out * 2 if up else res_out
            B.p[f"{name}.noise_const"] = (B.rng.standard_normal((out_res, out_res)) * 0.1).astype(np.float32)
            B.p[f"{name}.noise_strength"] = np.zeros((), np.float32)

    n = int(math.log2(resolution)) - 1
    # encoder
    B.conv(f"encoder.b{resolution}.fromrgb", 4, nf[resolution], 1)
    for i in range(n - 1):
        res = resolution >> i
        ci, co = nf[res], nf[res >> 1]
        sep(f"encoder.b{res}.conv1", ci, ci, res)
        sep(f"encoder.b{res}.conv2", ci, co, res, down=True)
    sep("encoder.b4.conv1", nf[4], nf[4], 4)
    sep("encoder.b4.conv2", nf[4], nf[4], 4)
    # synthesis
    sep("synthesis.b4.conv1", nf[4], nf[4], 4)
    sep("synthesis.b4.conv2", nf[4], nf[4], 4)
    B.conv("synthesis.b4.torgb", nf[4], 3, 1)
    for i in range(n - 2, -1, -1):
        res = resolution >> i
        ci, co = nf[res >> 1], nf[res]
        sep(f"synthesis.b{res}.conv1", ci, co, res >> 1, up=True, noise=True)
        sep(f"synthesis.b{res}.conv2", co, co, res, noise=True)
        B.conv(f"synthesis.b{res}.torgb", co, 3, 1)
        B.dwconv(f"synthesis.b{res}.upsample.filter", 3, 4, bias=False)
        B.p[f"synthesis.b{res}.upsample.filter_const"] = np.full((res, res), 4.0, np.float32)
    return B.p


def random_yolov9t_params(seed: int = 0, nc: int = 80) -> dict[str, np.ndarray]:
    """YOLOv9t weight dict (model.0..21 + detect, BN as fused scale/shift)."""
    B = _Builder(seed)

    def cv(name, ci, co, k):
        B.conv(f"{name}.conv", ci, co, k, bias=False)
        B.scale_shift(f"{name}.bn", co)

    def rep(name, ci, co):
        cv(f"{name}.conv1", ci, co, 3)
        cv(f"{name}.conv2", ci, co, 1)

    def repcsp(name, ci, co, n=3, e=0.5):
        c_ = int(co * e)
        cv(f"{name}.cv1", ci, c_, 1)
        cv(f"{name}.cv2", ci, c_, 1)
        cv(f"{name}.cv3", 2 * c_, co, 1)
        for i in range(n):
            rep(f"{name}.m.{i}.cv1", c_, c_)
            cv(f"{name}.m.{i}.cv2", c_, c_, 3)

    def rep4(name, ci, co, c3, c4, n=3):
        cv(f"{name}.cv1", ci, c3, 1)
        repcsp(f"{name}.cv2.0", c3 // 2, c4, n)
        cv(f"{name}.cv2.1", c4, c4, 3)
        repcsp(f"{name}.cv3.0", c4, c4, n)
        cv(f"{name}.cv3.1", c4, c4, 3)
        cv(f"{name}.cv4", c3 + 2 * c4, co, 1)

    def elan1(name, ci, co, c3, c4):
        cv(f"{name}.cv1", ci, c3, 1)
        cv(f"{name}.cv2", c3 // 2, c4, 3)
        cv(f"{name}.cv3", c4, c4, 3)
        cv(f"{name}.cv4", c3 + 2 * c4, co, 1)

    def aconv(name, ci, co):
        cv(f"{name}.cv1", ci, co, 3)

    cv("model.0", 3, 16, 3)
    cv("model.1", 16, 32, 3)
    elan1("model.2", 32, 32, 32, 16)
    aconv("model.3", 32, 64)
    rep4("model.4", 64, 64, 64, 32)
    aconv("model.5", 64, 96)
    rep4("model.6", 96, 96, 96, 48)
    aconv("model.7", 96, 128)
    rep4("model.8", 128, 128, 128, 64)
    cv("model.9.cv1", 128, 64, 1)
    cv("model.9.cv5", 256, 128, 1)
    rep4("model.12", 224, 96, 96, 48)
    rep4("model.15", 160, 64, 64, 32)
    aconv("model.16", 64, 48)
    rep4("model.18", 144, 96, 96, 48)
    aconv("model.19", 96, 64)
    rep4("model.21", 192, 128, 128, 64)
    ch = [64, 96, 128]
    c2h = max(16, ch[0] // 4, 64)
    c3h = max(ch[0], min(nc, 100))
    for i, c in enumerate(ch):
        cv(f"detect.cv2.{i}.0", c, c2h, 3)
        cv(f"detect.cv2.{i}.1", c2h, c2h, 3)
        B.conv(f"detect.cv2.{i}.2", c2h, 64, 1)
        cv(f"detect.cv3.{i}.0", c, c3h, 3)
        cv(f"detect.cv3.{i}.1", c3h, c3h, 3)
        B.conv(f"detect.cv3.{i}.2", c3h, nc, 1)
    return B.p


def random_birefnet_params(variant: str = "tiny", seed: int = 0) -> dict[str, np.ndarray]:
    """BiRefNet weight dict (bb. SWIN backbone + decoder, converted naming)."""
    B = _Builder(seed)
    embed = 96 if variant == "tiny" else 192
    window = 7 if variant == "tiny" else 12
    depths = (2, 2, 6, 2) if variant == "tiny" else (2, 2, 18, 2)
    heads = (3, 6, 12, 24) if variant == "tiny" else (6, 12, 24, 48)
    dims = [embed * (2**i) for i in range(4)]

    B.w("bb.patch_embed.proj.weight", embed, 3, 4, 4)
    B.b("bb.patch_embed.proj.bias", embed)
    B.ln("bb.patch_embed.norm", embed)
    for s in range(4):
        d = dims[s]
        for i in range(depths[s]):
            base = f"bb.layers.{s}.blocks.{i}"
            B.ln(f"{base}.norm1", d)
            B.ln(f"{base}.norm2", d)
            B.lin(f"{base}.attn.qkv", d, 3 * d)
            B.lin(f"{base}.attn.proj", d, d)
            B.p[f"{base}.attn.relative_position_bias_table"] = (
                B.rng.standard_normal(((2 * window - 1) ** 2, heads[s])) * 0.02
            ).astype(np.float32)
            B.lin(f"{base}.mlp.fc1", d, d * 4)
            B.lin(f"{base}.mlp.fc2", d * 4, d)
        if s < 3:
            B.ln(f"bb.layers.{s}.downsample.norm", 4 * d)
            B.lin(f"bb.layers.{s}.downsample.reduction", 4 * d, 2 * d, bias=False)
    for i in range(4):
        B.ln(f"bb.norm{i}", dims[i])

    cat = [2 * d for d in dims]
    cat3 = sum(cat)
    ch, ipt = 112, 64

    def deform(name, ci, co, k):
        B.conv(f"{name}.offset", ci, 2 * k * k, k)
        B.conv(f"{name}.modulator", ci, k * k, k)
        B.w(f"{name}.conv.weight", co, ci, k, k)

    def dec_blk(name, ci, co, inter=ch):
        B.conv(f"{name}.conv_in", ci, inter, 3)
        deform(f"{name}.dec_att.aspp1.conv", inter, inter // 4, 1)
        B.scale_shift(f"{name}.dec_att.aspp1.bn", inter // 4)
        for j, k in enumerate((1, 3, 7)):
            deform(f"{name}.dec_att.aspp_deforms.{j}.conv", inter, inter // 4, k)
            B.scale_shift(f"{name}.dec_att.aspp_deforms.{j}.bn", inter // 4)
        B.conv(f"{name}.dec_att.global_avg_pool.1", inter, inter // 4, 1)
        B.conv(f"{name}.dec_att.conv1", 5 * (inter // 4), inter, 1)
        B.conv(f"{name}.conv_out", inter, co, 3)

    def simple(name, ci, co, inter=64):
        B.conv(f"{name}.conv1", ci, inter, 3)
        B.conv(f"{name}.conv_out", inter, co, 3)

    dec_blk("squeeze_module.0", cat3, ch)
    d = "decoder"
    simple(f"{d}.ipt_blk5", 3 * 32 * 32, ipt)
    simple(f"{d}.ipt_blk4", 3 * 16 * 16, ipt)
    simple(f"{d}.ipt_blk3", 3 * 8 * 8, ipt)
    simple(f"{d}.ipt_blk2", 3 * 4 * 4, ipt)
    simple(f"{d}.ipt_blk1", 3, ipt)
    dec_blk(f"{d}.block4", ch + ipt, ch)
    dec_blk(f"{d}.block3", ch + ipt, ch)
    dec_blk(f"{d}.block2", ch + ipt, ch)
    dec_blk(f"{d}.block1", ch + ipt, ch)
    for i in (2, 3, 4):
        B.conv(f"{d}.gdt_convs_{i}.0", ch, 16, 3)
        B.conv(f"{d}.gdt_convs_attn_{i}.0", 16, 1, 1)
    B.conv(f"{d}.lateral_block4.conv", cat[2], ch, 1)
    B.conv(f"{d}.lateral_block3.conv", cat[1], ch, 1)
    B.conv(f"{d}.lateral_block2.conv", cat[0], ch, 1)
    B.conv(f"{d}.conv_out1.0", ch + ipt, 1, 1)
    return B.p


def random_sam3_vision_params(seed: int = 0, dim: int = 1280, layers: int = 32, fpn_ch: int = 256,
                              mlp: int | None = None, pos_grid: int = 1008 // 14) -> dict[str, np.ndarray]:
    """SAM3 RoPE-ViT vision encoder + FPN neck (det.ve.* naming without the
    prefix), with an MLP of ``mlp`` (default 4 x dim) and a ``pos_grid`` x
    ``pos_grid`` position table. The defaults, width 1280, MLP 4 x 1280 =
    5120 and a 72 x 72 position table, are a ViT-H-scale stand-in, not SAM
    3's published backbone (width 1024, MLP 4736, a 24 x 24 table tiled 3 x
    3: ``dim=1024, mlp=4736, pos_grid=24``); the card's smoke phases and the
    vision-bench row run the defaults."""
    B = _Builder(seed)
    mlp = 4 * dim if mlp is None else mlp
    B.conv("backbone.embeddings.patch_embeddings.projection", 3, dim, 14)
    B.p["backbone.embeddings.position_embeddings"] = (
        B.rng.standard_normal((pos_grid * pos_grid, dim)) * 0.02
    ).astype(np.float32)
    B.ln("backbone.layer_norm", dim)
    for i in range(layers):
        base = f"backbone.layers.{i}"
        B.ln(f"{base}.layer_norm1", dim)
        B.ln(f"{base}.layer_norm2", dim)
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            B.lin(f"{base}.attention.{proj}", dim, dim)
        B.lin(f"{base}.mlp.fc1", dim, mlp)
        B.lin(f"{base}.mlp.fc2", mlp, dim)
    # FPN neck
    B.convT("neck.fpn_layers.0.scale_layers.0", dim, dim // 2, 2)
    B.convT("neck.fpn_layers.0.scale_layers.2", dim // 2, dim // 4, 2)
    B.conv("neck.fpn_layers.0.proj1", dim // 4, fpn_ch, 1)
    B.conv("neck.fpn_layers.0.proj2", fpn_ch, fpn_ch, 3)
    B.convT("neck.fpn_layers.1.scale_layers.0", dim, dim // 2, 2)
    B.conv("neck.fpn_layers.1.proj1", dim // 2, fpn_ch, 1)
    B.conv("neck.fpn_layers.1.proj2", fpn_ch, fpn_ch, 3)
    for i in (2, 3):
        B.conv(f"neck.fpn_layers.{i}.proj1", dim, fpn_ch, 1)
        B.conv(f"neck.fpn_layers.{i}.proj2", fpn_ch, fpn_ch, 3)
    return B.p
