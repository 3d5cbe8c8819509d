"""BiRefNet SWIN-L at 1024x1024 served by the program: its weights, its
server, and how a request and its answer look.

The weights are BiRefNet's under the converted GGUF names (the names and
shapes of the program's random BiRefNet weights), each linear and conv
drawn at ``1 / sqrt(fan_in)`` so that a layer keeps its input's spread,
layer norms at one and zero, BatchNorms near one, the relative position
tables at 0.02, small biases, and the last conv scaled so that the matte's
logits spread over the sigmoid's middle (the file's ``weights`` and
``assumed``). They are handed as float32 to ``BirefnetModel``, which casts
them to the card's bfloat16, and again, drawn anew from the seed, to the
reference.
"""

from __future__ import annotations

import math

__all__ = ["weight_specs", "build", "request", "result_pixels", "warm"]


def weight_specs(cfg: dict) -> list:
    sw, dec, w = cfg["swin"], cfg["decoder"], cfg["weights"]
    embed, window = sw["embed_dim"], sw["window_size"]
    dims = [embed * 2**i for i in range(len(sw["depths"]))]
    bias_std = w["bias_std"]
    specs = []

    def weight(name, shape, fan_in, g=1.0):
        specs.append((name, shape, g / math.sqrt(fan_in), 0.0))

    def bias(name, n, mean=0.0):
        specs.append((name, (n,), bias_std, mean))

    def conv(name, ci, co, k, with_bias=True, g=1.0, bias_mean=0.0):
        weight(f"{name}.weight", (co, ci, k, k), ci * k * k, g)
        if with_bias:
            bias(f"{name}.bias", co, bias_mean)

    def lin(name, ci, co, with_bias=True):
        weight(f"{name}.weight", (co, ci), ci)
        if with_bias:
            bias(f"{name}.bias", co)

    def ln(name, c):
        specs.append((f"{name}.weight", (c,), 0.0, 1.0))
        specs.append((f"{name}.bias", (c,), 0.0, 0.0))

    conv("bb.patch_embed.proj", 3, embed, 4)
    ln("bb.patch_embed.norm", embed)
    for s, (depth, heads) in enumerate(zip(sw["depths"], sw["num_heads"])):
        d = dims[s]
        for i in range(depth):
            base = f"bb.layers.{s}.blocks.{i}"
            ln(f"{base}.norm1", d)
            ln(f"{base}.norm2", d)
            lin(f"{base}.attn.qkv", d, 3 * d)
            lin(f"{base}.attn.proj", d, d)
            specs.append((f"{base}.attn.relative_position_bias_table", ((2 * window - 1) ** 2, heads),
                          w["rel_pos_std"], 0.0))
            lin(f"{base}.mlp.fc1", d, 4 * d)
            lin(f"{base}.mlp.fc2", 4 * d, d)
        if s < len(dims) - 1:
            ln(f"bb.layers.{s}.downsample.norm", 4 * d)
            lin(f"bb.layers.{s}.downsample.reduction", 4 * d, 2 * d, with_bias=False)
    for i, d in enumerate(dims):
        ln(f"bb.norm{i}", d)

    cat = [2 * d for d in dims]
    ch, ipt = dec["channels"], dec["ipt_channels"]

    def deform(name, ci, co, k):
        conv(f"{name}.offset", ci, 2 * k * k, k)
        conv(f"{name}.modulator", ci, k * k, k)
        weight(f"{name}.conv.weight", (co, ci, k, k), ci * k * k)

    def bn(name, c):
        specs.append((f"{name}.weight", (c,), 0.02, 1.0))
        specs.append((f"{name}.bias", (c,), bias_std, 0.0))

    def dec_blk(name, ci, co):
        conv(f"{name}.conv_in", ci, ch, 3)
        deform(f"{name}.dec_att.aspp1.conv", ch, ch // 4, 1)
        bn(f"{name}.dec_att.aspp1.bn", ch // 4)
        for j, k in enumerate((1, 3, 7)):
            deform(f"{name}.dec_att.aspp_deforms.{j}.conv", ch, ch // 4, k)
            bn(f"{name}.dec_att.aspp_deforms.{j}.bn", ch // 4)
        conv(f"{name}.dec_att.global_avg_pool.1", ch, ch // 4, 1)
        conv(f"{name}.dec_att.conv1", 5 * (ch // 4), ch, 1)
        conv(f"{name}.conv_out", ch, co, 3)

    def simple(name, ci, co, inter=64):
        conv(f"{name}.conv1", ci, inter, 3)
        conv(f"{name}.conv_out", inter, co, 3)

    dec_blk("squeeze_module.0", sum(cat), ch)
    d = "decoder"
    for blk, patch in (("ipt_blk5", 32), ("ipt_blk4", 16), ("ipt_blk3", 8), ("ipt_blk2", 4), ("ipt_blk1", 1)):
        simple(f"{d}.{blk}", 3 * patch * patch, ipt)
    for blk in ("block4", "block3", "block2", "block1"):
        dec_blk(f"{d}.{blk}", ch + ipt, ch)
    for i in (2, 3, 4):
        conv(f"{d}.gdt_convs_{i}.0", ch, 16, 3)
        conv(f"{d}.gdt_convs_attn_{i}.0", 16, 1, 1)
    conv(f"{d}.lateral_block4.conv", cat[2], ch, 1)
    conv(f"{d}.lateral_block3.conv", cat[1], ch, 1)
    conv(f"{d}.lateral_block2.conv", cat[0], ch, 1)
    conv(f"{d}.conv_out1.0", ch + ipt, 1, 1, g=w["last_gain"], bias_mean=w["last_bias"])
    return specs


def build(weights: dict, cfg: dict, device: str):
    """The served path: ``BirefnetModel`` behind ``ImageServer``."""
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.models.birefnet import BirefnetModel, BirefnetParams
    from vision_tpu_torch.models.swin import SwinLayerParams, SwinParams
    from vision_tpu_torch.serve import ImageServer

    sw = cfg["swin"]
    layers = tuple(SwinLayerParams(d, h, sw["embed_dim"] * 2**i)
                   for i, (d, h) in enumerate(zip(sw["depths"], sw["num_heads"])))
    size = cfg["image_size"]
    p = BirefnetParams(image_size=size, image_extent=(size, size),
                       encoder=SwinParams(sw["embed_dim"], sw["window_size"], layers))
    model = BirefnetModel(weights, p, backend_init(device))
    return ImageServer(model, **cfg["server"])


def request(pixels):
    from vision_tpu_torch.image import Image, ImageFormat

    return Image(pixels, ImageFormat.rgb_u8)


def result_pixels(result):
    """The served alpha_u8 matte, (H, W, 1)."""
    return result.data


def warm(server, extent) -> None:
    server.warmup(tuple(extent))
