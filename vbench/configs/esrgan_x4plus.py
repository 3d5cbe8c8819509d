"""RealESRGAN_x4plus served by the program: its weights, its server, and how
a request and its answer look.

The weights are the RRDBNet's under the converted GGUF names, each conv
drawn at ``1 / sqrt(fan_in)`` so that a layer keeps its input's spread,
the biases small, and the last conv scaled and shifted so that the served
pixels spread over the middle of their range (the file's ``weights`` and
``assumed``). They are handed as float32 to ``EsrganModel``, which casts
them to the card's bfloat16, and again, drawn anew from the seed, to the
reference.
"""

from __future__ import annotations

import math

__all__ = ["weight_specs", "build", "request", "result_pixels", "warm"]


def weight_specs(cfg: dict) -> list:
    nf, nb, gc, scale = cfg["num_feat"], cfg["num_block"], cfg["num_grow_ch"], cfg["scale"]
    w = cfg["weights"]
    specs = []

    def conv(name, ci, co, gain=1.0, bias_mean=0.0):
        specs.append((f"{name}.weight", (co, ci, 3, 3), gain / math.sqrt(ci * 9), 0.0))
        specs.append((f"{name}.bias", (co,), w["bias_std"], bias_mean))

    conv("model.0", cfg["num_in_ch"], nf)
    for i in range(nb):
        for r in (1, 2, 3):
            base = f"model.1.sub.{i}.RDB{r}"
            for j in range(1, 5):
                conv(f"{base}.conv{j}.0", nf + (j - 1) * gc, gc)
            conv(f"{base}.conv5.0", nf + 4 * gc, nf)
    conv(f"model.1.sub.{nb}", nf, nf)
    seq = 2
    for _ in range(int(math.log2(scale))):
        conv(f"model.{seq + 1}", nf, nf)
        seq += 3
    conv(f"model.{seq}", nf, nf)
    conv(f"model.{seq + 2}", nf, cfg["num_out_ch"], gain=w["last_gain"], bias_mean=w["last_bias"])
    return specs


def build(weights: dict, cfg: dict, device: str):
    """The served path: ``EsrganModel`` behind ``EsrganServer``."""
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.models.esrgan import EsrganModel, EsrganParams
    from vision_tpu_torch.serve import EsrganServer

    model = EsrganModel(weights, EsrganParams(cfg["scale"], cfg["num_block"]), backend_init(device))
    return EsrganServer(model, **cfg["server"])


def request(pixels):
    from vision_tpu_torch.image import Image, ImageFormat

    return Image(pixels, ImageFormat.rgb_u8)


def result_pixels(result):
    """The served rgba_u8 image, (4 H, 4 W, 4)."""
    return result.data


def warm(server, extent) -> None:
    server.warmup(tuple(extent))
