"""Model weight conversion: torch checkpoints (.pt/.pth/.safetensors) -> GGUF.

The port's copy of vision_tpu/convert/convert.py: the same renames,
fusions, tables, layouts and block quantization over the port's own core
modules (gguf, quantize, weights), and the same bytes out
(tests/test_torch_convert.py). A re-provision of the reference's
scripts/convert.py with identical output semantics so the produced files
interoperate with both frameworks:

  * per-arch tensor renames (image_encoder->enc, mask_decoder->dec, ...)
  * conv+BN fusion into a single conv with bias (convert.py:157-197) and
    standalone BN->mul/add fusion (convert.py:133-154)
  * SAM attention-bias index tables and dense positional embeddings baked
    at conversion (convert.py:250-282)
  * per-arch metadata KVs ({arch}.image_size, swin.embed_dim, dino.*, ...)
  * layout: torch NCHW ("whcn") by default with a `{arch}.conv2d_weights`
    index list, or pre-permuted "cwhn" on request

Usage: python -m vision_tpu_torch.convert.convert <arch> model.pth -o out.gguf [-q q8_0] [--layout cwhn]
(installed as ``vision-convert-torch``).
"""

from __future__ import annotations

import argparse
import itertools
from pathlib import Path

import numpy as np

from ..core.errors import raise_error
from ..core.gguf import REQUANTIZE_TYPES, GGMLType, GGUFWriter, quantize_q8_0
from ..core.weights import is_conv_2d_name

__all__ = ["convert_model"]

BN_EPS = 1e-5


def _to_numpy(v) -> np.ndarray:
    """Floats widen to f32 (f16/bf16 have no straight numpy path); integer
    buffers (e.g. bn num_batches_tracked, index tables) keep their dtype —
    the reference converter writes them as integer GGUF tensors. Dtypes GGUF
    has no tensor type for (bool / unsigned ints) widen to the smallest
    signed type that holds their values so conversion never aborts."""
    if v.is_floating_point():
        return v.float().numpy()
    a = v.numpy()
    widen = {
        np.dtype(np.bool_): np.int8,
        np.dtype(np.uint8): np.int16,
        np.dtype(np.uint16): np.int32,
        np.dtype(np.uint32): np.int64,
        np.dtype(np.uint64): np.int64,
    }
    t = widen.get(a.dtype)
    return a.astype(t) if t is not None else a


def _load_checkpoint(path: Path) -> dict[str, np.ndarray]:
    import torch

    if path.suffix in (".safetensors", ".safetensor"):
        try:
            from safetensors import safe_open
        except ImportError:
            raise_error("safetensors is not available in this environment")
        with safe_open(str(path), "pt") as f:
            return {k: _to_numpy(f.get_tensor(k)) for k in f.keys()}
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    # unwrap common checkpoint containers (BasicSR/Real-ESRGAN releases use
    # {'params'|'params_ema': {...}}; lightning etc. use 'state_dict')
    if isinstance(sd, dict):
        for key in ("state_dict", "params_ema", "params"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    return {k: _to_numpy(v) for k, v in sd.items() if hasattr(v, "numpy")}


def is_conv_2d(name: str, t: np.ndarray) -> bool:
    # one shape heuristic shared with the loader (weights.is_conv_2d_name):
    # what this writer permutes, that reader un-permutes
    return is_conv_2d_name(name, tuple(t.shape))


def conv_2d_to_nhwc(k: np.ndarray) -> np.ndarray:
    if k.shape[1] == 1:  # depthwise
        return np.ascontiguousarray(k.transpose(2, 3, 1, 0))
    return np.ascontiguousarray(k.transpose(0, 2, 3, 1))


class Writer:
    """GGUFWriter wrapper tracking layout + conv2d index list
    (reference convert.py Writer, :45-97)."""

    def __init__(self, path, arch, float_type=None):
        self.w = GGUFWriter(path, arch)
        self.arch = arch
        self.float_type = float_type
        self.layout = "unknown"
        self.conv2d_weights: list[int] = []
        self._index = 0

    def add(self, key, value):
        self.w.add(key, value)

    def set_layout_default(self, layout):
        if self.layout == "unknown":
            self.layout = layout
            self.w.add(f"{self.arch}.tensor_data_layout", layout)

    def add_tensor(self, name, t: np.ndarray, float_type=None):
        ft = float_type or self.float_type
        target = REQUANTIZE_TYPES.get(ft, (0, None))[1] if ft else None
        if target is not None and t.dtype == np.float32 and t.ndim >= 2:
            # block-quantize eligible weights (ggml rule: blocks run along
            # the innermost stored dim, so rows must divide the block);
            # K-ineligible 32-divisible rows fall back to q8_0, and small /
            # 1D / ragged tensors stay f32, like llama-quantize's ladder
            from ..core.quantize import block_size, quantize_blocks

            if t.shape[-1] % block_size(target) == 0:
                self.w.add_raw_tensor(name, tuple(t.shape), target, quantize_blocks(target, t))
                self._index += 1
                return
            if block_size(target) == 256 and t.shape[-1] % 32 == 0:
                self.w.add_raw_tensor(name, tuple(t.shape), GGMLType.Q8_0, quantize_q8_0(t))
                self._index += 1
                return
        gt = None
        if ft == "f16" and t.dtype == np.float32:
            gt = GGMLType.F16
        if ft == "f32" or (target is not None and t.dtype == np.float32):
            gt = GGMLType.F32
        self.w.add_tensor(name, t, gt)
        self._index += 1

    def convert_tensor_2d(self, t: np.ndarray) -> np.ndarray:
        if self.layout == "cwhn":
            return conv_2d_to_nhwc(t)
        self.conv2d_weights.append(self._index)
        return t

    def finish(self):
        if self.conv2d_weights:
            self.w.add(f"{self.arch}.conv2d_weights", self.conv2d_weights)
        # gguf llama_ftype convention (7 = MOSTLY_Q8_0, ...)
        self.w.add(
            "general.file_type", REQUANTIZE_TYPES.get(self.float_type or "", (0, None))[0]
        )
        self.w.write()


def fuse_batch_norm(model: dict, key: str, key_bn: str):
    """Standalone BN -> mul/add (reference convert.py:133-154).
    Returns None if the tensor is consumed (running stats)."""
    sw, sb = f"{key_bn}.weight", f"{key_bn}.bias"
    if key.endswith(sw):
        base = key[: -len(sw)]
        var = model.get(f"{base}{key_bn}.running_var")
        if var is None:  # already-fused scale/shift checkpoint
            return model[key]
        return model[key] / np.sqrt(var + BN_EPS)
    if key.endswith(sb):
        base = key[: -len(sb)]
        var = model.get(f"{base}{key_bn}.running_var")
        if var is None:
            return model[key]
        w = model[f"{base}{key_bn}.weight"]
        mean = model[f"{base}{key_bn}.running_mean"]
        return model[key] - mean * w / np.sqrt(var + BN_EPS)
    if key.endswith(f"{key_bn}.running_mean") or key.endswith(f"{key_bn}.running_var"):
        return None
    return model[key]


def fuse_conv_2d_batch_norm(model, key, name, key_module, key_conv, key_norm, writer: Writer):
    """Conv+BN fusion (reference convert.py:157-197). Returns True when the
    key was handled (fused or skipped)."""
    suffix_conv = f"{key_module}{key_conv}.weight"
    suffix_bias = f"{key_module}{key_conv}.bias"
    suffix_norm = f"{key_module}{key_norm}."

    if key.endswith(suffix_conv):
        base = key[: -len(suffix_conv)]
        bn_w = model.get(f"{base}{suffix_norm}weight")
        if bn_w is None:
            return False
        bn_b = model[f"{base}{suffix_norm}bias"]
        bn_mean = model[f"{base}{suffix_norm}running_mean"]
        bn_var = model[f"{base}{suffix_norm}running_var"]
        conv_b = model.get(f"{base}{suffix_bias}", np.zeros_like(bn_b))
        scale = bn_w / np.sqrt(bn_var + BN_EPS)
        fused_w = model[key] * scale[:, None, None, None]
        fused_b = (conv_b - bn_mean) * scale + bn_b
        fused_w = writer.convert_tensor_2d(fused_w)
        writer.add_tensor(name, fused_w)
        writer.add_tensor(name.replace("weight", "bias"), fused_b)
        return True
    if key.endswith(suffix_bias):
        base = key[: -len(suffix_bias)]
        return f"{base}{suffix_norm}weight" in model
    if suffix_norm in key:
        return True
    return False


def build_attention_bias_indices(resolution: int) -> np.ndarray:
    points = list(itertools.product(range(resolution), range(resolution)))
    offsets, idxs = {}, []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            offsets.setdefault(off, len(offsets))
            idxs.append(offsets[off])
    n = len(points)
    return np.asarray(idxs, np.int64).reshape(n, n)


def build_dense_positional_embeddings(gaussian: np.ndarray, size: int = 64) -> np.ndarray:
    """(reference convert.py:265-282)."""
    ye = (np.cumsum(np.ones((size, size)), 0) - 0.5) / size
    xe = (np.cumsum(np.ones((size, size)), 1) - 0.5) / size
    coords = np.stack([xe, ye], -1)
    proj = (2 * coords - 1) @ gaussian * (2 * np.pi)
    return np.concatenate([np.sin(proj), np.cos(proj)], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# per-arch converters
# ---------------------------------------------------------------------------


def convert_sam(model: dict, w: Writer):
    """(reference convert_sam, convert.py:220-262)."""
    w.set_layout_default("whcn")
    for key, t in model.items():
        name = (
            key.replace("image_encoder.", "enc.")
            .replace("mask_decoder.", "dec.")
            .replace("_image_to_token.", "_i2t.")
            .replace("_token_to_image.", "_t2i.")
        )
        if name.endswith("attention_biases"):
            heads = t.shape[0]
            resolution = {4: 7, 5: 14, 10: 7}[heads]
            idxs = build_attention_bias_indices(resolution)
            w.add_tensor(name + "_indexed", t[:, idxs])
            continue
        if "local_conv" in key:
            old = w.layout
            w.layout = "cwhn"
            handled = fuse_conv_2d_batch_norm(model, key, name, "", "c", "bn", w)
            if not handled:
                # already-fused checkpoint (no adjacent BN): still store
                # cwhn — the loader un-permutes local_conv weights
                # unconditionally (mobile_sam.fixup_weights), so falling
                # through to the torch-layout write would silently produce
                # mis-laid-out depthwise kernels
                if key.endswith("c.weight"):
                    w.add_tensor(name, w.convert_tensor_2d(t))
                else:  # c.bias
                    w.add_tensor(name, t)
                handled = True
            w.layout = old
            if handled:
                continue
        if fuse_conv_2d_batch_norm(model, key, name, "", "c", "bn", w):
            continue
        if name.endswith("neck.0.weight") or name.endswith("neck.2.weight"):
            t = w.convert_tensor_2d(t)
        if key == "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
            w.add_tensor("dec.dense_positional_embedding", build_dense_positional_embeddings(t), "f32")
        if name in ("dec.iou_token.weight", "dec.mask_tokens.weight"):
            w.add_tensor(name, t, "f32")
            continue
        w.add_tensor(name, t)


def convert_birefnet(model: dict, w: Writer, filename: str):
    """(reference convert_birefnet, convert.py convert_birefnet)."""
    w.set_layout_default("whcn")
    x = model["bb.layers.0.blocks.0.attn.proj.bias"]
    if x.shape[0] == 96:
        w.add("swin.config", "tiny")
        w.add("swin.embed_dim", 96)
    elif x.shape[0] == 192:
        w.add("swin.config", "large")
        w.add("swin.embed_dim", 192)
    else:
        # non-preset checkpoint: derive the full swin config from the state
        # dict and store it explicitly (swin_detect_params reads it back)
        w.add("swin.config", "custom")
        w.add("swin.embed_dim", int(x.shape[0]))
        depths, heads, dims = [], [], []
        i = 0
        while f"bb.layers.{i}.blocks.0.attn.proj.bias" in model:
            d = 0
            while f"bb.layers.{i}.blocks.{d}.attn.proj.bias" in model:
                d += 1
            tbl = model[f"bb.layers.{i}.blocks.0.attn.relative_position_bias_table"]
            depths.append(d)
            heads.append(int(tbl.shape[1]))
            dims.append(int(model[f"bb.layers.{i}.blocks.0.attn.proj.bias"].shape[0]))
            i += 1
        if not depths:
            raise_error(
                "birefnet converter: no 'bb.layers.N.blocks...' keys found — "
                "cannot derive a custom swin config from this checkpoint"
            )
        window = (int(round(tbl.shape[0] ** 0.5)) + 1) // 2  # table is (2w-1)^2
        w.add("swin.window", window)
        w.add("swin.depths", depths)
        w.add("swin.num_heads", heads)
        w.add("swin.dims", dims)
    image_size = 1024
    if "HR" in filename or "2K" in filename:
        image_size = 2048
    elif "dynamic" in filename:
        image_size = -1
    w.add("birefnet.image_size", image_size)
    w.add("birefnet.image_multiple", 128)
    for key, t in model.items():
        name = (
            key.replace("decoder_block", "block")
            .replace("atrous_conv", "conv")
            .replace("modulator_conv", "modulator")
            .replace("offset_conv", "offset")
            .replace("regular_conv", "conv")
        )
        if name.endswith("relative_position_index"):
            continue
        if fuse_conv_2d_batch_norm(model, key, name, "global_avg_pool.", "1", "2", w):
            continue
        if fuse_conv_2d_batch_norm(model, key, name, "dec_att.", "conv1", "bn1", w):
            continue
        if fuse_conv_2d_batch_norm(model, key, name, "", "conv_in", "bn_in", w):
            continue
        if fuse_conv_2d_batch_norm(model, key, name, "", "conv_out", "bn_out", w):
            continue
        handled = False
        for i in (2, 3, 4):
            if fuse_conv_2d_batch_norm(model, key, name, f"gdt_convs_{i}.", "0", "1", w):
                handled = True
                break
        if handled:
            continue
        t = fuse_batch_norm(model, key, "bn")
        if t is None:
            continue
        if is_conv_2d(name, t):
            if "patch_embed" in name:
                t = conv_2d_to_nhwc(t)
            else:
                t = w.convert_tensor_2d(t)
        w.add_tensor(name, t)


def convert_depth_anything(model: dict, w: Writer):
    """(reference convert_depth_anything)."""
    w.set_layout_default("whcn")
    if "pretrained.cls_token" in model:
        # original (non-HF) Depth-Anything checkpoints use 'pretrained.*'
        # naming (reference convert.py:437-440 rejects them the same way)
        raise_error(
            "Weights not supported: original Depth-Anything checkpoint "
            "('pretrained.*' names) — convert the Hugging Face release instead"
        )
    proj = "backbone.embeddings.patch_embeddings.projection.weight"
    if proj not in model:
        raise_error("not a Depth-Anything (HF) checkpoint: missing '{}'", proj)
    shape = model[proj].shape
    w.add("dino.patch_size", int(shape[2]))
    w.add("dino.embed_dim", int(shape[0]))
    w.add("depthanything.image_size", 518)
    heads_layers = {384: (6, 12, [2, 5, 8, 11]), 768: (12, 12, [2, 5, 8, 11]), 1024: (16, 24, [4, 11, 17, 23])}
    if shape[0] in heads_layers:
        nh, nl, fl = heads_layers[shape[0]]
    else:  # non-standard checkpoint: derive from the state dict
        nl = 1 + max(
            int(k.split(".")[3]) for k in model if k.startswith("backbone.encoder.layer.")
        )
        nh = max(1, int(shape[0]) // 64) if shape[0] % 64 == 0 else 4
        step = max(1, nl // 4)
        fl = list(range(nl - 1, -1, -step))[:4][::-1]
    w.add("dino.n_heads", nh)
    w.add("dino.n_layers", nl)
    w.add("depthanything.feature_layers", fl)
    for key, t in model.items():
        name = key
        if is_conv_2d(name, t):
            if "patch_embeddings" in name or ("projection" in name and "fusion" not in name):
                t = conv_2d_to_nhwc(t)
            elif "0.resize" in name or "1.resize" in name:
                pass
            else:
                t = w.convert_tensor_2d(t)
        if "position_embeddings" in name or "cls_token" in name:
            w.add_tensor(name, t, "f32")
            continue
        w.add_tensor(name, t)


def convert_migan(model: dict, w: Writer):
    w.set_layout_default("whcn")
    resolutions = [
        int(k.split(".")[1][1:]) for k in model if k.startswith("encoder.b") and k.endswith("fromrgb.weight")
    ]
    if resolutions:
        w.add("migan.image_size", max(resolutions))
    for name, t in model.items():
        if is_conv_2d(name, t):
            t = w.convert_tensor_2d(t)
        w.add_tensor(name, t)


def convert_esrgan(model: dict, w: Writer, scale: int | None = None, n_blocks: int | None = None):
    """ESRGAN state dicts: old-arch `model.N...` naming directly, or
    new-arch BasicSR names via normalize_esrgan_names (the reference goes
    through spandrel, which stores old-arch internally)."""
    w.set_layout_default("whcn")
    model, detected_scale = normalize_esrgan_names(model)
    if scale is None:
        scale = detected_scale
    if n_blocks is None:
        n_blocks = 0
        for k in model:
            parts = k.split(".")
            if len(parts) > 3 and parts[0] == "model" and parts[1] == "1" and parts[2] == "sub":
                if parts[3].isdigit() and "RDB" in k:
                    n_blocks = max(n_blocks, int(parts[3]) + 1)
    w.add("esrgan.scale", scale)
    w.add("esrgan.block_count", n_blocks)
    for name, t in model.items():
        if is_conv_2d(name, t):
            t = w.convert_tensor_2d(t)
        w.add_tensor(name, t)


def convert_sam3(model: dict, w: Writer, model_dir: Path):
    """SAM3 (reference convert.py:288-351): tokenizer vocab/merges exported
    as GGUF string arrays + special-token ids + max_length, weights renamed
    (detector_model->det, vision_encoder->ve, ...); text_projection dropped."""
    import json

    w.set_layout_default("whcn")
    vocab_path = model_dir / "vocab.json"
    merges_path = model_dir / "merges.txt"
    config_path = model_dir / "tokenizer_config.json"
    if not vocab_path.exists() or not merges_path.exists():
        raise_error("sam3 conversion requires vocab.json and merges.txt next to the checkpoint ({})", model_dir)
    with open(vocab_path) as fh:
        vocab = json.load(fh)
    config = {}
    if config_path.exists():
        with open(config_path) as fh:
            config = json.load(fh)

    token_list = [""] * (max(vocab.values()) + 1)
    for tok, tid in vocab.items():
        token_list[tid] = tok
    merges = []
    with open(merges_path) as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                merges.append(line)

    w.add("tokenizer.ggml.model", "clip")
    w.add("tokenizer.ggml.tokens", token_list)
    w.add("tokenizer.ggml.merges", merges)
    w.add("tokenizer.ggml.bos_token_id", int(config.get("bos_token_id", 49406)))
    w.add("tokenizer.ggml.eos_token_id", int(config.get("eos_token_id", 49407)))
    w.add("tokenizer.ggml.padding_token_id", int(config.get("pad_token_id", 49407)))
    w.add("tokenizer.ggml.unknown_token_id", int(config.get("unk_token_id", 49407)))
    w.add("sam3.tokenizer.max_length", int(config.get("model_max_length", 32)))

    for key, t in model.items():
        if key.startswith("detector_model.text_encoder.text_projection"):
            continue
        name = (
            key.replace("detector_model", "det")
            .replace("text_encoder", "te")
            .replace("vision_encoder", "ve")
            .replace("tracker_model", "trk")
            .replace("mask_decoder.", "decoder.")
            .replace("_image_to_token.", "_i2t.")
            .replace("_token_to_image.", "_t2i.")
        )
        if is_conv_2d(name, t):
            t = w.convert_tensor_2d(t)
        w.add_tensor(name, t)


def normalize_esrgan_names(model: dict) -> tuple[dict, int]:
    """New-arch (BasicSR RRDBNet: conv_first/body.N.rdbK.convJ/conv_up...)
    -> old-arch sequential names (model.0, model.1.sub.N.RDBk.convj.0, ...).
    Pure rename table standing in for the reference's spandrel normalization
    (convert.py:504-527). Returns (renamed dict, scale)."""
    if not any(k.startswith("conv_first") for k in model):
        # already old-arch; infer scale from the upsample layer indices
        idxs = [
            int(k.split(".")[1])
            for k in model
            if k.startswith("model.") and k.split(".")[1].isdigit()
        ]
        if not idxs:
            raise_error(
                "not an ESRGAN/RRDBNet state dict: no 'conv_first.*' or "
                "'model.N.*' keys found"
            )
        return dict(model), {10: 4, 7: 2, 4: 1}.get(max(idxs), 4)
    in_ch = model["conv_first.weight"].shape[1]
    if in_ch != 3:
        # x2/x1 Real-ESRGAN variants pixel-unshuffle the input (in_ch 12/48)
        # and keep both conv_up layers — a different inference graph, not a
        # rename away (the reference inherits this limitation via spandrel's
        # shuffle_factor check, convert.py:511-512)
        raise_error(
            "ESRGAN checkpoints with pixel-unshuffled input (conv_first in_ch={}) are not supported",
            in_ch,
        )
    n_up = len({k.split(".")[0] for k in model if k.startswith("conv_up")})
    scale = 2 ** n_up
    nb = 1 + max(int(k.split(".")[1]) for k in model if k.startswith("body."))
    out = {}
    up_seq = {n: 3 * n for n in range(1, n_up + 1)}  # conv_upN -> model.3N
    hr_idx = 2 + 3 * n_up
    for k, t in model.items():
        if k.startswith("conv_first."):
            out["model.0." + k.split(".", 1)[1]] = t
        elif k.startswith("body."):
            _, i, rdb, conv, leaf = k.split(".")  # body.3.rdb1.conv2.weight
            out[f"model.1.sub.{i}.RDB{rdb[-1]}.{conv}.0.{leaf}"] = t
        elif k.startswith("conv_body."):
            out[f"model.1.sub.{nb}." + k.split(".", 1)[1]] = t
        elif k.startswith("conv_up"):
            n = int(k.split(".")[0][-1])
            out[f"model.{up_seq[n]}." + k.split(".", 1)[1]] = t
        elif k.startswith("conv_hr."):
            out[f"model.{hr_idx}." + k.split(".", 1)[1]] = t
        elif k.startswith("conv_last."):
            out[f"model.{hr_idx + 2}." + k.split(".", 1)[1]] = t
        else:
            out[k] = t
    return out, scale


def convert_yolov9t(model: dict, w: Writer):
    """YOLOv9t with BN fused to mul/add (reference scripts/yolov9t.py flow).
    Accepts ultralytics checkpoints: the detection head lives at model.22.*
    there and is remapped to detect.* (ref yolov9t.py:160-236)."""
    w.set_layout_default("whcn")
    model = {k.replace("model.22.", "detect."): v for k, v in model.items()}
    for key, t in model.items():
        out = fuse_batch_norm(model, key, "bn")
        if out is None:
            continue
        if is_conv_2d(key, out):
            out = w.convert_tensor_2d(out)
        if key.endswith("bn.num_batches_tracked"):
            continue
        w.add_tensor(key, out)


ARCH_NAMES = {
    "sam": "mobile-sam",
    "sam3": "sam3",
    "birefnet": "birefnet",
    "depth-anything": "depthanything",
    "depthany": "depthanything",  # CLI-verb alias; same arch KV prefix
    "migan": "migan",
    "esrgan": "esrgan",
    "yolov9t": "yolov9t",
}


def convert_model(
    arch: str,
    input_path: str | Path,
    output_path: str | Path,
    float_type: str | None = None,
    layout: str | None = None,
    esrgan_scale: int | None = None,
) -> Path:
    input_path, output_path = Path(input_path), Path(output_path)
    model = _load_checkpoint(input_path)
    w = Writer(output_path, ARCH_NAMES.get(arch, arch), float_type)
    if layout:
        w.layout = layout
        w.add(f"{w.arch}.tensor_data_layout", layout)
    if arch == "sam":
        convert_sam(model, w)
    elif arch == "birefnet":
        convert_birefnet(model, w, input_path.name)
    elif arch in ("depth-anything", "depthany"):
        convert_depth_anything(model, w)
    elif arch == "migan":
        convert_migan(model, w)
    elif arch == "esrgan":
        convert_esrgan(model, w, scale=esrgan_scale)
    elif arch == "yolov9t":
        convert_yolov9t(model, w)
    elif arch == "sam3":
        convert_sam3(model, w, input_path.parent)
    else:
        raise_error("Unknown architecture: {}", arch)
    w.finish()
    return output_path


def main():
    p = argparse.ArgumentParser(description="Convert model weights to GGUF")
    p.add_argument("arch", choices=list(ARCH_NAMES.keys()))
    p.add_argument("input")
    p.add_argument("--output", "-o", default="models")
    p.add_argument(
        "--quantize", "-q", default=None,
        choices=[t for t in REQUANTIZE_TYPES if t != "f32"],
    )
    p.add_argument("--layout", "-l", choices=["whcn", "cwhn"], default=None)
    p.add_argument("--esrgan-scale", type=int, default=None)
    args = p.parse_args()
    out = Path(args.output)
    if out.is_dir() or out.suffix != ".gguf":
        suffix = f"-{args.quantize.upper()}" if args.quantize else ""
        out = out / f"{Path(args.input).stem}{suffix}.gguf"
    result = convert_model(args.arch, args.input, out, args.quantize, args.layout, args.esrgan_scale)
    print(f"-> {result}")


if __name__ == "__main__":
    main()
