"""chip_smoke.py checks and times the flash kernel at the token counts the
Depth-Anything requests it serves really reach: its request extents are one
module-level constant, and the token counts come from the model's own
depthany_image_extent, so no literal can drift from the served shape. Its
SAM3 FLOP count is the port's forward's, and its synthetic vocabulary has
CLIP's ids."""

import importlib.util
from pathlib import Path

import pytest

from vision_tpu.models.depth_anything import DepthAnythingParams as JaxParams
from vision_tpu.models.depth_anything import depthany_image_extent as jax_image_extent


@pytest.fixture(scope="module")
def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # defines only; main() is not run
    return module


def test_depth_tokens_are_the_served_extents(chip_smoke):
    assert chip_smoke.DEPTH_EXTENTS == ((518, 518), (700, 500))
    assert [chip_smoke.depth_tokens(e) for e in chip_smoke.DEPTH_EXTENTS] == [1370, 1925]


@pytest.mark.parametrize("extent", [(518, 518), (700, 500), (500, 700), (1024, 768)])
def test_depth_tokens_follow_the_reference_extent(chip_smoke, extent):
    """The same count the JAX package's extent rule gives (patch 14, one class token)."""
    w, h = jax_image_extent(extent, JaxParams())
    assert chip_smoke.depth_tokens(extent) == (w // 14) * (h // 14) + 1


@pytest.mark.parametrize("image", [56, 70], ids=["whole_windows", "padded_windows"])
def test_sam3_vision_flops_match_the_counted_forward(chip_smoke, image):
    """The FLOPs chip_smoke.py divides SAM3's time by are those of the
    port's encode_vision, as torch's flop counter counts its products and
    convolutions, here at a small width (with padded windows too)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.models.random_weights import random_sam3_vision_params
    from vision_tpu_torch.models.sam3 import Sam3VitParams, encode_vision

    vp = Sam3VitParams(image_size=image, patch_size=14, window_size=2, n_layers=3, n_heads=2, global_attn_indexes=(1,))
    store = {f"det.ve.{k}": v for k, v in random_sam3_vision_params(0, 32, 3, 16).items()}
    p = Params(params_from_numpy(store, "cpu", torch.float32))["det.ve"]
    with FlopCounterMode(display=False) as counter:
        encode_vision(p, torch.zeros(2, image, image, 3), vp)
    assert counter.get_total_flops() == chip_smoke.sam3_vision_flops(vp, 2, dim=32, fpn_ch=16)


def test_sam3_vocab_has_clip_ids_and_real_merges(chip_smoke):
    from vision_tpu_torch.models.sam3 import ClipTokenizer

    tokens, merges = chip_smoke.sam3_vocab()
    assert len(tokens) == 49408 == len(set(tokens))
    assert tokens[49406:] == ["<|startoftext|>", "<|endoftext|>"]
    tk = ClipTokenizer({t: i for i, t in enumerate(tokens)}, {tuple(m.split(" ")): i for i, m in enumerate(merges)})
    ids = tk.tokenize(chip_smoke.SAM3_PROMPTS[1], 16).token_ids
    assert ids[0] == 49406 and tokens[ids[1]] == "the</w>" and tokens[ids[2]] == "red</w>"


def test_yolo_conv_calls_are_the_forwards_112(chip_smoke):
    """The YOLOv9t calls phases 22 and 26 check and time are recorded from
    the port's own forward: 112 stride-1 3x3 convs at the full widths, 28
    distinct shapes and forms (here at 64x64, batch 2, on the CPU), each
    with its BN and SiLU, r1 for the RepConvs, r2 for the shortcuts, and
    views of the ELAN buffers."""
    import torch

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.models.random_weights import random_yolov9t_params
    from vision_tpu_torch.models.yolov9t import Yolov9tModel, Yolov9tParams
    from vision_tpu_torch.ops.cuda import conv3x3 as cc

    model = Yolov9tModel(params_from_numpy(random_yolov9t_params(0), "cpu", torch.float32), Yolov9tParams(),
                         backend_init("cpu"))
    calls = chip_smoke.yolo_conv_calls(cc, lambda: model.forward_u8(torch.zeros(2, 64, 64, 3, dtype=torch.uint8)))
    shapes = chip_smoke.yolo_shapes(calls)
    assert len(calls) == chip_smoke.YOLO_CONVS == 112 and sum(shapes.values()) == 112 and len(shapes) == 28
    assert cc.conv3x3.__name__ == "conv3x3"  # the spy is gone
    r1 = sum(n for c, n in shapes.items() if c[7])
    r2 = sum(n for c, n in shapes.items() if c[8])
    views = sum(n for c, n in shapes.items() if c[9])
    # 7 RepNCSPELAN4 x 2 RepCSP x 3 RepConvs; as many shortcuts; the ELAN
    # buffers' 2 x 8 convs and each RepCSP's last bottleneck
    assert (r1, r2, views) == (42, 42, 16 + 14)
    assert {c[4] for c in shapes} == {16, 24, 32, 48, 64, 80}
    assert "into channels" in chip_smoke.yolo_form_label(next(c for c in shapes if c[9]))


def test_match_detections(chip_smoke):
    from vision_tpu_torch.models.yolov9t import Detection

    a = [Detection(0, 0, 10, 10, 0.9, 1), Detection(20, 20, 30, 30, 0.8, 2)]
    assert chip_smoke.match_detections(a, list(reversed(a))) == 1.0
    assert chip_smoke.match_detections(a, [Detection(0, 0, 10, 10, 0.9, 3), a[1]]) == 0.5
    assert chip_smoke.match_detections(a, [Detection(5, 5, 15, 15, 0.9, 1)]) == 0.0
    assert chip_smoke.match_detections([], []) == 1.0
