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
from torch_threads import torch_threads  # noqa: F401


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


def test_the_phase_list_runs_to_32(chip_smoke):
    doc = chip_smoke.__doc__
    numbers = [int(ln.split(".")[0]) for ln in doc.splitlines() if ln[:4].strip().rstrip(".").isdigit()]
    assert numbers == list(range(1, 49))
    for name in ("http_phase", "bulk_phase", "verbs_phase", "serve_verb", "dequant_cases", "residency_phase",
                 "quantize_verb_phase", "grad_cases", "train_harness", "recipe_run", "training_phases", "ops_phase",
                 "export_phase", "capi_phase", "flops_phase", "tooling_phases", "mesh_one_rank", "mesh_dp1_cli",
                 "mesh_shard_kernels", "mesh_more_ranks", "mesh_phases", "cli_main", "train_mesh_recipe",
                 "train_mesh_phase", "sam3_stack", "sam3_spatial_twin", "kernel_counts", "sam3_scan_phase",
                 "bench_launches", "bench_counts", "bench_rows", "bench_forward", "bench_parity", "bench_phase"):
        assert callable(getattr(chip_smoke, name))


def test_mesh_shards_are_the_tp_heads(chip_smoke):
    """Phase 44's shard shapes: the heads each tp rank holds (whole heads
    only: TinyViT's 5-head stage stays whole, so it has no shard case) and
    phase 43's served batches at each server's per-card default."""
    from vision_tpu_torch.models.mobile_sam import TinyVitParams

    heads = [lp.num_heads for lp in TinyVitParams().layers[1:]]
    tiny = [row for row in chip_smoke.MESH_WINDOW if row[0].startswith("TinyViT")]
    assert [row[3] * 2 for row in tiny] == [h for h in heads if h % 2 == 0]
    swin = [row for row in chip_smoke.MESH_WINDOW if row[0].startswith("SWIN-L")]
    assert sorted(row[3] * 2 for row in swin) == sorted(h for _, h in chip_smoke.SWIN_L_STAGES for _ in range(2))
    assert [row[1] for row in chip_smoke.MESH_FLASH] == [3 * 4, 16 // 2, 16 // 4]
    defaults = {"depthany": 4, "birefnet": 4, "esrgan": 4, "migan": 4, "yolov9t": 8, "sam": 6}
    for family, (_, batch, extents) in chip_smoke.MESH_SERVED.items():
        assert batch == defaults[family] == len(extents)
    assert set(chip_smoke.MESH_KERNELS) == set(chip_smoke.MESH_SERVED)


def test_the_kernels_line_names_every_vtt_op(chip_smoke):
    from vision_tpu_torch.ops.cuda import library

    named = [op for ops in chip_smoke.KERNEL_OPS.values() for op in ops]
    assert sorted(named) == sorted(f"vtt::{op}" for op in library.OPS)
    assert set(chip_smoke.EXPORT_CASES) == {"depthany", "sam", "birefnet", "esrgan", "migan", "yolov9t", "sam3"}
    # the vision-bench rows' launches (phase 48) are read under the benchmark's kernel names, which are the line's
    benched = {k.removesuffix(" masked") for row in chip_smoke.BENCH_KERNELS.values() for k in row}
    assert benched == {"flash_attention", "window_attention", "conv3x3", "deform_conv"} <= set(chip_smoke.KERNEL_OPS)


@pytest.mark.parametrize("kernel", ["flash_attention", "window_attention", "window_attention masked", "conv3x3",
                                    "deform_conv", "deform_sample", "dequant"])
def test_bench_rows_holds_every_row_of_its_kernel(chip_smoke, kernel):
    """The kernels line's launches_bench: each row that BENCH_KERNELS gives
    the kernel, with its count; a row missing or miscounted raises."""
    rows = [{"name": name, "launches": {**dict.fromkeys(chip_smoke.KERNEL_OPS, 0), **n}}
            for name, n in chip_smoke.BENCH_KERNELS.items()]
    want = {name: n[kernel] for name, n in chip_smoke.BENCH_KERNELS.items() if kernel in n}
    assert chip_smoke.bench_rows(rows, kernel) == want
    if want:
        name = next(iter(want))
        with pytest.raises(AssertionError, match="vision-bench launches"):
            chip_smoke.bench_rows([r for r in rows if r["name"] != name], kernel)
        rows[list(chip_smoke.BENCH_KERNELS).index(name)]["launches"][kernel] += 1
        with pytest.raises(AssertionError, match="vision-bench launches"):
            chip_smoke.bench_rows(rows, kernel)


def test_bench_counts_names_the_kernels_as_the_benchmark_does(chip_smoke):
    """bench_counts: kernel_counts under the benchmark's names, the masked
    window launches apart, kernels launched no time left out."""
    from vision_tpu_torch.ops.cuda import flash_attention, window_attention

    chip_smoke.zero_counts()
    assert chip_smoke.bench_counts() == {}
    flash_attention.launches, window_attention.launches, window_attention.masked_launches = 12, 24, 12
    try:
        assert chip_smoke.bench_counts() == {"flash_attention": 12, "window_attention": 24,
                                             "window_attention masked": 12}
    finally:
        chip_smoke.zero_counts()


def test_bench_parity_rows_are_the_new_shapes(chip_smoke):
    """Phase 48 holds the rows whose kernels no served path runs at their
    shapes against the CPU: SWIN-T BiRefNet and Depth-Anything at 518x714,
    whose token count phase 3's flash cases take."""
    import torch

    from vision_tpu_torch.models.depth_anything import DepthAnythingParams

    assert set(chip_smoke.BENCH_PARITY) == {"birefnet-1024", "depthany-small", "depthany-base"}
    for forms in chip_smoke.BENCH_PARITY.values():
        assert "bfloat16" in {d for d, _ in forms}
        assert all(isinstance(getattr(torch, d), torch.dtype) and 0 < b <= chip_smoke.E2E_REL_RMS for d, b in forms)
    patch = DepthAnythingParams().dino.patch_size
    assert chip_smoke.BENCH_DEPTH_T == 1 + (518 // patch) * (714 // patch) == 1888


def _vtt_launches(step, params, x) -> dict:
    """What a step launches on the card, counted on the CPU: its vtt
    operator calls (one a wrapper's launch) on fake tensors, under the
    benchmark's kernel names (the window kernel's calls with a window mask
    also as "window_attention masked")."""
    from collections import Counter

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = Counter()

    class Calls(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.overloadpacket._qualified_op_name
            if name.startswith("vtt::"):
                kernel = name.removeprefix("vtt::").removesuffix("_out")
                calls[kernel] += 1
                if kernel == "window_attention" and (args[6] if len(args) > 6 else kwargs.get("window_mask")) is not None:
                    calls["window_attention masked"] += 1
            return func(*args, **kwargs)

    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        params, x = pytree.tree_map_only(torch.Tensor, fake.from_tensor, (params, x))
        with torch.no_grad(), Calls():
            step(params, x)
    return dict(calls)


@pytest.mark.parametrize("name", ["sam-encode-1024", "sam-decode", "esrgan-512", "depthany-small", "depthany-base",
                                  "migan-512", "yolov9t-640", "birefnet-1024"])
def test_bench_kernels_are_what_a_rows_step_launches(chip_smoke, name):
    """Phase 48's launches per row: each of these rows' steps at its full
    width, counted on the CPU (fake tensors); the rows whose random weights
    are large (SWIN-L BiRefNet, SAM3's ViT-H) and ESRGAN at 1024^2 (the
    512^2 row's forward) by the per-forward constants the other phases
    hold."""
    import torch

    from vision_tpu_torch.benchmark import BENCHMARKS
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.models.sam3 import Sam3VitParams

    assert list(chip_smoke.BENCH_KERNELS) == list(BENCHMARKS)
    step, params, x = BENCHMARKS[name](backend_init("cpu"), torch.float32)
    assert _vtt_launches(step, params, x) == chip_smoke.BENCH_KERNELS[name]
    kernels = chip_smoke.BENCH_KERNELS
    assert kernels["esrgan-1024"] == kernels["esrgan-512"] == {"conv3x3": chip_smoke.ESRGAN_CONVS}
    assert kernels["birefnet-full-1024"] == {"window_attention": chip_smoke.BIREF_WINDOWS, "window_attention masked":
                                             chip_smoke.BIREF_MASKED, "deform_conv": chip_smoke.BIREF_DEFORMS}
    assert kernels["sam3-vision-1008"] == {"flash_attention": len(Sam3VitParams().global_attn_indexes)}


def test_the_bundle_loader_imports_no_model_module(chip_smoke):
    import ast

    tree = ast.parse(chip_smoke.EXPORT_LOADER)
    imported = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert imported == {"vision_tpu_torch.export", "vision_tpu_torch.ops.cuda"}


def test_output_leaves_order_a_forward_and_its_bundle_alike(chip_smoke):
    import torch

    from vision_tpu_torch.models.yolov9t import DetectOutput

    boxes, scores = torch.zeros(1, 2, 4), torch.ones(1, 2, 3)
    forward = DetectOutput(boxes, scores)
    bundle = {"scores": scores.clone(), "boxes": boxes.clone()}
    assert chip_smoke.same_output(torch, bundle, forward) == (True, 0.0)
    assert [t.shape for t in chip_smoke.output_leaves(forward)] == [boxes.shape, scores.shape]


def test_capi_inputs_follow_the_c_programs_pattern(chip_smoke, tmp_path):
    """The C program draws its image and mask as capi_inputs does."""
    import subprocess

    import numpy as np

    src = tmp_path / "pattern.c"
    program = chip_smoke.CAPI_PROGRAM
    body = program[program.index("    int w = atoi(argv[3])"):program.index("    void* model = 0;")]
    src.write_text("#include <stdio.h>\n#include <stdlib.h>\nint main(int argc, char** argv) {\n" + body
                   + "    fwrite(rgb, 1, (size_t)w * h * 3, stdout);\n    fwrite(mask, 1, (size_t)w * h, stdout);\n"
                   "    return 0;\n}\n")
    subprocess.run(["gcc", str(src), "-o", str(tmp_path / "pattern")], check=True)
    w, h = chip_smoke.CAPI_EXTENT
    out = subprocess.run([str(tmp_path / "pattern"), "", "", str(w), str(h)], capture_output=True, check=True).stdout
    images, args = chip_smoke.capi_inputs("migan")
    assert out == images[0][4] + images[1][4] and args == []
    assert chip_smoke.capi_inputs("sam")[1] == chip_smoke.CAPI_ARGS["sam"]


def test_http_requests_are_phase_30s_mix(chip_smoke):
    """34 bodies: Depth-Anything 8, BiRefNet 4, SAM 6 (3 points, 3 boxes,
    each prompt in its query), Real-ESRGAN 4, MI-GAN 4 RGBA with the mask in
    alpha, YOLOv9t 8; a seeded order, the same each run."""
    import numpy as np

    reqs = chip_smoke.http_requests(np.random.default_rng(30))
    assert len(reqs) == 34
    by = {}
    for service, path, px, prompt in reqs:
        by.setdefault(service, []).append((path, px, prompt))
        assert path.startswith(chip_smoke.HTTP_ROUTES[service])
    assert {s: len(v) for s, v in by.items()} == {"depthany": 8, "birefnet": 4, "sam": 6, "esrgan": 4, "migan": 4,
                                                 "yolo": 8}
    for service, items in by.items():
        extents = sorted((px.shape[1], px.shape[0]) for _, px, _ in items)
        assert extents == sorted(chip_smoke.HTTP_EXTENTS[service])
        assert all(px.shape[2] == (4 if service == "migan" else 3) for _, px, _ in items)
    kinds = sorted(prompt[0] for _, _, prompt in by["sam"])
    assert kinds == ["box"] * 3 + ["point"] * 3
    for path, px, (kind, where) in by["sam"]:
        query = path.split("?")[1]
        assert query == (f"x={where[0]}&y={where[1]}" if kind == "point" else
                         "box=" + ",".join(str(v) for xy in where for v in xy))
    migan_alpha = by["migan"][0][1][:, :, 3]
    assert set(np.unique(migan_alpha)) == {0, 255}
    again = chip_smoke.http_requests(np.random.default_rng(30))
    assert [r[1] for r in again] == [r[1] for r in reqs] and all(
        np.array_equal(a[2], b[2]) for a, b in zip(again, reqs))


def test_expected_launches_are_per_forward_counts_times_batches(chip_smoke):
    want = chip_smoke.expected_launches({"depthany": 2, "sam": 1, "birefnet": 1, "esrgan": 1, "yolo": 3, "migan": 5})
    assert want == {"flash": 24, "window": 10 + 48, "conv3x3": 351 + 3 * 112, "deform_conv": 20, "deform_sample": 0}
    assert chip_smoke.expected_launches({"migan": 4}) == dict.fromkeys(chip_smoke.COUNTER_KERNELS, 0)


def test_lsb_close_and_detections_match(chip_smoke):
    import numpy as np

    from vision_tpu_torch.models.yolov9t import Detection

    a = np.zeros((40, 50, 1), np.uint8)
    b = a.copy()
    b[0, 0] = 1
    assert chip_smoke.lsb_close(a, b) == (True, 1, 1 / 2000)
    b[0, 1] = 2
    assert not chip_smoke.lsb_close(a, b)[0] and chip_smoke.lsb_close(a, b, max_diff=255)[0]
    b[:2] = 1  # 100 of 2000 values off: past MAX_SHARE_OFF
    assert not chip_smoke.lsb_close(a, b, max_diff=255)[0]
    assert chip_smoke.lsb_close(a, a[:, :, 0])[0] is False
    dets = [Detection(1.234567, 2.0, 30.0, 40.0, 0.512345, 0), Detection(5.0, 6.0, 7.0, 8.0, 0.3, 85)]
    http_doc = [{"box": [1.23, 2.0, 30.0, 40.0], "confidence": 0.5123, "class_id": 0, "class_name": "person"},
                {"box": [5.0, 6.0, 7.0, 8.0], "confidence": 0.3, "class_id": 85, "class_name": "85"}]
    bulk_doc = [{"class": "person", "confidence": 0.5123, "box": [1.2, 2.0, 30.0, 40.0]},
                {"class": "85", "confidence": 0.3, "box": [5.0, 6.0, 7.0, 8.0]}]
    assert chip_smoke.detections_match(http_doc, dets, 0.005, 5e-5)
    assert chip_smoke.detections_match(bulk_doc, dets, 0.05, 5e-5)
    assert not chip_smoke.detections_match(bulk_doc, dets, 0.005, 5e-5)  # 1.2 is not 1.23 rounded
    assert not chip_smoke.detections_match(http_doc[:1], dets, 0.005, 5e-5)
    assert not chip_smoke.detections_match([dict(http_doc[0], class_id=1), http_doc[1]], dets, 0.005, 5e-5)


def test_bulk_extents_fill_three_depth_buckets(chip_smoke):
    """Phase 31: 12 Depth-Anything images in three snapped extents (each
    bucket's graph captured before the count), 8 YOLOv9t images."""
    from vision_tpu_torch.models.depth_anything import DepthAnythingParams, depthany_image_extent

    depth, yolo = chip_smoke.BULK_EXTENTS["depthany"], chip_smoke.BULK_EXTENTS["yolov9t"]
    assert len(depth) == 12 and len(yolo) == 8
    assert len({depthany_image_extent(e, DepthAnythingParams()) for e in depth}) == 3


def test_response_pixels_follow_the_endpoint(chip_smoke):
    import numpy as np

    from vision_tpu_torch import serve_http
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.image.png import read_png

    depth = Image(np.linspace(-0.2, 1.2, 30, dtype=np.float32).reshape(5, 6, 1), ImageFormat.alpha_f32)
    np.testing.assert_array_equal(chip_smoke.response_pixels("depthany", depth),
                                  read_png(serve_http._png_bytes(depth)))
    rgba = Image(np.arange(5 * 6 * 4, dtype=np.uint8).reshape(5, 6, 4), ImageFormat.rgba_u8)
    assert chip_smoke.response_pixels("migan", rgba).shape == (5, 6, 3)


def test_stream_plan_cycles_each_endpoints_bodies(chip_smoke):
    """Phase 30's latency streams: HTTP_STREAM requests an endpoint (64 or
    more, eight times the requests in flight), only its own bodies, each
    used as often as the others within one."""
    import numpy as np

    reqs = chip_smoke.http_requests(np.random.default_rng(30))
    assert chip_smoke.HTTP_STREAM >= 64
    for service, extents in chip_smoke.HTTP_EXTENTS.items():
        plan = chip_smoke.stream_plan(reqs, service, chip_smoke.HTTP_STREAM)
        assert len(plan) == chip_smoke.HTTP_STREAM and {reqs[i][0] for i in plan} == {service}
        uses = np.bincount(plan, minlength=len(reqs))[[i for i, r in enumerate(reqs) if r[0] == service]]
        assert len(uses) == len(extents) and uses.max() - uses.min() <= 1


def test_count_forwards_counts_calls_and_gives_the_method_back(chip_smoke):
    class Model:
        def forward_u8(self, x):
            return x + 1

    m = Model()
    calls = chip_smoke.count_forwards(m)
    assert [m.forward_u8(1), m.forward_u8(2)] == [2, 3] and len(calls) == 2
    del m.forward_u8
    assert m.forward_u8(3) == 4 and len(calls) == 2


@pytest.mark.parametrize("extent", [(518, 518), (700, 500), (640, 480)])
def test_depth_faults_drop_keys_at_every_eval_extent(chip_smoke, extent):
    """Each planted flash fault drops keys at every extent phase 32 scores
    (no token count there is a whole number of 64-key tiles), and only the
    keys it names."""
    import numpy as np

    assert extent in chip_smoke.BULK_EXTENTS["depthany"]
    t = chip_smoke.depth_tokens(extent)
    keys = np.arange(t)
    tail = keys[chip_smoke.DEPTH_FAULTS["ragged last key tile dropped"](t)]
    first = keys[chip_smoke.DEPTH_FAULTS["first 64-key tile dropped"](t)]
    assert t % 64 and len(tail) == t // 64 * 64 and tail[0] == 0
    assert len(first) == t - 64 and first[0] == 64 and first[-1] == t - 1


def test_shard_outputs_are_held_to_a_relative_rms(chip_smoke):
    """Phase 44's attention shard outputs pass within SHARD_BF16_REL_RMS of
    the plain version's f32 and fail past it (a dropped key tile moves a
    T-1370 output by ~0.2 of its RMS, far past the bound; bf16 rounding
    ~2-3e-3 stays under it)."""
    import torch

    ref = torch.linspace(-1.0, 1.0, 64).reshape(4, 16)
    assert chip_smoke.SHARD_BF16_REL_RMS == 1e-2
    assert chip_smoke.shard_rel_rms("rounded", ref * (1 + 3e-3), ref) == pytest.approx(3e-3, rel=1e-4)
    with pytest.raises(AssertionError, match="relative RMS"):
        chip_smoke.shard_rel_rms("a dropped tile", ref * 1.2, ref)


def test_sp_shards_are_a_sam3_rank_s_queries(chip_smoke):
    """Phase 44's sequence-parallel flash shapes: at batch 1 a rank of sp 3
    or 9 holds 5184 / sp of the window-major queries (3 windows of 576, 1)
    against all 5184 keys of the image; at sp 3 x tp 2, 8 of the 16 heads."""
    tokens = (1008 // 14) ** 2
    assert [(bh, tq, tk, d) for _, bh, tq, tk, d in chip_smoke.MESH_SP_FLASH] == [
        (16, tokens // 3, tokens, 80), (16, tokens // 9, tokens, 80), (16 // 2, tokens // 3, tokens, 80)]
    assert chip_smoke.SAM3_TRUNK_BF16_REL_RMS == chip_smoke.E2E_REL_RMS == 5e-2


def test_sam3_spatial_twin_is_the_stack_as_flat_views(chip_smoke):
    """Phase 47's spatial twin of a stacked Sam3Model: the flat window
    weights back as views of the stack (no copy), so that the spatial trunk
    on it gives what it gives on the loader's flat weights, and the model's
    window-major trunk agrees with it; sam3_stack(params, 1) is the first
    layer's slice."""
    import numpy as np
    import torch

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.models.random_weights import random_sam3_vision_params
    from vision_tpu_torch.models.sam3 import ClipTokenizer, Sam3Model, Sam3VitParams, encode_vision

    vp = Sam3VitParams(image_size=56, patch_size=14, window_size=2, n_layers=4, n_heads=2, global_attn_indexes=(1, 3))
    flat = params_from_numpy({f"det.ve.{k}": v for k, v in random_sam3_vision_params(0, 32, 4, 16).items()}, "cpu",
                             torch.float32)
    model = Sam3Model(flat, ClipTokenizer(vocab={}, bpe_rank={}), 8, backend_init("cpu"), vp=vp)
    model._vision_stack()
    twin = chip_smoke.sam3_spatial_twin(model.params, vp)
    assert set(twin) == set(flat) | set(model.params)
    stack = chip_smoke.sam3_stack(model.params)
    w = twin["det.ve.backbone.layers.2.mlp.fc1.weight"]
    assert w.untyped_storage().data_ptr() == stack["mlp.fc1.weight"].untyped_storage().data_ptr()
    assert chip_smoke.sam3_stack(model.params, 1)["mlp.fc1.weight"].shape[0] == 1
    x = torch.from_numpy(np.random.default_rng(0).random((1, 56, 56, 3)).astype(np.float32))
    with torch.inference_mode():
        want = encode_vision(Params(flat)["det.ve"], x, vp).fpn_hidden_states
        got = encode_vision(Params(twin)["det.ve"], x, vp).fpn_hidden_states
        scan = encode_vision(Params(model.params)["det.ve"], x, vp, win_stack=stack).fpn_hidden_states
    for a, b, c in zip(got, want, scan):
        assert torch.equal(a, b)
        assert float((c - b).abs().max()) <= 2e-5


def test_sam3_two_layers_are_the_flat_trunks_first_two(chip_smoke):
    """Phase 20's two-layer trunk on a stacked model: window layer 0 from the
    stack and layer 1's weights as the global layer, what the two layers of
    the flat weights give in the spatial trunk."""
    import numpy as np
    import torch

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.models.random_weights import random_sam3_vision_params
    from vision_tpu_torch.models.sam3 import ClipTokenizer, Sam3Model, Sam3VitParams, encode_vision

    vp = Sam3VitParams(image_size=56, patch_size=14, window_size=2, n_layers=4, n_heads=2, global_attn_indexes=(3,))
    vp2 = Sam3VitParams(image_size=56, patch_size=14, window_size=2, n_layers=2, n_heads=2, global_attn_indexes=(1,))
    flat = params_from_numpy({f"det.ve.{k}": v for k, v in random_sam3_vision_params(1, 32, 4, 16).items()}, "cpu",
                             torch.float32)
    model = Sam3Model(flat, ClipTokenizer(vocab={}, bpe_rank={}), 8, backend_init("cpu"), vp=vp)
    model._vision_stack()
    two, stack1 = chip_smoke.sam3_two_layers(model.params)
    assert stack1["mlp.fc1.weight"].shape[0] == 1
    x = torch.from_numpy(np.random.default_rng(1).random((1, 56, 56, 3)).astype(np.float32))
    with torch.inference_mode():
        want = encode_vision(Params(flat)["det.ve"], x, vp2).fpn_hidden_states
        got = encode_vision(Params(two)["det.ve"], x, vp2, win_stack=stack1).fpn_hidden_states
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 2e-5
