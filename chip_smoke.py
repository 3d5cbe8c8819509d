#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. environment: a CUDA device is required (no CPU continuation); prints the
     card's name and power limit, the torch and CUDA versions, and turns TF32
     off for the f32 comparisons;
  2. build: compiles the hand-written kernel library from the sources in
     vision_tpu_torch/csrc/ (one nvcc per source, in parallel) and prints the
     build seconds and ptxas's registers and spills for every instance;
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and at edge shapes;
  4. the Depth-Anything path: a Depth-Anything-V2-Small GGUF with random
     weights (seed 0) is written, loaded with depthany_load_model and served
     through ImageServer (batch 4): 8 requests in two extent buckets; the
     kernels' launch counts are zeroed just before and read just after;
  5. Depth-Anything parity: one request's raw depth on the card (bf16, kernel
     route) against the same port's f32 forward on the CPU (plain route);
  6. Depth-Anything timings with CUDA events, each beside the card name and
     power limit;
  7. the MobileSAM path: a mobile-sam GGUF of random_mobile_sam_params(0)
     (full TinyViT-5M) is written, loaded with sam_load_model on the card and
     on the CPU, and 12 requests (6 points, 6 boxes over 1024x1024, 640x480
     and 1600x1200) are served through SamServer (batch 6), the counts zeroed
     just before and read just after;
  8. MobileSAM parity: one request on the card in bf16 (kernel route) against
     the CPU's f32, stage by stage; and the encoder in f32 on the card
     (kernel route, TF32 off) against the CPU's f32;
  9. MobileSAM timings: the window kernel against its plain version, encode
     img/s over batch, single-mask latency, decode-only, the served numbers
     and the host's pre/post work, each beside the card name and power limit.

The line before the last is a JSON object describing every kernel of the
path; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BF16_MAX_ABS = 3e-2  # tests/test_pallas.py:55 allows 5e-2 for the Pallas bf16 path
F32_ATOL, F32_RTOL = 1e-4, 1e-3  # summation order differs; TF32 is off
E2E_REL_RMS = 5e-2  # bf16 card forward vs f32 CPU forward, whole model
RESAMPLE_RING = 0.1  # overshoot allowed past [0, 1] after the resize back
SAM_EMBED_REL_RMS = 5e-2  # bf16 card TinyViT embedding vs f32 CPU
SAM_MASK_REL_RMS = 1e-1  # bf16 card mask logits vs f32 CPU (the decoder adds its own bf16 roundings)
SAM_F32_REL_RMS = 1e-4  # f32 card encoder (kernel route, TF32 off) vs f32 CPU: summation order only
SAM_EXTENTS = ((1024, 1024), (640, 480), (1600, 1200))  # as is, upscaled, downscaled
SAM_STAGES = ((361, 49, 4), (25, 196, 5), (100, 49, 10))  # per image: windows, T, heads (hd = 32)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_cases(fa, torch) -> float:
    """Phase 3: the flash kernel against flash_attention_plain. Returns the
    largest absolute difference seen."""
    cases = [
        # (label, B, H, Tq, Tk, D, dtype)
        ("slice 518x518", 4, 6, 1370, 1370, 64, torch.bfloat16),
        ("slice 518x714", 4, 6, 1888, 1888, 64, torch.bfloat16),
        ("ragged f32", 2, 3, 300, 300, 32, torch.float32),
        ("one past a tile f32", 1, 2, 1025, 1025, 64, torch.float32),
        ("cross f32", 1, 2, 7, 150, 32, torch.float32),
        ("D=128 bf16", 2, 4, 700, 700, 128, torch.bfloat16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for label, b, h, tq, tk, d, dtype in cases:
        q = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, h, tk, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, h, tk, d, device="cuda", generator=gen).to(dtype)
        scale = d**-0.5
        before = fa.launches
        out = fa.flash_attention(q, k, v, scale=scale)
        torch.cuda.synchronize()
        if fa.launches != before + 1:
            raise AssertionError(f"{label}: launch count went {before} -> {fa.launches}")
        if out.shape != q.shape or out.dtype != dtype:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale)
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        worst = max(worst, err)
        if dtype == torch.float32:
            bound = F32_ATOL + F32_RTOL * ref.abs()
            ok = bool((diff <= bound).all())
            rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
        else:
            ok = err <= BF16_MAX_ABS
            rule = f"max abs <= {BF16_MAX_ABS}"
        print(f"kernel flash_attention {label} (B={b} H={h} Tq={tq} Tk={tk} D={d} {dtype}): "
              f"max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"flash_attention {label}: max abs err {err}")
    return worst


def window_cases(wa, torch, batch: int = 6) -> float:
    """Phase 3: the window kernel against window_attention_plain, at the
    three TinyViT stage shapes of a batch of ``batch`` 1024x1024 images in
    bf16 with a bf16 bias, and at f32 edge cases. Returns the largest
    absolute difference seen."""
    cases = [(f"stage {i + 1}", nw * batch, t, h, 32, torch.bfloat16, True)
             for i, (nw, t, h) in enumerate(SAM_STAGES)]
    cases += [
        # (label, NW, T, H, hd, dtype, bias)
        ("T=20 ragged f32", 7, 20, 2, 32, torch.float32, True),
        ("no bias f32", 9, 49, 4, 32, torch.float32, False),
        ("one window f32", 1, 49, 4, 32, torch.float32, True),
        ("H=5 T=196 f32", 3, 196, 5, 32, torch.float32, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for label, nw, t, h, hd, dtype, with_bias in cases:
        q, k, v = (torch.randn(nw, t, h * hd, device="cuda", generator=gen).to(dtype) for _ in range(3))
        bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(dtype) if with_bias else None
        scale = hd**-0.5
        before = wa.launches
        out = wa.window_attention(q, k, v, bias, h, scale)
        torch.cuda.synchronize()
        if wa.launches != before + 1:
            raise AssertionError(f"{label}: launch count went {before} -> {wa.launches}")
        if out.shape != q.shape or out.dtype != dtype:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
        ref = wa.window_attention_plain(q, k, v, bias, h, scale).float()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        worst = max(worst, err)
        if dtype == torch.float32:
            ok = bool((diff <= F32_ATOL + F32_RTOL * ref.abs()).all())
            rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
        else:
            ok = err <= BF16_MAX_ABS
            rule = f"max abs <= {BF16_MAX_ABS}"
        print(f"kernel window_attention {label} (NW={nw} T={t} H={h} hd={hd} {dtype}, "
              f"bias {'yes' if with_bias else 'no'}): max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"window_attention {label}: max abs err {err}")
    return worst


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b**2)) + 1e-12))


def sam_requests(rng, Image, ImageFormat):
    """6 point and 6 box requests over the three extents: (image, point, box)."""
    out = []
    for i in range(12):
        w, h = SAM_EXTENTS[i % 3]
        img = Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)
        if i % 2 == 0:
            out.append((img, (w // 3, h // 2), None))
        else:
            out.append((img, None, ((w // 8, h // 8), (w * 5 // 8, h * 3 // 4))))
    return out


def encoder_stages(params, x_u8, dtype, device):
    """The TinyViT encoder stage by stage, as tiny_vit runs it: a list of
    (name, output) ending with the embedding."""
    import torch

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models import mobile_sam as sam
    from vision_tpu_torch.ops import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

    tp = sam.TinyVitParams()
    out = []
    with torch.inference_mode():
        p = Params(params)["enc"]
        x = normalize_u8(x_u8.to(device), IMAGENET_MEAN, IMAGENET_STD, dtype)
        x = sam.patch_embed(p["patch_embed"], x)
        out.append(("patch_embed", x))
        x = sam.conv_layer(p["layers"][0], x, tp.layers[0])
        out.append(("layers.0 (MBConv)", x))
        for i in range(1, len(tp.layers)):
            x = sam.basic_layer(p["layers"][i], x, tp.layers[i])
            out.append((f"layers.{i} (windows)", x))
        res = tp.layers[-1].resolution
        x = sam.conv_2d(p["neck"][0], x.reshape(x.shape[0], res, res, x.shape[-1]))
        x = sam.layer_norm(p["neck"][1], x)
        x = sam.conv_2d(p["neck"][2], x, 1, 1)
        out.append(("embedding", sam.layer_norm(p["neck"][3], x)))
    return out


def write_sam_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_mobile_sam_params

    w = GGUFWriter(path, "mobile-sam")
    for name, a in random_mobile_sam_params(0).items():
        w.add_tensor(name, a)
    w.write()


def write_small_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_depth_anything_params

    w = GGUFWriter(path, "depthanything")
    w.add("dino.patch_size", 14)
    w.add("dino.embed_dim", 384)
    w.add("dino.n_heads", 6)
    w.add("dino.n_layers", 12)
    w.add("depthanything.image_size", 518)
    w.add("depthanything.feature_layers", [2, 5, 8, 11])
    w.add("depthanything.tensor_data_layout", "torch")
    for name, a in random_depth_anything_params("small", seed=0).items():
        w.add_tensor(name, a)
    w.write()


def main() -> int:
    import torch

    phase("1 environment")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs a CUDA card",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.models.depth_anything import depthany_load_model
    from vision_tpu_torch.models.mobile_sam import (
        best_masks,
        sam_load_model,
        sam_process_input_u8,
        sam_process_mask,
        sam_process_point,
    )
    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import flash_attention as fa
    from vision_tpu_torch.ops.cuda import window_attention as wa
    from vision_tpu_torch.serve import ImageServer, SamServer

    phase("2 build")
    t0 = time.perf_counter()
    build.load_library()
    print(f"kernel library {build.library_path().name}: ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info['seconds']:.2f} s)", flush=True)
    for line in build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    phase("3 kernels against their plain versions")
    worst = kernel_cases(fa, torch)
    win_worst = window_cases(wa, torch)

    phase("4 Depth-Anything path: Depth-Anything-V2-Small through ImageServer")
    rng = np.random.default_rng(0)

    def u8_img(h, w):
        return Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)

    requests = [u8_img(518, 518) for _ in range(5)] + [u8_img(500, 700) for _ in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "depth-anything-v2-small-random.gguf")
        write_small_gguf(path)
        model = depthany_load_model(path, backend_init("gpu"))
        cpu_model = depthany_load_model(path, backend_init("cpu"))
    print(f"model on {model.device.torch_device} {model.dtype}, flash={model.flash}", flush=True)
    with ImageServer(model, batch_size=4, max_delay_ms=20) as srv:
        srv.warmup()
        fa.launches = wa.launches = 0
        t_start = time.perf_counter()
        futures = [srv.submit(img) for img in requests]
        results = [f.result(timeout=600) for f in futures]
        wall_s = time.perf_counter() - t_start
        main_launches, depth_win_launches = fa.launches, wa.launches
        stats = srv.stats
        n_req, n_batches = stats.requests, stats.batches
        p50_ms = stats.p50_latency_ms
    for img, res in zip(requests, results):
        d = res.data
        if res.extent != img.extent or res.format != ImageFormat.alpha_f32:
            raise AssertionError(f"result {res.extent} {res.format} for request {img.extent}")
        # min-max normalized: [0, 1] exactly at the processed extent; a result
        # resampled back to its request's extent carries the stb filters'
        # ringing (Catmull-Rom/Mitchell, unclamped like the reference's float
        # resize), a few hundredths at most
        ring = 0.0 if img.extent == (518, 518) else RESAMPLE_RING
        if not (np.isfinite(d).all() and d.min() >= -ring and d.max() <= 1.0 + ring and d.max() > d.min()):
            raise AssertionError(f"result for {img.extent}: range [{d.min()}, {d.max()}]")
    if n_req != 8:
        raise AssertionError(f"stats.requests {n_req}")
    if main_launches == 0 or main_launches != 12 * n_batches or depth_win_launches != 0:
        raise AssertionError(f"flash_attention launches {main_launches} for {n_batches} batches of 12 layers, "
                             f"window_attention launches {depth_win_launches}")
    print(f"served {n_req} requests in {n_batches} batches; flash_attention launches {main_launches}, "
          f"window_attention launches {depth_win_launches}", flush=True)

    phase("5 Depth-Anything parity: card bf16 (kernel route) vs CPU f32 (plain route)")
    x = torch.from_numpy(requests[0].to_rgb_u8()[None])
    gpu_depth = model.forward_u8(x).float().cpu().numpy()
    cpu_depth = cpu_model.forward_u8(x).float().numpy()
    if gpu_depth.shape != (1, 518, 518, 1) or not np.isfinite(gpu_depth).all():
        raise AssertionError(f"forward_u8 gave {gpu_depth.shape}")
    depth_rms = rel_rms(gpu_depth, cpu_depth)
    print(f"depth relative RMS card vs CPU: {depth_rms:.4e} (bound {E2E_REL_RMS})", flush=True)
    if not depth_rms <= E2E_REL_RMS:
        raise AssertionError(f"end-to-end relative RMS {depth_rms}")

    phase(f"6 Depth-Anything timings on {card}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    timings = []
    for t in (1370, 1888):
        q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        kernel_ms = median_ms(lambda: fa.flash_attention(q, k, v), 20)
        plain_ms = median_ms(lambda: fa.flash_attention_plain(q, k, v, 64**-0.5), 20)
        kernel_ms2 = median_ms(lambda: fa.flash_attention(q, k, v), 20)
        plain_ms2 = median_ms(lambda: fa.flash_attention_plain(q, k, v, 64**-0.5), 20)
        timings.append((t, min(kernel_ms, kernel_ms2), min(plain_ms, plain_ms2)))
        print(f"flash_attention (24, {t}, 64) bf16: kernel median {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
              f"plain median {plain_ms:.4f} / {plain_ms2:.4f} ms [{card}]", flush=True)
    xb = torch.from_numpy(np.stack([r.to_rgb_u8() for r in requests[:4]]))
    fwd_ms = median_ms(lambda: model.forward_u8(xb), 5, warmup=2)
    print(f"forward_u8 batch 4 at 518x518 bf16: median {fwd_ms:.3f} ms [{card}]", flush=True)
    print(f"ImageServer 8 requests (5 at 518x518, 3 at 700x500): p50 latency {p50_ms:.3f} ms, "
          f"{8 / wall_s:.3f} img/s [{card}]", flush=True)
    del model, cpu_model

    phase("7 MobileSAM path: TinyViT-5M + SAM decoder through SamServer")
    srng = np.random.default_rng(3)
    sam_reqs = sam_requests(srng, Image, ImageFormat)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mobile-sam-random.gguf")
        write_sam_gguf(path)
        smodel = sam_load_model(path, backend_init("gpu"))
        cpu_smodel = sam_load_model(path, backend_init("cpu"))
    print(f"model on {smodel.device.torch_device} {smodel.dtype}, flash={smodel.flash}", flush=True)
    with SamServer(smodel, batch_size=6, max_delay_ms=5_000) as ssrv:
        ssrv.warmup()
        fa.launches = wa.launches = 0
        t_start = time.perf_counter()
        futures = [ssrv.submit(img, point=pt, box=bx) for img, pt, bx in sam_reqs]
        masks = [f.result(timeout=600) for f in futures]
        sam_wall_s = time.perf_counter() - t_start
        sam_win_launches, sam_flash_launches = wa.launches, fa.launches
        sstats = ssrv.stats
        s_req, s_batches, s_p50 = sstats.requests, sstats.batches, sstats.p50_latency_ms
    for (img, _, _), m in zip(sam_reqs, masks):
        if m.extent != img.extent or m.format != ImageFormat.alpha_u8 or not set(np.unique(m.data)) <= {0, 255}:
            raise AssertionError(f"mask {m.extent} {m.format} for request {img.extent}")
    if s_req != 12:
        raise AssertionError(f"stats.requests {s_req}")
    if sam_win_launches == 0 or sam_win_launches != 10 * s_batches or sam_flash_launches != 0:
        raise AssertionError(f"window_attention launches {sam_win_launches} for {s_batches} encoder batches "
                             f"of 10 windowed blocks, flash_attention launches {sam_flash_launches}")
    print(f"served {s_req} requests in {s_batches} batches; window_attention launches {sam_win_launches}, "
          f"flash_attention launches {sam_flash_launches}; mask foreground shares "
          f"{[round(float((m.data > 0).mean()), 4) for m in masks]}", flush=True)

    phase("8 MobileSAM parity: card bf16 (kernel route) vs CPU f32 (plain route)")
    img, pt, _ = sam_reqs[2]  # a 1600x1200 point request (downscaled)
    x = torch.from_numpy(sam_process_input_u8(img)[None])
    coords = sam_process_point(pt, img.extent)[None]
    gpu_stages = encoder_stages(smodel.params, x, smodel.dtype, "cuda")
    cpu_stages = encoder_stages(cpu_smodel.params, x, torch.float32, "cpu")
    for (name, g), (_, c) in zip(gpu_stages, cpu_stages):
        print(f"stage {name}: relative RMS card bf16 vs CPU f32 {rel_rms(g.float().cpu(), c):.4e}", flush=True)
    g_embed, c_embed = gpu_stages[-1][1], cpu_stages[-1][1]
    embed_rms = rel_rms(g_embed.float().cpu(), c_embed)
    g_pred = smodel.decode(g_embed, coords, "point")
    c_pred = cpu_smodel.decode(c_embed, coords, "point")
    g_masks, c_masks = g_pred.masks.float().cpu().numpy(), c_pred.masks.numpy()
    if g_masks.shape != (1, 4, 256, 256) or g_pred.masks.dtype != torch.float32 or not np.isfinite(g_masks).all():
        raise AssertionError(f"masks {g_masks.shape} {g_pred.masks.dtype}")
    mask_rms = rel_rms(g_masks, c_masks)
    agree = float(((g_masks > 0) == (c_masks > 0)).mean())
    iou_diff = (g_pred.iou.float().cpu().numpy() - c_pred.iou.numpy())[0]
    print(f"embedding relative RMS {embed_rms:.4e} (bound {SAM_EMBED_REL_RMS}); 4 mask logits relative RMS "
          f"{mask_rms:.4e} (bound {SAM_MASK_REL_RMS}); thresholded pixels agreeing {agree:.6f}; IoU card - CPU "
          f"{[float(d) for d in iou_diff]}", flush=True)
    if not (embed_rms <= SAM_EMBED_REL_RMS and mask_rms <= SAM_MASK_REL_RMS):
        raise AssertionError(f"MobileSAM bf16 parity: embedding {embed_rms}, masks {mask_rms}")
    f32_params = {k: v.to("cuda") for k, v in cpu_smodel.params.items()}
    before = wa.launches
    f32_embed = encoder_stages(f32_params, x, torch.float32, "cuda")[-1][1]
    f32_launches = wa.launches - before
    f32_rms = rel_rms(f32_embed.cpu(), c_embed)
    print(f"encoder f32 on the card (kernel route, {f32_launches} window launches, TF32 off) vs CPU f32: "
          f"relative RMS {f32_rms:.4e} (bound {SAM_F32_REL_RMS})", flush=True)
    if f32_launches != 10 or not f32_rms <= SAM_F32_REL_RMS:
        raise AssertionError(f"f32 encoder on the card: relative RMS {f32_rms}, {f32_launches} launches")
    del cpu_smodel, f32_params

    phase(f"9 MobileSAM timings on {card}")
    win_times = []
    for i, (nw, t, h) in enumerate(SAM_STAGES):
        q, k, v = (torch.randn(6 * nw, t, h * 32, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
        run_k = lambda: wa.window_attention(q, k, v, bias, h, 32**-0.5)  # noqa: E731
        run_p = lambda: wa.window_attention_plain(q, k, v, bias, h, 32**-0.5)  # noqa: E731
        k1, p1, k2, p2 = (median_ms(f, 20) for f in (run_k, run_p, run_k, run_p))
        win_times.append((f"({6 * nw}, {t}, {h * 32}) bf16, H={h}", min(k1, k2), min(p1, p2)))
        print(f"window_attention stage {i + 1} (NW={6 * nw}, T={t}, H={h}, hd=32) bf16: kernel median "
              f"{k1:.4f} / {k2:.4f} ms, plain median {p1:.4f} / {p2:.4f} ms [{card}]", flush=True)
    base = np.stack([sam_process_input_u8(r[0]) for r in sam_reqs[:8]])
    for b in (1, 2, 4, 6, 8):
        xb = torch.from_numpy(base[:b]).to("cuda")
        enc_ms = median_ms(lambda: smodel.encode_u8(xb), 20, warmup=3)
        print(f"encode (encode_batch's forward) batch {b} at 1024x1024 bf16: median {enc_ms:.3f} ms, "
              f"{b / enc_ms * 1e3:.3f} img/s [{card}]", flush=True)
    x1 = torch.from_numpy(base[:1]).to("cuda")
    pt_coords = np.array([[[0.1, 0.2], [0.0, 0.0]]], np.float32)

    def one_mask():
        return best_masks(smodel.decode(smodel.encode_u8(x1), pt_coords, "point"))

    mask_ms = median_ms(one_mask, 21, warmup=3)
    embed1 = smodel.encode_u8(x1)
    dec_ms = median_ms(lambda: best_masks(smodel.decode(embed1, pt_coords, "point")), 21, warmup=3)
    print(f"single mask (u8 1024x1024 -> encode -> point -> decode -> best mask) bf16: p50 {mask_ms:.3f} ms "
          f"over 21 runs [{card}]", flush=True)
    print(f"decode only, one point prompt: median {dec_ms:.3f} ms [{card}]", flush=True)
    print(f"SamServer 12 requests (6 points, 6 boxes; 1024x1024, 640x480, 1600x1200): p50 latency "
          f"{s_p50:.3f} ms, {12 / sam_wall_s:.3f} img/s, {s_batches} batches [{card}]", flush=True)
    fake_masks = np.random.default_rng(5).standard_normal((1, 256, 256)).astype(np.float32)
    for r in sam_reqs[:3]:
        t0 = time.perf_counter()
        sam_process_input_u8(r[0])
        t1 = time.perf_counter()
        sam_process_mask(fake_masks, 0, r[0].extent)
        t2 = time.perf_counter()
        print(f"host per request at {r[0].extent[0]}x{r[0].extent[1]}: prep (sam_process_input_u8) "
              f"{(t1 - t0) * 1e3:.3f} ms, post (sam_process_mask) {(t2 - t1) * 1e3:.3f} ms [{card}]", flush=True)

    _, k_ms, p_ms = timings[0]
    w_shape, w_ms, w_plain_ms = win_times[0]
    print(card)
    print(json.dumps({"kernels": [
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "vision_tpu_torch/csrc/flash_attention.cu",
            "replaces": "vision_tpu/ops/pallas/flash_attention.py:26",
            "launches": main_launches,
            "max_abs_err": worst,
            "ms": k_ms,
            "plain_ms": p_ms,
            "timed_shape": "(24, 1370, 64) bf16",
        },
        {
            "name": "window_attention",
            "route": "cuda",
            "source": "vision_tpu_torch/csrc/window_attention.cu",
            "replaces": "scripts/exp_winattn2.py:19",
            "launches": sam_win_launches,
            "max_abs_err": win_worst,
            "ms": w_ms,
            "plain_ms": w_plain_ms,
            "timed_shape": w_shape,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
