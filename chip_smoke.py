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
     paths' shapes and at edge shapes: flash attention at the token counts
     the Depth-Anything requests reach (depth_tokens of DEPTH_EXTENTS), D 32
     and 128, cross attention, Tq and Tk one past a key tile, and f32 cases;
     the window kernel at TinyViT's three stages (bf16 and f32 biases), one
     T > 200 case that reads its mask and bias from L2, and f32 cases; and
     the window kernel's launch plan, the library's against window_plan's,
     at every TinyViT and SWIN-L stage (two waves of the card at least);
  4. the Depth-Anything path: a Depth-Anything-V2-Small GGUF with random
     weights (seed 0) is written, loaded with depthany_load_model and served
     through ImageServer (batch 4): 8 requests in two extent buckets; the
     kernels' launch counts are zeroed just before and read just after;
  5. Depth-Anything parity: one request's raw depth on the card (bf16, kernel
     route) against the same port's f32 forward on the CPU (plain route);
  6. Depth-Anything timings, each beside the card name and power limit: the
     flash kernel and its plain version by the card's own time (device_ms:
     back-to-back calls queued behind a spin kernel) and the kernel by CUDA events
     around single calls (median_ms, the host's launch work included); the
     forward by CUDA events; and a torch.profiler trace of a batch-4
     forward (the flash kernel's share);
  7. the MobileSAM path: a mobile-sam GGUF of random_mobile_sam_params(0)
     (full TinyViT-5M) is written, loaded with sam_load_model on the card and
     on the CPU, and 12 requests (6 points, 6 boxes over 1024x1024, 640x480
     and 1600x1200) are served through SamServer (batch 6), the counts zeroed
     just before and read just after;
  8. MobileSAM parity: one request on the card in bf16 (kernel route) against
     the CPU's f32, stage by stage; and the encoder in f32 on the card
     (kernel route, TF32 off) against the CPU's f32;
  9. MobileSAM timings: the window kernel against its plain version (the
     card's own time, and per call with the host's launch work), encode
     img/s over batch, single-mask latency, decode-only, the served numbers
     and the host's pre/post work, each beside the card name and power limit;
 10. the conv3x3 kernel against its plain version: bf16 at the RRDB shapes
     (the five RDB convs, the stem and the last conv at 256x256), f32 edge
     cases (ragged H and W, batch, Cin 3 and 4, Cout 3, one pixel wide);
     then each epilogue and view form the Real-ESRGAN path gives it (conv1-4
     into a channel slice of a 192-channel buffer with leaky ReLU, conv5's
     x + 0.2 * y into the next buffer, RDB3's double residual written over
     its residual, the stem into a buffer, the trunk's skip, hr's leaky ReLU,
     the last conv), in bf16 at 256x256 and in bf16 and f32 at a ragged
     (2, 19, 23), every channel outside the written view checked unchanged;
     and one bf16 input of more than 2^31 elements, (4, 4096, 4096, 64 ->
     64);
 11. the Real-ESRGAN path: an esrgan GGUF of random_esrgan_params(0) (the
     full RealESRGAN-x4 RRDBNet: nf 64, gc 32, 23 blocks) is written, loaded
     with esrgan_load_model on the card and on the CPU, 6 requests (4 at
     256x256, 2 at 320x240) are served through EsrganServer (batch 4), and
     one 640x480 image goes through EsrganModel.compute's tiles, the counts
     zeroed just before and read just after each;
 12. Real-ESRGAN parity on a crop of one request: the card's bf16 float
     output against the CPU's f32, stage by stage in esrgan_generate's
     structure (each RRDB on its dense-block buffers, the biases, leaky
     ReLUs and residuals in the conv's epilogue); the card's f32 forward
     (kernel route, TF32 off, 351 launches) against the CPU's f32; the
     served u8 against the card's float forward;
 13. Real-ESRGAN timings: the conv kernel at the RDB shapes at 1024x1024 and
     the tail shapes at 4096x4096, with its path's epilogue and views and
     bare, against its plain version and F.conv2d (cuDNN, a yardstick the
     port never calls) with the bound beside each, by the card's own time
     (device_ms) and per call; forward_u8 at 1024x1024 and 512x512 x 4, and
     a profile of the latter that must hold fewer launches of other kernels
     than RRDBs (no elementwise pass per RRDB); the served and tiled
     numbers; and the yardsticks of the attention kernels
     (F.scaled_dot_product_attention, which the port never calls), by the
     card's own time and per call;
 14. the deform kernels against their plain versions: the column sampler
     (csrc/deform_sample.cu, off every served path) in bf16 at the 20 shapes
     of a batch-4 1024x1024 BiRefNet forward (Cin 112; k 1, 1, 3, 7 at
     256^2, 128^2, 64^2 and twice at 32^2; offsets within +-3) and f32 edge
     cases (Cin 5 and 12, stride 2, samples outside the image, bound 2 with
     offsets of +-9, no mask, f16 offsets, one column of more than 2^31
     elements); the fused deformable conv (csrc/deform_conv.cu) at the same
     20 shapes in bf16 with the path's epilogue (bias, BatchNorm, ReLU) into
     28-channel views of a 140-channel buffer (the other channels checked
     unchanged), its bf16 precision at k 7 256^2 against the f32 result
     rounded once, and f32 and bf16 edge cases (Cin 5, 8, 120, 200; Cout 1,
     28, 64, 100; stride 2; samples outside; bound 2 with offsets of +-9; no
     mask; f16 offsets; offsets of +-9 without a bound; more than 2^31
     column elements); and the window
     kernel with SWIN's per-window masks at the SWIN-L stage shapes (T 144,
     heads 6/12/24/48) and SWIN-T's T 49;
 15. the BiRefNet path: a birefnet GGUF of random_birefnet_params("large",
     0) (SWIN-L, 1024x1024) is written, loaded with birefnet_load_model on
     the card and on the CPU, and 8 requests (4 at 1024x1024, 2 at
     1280x720, 2 at 800x600, one extent bucket) are served through
     ImageServer (batch 4), the counts zeroed just before and read just
     after: 48 window launches (24 masked), 20 deform_conv launches and no
     deform_sample launch a batch;
 16. BiRefNet parity at 384x384: the card's bf16 against the CPU's f32,
     stage by stage; the card's f32 forward (kernel routes, TF32 off)
     against the CPU's f32; the served u8 mask against the card's float
     mask;
 17. BiRefNet timings, by the card's own time: the fused deformable conv
     per shape and per forward against its bound, its plain version, the
     yardstick F.grid_sample + mask product + torch.matmul (library calls
     the port never makes) and the parent's route (the column sampler, then
     torch.matmul), and the sampler alone; the masked window kernel against
     SDPA given the combined mask (the card's own time, and per call);
     forward_u8 at 1024x1024 batch 1 and 4 with the peak memory of each;
     the served numbers; and a torch.profiler trace of a batch-4 forward.

The line before the last is a JSON object describing every kernel of the
paths; the last line is {"ok": true, "device": {...}}.

    python3 chip_smoke.py --parent DIR

runs phases 1 and 2 and then only compare_with_parent: the attention and
conv kernels of another checkout of the port at DIR (say the parent commit,
unpacked with git archive) against this checkout's, in turns on one card,
then Real-ESRGAN's forward_u8 at 512x512 x 4 and BiRefNet's at 1024x1024 x
4 in each checkout (its own process, its own package and kernel library),
in turns.
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
ESRGAN_RDB = ((64, 32), (96, 32), (128, 32), (160, 32), (192, 64))  # (Cin, Cout) of conv1..conv5
ESRGAN_TAIL = ((64, 64), (64, 3))  # hr and last, at 4x the input's width and height
ESRGAN_CONVS = 351  # 1 + 23 * 3 * 5 + 1 + 2 + 1 + 1 per forward at scale 4
ESRGAN_FLOP_PER_PIXEL = 35.85e6  # per input pixel, all 351 convs at scale 4
ESRGAN_F32_REL_RMS = 1e-4  # f32 card forward (kernel route, TF32 off) vs f32 CPU: summation order only
# BiRefNet at 1024x1024: the decoder blocks' extents (squeeze and block4 at
# 32^2, block3 64^2, block2 128^2, block1 256^2) and each block's four
# deformable convs (aspp1 and the 1/3/7 branches), Cin 112
BIREF_BLOCK_HW = (32, 32, 64, 128, 256)
BIREF_DEFORM_KS = (1, 1, 3, 7)
BIREF_CIN = 112
BIREF_COUT = 28  # each ASPP branch's width, inter // 4; the branches fill a 5 * 28-channel buffer
DEFORM_F32_REL_RMS = 2e-5  # f32 fused deformable conv vs its plain version (TF32 off): summation order only
# the bf16 fused deformable conv's relative RMS error at most this times that
# of the f32 result rounded once to bf16 (its columns enter the product as a
# bf16 hi/lo pair, so the output is rounded once)
DEFORM_ROUNDING_RATIO = 1.15
BIREF_DEFORMS = 20  # 5 decoder blocks x 4 deformable convs per forward
BIREF_WINDOWS, BIREF_MASKED = 48, 24  # SWIN-L blocks per forward (both scales), the shifted half
BIREF_EXTENTS = ((1024, 1024),) * 4 + ((1280, 720),) * 2 + ((800, 600),) * 2  # (w, h); one 1024^2 bucket
BIREF_PARITY_HW = 384
BIREF_F32_REL_RMS = 1e-4  # f32 card forward (kernel routes, TF32 off) vs f32 CPU: summation order only
# SWIN-L's windowed attention at 1024x1024: (token grid side, heads); window 12, T 144
SWIN_L_STAGES = ((256, 6), (128, 12), (64, 24), (32, 48))
# the Depth-Anything requests' extents (w, h): 518x518 and 700x500, which
# depthany_image_extent snaps to 728x518
DEPTH_EXTENTS = ((518, 518), (700, 500))
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor
# cores, f32 outside the tensor cores, device memory
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# the deformable conv's bilinear blend per column element: the mask folded
# into the four corner weights once per (pixel, tap), then one product and
# three FMAs, 7 f32 FLOPs
BLEND_FLOPS = 7.0
# device_ms: a spin kernel of ~20 ms at the card's 1.98 GHz boost clock runs
# ahead of each timed run; and how the attention kernels' times in the
# kernels line were taken
SPIN_CYCLES = 40_000_000
DEVICE_TIMING = "the card's own time per call: CUDA events around 20 calls enqueued behind a spin kernel, over 20"


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


def device_ms(fn, calls: int = 20, warmup: int = 3, reps: int = 3) -> float:
    """The card's own time for one call of ``fn``: CUDA events around
    ``calls`` calls back to back, over the count, the median of ``reps``
    runs. Before each run a 20 ms spin kernel keeps the card busy while the
    host enqueues the calls, so the card runs them with no gap between.
    CUDA events around a single call (median_ms) also take in the host's
    time before the launch while the card idles: tens of microseconds of
    Python and launch work, as much as an attention kernel itself takes."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def depth_tokens(extent: tuple[int, int]) -> int:
    """DINOv2's token count for a Depth-Anything-V2 request of ``extent``
    (w, h): the patches of the extent depthany_image_extent snaps it to,
    and the class token."""
    from vision_tpu_torch.models.depth_anything import DepthAnythingParams, depthany_image_extent

    p = DepthAnythingParams()
    w, h = depthany_image_extent(extent, p)
    return (w // p.dino.patch_size) * (h // p.dino.patch_size) + 1


def kernel_cases(fa, torch) -> float:
    """Phase 3: the flash kernel against flash_attention_plain. Returns the
    largest absolute difference seen."""
    t_sq, t_wide = (depth_tokens(e) for e in DEPTH_EXTENTS)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (label, B, H, Tq, Tk, D, dtype)
        ("served 518x518", 4, 6, t_sq, t_sq, 64, bf16),
        ("served 700x500 (518x728)", 4, 6, t_wide, t_wide, 64, bf16),
        ("D=32 bf16", 2, 4, 700, 700, 32, bf16),
        ("D=128 bf16", 2, 4, 700, 700, 128, bf16),
        ("cross Tq 7, Tk 150 bf16", 1, 2, 7, 150, 64, bf16),
        (f"cross Tq {t_sq}, Tk {t_wide} bf16", 1, 6, t_sq, t_wide, 64, bf16),
        ("one past a 128 tile bf16", 2, 3, 129, 129, 64, bf16),
        ("one past a 64-key tile D=128 bf16", 1, 2, 129, 65, 128, bf16),
        ("one past a tile D=32 bf16", 1, 2, 257, 129, 32, bf16),
        ("ragged f32", 2, 3, 300, 300, 32, f32),
        ("one past a tile f32", 1, 2, 1025, 1025, 64, f32),
        ("cross f32", 1, 2, 7, 150, 32, f32),
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
    bf16 with a bf16 bias (stage 1 also with an f32 one), and at ragged and
    f32 edge cases. Returns the largest absolute difference seen."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"stage {i + 1}", nw * batch, t, h, 32, bf16, bf16) for i, (nw, t, h) in enumerate(SAM_STAGES)]
    cases += [
        # (label, NW, T, H, hd, dtype, bias dtype or None)
        ("stage 1, f32 bias", SAM_STAGES[0][0] * batch, 49, 4, 32, bf16, f32),
        ("T=20 ragged bf16, no bias", 7, 20, 2, 32, bf16, None),
        ("T=100 bf16", 5, 100, 3, 32, bf16, bf16),
        ("T=256 bf16, f32 bias (read from L2)", 6, 256, 2, 32, bf16, f32),
        ("T=20 ragged f32", 7, 20, 2, 32, f32, f32),
        ("no bias f32", 9, 49, 4, 32, f32, None),
        ("one window f32", 1, 49, 4, 32, f32, f32),
        ("H=5 T=196 f32", 3, 196, 5, 32, f32, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    for label, nw, t, h, hd, dtype, bias_dtype in cases:
        q, k, v = (torch.randn(nw, t, h * hd, device="cuda", generator=gen).to(dtype) for _ in range(3))
        with_bias = bias_dtype is not None
        bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(bias_dtype) if with_bias else None
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
              f"bias {bias_dtype}): max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"window_attention {label}: max abs err {err}")
    return worst


def window_plan_cases(wa, build, sam_batch: int = 6, swin_batch: int = 4) -> None:
    """Phase 3: the window kernel's launch plan, as the kernel library makes
    it (vtt_window_attention_plan), against window_plan, at TinyViT's three
    stages and SWIN-L's four (bf16 biases; SWIN with its shift masks); each
    must fill at least two waves of the card's SMs."""
    import ctypes

    from vision_tpu_torch.models.swin import compute_attention_mask

    lib = build.load_library()
    shapes = [(f"TinyViT stage {i + 1}", nw * sam_batch, t, h, 0) for i, (nw, t, h) in enumerate(SAM_STAGES)]
    for i, (side, h) in enumerate(SWIN_L_STAGES):
        n_masks = compute_attention_mask(side, side, 12).shape[0]
        shapes.append((f"SWIN-L stage {i + 1}", n_masks * swin_batch, 144, h, n_masks))
    for label, nw, t, h, n_masks in shapes:
        out = (ctypes.c_longlong * 6)()
        if lib.vtt_window_attention_plan(nw, t, h, n_masks, 2, out) != 0:
            raise AssertionError(f"{label}: vtt_window_attention_plan refused (NW={nw}, T={t}, H={h})")
        plan = wa.window_plan(nw, t, h, n_masks, 2)
        mine = (plan.blocks, plan.threads, plan.smem, plan.heads, plan.run, int(plan.staged))
        print(f"window_attention plan {label} (NW={nw}, T={t}, H={h}, {n_masks} masks): {plan.blocks} blocks of "
              f"{plan.threads} threads, {plan.smem} B shared memory, {plan.heads} heads x {plan.run} windows a "
              f"block, staged {plan.staged}, {plan.blocks_per_sm} blocks an SM, {plan.waves:.2f} waves", flush=True)
        if tuple(out) != mine or plan.waves < 2:
            raise AssertionError(f"{label}: library plan {tuple(out)}, window_plan {mine}, {plan.waves:.2f} waves")


def conv_cases(cc, torch) -> float:
    """Phase 10: the conv3x3 kernel against conv3x3_plain, bare, then with
    each epilogue and view form of the Real-ESRGAN path (epilogue_cases).
    Returns the largest absolute difference seen."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"RDB {ci}->{co}", 1, 256, 256, ci, co, bf16) for ci, co in ESRGAN_RDB]
    cases += [
        # (label, N, H, W, Cin, Cout, dtype)
        ("stem 3->64", 1, 256, 256, 3, 64, bf16),
        ("last 64->3", 1, 256, 256, 64, 3, bf16),
        ("ragged bf16, Cin 20 -> 12", 2, 7, 13, 20, 12, bf16),
        ("half a chunk bf16, Cin 24 -> 40", 3, 19, 23, 24, 40, bf16),
        ("two output tiles bf16, Cout 96", 1, 33, 17, 32, 96, bf16),
        ("W=13 H=7 f32", 1, 7, 13, 16, 8, f32),
        ("batch 3 f32", 3, 20, 19, 32, 32, f32),
        ("Cin 4 -> Cout 4 f32", 2, 9, 10, 4, 4, f32),
        ("Cin 3 f32", 1, 17, 18, 3, 64, f32),
        ("Cout 3 f32", 1, 15, 33, 64, 3, f32),
        ("one pixel wide f32", 2, 21, 1, 8, 8, f32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for label, n, h, w, ci, co, dtype in cases:
        x = (torch.randn(n, h, w, ci, device="cuda", generator=gen) * 0.5).to(dtype)
        wt = (torch.randn(co, ci, 3, 3, device="cuda", generator=gen) / (9 * ci) ** 0.5).to(dtype)
        before = cc.launches
        out = cc.conv3x3(x, wt)
        torch.cuda.synchronize()
        if cc.launches != before + 1:
            raise AssertionError(f"{label}: launch count went {before} -> {cc.launches}")
        if out.shape != (n, h, w, co) or out.dtype != dtype:
            raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
        ref = cc.conv3x3_plain(x.float(), wt.float())
        err = check_close(f"conv3x3 {label} ({n}, {h}, {w}, {ci}) -> {co} {dtype}", out, ref, dtype, torch)
        worst = max(worst, err)
    for dtype, (n, h, w) in ((bf16, (1, 256, 256)), (bf16, (2, 19, 23)), (f32, (2, 19, 23))):
        worst = max(worst, epilogue_cases(cc, torch, gen, n, h, w, dtype))

    # more than 2^31 elements: 64-bit offsets; the last image against the
    # plain version run on that image alone
    n, hw, c = 4, 4096, 64
    x = torch.empty(n, hw, hw, c, device="cuda", dtype=bf16)
    for i in range(n):  # one image at a time: each is below 2^31 elements
        x[i] = torch.randn(hw, hw, c, device="cuda", dtype=bf16, generator=gen)
    wt = (torch.randn(c, c, 3, 3, device="cuda", generator=gen) / (9 * c) ** 0.5).to(bf16)
    out = cc.conv3x3(x, wt)
    torch.cuda.synchronize()
    ref = cc.conv3x3_plain(x[n - 1 :].float(), wt.float())
    err = check_close(f"conv3x3 large ({n}, {hw}, {hw}, {c}) -> {c} bf16, {x.numel()} input elements, last image",
                      out[n - 1 :], ref, bf16, torch)
    del x, out, ref
    torch.cuda.empty_cache()
    return max(worst, err)


def epilogue_cases(cc, torch, gen, n: int, h: int, w: int, dtype) -> float:
    """Phase 10: each form the Real-ESRGAN path gives the kernel, on dense-
    block buffers of (n, h, w, 192), against conv3x3_plain on the same
    values: conv1-4 (a channel prefix in, 32 channels written after it,
    bias and leaky ReLU), conv5 (all 192 in, x + 0.2 * (conv + b) into the
    next buffer), RDB3's conv5 (the RRDB's residual too, written over it in
    place), the stem (Cin 3 into a buffer), the trunk conv (+ skip), hr
    (bias, leaky) and the last conv (Cout 3). Every channel a call must not
    write is checked unchanged. Returns the largest absolute difference."""
    nf, gc = 64, 32

    def rnd(*shape, scale=0.5):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(dtype)

    def weight(co, ci):
        return (torch.randn(co, ci, 3, 3, device="cuda", generator=gen) / (9 * ci) ** 0.5).to(dtype), rnd(co, scale=0.1)

    buf, nxt, res = rnd(n, h, w, nf + 4 * gc), rnd(n, h, w, nf + 4 * gc), rnd(n, h, w, nf + 4 * gc)
    x3, feat = rnd(n, h, w, 3), rnd(n, h, w, nf)
    forms = []  # (label, input view, weight, bias, kwargs, output view, its buffer)
    for k in range(4):
        c = nf + k * gc
        forms.append((f"conv{k + 1} {c}->{gc} into channels {c}:{c + gc}", buf[..., :c], *weight(gc, c),
                      {"slope": 0.2}, buf[..., c : c + gc], buf))
    forms.append(("conv5 192->64, x + 0.2 * y into the next buffer", buf, *weight(nf, 192),
                  {"r1": buf[..., :nf], "s1": 0.2}, nxt[..., :nf], nxt))
    forms.append(("RDB3 conv5, r2 + 0.2 * (x + 0.2 * y) over r2", buf, *weight(nf, 192),
                  {"r1": buf[..., :nf], "s1": 0.2, "r2": res[..., :nf], "s2": 0.2}, res[..., :nf], res))
    forms.append(("stem 3->64 into a buffer", x3, *weight(nf, 3), {}, nxt[..., :nf], nxt))
    forms.append(("trunk 64->64 + skip", buf[..., :nf], *weight(nf, nf), {"r1": feat}, None, None))
    forms.append(("hr 64->64, leaky", feat, *weight(nf, nf), {"slope": 0.2}, None, None))
    forms.append(("last 64->3", feat, *weight(3, nf), {}, None, None))
    worst = 0.0
    for label, x, wt, b, kw, out, whole in forms:
        ref = cc.conv3x3_plain(x.float(), wt.float(), b.float(),
                               **{k: (v.float() if torch.is_tensor(v) else v) for k, v in kw.items()})
        before_whole = None if whole is None else whole.clone()
        count = cc.launches
        got = cc.conv3x3(x, wt, b, out=out, **kw)
        torch.cuda.synchronize()
        if cc.launches != count + 1:
            raise AssertionError(f"{label}: launch count went {count} -> {cc.launches}")
        if out is not None:
            if got.data_ptr() != out.data_ptr():
                raise AssertionError(f"{label}: the result is not the given out view")
            keep = torch.ones(whole.shape[-1], dtype=torch.bool, device="cuda")
            keep[out.storage_offset() % whole.shape[-1] :][: out.shape[-1]] = False
            if not torch.equal(whole[..., keep], before_whole[..., keep]):
                raise AssertionError(f"{label}: channels outside the out view changed")
        worst = max(worst, check_close(f"conv3x3 epilogue {label} ({n}, {h}, {w}) {dtype}", got, ref, dtype, torch))
    return worst


def check_close(label: str, out, ref, dtype, torch) -> float:
    """Kernel output against the plain version's f32 result: max abs <=
    BF16_MAX_ABS in bf16, atol + rtol in f32. Returns the max abs error."""
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        ok = bool((diff <= F32_ATOL + F32_RTOL * ref.abs()).all())
        rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
    else:
        ok = err <= BF16_MAX_ABS
        rule = f"max abs <= {BF16_MAX_ABS}"
    print(f"kernel {label}: max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: max abs err {err}")
    return err


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bf16 tensor-core
    time and the device-memory time, and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_bound(pixels: int, ci: int, co: int, residuals: int = 0) -> tuple[float, str]:
    """bf16 3x3 conv: each input and output element, each residual read and
    the weight once."""
    return bound_ms(18.0 * pixels * ci * co, 2.0 * (pixels * (ci + co * (1 + residuals)) + 9 * ci * co))


def conv_path_forms(torch, gen, hw: int, ci: int, co: int):
    """The input, weight, bias and epilogue keywords of the Real-ESRGAN
    path's call at this shape: a growth conv reads a channel prefix of a
    192-channel buffer and writes its 32 channels after it with leaky ReLU,
    conv5 writes x + 0.2 * y into the next buffer, hr (64 -> 64) fuses the
    leaky ReLU, the last conv (-> 3) only the bias. Values of scale 0.5, as
    phase 10's, keep the outputs below 4, where a bf16 ulp is within
    BF16_MAX_ABS. Returns (x, w, b, kw, residuals read)."""
    bf16 = torch.bfloat16
    wt = (torch.randn(co, ci, 3, 3, device="cuda", generator=gen) / (9 * ci) ** 0.5).to(bf16)
    b = (torch.randn(co, device="cuda", generator=gen) * 0.1).to(bf16)
    if hw == 4096:
        x = (torch.randn(1, hw, hw, ci, device="cuda", generator=gen) * 0.5).to(bf16)
        return x, wt, b, ({"slope": 0.2} if co == 64 else {}), 0
    buf = (torch.randn(1, hw, hw, 192, device="cuda", generator=gen) * 0.5).to(bf16)
    if co == 32:
        return buf[..., :ci], wt, b, {"slope": 0.2, "out": buf[..., ci : ci + co]}, 0
    nxt = torch.empty(1, hw, hw, 192, device="cuda", dtype=bf16)
    return buf, wt, b, {"r1": buf[..., :co], "s1": 0.2, "out": nxt[..., :co]}, 1


def conv_timings(cc, torch, card: str) -> list:
    """Phase 13: the kernel bare and with its path's epilogue and views, its
    plain version and F.conv2d (channels-last cuDNN, bare), at the RDB
    shapes at 1024x1024 and the tail shapes at 4096x4096: the card's own
    time (device_ms, in turns) and, for the kernel, per call with the host's
    launch work (median_ms). Returns (label, pixels, Cin, Cout, kernel ms
    with the epilogue, bare kernel ms, plain ms, library ms, per-call ms,
    residuals read)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for hw, shapes in ((1024, ESRGAN_RDB), (4096, ESRGAN_TAIL)):
        for ci, co in shapes:
            x, wt, b, kw, res = conv_path_forms(torch, gen, hw, ci, co)
            xd = x.contiguous()
            xc = xd.permute(0, 3, 1, 2)  # an NHWC tensor is a channels-last NCHW one
            run_e = lambda: cc.conv3x3(x, wt, b, **kw)  # noqa: E731
            run_k = lambda: cc.conv3x3(xd, wt)  # noqa: E731
            run_l = lambda: F.conv2d(xc, wt, None, 1, 1)  # noqa: E731
            e1, k1, l1, e2, k2, l2 = (device_ms(f) for f in (run_e, run_k, run_l, run_e, run_k, run_l))
            p_ms = device_ms(lambda: cc.conv3x3_plain(xd, wt), calls=2, warmup=1, reps=1)
            call = median_ms(run_e, 10)
            bound, by = conv_bound(hw * hw, ci, co, res)
            rows.append((f"({hw}x{hw}, {ci}) -> {co}", hw * hw, ci, co, min(e1, e2), min(k1, k2), p_ms, min(l1, l2),
                         call, res))
            print(f"conv3x3 (1, {hw}, {hw}, {ci}) -> {co} bf16 on the card: kernel with the path's epilogue "
                  f"({', '.join(sorted(kw)) or 'bias'}) {e1:.4f} / {e2:.4f} ms, bare {k1:.4f} / {k2:.4f} ms, plain "
                  f"{p_ms:.4f} ms, F.conv2d {l1:.4f} / {l2:.4f} ms, bound {bound:.4f} ms ({by}); per call with the "
                  f"host's launch work {call:.4f} ms; {18.0 * hw * hw * ci * co / (min(e1, e2) * 1e-3) / 1e12:.1f} "
                  f"TFLOP/s [{card}]", flush=True)
            del x, xd, xc, kw
    torch.cuda.empty_cache()
    return rows


def attention_yardsticks(fa, wa, torch, card: str) -> tuple[float, float]:
    """Phase 13: F.scaled_dot_product_attention beside each attention kernel
    at its main path's shapes, a yardstick the port never calls: the card's
    own time of each (device_ms, in turns) and CUDA events around single
    calls (median_ms, the host's launch work included). Returns the library's
    device ms at the flash shapes by token count, and at the window kernel's
    TinyViT stage 1."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    flash = {}
    for t in (depth_tokens(e) for e in DEPTH_EXTENTS):
        q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        run_k = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        k1, l1, k2, l2 = (device_ms(f) for f in (run_k, run_l, run_k, run_l))
        ek, el = (median_ms(f, 20) for f in (run_k, run_l))
        flash[t] = min(l1, l2)
        b, by = bound_ms(4.0 * 24 * t * t * 64, 4 * 2.0 * 24 * t * 64)
        print(f"flash_attention (24, {t}, 64) bf16 on the card: kernel {k1:.4f} / {k2:.4f} ms, SDPA {l1:.4f} / "
              f"{l2:.4f} ms, bound {b:.4f} ms ({by}); per call with the host's launch work: kernel {ek:.4f} ms, SDPA "
              f"{el:.4f} ms [{card}]", flush=True)
    win = []
    for i, (nw, t, h) in enumerate(SAM_STAGES):
        q, k, v = (torch.randn(6 * nw, t, h * 32, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        bias = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
        # SDPA takes heads apart: (NW, H, T, hd), laid out before the timing
        q4, k4, v4 = (z.view(6 * nw, t, h, 32).transpose(1, 2).contiguous() for z in (q, k, v))
        run_k = lambda: wa.window_attention(q, k, v, bias, h, 32**-0.5)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bias)  # noqa: E731
        k1, l1, k2, l2 = (device_ms(f) for f in (run_k, run_l, run_k, run_l))
        ek, el = (median_ms(f, 20) for f in (run_k, run_l))
        win.append(min(l1, l2))
        b, by = bound_ms(4.0 * 6 * nw * h * t * t * 32, 4 * 2.0 * 6 * nw * t * h * 32 + 2.0 * h * t * t)
        print(f"window_attention stage {i + 1} (NW={6 * nw}, T={t}, H={h}, hd=32) bf16 on the card: kernel "
              f"{k1:.4f} / {k2:.4f} ms, SDPA with the bias as attn_mask {l1:.4f} / {l2:.4f} ms, bound {b:.4f} ms "
              f"({by}); per call with the host's launch work: kernel {ek:.4f} ms, SDPA {el:.4f} ms [{card}]",
              flush=True)
    return flash, win[0]


def profile_forward(model, x, torch, card: str, names=("conv3x3",)) -> dict:
    """Phases 13 and 17: where one forward's time goes, from a torch.profiler
    trace: device busy time (the sum of kernel times), the host's wall time,
    the idle share, the share of each named hand-written kernel, the
    launches of every other kernel, and the heaviest kernels. Returns the
    busy ms, wall ms and those other launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.forward_u8(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.forward_u8(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    shares = []
    for name in names:
        ms = sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
        shares.append(f"{name} {ms:.3f} ms ({ms / busy_ms:.2%} of busy)")
    others = sum(e.count for e in kernels if not any(name in e.key for name in names))
    print(f"profile of one forward_u8 {tuple(x.shape)}: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.2%}, {', '.join(shares)}, "
          f"{sum(e.count for e in kernels)} kernel launches, {others} of them not of {'/'.join(names)} [{card}]",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:100]}", flush=True)
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "other_launches": others}


def esrgan_stages(params, x_u8, p, dtype, device):
    """RRDBNet stage by stage, in esrgan_generate's structure (each RRDB on
    its dense-block buffers, every bias, leaky ReLU and residual in the conv
    kernel's epilogue): a list of (name, output) ending with the forward's
    float output."""
    import torch

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models import esrgan
    from vision_tpu_torch.ops import conv_3x3_fused, normalize_u8

    out = []
    with torch.inference_mode():
        m = Params(params)["model"]
        block = m[1]["sub"]
        feat = conv_3x3_fused(m[0], normalize_u8(x_u8.to(device), dtype=dtype))
        out.append(("stem", feat))
        sub = feat
        for i in range(p.n_blocks):
            sub = esrgan.rrdb(block[i], sub)
            if i in (0, p.n_blocks // 2, p.n_blocks - 1):
                out.append((f"after RRDB {i}", sub))
        x = conv_3x3_fused(block[p.n_blocks], sub, r1=feat)
        out.append(("trunk sum", x))
        seq = 2
        for _ in range(int(np.log2(p.scale))):
            x = esrgan._upsample(m[seq + 1], x)
            seq += 3
        out.append(("output", conv_3x3_fused(m[seq + 2], conv_3x3_fused(m[seq], x, slope=0.2))))
    return out


def write_esrgan_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_esrgan_params

    w = GGUFWriter(path, "esrgan")
    w.add("esrgan.scale", 4)
    w.add("esrgan.block_count", 23)
    for name, a in random_esrgan_params(0).items():
        w.add_tensor(name, a)
    w.write()


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b**2)) + 1e-12))


def rel_rms_t(a, b) -> float:
    """rel_rms of two tensors on the card, in f64 there."""
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / (b.pow(2).mean().sqrt() + 1e-12))


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

def deform_inputs(gen, torch, b, hw, cin, k, dtype, off_range=3.0, stride=1, pad=None, with_mask=True,
                  off_dtype=None):
    """x (b, hw, hw, cin), offsets within +-off_range and a mask in [0, 2] at
    the output extent of a k x k conv (pad k // 2 unless given)."""
    pad = k // 2 if pad is None else pad
    ho = (hw + 2 * pad - k) // stride + 1
    x = (torch.randn(b, hw, hw, cin, device="cuda", generator=gen) * 0.5).to(dtype)
    off = ((torch.rand(b, ho, ho, 2 * k * k, device="cuda", generator=gen) * 2 - 1) * off_range).to(
        off_dtype or dtype)
    mask = (torch.rand(b, ho, ho, k * k, device="cuda", generator=gen) * 2).to(dtype) if with_mask else None
    return x, off, mask, pad


def check_columns(label: str, out, ref, dtype, torch) -> float:
    """Sampler columns against the plain version's f32 columns: f32 within
    atol + rtol; bf16 within one bf16 ulp of the reference (the kernel
    rounds each column once, from an f32 blend whose FMAs may round its last
    f32 bit otherwise). Returns the max abs error."""
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        ok = bool((diff <= F32_ATOL + F32_RTOL * ref.abs()).all())
        rule = f"atol {F32_ATOL} rtol {F32_RTOL}"
    else:
        ok = bool((diff <= 2.0**-7 * ref.float().abs() + 1e-6).all())
        rule = "within one bf16 ulp"
    print(f"kernel deform_sample {label}: max_abs_err {err:.3e} [{rule}] {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"deform_sample {label}: max abs err {err}")
    return err


def deform_cases(dsm, torch) -> float:
    """Phase 14: the sampler against deform_sample_plain. The 256^2 shapes
    compare the batch's last image (the plain version's f32 temporaries of
    the whole batch are tens of gigabytes). Returns the largest absolute
    difference seen."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    bf16, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    for hw in BIREF_BLOCK_HW:
        for k in BIREF_DEFORM_KS:
            x, off, mask, pad = deform_inputs(gen, torch, 4, hw, BIREF_CIN, k, bf16)
            before = dsm.launches
            out = dsm.deform_sample(x, off, mask, k, k, 1, pad)
            torch.cuda.synchronize()
            if dsm.launches != before + 1 or out.shape != (4, hw, hw, k * k, BIREF_CIN) or out.dtype != bf16:
                raise AssertionError(f"deform_sample ({hw}, k={k}): {tuple(out.shape)} {out.dtype}, "
                                     f"{dsm.launches - before} launches")
            s = slice(3, 4) if hw == 256 else slice(0, 4)
            ref = dsm.deform_sample_plain(x[s].float(), off[s], mask[s], k, k, 1, pad)
            err = check_columns(f"BiRefNet (4, {hw}, {hw}, {BIREF_CIN}) k={k} bf16", out[s], ref, bf16, torch)
            worst = max(worst, err)
            del x, off, mask, out, ref
    cases = [
        # (label, b, hw, cin, k, stride, pad, dtype, off_range, bound, mask, off_dtype)
        ("Cin 5 f32", 2, 9, 5, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 12 f32 (16-byte path)", 2, 11, 12, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 12 bf16 (one element a thread)", 2, 11, 12, 3, 1, 1, bf16, 3.0, None, True, None),
        ("stride 2 f32", 2, 17, 16, 3, 2, 1, f32, 3.0, None, True, None),
        ("samples outside the image f32", 1, 10, 8, 3, 1, 1, f32, 12.0, None, True, None),
        ("bound 2, offsets +-9 f32", 2, 12, 8, 7, 1, 3, f32, 9.0, 2, True, None),
        ("no mask f32", 2, 12, 16, 7, 1, 3, f32, 3.0, None, False, None),
        ("f16 offsets read as f32, f32 x", 1, 12, 16, 3, 1, 1, f32, 3.0, None, True, torch.float16),
    ]
    for label, b, hw, cin, k, stride, pad, dtype, rng, bound, with_mask, off_dtype in cases:
        x, off, mask, pad = deform_inputs(gen, torch, b, hw, cin, k, dtype, rng, stride, pad, with_mask, off_dtype)
        out = dsm.deform_sample(x, off, mask, k, k, stride, pad, bound)
        torch.cuda.synchronize()
        ref = dsm.deform_sample_plain(x.float(), off, mask, k, k, stride, pad, bound)
        worst = max(worst, check_columns(f"{label} ({b}, {hw}, {hw}, {cin}) k={k}", out, ref, dtype, torch))

    # more than 2^31 column elements: 64-bit offsets; the last image against
    # the plain version run on that image alone
    x, off, mask, pad = deform_inputs(gen, torch, 6, 256, BIREF_CIN, 7, f32)
    out = dsm.deform_sample(x, off, mask, 7, 7, 1, pad)
    torch.cuda.synchronize()
    ref = dsm.deform_sample_plain(x[5:], off[5:], mask[5:], 7, 7, 1, pad)
    err = check_columns(f"large (6, 256, 256, {BIREF_CIN}) k=7 f32, {out.numel()} column elements, last image",
                        out[5:], ref, f32, torch)
    del x, off, mask, out, ref
    torch.cuda.empty_cache()
    return max(worst, err)


def deform_conv_path_forms(torch, gen, b: int, hw: int, k: int, branch: int, dtype=None, cin: int = BIREF_CIN,
                           cout: int = BIREF_COUT):
    """The inputs and keywords of the BiRefNet path's call of the fused
    deformable conv for ASPP branch ``branch`` (0-3) at this shape: x, the
    offsets (within +-3) and the 2 * sigmoid mask of deform_inputs, a weight
    of scale 1 / sqrt(k^2 Cin), the conv bias, the BatchNorm's scale and
    shift, ReLU, ``out`` the branch's channels of a (b, hw, hw, 5 Cout)
    buffer filled with noise, and the weight's layout, which BirefnetModel
    makes once. Returns (x, w, off, mask, pad, kw, buf)."""
    from vision_tpu_torch.ops.cuda.deform_conv import weight_layout

    dtype = dtype or torch.bfloat16
    x, off, mask, pad = deform_inputs(gen, torch, b, hw, cin, k, dtype)
    w = (torch.randn(cout, cin, k, k, device="cuda", generator=gen) / (k * k * cin) ** 0.5).to(dtype)
    bias, shift = ((torch.randn(cout, device="cuda", generator=gen) * 0.1).to(dtype) for _ in range(2))
    scale = (torch.rand(cout, device="cuda", generator=gen) + 0.5).to(dtype)
    buf = torch.randn(b, hw, hw, 5 * cout, device="cuda", generator=gen).to(dtype)
    kw = {"bias": bias, "scale": scale, "shift": shift, "relu": True,
          "out": buf[..., branch * cout:(branch + 1) * cout], "layout": weight_layout(w, dtype)}
    return x, w, off, mask, pad, kw, buf


def deform_conv_cases(dcm, torch) -> tuple[float, float]:
    """Phase 14: the fused deformable conv against deform_conv_plain. bf16
    at the 20 shapes of a batch-4 1024x1024 BiRefNet forward with the path's
    epilogue (bias, BatchNorm scale and shift, ReLU) into its branch's
    channels of a 140-channel buffer, max abs <= BF16_MAX_ABS and every other
    channel unchanged (the 256^2 shapes compare the batch's last image); at
    k 7, 256^2 its relative RMS against the f32 result is at most
    DEFORM_ROUNDING_RATIO times that of the f32 result rounded once to bf16;
    edge cases in f32 (relative RMS <= DEFORM_F32_REL_RMS, TF32 off) and
    bf16, one with more than 2^31 column elements (which the kernel never
    holds). Returns the largest absolute difference seen and the precision
    ratio."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32
    worst, ratio = 0.0, None
    for hw in BIREF_BLOCK_HW:
        for branch, k in enumerate(BIREF_DEFORM_KS):
            x, w, off, mask, pad, kw, buf = deform_conv_path_forms(torch, gen, 4, hw, k, branch)
            before, keep = dcm.launches, buf.clone()
            out = dcm.deform_conv(x, w, off, mask, k, k, 1, pad, **kw)
            torch.cuda.synchronize()
            if dcm.launches != before + 1 or out.data_ptr() != kw["out"].data_ptr():
                raise AssertionError(f"deform_conv ({hw}, k={k}): {dcm.launches - before} launches, out not in place")
            c0, c1 = branch * BIREF_COUT, (branch + 1) * BIREF_COUT
            if not (torch.equal(buf[..., :c0], keep[..., :c0]) and torch.equal(buf[..., c1:], keep[..., c1:])):
                raise AssertionError(f"deform_conv ({hw}, k={k}): channels outside the view changed")
            s = slice(3, 4) if hw == 256 else slice(0, 4)
            epi = {n: v.float() for n, v in kw.items() if n in ("bias", "scale", "shift")}
            ref = dcm.deform_conv_plain(x[s].float(), w.float(), off[s], mask[s], k, k, 1, pad, relu=True, **epi)
            label = (f"deform_conv BiRefNet (4, {hw}, {hw}, {BIREF_CIN}) k={k} -> {BIREF_COUT} bf16, bias, BN, ReLU "
                     f"into channels {c0}:{c1} of {5 * BIREF_COUT}")
            worst = max(worst, check_close(label, out[s], ref, bf16, torch))
            if hw == 256 and k == 7:
                k_err, once = rel_rms_t(out[s].float(), ref), rel_rms_t(ref.to(bf16).float(), ref)
                ratio = k_err / once
                print(f"deform_conv k=7 256^2 bf16: relative RMS against the f32 result {k_err:.4e}, the f32 result "
                      f"rounded once to bf16 {once:.4e}: ratio {ratio:.4f} (bound {DEFORM_ROUNDING_RATIO})", flush=True)
                if not ratio <= DEFORM_ROUNDING_RATIO:
                    raise AssertionError(f"deform_conv bf16 precision ratio {ratio}")
            del x, w, off, mask, kw, buf, keep, out, ref
    cases = [
        # (label, b, hw, cin, cout, k, stride, pad, dtype, off_range, bound, mask, off_dtype)
        ("Cin 5, Cout 1", 2, 9, 5, 1, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 8, Cout 28", 2, 11, 8, 28, 3, 1, 1, f32, 3.0, None, True, None),
        ("Cin 120, Cout 64", 1, 13, 120, 64, 3, 1, 1, f32, 3.0, None, True, None),
        ("stride 2", 2, 17, 16, 28, 3, 2, 1, f32, 3.0, None, True, None),
        ("samples outside the image", 1, 10, 8, 28, 3, 1, 1, f32, 12.0, None, True, None),
        ("bound 2, offsets +-9", 2, 12, 8, 28, 7, 1, 3, f32, 9.0, 2, True, None),
        ("no mask", 2, 12, 16, 28, 7, 1, 3, f32, 3.0, None, False, None),
        ("f16 offsets read as f32", 1, 12, 16, 28, 3, 1, 1, f32, 3.0, None, True, torch.float16),
        ("Cin 5, Cout 1 (one element a load)", 2, 9, 5, 1, 3, 1, 1, bf16, 3.0, None, True, None),
        ("Cin 24, Cout 64 (64-wide tile)", 2, 13, 24, 64, 3, 1, 1, bf16, 3.0, None, True, None),
        ("Cin 112, Cout 100 (two 64-wide tiles)", 1, 19, 112, 100, 7, 1, 3, bf16, 3.0, None, True, None),
        ("stride 2, bound 2, offsets +-9", 2, 21, 32, 28, 3, 2, 1, bf16, 9.0, 2, True, None),
        ("no mask, ragged 8x8 tiles", 3, 11, 16, 28, 7, 1, 3, bf16, 3.0, None, False, None),
        ("Cin 200 (two blend passes), Cout 28", 1, 13, 200, 28, 3, 1, 1, bf16, 3.0, None, True, None),
        ("Cin 112, offsets +-9 (corners far from the tile)", 1, 40, 112, 28, 7, 1, 3, bf16, 9.0, None, True, None),
    ]
    for label, b, hw, cin, cout, k, stride, pad, dtype, rng, bound, with_mask, off_dtype in cases:
        x, off, mask, pad = deform_inputs(gen, torch, b, hw, cin, k, dtype, rng, stride, pad, with_mask, off_dtype)
        w = (torch.randn(cout, cin, k, k, device="cuda", generator=gen) / (k * k * cin) ** 0.5).to(dtype)
        bias = (torch.randn(cout, device="cuda", generator=gen) * 0.1).to(dtype)
        out = dcm.deform_conv(x, w, off, mask, k, k, stride, pad, bound, bias=bias)
        torch.cuda.synchronize()
        ref = dcm.deform_conv_plain(x.float(), w.float(), off, mask, k, k, stride, pad, bound, bias=bias.float())
        label = f"deform_conv {label} ({b}, {hw}, {hw}, {cin}) k={k} -> {cout} {dtype}"
        if dtype == f32:
            err = rel_rms_t(out, ref)
            print(f"kernel {label}: relative RMS {err:.3e} [<= {DEFORM_F32_REL_RMS}] "
                  f"{'ok' if err <= DEFORM_F32_REL_RMS else 'FAIL'}", flush=True)
            if not err <= DEFORM_F32_REL_RMS:
                raise AssertionError(f"{label}: relative RMS {err}")
            err = float((out - ref).abs().max())
        else:
            err = check_close(label, out, ref, dtype, torch)
        worst = max(worst, err)

    # more than 2^31 column elements (B Ho Wo k^2 Cin): the last image against
    # the plain version run on that image alone
    x, w, off, mask, pad, kw, buf = deform_conv_path_forms(torch, gen, 6, 256, 7, 3, f32)
    out = dcm.deform_conv(x, w, off, mask, 7, 7, 1, pad, **kw)
    torch.cuda.synchronize()
    epi = {n: v for n, v in kw.items() if n in ("bias", "scale", "shift")}
    ref = dcm.deform_conv_plain(x[5:], w, off[5:], mask[5:], 7, 7, 1, pad, relu=True, **epi)
    err = rel_rms_t(out[5:], ref)
    print(f"kernel deform_conv large (6, 256, 256, {BIREF_CIN}) k=7 f32, {6 * 256 * 256 * 49 * BIREF_CIN} column "
          f"elements, last image: relative RMS {err:.3e} [<= {DEFORM_F32_REL_RMS}]", flush=True)
    if not err <= DEFORM_F32_REL_RMS:
        raise AssertionError(f"deform_conv large: relative RMS {err}")
    del x, w, off, mask, kw, buf, out, ref
    torch.cuda.empty_cache()
    return worst, ratio


def swin_windows(torch, gen, side: int, window: int, heads: int, batch: int, dtype, bias_dtype=None):
    """q, k, v of one SWIN stage's windows (the token grid padded to the
    window), a bias (heads, T, T) in ``bias_dtype`` (default ``dtype``) and
    the stage's shift mask (nW, T, T) f32 on the card."""
    from vision_tpu_torch.models.swin import compute_attention_mask

    mask = torch.tensor(compute_attention_mask(side, side, window), device="cuda")
    nw, t = mask.shape[0] * batch, window * window
    q, k, v = (torch.randn(nw, t, heads * 32, device="cuda", generator=gen).to(dtype) for _ in range(3))
    bias = (torch.randn(heads, t, t, device="cuda", generator=gen) * 0.5).to(bias_dtype or dtype)
    return q, k, v, bias, mask


def masked_window_cases(wa, torch) -> float:
    """Phase 14: the window kernel with per-window masks against
    window_attention_plain: SWIN-L's four stages at 1024x1024, batch 4, in
    bf16 with a bf16 bias (stage 1 also with an f32 one); SWIN-T's T 49
    (window 7); windows of 15 and 16 (T 225 and 256: mask and bias read from
    L2, in pairs where T is even) and f32 cases. Returns the largest absolute
    difference seen."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(f"SWIN-L stage {i + 1}", side, 12, h, 4, bf16, bf16) for i, (side, h) in enumerate(SWIN_L_STAGES)]
    cases += [("SWIN-L stage 1, f32 bias", 256, 12, 6, 4, bf16, f32),
              ("SWIN-T stage 1 at 224^2", 56, 7, 3, 2, bf16, bf16),
              ("window 15, T=225 (L2)", 30, 15, 2, 2, bf16, bf16),
              ("window 16, T=256 (L2)", 32, 16, 3, 2, bf16, f32),
              ("SWIN-L stage 4 f32", 32, 12, 48, 2, f32, f32),
              ("SWIN-T T=49 f32", 20, 7, 6, 3, f32, f32)]
    worst = 0.0
    for label, side, window, h, batch, dtype, bias_dtype in cases:
        q, k, v, bias, mask = swin_windows(torch, gen, side, window, h, batch, dtype, bias_dtype)
        before, before_masked = wa.launches, wa.masked_launches
        out = wa.window_attention(q, k, v, bias, h, 32**-0.5, mask)
        torch.cuda.synchronize()
        if wa.launches != before + 1 or wa.masked_launches != before_masked + 1:
            raise AssertionError(f"{label}: launch counts went {before} -> {wa.launches}")
        ref = wa.window_attention_plain(q, k, v, bias, h, 32**-0.5, mask).float()
        err = check_close(f"window_attention masked {label} (NW={q.shape[0]}, T={q.shape[1]}, H={h}, "
                          f"{mask.shape[0]} masks) {dtype}, bias {bias.dtype}", out, ref, dtype, torch)
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label}: non-finite output")
        worst = max(worst, err)
    return worst


def write_birefnet_gguf(path: str) -> None:
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_birefnet_params

    w = GGUFWriter(path, "birefnet")
    w.add("birefnet.image_size", 1024)
    w.add("birefnet.image_multiple", 32)
    w.add("swin.embed_dim", 192)
    for name, a in random_birefnet_params("large", 0).items():
        w.add_tensor(name, a)
    w.write()


def birefnet_stages(model, x_u8, params=None, dtype=None):
    """birefnet_predict stage by stage on the model's device: the four
    encoder levels, the squeeze block, the four decoder blocks and the mask,
    as a list of (name, output). The stages are read by wrapping the
    module's encode and basic_decoder_block for one call."""
    import torch

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models import birefnet as bn
    from vision_tpu_torch.ops import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

    out = []
    encode, block = bn.encode, bn.basic_decoder_block

    def encode_rec(*a):
        xs = encode(*a)
        out.extend((f"encoder level {i}", f) for i, f in enumerate(xs))
        return xs

    def block_rec(*a):
        y = block(*a)
        out.append((("squeeze", "block4", "block3", "block2", "block1")[len(out) - 4], y))
        return y

    bn.encode, bn.basic_decoder_block = encode_rec, block_rec
    try:
        with torch.inference_mode():
            dt = dtype or model.dtype
            x = normalize_u8(x_u8.to(model.device.torch_device), IMAGENET_MEAN, IMAGENET_STD, dt)
            mask = bn.birefnet_predict(Params(params or model.params), x, model.p, model.deform_bound)
    finally:
        bn.encode, bn.basic_decoder_block = encode, block
    return out + [("mask", mask)]


def deform_bound_ms(b: int, hw: int, cin: int, k: int, nbytes_el: int = 2) -> tuple[float, str]:
    """The sampler's least time: columns written, x, offsets and mask read
    once (bytes), or its f32 blend on the CUDA cores (operations):
    BLEND_FLOPS per column element."""
    cols = b * hw * hw * k * k * cin
    nbytes = nbytes_el * (cols + b * hw * hw * cin + b * hw * hw * 3 * k * k)
    t_ops, t_bytes = BLEND_FLOPS * cols / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def grid_sample_yardstick(x, off, k: int, pad: int, torch):
    """F.grid_sample over all taps: the same bilinear samples (zeros outside,
    no modulation) of the NCHW view of x at the deformed positions, laid
    out (B, Cin, Ho, Wo * K^2). Returns the call and its grid (made here,
    outside the timing)."""
    import torch.nn.functional as F

    b, h, w, _ = x.shape
    ho, wo = off.shape[1], off.shape[2]
    kk = k * k
    o = off.float().reshape(b, ho, wo, kk, 2)
    ky = torch.arange(k, device="cuda").repeat_interleave(k)
    kx = torch.arange(k, device="cuda").repeat(k)
    py = (torch.arange(ho, device="cuda") - pad)[:, None, None] + ky + o[..., 0]
    px = (torch.arange(wo, device="cuda") - pad)[None, :, None] + kx + o[..., 1]
    # align_corners=False: pixel i's centre is at (2i + 1) / n - 1
    grid = torch.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1], dim=-1).reshape(b, ho, wo * kk, 2).to(x.dtype)
    xc = x.permute(0, 3, 1, 2)  # an NHWC tensor is a channels-last NCHW one
    return lambda: F.grid_sample(xc, grid, "bilinear", "zeros", align_corners=False)


def deform_conv_bound_ms(b: int, hw: int, cin: int, cout: int, k: int) -> tuple[float, str]:
    """The fused deformable conv's least time in bf16: x, the offsets, the
    mask and the weight read once and the output written once (bytes), or
    the larger of its f32 blend on the CUDA cores (BLEND_FLOPS per column
    element) and its product on the tensor cores (operations), in the
    kernel's order: blend the Cin channels of each (pixel, tap), then
    multiply. The columns are never written. The other order, a product of
    every input pixel with each tap's weight and then a blend of its Cout
    results, does fewer operations where Cout < Cin (BiRefNet's 28 < 112:
    a blend a quarter as long, with the same product at stride 1); this
    bound does not count that order."""
    cols = b * hw * hw * k * k * cin
    nbytes = 2.0 * (b * hw * hw * (cin + 3 * k * k + cout) + k * k * cin * cout)
    t_ops = max(BLEND_FLOPS * cols / PEAK_F32_FLOPS, 2.0 * cols * cout / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def deform_timings(dsm, dcm, torch, card: str) -> dict:
    """Phase 17: at each distinct (extent, k) of a batch-4 1024x1024 BiRefNet
    forward, by the card's own time (device_ms): the fused kernel with the
    path's epilogue and view (and bare), against the parent's route (the
    column sampler, then torch.matmul of its columns) in turns; the plain
    version; the yardstick, F.grid_sample over all taps, the mask product
    and torch.matmul of (B Ho Wo, k^2 Cin) columns, each timed alone and
    summed (library calls the port never makes); the sampler alone with
    its plain version; and the weight's layout (two device passes that the
    model makes once, and a call given no layout at every call), alone and
    per call with the host's work. Returns {(hw, k): {name: ms, ...}}."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf16 = torch.bfloat16
    rows = {}
    for hw in sorted(set(BIREF_BLOCK_HW)):
        for k in sorted(set(BIREF_DEFORM_KS)):
            kk = k * k
            x, w, off, mask, pad, kw, _ = deform_conv_path_forms(torch, gen, 4, hw, k, 3)
            wmat = w.permute(2, 3, 1, 0).reshape(kk * BIREF_CIN, BIREF_COUT).contiguous()
            cols = torch.empty(4 * hw * hw, kk * BIREF_CIN, device="cuda", dtype=bf16).normal_(generator=gen)
            run_f = lambda: dcm.deform_conv(x, w, off, mask, k, k, 1, pad, **kw)  # noqa: E731
            run_b = lambda: dcm.deform_conv(x, w, off, mask, k, k, 1, pad, layout=kw["layout"])  # noqa: E731
            run_l = lambda: dcm.weight_layout(w, bf16)  # noqa: E731
            plain_kw = {n: v for n, v in kw.items() if n != "layout"}  # the plain version reads the weight
            run_p = lambda: dcm.deform_conv_plain(x, w, off, mask, k, k, 1, pad, **plain_kw)  # noqa: E731
            run_s = lambda: dsm.deform_sample(x, off, mask, k, k, 1, pad)  # noqa: E731
            run_sp = lambda: dsm.deform_sample_plain(x, off, mask, k, k, 1, pad)  # noqa: E731
            run_r = lambda: torch.matmul(run_s().view(-1, kk * BIREF_CIN), wmat)  # noqa: E731
            run_g = grid_sample_yardstick(x, off, k, pad, torch)
            sampled = run_g()  # (B, Cin, Ho, Wo k^2)
            m4 = mask.reshape(4, 1, hw, hw * kk)
            run_m = lambda: sampled * m4  # noqa: E731
            run_mm = lambda: torch.matmul(cols, wmat)  # noqa: E731
            f1, r1, f2, r2 = (device_ms(fn) for fn in (run_f, run_r, run_f, run_r))
            t = {"fused": min(f1, f2), "route": min(r1, r2), "bare": device_ms(run_b), "sampler": device_ms(run_s),
                 "grid_sample": device_ms(run_g), "mask_product": device_ms(run_m), "matmul": device_ms(run_mm),
                 "plain": device_ms(run_p, calls=2, warmup=1, reps=1),
                 "sampler_plain": device_ms(run_sp, calls=1, warmup=1, reps=1),
                 "layout": device_ms(run_l), "layout_call": median_ms(run_l, 10)}
            t["library"] = t["grid_sample"] + t["mask_product"] + t["matmul"]
            # what one call allocates above its inputs: the fused kernel
            # nothing but its output, the parent's route its columns too
            for key, fn in (("fused_alloc_mib", run_b), ("route_alloc_mib", run_r)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                fn()
                torch.cuda.synchronize()
                t[key] = (torch.cuda.max_memory_allocated() - before) / 2**20
            t["bound"], t["bound_by"] = deform_conv_bound_ms(4, hw, BIREF_CIN, BIREF_COUT, k)
            t["sampler_bound"], t["sampler_bound_by"] = deform_bound_ms(4, hw, BIREF_CIN, k)
            rows[(hw, k)] = t
            print(f"deform_conv (4, {hw}, {hw}, {BIREF_CIN}) k={k} -> {BIREF_COUT} bf16 on the card: fused kernel with "
                  f"the path's epilogue into a view {f1:.4f} / {f2:.4f} ms, bare {t['bare']:.4f} ms; the weight's "
                  f"layout {t['layout']:.4f} ms ({t['layout_call']:.4f} ms a call with the host's work), made once by "
                  f"the model; parent's route "
                  f"(sampler + matmul) {r1:.4f} / {r2:.4f} ms, sampler alone {t['sampler']:.4f} ms; yardstick "
                  f"{t['library']:.4f} ms (F.grid_sample {t['grid_sample']:.4f} + mask product "
                  f"{t['mask_product']:.4f} + matmul {t['matmul']:.4f}); plain {t['plain']:.4f} ms, sampler plain "
                  f"{t['sampler_plain']:.4f} ms; bound {t['bound']:.4f} ms ({t['bound_by']}), sampler's "
                  f"{t['sampler_bound']:.4f} ms ({t['sampler_bound_by']}); one call allocates "
                  f"{t['fused_alloc_mib']:.1f} MiB fused, {t['route_alloc_mib']:.1f} MiB by the parent's route "
                  f"[{card}]", flush=True)
            del x, w, off, mask, kw, wmat, cols, sampled, m4, run_g
            torch.cuda.empty_cache()
    return rows


def masked_window_yardsticks(wa, torch, card: str) -> list:
    """Phase 17: the masked window kernel against its plain version and SDPA
    given the combined mask (bias + the stage's shift mask, per window),
    at SWIN-L's four stages, batch 4: the card's own time of each
    (device_ms, in turns) and CUDA events around single calls of the kernel
    and SDPA. Returns (label, kernel, plain, library, bound, bound_by), the
    times the card's own."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for i, (side, h) in enumerate(SWIN_L_STAGES):
        q, k, v, bias, mask = swin_windows(torch, gen, side, 12, h, 4, torch.bfloat16)
        nw, t, c = q.shape
        q4, k4, v4 = (z.view(nw, t, h, 32).transpose(1, 2).contiguous() for z in (q, k, v))
        combined = (bias.float()[None] + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]).to(torch.bfloat16)
        run_k = lambda: wa.window_attention(q, k, v, bias, h, 32**-0.5, mask)  # noqa: E731
        run_p = lambda: wa.window_attention_plain(q, k, v, bias, h, 32**-0.5, mask)  # noqa: E731
        run_l = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=combined)  # noqa: E731
        k1, p1, l1, k2, p2, l2 = (device_ms(f) for f in (run_k, run_p, run_l, run_k, run_p, run_l))
        ek, el = (median_ms(f, 10) for f in (run_k, run_l))
        b, by = bound_ms(4.0 * nw * h * t * t * 32, 4 * 2.0 * nw * t * c + 2.0 * h * t * t + 4.0 * mask.numel())
        label = f"SWIN-L stage {i + 1} (NW={nw}, T={t}, H={h}, hd=32) bf16, {mask.shape[0]} masks"
        rows.append((label, min(k1, k2), min(p1, p2), min(l1, l2), b, by))
        print(f"window_attention masked {label} on the card: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, SDPA with the combined mask {l1:.4f} / {l2:.4f} ms, bound {b:.4f} ms ({by}); per call "
              f"with the host's launch work: kernel {ek:.4f} ms, SDPA {el:.4f} ms [{card}]", flush=True)
        del q, k, v, q4, k4, v4, combined
        torch.cuda.empty_cache()
    return rows


def parent_library(parent: str, build):
    """The kernel library of another checkout of the port at ``parent``,
    built from its vision_tpu_torch/csrc/ with this build's flags into
    build/parent_kernels/; its attention and conv entry points have this
    checkout's signatures (the BiRefNet A/B runs each checkout's forward
    in its own process)."""
    import ctypes
    from pathlib import Path

    out = build.BUILD_DIR.parent / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    sources = sorted((Path(parent) / "vision_tpu_torch" / "csrc").glob("*.cu"))
    objs = [out / f"{s.stem}.o" for s in sources]
    nvcc = build._nvcc()
    build._run_all([[nvcc, *build.NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)])
    path = out / "libparent.so"
    build._run_all([[nvcc, "-shared", "-o", str(path), *map(str, objs)]])
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vtt_flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
    lib.vtt_window_attention_fwd.argtypes = [p, p, p, p, p, i, p, i, i, i, i, i, i, ctypes.c_float, p]
    q, f = ctypes.c_longlong, ctypes.c_float
    lib.vtt_conv3x3_fwd.argtypes = [p, q, p, p, p, q, p, q, f, p, q, f, i, f, i, i, i, i, i, i, p]
    lib.vtt_flash_attention_fwd.restype = lib.vtt_window_attention_fwd.restype = lib.vtt_conv3x3_fwd.restype = i
    return lib


# run in a checkout's root with ``python -c``, so that it imports that
# checkout's package: Real-ESRGAN forward_u8 at 512x512 x 4 (random weights,
# seed 0), CUDA events around single forwards and the profiler's busy time;
# the last line is a JSON object
FORWARD_AB = """
import json, time
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.models import esrgan
from vision_tpu_torch.models.random_weights import random_esrgan_params
model = esrgan.EsrganModel(params_from_numpy(random_esrgan_params(0), "cuda", torch.float32),
                           esrgan.EsrganParams(4, 23), backend_init("gpu"))
x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 512, 512, 3), np.uint8)).to("cuda")
y = model.forward_u8(x, to_u8=False).float()
times = []
for _ in range(3):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(); model.forward_u8(x); e.record(); e.synchronize(); times.append(s.elapsed_time(e))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    model.forward_u8(x); torch.cuda.synchronize()
ks = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA]
print(json.dumps({"ms": sorted(times)[1], "busy_ms": sum(k.self_device_time_total for k in ks) / 1e3,
                  "launches": sum(k.count for k in ks), "out_rms": float(y.pow(2).mean().sqrt()),
                  "out_sum": float(y.double().sum())}))
"""


# the same for BiRefNet (SWIN-L, random_birefnet_params("large", 0)):
# forward_u8 at 1024x1024 x 4, with the peak memory the forward allocates
FORWARD_BIREF = """
import json
import numpy as np, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.models import birefnet
from vision_tpu_torch.models.random_weights import random_birefnet_params
from vision_tpu_torch.models.swin import SWIN_L_PARAMS
p = birefnet.BirefnetParams(1024, 32, (1024, 1024), SWIN_L_PARAMS)
model = birefnet.BirefnetModel(params_from_numpy(random_birefnet_params("large", 0), "cuda", torch.bfloat16), p,
                               backend_init("gpu"))
x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 1024, 1024, 3), np.uint8)).to("cuda")
y = model.forward_u8(x).float()
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
base = torch.cuda.memory_allocated()
model.forward_u8(x)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated()
times = []
for _ in range(3):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(); model.forward_u8(x); e.record(); e.synchronize(); times.append(s.elapsed_time(e))
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    model.forward_u8(x); torch.cuda.synchronize()
ks = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA]
busy = sum(k.self_device_time_total for k in ks) / 1e3
deform = sum(k.self_device_time_total for k in ks if "deform" in k.key) / 1e3
print(json.dumps({"ms": sorted(times)[1], "busy_ms": busy, "deform_ms": deform, "launches": sum(k.count for k in ks),
                  "peak_mib": peak / 2**20, "above_mib": (peak - base) / 2**20,
                  "out_mean": float(y.double().mean())}))
"""


def forward_in(checkout: str, script: str = FORWARD_AB) -> dict:
    """``script`` (FORWARD_AB or FORWARD_BIREF) run in ``checkout`` (its
    package, its kernel library)."""
    out = subprocess.run([sys.executable, "-c", script], cwd=checkout, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"forward in {checkout} failed:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare_conv_with_parent(libs: dict, torch, card: str) -> None:
    """``--parent DIR``: the conv kernel of the checkout at DIR against this
    checkout's, both through this checkout's wrapper with the path's
    epilogue and views, in turns (parent, this, this, parent) by the card's
    own time, beside F.conv2d (bare) and the bound, at phase 13's shapes;
    each held against the plain version."""
    import torch.nn.functional as F

    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import conv3x3 as cc

    gen = torch.Generator(device="cuda").manual_seed(14)
    for hw, shapes in ((1024, ESRGAN_RDB), (4096, ESRGAN_TAIL)):
        for ci, co in shapes:
            x, wt, b, kw, res = conv_path_forms(torch, gen, hw, ci, co)
            xc = x.contiguous().permute(0, 3, 1, 2)
            ref = cc.conv3x3_plain(x, wt, b, **{n: v for n, v in kw.items() if n != "out"})
            run = lambda: cc.conv3x3(x, wt, b, **kw)  # noqa: E731
            errs, times = {}, {}
            for name in ("parent", "this", "this", "parent"):
                build._lib = libs[name]
                if name not in errs:
                    errs[name] = float((run().float() - ref.float()).abs().max())
                times.setdefault(name, []).append(device_ms(run))
            build._lib = libs["this"]
            lib_ms = device_ms(lambda: F.conv2d(xc, wt, None, 1, 1))
            bound, by = conv_bound(hw * hw, ci, co, res)
            print(f"A/B conv3x3 (1, {hw}, {hw}, {ci}) -> {co} bf16 with the path's epilogue: parent "
                  f"{'/'.join(f'{t:.4f}' for t in times['parent'])}, this {'/'.join(f'{t:.4f}' for t in times['this'])}"
                  f" ms; F.conv2d {lib_ms:.4f} ms; bound {bound:.4f} ms ({by}); max abs err parent "
                  f"{errs['parent']:.3e}, this {errs['this']:.3e} [{card}]", flush=True)
            if max(errs.values()) > BF16_MAX_ABS:
                raise AssertionError(f"conv3x3 ({hw}, {ci}) -> {co}: max abs err {errs}")
            del x, xc, kw, ref
    torch.cuda.empty_cache()


def compare_with_parent(parent: str, torch, card: str) -> None:
    """``--parent DIR``: the attention kernels of the checkout at DIR against
    this checkout's, both through this checkout's wrappers on the same
    inputs, each held against the plain version, and timed in turns
    (parent, this, this, parent) beside SDPA and the bound: the card's own
    time (device_ms) and CUDA events around single calls (median_ms), at
    the main paths' shapes: flash at the Depth-Anything token counts
    (batch 4), the window kernel at TinyViT's three stages (batch 6) and
    SWIN-L's four, masked (batch 4). Then the conv kernel
    (compare_conv_with_parent), Real-ESRGAN's forward and BiRefNet's
    (forward_in each checkout, in turns: wall, busy and deform time, peak
    memory)."""
    import torch.nn.functional as F

    from vision_tpu_torch.models.swin import compute_attention_mask
    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import flash_attention as fa
    from vision_tpu_torch.ops.cuda import window_attention as wa

    libs = {"this": build.load_library(), "parent": parent_library(parent, build)}
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = []
    for t in (depth_tokens(e) for e in DEPTH_EXTENTS):
        q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        cases.append((f"flash_attention (24, {t}, 64) bf16",
                      lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
                      lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v, 0.125),
                      lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v),
                      bound_ms(4.0 * 24 * t * t * 64, 4 * 2.0 * 24 * t * 64)))
    stages = [(f"TinyViT stage {i + 1}", 6 * nw, t, h, None) for i, (nw, t, h) in enumerate(SAM_STAGES)]
    stages += [(f"SWIN-L stage {i + 1} masked", None, side, h, 12) for i, (side, h) in enumerate(SWIN_L_STAGES)]
    for label, nw, t, h, window in stages:
        if window:
            q, k, v, bias, mask = swin_windows(torch, gen, t, window, h, 4, torch.bfloat16)
            nw, t = q.shape[:2]
            combined = (bias.float()[None] + mask.repeat(nw // mask.shape[0], 1, 1)[:, None]).to(torch.bfloat16)
            mask_bytes = 4.0 * mask.numel()
        else:
            q, k, v = (torch.randn(nw, t, h * 32, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
            bias = combined = (torch.randn(h, t, t, device="cuda", generator=gen) * 0.5).to(torch.bfloat16)
            mask, mask_bytes = None, 0.0
        q4, k4, v4 = (z.view(nw, t, h, 32).transpose(1, 2).contiguous() for z in (q, k, v))
        cases.append((f"window_attention {label} (NW={nw}, T={t}, H={h}, hd=32) bf16",
                      lambda q=q, k=k, v=v, b=bias, h=h, m=mask: wa.window_attention(q, k, v, b, h, 32**-0.5, m),
                      lambda q=q, k=k, v=v, b=bias, h=h, m=mask: wa.window_attention_plain(q, k, v, b, h, 32**-0.5, m),
                      lambda q=q4, k=k4, v=v4, c=combined: F.scaled_dot_product_attention(q, k, v, attn_mask=c),
                      bound_ms(4.0 * nw * h * t * t * 32, 4 * 2.0 * nw * t * h * 32 + 2.0 * h * t * t + mask_bytes)))
    for label, run, plain, sdpa, (bound, by) in cases:
        ref = plain().float()
        errs = {}
        for name, lib in libs.items():
            build._lib = lib
            errs[name] = float((run().float() - ref).abs().max())
        times = {}
        for timer in (device_ms, median_ms):
            for name in ("parent", "this", "this", "parent"):
                build._lib = libs[name]
                times.setdefault((timer, name), []).append(timer(run, 20))
            times[(timer, "SDPA")] = [timer(sdpa, 20) for _ in range(2)]
        build._lib = libs["this"]
        line = "; ".join(
            f"{what} parent {'/'.join(f'{x:.4f}' for x in times[(timer, 'parent')])}, this "
            f"{'/'.join(f'{x:.4f}' for x in times[(timer, 'this')])}, SDPA "
            f"{'/'.join(f'{x:.4f}' for x in times[(timer, 'SDPA')])} ms"
            for timer, what in ((device_ms, "device"), (median_ms, "per call (events)")))
        print(f"A/B {label}: {line}; bound {bound:.4f} ms ({by}); max abs err parent {errs['parent']:.3e}, this "
              f"{errs['this']:.3e} [{card}]", flush=True)
        if max(errs.values()) > BF16_MAX_ABS:
            raise AssertionError(f"{label}: max abs err {errs}")
    build._lib = libs["this"]
    compare_conv_with_parent(libs, torch, card)
    # Real-ESRGAN forward_u8, each checkout in its own process, in turns
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for name, where in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        runs.setdefault(name, []).append(forward_in(where))
    print("A/B Real-ESRGAN forward_u8 (4, 512, 512) bf16: " + "; ".join(
        f"{name} " + ", ".join(f"{r['ms']:.3f} ms (busy {r['busy_ms']:.3f} ms, {r['launches']} launches)" for r in rs)
        for name, rs in runs.items()) + f"; output RMS parent {runs['parent'][0]['out_rms']:.6e}, this "
        f"{runs['this'][0]['out_rms']:.6e} [{card}]", flush=True)
    # BiRefNet forward_u8, each checkout in its own process, in turns
    runs = {}
    for name, where in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        runs.setdefault(name, []).append(forward_in(where, FORWARD_BIREF))
    print("A/B BiRefNet forward_u8 (4, 1024, 1024) bf16: " + "; ".join(
        f"{name} " + ", ".join(f"{r['ms']:.3f} ms (busy {r['busy_ms']:.3f} ms, deform {r['deform_ms']:.3f} ms, "
                               f"{r['launches']} launches, peak {r['peak_mib']:.1f} MiB, {r['above_mib']:.1f} MiB "
                               f"above the weights and input)" for r in rs)
        for name, rs in runs.items()) + f"; mask mean parent {runs['parent'][0]['out_mean']:.6e}, this "
        f"{runs['this'][0]['out_mean']:.6e} [{card}]", flush=True)
    saved = min(r["peak_mib"] for r in runs["parent"]) - max(r["peak_mib"] for r in runs["this"])
    print(f"A/B BiRefNet peak memory: this checkout allocates {saved:.1f} MiB less at peak [{card}]", flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR", help="only time the attention and conv kernels and the Real-ESRGAN "
                        "and BiRefNet forwards of the port's checkout at DIR against this checkout's "
                        "(compare_with_parent), after phases 1 and 2")
    args = parser.parse_args(argv)

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
    from vision_tpu_torch.models.birefnet import birefnet_load_model
    from vision_tpu_torch.models.esrgan import esrgan_load_model
    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import conv3x3 as cc
    from vision_tpu_torch.ops.cuda import deform_conv as dcm
    from vision_tpu_torch.ops.cuda import deform_sample as dsm
    from vision_tpu_torch.ops.cuda import flash_attention as fa
    from vision_tpu_torch.ops.cuda import window_attention as wa
    from vision_tpu_torch.serve import EsrganServer, ImageServer, SamServer

    phase("2 build")
    t0 = time.perf_counter()
    build.load_library()
    print(f"kernel library {build.library_path().name}: ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info['seconds']:.2f} s)", flush=True)
    for line in build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or "Potential" in line:
            print("ptxas:", line.strip())
    if args.parent:
        phase(f"A/B the attention and conv kernels and the Real-ESRGAN and BiRefNet forwards of {args.parent} "
              "against this checkout's")
        compare_with_parent(args.parent, torch, card)
        return 0

    phase("3 kernels against their plain versions")
    worst = kernel_cases(fa, torch)
    win_worst = window_cases(wa, torch)
    window_plan_cases(wa, build)
    build_s = build.build_info["seconds"]

    phase("4 Depth-Anything path: Depth-Anything-V2-Small through ImageServer")
    rng = np.random.default_rng(0)

    def u8_img(h, w):
        return Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)

    (w_sq, h_sq), (w_wide, h_wide) = DEPTH_EXTENTS
    requests = [u8_img(h_sq, w_sq) for _ in range(5)] + [u8_img(h_wide, w_wide) for _ in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "depth-anything-v2-small-random.gguf")
        write_small_gguf(path)
        model = depthany_load_model(path, backend_init("gpu"))
        cpu_model = depthany_load_model(path, backend_init("cpu"))
    print(f"model on {model.device.torch_device} {model.dtype}, flash={model.flash}", flush=True)
    with ImageServer(model, batch_size=4, max_delay_ms=20) as srv:
        srv.warmup()
        fa.launches = wa.launches = cc.launches = dsm.launches = dcm.launches = 0
        t_start = time.perf_counter()
        futures = [srv.submit(img) for img in requests]
        results = [f.result(timeout=600) for f in futures]
        wall_s = time.perf_counter() - t_start
        main_launches, depth_win_launches, depth_conv_launches = fa.launches, wa.launches, cc.launches
        other_deform = {"Depth-Anything": (dsm.launches, dcm.launches)}
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
    if (main_launches == 0 or main_launches != 12 * n_batches or depth_win_launches != 0
            or depth_conv_launches != 0):
        raise AssertionError(f"flash_attention launches {main_launches} for {n_batches} batches of 12 layers, "
                             f"window_attention launches {depth_win_launches}, conv3x3 launches "
                             f"{depth_conv_launches}")
    print(f"served {n_req} requests in {n_batches} batches; flash_attention launches {main_launches}, "
          f"window_attention launches {depth_win_launches}, conv3x3 launches {depth_conv_launches}", flush=True)

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
    for t in (depth_tokens(e) for e in DEPTH_EXTENTS):
        q, k, v = (torch.randn(4, 6, t, 64, device="cuda", generator=gen).to(torch.bfloat16) for _ in range(3))
        run_k = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        run_p = lambda: fa.flash_attention_plain(q, k, v, 64**-0.5)  # noqa: E731
        k1, p1, k2, p2 = (device_ms(f) for f in (run_k, run_p, run_k, run_p))
        timings.append((t, min(k1, k2), min(p1, p2)))
        print(f"flash_attention (24, {t}, 64) bf16 on the card: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms; per call with the host's launch work: kernel {median_ms(run_k, 20):.4f} ms [{card}]",
              flush=True)
    xb = torch.from_numpy(np.stack([r.to_rgb_u8() for r in requests[:4]]))
    fwd_ms = median_ms(lambda: model.forward_u8(xb), 5, warmup=2)
    print(f"forward_u8 batch 4 at 518x518 bf16: median {fwd_ms:.3f} ms [{card}]", flush=True)
    profile_forward(model, torch.from_numpy(np.stack([r.to_rgb_u8() for r in requests[:4]])), torch, card,
                    ("flash_attention",))
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
        fa.launches = wa.launches = cc.launches = dsm.launches = dcm.launches = 0
        t_start = time.perf_counter()
        futures = [ssrv.submit(img, point=pt, box=bx) for img, pt, bx in sam_reqs]
        masks = [f.result(timeout=600) for f in futures]
        sam_wall_s = time.perf_counter() - t_start
        sam_win_launches, sam_flash_launches, sam_conv_launches = wa.launches, fa.launches, cc.launches
        other_deform["MobileSAM"] = (dsm.launches, dcm.launches)
        sstats = ssrv.stats
        s_req, s_batches, s_p50 = sstats.requests, sstats.batches, sstats.p50_latency_ms
    for (img, _, _), m in zip(sam_reqs, masks):
        if m.extent != img.extent or m.format != ImageFormat.alpha_u8 or not set(np.unique(m.data)) <= {0, 255}:
            raise AssertionError(f"mask {m.extent} {m.format} for request {img.extent}")
    if s_req != 12:
        raise AssertionError(f"stats.requests {s_req}")
    if (sam_win_launches == 0 or sam_win_launches != 10 * s_batches or sam_flash_launches != 0
            or sam_conv_launches != 0):
        raise AssertionError(f"window_attention launches {sam_win_launches} for {s_batches} encoder batches "
                             f"of 10 windowed blocks, flash_attention launches {sam_flash_launches}, conv3x3 "
                             f"launches {sam_conv_launches}")
    print(f"served {s_req} requests in {s_batches} batches; window_attention launches {sam_win_launches}, "
          f"flash_attention launches {sam_flash_launches}, conv3x3 launches {sam_conv_launches}; mask foreground shares "
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
        k1, p1, k2, p2 = (device_ms(f) for f in (run_k, run_p, run_k, run_p))
        win_times.append((f"({6 * nw}, {t}, {h * 32}) bf16, H={h}", min(k1, k2), min(p1, p2)))
        print(f"window_attention stage {i + 1} (NW={6 * nw}, T={t}, H={h}, hd=32) bf16 on the card: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; per call with the host's launch work: kernel "
              f"{median_ms(run_k, 20):.4f} ms [{card}]", flush=True)
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

    del smodel, embed1

    phase("10 conv3x3 kernel against its plain version")
    conv_worst = conv_cases(cc, torch)

    phase("11 Real-ESRGAN path: RealESRGAN-x4 RRDBNet through EsrganServer and the tiled compute")
    erng = np.random.default_rng(6)
    esr_reqs = [u8_img(256, 256) for _ in range(4)] + [u8_img(240, 320) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "realesrgan-x4-random.gguf")
        write_esrgan_gguf(path)
        emodel = esrgan_load_model(path, backend_init("gpu"))
        cpu_emodel = esrgan_load_model(path, backend_init("cpu"))
    print(f"model on {emodel.device.torch_device} {emodel.dtype}, {emodel.p}", flush=True)
    with EsrganServer(emodel, batch_size=4, max_delay_ms=50) as esrv:
        esrv.warmup((256, 256))
        fa.launches = wa.launches = cc.launches = dsm.launches = dcm.launches = 0
        t_start = time.perf_counter()
        futures = [esrv.submit(img) for img in esr_reqs]
        upscaled = [f.result(timeout=600) for f in futures]
        esr_wall_s = time.perf_counter() - t_start
        esr_conv_launches, esr_flash_launches, esr_win_launches = cc.launches, fa.launches, wa.launches
        other_deform["Real-ESRGAN"] = (dsm.launches, dcm.launches)
        estats = esrv.stats
        e_req, e_batches, e_p50 = estats.requests, estats.batches, estats.p50_latency_ms
    for img, res in zip(esr_reqs, upscaled):
        want = (4 * img.extent[0], 4 * img.extent[1])
        if res.extent != want or res.format != ImageFormat.rgba_u8 or not (res.data[..., 3] == 255).all():
            raise AssertionError(f"result {res.extent} {res.format} for request {img.extent}")
    if e_req != 6 or e_batches != 2:
        raise AssertionError(f"stats: {e_req} requests in {e_batches} batches, expected 6 in 2")
    if esr_conv_launches != ESRGAN_CONVS * e_batches or esr_flash_launches != 0 or esr_win_launches != 0:
        raise AssertionError(f"conv3x3 launches {esr_conv_launches} for {e_batches} batches of {ESRGAN_CONVS} "
                             f"convs, flash_attention {esr_flash_launches}, window_attention {esr_win_launches}")
    print(f"served {e_req} requests in {e_batches} batches; conv3x3 launches {esr_conv_launches}, "
          f"flash_attention launches {esr_flash_launches}, window_attention launches {esr_win_launches}", flush=True)
    big = Image(erng.integers(0, 256, (480, 640, 4), np.uint8), ImageFormat.rgba_u8)
    cc.launches = dsm.launches = dcm.launches = 0
    t0 = time.perf_counter()
    tiled = emodel.compute(big)
    torch.cuda.synchronize()
    tiled_ms = (time.perf_counter() - t0) * 1e3
    tiled_launches = cc.launches
    other_deform["Real-ESRGAN tiled"] = (dsm.launches, dcm.launches)
    if any(any(n) for n in other_deform.values()):
        raise AssertionError(f"(deform_sample, deform_conv) launches on the other paths: {other_deform}")
    if tiled.extent != (2560, 1920) or tiled.format != ImageFormat.rgba_u8 or tiled_launches != 3 * ESRGAN_CONVS:
        raise AssertionError(f"tiled compute: {tiled.extent} {tiled.format}, {tiled_launches} conv3x3 launches "
                             f"(9 tiles of 224x176 in 3 chunks of 4: {3 * ESRGAN_CONVS})")
    print(f"tiled compute 640x480 -> {tiled.extent}: {tiled_launches} conv3x3 launches (3 chunks of 4 tiles)",
          flush=True)

    phase("12 Real-ESRGAN parity: card bf16 (kernel route) vs CPU f32 (plain route)")
    crop = torch.from_numpy(np.ascontiguousarray(esr_reqs[0].to_rgb_u8()[:64, :64])[None])
    t0 = time.perf_counter()
    cpu_stages = esrgan_stages(cpu_emodel.params, crop, cpu_emodel.p, torch.float32, "cpu")
    cpu_s = time.perf_counter() - t0
    gpu_stages = esrgan_stages(emodel.params, crop, emodel.p, emodel.dtype, "cuda")
    for (name, g), (_, c) in zip(gpu_stages, cpu_stages):
        print(f"stage {name}: relative RMS card bf16 vs CPU f32 {rel_rms(g.float().cpu(), c):.4e}", flush=True)
    g_out, c_out = gpu_stages[-1][1].float().cpu().numpy(), cpu_stages[-1][1].numpy()
    if g_out.shape != (1, 256, 256, 3) or not np.isfinite(g_out).all():
        raise AssertionError(f"output {g_out.shape}")
    esr_rms = rel_rms(g_out, c_out)
    print(f"output relative RMS card bf16 vs CPU f32 {esr_rms:.4e} (bound {E2E_REL_RMS}); CPU f32 forward at "
          f"64x64 took {cpu_s:.3f} s; output range card [{g_out.min():.4e}, {g_out.max():.4e}], CPU "
          f"[{c_out.min():.4e}, {c_out.max():.4e}], RMS {float(np.sqrt(np.mean(c_out**2))):.4e}", flush=True)
    if not esr_rms <= E2E_REL_RMS:
        raise AssertionError(f"Real-ESRGAN bf16 parity: relative RMS {esr_rms}")
    f32_params = {k: v.to("cuda") for k, v in cpu_emodel.params.items()}
    cc.launches = 0
    f32_out = esrgan_stages(f32_params, crop, cpu_emodel.p, torch.float32, "cuda")[-1][1]
    f32_launches = cc.launches
    esr_f32_rms = rel_rms(f32_out.cpu(), c_out)
    print(f"forward f32 on the card (kernel route, {f32_launches} conv3x3 launches, TF32 off) vs CPU f32: "
          f"relative RMS {esr_f32_rms:.4e} (bound {ESRGAN_F32_REL_RMS})", flush=True)
    if f32_launches != ESRGAN_CONVS or not esr_f32_rms <= ESRGAN_F32_REL_RMS:
        raise AssertionError(f"f32 forward on the card: relative RMS {esr_f32_rms}, {f32_launches} launches")
    del cpu_emodel, f32_params, cpu_stages, gpu_stages
    # the served u8 against the same image's float forward on the card: a
    # consistency check only (with these weights the u8 image is mostly 0)
    x0 = torch.from_numpy(esr_reqs[0].to_rgb_u8()[None])
    y0 = emodel.forward_u8(x0, to_u8=False).float()
    want_u8 = (torch.clamp(y0, 0.0, 1.0) * 255.0).to(torch.uint8)[0].cpu().numpy().astype(np.int16)
    served = upscaled[0].data[..., :3].astype(np.int16)
    u8_diff = int(np.abs(served - want_u8).max())
    print(f"served u8 vs clip(float forward) * 255 on the card: max difference {u8_diff} level(s); float output "
          f"range [{float(y0.min()):.4e}, {float(y0.max()):.4e}], u8 range [{served.min()}, {served.max()}], "
          f"{float((served > 0).mean()):.4%} of u8 values above 0", flush=True)
    if u8_diff > 1:
        raise AssertionError(f"served u8 differs from the float forward by {u8_diff} levels")

    phase(f"13 Real-ESRGAN timings on {card}")
    conv_rows = conv_timings(cc, torch, card)
    esr_profile = {}
    for b, hw in ((1, 1024), (4, 512)):
        xb = torch.from_numpy(erng.integers(0, 256, (b, hw, hw, 3), np.uint8)).to("cuda")
        f1 = median_ms(lambda: emodel.forward_u8(xb), 3, warmup=1)
        f2 = median_ms(lambda: emodel.forward_u8(xb), 3, warmup=0)
        f_ms = min(f1, f2)
        tflops = ESRGAN_FLOP_PER_PIXEL * b * hw * hw / (f_ms * 1e-3) / 1e12
        print(f"forward_u8 batch {b} at {hw}x{hw} bf16: median {f1:.3f} / {f2:.3f} ms, {b / f_ms * 1e3:.3f} img/s, "
              f"{tflops:.3f} TFLOP/s achieved [{card}]", flush=True)
        if b == 4:
            esr_profile = profile_forward(emodel, xb, torch, card)
        del xb
    # no elementwise pass per RRDB: what is not a conv launch is the input's
    # normalisation, the two nearest upsamplings and the u8 output
    if esr_profile["other_launches"] >= emodel.p.n_blocks:
        raise AssertionError(f"{esr_profile['other_launches']} launches other than conv3x3 in one forward of "
                             f"{emodel.p.n_blocks} RRDBs")
    print(f"EsrganServer 6 requests (4 at 256x256, 2 at 320x240; batch 4): p50 latency {e_p50:.3f} ms, "
          f"{6 / esr_wall_s:.3f} img/s, {e_batches} batches [{card}]", flush=True)
    print(f"tiled compute 640x480 (9 tiles of 224x176, 3 chunks of 4): {tiled_ms:.3f} ms [{card}]", flush=True)
    print(f"kernel build (nvcc, every source in parallel): {build_s:.2f} s [{card}]", flush=True)
    flash_libs, win_lib = attention_yardsticks(fa, wa, torch, card)
    del emodel

    phase("14 deform kernels and masked window kernel against their plain versions")
    deform_worst = deform_cases(dsm, torch)
    dconv_worst, dconv_ratio = deform_conv_cases(dcm, torch)
    win_worst = max(win_worst, masked_window_cases(wa, torch))

    phase("15 BiRefNet path: SWIN-L BiRefNet through ImageServer")
    brng = np.random.default_rng(12)
    bir_reqs = [Image(brng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8) for w, h in BIREF_EXTENTS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "birefnet-swin-l-random.gguf")
        t0 = time.perf_counter()
        write_birefnet_gguf(path)
        gguf_s = time.perf_counter() - t0
        bmodel = birefnet_load_model(path, backend_init("gpu"))
        cpu_bmodel = birefnet_load_model(path, backend_init("cpu"))
    print(f"model on {bmodel.device.torch_device} {bmodel.dtype}, extent {bmodel.p.image_extent}, deform bound "
          f"{bmodel.deform_bound}; GGUF written in {gguf_s:.1f} s", flush=True)
    with ImageServer(bmodel, batch_size=4, max_delay_ms=5_000) as bsrv:
        bsrv.warmup()
        fa.launches = wa.launches = wa.masked_launches = cc.launches = dsm.launches = dcm.launches = 0
        t_start = time.perf_counter()
        futures = [bsrv.submit(img) for img in bir_reqs]
        mattes = [f.result(timeout=600) for f in futures]
        bir_wall_s = time.perf_counter() - t_start
        bir_launches = {"window": wa.launches, "window masked": wa.masked_launches, "deform_conv": dcm.launches,
                        "deform_sample": dsm.launches, "flash": fa.launches, "conv3x3": cc.launches}
        bstats = bsrv.stats
        b_req, b_batches, b_p50 = bstats.requests, bstats.batches, bstats.p50_latency_ms
    for img, m in zip(bir_reqs, mattes):
        if m.extent != img.extent or m.format != ImageFormat.alpha_u8:
            raise AssertionError(f"matte {m.extent} {m.format} for request {img.extent}")
    want = {"window": BIREF_WINDOWS * b_batches, "window masked": BIREF_MASKED * b_batches,
            "deform_conv": BIREF_DEFORMS * b_batches, "deform_sample": 0, "flash": 0, "conv3x3": 0}
    if b_req != 8 or b_batches != 2 or bir_launches != want:
        raise AssertionError(f"{b_req} requests in {b_batches} batches (8 in 2 expected); launches {bir_launches}, "
                             f"expected {want}")
    print(f"served {b_req} requests in {b_batches} batches; launches {bir_launches}; matte means "
          f"{[round(float(m.data.mean()), 2) for m in mattes]}", flush=True)

    phase(f"16 BiRefNet parity at {BIREF_PARITY_HW}x{BIREF_PARITY_HW}: card bf16 (kernel routes) vs CPU f32 "
          "(plain routes)")
    # birefnet_predict takes any extent that is a multiple of 32
    xs = torch.from_numpy(brng.integers(0, 256, (1, BIREF_PARITY_HW, BIREF_PARITY_HW, 3), np.uint8))
    t0 = time.perf_counter()
    cpu_stages = birefnet_stages(cpu_bmodel, xs)
    cpu_s = time.perf_counter() - t0
    gpu_stages = birefnet_stages(bmodel, xs)
    for (name, g), (_, c) in zip(gpu_stages, cpu_stages):
        print(f"stage {name} {tuple(g.shape)}: relative RMS card bf16 vs CPU f32 {rel_rms(g.float().cpu(), c):.4e}",
              flush=True)
    g_mask, c_mask = gpu_stages[-1][1].float().cpu().numpy(), cpu_stages[-1][1].numpy()
    if g_mask.shape != (1, BIREF_PARITY_HW, BIREF_PARITY_HW, 1) or not np.isfinite(g_mask).all():
        raise AssertionError(f"mask {g_mask.shape}")
    bir_rms = rel_rms(g_mask, c_mask)
    print(f"mask relative RMS card bf16 vs CPU f32 {bir_rms:.4e} (bound {E2E_REL_RMS}); CPU f32 forward took "
          f"{cpu_s:.3f} s; mask range card [{g_mask.min():.4e}, {g_mask.max():.4e}], CPU mean {c_mask.mean():.4e}",
          flush=True)
    if not bir_rms <= E2E_REL_RMS:
        raise AssertionError(f"BiRefNet bf16 parity: relative RMS {bir_rms}")
    f32_params = {k: v.to("cuda") for k, v in cpu_bmodel.params.items()}
    wa.launches = dcm.launches = dsm.launches = 0
    f32_mask = birefnet_stages(bmodel, xs, f32_params, torch.float32)[-1][1]
    f32_launches = (wa.launches, dcm.launches, dsm.launches)
    bir_f32_rms = rel_rms(f32_mask.cpu(), c_mask)
    print(f"forward f32 on the card (kernel routes, {f32_launches[0]} window, {f32_launches[1]} deform_conv and "
          f"{f32_launches[2]} deform_sample launches, "
          f"TF32 off) vs CPU f32: relative RMS {bir_f32_rms:.4e} (bound {BIREF_F32_REL_RMS})", flush=True)
    if f32_launches != (BIREF_WINDOWS, BIREF_DEFORMS, 0) or not bir_f32_rms <= BIREF_F32_REL_RMS:
        raise AssertionError(f"f32 forward on the card: relative RMS {bir_f32_rms}, launches {f32_launches}")
    del cpu_bmodel, f32_params, cpu_stages, gpu_stages
    # the served u8 against the card's float mask of the same one-image
    # forward: a server of batch 1 runs exactly that forward
    x0 = torch.from_numpy(bir_reqs[0].to_rgb_u8()[None])
    with ImageServer(bmodel, batch_size=1) as one:
        served = one.compute(bir_reqs[0]).data.astype(np.int16)
    y0 = bmodel.forward_u8(x0).float()[0].cpu().numpy()
    want_u8 = (np.clip(y0, 0.0, 1.0) * 255.0).astype(np.int16)
    u8_diff = int(np.abs(served - want_u8).max())
    print(f"served u8 matte vs clip(float mask) * 255 on the card: max difference {u8_diff} level(s); float range "
          f"[{y0.min():.4e}, {y0.max():.4e}]", flush=True)
    if u8_diff > 1:
        raise AssertionError(f"served u8 differs from the float mask by {u8_diff} levels")

    phase(f"17 BiRefNet timings on {card}")
    d_rows = deform_timings(dsm, dcm, torch, card)
    fwd_shapes = [(hw, k) for hw in BIREF_BLOCK_HW for k in BIREF_DEFORM_KS]  # a forward's 20 convs
    d_sum = {key: sum(d_rows[sh][key] for sh in fwd_shapes) for key in d_rows[fwd_shapes[0]]
             if not key.endswith("bound_by")}
    for key in ("bound_by", "sampler_bound_by"):  # what bounds most of the 20's summed bound
        d_sum[key] = max(("bytes", "operations"), key=lambda by, key=key: sum(
            d_rows[sh][key[:-3]] for sh in fwd_shapes if d_rows[sh][key] == by))
    print(f"deform over one batch-4 1024x1024 forward's {len(fwd_shapes)} convs, by the card's own time: fused "
          f"deform_conv {d_sum['fused']:.4f} ms (bare {d_sum['bare']:.4f}; the weights' layouts, made once "
          f"by the model: {d_sum['layout']:.4f} ms, {d_sum['layout_call']:.4f} ms with the host's work), bound "
          f"{d_sum['bound']:.4f} ms "
          f"({d_sum['bound_by']}), plain {d_sum['plain']:.4f} ms, yardstick F.grid_sample + mask product + matmul "
          f"{d_sum['library']:.4f} ms, parent's route sampler + matmul {d_sum['route']:.4f} ms (sampler "
          f"{d_sum['sampler']:.4f} ms, bound {d_sum['sampler_bound']:.4f} ms ({d_sum['sampler_bound_by']}), plain "
          f"{d_sum['sampler_plain']:.4f} ms) [{card}]", flush=True)
    mw_rows = masked_window_yardsticks(wa, torch, card)
    for b in (1, 4):
        xb = torch.from_numpy(brng.integers(0, 256, (b, 1024, 1024, 3), np.uint8)).to("cuda")
        f1 = median_ms(lambda: bmodel.forward_u8(xb), 3, warmup=1)
        f2 = median_ms(lambda: bmodel.forward_u8(xb), 3, warmup=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        bmodel.forward_u8(xb)
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        print(f"BiRefNet forward_u8 batch {b} at 1024x1024 bf16: median {f1:.3f} / {f2:.3f} ms, "
              f"{b / min(f1, f2) * 1e3:.3f} img/s; peak allocated {peak_mb:.1f} MiB ({peak_mb - base_mb:.1f} MiB "
              f"above the {base_mb:.1f} MiB held before) [{card}]", flush=True)
        if b == 4:
            bir_profile = profile_forward(bmodel, xb, torch, card, ("window_attention", "deform_conv"))
            bir_profile["peak_mib"] = peak_mb
        del xb
    print(f"ImageServer 8 BiRefNet requests (4 at 1024x1024, 2 at 1280x720, 2 at 800x600; batch 4): p50 latency "
          f"{b_p50:.3f} ms, {8 / bir_wall_s:.3f} img/s, {b_batches} batches [{card}]", flush=True)
    from vision_tpu_torch.image import image_scale, preprocess_scale_method
    from vision_tpu_torch.models.birefnet import birefnet_process_output

    fake_mask = brng.random((1024, 1024, 1), dtype=np.float32)
    for img in (bir_reqs[0], bir_reqs[4], bir_reqs[6]):  # one request of each extent
        t0 = time.perf_counter()
        if img.extent != (1024, 1024):
            image_scale(img, (1024, 1024), preprocess_scale_method()).to_rgb_u8()
        else:
            img.to_rgb_u8()
        t1 = time.perf_counter()
        birefnet_process_output(fake_mask, img.extent)
        t2 = time.perf_counter()
        print(f"host per BiRefNet request at {img.extent[0]}x{img.extent[1]}: prep (resize to 1024x1024, rgb u8) "
              f"{(t1 - t0) * 1e3:.3f} ms, post (birefnet_process_output) {(t2 - t1) * 1e3:.3f} ms [{card}]",
              flush=True)
    del bmodel

    # one RDB's five convs at 1024x1024 as the path runs them, summed
    rdb = conv_rows[: len(ESRGAN_RDB)]
    rdb_bounds = [conv_bound(px, ci, co, res) for _, px, ci, co, *_, res in rdb]
    rdb_bound = sum(ms for ms, _ in rdb_bounds)
    rdb_by = max(("bytes", "operations"), key=[by for _, by in rdb_bounds].count)  # what bounds most of the five
    (t_sq, k_ms, p_ms), (t_wide, k_wide, p_wide) = timings
    w_shape, w_ms, w_plain_ms = win_times[0]
    nw, t, h = SAM_STAGES[0]
    flash_bound, flash_by = bound_ms(4.0 * 24 * t_sq**2 * 64, 4 * 2.0 * 24 * t_sq * 64)
    wide_bound, wide_by = bound_ms(4.0 * 24 * t_wide**2 * 64, 4 * 2.0 * 24 * t_wide * 64)
    win_bound, win_by = bound_ms(4.0 * 6 * nw * h * t * t * 32, 4 * 2.0 * 6 * nw * t * h * 32 + 2.0 * h * t * t)
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
            "bound_ms": flash_bound,
            "bound_by": flash_by,
            "library_ms": flash_libs[t_sq],
            "timed_shape": f"(24, {t_sq}, 64) bf16",
            "timing": DEVICE_TIMING,
            f"at_{t_wide}_tokens": {"ms": k_wide, "plain_ms": p_wide, "bound_ms": wide_bound, "bound_by": wide_by,
                                    "library_ms": flash_libs[t_wide]},
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
            "bound_ms": win_bound,
            "bound_by": win_by,
            "library_ms": win_lib,
            "timed_shape": w_shape,
            "timing": DEVICE_TIMING,
            "launches_birefnet": bir_launches["window"],
            "launches_birefnet_masked": bir_launches["window masked"],
            "birefnet_masked_stage1": dict(zip(("label", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                                               mw_rows[0])),
        },
        {
            "name": "conv3x3",
            "route": "cuda",
            "source": "vision_tpu_torch/csrc/conv3x3.cu",
            "replaces": "scripts/exp_pallas_conv.py:36",
            "launches": esr_conv_launches,
            "max_abs_err": conv_worst,
            "ms": sum(r[4] for r in rdb),
            "plain_ms": sum(r[6] for r in rdb),
            "bound_ms": rdb_bound,
            "bound_by": rdb_by,
            "library_ms": sum(r[7] for r in rdb),
            "timed_shape": "one RDB's five convs at (1, 1024, 1024) bf16 with the path's epilogue and views, "
                           "summed: " + ", ".join(f"{ci}->{co}" for ci, co in ESRGAN_RDB),
            "timing": DEVICE_TIMING,
            "bare_ms": sum(r[5] for r in rdb),
            "shapes": [dict(zip(("shape", "ms", "bare_ms", "plain_ms", "library_ms", "per_call_ms"),
                                (r[0], r[4], r[5], r[6], r[7], r[8]))) for r in conv_rows],
            "forward_512x4_busy_ms": esr_profile["busy_ms"],
            "forward_512x4_other_launches": esr_profile["other_launches"],
        },
        {
            "name": "deform_conv",
            "route": "cuda",
            "source": "vision_tpu_torch/csrc/deform_conv.cu",
            "replaces": "scripts/exp_deform_pallas.py:56",
            "launches": bir_launches["deform_conv"],
            "max_abs_err": dconv_worst,
            "ms": d_sum["fused"],
            "plain_ms": d_sum["plain"],
            "bound_ms": d_sum["bound"],
            "bound_by": d_sum["bound_by"],
            "library_ms": d_sum["library"],
            "timed_shape": f"one batch-4 1024x1024 BiRefNet forward's 20 deformable convs with the path's epilogue "
                           f"into 28-channel views, summed: Cin {BIREF_CIN} -> {BIREF_COUT} bf16, k 1, 1, 3, 7 at "
                           f"256^2, 128^2, 64^2 and twice at 32^2",
            "timing": DEVICE_TIMING,
            "library_call": "F.grid_sample over all taps + the mask product + torch.matmul, each timed alone, summed",
            "parent_route_ms": d_sum["route"],
            "weight_layout_ms": d_sum["layout"],
            "bf16_rounding_ratio_k7_256": dconv_ratio,
            "forward_1024x4_busy_ms": bir_profile["busy_ms"],
            "forward_1024x4_peak_mib": bir_profile["peak_mib"],
            "alloc_mib_k7_256": {"fused": d_rows[(256, 7)]["fused_alloc_mib"],
                                 "parent_route": d_rows[(256, 7)]["route_alloc_mib"]},
        },
        {
            "name": "deform_sample",
            "route": "cuda",
            "source": "vision_tpu_torch/csrc/deform_sample.cu",
            "replaces": "scripts/exp_deform_pallas.py:56",
            "launches": bir_launches["deform_sample"],
            "max_abs_err": deform_worst,
            "ms": d_sum["sampler"],
            "plain_ms": d_sum["sampler_plain"],
            "bound_ms": d_sum["sampler_bound"],
            "bound_by": d_sum["sampler_bound_by"],
            "library_ms": d_sum["grid_sample"],
            "timed_shape": f"the columns of one batch-4 1024x1024 BiRefNet forward's 20 deformable convs, summed: "
                           f"Cin {BIREF_CIN} bf16; the standalone column kernel, off every served path",
            "timing": DEVICE_TIMING,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
