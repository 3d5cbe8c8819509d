#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. environment: a CUDA device is required (no CPU continuation); prints the
     card's name and power limit, the torch and CUDA versions, and turns TF32
     off for the f32 comparisons;
  2. build: compiles the hand-written kernel library from the sources in
     vision_tpu_torch/csrc/ and prints the build seconds and ptxas's report;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and at edge shapes;
  4. the main path: a Depth-Anything-V2-Small GGUF with random weights
     (seed 0) is written, loaded with depthany_load_model and served through
     ImageServer (batch 4): 8 requests in two extent buckets; the kernels'
     launch counts are zeroed just before and read just after;
  5. end-to-end parity: one request's raw depth on the card (bf16, kernel
     route) against the same port's f32 forward on the CPU (plain route);
  6. timings with CUDA events, each beside the card name and power limit.

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
    from vision_tpu_torch.ops.cuda import build
    from vision_tpu_torch.ops.cuda import flash_attention as fa
    from vision_tpu_torch.serve import ImageServer

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

    phase("4 main path: Depth-Anything-V2-Small through ImageServer")
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
        fa.launches = 0
        t_start = time.perf_counter()
        futures = [srv.submit(img) for img in requests]
        results = [f.result(timeout=600) for f in futures]
        wall_s = time.perf_counter() - t_start
        main_launches = fa.launches
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
    if main_launches == 0 or main_launches != 12 * n_batches:
        raise AssertionError(f"flash_attention launches {main_launches} for {n_batches} batches of 12 layers")
    print(f"served {n_req} requests in {n_batches} batches; flash_attention launches {main_launches}", flush=True)

    phase("5 end-to-end parity: card bf16 (kernel route) vs CPU f32 (plain route)")
    x = torch.from_numpy(requests[0].to_rgb_u8()[None])
    gpu_depth = model.forward_u8(x).float().cpu().numpy()
    cpu_depth = cpu_model.forward_u8(x).float().numpy()
    if gpu_depth.shape != (1, 518, 518, 1) or not np.isfinite(gpu_depth).all():
        raise AssertionError(f"forward_u8 gave {gpu_depth.shape}")
    rel_rms = float(np.sqrt(np.mean((gpu_depth - cpu_depth) ** 2)) / (np.sqrt(np.mean(cpu_depth**2)) + 1e-12))
    print(f"depth relative RMS card vs CPU: {rel_rms:.4e} (bound {E2E_REL_RMS})", flush=True)
    if not rel_rms <= E2E_REL_RMS:
        raise AssertionError(f"end-to-end relative RMS {rel_rms}")

    phase(f"6 timings on {card}")
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

    _, k_ms, p_ms = timings[0]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "vision_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vision_tpu/ops/pallas/flash_attention.py:26",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": k_ms,
        "plain_ms": p_ms,
        "timed_shape": "(24, 1370, 64) bf16",
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
