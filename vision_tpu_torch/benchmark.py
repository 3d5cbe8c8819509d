"""vision-bench — the per-model benchmark harness, the port of
vision_tpu/benchmark.py.

Re-provision of the reference benchmark harness (tests/benchmark.cpp:
warm-up + timed loop, mean±stdev, markdown table output). Each row runs one
family's full-width forward on random weights made from seed 0 (no
checkpoints are needed; throughput does not depend on the weights), as one
step that returns the f32 sum of the forward's outputs, the same step the
JAX package times.

Methodology on the card: one eager call of the step (it builds the kernel
library, fills the ``device_cache`` constants and lets cuBLAS and cuDNN
choose), one capture of the step into a CUDA graph (``core/graph.py``
``capture_forward``; a step that does not capture raises, there is no eager
fallback), one replay whose output must equal the eager call's bit for bit,
then ``repeats`` times: a CUDA event, K replays, a CUDA event. A row's time
is the events' elapsed time over K, its mean and stdev over the repeats: the
card's time per forward, with no host launch work between replays. On the
CPU (``device="cpu"``) the step runs eagerly, timed by ``time.perf_counter``.

Each row's GFLOP is ``utils.flops.count_flops`` of the exact step being
timed (on fake tensors, before timing); TF/s and MFU follow from it against
the card's dense bf16 peak (``PEAK_TF_PER_SEC``, NVIDIA's data sheets).

Usage: python -m vision_tpu_torch.benchmark [model ...] [--k N] [--repeats N] [--json] [--backend cpu|gpu]
"""

from __future__ import annotations

import argparse
import gc
import statistics
import sys
import time

import numpy as np
import torch

from .core.device import Device, backend_init
from .core.errors import raise_error

__all__ = ["BENCHMARKS", "PEAK_TF_PER_SEC", "main", "print_rows", "run_benchmark", "workload_mfu"]


def _u8(shape, dev: Device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)).to(dev.torch_device)


def _device_params(raw: dict, dev: Device, dtype: torch.dtype, keep_f32=()) -> dict:
    """``raw`` (numpy, torch-canonical) on the device: every f32 array cast
    to ``dtype`` except those whose name holds one of ``keep_f32``, other
    types kept, as the JAX rows place their weights."""
    out = {}
    for k, v in raw.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if v.dtype == np.float32 and not any(s in k for s in keep_f32):
            out[k] = t.to(dev.torch_device, dtype)
        else:
            out[k] = t.to(dev.torch_device)
    return out


def _leaves(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


def _row(build):
    """A BENCHMARKS entry from ``build(dev, dtype) -> (forward, params, x)``:
    ``(dev, dtype) -> (step, params, x)``, where ``step(params, x)`` is the
    sum of every output of ``forward(params, x)`` in f32, a scalar on the
    device, and ``step.forward`` is the forward itself."""

    def bench(dev: Device, dtype: torch.dtype):
        forward, params, x = build(dev, dtype)

        def step(w, xx):
            return sum(t.float().sum() for t in _leaves(forward(w, xx)))

        step.forward = forward
        return step, params, x

    return bench


def _sam_encode(dev, dtype):
    from .core.params import Params
    from .models.mobile_sam import sam_encode_image
    from .models.random_weights import random_mobile_sam_params
    from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

    def forward(w, x):
        return sam_encode_image(Params(w), normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, dtype), flash=True)

    return forward, _device_params(random_mobile_sam_params(0), dev, dtype), _u8((1, 1024, 1024, 3), dev)


def _sam_decode(dev, dtype):
    from .core.params import Params
    from .models.mobile_sam import sam_encode_points, sam_predict_mask
    from .models.random_weights import random_mobile_sam_params

    def forward(w, c):
        pp = Params(w)
        embed = torch.zeros((1, 64, 64, 256), dtype=dtype, device=c.device)
        return sam_predict_mask(pp, embed, sam_encode_points(pp, c))

    coords = torch.from_numpy(np.array([[0.1, 0.2], [0.0, 0.0]], np.float32)).to(dev.torch_device)
    return forward, _device_params(random_mobile_sam_params(0), dev, dtype), coords


def _esrgan(res: int):
    def build(dev, dtype):
        from .core.params import Params
        from .models.esrgan import EsrganParams, esrgan_generate
        from .models.random_weights import random_esrgan_params
        from .ops.preprocess import normalize_u8

        # the plain RRDB form: the JAX row's packed block-domain form is a TPU
        # layout (esrgan_pack_weights), which the port does not take
        p = EsrganParams(4, 23)

        def forward(w, x):
            return esrgan_generate(Params(w), normalize_u8(x, dtype=dtype), p)

        return forward, _device_params(random_esrgan_params(0), dev, dtype), _u8((1, res, res, 3), dev)

    return build


def _depthany(variant: str):
    def build(dev, dtype):
        from .core.params import Params
        from .models.depth_anything import DepthAnythingParams, depthany_predict
        from .models.dino import DinoParams
        from .models.random_weights import random_depth_anything_params
        from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

        dim, heads = (384, 6) if variant == "small" else (768, 12)
        p = DepthAnythingParams(dino=DinoParams(14, dim, heads, 12), feature_layers=(2, 5, 8, 11))

        def forward(w, x):
            return depthany_predict(Params(w), normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, dtype), p, flash=True)

        params = _device_params(random_depth_anything_params(variant), dev, dtype,
                                keep_f32=("position_embeddings", "cls_token"))
        return forward, params, _u8((1, 518, 714, 3), dev)

    return build


def _migan(dev, dtype):
    from .core.params import Params
    from .models.migan import MiganParams, migan_generate
    from .models.random_weights import random_migan_params

    p = MiganParams(resolution=512)

    def forward(w, x):
        return migan_generate(Params(w), x.to(dtype), p)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 512, 512, 4))).to(dev.torch_device, dtype)
    return forward, _device_params(random_migan_params(512), dev, dtype), x


def _yolov9t(dev, dtype):
    from .core.params import Params
    from .models.random_weights import random_yolov9t_params
    from .models.yolov9t import Yolov9tParams, yolov9t_forward
    from .ops.preprocess import normalize_u8

    p = Yolov9tParams()

    def forward(w, x):
        return yolov9t_forward(Params(w), normalize_u8(x, dtype=dtype), p)

    return forward, _device_params(random_yolov9t_params(), dev, dtype), _u8((1, 640, 640, 3), dev)


def _birefnet(variant: str):
    def build(dev, dtype):
        from .core.params import Params
        from .models.birefnet import BirefnetParams, birefnet_predict, deform_layouts
        from .models.random_weights import random_birefnet_params
        from .models.swin import SWIN_L_PARAMS, SWIN_T_PARAMS
        from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

        enc = SWIN_T_PARAMS if variant == "tiny" else SWIN_L_PARAMS
        p = BirefnetParams(image_size=1024, image_extent=(1024, 1024), encoder=enc)

        def forward(w, x):
            # the exact deformable convs (deform_bound None): the JAX row bounds
            # the offsets on the TPU only
            return birefnet_predict(Params(w), normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, dtype), p)

        params = _device_params(random_birefnet_params(variant), dev, dtype)
        # the deformable convs' weights laid out for the fused kernel once, as BirefnetModel does
        params.update(deform_layouts(params, dtype))
        return forward, params, _u8((1, 1024, 1024, 3), dev)

    return build


def _sam3_vision(dev, dtype):
    from .core.params import Params
    from .models.random_weights import random_sam3_vision_params
    from .models.sam3 import Sam3VitParams, encode_vision, sam3_pack_vision_weights

    p = Sam3VitParams()
    params = _device_params(random_sam3_vision_params(), dev, dtype, keep_f32=("position_embeddings",))
    # the production trunk: the window-major trunk over the stacked window weights
    stack = sam3_pack_vision_weights(params, p)

    def forward(w, x):
        # the [-1, 1] input mapping of sam3_process_input
        img = x.to(dtype) / 127.5 - 1.0
        return encode_vision(Params(w["p"]), img, p, flash=True, win_stack=w["s"]).fpn_hidden_states

    return forward, {"p": params, "s": stack}, _u8((1, 1008, 1008, 3), dev)


BENCHMARKS = {
    "sam-encode-1024": _row(_sam_encode),
    "sam-decode": _row(_sam_decode),
    "esrgan-512": _row(_esrgan(512)),
    "esrgan-1024": _row(_esrgan(1024)),
    "depthany-small": _row(_depthany("small")),
    "depthany-base": _row(_depthany("base")),
    "migan-512": _row(_migan),
    "yolov9t-640": _row(_yolov9t),
    "birefnet-1024": _row(_birefnet("tiny")),
    "birefnet-full-1024": _row(_birefnet("large")),
    "sam3-vision-1008": _row(_sam3_vision),
}

# dense bf16 tensor-core peak by torch.cuda.get_device_name (NVIDIA's data
# sheets, at each part's full power limit); MFU is reported only for these
PEAK_TF_PER_SEC = {
    "NVIDIA H100 80GB HBM3": 989.0,  # SXM
    "NVIDIA H100 PCIe": 756.0,
    "NVIDIA H100 NVL": 835.0,
}


def workload_mfu(gflop: float | None, mean_ms: float, device_name: str):
    """(tf_per_sec, mfu) for a finished row; Nones where unknown.

    TF/s falls out as GFLOP/ms; MFU is against the card's dense bf16 peak
    (``PEAK_TF_PER_SEC``). ``gflop`` comes from ``utils.flops.count_flops``
    over the exact step being timed: the matrix-product and convolution
    arithmetic the step runs (each hand-written kernel by its formula).
    """
    if not gflop or mean_ms <= 0:
        return None, None
    tf = gflop / mean_ms
    peak = PEAK_TF_PER_SEC.get(device_name)
    return tf, (tf / peak if peak else None)


def _kernel_launches(tally: dict) -> dict:
    """A capture's tally {(wrapper module, counter): n} as {kernel: n}, the
    window kernel's masked launches under ``"window_attention masked"``."""
    out = {}
    for (module, counter), n in tally.items():
        kernel = module.rsplit(".", 1)[-1]
        out[kernel if counter == "launches" else f"{kernel} masked"] = n
    return out


def _replay_ms(graph, k: int, repeats: int) -> tuple[float, float]:
    """Mean and stdev over ``repeats`` of the CUDA events' elapsed time
    around ``k`` back-to-back replays, over k."""
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(k):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.mean(times), (statistics.stdev(times) if len(times) > 1 else 0.0)


def _eager_ms(fn, x, k: int, repeats: int) -> tuple[float, float]:
    """The same over eager calls, timed on the host (the CPU)."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(k):
            fn(x)
        times.append((time.perf_counter() - t0) * 1e3 / k)
    return statistics.mean(times), (statistics.stdev(times) if len(times) > 1 else 0.0)


def _time_row(step, params, x, dev: Device, k: int, repeats: int) -> dict:
    """Time one row (see the module's docstring): mean_ms, stdev_ms, k, the
    step's value, and on the card the capture's kernel launches."""
    from .core.graph import capture_forward

    def fn(xx):
        return step(params, xx)

    with torch.inference_mode():
        value = fn(x)
        row = {"value": float(value)}
        if dev.torch_device.type == "cuda":
            replay = capture_forward(fn, (x,), dev.torch_device, torch.cuda.graph_pool_handle(),
                                     torch.cuda.Stream(dev.torch_device))
            replay.graph.replay()
            torch.cuda.synchronize(dev.torch_device)
            if not torch.equal(replay.static_out, value):
                raise_error("vision-bench: a replay gave {} where the eager step gave {}", float(replay.static_out),
                            row["value"])
            row["launches"] = _kernel_launches(replay.tally)

            def timed(kk):
                return _replay_ms(replay.graph, kk, repeats)
        else:
            def timed(kk):
                return _eager_ms(fn, x, kk, repeats)

        mean, stdev = timed(k)
        if mean < 1.0 and k < 256:
            # sub-ms workloads drown in timing noise at small K
            k = 256
            mean, stdev = timed(k)
    return {"mean_ms": mean, "stdev_ms": stdev, "k": k, **row}


def run_benchmark(names=None, k: int = 8, repeats: int = 3, device=None) -> list[dict]:
    """Build, count and time each row of ``names`` (default: all of
    BENCHMARKS, in order) on ``device`` (``backend_init``'s: the card unless
    "cpu" is named; without a card it raises). Returns one dict a row:
    name, mean_ms, stdev_ms, k, gflop, tf_per_sec, mfu, the step's value
    and, on the card, the capture's hand-written kernel launches
    (``launches``). Progress goes to stderr."""
    from .utils.flops import count_flops

    dev = backend_init(device)
    dtype = dev.preferred_float_type
    names = list(names or BENCHMARKS)
    unknown = [n for n in names if n not in BENCHMARKS]
    if unknown:
        raise_error("vision-bench: unknown benchmark(s) {} (expected some of {})", unknown, list(BENCHMARKS))
    kind = torch.cuda.get_device_name(dev.torch_device) if dev.torch_device.type == "cuda" else "cpu"
    rows = []
    for name in names:
        t0 = time.perf_counter()
        step, params, x = BENCHMARKS[name](dev, dtype)
        # trace-only FLOP count of the exact step being timed (fake tensors)
        gflop = count_flops(step, params, x) / 1e9
        timed = _time_row(step, params, x, dev, k, repeats)
        tf, mfu = workload_mfu(gflop, timed["mean_ms"], kind)
        rows.append({"name": name, "mean_ms": timed.pop("mean_ms"), "stdev_ms": timed.pop("stdev_ms"),
                     "k": timed.pop("k"), "gflop": gflop, "tf_per_sec": tf, "mfu": mfu, **timed})
        del step, params, x
        gc.collect()
        if dev.torch_device.type == "cuda":
            torch.cuda.empty_cache()  # a row's weights and graph pool go before the next row's
        eff = f", {tf:.1f} TF/s" if tf else ""
        print(f"# {name}: {rows[-1]['mean_ms']:.3f} ms/iter (k={rows[-1]['k']}{eff}) "
              f"[{time.perf_counter() - t0:.0f}s in all, set-up included]", file=sys.stderr, flush=True)
    return rows


def print_rows(rows: list[dict], json_lines: bool = False, on_card: bool = True) -> None:
    """The rows as the JAX package's vision-bench prints them: a markdown
    table under a line that says how the times were taken (``on_card``: per
    CUDA-graph replay, else eager calls on the CPU), or with ``json_lines``
    one JSON object a row (bench.py's format)."""
    if json_lines:
        import json

        for r in rows:
            rec = {"metric": r["name"], "value": round(r["mean_ms"], 3), "unit": "ms/iter",
                   "stdev": round(r["stdev_ms"], 3), "k": r["k"]}
            if r["tf_per_sec"] is not None:
                rec["gflop"] = round(r["gflop"], 1)
                rec["tf_per_sec"] = round(r["tf_per_sec"], 2)
            if r["mfu"] is not None:
                rec["mfu"] = round(r["mfu"], 4)
            print(json.dumps(rec))
        return
    if on_card:
        print("device ms/iter, per CUDA-graph replay, timed by CUDA events")
    else:
        print("host ms/iter, eager calls on the CPU timed by time.perf_counter")
    print(f"| {'benchmark':<20} | {'mean':>10} | {'stdev':>8} | {'K':>3} | {'TF/s':>7} | {'MFU':>5} |")
    print(f"|{'-' * 22}|{'-' * 12}|{'-' * 10}|{'-' * 5}|{'-' * 9}|{'-' * 7}|")
    for r in rows:
        tf = f"{r['tf_per_sec']:7.1f}" if r["tf_per_sec"] else f"{'—':>7}"
        mfu = f"{r['mfu'] * 100:4.1f}%" if r["mfu"] else f"{'—':>5}"
        print(f"| {r['name']:<20} | {r['mean_ms']:8.1f}ms | {r['stdev_ms']:6.1f}ms | {r['k']:>3} | {tf} | {mfu} |")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vision-bench")
    p.add_argument("models", nargs="*", choices=list(BENCHMARKS.keys()) + [[]], default=[])
    p.add_argument("--k", type=int, default=8, help="graph replays (eager calls on the CPU) a timed repeat")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--json", action="store_true", help="one JSON line per row (machine-readable; bench.py's format)")
    p.add_argument("--backend", default=None, choices=["cpu", "gpu"],
                   help="device (default: the GPU; there is no fallback to the CPU)")
    args = p.parse_args(argv)
    rows = run_benchmark(args.models or None, k=args.k, repeats=args.repeats, device=args.backend)
    print_rows(rows, args.json, on_card=args.backend != "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
