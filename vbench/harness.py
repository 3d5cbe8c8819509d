"""The benchmark of ``vision_tpu_torch`` on the card: one run of one cell.

Everything that belongs to a cell is found by name from ``BENCHMARK.json``:

- the configuration's sizes ``vbench/configs/<config>.json`` (the entry's
  ``file``), its builder ``vbench/configs/<config>.py`` (weights, server,
  requests) and its plain reference ``vbench/reference/<config>.py``;
- the traffic mix ``vbench/traffic/<traffic>.json``, read by
  ``vbench/loadgen.py``;
- each metric's reader, ``vbench/end_to_end/<metric>.py`` and
  ``vbench/layer_metrics/<metric>.py``.

A run: weights drawn on the card from ``--seed``, the program's model and
server built from them, a pool of request images made on the card, every
graph key of the mix captured, the lead-in, then ``--seconds`` of measured
traffic. After the window closes every answer due in it is awaited, the
peak memory is read, the program's state is freed, and the answers kept
for the check are compared with the plain reference's, computed from the
same seed in float32 with TF32 off. ``--trace 1`` records the device trace
and the host spans over the lead-in and the window and prints the
per-layer metrics instead of the end-to-end ones.

The last line of standard output is the result, a JSON object; each number
compared for ``correct`` is printed beside its limit on the last lines of
standard error and under ``checks``, the result's last key.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import loadgen, trace as tracing
from .weights import derive_seed, draw, image_pool

__all__ = ["Cell", "find_cell", "load_benchmark", "main", "run", "forbidden_modules"]

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "vision_tpu")
PEAKS = {  # NVIDIA's data sheets, dense, at the full power limit
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12, "bytes": 3.35e12},
}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"vbench: no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of BENCHMARK.json with the files found by its names."""

    name: str
    entry: dict
    config: dict  # the configuration's entry
    config_file: Path
    builder: Path
    reference: Path
    traffic: Path
    end_to_end: dict  # {name: (entry, reader path)} of the metrics this cell reports
    per_layer: dict

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _reports(metric: dict, cell: str, reported_e2e=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported_e2e is None or metric["moves"] in reported_e2e


def find_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"vbench: no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    bench = root / "vbench"
    e2e = {m["name"]: (m, bench / "end_to_end" / f"{m['name']}.py")
           for m in spec["end_to_end"] if _reports(m, name)}
    layer = {m["name"]: (m, bench / "layer_metrics" / f"{m['name']}.py")
             for m in spec["per_layer"] if _reports(m, name, e2e)}
    cell = Cell(name, entry, config, root / config["file"], bench / "configs" / f"{config['name']}.py",
                bench / "reference" / f"{config['name']}.py", bench / "traffic" / f"{entry['traffic']}.json",
                e2e, layer)
    missing = [str(p) for p in (cell.config_file, cell.builder, cell.reference, cell.traffic,
                                *(p for _, p in e2e.values()), *(p for _, p in layer.values())) if not p.is_file()]
    if missing:
        raise FileNotFoundError(f"vbench: cell {name} lacks {missing}")
    return cell


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class Context:
    """What a metric reader reads."""

    cell: Cell
    cfg: dict
    traffic: loadgen.Traffic
    seconds: float
    setup_s: float
    record: loadgen.Record
    stats_open: dict = field(default_factory=dict)
    stats_close: dict = field(default_factory=dict)
    batch_size: int = 0
    device_name: str = ""
    window: tracing.Window | None = None
    spans: tracing.Spans | None = None
    flops_per_image: object = None  # extent (w, h) -> reference FLOPs of one image

    @property
    def peaks(self) -> dict | None:
        return PEAKS.get(self.device_name)

    def latencies_s(self) -> np.ndarray:
        """Every request due in the window, from its due time to its answer;
        one never answered counts to the time the load stopped waiting."""
        rec = self.record
        return np.array([(r[4] if r[4] is not None and r[5] else max(rec.t_gave_up, rec.t_close)) - r[2]
                         for r in rec.window_rows()])


def _stats(server) -> dict:
    s = server.stats
    with s._lock:
        return {"requests": s.requests, "batches": s.batches, "batched_items": s.batched_items}


def _flops_counter(rmod, specs, cfg):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cache = {}

    def flops(extent):
        if extent not in cache:
            w = {n: torch.empty(shape, device="meta") for n, shape, _, _ in specs}
            x = torch.empty((1, extent[1], extent[0], 3), dtype=torch.uint8, device="meta")
            with FlopCounterMode(display=False) as mode:
                rmod.forward(w, x, cfg)
            cache[extent] = float(mode.get_total_flops())
        return cache[extent]

    return flops


def _merge(base: dict, extra: dict | None) -> dict:
    out = json.loads(json.dumps(base))
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def compare(served: np.ndarray, expected: np.ndarray) -> tuple[float, float]:
    """(RMS of the difference in u8 levels, % of values more than 3 levels
    off) of a served answer against the reference's; an answer of the wrong
    shape reads 255 and 100%."""
    if served.shape != expected.shape:
        return 255.0, 100.0
    d = np.abs(served.astype(np.int16) - expected.astype(np.int16))
    return float(np.sqrt(np.mean(d.astype(np.float64) ** 2))), float(100.0 * np.mean(d > 3))


def run(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT, device: str = "gpu",
        config_overrides: dict | None = None, traffic_overrides: dict | None = None, fault=None,
        control: bool = False, t_start: float | None = None) -> dict:
    """One run of cell ``workload``; returns the result object (with
    ``checks`` last). ``device`` "cpu" runs it on the CPU, as the tests do,
    at the sizes that ``config_overrides`` / ``traffic_overrides`` set.
    ``fault(server)`` plants a fault in the served path before the window.
    ``control`` also reads the control, the reference in float8, on the
    same answers (``control_checks``)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_benchmark(root)
    cell = find_cell(spec, workload, root)
    cfg = _merge(json.loads(cell.config_file.read_text()), config_overrides)
    traffic = loadgen.load_traffic(cell.traffic, traffic_overrides)
    builder = load_module(cell.builder, f"vbench_config_{cell.config['name']}")
    reference = load_module(cell.reference, f"vbench.reference.{cell.config['name']}")
    dev = torch.device("cuda", 0) if device == "gpu" else torch.device("cpu")
    cuda = dev.type == "cuda"

    parts = {"imports": time.perf_counter() - t_start}
    tick = time.perf_counter()

    def part(name):
        nonlocal tick
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - tick
        tick = now

    specs = builder.weight_specs(cfg)
    weights = draw(specs, seed, dev)
    part("weights")
    server = builder.build(weights, cfg, device)
    del weights
    part("model")
    extents = [(int(w), int(h)) for w, h, _ in traffic.extents]
    pools = [image_pool(seed, f"{w}x{h}", traffic.pool, w, h, dev) for w, h in extents]
    requests = [[builder.request(a) for a in pool] for pool in pools]
    part("images")
    for extent in extents:
        builder.warm(server, extent)
    part("warm")
    if fault is not None:
        fault(server)
    spans = devtrace = None
    if trace:
        spans = tracing.Spans()
        spans.install(server)
        devtrace = tracing.DeviceTrace(torch)
        devtrace.start()
        part("profiler")

    record = loadgen.Record()
    record.t_open = time.perf_counter() + 0.05 + traffic.lead_s
    record.t_close = record.t_open + seconds
    stats_at = {}

    def watch():
        for when, key in ((record.t_open, "open"), (record.t_close, "close")):
            loadgen._sleep_until(when)
            if devtrace is not None:
                devtrace.mark()
            stats_at[key] = _stats(server)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    rng = np.random.default_rng(derive_seed(seed, "traffic"))
    drive = loadgen.run_closed if traffic.loop == "closed" else loadgen.run_open
    drive(server.submit, requests, traffic, seconds, rng, record, builder.result_pixels)
    watcher.join()
    setup_s = record.t_open - t_start
    if devtrace is not None:
        devtrace.stop()
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    batch_size = server.batch_size
    server.close()
    del server, requests
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ctx = Context(cell, cfg, traffic, seconds, setup_s, record, stats_at.get("open", {}), stats_at.get("close", {}),
                  batch_size, device_name, spans=spans)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": device_name, "count": cell.chips,
                   "memory_peak_bytes": memory_peak}
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": device_info}
    if trace:
        ctx.window = tracing.reduce(devtrace)
        del devtrace
        ctx.flops_per_image = _flops_counter(reference, specs, cfg)
        device_info["busy_s"] = ctx.window.busy_ns / 1e9
        device_info["window_s"] = ctx.window.seconds
        readers = cell.per_layer
        result["breakdown"] = {"device_ops": tracing.heaviest(ctx.window),
                               "idle_gaps": tracing.label_gaps(ctx.window, spans)}
    else:
        readers = cell.end_to_end
    for name, (entry, path) in readers.items():
        value = load_module(path, f"vbench_metric_{name.replace('.', '_')}").read(ctx)
        if value is not None:
            result["metrics"][name] = {"value": float(value), "unit": entry["unit"]}

    rows = record.window_rows()
    failed = sum(1 for r in rows if not r[5])
    result["attempted"], result["failed"] = len(rows), failed
    lateness = np.array(record.lateness_s) if record.lateness_s else np.zeros(1)
    parts["lead_in"] = traffic.lead_s
    result["setup_parts_s"] = parts
    result["loadgen"] = {"loop": traffic.loop, "completed_in_window": len(record.completed_in_window()),
                         "backlog_at_close": sum(1 for r in rows if r[4] is None or r[4] > record.t_close),
                         "sender_late_p95_ms": float(np.percentile(lateness, 95) * 1e3),
                         "sender_late_max_ms": float(lateness.max() * 1e3), "errors": record.errors[:5]}

    # the check: the kept answers against the reference, from the same seed
    t_check = time.perf_counter()
    weights = draw(specs, seed, dev)
    worst = [0.0, 0.0]
    worst_control = [0.0, 0.0]
    compared = [0] * len(extents)
    spread = []
    for k, i, served in record.kept:
        x = torch.from_numpy(pools[k][i][None]).to(dev)
        expected = reference.expected_u8(weights, x, cfg)[0].cpu().numpy()
        spread.append(float(expected.std()))
        worst = [max(a, b) for a, b in zip(worst, compare(served, expected))]
        compared[k] += 1
        if control:
            lower = reference.expected_u8(weights, x, cfg, "fp8")[0].cpu().numpy()
            worst_control = [max(a, b) for a, b in zip(worst_control, compare(lower, expected))]
    del weights
    limit = cfg["check"]["limit"]
    ok_limit = limit is not None and worst[0] <= limit
    result["correct"] = bool(ok_limit and failed == 0 and all(compared))
    result["check_s"] = time.perf_counter() - t_check
    result["readings"] = {"off3_pct": worst[1], "reference_std_u8": spread}
    if control:
        result["control_checks"] = {"rms_u8": worst_control[0], "off3_pct": worst_control[1]}
    result["checks"] = {
        "rms_u8": {"value": worst[0], "limit": limit},
        "unanswered": {"value": failed, "limit": 0},
        "compared": {"value": sum(compared), "limit": f"at least 1 of each of {len(extents)} extents"},
    }
    return result


def main(argv: list[str], t_start: float | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="vbench/run.py", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache = ROOT / "build" / "vbench"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv_compute")

    import torch

    cell = find_cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"vbench: cell {cell.name} needs {cell.chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        log(f"vbench: the run loaded {found}; the benchmark of the port may load no JAX and no JAX package")
        return 3
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
