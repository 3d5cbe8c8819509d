"""The harness on the CPU: what BENCHMARK.json names is found by name, its
names and units keep to the contract's characters, a cell added from new
files only runs, the open loop's arithmetic, the result's keys, and no JAX
in a run's process.

    python -m pytest vbench/tests -q
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from vbench import harness, loadgen

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}

torch.set_num_threads(2)

TINY_ESRGAN = dict(config_overrides={"num_block": 2}, traffic_overrides={
    "extents": [[24, 24, 1.0]], "clients": 2, "pool": 3, "lead_s": 0.3, "check_per_extent": 2})


@pytest.fixture(scope="module")
def spec():
    return harness.load_benchmark(ROOT)


def test_every_cell_finds_its_files_by_name(spec):
    for w in spec["workloads"]:
        cell = harness.find_cell(spec, w["name"], ROOT)
        assert cell.builder == ROOT / "vbench" / "configs" / f"{w['config']}.py"
        assert cell.reference == ROOT / "vbench" / "reference" / f"{w['config']}.py"
        assert cell.traffic == ROOT / "vbench" / "traffic" / f"{w['traffic']}.json"
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer, f"{w['name']} reports no per-layer metric"
        for m, _ in cell.per_layer.values():
            assert m["moves"] in cell.end_to_end


def test_names_units_and_keys_keep_to_the_contract(spec):
    assert set(spec) == TOP_KEYS
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["config"] for w in spec["workloads"]] + [w["traffic"] for w in spec["workloads"]]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in spec[group]}) == len(spec[group])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("vbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_cell_added_from_new_files_only_runs(spec, tmp_path):
    """A later cell brings its traffic and a metric as new files and new
    entries; no file already there changes."""
    shutil.copytree(ROOT / "vbench", tmp_path / "vbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "vbench" / "traffic" / "closed2_tiny.json").write_text(json.dumps(
        {"loop": "closed", "clients": 2, "extents": [[24, 24, 1.0]], "pool": 3, "lead_s": 0.3, "check_per_extent": 1}))
    (tmp_path / "vbench" / "layer_metrics" / "answered.tiny.py").write_text(
        "def read(ctx):\n    return float(len(ctx.record.completed_in_window()))\n")
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append({"name": "esrgan_x4plus.closed2_tiny", "config": "esrgan_x4plus",
                              "traffic": "closed2_tiny", "chips": 1, "why": "a dummy cell"})
    spec["end_to_end"][0]["workloads"].append("esrgan_x4plus.closed2_tiny")
    spec["per_layer"].append({"name": "answered.tiny", "unit": "images", "better": "higher",
                              "source": "program_counter", "layer": "serving", "moves": "img_s",
                              "workloads": ["esrgan_x4plus.closed2_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell(spec, "esrgan_x4plus.closed2_tiny", tmp_path)
    assert set(cell.end_to_end) == {"img_s", "setup_s"} and set(cell.per_layer) == {"answered.tiny"}
    result = harness.run("esrgan_x4plus.closed2_tiny", 5, 1.0, False, root=tmp_path, device="cpu",
                         config_overrides={"num_block": 2, "check": {"limit": 0.5}})
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"img_s", "setup_s"}


def test_open_schedule_gives_every_seed_the_same_work():
    traffic = loadgen.Traffic(loop="open", rate_per_s=40.0, extents=[[8, 8, 0.5], [16, 8, 0.3], [16, 16, 0.2]],
                              pool=5, lead_s=1.0)
    a = loadgen.open_schedule(traffic, 10.0, np.random.default_rng(1))
    b = loadgen.open_schedule(traffic, 10.0, np.random.default_rng(2))
    window = [r for r in a if r[0] >= 1.0]
    assert len(a) == len(b) == 440 and len(window) == 400
    assert [sum(1 for r in window if r[1] == k) for k in range(3)] == [200, 120, 80]
    gaps = lambda s: sorted(np.round(np.diff([r[0] for r in s if r[0] >= 1.0] + [11.0]), 9))  # noqa: E731
    assert gaps(a) == pytest.approx(gaps(b)) and [r[1] for r in a] != [r[1] for r in b]
    assert window[0][0] == pytest.approx(1.0) and max(r[0] for r in window) < 11.0


class _FakeServer:
    """Answers each request after ``service_s`` on one worker thread, in
    order; ``stall`` adds a pause once, at a given time."""

    def __init__(self, service_s: float, stall_at: float | None = None, stall_s: float = 0.0):
        self.q: list = []
        self.cv = threading.Condition()
        self.service_s, self.stall_at, self.stall_s = service_s, stall_at, stall_s
        self.stop = False
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def submit(self, item):
        fut = Future()
        with self.cv:
            self.q.append((item, fut))
            self.cv.notify()
        return fut

    def _work(self):
        while True:
            with self.cv:
                while not self.q and not self.stop:
                    self.cv.wait()
                if self.stop and not self.q:
                    return
                item, fut = self.q.pop(0)
            if self.stall_at is not None and time.perf_counter() >= self.stall_at:
                time.sleep(self.stall_s)
                self.stall_at = None
            time.sleep(self.service_s)
            fut.set_result(item)

    def close(self):
        with self.cv:
            self.stop = True
            self.cv.notify()
        self.t.join(timeout=10)


def _p95(stall_s: float, seed: int = 3) -> tuple[float, list]:
    traffic = loadgen.Traffic(loop="open", rate_per_s=50.0, extents=[[8, 8, 1.0]], pool=2, lead_s=0.2,
                              check_per_extent=1, late_wait_s=5.0)
    record = loadgen.Record()
    record.t_open = time.perf_counter() + 0.05 + traffic.lead_s
    record.t_close = record.t_open + 1.0
    server = _FakeServer(0.002, stall_at=record.t_open + 0.3, stall_s=stall_s)
    requests = [[np.full((2, 2), i, np.uint8) for i in range(2)]]
    loadgen.run_open(server.submit, requests, traffic, 1.0, np.random.default_rng(seed), record, lambda a: a)
    server.close()
    ctx = harness.Context(None, {}, traffic, 1.0, 0.0, record)
    p95 = harness.load_module(ROOT / "vbench" / "end_to_end" / "p95_ms.py", "p95").read(ctx)
    return p95, record


def test_open_loop_times_from_due_time_and_a_stall_raises_p95():
    calm, record = _p95(0.0)
    assert all(r[3] >= r[2] for r in record.rows)  # sent at or after due
    assert all(r[4] - r[2] >= r[4] - r[3] for r in record.rows if r[4] is not None)
    assert len(record.window_rows()) == 50 and not record.errors
    stalled, record = _p95(0.25)
    # the stall delays every request due while it lasts, ~12 of 50, by up to 250 ms
    assert stalled > calm + 100.0, (calm, stalled)


def test_a_cpu_run_has_the_contract_keys_and_checks_last():
    result = harness.run("esrgan_x4plus.closed16_512", 9, 0.6, False, device="cpu",
                         **{**TINY_ESRGAN, "config_overrides": {"num_block": 2, "check": {"limit": 0.5}}})
    assert RESULT_KEYS <= set(result) and list(result)[-1] == "checks"
    assert set(result) - RESULT_KEYS <= {"loadgen", "setup_parts_s", "readings", "check_s", "checks"}
    assert set(result["metrics"]) == {"img_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert all({"value", "limit"} == set(c) for c in result["checks"].values())
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0


def test_without_a_card_the_command_prints_no_result(tmp_path):
    proc = subprocess.run([sys.executable, "vbench/run.py", "--workload", "esrgan_x4plus.closed16_512", "--seed",
                           str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    if "cuda" in proc.stderr.lower() and proc.returncode == 0:
        pytest.fail("a run without a card exited 0")
    assert proc.returncode != 0 and proc.stdout.strip() == "", (proc.returncode, proc.stdout[-500:])


def test_a_run_loads_no_jax_and_no_jax_package():
    code = ("import sys, torch; torch.set_num_threads(2); from vbench import harness; "
            "harness.run('esrgan_x4plus.closed16_512', 4, 0.5, False, device='cpu', "
            "config_overrides={'num_block': 2}, traffic_overrides={'extents': [[16, 16, 1.0]], 'clients': 1, "
            "'pool': 2, 'lead_s': 0.2, 'check_per_extent': 1}); print(harness.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    src = [p for p in (ROOT / "vbench").rglob("*.py") if "tests" not in p.parts]
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|vision_tpu)(?:\s|\.|$)", re.M)
    assert not [str(p) for p in src if pattern.search(p.read_text())]
