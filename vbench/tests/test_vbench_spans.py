"""The readers of the program's spans on the CPU: ``copy_back_ms_per_img``,
``post_ms_per_img``, ``prep_ms_per_img`` and ``idle_after_forward_share``
on synthetic records, a synthetic window and hand-made device windows
(one whose offset a late marker skewed), against values worked out by hand; None on a program without the recorder
and when the ring lost records inside the window; and on the spans of a
harness run of the held cell at a tiny size.

    python -m pytest vbench/tests -q
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from vbench import harness, loadgen, trace
from vision_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
CELL = "esrgan_x4plus.closed16_512"
SPAN_METRICS = ("copy_back_ms_per_img", "post_ms_per_img", "prep_ms_per_img", "idle_after_forward_share")
S = 1_000_000_000  # ns a second

torch.set_num_threads(2)


def _reader(name):
    return harness.load_module(ROOT / "vbench" / "layer_metrics" / f"{name}.py", f"vbench_metric_{name}")


def _ns(s: float) -> int:
    return int(round(s * S))


def _rec(sid, name, start_s, end_s, parent=0):
    return (sid, name, _ns(start_s), _ns(end_s), 0, 1, parent, ())


# host seconds: the window is [100, 110]; three batches, the last past the
# close; in the ring's order, by their ends
RECORDS = sorted([
    _rec(30, "serve.deliver", 98.9, 99.0),
    _rec(2, "serve.prep", 99.9, 100.1),
    _rec(3, "serve.wait", 100.0, 100.2, parent=1),
    _rec(4, "serve.copy_back", 100.2, 100.3, parent=1),
    _rec(5, "serve.post", 100.3, 100.45, parent=1),
    _rec(1, "serve.batch", 99.5, 100.5),
    _rec(6, "serve.prep", 104.0, 104.01),
    _rec(11, "serve.wait", 105.1, 105.5, parent=10),
    _rec(12, "serve.copy_back", 105.5, 105.6, parent=10),
    _rec(13, "serve.post", 105.6, 105.9, parent=10),
    _rec(10, "serve.batch", 105.0, 106.0),
    _rec(21, "serve.wait", 109.9, 110.1, parent=20),
    _rec(22, "serve.copy_back", 110.1, 110.2, parent=20),
    _rec(23, "serve.post", 110.2, 110.3, parent=20),
    _rec(20, "serve.batch", 109.8, 110.4),
], key=lambda r: r[3])
OFFSET = 5 * S  # device ns = host ns + OFFSET
# the device's idle gaps, in device seconds; the window is [105, 115] there
GAPS = [(105.0, 105.3), (107.0, 107.5), (110.8, 112.0), (114.9, 115.0)]
EXPECTED = {
    "copy_back_ms_per_img": (0.1 + 0.1) * 1e3 / 4,
    "post_ms_per_img": (0.15 + 0.3) * 1e3 / 4,
    "prep_ms_per_img": (0.1 + 0.01) * 1e3 / 4,
    # [100.2, 100.5] and [105.5, 106.0] after their waits, shifted by 5 s,
    # meet the first gap for 0.1 s and the third for 0.2 s; [110.1, 110.4]
    # lies past the window
    "idle_after_forward_share": 100.0 * (0.1 + 0.2) / 10.0,
}


def _context():
    record = loadgen.Record(t_open=100.0, t_close=110.0)
    record.rows = [(0, i, 99.0 + i, 99.0 + i, t, True) for i, t in enumerate((100.5, 103.0, 106.0, 109.0, 110.5))]
    window = trace.Window(open_ns=105 * S, close_ns=115 * S, offset_ns=OFFSET, names=[], starts=np.zeros(0),
                          ends=np.zeros(0), durations=np.zeros(0), busy_ns=0,
                          gaps=[(_ns(a), _ns(b)) for a, b in GAPS])
    return harness.Context(None, {}, None, 10.0, 0.0, record, window=window)


@pytest.fixture
def program(monkeypatch):
    state = {"records": list(RECORDS), "dropped": 0}
    monkeypatch.setattr(profiling, "spans", lambda: list(state["records"]))
    monkeypatch.setattr(profiling, "dropped", lambda: state["dropped"])
    return state


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_the_hand_worked_value(name, program):
    assert _reader(name).read(_context()) == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_none_on_a_program_without_the_recorder(name, program, monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert _reader(name).read(_context()) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_gives_none_when_the_ring_lost_records_in_the_window(name, program, capsys):
    program["dropped"] = 3
    program["records"] = [r for r in RECORDS if r[3] > 100.3 * S]  # the oldest kept ends inside the window
    assert _reader(name).read(_context()) is None
    assert "dropped 3 records" in capsys.readouterr().err
    # records lost before the window opened cost nothing
    program["records"] = list(RECORDS)
    assert _reader(name).read(_context()) == pytest.approx(EXPECTED[name], rel=1e-9)


def test_idle_after_forward_share_maps_by_the_paired_clock(program):
    """Where the device's clock is the Unix clock, host times map by one
    paired clock reading, not by the window's offset, which a late open
    marker leaves 50 ms late here: the first batch's after-forward interval
    [100.2, 100.5] meets the gap [100.0, 100.3] for 0.1 s, not 0.05 s."""
    import time

    paired = time.time_ns() - time.perf_counter_ns()
    ctx = _context()
    ctx.window = trace.Window(open_ns=100 * S + paired, close_ns=110 * S + paired, offset_ns=paired + S // 20,
                              names=[], starts=np.zeros(0), ends=np.zeros(0), durations=np.zeros(0), busy_ns=0,
                              gaps=[(_ns(100.0) + paired, _ns(100.3) + paired)])
    assert _reader("idle_after_forward_share").read(ctx) == pytest.approx(100.0 * 0.1 / 10.0, rel=1e-4)


def test_idle_after_forward_share_reads_nothing_without_a_wait(program):
    program["records"] = [r for r in RECORDS if r[1] != "serve.wait"]
    assert _reader("idle_after_forward_share").read(_context()) is None


def test_the_held_cell_reads_the_program_spans_of_a_tiny_cpu_run(monkeypatch):
    """The held cell names the four readers, and they read the spans of a
    harness run (untraced, on the CPU, at a tiny size): time in each phase
    per image answered, none of it more than the batches' own time."""
    cell = harness.find_cell(harness.load_benchmark(ROOT), CELL, ROOT)
    assert set(SPAN_METRICS) <= set(cell.per_layer)
    seen = []

    class Context(harness.Context):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(harness, "Context", Context)
    result = harness.run(CELL, 2**31 + 11, 1.0, False, device="cpu",
                         config_overrides={"num_block": 2, "check": {"limit": 0.5}},
                         traffic_overrides={"extents": [[24, 24, 1.0]], "clients": 2, "pool": 3, "lead_s": 0.3,
                                            "check_per_extent": 1})
    assert result["correct"], result["checks"]
    (ctx,) = seen
    images = len(ctx.record.completed_in_window())
    values = {name: _reader(name).read(ctx) for name in SPAN_METRICS[:3]}
    assert images and all(v is not None and v > 0 for v in values.values()), values
    lo, hi = _ns(ctx.record.t_open), _ns(ctx.record.t_close)
    batches = sum(max(0, min(r[3], hi) - max(r[2], lo)) for r in profiling.spans() if r[1] == "serve.batch")
    assert values["copy_back_ms_per_img"] + values["post_ms_per_img"] <= batches / 1e6 / images
    assert _reader("idle_after_forward_share").read(ctx) is None  # no device trace
