"""idle_after_forward_share (%, device trace; serving: serve.py
``BatchServer``): the card's idle time in the traced window while the batch
worker was past the card's answers, over the window's length. Per
``serve.batch`` span of the program, the interval from the end of its
``serve.wait`` (the card has the answers) to the batch's end (copy back,
post-processing, delivery); the union of those intervals, mapped to the
device's clock, against the window's idle gaps.

The mapping: the profiler stamps device operations on the Unix clock, so
one paired reading of ``time.time_ns()`` and ``time.perf_counter_ns()``
maps the program's host times onto them. The window's own offset
(``Window.host_to_device``) is taken from the open marker kernel's start
and is late by however long that marker waited to run, which shifts every
interval later, onto the next batch's busy replay; it is used only where
the device's clock is not the Unix clock (the two offsets more than a
second apart)."""

import time

import numpy as np

from vbench.layer_metrics.copy_back_ms_per_img import program_spans
from vbench.trace import union_ns


def offset_ns(win) -> int:
    """Device ns = host perf_counter ns + this."""
    paired = time.time_ns() - time.perf_counter_ns()
    return paired if abs(paired - win.offset_ns) < 1_000_000_000 else win.offset_ns


def read(ctx):
    win = ctx.window
    records = program_spans(ctx)
    if win is None or records is None or win.close_ns <= win.open_ns:
        return None
    waited = {r[6]: r[3] for r in records if r[1] == "serve.wait"}  # batch id -> end of its wait
    after = [(waited[r[0]], r[3]) for r in records if r[1] == "serve.batch" and r[0] in waited]
    if not after:
        return None
    shift = offset_ns(win)
    _, ps, pe = union_ns(np.array([a for a, _ in after], np.int64) + shift,
                         np.array([b for _, b in after], np.int64) + shift)
    gaps = np.array(win.gaps, np.int64).reshape(-1, 2)
    overlap = np.minimum(gaps[:, 1:2], pe[None, :]) - np.maximum(gaps[:, 0:1], ps[None, :])
    return 100.0 * float(np.clip(overlap, 0, None).sum()) / (win.close_ns - win.open_ns)
