"""The traced run's instruments: a device trace of the window and host spans
of the benchmark's own wrappers around the program's layers.

- :class:`Spans` wraps the server's batch function (the serving layer's call
  into the model: stack, forward, copy back, post-processing) and the
  model's ``forward_u8`` (the graph replay) of one server, and records each
  call's host interval; the forward's records also hold its input shape.
- :class:`DeviceTrace` runs ``torch.profiler`` with CUDA activity from the
  start of the lead-in (the tracer drops records at the start of a burst,
  so the lead-in's first batches take that loss) to the end of the window,
  and launches a marker kernel (``torch.cuda._sleep``, the ``spin_kernel``)
  on a stream of its own at the window's open and close. The markers give
  the window in the device's clock and the offset that maps host times onto
  it.
- :func:`reduce` turns the trace into arrays of device operations inside the
  window (kernels, copies, sets), their union (busy time), and the idle gaps
  labelled by what the worker thread was doing.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

__all__ = ["Spans", "DeviceTrace", "Window", "reduce", "union_ns"]

MARKER = "spin_kernel"


class Spans:
    """Host intervals (perf_counter seconds) of a server's batches and of
    its model's forwards."""

    def __init__(self):
        self.batches: list[tuple[float, float]] = []
        self.forwards: list[tuple[float, float, tuple]] = []
        self._lock = threading.Lock()

    def install(self, server) -> None:
        inner = server._server._fn
        forward = server.model.forward_u8

        def batch(items):
            t0 = time.perf_counter()
            try:
                return inner(items)
            finally:
                with self._lock:
                    self.batches.append((t0, time.perf_counter()))

        def forward_u8(x, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return forward(x, *args, **kwargs)
            finally:
                with self._lock:
                    self.forwards.append((t0, time.perf_counter(), tuple(x.shape)))

        server._server._fn = batch
        server.model.forward_u8 = forward_u8


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.marks: list[float] = []
        self._stream = torch.cuda.Stream(priority=-1)
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def mark(self) -> None:
        """A marker kernel on the trace's own stream, its host time kept."""
        with self.torch.cuda.stream(self._stream):
            self.marks.append(time.perf_counter())
            self.torch.cuda._sleep(1)

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self._prof.stop()

    def device_events(self):
        """(names, start_ns, end_ns) of every device operation traced."""
        from torch.autograd import DeviceType

        names, starts, ends = [], [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            names.append(e.name())
            starts.append(start)
            ends.append(start + dur)
        return names, np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def union_ns(starts: np.ndarray, ends: np.ndarray) -> tuple[int, np.ndarray, np.ndarray]:
    """Total length of the union of intervals, and its pieces (sorted)."""
    if len(starts) == 0:
        return 0, starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    piece_s = s[idx]
    piece_e = np.append(reach[idx[1:] - 1], reach[-1])
    return int((piece_e - piece_s).sum()), piece_s, piece_e


@dataclass
class Window:
    """The traced window in the device's clock, and what ran in it."""

    open_ns: int
    close_ns: int
    offset_ns: int  # device ns = host perf_counter ns + offset
    names: list  # name of each operation in the window
    starts: np.ndarray  # its start and end, clipped to the window
    ends: np.ndarray
    durations: np.ndarray  # unclipped
    busy_ns: int
    gaps: list  # (start ns, end ns) of each idle gap

    @property
    def seconds(self) -> float:
        return (self.close_ns - self.open_ns) / 1e9

    def matching(self, patterns) -> np.ndarray:
        """Mask of the operations whose name holds any of ``patterns``."""
        return np.array([any(p in n for p in patterns) for n in self.names], bool)

    def host_to_device(self, t: float) -> int:
        return int(round(t * 1e9)) + self.offset_ns


def reduce(trace: DeviceTrace) -> Window:
    names, starts, ends = trace.device_events()
    is_mark = np.array([MARKER in n for n in names], bool)
    mark_starts = np.sort(starts[is_mark])
    if len(mark_starts) < 2 or len(trace.marks) < 2:
        raise RuntimeError(f"device trace: {len(mark_starts)} window markers traced, 2 expected "
                           f"({len(names)} device operations in all)")
    open_ns, close_ns = int(mark_starts[-2]), int(mark_starts[-1])
    offset = open_ns - int(round(trace.marks[-2] * 1e9))
    keep = ~is_mark & (ends > open_ns) & (starts < close_ns)
    kept_names = [n for n, k in zip(names, keep) if k]
    s, e = starts[keep], ends[keep]
    cs, ce = np.clip(s, open_ns, close_ns), np.clip(e, open_ns, close_ns)
    busy, ps, pe = union_ns(cs, ce)
    bounds_s = np.concatenate([[open_ns], pe])
    bounds_e = np.concatenate([ps, [close_ns]])
    gaps = [(int(a), int(b)) for a, b in zip(bounds_s, bounds_e) if b > a]
    return Window(open_ns, close_ns, offset, kept_names, cs, ce, e - s, busy, gaps)


def label_gaps(window: Window, spans: Spans, top: int = 10) -> list:
    """Idle gaps summed by what the worker thread was doing at each gap's
    middle: inside ``forward_u8``, stacking a batch's inputs before it,
    copying back and post-processing after it, or waiting for requests.
    ``[[label, seconds], ...]``, longest first, at most ``top``."""
    batches = np.array([(window.host_to_device(a), window.host_to_device(b)) for a, b in spans.batches], np.int64)
    fwd = np.array([(window.host_to_device(a), window.host_to_device(b)) for a, b, _ in spans.forwards], np.int64)
    totals: dict[str, list] = {}
    for a, b in window.gaps:
        mid = (a + b) // 2
        label = "worker waiting for requests (queue, batch window)"
        if len(fwd) and np.any((fwd[:, 0] <= mid) & (mid < fwd[:, 1])):
            label = "worker in forward_u8 (input copy, replay launch, output copy)"
        elif len(batches):
            inside = np.flatnonzero((batches[:, 0] <= mid) & (mid < batches[:, 1]))
            if len(inside):
                b0, b1 = batches[inside[0]]
                started = len(fwd) and np.any((fwd[:, 0] >= b0) & (fwd[:, 0] <= mid))
                label = ("worker after forward_u8 (copy back, post-processing)" if started
                         else "worker before forward_u8 (stacking the batch)")
        t = totals.setdefault(label, [0, 0, 0])
        t[0] += b - a
        t[1] += 1
        t[2] = max(t[2], b - a)
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return [[f"{label}: {n} gaps, longest {longest / 1e6:.3f} ms", total / 1e9] for label, (total, n, longest) in rows]


def heaviest(window: Window, top: int = 10) -> list:
    """``[[name, seconds], ...]``: the device operations with the most time
    inside the window (clipped), summed by name."""
    by: dict[str, int] = {}
    for n, d in zip(window.names, window.ends - window.starts):
        by[n] = by.get(n, 0) + int(d)
    return [[n[:160], t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
