"""Timing and tracing — the port of vision_tpu/utils/profiling.py.

``Timer`` is the per-phase wall-clock timer of the JAX package (the
reference CLI's timer, src/cli/cli.cpp:203-216), unchanged.
``device_barrier`` waits for the work queued on a tensor's device.

``span(name, parent=None, **attrs)`` records a span of the program: a named
interval of one thread, with the span that encloses it and a few integer
attributes, into one bounded in-memory ring per process. ``spans()`` is a
snapshot of the ring, ``dropped()`` the count of records it evicted. The
serving layer (serve.py) and the graph cache (core/graph.py) record their
phases here; see ``spans()`` for a record's fields. Times are
``time.perf_counter_ns()``, and each record also holds the thread's CPU time
inside the span (``time.thread_time_ns()``), so that wall time minus CPU
time is the time the thread waited (for the card, the interpreter lock, the
scheduler). Always on: a span costs two pairs of clock reads and one append.

``trace(log_dir)`` records a ``torch.profiler`` trace of the enclosed block,
host and CUDA activities, as a Chrome trace (JSON, for Perfetto or
chrome://tracing) in ``log_dir``. The hand-written kernels run as the
``vtt::`` operators (ops/cuda/library.py), so the host side of the trace
names each of them beside the kernel it launched. The profiler's host-side
op events are those of the thread that entered ``trace`` (it is
thread-local on the host), so the spans recorded during the block, on every
thread (a server's batch worker and prep pool too), are added to the file as
complete events on their threads' rows.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch

__all__ = ["Timer", "trace", "device_barrier", "span", "spans", "dropped"]

_RING_RECORDS = 1 << 16
_ring: collections.deque = collections.deque(maxlen=_RING_RECORDS)
_ids = itertools.count(1)  # span ids; 0 is "no parent"
_dropped = 0
_dropped_lock = threading.Lock()
_local = threading.local()  # per thread: its open spans, its native id
_perf_ns, _cpu_ns = time.perf_counter_ns, time.thread_time_ns


def _this_thread() -> tuple[list, int]:
    try:
        return _local.open, _local.tid
    except AttributeError:
        _local.open, _local.tid = [], threading.get_native_id()
        return _local.open, _local.tid


def _begin(name: str, parent: int, attrs: tuple, tid: int | None = None) -> tuple:
    """A span begun now on this thread: (id, name, start ns, thread CPU ns,
    thread, parent, attrs). Closed by :func:`_end`, on any thread."""
    if tid is None:
        tid = _this_thread()[1]
    return (next(_ids), name, _perf_ns(), _cpu_ns(), tid, parent, attrs)


def _end(begun: tuple, tid: int | None = None) -> None:
    """Record the span ``begun`` (from :func:`_begin`) as ending now. Its CPU
    time is -1 when it ends on another thread than it began on."""
    # the CPU clock first: its interval then nests inside the wall clock's,
    # which _begin read first, so a span's CPU time never exceeds its wall
    # time by the CPU clock's own read
    cpu, end = _cpu_ns(), _perf_ns()
    sid, name, start, cpu0, tid0, parent, attrs = begun
    if tid is None:
        tid = _this_thread()[1]
    cpu = cpu - cpu0 if tid == tid0 else -1
    if len(_ring) == _RING_RECORDS:
        global _dropped
        with _dropped_lock:
            _dropped += 1
    _ring.append((sid, name, start, end, cpu, tid0, parent, attrs))


class _Span:
    __slots__ = ("_args", "_begun", "_open", "_tid")

    def __init__(self, args):
        self._args = args

    def __enter__(self) -> int:
        name, parent, attrs = self._args
        self._open, self._tid = stack, tid = _this_thread()
        if parent is None:
            parent = stack[-1] if stack else 0
        self._begun = begun = _begin(name, parent, attrs, tid)
        stack.append(begun[0])
        return begun[0]

    def __exit__(self, *exc) -> None:
        self._open.pop()
        _end(self._begun, self._tid)


def span(name: str, parent: int | None = None, **attrs) -> _Span:
    """A context manager that records the enclosed block as span ``name`` and
    returns its id. ``parent`` is a span id (0: none); by default the
    innermost span open on this thread. ``attrs`` are ints or tuples of ints
    (request ids, sizes, shapes)."""
    return _Span((name, parent, tuple(attrs.items())))


def spans() -> list[tuple]:
    """A snapshot of the recorded spans, oldest first (in the order they
    ended): tuples ``(id, name, start_ns, end_ns, cpu_ns, thread, parent,
    attrs)``, times by ``time.perf_counter_ns()``, ``cpu_ns`` the thread's
    CPU time inside the span (-1 for a span that ended on another thread),
    ``thread`` the native id of the thread it began on, ``parent`` a span
    id or 0, ``attrs`` a tuple of (name, value) pairs."""
    while True:
        try:
            return list(_ring)
        except RuntimeError:  # appended to while copied
            continue


def dropped() -> int:
    """Records evicted from the ring (it keeps the newest 65536)."""
    return _dropped


def device_barrier(x) -> None:
    """Wait for the device work feeding tensor ``x`` (nothing for a CPU
    tensor or a non-tensor)."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class Timer:
    """Per-phase wall-clock timer (reference cli.cpp timer)."""

    def __init__(self, label: str = "", verbose: bool = True):
        self.label = label
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        if self.verbose and self.label and exc[0] is None:
            print(f"{self.label}: {self.elapsed * 1000:.1f} ms")

    def elapsed_str(self) -> str:
        return f"{self.elapsed * 1000:.1f} ms"


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace (CPU, and CUDA where the card is
    there) of the enclosed block into ``log_dir/trace-<pid>-<ns>.json``.
    The card's queued work is waited for before the trace stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    t1 = time.perf_counter_ns()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, t0, t1)


def _add_spans(path: str, t0: int, t1: int) -> None:
    """Append the spans that overlap [t0, t1] (perf_counter ns) to the
    Chrome trace at ``path`` as complete events ("ph": "X") on their
    threads' rows, with their attributes, ids and CPU time in ``args``. The
    file's clock: an event's ``ts`` (us) plus its ``baseTimeNanoseconds`` is
    Unix time, to which one paired reading maps perf_counter."""
    to_unix = time.time_ns() - time.perf_counter_ns()
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    for sid, name, start, end, cpu, tid, parent, attrs in spans():
        if end < t0 or start > t1:
            continue
        args = dict(attrs, span_id=sid, parent=parent, cpu_us=cpu / 1e3 if cpu >= 0 else None)
        doc["traceEvents"].append({"ph": "X", "cat": "span", "name": name, "pid": pid, "tid": tid,
                                   "ts": (start + to_unix - base) / 1e3, "dur": (end - start) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
