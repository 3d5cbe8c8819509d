"""Timing and tracing — the port of vision_tpu/utils/profiling.py.

``Timer`` is the per-phase wall-clock timer of the JAX package (the
reference CLI's timer, src/cli/cli.cpp:203-216), unchanged.
``device_barrier`` waits for the work queued on a tensor's device.
``trace(log_dir)`` records a ``torch.profiler`` trace of the enclosed block,
host and CUDA activities, as a Chrome trace (JSON, for Perfetto or
chrome://tracing) in ``log_dir``. The hand-written kernels run as the
``vtt::`` operators (ops/cuda/library.py), so the host side of the trace
names each of them beside the kernel it launched. Host-side op events are
those of the thread that entered ``trace`` (the profiler is thread-local on
the host): a server's worker thread shows on the device side only.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["Timer", "trace", "device_barrier"]


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
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
