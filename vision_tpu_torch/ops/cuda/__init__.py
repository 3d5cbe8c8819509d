"""Hand-written Hopper kernels (sources in vision_tpu_torch/csrc/) and their
wrappers, one module each, each with module-level launch counts
(``launches``; the window kernel's ``masked_launches`` too) that count the
kernel's launches on the card, CUDA-graph replays included (see
:func:`count_launch`). Importing builds nothing: the kernel library is
compiled with nvcc at its first launch (cuda/build.py). Each wrapper calls
its kernel's ``vtt`` operator (library.py, imported here so that importing
any wrapper registers them all)."""

from __future__ import annotations

import sys
import threading
from collections import Counter
from contextlib import contextmanager

__all__ = ["add_counts", "capture_tally", "count_launch"]

_capture = threading.local()


def add_counts(tally: dict) -> None:
    """Add ``{(module name, counter name): n}`` to the wrappers' counters."""
    for (module, name), n in tally.items():
        mod = sys.modules[module]
        with mod._count_lock:
            setattr(mod, name, getattr(mod, name) + n)


def count_launch(module: str, **counts: int) -> None:
    """A wrapper launched its kernel: add ``counts`` to module ``module``'s
    counters. While this thread captures a CUDA graph the kernel is only
    recorded, not run, so the counts go to the capture's tally instead, and
    every replay of the graph adds that tally (core/graph.py)."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        for name, n in counts.items():
            tally[(module, name)] += n
        return
    add_counts({(module, name): n for name, n in counts.items()})


@contextmanager
def capture_tally():
    """Collect this thread's :func:`count_launch` calls into a Counter
    (yielded) instead of the counters, for one graph capture."""
    _capture.tally = tally = Counter()
    try:
        yield tally
    finally:
        _capture.tally = None


from . import library  # noqa: E402,F401  (registers the vtt operators; the wrappers import count_launch above)
