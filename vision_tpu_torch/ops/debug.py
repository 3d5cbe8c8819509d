"""Capture-by-name debugging — the port of vision_tpu/ops/debug.py.

Model code tags intermediate values with their dotted module name
(``capture(name, value)``); while a capture context is active (parity
tests, the CLI's ``--dump``), tagged values are recorded. Outside a context
it is a no-op.

Two differences from the JAX package, where arrays are immutable and a
traced program records nothing:

* a capture stores ``value.detach().clone()``: the port writes later layers
  into channel views of shared buffers (YOLOv9t's ELAN buffers through
  ``vtt::conv3x3_out``), so a reference would show a later write;
* nothing is recorded while the current stream captures a CUDA graph, and
  an active context raises there, so a dump never holds graph-pool memory:
  dump from the eager forward (``model._forward_u8``).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

__all__ = ["capture", "capture_context", "capturing"]

_active: list[dict[str, Any]] = []


def capture(name: str, value):
    """Record a copy of ``value`` under ``name`` if a capture context is
    active; return ``value``."""
    if _active:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"capture('{name}'): a capture context is active while a CUDA graph is being "
                               f"captured; dump from the eager forward")
        _active[-1][name] = value.detach().clone() if isinstance(value, torch.Tensor) else value
    return value


def capturing() -> bool:
    return bool(_active)


@contextlib.contextmanager
def capture_context():
    sink: dict[str, Any] = {}
    _active.append(sink)
    try:
        yield sink
    finally:
        _active.pop()
