"""Compute-graph cache — a CUDA graph per (model, input shapes), the port of
vision_tpu/core/graph.py.

The JAX package runs one jitted XLA program per (model, shape bucket), so a
forward costs one dispatch. An eager PyTorch forward issues each of its
hundreds of launches from Python instead. Here each model keeps a
:class:`ForwardGraphs`: on the card, the first call at a key warms the
forward up eagerly and captures it into one CUDA graph, and every later call
at that key copies its input into the graph's static input and replays it.
On the CPU there is no graph, and the forward runs eagerly.

  * ``GraphCache`` — the JAX package's per-model cache, unchanged: entries
    under a caller's key, least recently used evicted first, and only after a
    successful build.
  * ``shape_bucket`` / ``snap_to_multiple`` — snap an extent to a multiple
    so that nearby resolutions share one entry (Depth-Anything's and
    BiRefNet's input extents).
  * ``device_cache`` — an ``lru_cache`` for functions that build constant
    device tensors; a graph keeps alive every such tensor its capture read.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache, partial, wraps
from typing import Callable, Hashable

import torch
from torch._guards import detect_fake_mode

from .errors import raise_error

__all__ = ["ForwardGraphs", "GraphCache", "capture_forward", "device_cache", "shape_bucket", "snap_to_multiple"]


def snap_to_multiple(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def shape_bucket(extent: tuple[int, int], multiple: int, max_extent: int | None = None) -> tuple[int, int]:
    """Snap (width, height) up to `multiple`, optionally clamped."""
    w = snap_to_multiple(extent[0], multiple)
    h = snap_to_multiple(extent[1], multiple)
    if max_extent is not None:
        if max_extent < multiple:
            # no multiple fits under the cap; rounding UP would silently
            # exceed a memory-derived budget — the one thing the clamp is for
            raise_error("shape_bucket: max_extent {} cannot hold a multiple of {}", max_extent, multiple)
        # clamp must STAY a multiple — min() alone breaks the contract when
        # max_extent is not itself a multiple
        cap = (max_extent // multiple) * multiple
        w, h = min(w, cap), min(h, cap)
    return (w, h)


class GraphCache:
    """Lazily built forwards per key (reference compute_graph + the
    per-model 'rebuild if extent changed' logic in vision.cpp)."""

    def __init__(self, build: Callable[..., Callable], max_entries: int = 8):
        if max_entries < 1:
            raise_error("GraphCache needs max_entries >= 1, got {}", max_entries)
        self._build = build
        self._cache: dict[Hashable, Callable] = {}
        self._max = max_entries

    def get(self, key: Hashable, *build_args, **build_kwargs) -> Callable:
        fn = self._cache.pop(key, None)
        if fn is None:
            fn = self._build(*build_args, **build_kwargs)
            # evict AFTER a successful build (a failed build must not cost
            # an entry), oldest-used first (re-insertion keeps recency)
            if len(self._cache) >= self._max:
                self._cache.pop(next(iter(self._cache)))
        self._cache[key] = fn
        return fn

    def clear(self) -> None:
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)


_tls = threading.local()
# CUDA graphs may be captured one at a time in a process (torch.cuda.graph)
_capture_lock = threading.Lock()


def device_cache(maxsize: int):
    """``lru_cache(maxsize)`` for a function that builds a constant tensor
    (or a tuple of them) on a device from hashable arguments. A CUDA graph
    reads such a tensor at the address it had during capture, so while this
    thread captures one, every result the function returns is also kept by
    the graph: an entry the cache evicts later is not freed under it. The
    function runs outside inference mode, so a constant first made by a
    served forward (under ``torch.inference_mode``) can later be saved for
    the backward of a training forward. Under a fake-tensor trace
    (``torch.export``, ``utils/flops.py``) the function runs uncached, so no
    fake tensor lands in the cache."""

    def wrap(fn):
        def build(*args):
            with torch.inference_mode(False):
                return fn(*args)

        cached = lru_cache(maxsize)(build)

        @wraps(fn)
        def get(*args):
            if detect_fake_mode() is not None:
                # a fake-tensor trace (torch.export, utils/flops.py): the
                # result is built anew, a constant of the trace, never an entry
                return build(*args)
            out = cached(*args)
            kept = getattr(_tls, "kept", None)
            if kept is not None:
                kept.append(out)
            return out

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get

    return wrap


@contextmanager
def _keeping():
    _tls.kept = kept = []
    try:
        yield kept
    finally:
        _tls.kept = None


def _clone(out):
    if isinstance(out, tuple):
        return type(out)(*(t.clone() for t in out))
    return out.clone()


class _Replay:
    """One captured forward: its graph, static input and output tensors, the
    kernel launches its capture recorded and the constants it read."""

    def __init__(self, graph, static_in, static_out, tally, kept):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.tally = tally
        self.kept = kept

    def __call__(self, *args):
        from ..ops.cuda import add_counts

        for s, a in zip(self.static_in, args):
            s.copy_(a, non_blocking=True)
        self.graph.replay()
        add_counts(self.tally)
        # the next replay overwrites the static output: the caller gets a
        # copy, made on the stream after this replay and before the next
        return _clone(self.static_out)


def capture_forward(fn: Callable, args: tuple, device: torch.device, pool, stream) -> _Replay:
    """Capture ``fn(*args)`` on the card into a CUDA graph in memory pool
    ``pool`` and return its replay: a callable that takes tensors of the
    shapes and types of ``args`` (on any device) and returns a copy of the
    forward's output (a tensor or a tuple of tensors).

    The static inputs are allocated here and filled with ``args``. One eager
    forward on ``stream`` warms up first: it builds the kernel library,
    fills the constant caches (``device_cache``) at this exact key, and lets
    cuBLAS and cuDNN choose their algorithms and workspaces, so the capture
    makes no host to device copy and no synchronizing call. A failed capture
    raises; there is no eager fallback. The capture runs on ``stream`` too:
    the caching allocator hands a freed block only to the stream that freed
    it, so the graphs that share ``pool`` reuse each other's free memory
    only when every one of them is captured on the same stream. Its error
    mode is ``thread_local``: servers call the forward from a worker thread
    while other threads of the process may use the card, and only this
    thread's calls can break this capture."""
    with torch.cuda.device(device):
        static_in = [torch.empty(a.shape, dtype=a.dtype, device=device) for a in args]
        for s, a in zip(static_in, args):
            s.copy_(a)
        main = torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            fn(*static_in)
        main.wait_stream(stream)
        from ..ops.cuda import capture_tally

        graph = torch.cuda.CUDAGraph()
        with _capture_lock, capture_tally() as tally, _keeping() as kept:
            with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                static_out = fn(*static_in)
        return _Replay(graph, static_in, static_out, dict(tally), kept)


class ForwardGraphs:
    """A model's forward behind a :class:`GraphCache` keyed on its inputs'
    shapes and types and its flags: on the card one captured CUDA graph per
    key (:func:`capture_forward`), all of the model's graphs in one memory
    pool, captured on one stream, so that a graph reuses what the others
    free (they never run at once); on the CPU the eager forward.

    Calls are serialized by a lock: a replay's static input and output are
    shared by every caller at its key. On a mesh (parallel/) every rank
    keeps its own graphs, keyed on its shard's shapes; the scatter and the
    gather stay outside the replay, and a tp > 1 model runs eagerly."""

    def __init__(self, forward: Callable, device: torch.device, max_entries: int = 8):
        self.forward = forward
        self.device = device
        self.cache = GraphCache(self._build, max_entries)
        self.pool = self.stream = None
        self._lock = threading.Lock()

    def __call__(self, *args: torch.Tensor, **flags):
        key = (tuple((tuple(a.shape), a.dtype) for a in args), tuple(sorted(flags.items())))
        with self._lock, torch.inference_mode():
            return self.cache.get(key, args, flags)(*args)

    def _build(self, args: tuple, flags: dict) -> Callable:
        fn = partial(self.forward, **flags) if flags else self.forward
        if self.device.type != "cuda":
            return fn
        if self.pool is None:
            self.pool, self.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(self.device)
        return capture_forward(fn, args, self.device, self.pool, self.stream)
