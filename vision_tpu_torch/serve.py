"""Batched request serving on one card — a port of vision_tpu/serve.py.

The reference engine is strictly single-request: one image in, one result
out per call (``src/visp/vision.cpp:36-95``). As in the JAX package, request
batching is the scaling axis here: concurrent client requests that share a
shape bucket run as ONE batched forward on the card.

Two layers:

* :class:`BatchServer` — model-agnostic batching queue (a copy of the JAX
  package's; pure Python). Clients ``submit()`` items and get
  ``concurrent.futures.Future`` results; host-side request preparation
  (resize/normalize) runs on a dedicated prep worker pool so ``submit()``
  returns immediately; a batch worker thread drains the queue, groups items
  that share a shape bucket, and runs the supplied batch function.
* :class:`ImageServer` — whole-image serving for
  :class:`~vision_tpu_torch.models.depth_anything.DepthAnythingModel`. The
  other families of the JAX package's servers arrive with their slices.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .image import Image, ImageFormat, image_scale, preprocess_scale_method

__all__ = ["BatchServer", "ServerStats", "ImageServer"]

_LATENCY_WINDOW = 4096  # most recent request latencies kept for percentiles


def _warmup_wait(futures: Sequence[Future], what: str) -> None:
    """Bounded wait on warmup futures, with stderr narration: progress every
    minute, and a clean failure after ``VISP_WARMUP_TIMEOUT`` seconds
    (default 900; the first call builds the kernel library) instead of
    stalling the caller forever. On timeout the server itself stays up."""
    import os
    import sys

    timeout = float(os.environ.get("VISP_WARMUP_TIMEOUT", "900"))
    t0 = time.monotonic()
    for fut in futures:
        while True:
            remaining = timeout - (time.monotonic() - t0)
            if remaining <= 0:
                raise TimeoutError(
                    f"serve: warmup({what}) did not complete within "
                    f"{timeout:.0f}s; the server is still running — retry "
                    "warmup(), raise VISP_WARMUP_TIMEOUT, or serve cold"
                )
            try:
                fut.result(timeout=min(60.0, remaining))
                break
            except FutureTimeoutError:  # not the builtin TimeoutError before 3.11
                print(
                    f"serve: warmup({what}) still warming up after "
                    f"{time.monotonic() - t0:.0f}s",
                    file=sys.stderr, flush=True,
                )


def _deliver_exception(fut: Future, exc: BaseException) -> None:
    """set_exception tolerant of a client having cancelled the Future
    (InvalidStateError from a worker thread would kill the worker)."""
    try:
        fut.set_exception(exc)
    except Exception:
        pass


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    batched_items: int = 0
    _latencies_ms: list = field(default_factory=list, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def occupancy(self) -> float:
        """Mean items per executed batch (NOT a fraction of batch_size)."""
        return self.batched_items / self.batches if self.batches else 0.0

    def _record_latencies(self, lat_ms: Sequence[float]) -> None:
        with self._lock:
            self._latencies_ms.extend(lat_ms)
            if len(self._latencies_ms) > _LATENCY_WINDOW:
                del self._latencies_ms[: -_LATENCY_WINDOW]

    def latency_ms(self, pct: float) -> float:
        """Request latency percentile (submit -> result), in milliseconds."""
        with self._lock:
            if not self._latencies_ms:
                return 0.0
            return float(np.percentile(self._latencies_ms, pct))

    @property
    def p50_latency_ms(self) -> float:
        return self.latency_ms(50.0)

    @property
    def p99_latency_ms(self) -> float:
        return self.latency_ms(99.0)

    def reset(self) -> None:
        """Zero all counters and the latency window — called after warmup so
        multi-minute first-compile latencies and padding-only warmup batches
        don't poison the percentiles a dashboard reads."""
        with self._lock:
            self.requests = 0
            self.batches = 0
            self.batched_items = 0
            self._latencies_ms.clear()


class BatchServer:
    """Group concurrent requests into fixed-size batches for one device program.

    Parameters
    ----------
    fn: called with a list of 1..batch_size items (one shape bucket), must
        return a sequence of per-item results in order. It sees only real
        items — padding to the program's static batch is the adapter's job.
    batch_size: maximum items per call (with a dp mesh, use a multiple of
        the mesh's dp extent so the shard is even).
    max_delay_ms: how long the worker waits for more same-bucket items
        before dispatching a partial batch. Latency/throughput knob.
    bucket_key: items whose key differs are never batched together (use the
        processed input shape — mixed shapes would retrace the program).
    prepare: optional host-side request preparation, run on a worker pool
        of ``prep_workers`` threads so ``submit()`` never blocks on pixel
        math (a client thread doing its own prep would serialize the queue
        and starve the batch window). ``bucket_key`` sees prepared items.
    """

    def __init__(
        self,
        fn: Callable[[list], Sequence],
        batch_size: int = 8,
        max_delay_ms: float = 2.0,
        bucket_key: Callable[[Any], Any] = lambda item: None,
        prepare: Callable[[Any], Any] | None = None,
        prep_workers: int = 4,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._fn = fn
        self.batch_size = batch_size
        self.max_delay = max_delay_ms / 1e3
        self._bucket_key = bucket_key
        self._prepare = prepare
        self._queue: queue.Queue = queue.Queue()
        self._pending: dict[Any, list] = {}
        self._deadlines: dict[Any, float] = {}  # per-bucket batch-window end
        self.stats = ServerStats()
        self._closed = False
        # guards the _closed flag vs. queue writes: nothing may enqueue
        # after the shutdown sentinel or its Future would never resolve
        self._close_lock = threading.Lock()
        self._prep_pool = (
            ThreadPoolExecutor(max_workers=prep_workers, thread_name_prefix="visp-prep")
            if prepare is not None
            else None
        )
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, item) -> Future:
        fut: Future = Future()
        t0 = time.perf_counter()
        with self._close_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if self._prep_pool is not None:
                self._prep_pool.submit(self._prep_task, item, fut, t0)
            else:
                self._queue.put((item, fut, t0))
        with self.stats._lock:
            self.stats.requests += 1
        return fut

    def _prep_task(self, item, fut: Future, t0: float) -> None:
        try:
            prepared = self._prepare(item)
        except BaseException as e:  # noqa: BLE001 — prep failures travel to the caller
            _deliver_exception(fut, e)
            return
        # no lock needed: close() drains this pool BEFORE the sentinel
        self._queue.put((prepared, fut, t0))

    def compute(self, item):
        """Synchronous convenience: submit and wait."""
        return self.submit(item).result()

    def close(self):
        """Drain outstanding requests, then stop the worker."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # in-flight prep tasks still enqueue; wait for them, THEN send the
        # sentinel so no entry can land behind it (its Future would hang)
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=True)
        self._queue.put(None)
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side --------------------------------------------------------

    def _take(self, timeout) -> bool:
        """Move one queue entry into the pending buckets. False = shutdown."""
        try:
            entry = self._queue.get(timeout=timeout)
        except queue.Empty:
            return True
        if entry is None:
            return False
        self._bucket(entry)
        return True

    def _bucket(self, entry) -> None:
        item, fut, _ = entry
        try:
            key = self._bucket_key(item)
        except BaseException as e:  # noqa: BLE001 — a bad key must not kill the worker
            _deliver_exception(fut, e)
            return
        if key not in self._pending:
            self._deadlines[key] = time.monotonic() + self.max_delay
        self._pending.setdefault(key, []).append(entry)

    def _dispatch(self, group: list) -> None:
        # claim each Future (-> RUNNING, after which client cancel() fails);
        # entries whose client already cancelled are dropped — calling
        # set_result on a cancelled Future raises InvalidStateError, which
        # would kill this worker thread and hang every later request
        live = [e for e in group if e[1].set_running_or_notify_cancel()]
        if not live:
            return
        items = [it for it, _, _ in live]
        try:
            results = self._fn(items)
            if len(results) != len(items):
                raise RuntimeError(
                    f"batch fn returned {len(results)} results for {len(items)} items"
                )
        except BaseException as e:  # noqa: BLE001 — failures travel to callers
            for _, fut, _ in live:
                fut.set_exception(e)
            return
        with self.stats._lock:
            self.stats.batches += 1
            self.stats.batched_items += len(items)
        done = time.perf_counter()
        for (_, fut, _), res in zip(live, results):
            fut.set_result(res)
        self.stats._record_latencies([(done - t0) * 1e3 for _, _, t0 in live])

    def _drain_queue(self) -> None:
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                return
            if entry is not None:
                self._bucket(entry)

    def _run(self) -> None:
        alive = True
        while alive or self._pending:
            if alive:
                # wake by the soonest bucket deadline (each bucket keeps its
                # OWN max_delay window: one bucket filling must not flush a
                # partial sibling that is still collecting requests)
                timeout = 0.05
                if self._pending:
                    soonest = min(self._deadlines[k] for k in self._pending)
                    timeout = min(max(soonest - time.monotonic(), 0.0), 0.05)
                alive = self._take(timeout=timeout)
                if not alive:
                    self._drain_queue()
            now = time.monotonic()
            for key in list(self._pending):
                bucket = self._pending[key]
                if alive and len(bucket) < self.batch_size and now < self._deadlines[key]:
                    continue  # inside its batch window and not full
                del self._pending[key]
                self._deadlines.pop(key, None)
                for i in range(0, len(bucket), self.batch_size):
                    self._dispatch(bucket[i : i + self.batch_size])


def _dummy_image(extent):
    """Zero image for server warmup requests (extent = (width, height))."""
    w, h = extent
    return Image(np.zeros((h, w, 4), np.uint8), ImageFormat.rgba_u8)


# the JAX package's ImageServer families that wait for their slices
_LATER_SLICES = {"BirefnetModel": "BiRefNet", "MiganModel": "MI-GAN"}


class ImageServer:
    """Batched serving for the whole-image model families; in the port so
    far, :class:`~vision_tpu_torch.models.depth_anything.DepthAnythingModel`.

    N concurrent requests at one processed extent run as ONE batched
    forward (the reference handles this family strictly one request at a
    time, ``vision.cpp:137-168``). A request is an
    :class:`~vision_tpu_torch.image.Image`; the result is the min-max
    normalized depth at the request's own extent. Every group is padded to
    ``batch_size`` with its first item, so each extent bucket runs one
    batch shape.
    """

    def __init__(
        self,
        model,
        batch_size: int = 4,
        max_delay_ms: float = 2.0,
        prep_workers: int = 2,
        max_pixels: int = 4 * 1024 * 1024,
    ):
        kind = type(model).__name__
        if kind in _LATER_SLICES:
            raise TypeError(
                f"ImageServer does not serve {kind} yet: it arrives with the port's "
                f"{_LATER_SLICES[kind]} slice"
            )
        if kind != "DepthAnythingModel":
            raise TypeError(f"ImageServer does not support {kind}")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.model = model
        self.batch_size = batch_size
        # depth-anything snaps its processed extent UP from the input, so an
        # unguarded huge upload would run a one-off giant batch
        self.max_pixels = max_pixels
        self._server = BatchServer(
            self._run_group,
            batch_size=batch_size,
            max_delay_ms=max_delay_ms,
            bucket_key=lambda it: it[0].shape,
            prepare=self._prepare,
            prep_workers=prep_workers,
        )

    # prepared item = (u8 input array, processed extent, original request)
    def _prepare(self, image):
        from .models.depth_anything import depthany_image_extent

        if image.width * image.height > self.max_pixels:
            raise ValueError(
                f"input {image.width}x{image.height} exceeds the server's "
                f"max_pixels ({self.max_pixels}); resize client-side or raise the cap"
            )
        extent = depthany_image_extent(image.extent, self.model.p)
        img = image if image.extent == extent else image_scale(image, extent, preprocess_scale_method())
        return (img.to_rgb_u8(), extent, image)

    def _run_group(self, items: list):
        from .models.depth_anything import depthany_process_output

        n = len(items)
        padded = items + [items[0]] * (self.batch_size - n)
        x = torch.from_numpy(np.stack([it[0] for it in padded]))
        y = self.model.forward_u8(x)[:n].float().cpu().numpy()
        return [depthany_process_output(yi, it[2].extent) for yi, it in zip(y, items)]

    def warmup(self, extent=None) -> None:
        """Run one padded batch before taking traffic (the first launch
        builds the kernel library). Default extent: the model's own snap
        target, image_size squared."""
        if extent is None:
            size = self.model.p.image_size
            extent = (size, size)
        _warmup_wait([self.submit(_dummy_image(extent))], f"{type(self.model).__name__} {extent}")
        self.stats.reset()

    def submit(self, request) -> Future:
        return self._server.submit(request)

    def compute(self, request):
        return self.submit(request).result()

    @property
    def stats(self) -> ServerStats:
        return self._server.stats

    def close(self):
        self._server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
