"""Batched request serving on one card or a dp mesh — a port of
vision_tpu/serve.py.

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
  :class:`~vision_tpu_torch.models.depth_anything.DepthAnythingModel`,
  :class:`~vision_tpu_torch.models.birefnet.BirefnetModel` and
  :class:`~vision_tpu_torch.models.migan.MiganModel` (``(image, mask)``
  requests).
* :class:`SamServer` — promptable segmentation on a
  :class:`~vision_tpu_torch.models.mobile_sam.SamModel`: each group is encoded
  and decoded in one eager pass on the card.
* :class:`EsrganServer` — whole-image super-resolution on an
  :class:`~vision_tpu_torch.models.esrgan.EsrganModel`: each same-extent
  group is one batched RRDBNet forward.
* :class:`YoloServer` — object detection on a
  :class:`~vision_tpu_torch.models.yolov9t.Yolov9tModel`: the letterboxed
  group is one forward with the top-K candidate extraction on the card, NMS
  on the host per request.

With a model built on a mesh (parallel/), the grouped batch additionally
splits over cards through the model's entry points: rank 0 runs the
server and scatters each group over the mesh's dp axis, the other ranks
follow (parallel/runner.py), so N cards serve N times the batch in one
call. Batch sizes then default to the per-card default times dp, and
groups always pad to the full batch, so every shard is even.
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

__all__ = ["BatchServer", "ServerStats", "ImageServer", "SamServer", "EsrganServer", "YoloServer"]

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


def _dummy_image(extent=(64, 64)):
    """Zero image for server warmup requests (extent = (width, height))."""
    w, h = extent
    return Image(np.zeros((h, w, 4), np.uint8), ImageFormat.rgba_u8)


def _resolve_batch(batch_size: int | None, per_chip_default: int, mesh=None) -> int:
    """A server's batch size: None takes the family's per-card default,
    scaled by the mesh's dp extent so every card keeps its shard; an
    explicit value must divide evenly over the dp axis (the JAX package's
    ``_resolve_batch``)."""
    dp = mesh.size(0) if mesh is not None else 1
    if batch_size is None:
        return per_chip_default * dp
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if batch_size % dp:
        raise ValueError(f"batch_size {batch_size} not divisible by mesh dp={dp}")
    return batch_size


_IMAGE_FAMILIES = ("BirefnetModel", "DepthAnythingModel", "MiganModel")


class ImageServer:
    """Batched serving for the whole-image model families:
    :class:`~vision_tpu_torch.models.depth_anything.DepthAnythingModel`,
    :class:`~vision_tpu_torch.models.birefnet.BirefnetModel` and
    :class:`~vision_tpu_torch.models.migan.MiganModel`.

    N concurrent requests at one processed extent run as ONE batched
    forward (the reference handles these families strictly one request at a
    time, ``vision.cpp:97-205``). A request is an
    :class:`~vision_tpu_torch.image.Image`; MI-GAN takes ``(image, mask)``.
    The result, at the request's own extent, is the min-max normalized depth
    (``alpha_f32``) for Depth-Anything, the ``alpha_u8`` matte for BiRefNet
    and the inpainted ``rgba_u8`` image with the mask as alpha for MI-GAN.
    Every group is padded to ``batch_size`` with its first item, so each
    extent bucket runs one batch shape.
    """

    def __init__(
        self,
        model,
        batch_size: int | None = 4,
        max_delay_ms: float = 2.0,
        prep_workers: int = 2,
        max_pixels: int = 4 * 1024 * 1024,
    ):
        kind = type(model).__name__
        if kind not in _IMAGE_FAMILIES:
            raise TypeError(f"ImageServer does not support {kind}")
        batch_size = _resolve_batch(batch_size, 4, getattr(model, "mesh", None))
        self.model = model
        self.kind = kind
        self.batch_size = batch_size
        # depth-anything snaps its processed extent UP from the input, so an
        # unguarded huge upload would run a one-off giant batch; birefnet and
        # migan resize to fixed extents but still pay host-side prep
        # proportional to the upload
        self.max_pixels = max_pixels
        self._server = BatchServer(
            self._run_group,
            batch_size=batch_size,
            max_delay_ms=max_delay_ms,
            bucket_key=lambda it: it[0].shape,
            prepare=self._prepare,
            prep_workers=prep_workers,
        )

    # prepared item = (u8 input array [, u8 mask array], processed extent, original request)
    def _prepare(self, request):
        image = request[0] if isinstance(request, tuple) else request
        if image.width * image.height > self.max_pixels:
            raise ValueError(
                f"input {image.width}x{image.height} exceeds the server's "
                f"max_pixels ({self.max_pixels}); resize client-side or raise the cap"
            )
        if self.kind == "MiganModel":
            from .models.migan import _mask_u8

            image, mask = request
            res = (self.model.p.resolution, self.model.p.resolution)
            # reduce to RGB BEFORE any resize: stb's resize premultiplies
            # alpha, and a request's alpha channel is not MI-GAN's mask;
            # premultiplying would black out the region to keep
            if image.channels == 4:
                image = Image(image.to_rgb_u8(), ImageFormat.rgb_u8)
            img_r = image if image.extent == res else image_scale(image, res, preprocess_scale_method())
            mask_r = mask if mask.extent == res else image_scale(mask, res, preprocess_scale_method())
            return (img_r.to_rgb_u8(), _mask_u8(mask_r.data), res, request)
        if self.kind == "BirefnetModel":
            from .models.birefnet import birefnet_image_extent

            extent = birefnet_image_extent(image.extent, self.model.p, self.model.device.max_alloc)
        else:
            from .models.depth_anything import depthany_image_extent

            extent = depthany_image_extent(image.extent, self.model.p)
        img = image if image.extent == extent else image_scale(image, extent, preprocess_scale_method())
        return (img.to_rgb_u8(), extent, image)

    def _run_group(self, items: list):
        n = len(items)
        padded = items + [items[0]] * (self.batch_size - n)
        x = torch.from_numpy(np.stack([it[0] for it in padded]))
        if self.kind == "MiganModel":
            from .models.migan import migan_process_output

            m = torch.from_numpy(np.stack([it[1] for it in padded]))
            y = self.model.forward_u8(x, m)[:n].float().cpu().numpy()
            return [migan_process_output(yi, img, mask) for yi, (_, _, _, (img, mask)) in zip(y, items)]
        if self.kind == "BirefnetModel":
            from .models.birefnet import birefnet_process_output as post
        else:
            from .models.depth_anything import depthany_process_output as post
        y = self.model.forward_u8(x)[:n].float().cpu().numpy()
        return [post(yi, it[2].extent) for yi, it in zip(y, items)]

    def warmup(self, extent=None) -> None:
        """Run one padded batch before taking traffic (the first launch
        builds the kernel library). Default extent: the model's canonical
        inference size (BiRefNet's ``p.image_extent``; Depth-Anything's own
        snap target, image_size squared); MI-GAN warms its resolution with
        a zero mask."""
        if self.kind == "MiganModel":
            res = (self.model.p.resolution, self.model.p.resolution)
            mask = Image(np.zeros((res[1], res[0], 1), np.uint8), ImageFormat.alpha_u8)
            _warmup_wait([self.submit((_dummy_image(res), mask))], "migan")
            self.stats.reset()
            return
        if extent is None:
            if self.kind == "BirefnetModel":
                extent = self.model.p.image_extent
            else:
                size = self.model.p.image_size
                extent = (size, size)
        _warmup_wait([self.submit(_dummy_image(extent))], f"{self.kind} {extent}")
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


class SamServer:
    """Concurrent promptable segmentation on a SamModel.

    Each request is ``(image, prompt)`` where prompt is a 2-tuple point or a
    ``((x0, y0), (x1, y1))`` box (the reference prompt forms,
    ``vision.cpp:54-95``). Requests are grouped (points and boxes bucket
    separately: they run different prompt encoders), and the whole group is
    encoded and decoded in one pass: the JAX package's ``vmap`` over
    (embedding, prompt) is the batch dimension written out, the best mask of
    each request is chosen on the card, and one f32 mask per request crosses
    to the host. Groups are padded to ``batch_size`` with their first item,
    so the card sees one batch shape. Host-side preparation (the 1024² resize
    and the coordinate transform) runs on the BatchServer's prep pool.
    """

    def __init__(
        self,
        model,
        # 6: the JAX package's default, kept for API parity; this card's own
        # operating point waits for the port's benchmark
        batch_size: int | None = 6,
        max_delay_ms: float = 2.0,
        prep_workers: int = 4,
    ):
        if type(model).__name__ != "SamModel":
            raise TypeError(f"SamServer serves a SamModel, got {type(model).__name__}")
        batch_size = _resolve_batch(batch_size, 6, getattr(model, "mesh", None))
        self.model = model
        self.batch_size = batch_size
        self._server = BatchServer(
            self._run_group,
            batch_size=batch_size,
            max_delay_ms=max_delay_ms,
            bucket_key=lambda item: item[1],  # prompt kind
            prepare=self._prepare,
            prep_workers=prep_workers,
        )

    # raw request = (image, point, box); prepared = (x, kind, coords, extent)
    def _prepare(self, request):
        from .models.mobile_sam import sam_process_box, sam_process_input_u8, sam_process_point

        image, point, box = request
        x = sam_process_input_u8(image, self.model.p)
        if point is not None:
            kind, coords = "point", sam_process_point(point, image.extent, self.model.p)
        else:
            kind, coords = "box", sam_process_box(box[0], box[1], image.extent, self.model.p)
        return (x, kind, coords, image.extent)

    def _run_group(self, items: list):
        from .models.mobile_sam import sam_process_mask

        kind = items[0][1]
        n = len(items)
        padded = items + [items[0]] * (self.batch_size - n)
        x = torch.from_numpy(np.stack([it[0] for it in padded]))
        coords = np.stack([it[2] for it in padded])
        masks = self.model.serve_masks(x, coords, kind)[:n].cpu().numpy()  # (n, 256, 256)
        return [sam_process_mask(masks[i][None], 0, it[3], self.model.p) for i, it in enumerate(items)]

    def warmup(self, kinds=("point", "box")) -> None:
        """Run one padded group of each prompt kind before taking traffic
        (the first launch builds the kernel library)."""
        img = _dummy_image((64, 64))
        futs = []
        for kind in kinds:
            if kind == "point":
                futs.append(self.submit(img, point=(32, 32)))
            else:
                futs.append(self.submit(img, box=((8, 8), (56, 56))))
        _warmup_wait(futs, f"sam {'+'.join(kinds)}")
        self.stats.reset()

    def submit(self, image, point=None, box=None) -> Future:
        if (point is None) == (box is None):
            raise ValueError("exactly one of point/box must be given")
        return self._server.submit((image, point, box))

    def compute(self, image, point=None, box=None):
        return self.submit(image, point=point, box=box).result()

    @property
    def stats(self) -> ServerStats:
        return self._server.stats

    def close(self):
        self._server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EsrganServer:
    """Concurrent whole-image super-resolution on an EsrganModel.

    Requests are :class:`~vision_tpu_torch.image.Image` instances; same-extent
    images batch into ONE forward on the card (the reference runs a
    sequential per-tile loop, ``vision.cpp:240-251``; here N requests of one
    extent are a single batched RRDBNet call, and mixed extents bucket
    separately). A partial group is padded with copies of its first item
    and the padding is sliced off on the card, before the copy to the host.
    Results are ``rgba_u8`` at scale times the request's extent, alpha 255.
    Serving-size inputs only: a request past ``max_pixels`` raises, and
    large images go through ``EsrganModel.compute``'s tiled path instead.
    """

    def __init__(
        self,
        model,
        # 4: whole-image RRDBNet batches grow memory linearly, and 4 keeps
        # the 1024^2 bucket inside the card (the JAX package's default)
        batch_size: int | None = 4,
        max_delay_ms: float = 2.0,
        prep_workers: int = 2,
        max_pixels: int = 1024 * 1024,
    ):
        if type(model).__name__ != "EsrganModel":
            raise TypeError(f"EsrganServer serves an EsrganModel, got {type(model).__name__}")
        batch_size = _resolve_batch(batch_size, 4, getattr(model, "mesh", None))
        self.model = model
        self.batch_size = batch_size
        self.max_pixels = max_pixels
        self._server = BatchServer(
            self._run_group,
            batch_size=batch_size,
            max_delay_ms=max_delay_ms,
            bucket_key=lambda item: item[1],  # image extent
            prepare=self._prepare,
            prep_workers=prep_workers,
        )

    # raw request = Image; prepared = (rgb_u8 array, extent)
    def _prepare(self, image):
        w, h = image.extent
        if w * h > self.max_pixels:
            raise ValueError(
                f"image {image.extent} exceeds the whole-image serving limit "
                f"({self.max_pixels} px); use EsrganModel.compute's tiled path"
            )
        return (image.to_rgb_u8(), image.extent)

    def _run_group(self, items: list):
        n = len(items)
        padded = items + [items[0]] * (self.batch_size - n)
        x = torch.from_numpy(np.stack([it[0] for it in padded]))
        y = self.model.forward_u8(x)[:n].cpu().numpy()
        alpha = np.full((*y.shape[1:3], 1), 255, np.uint8)
        return [
            Image(np.ascontiguousarray(np.concatenate([yi, alpha], axis=2)), ImageFormat.rgba_u8)
            for yi in y
        ]

    def warmup(self, extent=(256, 256)) -> None:
        """Run one padded batch at ``extent`` before taking traffic (the
        first launch builds the kernel library), then reset the stats."""
        _warmup_wait([self.submit(_dummy_image(extent))], f"esrgan {extent}")
        self.stats.reset()

    def submit(self, image) -> Future:
        return self._server.submit(image)

    def compute(self, image):
        return self.submit(image).result()

    @property
    def stats(self) -> ServerStats:
        return self._server.stats

    def close(self):
        self._server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class YoloServer:
    """Concurrent object detection on a Yolov9tModel.

    Every request letterboxes to the model's square input size, so all
    requests share one bucket and one batch shape; the group runs as one
    forward (the detection DAG on the card), then the candidate extraction
    on the card: per image, the top-K anchors by their best class score
    (``torch.topk``), their indices sorted back into anchor order (NMS
    breaks score ties by candidate order, which must match the unbatched
    ``compute``), and their boxes and scores gathered, so only K x (4 + nc)
    floats an image cross to the host. NMS and the box un-letterbox run on
    the host per request, with per-request thresholds. Results are lists of
    :class:`~vision_tpu_torch.models.yolov9t.Detection`.

    Where scores tie at the K-th place, ``torch.topk`` and the JAX package's
    ``jax.lax.top_k`` may keep different anchors; K bounds the candidates
    NMS sees, so with very low ``conf_thres`` (below ~0.05) raise
    ``max_candidates``.
    """

    def __init__(self, model, batch_size: int | None = 8, max_delay_ms: float = 2.0, prep_workers: int = 2,
                 conf_thres: float = 0.25, iou_thres: float = 0.45, max_candidates: int = 1024):
        if type(model).__name__ != "Yolov9tModel":
            raise TypeError(f"YoloServer serves a Yolov9tModel, got {type(model).__name__}")
        # 8: YOLOv9t at 640 is small enough that deeper batches amortize the
        # launches without memory pressure (the JAX package's default)
        batch_size = _resolve_batch(batch_size, 8, getattr(model, "mesh", None))
        self.model = model
        self.batch_size = batch_size
        self.conf_thres = conf_thres
        self.iou_thres = iou_thres
        n_anchors = sum((model.p.input_size // st) ** 2 for st in (8, 16, 32))
        self.k = min(max_candidates, n_anchors)
        self._server = BatchServer(
            self._run_group,
            batch_size=batch_size,
            max_delay_ms=max_delay_ms,
            bucket_key=lambda it: it[0].shape,
            prepare=self._prepare,
            prep_workers=prep_workers,
        )

    def candidates(self, x_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The batched forward and the top-K extraction on the card: (B, K, 4)
        boxes and (B, K, nc) scores, f32, anchors in their order."""
        out = self.model.forward_u8(x_u8)
        with torch.inference_mode():
            idx = torch.topk(out.scores.amax(dim=-1), self.k, dim=-1).indices.sort(dim=-1).values
            boxes = torch.gather(out.boxes, 1, idx[..., None].expand(-1, -1, out.boxes.shape[-1]))
            scores = torch.gather(out.scores, 1, idx[..., None].expand(-1, -1, out.scores.shape[-1]))
        return boxes, scores

    # request = image | (image, conf, iou); prepared item =
    # (letterboxed u8 array, (original extent, gain, dw, dh), conf, iou)
    def _prepare(self, request):
        from .models.yolov9t import letterbox

        conf, iou = self.conf_thres, self.iou_thres
        if isinstance(request, tuple):
            request, conf, iou = request
        arr, gain, dw, dh = letterbox(request, self.model.p.input_size)
        return (arr, (request.extent, gain, dw, dh), conf, iou)

    def _run_group(self, items: list):
        from .models.yolov9t import non_max_suppression, scale_boxes

        n = len(items)
        padded = items + [items[0]] * (self.batch_size - n)
        b_dev, s_dev = self.candidates(torch.from_numpy(np.stack([it[0] for it in padded])))
        boxes, scores = b_dev[:n].cpu().numpy(), s_dev[:n].cpu().numpy()
        results = []
        for b, s, (_, (extent, gain, dw, dh), conf, iou) in zip(boxes, scores, items):
            results.append(scale_boxes(non_max_suppression(b, s, conf, iou), extent, gain, dw, dh))
        return results

    def warmup(self) -> None:
        """Run one padded batch before taking traffic (the first launch
        builds the kernel library; letterbox gives every request the same
        bucket), then reset the stats."""
        _warmup_wait([self.submit(_dummy_image())], "yolov9t")
        self.stats.reset()

    def submit(self, image, conf_thres=None, iou_thres=None) -> Future:
        """Per-request thresholds override the server's (NMS runs on the host
        per request, so mixed thresholds batch together)."""
        if conf_thres is None and iou_thres is None:
            return self._server.submit(image)
        return self._server.submit((
            image,
            self.conf_thres if conf_thres is None else conf_thres,
            self.iou_thres if iou_thres is None else iou_thres,
        ))

    def compute(self, image, conf_thres=None, iou_thres=None):
        return self.submit(image, conf_thres, iou_thres).result()

    @property
    def stats(self) -> ServerStats:
        return self._server.stats

    def close(self):
        self._server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
