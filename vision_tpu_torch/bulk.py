"""Bulk (offline directory) inference through the batched serving layer, the
port of vision_tpu/bulk.py.

``python -m vision_tpu_torch.cli <family> -i <dir> -o <dir>`` routes here:
every image in the input directory is submitted to the family's batching
server (``serve.py``), so same-extent images run as ONE batched forward (a
CUDA graph replay on the card) per group at the family's default batch (sam
6, esrgan/birefnet/depthany/migan 4, yolo 8). Decode of image N+k overlaps
the card's work on earlier groups through a bounded submit-ahead window, so
host IO never serializes with the card.

The reference CLI is strictly one image per invocation
(``src/cli/cli.cpp`` main flow — single -i/-o pair); this subsystem is
the serving layer re-applied to offline throughput, with the same
shape-bucketing.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from pathlib import Path
from typing import Sequence

import numpy as np

from .core.errors import raise_error

__all__ = ["bulk_inputs", "bulk_run", "pair_masks"]

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".gif")


def bulk_inputs(path: str | os.PathLike) -> list[str]:
    """Sorted image files directly inside ``path`` (non-recursive)."""
    p = Path(path)
    if not p.is_dir():
        raise_error("bulk: '{}' is not a directory", path)
    out = sorted(
        str(f) for f in p.iterdir()
        if f.is_file() and f.suffix.lower() in _IMG_EXTS
    )
    if not out:
        raise_error("bulk: no images ({}) in '{}'", "/".join(_IMG_EXTS), path)
    return out


def pair_masks(images: Sequence[str], mask_dir: str) -> list[tuple[str, str]]:
    """Match every image to the same-stem file in ``mask_dir``."""
    masks = {Path(m).stem: m for m in bulk_inputs(mask_dir)}
    pairs = []
    for img in images:
        stem = Path(img).stem
        if stem not in masks:
            raise_error("bulk: no mask named '{}.*' in '{}'", stem, mask_dir)
        pairs.append((img, masks[stem]))
    return pairs


def _save(result, dst: Path) -> None:
    """PNG-save a server result Image (float payloads -> u8, the
    serve_http._png_bytes conversion)."""
    from .image import Image, ImageFormat, image_save
    from .image.image import result_u8

    if np.issubdtype(np.asarray(result.data).dtype, np.floating):  # e.g. depthany alpha_f32
        a = result_u8(result.data)
        fmt = {1: ImageFormat.alpha_u8, 3: ImageFormat.rgb_u8, 4: ImageFormat.rgba_u8}
        result = Image(np.ascontiguousarray(a), fmt[a.shape[2]])
    image_save(result, dst)


def bulk_run(
    model,
    inputs: Sequence,
    out_dir: str | os.PathLike,
    prompt: Sequence[int] | None = None,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    batch_size: int | None = None,
    max_delay_ms: float = 200.0,
    log=print,
) -> list[str]:
    """Run every input through the model family's batching server.

    ``inputs``: image paths (MI-GAN: ``(image, mask)`` path pairs). Every
    output is written to ``out_dir`` under the input's stem as PNG; YOLO
    additionally writes one ``detections.json`` mapping each stem to its
    boxes. ``prompt`` (SAM): 2 ints = point / 4 = box applied to every
    image; default is each image's center point. Per-item failures (e.g.
    an image over EsrganServer's whole-image limit) are logged and
    skipped — raising only if NOTHING succeeded. Returns the written
    paths.

    The submit-ahead window is bounded (4 groups deep), so arbitrarily
    large directories stream at constant host memory. ``max_delay_ms``
    defaults much higher than serving's 2 ms: offline throughput wants
    full groups, not low per-request latency, and the window only costs
    idle time on the final partial group of each shape bucket. The model
    runs on the device it was loaded on.
    """
    from .image import image_load

    kind = type(model).__name__
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    # family dispatch: server + submit(request paths) -> Future; finish
    # turns a resolved result into the written file, fail cleans up any
    # per-item state when a future/finish errored
    def finish(res, stem):  # default: PNG under the input's stem
        dst = out / f"{stem}.png"
        _save(res, dst)
        return str(dst)

    def fail(stem):
        pass

    detections: dict[str, list] = {}
    if kind == "SamModel":
        from .serve import SamServer

        server = SamServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms)

        def submit(path):
            img = image_load(path)
            if prompt and len(prompt) >= 4:
                return server.submit(img, box=((prompt[0], prompt[1]), (prompt[2], prompt[3])))
            if prompt:
                return server.submit(img, point=(prompt[0], prompt[1]))
            return server.submit(img, point=(img.width // 2, img.height // 2))

    elif kind == "EsrganModel":
        from .serve import EsrganServer

        server = EsrganServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms)

        def submit(path):
            return server.submit(image_load(path))

    elif kind in ("BirefnetModel", "DepthAnythingModel", "MiganModel"):
        from .serve import ImageServer

        server = ImageServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms)

        def submit(path):
            if kind == "MiganModel":
                img_path, mask_path = path
                return server.submit((image_load(img_path), image_load(mask_path)))
            return server.submit(image_load(path))

    elif kind == "Yolov9tModel":
        from .models.yolov9t import COCO_CLASS_NAMES, draw_detections
        from .serve import YoloServer

        server = YoloServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms,
                            conf_thres=conf_thres, iou_thres=iou_thres)
        originals: dict[str, object] = {}

        def submit(path):
            img = image_load(path)
            originals[Path(path).stem] = img
            return server.submit(img)

        def finish(dets, stem):
            # write the annotation FIRST: an image only appears in
            # detections.json if its output file exists
            dst = out / f"{stem}.png"
            _save(draw_detections(originals.pop(stem), dets), dst)
            detections[stem] = [
                {
                    "class": COCO_CLASS_NAMES[d.class_id]
                    if d.class_id < len(COCO_CLASS_NAMES) else str(d.class_id),
                    "confidence": round(float(d.confidence), 4),
                    "box": [round(float(v), 1) for v in (d.x1, d.y1, d.x2, d.y2)],
                }
                for d in dets
            ]
            return str(dst)

        def fail(stem):  # don't let failed items pin their decoded image
            originals.pop(stem, None)
            detections.pop(stem, None)

    else:
        raise_error("bulk: unsupported model type '{}'", kind)

    written: list[str] = []
    failures = 0
    window = 4 * server.batch_size
    pending: deque = deque()  # (stem, input repr, future)
    t0 = time.perf_counter()

    def drain_one():
        nonlocal failures
        stem, src, fut = pending.popleft()
        try:
            written.append(finish(fut.result(), stem))
        except Exception as e:  # per-item: log + continue
            failures += 1
            fail(stem)
            log(f"  FAILED {src}: {e}")

    # validate the whole plan BEFORE any work: pure path checks, so a bad
    # plan fails fast instead of mid-run with results half-written
    seen_stems: set[str] = set()
    for item in inputs:
        src = item[0] if isinstance(item, tuple) else item
        stem = Path(src).stem
        if stem in seen_stems:
            # a.png + a.jpg would both write out/a.png (and cross the
            # YOLO per-stem state) — refuse rather than silently clobber
            raise_error("bulk: duplicate input stem '{}' ('{}')", stem, src)
        seen_stems.add(stem)
        dst = out / f"{stem}.png"
        if dst.resolve() == Path(src).resolve():
            raise_error("bulk: output '{}' would overwrite its input", dst)

    try:
        for item in inputs:
            src = item[0] if isinstance(item, tuple) else item
            stem = Path(src).stem
            try:
                pending.append((stem, src, submit(item)))
            except Exception as e:  # e.g. a corrupt image failing decode
                failures += 1
                fail(stem)
                log(f"  FAILED {src}: {e}")
            while len(pending) >= window:
                drain_one()
        while pending:
            drain_one()
    finally:
        server.close()

    wall = time.perf_counter() - t0
    n = len(written)
    if n == 0:
        raise_error("bulk: all {} inputs failed", failures)
    occ = server.stats.occupancy
    log(f"  {n} images in {wall:.1f}s ({n / wall:.2f} img/s"
        f"{f', {failures} failed' if failures else ''}"
        f", occupancy {occ:.2f}/{server.batch_size})")
    if detections:
        (out / "detections.json").write_text(json.dumps(detections, indent=1))
        written.append(str(out / "detections.json"))
    return written
