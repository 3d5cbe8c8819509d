"""Video inference through the batched serving layer, the port of
vision_tpu/video.py.

``python -m vision_tpu_torch.cli <family> -i clip.mp4 -o out.mp4`` routes
here: frames are decoded (OpenCV), streamed through the family's batching
server (``serve.py``) with a bounded submit-ahead window — so decode of
frame N+k overlaps the card's work on earlier groups, and every group runs
as ONE batched forward at the family's default batch — and the results are
encoded back into a video at the source frame rate. Since every frame of a
clip has the same extent, the whole video lands in a single shape bucket
(one CUDA graph on the card): the best-case workload for the batching
design.

Per family the output video is: sam / birefnet — the mask (grayscale);
depthany — normalized depth (grayscale); migan — the inpainted frames
(one static mask applied to every frame: the watermark/logo-removal
use case); esrgan — the upscaled frames; yolov9t — annotated frames
(plus per-frame detections returned / written as JSON by the CLI).

The reference has no video path (its CLI is one image per invocation,
``src/cli/cli.cpp``); this subsystem is the serving layer re-applied to
frame streams. OpenCV is an optional dependency: it is imported only where
a video is read or written, everything here raises a clear error when it is
missing, and nothing else imports it.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from pathlib import Path
from typing import Sequence

import numpy as np

from .core.errors import raise_error

__all__ = ["VIDEO_EXTS", "is_video", "VideoReader", "VideoWriter", "video_run"]

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v")

# container -> preferred fourcc (fallbacks tried in order)
_FOURCC = {
    ".avi": ("MJPG", "mp4v"),
    ".webm": ("VP80", "mp4v"),
}
_DEFAULT_FOURCC = ("mp4v", "MJPG")


def is_video(path: str | os.PathLike) -> bool:
    return Path(path).suffix.lower() in VIDEO_EXTS


def _cv2():
    try:
        import cv2
    except ImportError:
        raise_error(
            "video: OpenCV (cv2) is required for video decode/encode and is "
            "not installed — install opencv-python, or extract frames to a "
            "directory and use bulk mode instead"
        )
    return cv2


class VideoReader:
    """Iterate a video file as rgb_u8 ``Image`` frames.

    ``fps`` / ``extent`` (width, height) / ``frame_count`` come from the
    container metadata; ``frame_count`` can be 0 when the container does
    not declare it — iteration is the source of truth.
    """

    def __init__(self, path: str | os.PathLike):
        cv2 = _cv2()
        self.path = str(path)
        if not Path(path).is_file():
            raise_error("video: '{}' is not a file", path)
        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            raise_error("video: cannot open '{}' (unsupported codec/container?)", path)
        # containers can report 0 or NaN fps (NaN is truthy, so a bare
        # `or 30.0` would pass it through and yield a wrong-speed or
        # unopenable writer) — accept only a finite positive rate
        fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self.fps = fps if math.isfinite(fps) and fps > 0 else 30.0
        self.extent = (
            int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )
        self.frame_count = max(int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT)), 0)

    def __iter__(self):
        from .image import Image, ImageFormat

        while True:
            ok, bgr = self._cap.read()
            if not ok:
                return
            yield Image(np.ascontiguousarray(bgr[:, :, ::-1]), ImageFormat.rgb_u8)

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VideoWriter:
    """Write rgb_u8 frames (``Image`` or (H, W, 3) u8 arrays) to a video."""

    def __init__(self, path: str | os.PathLike, fps: float, extent: tuple[int, int]):
        cv2 = _cv2()
        self.path = str(path)
        self.extent = (int(extent[0]), int(extent[1]))
        self.n_written = 0
        suffix = Path(path).suffix.lower()
        self._writer = None
        for fourcc in _FOURCC.get(suffix, _DEFAULT_FOURCC):
            w = cv2.VideoWriter(
                self.path, cv2.VideoWriter_fourcc(*fourcc), float(fps), self.extent
            )
            if w.isOpened():
                self._writer = w
                break
            w.release()
        if self._writer is None:
            raise_error(
                "video: cannot open writer for '{}' ({}x{} @ {} fps)",
                path, self.extent[0], self.extent[1], fps,
            )

    def write(self, frame) -> None:
        a = np.asarray(getattr(frame, "data", frame))
        a = _to_rgb_u8(a)
        if (a.shape[1], a.shape[0]) != self.extent:
            raise_error(
                "video: frame is {}x{} but the writer was opened at {}x{}",
                a.shape[1], a.shape[0], self.extent[0], self.extent[1],
            )
        ok = self._writer.write(np.ascontiguousarray(a[:, :, ::-1]))  # RGB -> BGR
        # some codec/frame combinations fail silently inside OpenCV; the
        # boolean return is the only signal (None on older builds = unknown)
        if ok is False:
            raise_error(
                "video: encoder rejected frame {} ({}x{}) for '{}'",
                self.n_written, a.shape[1], a.shape[0], self.path,
            )
        self.n_written += 1

    def close(self) -> None:
        self._writer.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _to_rgb_u8(a: np.ndarray) -> np.ndarray:
    """Server result payload -> (H, W, 3) u8: float [0,1] maps to u8
    (the serve_http conversion), 1-channel replicates to gray, alpha is
    dropped."""
    from .image.image import result_u8

    a = result_u8(a)
    if a.shape[2] == 1:
        a = np.repeat(a, 3, axis=2)
    return a[:, :, :3]


def video_run(
    model,
    input_path: str | os.PathLike,
    output_path: str | os.PathLike,
    prompt: Sequence[int] | None = None,
    mask: str | os.PathLike | None = None,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    batch_size: int | None = None,
    max_delay_ms: float = 200.0,
    log=print,
):
    """Stream every frame of ``input_path`` through the model family's
    batching server and encode the results into ``output_path``.

    ``prompt`` (SAM): 2 ints = point / 4 = box applied to every frame
    (default: frame center). ``mask`` (MI-GAN): a mask image applied to
    every frame. YOLO: returns the per-frame detections list (the CLI
    writes it as JSON next to the output video); other families return
    ``None``. Frame order is preserved (FIFO drain over the submit-ahead
    window). A failing frame fails the run — frames of one clip are
    homogeneous, so a failure is systematic, and a video with silently
    dropped frames loses audio/timing alignment.
    """
    from .image import image_load

    kind = type(model).__name__
    out_p = Path(output_path)
    if not is_video(out_p):
        raise_error(
            "video: output '{}' must be a video file ({})",
            output_path, "/".join(VIDEO_EXTS),
        )
    if out_p.resolve() == Path(input_path).resolve():
        raise_error("video: output '{}' would overwrite its input", output_path)

    detections: list[list] | None = None
    finish = None  # (decoded frame, server result) -> writable frame
    if kind == "SamModel":
        from .serve import SamServer

        server = SamServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms)

        def submit(frame):
            if prompt and len(prompt) >= 4:
                return server.submit(frame, box=((prompt[0], prompt[1]), (prompt[2], prompt[3])))
            if prompt:
                return server.submit(frame, point=(prompt[0], prompt[1]))
            return server.submit(frame, point=(frame.width // 2, frame.height // 2))

    elif kind == "EsrganModel":
        from .serve import EsrganServer

        server = EsrganServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms)
        submit = server.submit

    elif kind in ("BirefnetModel", "DepthAnythingModel", "MiganModel"):
        from .serve import ImageServer

        if kind == "MiganModel":
            # validate + load the mask BEFORE constructing the server so a
            # bad argument doesn't leak the worker thread / prep executor
            if mask is None:
                raise_error("video: migan needs a mask image (-i video mask.png)")
            mask_img = image_load(mask)
            server = ImageServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms)

            def submit(frame):
                return server.submit((frame, mask_img))

            def finish(frame, res):
                # the server result is rgba u8 at the frame extent with the
                # inpaint mask as alpha (alpha=255 -> keep region). Image
                # and bulk modes write that PNG as-is, deferring the
                # composite to the consumer; a video frame has no alpha, so
                # composite here: keep the ORIGINAL pixels where the mask
                # says keep, generated pixels in the hole — otherwise the
                # whole frame would be the generator's reconstruction after
                # its fixed-resolution scale round-trip.
                a = np.asarray(res.data)
                m = a[:, :, 3:4].astype(np.float32) / 255.0
                orig = _to_rgb_u8(np.asarray(frame.data)).astype(np.float32)
                out = orig * m + a[:, :, :3].astype(np.float32) * (1.0 - m)
                return np.clip(out + 0.5, 0, 255).astype(np.uint8)

        else:
            server = ImageServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms)
            submit = server.submit

    elif kind == "Yolov9tModel":
        from .models.yolov9t import COCO_CLASS_NAMES, draw_detections
        from .serve import YoloServer

        server = YoloServer(model, batch_size=batch_size, max_delay_ms=max_delay_ms,
                            conf_thres=conf_thres, iou_thres=iou_thres)
        submit = server.submit
        detections = []

        def finish(frame, dets):
            detections.append([
                {
                    "class": COCO_CLASS_NAMES[d.class_id]
                    if d.class_id < len(COCO_CLASS_NAMES) else str(d.class_id),
                    "confidence": round(float(d.confidence), 4),
                    "box": [round(float(v), 1) for v in (d.x1, d.y1, d.x2, d.y2)],
                }
                for d in dets
            ])
            return draw_detections(frame, dets)

    else:
        raise_error("video: unsupported model type '{}'", kind)

    t0 = time.perf_counter()
    writer = None
    n = 0
    try:
        with VideoReader(input_path) as reader:
            window = 4 * server.batch_size
            pending: deque = deque()  # (frame-or-None, future), FIFO = frame order

            def drain_one():
                nonlocal writer, n
                frame, fut = pending.popleft()
                res = fut.result()
                if finish is not None:
                    res = finish(frame, res)
                a = _to_rgb_u8(np.asarray(getattr(res, "data", res)))
                if writer is None:
                    writer = VideoWriter(out_p, reader.fps, (a.shape[1], a.shape[0]))
                writer.write(a)
                n += 1

            for frame in reader:
                # YOLO (annotation) and MI-GAN (composite) keep the decoded
                # frame alive; the window bound keeps that at ~4 groups
                pending.append((frame if finish is not None else None, submit(frame)))
                while len(pending) >= window:
                    drain_one()
            while pending:
                drain_one()
    finally:
        server.close()
        if writer is not None:
            writer.close()

    if n == 0:
        raise_error("video: no frames decoded from '{}'", input_path)
    wall = time.perf_counter() - t0
    occ = server.stats.occupancy
    log(f"  {n} frames in {wall:.1f}s ({n / wall:.2f} fps"
        f", occupancy {occ:.2f}/{server.batch_size})")
    return detections
