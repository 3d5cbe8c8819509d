"""HTTP serving front-end over the batching servers, the port of
vision_tpu/serve_http.py.

A small threaded HTTP server that exposes loaded models over a REST-ish
API, with request batching done by the underlying
:class:`~vision_tpu_torch.serve.BatchServer` machinery — concurrent HTTP
clients whose requests arrive inside one batch window share one forward on
the card.

Endpoints:

* ``POST /v1/sam/mask?x=..&y=..``  (or ``?box=x0,y0,x1,y1``)
  body = image bytes (PNG/JPEG) -> PNG mask (alpha_u8) at the input extent.
* ``POST /v1/esrgan``  body = image bytes -> PNG upscaled image.
* ``POST /v1/birefnet``  body = image bytes -> PNG foreground mask.
* ``POST /v1/depthany``  body = image bytes -> PNG depth map (u8).
* ``POST /v1/migan``  body = RGBA image whose ALPHA channel is the inpaint
  mask (white = region to fill) -> PNG inpainted image.
* ``POST /v1/yolo?conf=..&iou=..``  body = image bytes -> JSON detections
  ``[{box: [x1,y1,x2,y2], confidence, class_id, class_name}, ...]``.
* ``GET  /healthz`` -> JSON: per-model request/batch counts, occupancy,
  p50/p99 request latency.

PNG bodies are decoded and responses encoded by the port's own codec
(image/png.py); other body formats need PIL. A body the port cannot decode
is the client's fault (400), as undecodable bytes are in the JAX package.

Built on http.server (stdlib) — no extra dependencies; each request is
handled on its own thread and blocks on the batch future, so batching
happens naturally across concurrent clients. Handler threads only decode,
wait and encode on the host: every device call, and every copy of a result
to the host, runs on the servers' batch workers.
"""

from __future__ import annotations

import io
import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .core.errors import VispError

__all__ = ["VisionHTTPServer", "serve_forever"]


def _client_error_types():
    # ValueError covers malformed query params and the servers' own request
    # validation (e.g. EsrganServer max_pixels); UnidentifiedImageError is
    # undecodable body bytes. Deliberately NOT broader (KeyError/OSError
    # would misclassify genuine server faults as 400s).
    errs = [ValueError]
    try:
        from PIL import UnidentifiedImageError

        errs.insert(0, UnidentifiedImageError)
    except ImportError:
        pass
    return tuple(errs)


_CLIENT_ERRORS = _client_error_types()

# largest accepted request body; a 64 MP rgba PNG is well under this
MAX_BODY_BYTES = 256 * 1024 * 1024


def _load_image_bytes(data: bytes):
    """A request body as an Image: a PNG by the port's codec (one outside its
    scope through PIL), any other format through PIL. Raises VispError for a
    damaged PNG, or a body that is not PNG when PIL is not installed."""
    from .image import image_load_array
    from .image.png import PNG_SIGNATURE, PngUnsupported, read_png

    if data.startswith(PNG_SIGNATURE):
        try:
            px = read_png(data)
        except PngUnsupported:
            pass
        else:
            if data[25:26] == b"\x04":  # IHDR colour type 4, PIL's "LA": converted to RGB below
                px = np.ascontiguousarray(px[:, :, :3])
            return image_load_array(px)
    try:
        from PIL import Image as PILImage
    except ImportError:
        raise VispError("request body: only PNG is decoded without PIL, and PIL is not installed") from None
    pil = PILImage.open(io.BytesIO(data))
    if pil.mode == "P":
        # palette PNGs: keep a transparency chunk as alpha (image_load's
        # behavior, image/image.py) instead of silently dropping it
        pil = pil.convert("RGBA" if "transparency" in pil.info else "RGB")
    elif pil.mode not in ("RGB", "RGBA", "L"):
        pil = pil.convert("RGB")
    return image_load_array(np.asarray(pil))


def _png_bytes(img) -> bytes:
    from .image.image import result_u8
    from .image.png import encode_png

    return encode_png(result_u8(img.data))


class VisionHTTPServer:
    """Bundle of batching servers behind one HTTP listener.

    Each ``*_model``: a loaded model handle of that family (or None); each
    gets its own BatchServer-based service, on the device the model was
    loaded on.
    """

    def __init__(self, sam_model=None, esrgan_model=None, birefnet_model=None,
                 depthany_model=None, migan_model=None, yolo_model=None,
                 # None -> every service picks its family's default batch
                 # (serve._resolve_batch)
                 batch_size: int | None = None,
                 max_delay_ms: float = 5.0, host: str = "127.0.0.1", port: int = 8000,
                 warmup: bool = False):
        self.services = {}
        try:
            self._build(sam_model, esrgan_model, birefnet_model, depthany_model,
                        migan_model, yolo_model, batch_size, max_delay_ms,
                        host, port, warmup)
        except BaseException:
            # a bind/warmup/validation failure must not leak the worker and
            # prep threads of the services already constructed
            for svc in self.services.values():
                svc.close()
            raise

    def _build(self, sam_model, esrgan_model, birefnet_model, depthany_model,
               migan_model, yolo_model, batch_size, max_delay_ms, host, port,
               warmup):
        from .serve import EsrganServer, ImageServer, SamServer, YoloServer

        if sam_model is not None:
            self.services["sam"] = SamServer(sam_model, batch_size=batch_size,
                                             max_delay_ms=max_delay_ms)
        if esrgan_model is not None:
            self.services["esrgan"] = EsrganServer(esrgan_model, batch_size=batch_size,
                                                   max_delay_ms=max_delay_ms)
        for name, model in (("birefnet", birefnet_model), ("depthany", depthany_model),
                            ("migan", migan_model)):
            if model is not None:
                self.services[name] = ImageServer(model, batch_size=batch_size,
                                                  max_delay_ms=max_delay_ms)
        if yolo_model is not None:
            self.services["yolo"] = YoloServer(yolo_model, batch_size=batch_size,
                                               max_delay_ms=max_delay_ms)
        if not self.services:
            raise ValueError("at least one model is required")
        if warmup:
            for name, svc in self.services.items():
                print(f"warming up {name}...", flush=True)
                svc.warmup()
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._thread: threading.Thread | None = None
        self._serving = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        """Serve in a background thread (tests / embedding)."""
        self._serving = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        self._serving = True
        self._httpd.serve_forever()

    def stats(self) -> dict:
        out = {}
        for name, svc in self.services.items():
            st = svc.stats
            out[name] = {
                "requests": st.requests,
                "batches": st.batches,
                "occupancy": round(st.occupancy, 3),
                "p50_latency_ms": round(st.p50_latency_ms, 2),
                "p99_latency_ms": round(st.p99_latency_ms, 2),
            }
        return out

    def close(self):
        # shutdown() blocks on an event only serve_forever() sets — calling
        # it on a server that never started would deadlock
        if self._serving:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        for svc in self.services.values():
            svc.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


_ROUTES = {"/v1/sam/mask": "sam", "/v1/esrgan": "esrgan", "/v1/birefnet": "birefnet",
           "/v1/depthany": "depthany", "/v1/migan": "migan", "/v1/yolo": "yolo"}


def _make_handler(server: VisionHTTPServer):
    class Handler(BaseHTTPRequestHandler):
        # bound rfile reads: a client that sends fewer bytes than its
        # Content-Length would otherwise pin a handler thread forever
        timeout = 60

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {"status": "ok", "models": server.stats()})
            else:
                self._json(404, {"error": "not found"})

        def _send(self, code: int, body: bytes, ctype: str):
            self._responded = True
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _discard_body(self):
            """Read and drop a declared body (up to MAX_BODY_BYTES) that an
            early answer does not use: the connection closes after the
            answer, and closing it with bytes unread resets it, so a client
            still sending would see a broken pipe instead of the answer."""
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return
            if n > MAX_BODY_BYTES:
                return
            while n > 0:
                chunk = self.rfile.read(min(n, 1 << 20))
                if not chunk:
                    return
                n -= len(chunk)

        def _linger(self, seconds: float = 2.0):
            """Close after an answer that leaves a declared body unread: stop
            writing, then drop what the client still sends (for up to
            ``seconds``) before the close. Closing with bytes unread resets
            the connection, and the reset can reach the client before it
            has read the answer."""
            self.close_connection = True
            try:
                self.wfile.flush()
                self.connection.shutdown(socket.SHUT_WR)
                self.connection.settimeout(seconds)
                deadline = time.monotonic() + seconds
                while time.monotonic() < deadline and self.connection.recv(1 << 16):
                    pass
            except OSError:
                pass

        def do_POST(self):
            self._responded = False
            url = urlparse(self.path)
            try:
                # resolve the route BEFORE paying for body decode
                route = url.path
                if route not in _ROUTES:
                    self._discard_body()
                    return self._json(404, {"error": "not found"})
                svc = server.services.get(_ROUTES[route])
                if svc is None:
                    self._discard_body()
                    return self._json(404, {"error": f"no {_ROUTES[route]} model loaded"})

                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    return self._json(400, {"error": "malformed Content-Length"})
                if n <= 0:
                    if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
                        return self._json(411, {"error": "chunked bodies unsupported; "
                                                "send Content-Length"})
                    return self._json(400, {"error": "empty body"})
                if n > MAX_BODY_BYTES:
                    # reject BEFORE buffering: a client-declared multi-GB
                    # Content-Length must not drive a host allocation (the
                    # image/pixel caps only run after the body is read)
                    self._json(413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"})
                    return self._linger()

                try:
                    try:
                        img = _load_image_bytes(self.rfile.read(n))
                    except VispError as e:
                        # the decoder's own error: bytes the port cannot read
                        # are the client's fault, as PIL's are in the JAX package
                        return self._json(400, {"error": f"{type(e).__name__}: {e}"})
                    q = parse_qs(url.query)

                    if route == "/v1/sam/mask":
                        if "box" in q:
                            x0, y0, x1, y1 = (int(v) for v in q["box"][0].split(","))
                            fut = svc.submit(img, box=((x0, y0), (x1, y1)))
                        else:
                            x = int(q.get("x", [img.width // 2])[0])
                            y = int(q.get("y", [img.height // 2])[0])
                            fut = svc.submit(img, point=(x, y))
                        return self._send(200, _png_bytes(fut.result()), "image/png")

                    if route in ("/v1/esrgan", "/v1/birefnet", "/v1/depthany"):
                        fut = svc.submit(img)
                        return self._send(200, _png_bytes(fut.result()), "image/png")

                    if route == "/v1/migan":
                        from .image import Image, ImageFormat

                        a = np.asarray(img.data)
                        if a.ndim != 3 or a.shape[2] != 4:
                            return self._json(400, {"error": "migan needs an RGBA body "
                                                    "(alpha channel = inpaint mask)"})
                        mask = Image(np.ascontiguousarray(a[:, :, 3:4]), ImageFormat.alpha_u8)
                        out = svc.submit((img, mask)).result()
                        # the model injects the inpaint mask as the output's
                        # alpha (reference composite contract); encoded
                        # verbatim that renders the keep-region transparent
                        # in a viewer — this endpoint promises the inpainted
                        # IMAGE, so flatten to rgb
                        rgb = Image(np.ascontiguousarray(np.asarray(out.data)[:, :, :3]), ImageFormat.rgb_u8)
                        return self._send(200, _png_bytes(rgb), "image/png")

                    # /v1/yolo
                    from .models.yolov9t import COCO_CLASS_NAMES

                    conf = float(q["conf"][0]) if "conf" in q else None
                    iou = float(q["iou"][0]) if "iou" in q else None
                    dets = svc.submit(img, conf_thres=conf, iou_thres=iou).result()
                    return self._json(200, [
                        {
                            "box": [round(d.x1, 2), round(d.y1, 2), round(d.x2, 2), round(d.y2, 2)],
                            "confidence": round(d.confidence, 4),
                            "class_id": d.class_id,
                            "class_name": COCO_CLASS_NAMES[d.class_id]
                            if d.class_id < len(COCO_CLASS_NAMES) else str(d.class_id),
                        }
                        for d in dets
                    ])
                except _CLIENT_ERRORS as e:
                    # bad image bytes / malformed params / size-limit
                    # rejections are the CLIENT's fault, not a 500
                    return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 — HTTP boundary
                if self._responded:
                    # a 200 response was already (partially) written — a
                    # second status line would corrupt the connection;
                    # drop it (client disconnects land here)
                    return None
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_forever(sam_model=None, esrgan_model=None, **kw):
    srv = VisionHTTPServer(sam_model=sam_model, esrgan_model=esrgan_model, **kw)
    # flushed: a parent process reads the port from a pipe
    print(f"serving on port {srv.port}: {sorted(srv.services)} (GET /healthz)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # close on ANY exit so batch workers and the socket never leak
        srv.close()
