"""The port's serve_http.py against the JAX package's: both packages'
VisionHTTPServer on port 0 with the six small families of
tests/test_torch_api.py on the CPU, sent the same bodies. Image responses
are within one u8 level of the JAX ones on at most 0.1% of their values (the
rule of tests/test_torch_cli.py), YOLOv9t's JSON within its 0.01 px and 1e-4
roundings of boxes within 1e-3 px and confidences within 1e-4; every bad
request gets the JAX server's status code; PNG bodies decode with PIL
hidden; ``/healthz`` has the JAX keys; and the ``serve`` verb's rules, and
the verb itself as a subprocess that exits 0 on SIGINT."""

import http.client
import io
import json
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

import vision_tpu.cli as jcli
import vision_tpu.serve_http as jhttp
import vision_tpu_torch.cli as tcli
import vision_tpu_torch.serve_http as thttp
from test_torch_api import FAMILIES, sample_image, write_family_gguf
from vision_tpu import api as japi
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu_torch import api
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.image.png import encode_png, read_png

MAX_SHARE_OFF = 1e-3  # share of values that may differ, by one u8 level at most
BOX_TOL, CONF_TOL = 0.01 + 1e-3, 1e-4 + 1e-4  # the JSON's roundings of values within 1e-3 px / 1e-4
KEYWORDS = {"sam": "sam_model", "esrgan": "esrgan_model", "birefnet": "birefnet_model",
            "depthany": "depthany_model", "migan": "migan_model", "yolov9t": "yolo_model"}


def _png(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    PILImage.fromarray(a).save(buf, format="PNG")
    return buf.getvalue()


def _request(port, method, path, body=None, headers=None):
    """(status, body, content type) of one request; raw headers as given."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.putrequest(method, path, skip_accept_encoding=True)
        for k, v in (headers if headers is not None else {"Content-Length": str(len(body or b""))}).items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        return r.status, r.read(), r.getheader("Content-Type")
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """name -> the JAX and the port's VisionHTTPServer over the six small
    families (batch 2, a 50 ms window), listening on port 0."""
    d = tmp_path_factory.mktemp("torch_http")
    paths = {f: write_family_gguf(f, d) for f in FAMILIES}
    jdev, tdev = jax_backend_init("cpu"), backend_init("cpu")
    jmodels = {KEYWORDS[f]: japi.load_model(p, jdev) for f, p in paths.items()}
    tmodels = {KEYWORDS[f]: api.load_model(p, tdev) for f, p in paths.items()}
    srv = {"jax": jhttp.VisionHTTPServer(batch_size=2, max_delay_ms=50, port=0, **jmodels).start()}
    try:
        srv["torch"] = thttp.VisionHTTPServer(batch_size=2, max_delay_ms=50, port=0, **tmodels).start()
        yield srv
    finally:
        for s in srv.values():
            s.close()


def _rgb(h, w):
    return sample_image(h, w)


def _rgba(h, w):
    a = sample_image(h, w, 4)
    a[:, :, 3] = 255
    a[h // 4 : h // 2, w // 3 : w // 2, 3] = 0  # the hole
    return a


ROUTES = {  # label -> (path, body)
    "sam_point": ("/v1/sam/mask?x=40&y=30", _rgb(72, 96)),
    "sam_box": ("/v1/sam/mask?box=10,12,70,60", _rgb(72, 96)),
    "sam_center": ("/v1/sam/mask", _rgb(60, 50)),
    "esrgan": ("/v1/esrgan", _rgb(24, 32)),
    "birefnet": ("/v1/birefnet", _rgb(72, 96)),
    "depthany": ("/v1/depthany", _rgb(70, 84)),
    "depthany_gray": ("/v1/depthany", _rgb(56, 56)[:, :, 0]),
    "migan": ("/v1/migan", _rgba(64, 80)),
    "yolo": ("/v1/yolo?conf=0.3", _rgb(72, 96)),
    "yolo_iou": ("/v1/yolo?conf=0.2&iou=0.3", _rgb(100, 120)),
}


def _pixels(body):
    return np.asarray(PILImage.open(io.BytesIO(body))).astype(int)


@pytest.mark.parametrize("label", sorted(ROUTES))
def test_responses_match_the_jax_server(label, servers):
    path, a = ROUTES[label]
    got = _request(servers["torch"].port, "POST", path, _png(a))
    want = _request(servers["jax"].port, "POST", path, _png(a))
    assert got[0] == want[0] == 200 and got[2] == want[2], (got[:1], want[:1], want[1][:200])
    if got[2] == "application/json":
        g, j = json.loads(got[1]), json.loads(want[1])
        assert len(g) == len(j) > 0
        for dg, dj in zip(g, j):
            assert dg.keys() == dj.keys() == {"box", "confidence", "class_id", "class_name"}
            assert (dg["class_id"], dg["class_name"]) == (dj["class_id"], dj["class_name"])
            assert np.abs(np.subtract(dg["box"], dj["box"])).max() <= BOX_TOL
            assert abs(dg["confidence"] - dj["confidence"]) <= CONF_TOL
        return
    g, j = _pixels(got[1]), _pixels(want[1])
    assert g.shape == j.shape, (g.shape, j.shape)
    diff = np.abs(g - j)
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE_OFF, (diff.max(), (diff > 0).mean())
    # the port's codec reads its own response as PIL does
    np.testing.assert_array_equal(read_png(got[1]).reshape(g.shape), g)


def test_concurrent_clients_share_a_batch(servers):
    port = servers["torch"].port
    before = json.loads(_request(port, "GET", "/healthz")[1])["models"]["depthany"]
    body = _png(_rgb(70, 84))
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda _: _request(port, "POST", "/v1/depthany", body), range(4)))
    assert all(r[0] == 200 for r in results) and len({r[1] for r in results}) == 1
    after = json.loads(_request(port, "GET", "/healthz")[1])["models"]["depthany"]
    assert after["requests"] - before["requests"] == 4
    assert after["batches"] - before["batches"] < 4  # two at most share a batch of 2


BAD = {  # label -> (method, path, body, headers or None for a plain Content-Length)
    "unknown_route": ("POST", "/v1/nope", b"x", None),
    "unknown_get": ("GET", "/nope", None, None),
    "empty_body": ("POST", "/v1/esrgan", None, {"Content-Length": "0"}),
    "no_length": ("POST", "/v1/esrgan", None, {}),
    "malformed_length": ("POST", "/v1/esrgan", None, {"Content-Length": "abc"}),
    "chunked": ("POST", "/v1/esrgan", b"0\r\n\r\n", {"Transfer-Encoding": "chunked"}),
    "too_large": ("POST", "/v1/migan", b"x", {"Content-Length": str(1 << 33)}),
    "bad_box": ("POST", "/v1/sam/mask?box=1,2,3", _png(np.zeros((24, 32, 3), np.uint8)), None),
    "bad_point": ("POST", "/v1/sam/mask?x=a", _png(np.zeros((24, 32, 3), np.uint8)), None),
    "bad_conf": ("POST", "/v1/yolo?conf=high", _png(np.zeros((24, 32, 3), np.uint8)), None),
    "not_an_image": ("POST", "/v1/esrgan", b"this is not an image", None),
    "migan_rgb": ("POST", "/v1/migan", _png(np.zeros((24, 32, 3), np.uint8)), None),
    "esrgan_over_cap": ("POST", "/v1/esrgan", _png(np.zeros((1030, 1030, 3), np.uint8)), None),
}


@pytest.mark.parametrize("label", sorted(BAD))
def test_bad_requests_get_the_jax_status(label, servers):
    method, path, body, headers = BAD[label]
    codes = []
    for name in ("jax", "torch"):
        try:
            status, resp, ctype = _request(servers[name].port, method, path, body, headers)
        except (ConnectionError, http.client.HTTPException):
            status, resp, ctype = "dropped", b"{}", "application/json"  # a cut after the early reply
        codes.append(status)
        assert ctype == "application/json" and "error" in json.loads(resp), (name, resp[:200])
    assert codes[1] == codes[0] and codes[1] in (400, 404, 411, 413), codes


def test_a_damaged_png_is_a_client_error(servers):
    """A truncated PNG body: the port's codec reads no image from it, and
    the port answers 400, as it answers every body it cannot decode (the JAX
    server reaches PIL's OSError there, which it answers with 500)."""
    data = _png(_rgb(40, 50))
    for cut in (data[:-30], data[: len(data) // 2], data[:40]):
        status, resp, _ = _request(servers["torch"].port, "POST", "/v1/depthany", cut)
        assert status == 400 and json.loads(resp)["error"].startswith("VispError: PNG"), resp


def test_healthz_has_the_jax_keys(servers):
    got, want = (json.loads(_request(servers[n].port, "GET", "/healthz")[1]) for n in ("torch", "jax"))
    assert got.keys() == want.keys() == {"status", "models"} and got["status"] == "ok"
    assert got["models"].keys() == want["models"].keys() == {"sam", "esrgan", "birefnet", "depthany", "migan", "yolo"}
    for name in got["models"]:
        assert got["models"][name].keys() == want["models"][name].keys() == {
            "requests", "batches", "occupancy", "p50_latency_ms", "p99_latency_ms"}


@pytest.fixture(scope="module")
def depth_only(tmp_path_factory):
    path = write_family_gguf("depthany", tmp_path_factory.mktemp("torch_http_depth"))
    with thttp.VisionHTTPServer(depthany_model=api.load_model(path, backend_init("cpu")), port=0) as srv:
        yield srv, path


def test_png_bodies_decode_without_pil(depth_only, monkeypatch):
    """With PIL unimportable a PNG body decodes through the port's codec and
    the response is the one PIL's presence gives; any other body is a 400
    that names PIL."""
    srv, _ = depth_only
    body = encode_png(_rgb(56, 70))
    with_pil = _request(srv.port, "POST", "/v1/depthany", body)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    without = _request(srv.port, "POST", "/v1/depthany", body)
    assert without[0] == with_pil[0] == 200 and without[1] == with_pil[1]
    status, resp, _ = _request(srv.port, "POST", "/v1/depthany", b"\xff\xd8\xff\xe0 a jpeg, say")
    assert status == 400 and "only PNG is decoded without PIL" in json.loads(resp)["error"]


def test_a_family_not_loaded_is_404(depth_only):
    srv, _ = depth_only
    status, resp, _ = _request(srv.port, "POST", "/v1/birefnet", _png(_rgb(20, 20)))
    assert status == 404 and json.loads(resp) == {"error": "no birefnet model loaded"}


@pytest.mark.parametrize("path,error", [("/v1/birefnet", "no birefnet model loaded"), ("/v1/nope", "not found")],
                         ids=["family_not_loaded", "unknown_route"])
def test_a_large_body_to_a_route_it_does_not_serve_gets_its_404(depth_only, path, error):
    """The answer comes before the body is needed, and the server reads the
    body it does not use before it closes the connection, so a client still
    sending 8 MB gets the 404, not a reset connection."""
    srv, _ = depth_only
    body = np.random.default_rng(0).integers(0, 256, 8 << 20, dtype=np.uint8).tobytes()
    for _ in range(3):
        status, resp, _ = _request(srv.port, "POST", path, body)
        assert status == 404 and json.loads(resp) == {"error": error}


def test_bind_failure_leaks_no_threads(depth_only):
    """A port already taken: the constructor raises and closes the services
    it had started, as the JAX server does."""
    srv, path = depth_only
    model = api.load_model(path, backend_init("cpu"))
    before = threading.active_count()
    with pytest.raises(OSError):
        thttp.VisionHTTPServer(depthany_model=model, yolo_model=None, port=srv.port)
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="at least one model is required"):
        thttp.VisionHTTPServer(port=0)


def test_response_encoding_matches_the_jax_conversion():
    """Depth-Anything's alpha_f32: clip, x 255, + 0.5, to u8, as the JAX
    _png_bytes does; gray stays one channel."""
    from vision_tpu.image import Image as JImage
    from vision_tpu.image import ImageFormat as JFormat
    from vision_tpu_torch.image import Image, ImageFormat

    f = np.linspace(-0.1, 1.1, 7 * 9, dtype=np.float32).reshape(7, 9, 1)
    got = thttp._png_bytes(Image(f, ImageFormat.alpha_f32))
    want = jhttp._png_bytes(JImage(f, JFormat.alpha_f32))
    np.testing.assert_array_equal(_pixels(got), _pixels(want))
    assert PILImage.open(io.BytesIO(got)).mode == "L"


def _run(cli, args, capsys):
    rc = cli.main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_serve_verb_rules_match_the_jax_cli(tmp_path, capsys):
    depth = write_family_gguf("depthany", tmp_path)
    from vision_tpu_torch.core.gguf import GGUFWriter

    w = GGUFWriter(tmp_path / "sam3.gguf", "sam3")
    w.add_tensor("x", np.zeros(4, np.float32))
    w.write()
    for args, message in (
        (["serve"], "No model specified (-m)"),
        (["serve", "-m", tmp_path / "none.gguf"], "Model file not found"),
        (["serve", "-m", depth, "--extra-model", tmp_path / "typo.gguf"], "Model file not found: "),
        (["serve", "-m", depth, "--esrgan-model", tmp_path / "typo.gguf"], "Model file not found: "),
        (["serve", "-m", depth, "--extra-model", depth, "-b", "cpu"], "two models of one family given (depthany_model)"),
        (["serve", "-m", tmp_path / "sam3.gguf", "-b", "cpu"], "serve does not support sam3 models"),
    ):
        got, want = _run(tcli, args, capsys), _run(jcli, args, capsys)
        assert got[0] == want[0] == 1 and message in got[2] and message in want[2], (got, want)
    with pytest.raises(SystemExit):  # --dp waits for the port's meshes
        tcli.main(["serve", "-m", str(depth), "--dp", "2"])
    capsys.readouterr()
    # --adapter merges a LoRA file into -m first (tests/test_torch_finetune.py), here a missing one
    rc, _, err = _run(tcli, ["serve", "-m", depth, "--adapter", tmp_path / "a.gguf"], capsys)
    assert rc == 1 and "Adapter file not found" in err


def test_serve_verb_as_a_subprocess(tmp_path):
    """python -m vision_tpu_torch.cli serve on port 0 prints its port,
    answers, and exits 0 on SIGINT."""
    depth = write_family_gguf("depthany", tmp_path)
    yolo = write_family_gguf("yolov9t", tmp_path)
    proc = subprocess.Popen([sys.executable, "-m", "vision_tpu_torch.cli", "serve", "-m", depth, "--extra-model", yolo,
                             "-b", "cpu", "--port", "0"], cwd=Path(__file__).resolve().parents[1],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        deadline = time.monotonic() + 120
        lines = []
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving on port "):
                port = int(line.split()[3].rstrip(":"))
        assert port, "".join(lines) + proc.stderr.read() if proc.poll() is not None else "".join(lines)
        assert "['depthany', 'yolo']" in lines[-1]
        status, body, ctype = _request(port, "POST", "/v1/depthany", _png(_rgb(56, 56)))
        assert status == 200 and ctype == "image/png" and _pixels(body).shape == (56, 56)
        status, body, ctype = _request(port, "POST", "/v1/yolo", _png(_rgb(56, 56)))
        assert status == 200 and isinstance(json.loads(body), list)
        assert _request(port, "POST", "/v1/esrgan", _png(_rgb(8, 8)))[0] == 404
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
