"""The port's video.py and the CLI's video input against the JAX package's,
on the CPU with the small GGUFs of tests/test_torch_api.py: the reader and
writer round trip (each package's reader gives the other's frames exactly,
both decoding through OpenCV), and both packages' video_run on one short
clip (Depth-Anything, YOLOv9t with its per-frame detections, MI-GAN with
one static mask), frame by frame; the validation errors and the CLI's video
rules. Both outputs go through the same lossy codec (MJPG in .avi), whose
8x8 blocks spread a one-level difference of the model outputs (at most 0.1%
of values, tests/test_torch_cli.py) over a block: each output frame is held
to the JAX one within a mean absolute difference of VIDEO_MEAN_TOL levels.
OpenCV-gated, as tests/test_video.py is."""

import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import vision_tpu.cli as jcli  # noqa: E402
import vision_tpu.video as jvideo  # noqa: E402
import vision_tpu_torch.cli as tcli  # noqa: E402
import vision_tpu_torch.video as tvideo  # noqa: E402
from test_torch_api import write_family_gguf  # noqa: E402
from vision_tpu import api as japi  # noqa: E402
from vision_tpu.core.device import backend_init as jax_backend_init  # noqa: E402
from vision_tpu.core.errors import VispError as JaxVispError  # noqa: E402
from vision_tpu_torch import api  # noqa: E402
from vision_tpu_torch.core.device import backend_init  # noqa: E402
from vision_tpu_torch.core.errors import VispError  # noqa: E402
from vision_tpu_torch.image import Image, ImageFormat, image_save  # noqa: E402

VIDEO_MEAN_TOL = 0.5  # mean |port - JAX| of an output frame, u8 levels, after the codec
BOX_TOL, CONF_TOL = 0.1 + 1e-3, 1e-4 + 1e-4  # the JSON's 0.1 px / 1e-4 roundings of values within 1e-3 / 1e-4


def _gradient_frames(n, h, w, seed=0):
    """Smooth frames (gradient + per-frame offset) so lossy codecs stay
    close to the source; the flat green level identifies each frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = ((yy * 255 // max(h - 1, 1) + xx * 255 // max(w - 1, 1)) // 2).astype(np.uint8)
    frames = []
    for i in range(n):
        green = np.full_like(base, min(20 + i * 30, 250))
        f = np.stack([base, green, base[::-1]], axis=2).copy()
        f[:, :, 0] = np.clip(f[:, :, 0].astype(np.int32) + int(rng.integers(-8, 8)), 0, 255).astype(np.uint8)
        frames.append(f)
    return frames


def _write_video(path, frames, fps=12.0):
    with tvideo.VideoWriter(path, fps, (frames[0].shape[1], frames[0].shape[0])) as w:
        for f in frames:
            w.write(f)
    return str(path)


def _frames(video, path):
    with video.VideoReader(path) as r:
        return [np.asarray(f.data) for f in r]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_video")
    return {family: write_family_gguf(family, d) for family in ("depthany", "yolov9t", "migan")}


def test_is_video_and_exts_match_jax():
    assert tvideo.VIDEO_EXTS == jvideo.VIDEO_EXTS
    for name in ("clip.mp4", "A.AVI", "x.webm", "image.png", "dir", "a.m4v"):
        assert tvideo.is_video(name) == jvideo.is_video(name)


def test_reader_writer_round_trip(tmp_path):
    frames = _gradient_frames(7, 48, 64)
    src = _write_video(tmp_path / "t.avi", frames)
    with tvideo.VideoReader(src) as r:
        assert r.extent == (64, 48) and r.fps == pytest.approx(12.0, abs=0.5)
        got = list(r)
    assert len(got) == 7 and all(g.format == ImageFormat.rgb_u8 and g.extent == (64, 48) for g in got)
    assert np.mean(np.abs(got[0].data.astype(int) - frames[0].astype(int))) < 8.0  # MJPG, smooth content
    for i in (0, 3, 6):  # frame order survives
        assert abs(float(np.mean(got[i].data[:, :, 1])) - (20 + i * 30)) < 12.0
    # the JAX package's reader and writer: the same frames, the same bytes
    jsrc = tmp_path / "j.avi"
    with jvideo.VideoWriter(jsrc, 12.0, (64, 48)) as w:
        for f in frames:
            w.write(f)
    assert jsrc.read_bytes() == (tmp_path / "t.avi").read_bytes()
    for a, b in zip(_frames(jvideo, src), [g.data for g in got]):
        np.testing.assert_array_equal(a, b)


def test_writer_takes_server_payloads(tmp_path):
    """Float [0, 1] maps to u8 by the served conversion, one channel
    replicates to gray, alpha is dropped, a wrong extent is refused."""
    with tvideo.VideoWriter(tmp_path / "p.avi", 10.0, (16, 8)) as w:
        w.write(Image(np.full((8, 16, 1), 0.5, np.float32), ImageFormat.alpha_f32))
        w.write(np.zeros((8, 16, 4), np.uint8))
        with pytest.raises(VispError, match="frame is 8x8 but the writer was opened at 16x8"):
            w.write(np.zeros((8, 8, 3), np.uint8))
    np.testing.assert_array_equal(tvideo._to_rgb_u8(np.full((2, 2, 1), 0.5, np.float32)),
                                  jvideo._to_rgb_u8(np.full((2, 2, 1), 0.5, np.float32)))


@pytest.mark.parametrize("family", ["depthany", "yolov9t", "migan"])
def test_video_run_matches_jax(family, ggufs, tmp_path):
    h, w = {"depthany": (70, 84), "yolov9t": (100, 120), "migan": (64, 64)}[family]
    src = _write_video(tmp_path / "in.avi", _gradient_frames(5, h, w))
    kw = {}
    if family == "migan":
        m = np.full((h, w, 1), 255, np.uint8)
        m[20:40, 20:40] = 0  # the hole to inpaint
        image_save(Image(m, ImageFormat.alpha_u8), tmp_path / "mask.png")
        kw["mask"] = tmp_path / "mask.png"
    if family == "yolov9t":
        kw["conf_thres"] = 0.3
    results, logs = {}, {"jax": [], "torch": []}
    for name, video, load, dev in (("jax", jvideo, japi.load_model, jax_backend_init("cpu")),
                                   ("torch", tvideo, api.load_model, backend_init("cpu"))):
        results[name] = video.video_run(load(ggufs[family], dev), src, tmp_path / f"{name}.avi", batch_size=2,
                                        log=logs[name].append, **kw)
    got, want = _frames(tvideo, tmp_path / "torch.avi"), _frames(jvideo, tmp_path / "jax.avi")
    assert len(got) == len(want) == 5 and got[0].shape == want[0].shape == (h, w, 3)
    for i, (g, j) in enumerate(zip(got, want)):
        assert np.mean(np.abs(g.astype(int) - j.astype(int))) <= VIDEO_MEAN_TOL, i
    assert logs["torch"][-1].split(" in ")[0] == logs["jax"][-1].split(" in ")[0] == "  5 frames"
    if family == "migan":
        # the keep region (mask 255) is the input's own pixels, composited per frame
        inputs = _frames(tvideo, src)
        assert np.mean(np.abs(got[0][:10].astype(int) - inputs[0][:10].astype(int))) < 12.0
    if family != "yolov9t":
        assert results["torch"] is None and results["jax"] is None
        return
    assert len(results["torch"]) == len(results["jax"]) == 5 and sum(map(len, results["torch"])) > 0
    for g_frame, j_frame in zip(results["torch"], results["jax"]):
        assert [d["class"] for d in g_frame] == [d["class"] for d in j_frame]
        for g, j in zip(g_frame, j_frame):
            assert np.abs(np.subtract(g["box"], j["box"])).max() <= BOX_TOL
            assert abs(g["confidence"] - j["confidence"]) <= CONF_TOL


@pytest.mark.parametrize("case", ["not_a_video_output", "overwrite", "unsupported_model", "migan_without_mask",
                                  "reader_missing_file"])
def test_video_errors_match_jax(case, ggufs, tmp_path):
    src = _write_video(tmp_path / "in.avi", _gradient_frames(2, 64, 64))

    def call(video, load, dev):
        if case == "not_a_video_output":
            return video.video_run(load(ggufs["depthany"], dev), src, tmp_path / "out.png")
        if case == "overwrite":
            return video.video_run(load(ggufs["depthany"], dev), src, src)
        if case == "unsupported_model":
            return video.video_run(object(), src, tmp_path / "out.avi")
        if case == "migan_without_mask":
            return video.video_run(load(ggufs["migan"], dev), src, tmp_path / "out.avi", log=lambda *_: None)
        return video.VideoReader(tmp_path / "missing.mp4")

    with pytest.raises(JaxVispError) as want:
        call(jvideo, japi.load_model, jax_backend_init("cpu"))
    with pytest.raises(VispError) as got:
        call(tvideo, api.load_model, backend_init("cpu"))
    assert str(got.value) == str(want.value)


def test_without_opencv_the_error_names_it(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(VispError, match="OpenCV \\(cv2\\) is required"):
        tvideo.VideoReader(tmp_path / "x.mp4")


def _run(cli, args, capsys):
    rc = cli.main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_video_rules_match_the_jax_cli(ggufs, tmp_path, capsys):
    src = _write_video(tmp_path / "in.avi", _gradient_frames(1, 32, 32))
    for args, message in (
        (["esrgan", "-i", src, "-o", tmp_path / "o.avi", "--tile", "256"], "not supported in video mode"),
        (["sam", "-i", src, "-o", tmp_path / "o.avi", "--composite", tmp_path / "c.png"],
         "not supported in video mode"),
        (["migan", "-m", ggufs["migan"], "-b", "cpu", "-i", src, src, "-o", tmp_path / "o.avi"],
         "migan video mode takes -i <video> <mask-image>"),
    ):
        got, want = _run(tcli, args, capsys), _run(jcli, args, capsys)
        assert got[0] == want[0] == 1 and got[2] == want[2] and message in got[2], (got, want)


@pytest.mark.parametrize("verb", ["depthany", "yolov9t"])
def test_cli_video_input_matches_the_jax_cli(verb, ggufs, tmp_path, capsys):
    src = _write_video(tmp_path / "in.avi", _gradient_frames(3, 70, 70))
    outs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        rc, out, err = _run(cli, [verb, "-m", ggufs[verb], "-b", "cpu", "-i", src, "-o", tmp_path / f"{name}.avi",
                                  "--conf", "0.3"], capsys)
        assert rc == 0, err
        outs[name] = out
    got, want = _frames(tvideo, tmp_path / "torch.avi"), _frames(jvideo, tmp_path / "jax.avi")
    assert len(got) == len(want) == 3
    for g, j in zip(got, want):
        assert np.mean(np.abs(g.astype(int) - j.astype(int))) <= VIDEO_MEAN_TOL
    assert outs["torch"].rstrip().endswith(f"-> {tmp_path / 'torch.avi'}")
    if verb == "yolov9t":
        dets = json.loads((tmp_path / "torch.detections.json").read_text())
        assert len(dets) == 3 and len(dets) == len(json.loads((tmp_path / "jax.detections.json").read_text()))
        assert f"-> {tmp_path / 'torch.detections.json'} (" in outs["torch"]
