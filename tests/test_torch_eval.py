"""The port's evaluate.py and the CLI's ``eval`` verb against the JAX
package's: the cases of tests/test_eval.py, each scored by both packages on
the same files and held to the JAX result dict within 1e-6; the 16-bit gray
PNG reader against PIL's ``I;16`` (with PIL hidden from the port); and
``eval`` as a CLI verb in both modes. Scoring only, the printed report is
the JAX CLI's line for line. With -m, each package runs its own inference
first (bulk_run on the CPU), whose PNGs may differ by one u8 level on up to
0.1% of values (tests/test_torch_cli.py), so the scores agree within 1e-3
there."""

import io
import json
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image as PILImage

import vision_tpu.cli as jcli
import vision_tpu.evaluate as jev
import vision_tpu_torch.cli as tcli
import vision_tpu_torch.evaluate as tev
from test_torch_api import sample_image, write_family_gguf
from vision_tpu.core.errors import VispError as JaxVispError
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.image import png

TOL = 1e-6
CLI_TOL = 1e-3  # eval -m: each package's own predictions, within one u8 level on <= 0.1% of values


def _same_result(got, want, tol=TOL, path="result"):
    """Equal structure; floats within ``tol`` (inf equal to inf)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, sorted(got), sorted(want))
        for k in want:
            _same_result(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, float) and not np.isfinite(want):
        assert got == want, (path, got, want)
    elif isinstance(want, (float, np.floating)):
        assert isinstance(got, float) and abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _save_gray(path, a):
    path.parent.mkdir(parents=True, exist_ok=True)
    PILImage.fromarray(np.asarray(a, np.uint8)).save(path)


def _both(task, pred, gt, **kw):
    got, want = tev.evaluate(task, pred, gt, **kw), jev.evaluate(task, pred, gt, **kw)
    _same_result(got, want)
    return got, want


def _write_detections(path, doc):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc))


# the cases of tests/test_eval.py: each writes its files into d and returns
# evaluate's arguments
def _mask_known_overlap(d):
    gt = np.zeros((16, 16), np.uint8)
    gt[2:10, 2:10] = 255
    pred = np.zeros((16, 16), np.uint8)
    pred[4:12, 4:12] = 255
    _save_gray(d / "gt" / "a.png", gt)
    _save_gray(d / "pred" / "a.png", pred)
    _save_gray(d / "gt" / "b.png", np.zeros((8, 8)))
    _save_gray(d / "pred" / "b.png", np.zeros((8, 8)))
    return ("mask", d / "pred", d / "gt"), {"a": {"iou": 36 / 92, "f1": 2 * 36 / 128, "mae": 56 / 256}}


def _mask_resized(d):
    _save_gray(d / "gt" / "a.png", np.full((16, 16), 255))
    _save_gray(d / "pred" / "a.png", np.full((8, 8), 255))
    return ("mask", d / "pred", d / "gt"), {"a": {"iou": 1.0}}


def _depth_aligned(d):
    gt = np.random.default_rng(0).uniform(0.5, 2.0, (20, 20)).astype(np.float32)
    (d / "gt").mkdir()
    (d / "pred").mkdir()
    np.save(d / "gt" / "a.npy", gt)
    np.save(d / "pred" / "a.npy", 0.25 * gt - 0.05)
    return ("depth", d / "pred", d / "gt"), {"a": {"delta1": 1.0}}


def _depth_constant_half_res(d):
    (d / "gt").mkdir()
    (d / "pred").mkdir()
    np.save(d / "gt" / "a.npy", np.full((20, 20), 1.0, np.float32))
    np.save(d / "pred" / "a.npy", np.full((10, 10), 5.0, np.float32))
    return ("depth", d / "pred", d / "gt"), {"a": {"absrel": 0.0}}


def _depth_png_pred_16bit_gt(d):
    """u8 PNG predictions (bulk_run's output) against 16-bit PNG ground
    truth, one at another extent (the bilinear resize)."""
    rng = np.random.default_rng(3)
    for stem, (h, w) in (("a", (24, 32)), ("b", (12, 16))):
        g = rng.uniform(0.1, 1.0, (24, 32))
        PILImage.fromarray((g * 65535).astype(np.uint16)).save(_mkdir(d / "gt") / f"{stem}.png")
        p = 1.0 / (g[:: 24 // h, :: 32 // w] + rng.normal(0, 0.05, (h, w)).clip(-0.05, 0.05))
        _save_gray(d / "pred" / f"{stem}.png", (p / p.max() * 255).clip(0, 255))
    return ("depth", d / "pred", d / "gt"), {}


def _image_identical_and_constant_diff(d):
    img = np.random.default_rng(1).integers(0, 256, (24, 24, 3), np.uint8)
    for side in ("gt", "pred"):
        _mkdir(d / side)
        PILImage.fromarray(img).save(d / side / "same.png")
    _save_gray(d / "gt" / "diff.png", np.full((24, 24), 255))
    _save_gray(d / "pred" / "diff.png", np.zeros((24, 24)))
    return ("image", d / "pred", d / "gt"), {"same": {"rms": 0.0, "psnr": float("inf")}, "diff": {"rms": 2.0}}


def _image_npy(d):
    """.npy predictions against PNG ground truth: the plain RMS branch."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (16, 20, 3), np.uint8)
    _mkdir(d / "gt")
    PILImage.fromarray(img).save(d / "gt" / "a.png")
    np.save(_mkdir(d / "pred") / "a.npy", (img / 255.0 + rng.normal(0, 0.02, img.shape)).astype(np.float32))
    return ("image", d / "pred", d / "gt"), {}


def _detection_worked(d):
    _write_detections(d / "pred" / "detections.json", {
        "a": [{"class": "person", "confidence": 0.9, "box": [0, 2, 10, 12]},
              {"class": "person", "confidence": 0.8, "box": [50, 50, 60, 60]}],
        "b": [],
    })
    (_mkdir(d / "gt") / "a.txt").write_text("person 0 0 10 10\n")
    (d / "gt" / "b.txt").write_text("")
    return ("detection", d / "pred", d / "gt"), {}


def _detection_confident_fp(d):
    _write_detections(d / "pred" / "detections.json", {
        "a": [{"class": "0", "confidence": 0.95, "box": [50, 50, 60, 60]},
              {"class": "0", "confidence": 0.6, "box": [0, 0, 10, 10]}],
    })
    (_mkdir(d / "gt") / "a.txt").write_text("0 0 0 10 10\n")
    return ("detection", d / "pred", d / "gt"), {}


def _detection_gt_json(d):
    _write_detections(d / "pred" / "detections.json", {"a": [{"class": 0, "confidence": 1.0, "box": [0, 0, 4, 4]}]})
    _write_detections(d / "gt.json", {"a": [{"class": 0, "box": [0, 0, 4, 4]}], "c": []})
    return ("detection", d / "pred", d / "gt.json"), {}


def _mkdir(p):
    p.mkdir(parents=True, exist_ok=True)
    return p


CASES = {f.__name__.lstrip("_"): f for f in (
    _mask_known_overlap, _mask_resized, _depth_aligned, _depth_constant_half_res, _depth_png_pred_16bit_gt,
    _image_identical_and_constant_diff, _image_npy, _detection_worked, _detection_confident_fp, _detection_gt_json,
)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_matches_jax(case, tmp_path):
    args, worked = CASES[case](tmp_path)
    got, want = _both(*args)
    for stem, values in worked.items():
        for k, v in values.items():
            assert got["per_image"][stem][k] == pytest.approx(v, abs=1e-5), (stem, k)
    assert tev.format_report(got) == jev.format_report(want)


def test_depth_without_alignment_matches_jax(tmp_path):
    CASES["depth_aligned"](tmp_path)
    got, _ = _both("depth", tmp_path / "pred", tmp_path / "gt", align_depth=False)
    assert got["aligned"] is False and got["per_image"]["a"]["absrel"] > 0.5
    pairs = tev.pair_files(tmp_path / "pred", tmp_path / "gt")
    assert pairs == jev.pair_files(tmp_path / "pred", tmp_path / "gt")
    _same_result(tev.evaluate_depth(pairs, align=False), jev.evaluate_depth(pairs, align=False))


def test_detection_scores_match_the_expected_map(tmp_path):
    """tests/test_eval.py's worked values, scored by the port."""
    (args, _) = CASES["detection_worked"](tmp_path / "w")
    r = tev.evaluate(*args)
    assert r["mean"] == {"map50": pytest.approx(1.0), "map50_95": pytest.approx(0.4)}
    assert r["ap_per_iou"]["0.65"] == pytest.approx(1.0) and r["ap_per_iou"]["0.70"] == pytest.approx(0.0)
    (args, _) = CASES["detection_confident_fp"](tmp_path / "c")
    assert tev.evaluate_detections(*args[1:])["mean"]["map50"] == pytest.approx(0.5)


@pytest.mark.parametrize("case", ["image_extent_mismatch", "missing_gt_json", "no_gt_file", "unknown_task",
                                  "unknown_class", "bad_txt_line", "no_detections_file", "no_family_task"])
def test_errors_match_jax(case, tmp_path):
    d = tmp_path
    call = None
    if case == "image_extent_mismatch":
        for side, n in (("gt", 16), ("pred", 8)):
            _mkdir(d / side)
            PILImage.fromarray(np.zeros((n, n, 3), np.uint8)).save(d / side / "a.png")
        call = lambda ev: ev.evaluate("image", d / "pred", d / "gt")  # noqa: E731
    elif case == "missing_gt_json":
        _write_detections(d / "pred" / "detections.json", {"a": []})
        _write_detections(d / "gt2.json", {"zzz": []})
        call = lambda ev: ev.evaluate_detections(d / "pred", d / "gt2.json")  # noqa: E731
    elif case == "no_gt_file":
        _save_gray(d / "pred" / "a.png", np.zeros((4, 4)))
        _mkdir(d / "gt")
        call = lambda ev: ev.pair_files(d / "pred", d / "gt")  # noqa: E731
    elif case == "unknown_task":
        call = lambda ev: ev.evaluate("nope", d, d)  # noqa: E731
    elif case == "unknown_class":
        _write_detections(d / "pred" / "detections.json", {"a": [{"class": "unicorn", "box": [0, 0, 1, 1]}]})
        (_mkdir(d / "gt") / "a.txt").write_text("")
        call = lambda ev: ev.evaluate("detection", d / "pred", d / "gt")  # noqa: E731
    elif case == "bad_txt_line":
        _write_detections(d / "pred" / "detections.json", {"a": []})
        (_mkdir(d / "gt") / "a.txt").write_text("0 1 2 3\n")
        call = lambda ev: ev.evaluate("detection", d / "pred", d / "gt")  # noqa: E731
    elif case == "no_detections_file":
        _mkdir(d / "pred")
        call = lambda ev: ev.evaluate("detection", d / "pred", d)  # noqa: E731
    else:
        call = lambda ev: ev.task_for_family("sam3")  # noqa: E731
    with pytest.raises(JaxVispError) as want:
        call(jev)
    with pytest.raises(VispError) as got:
        call(tev)
    assert str(got.value) == str(want.value)


def test_task_map_matches_jax():
    assert tev.TASKS == jev.TASKS
    for family in ("birefnet", "sam", "depth_anything", "esrgan", "migan", "yolov9t"):
        assert tev.task_for_family(family) == jev.task_for_family(family)


def _png16(samples: np.ndarray, ft: np.ndarray) -> bytes:
    """A 16-bit gray PNG of ``samples`` (H, W) whose row y takes scanline
    filter ``ft[y]``: the filters run over the big-endian sample bytes, two
    to a pixel (PNG's bpp for 16-bit gray)."""
    h, w = samples.shape
    x = np.stack([samples >> 8, samples & 0xFF], -1).astype(np.int16)  # (H, W, 2) big-endian bytes
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, png._paeth(a, b, c)])[ft, np.arange(h)]
    rows = np.empty((h, 1 + 2 * w), np.uint8)
    rows[:, 0] = ft
    rows[:, 1:] = ((x - pred) % 256).astype(np.uint8).reshape(h, 2 * w)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (png.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_read_png16_matches_pil(filters):
    """Samples whose high and low bytes differ (a byte-order slip would read
    0x0102 as 0x0201) through every scanline filter, against PIL's I;16."""
    rng = np.random.default_rng(len(filters))
    samples = rng.integers(0, 65536, (13, 11)).astype(np.uint16)
    samples[0, :3] = (0x0102, 0x0201, 0xFF00)
    ft = (rng.integers(0, 5, 13) if filters == "mixed"
          else np.full(13, ["none", "sub", "up", "average", "paeth"].index(filters))).astype(np.uint8)
    data = _png16(samples, ft)
    got = png.read_png16(data)
    assert got.shape == (13, 11, 1) and got.dtype == np.uint16
    np.testing.assert_array_equal(got[:, :, 0], samples)
    np.testing.assert_array_equal(got[:, :, 0], np.asarray(PILImage.open(io.BytesIO(data))))


def test_read_png16_scope():
    with pytest.raises(png.PngUnsupported, match="16-bit gray"):
        png.read_png16(png.encode_png(np.zeros((4, 4, 1), np.uint8)))
    with pytest.raises(png.PngUnsupported):
        png.read_png(_png16(np.zeros((4, 4), np.uint16), np.zeros(4, np.uint8)))
    with pytest.raises(VispError, match="truncated|IEND"):
        png.read_png16(_png16(np.zeros((4, 4), np.uint16), np.zeros(4, np.uint8))[:-20])


def test_16bit_gt_read_without_pil_equals_jax(tmp_path, monkeypatch):
    """A 16-bit PNG ground truth as PIL writes it (I;16), read by the port's
    codec with PIL unimportable: the JAX package's reading (PIL) exactly."""
    gt16 = (np.arange(256, dtype=np.uint32).reshape(16, 16) * 257).astype(np.uint16)
    gt16[0, 0] = 0x0102
    p = tmp_path / "gt16.png"
    PILImage.fromarray(gt16).save(p)  # mode I;16
    assert PILImage.open(p).mode == "I;16"
    _save_gray(tmp_path / "g8.png", np.arange(16, dtype=np.uint8).reshape(4, 4) * 16)
    want, want8 = jev._load_map(p), jev._load_map(tmp_path / "g8.png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = tev._load_map(p)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (16, 16, 1)
    np.testing.assert_array_equal(got, want)
    assert got[0, 1, 0] == pytest.approx(257 / 65535.0) and got[0, 0, 0] == pytest.approx(0x0102 / 65535.0)
    np.testing.assert_array_equal(tev._load_map(tmp_path / "g8.png"), want8)  # 8-bit gray, also without PIL


# -- the CLI verb ------------------------------------------------------------


def _run(cli, args, capsys):
    rc = cli.main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", ["mask_known_overlap", "depth_png_pred_16bit_gt", "image_identical_and_constant_diff",
                                  "detection_worked"])
def test_cli_eval_scoring_only_prints_as_the_jax_cli(case, tmp_path, capsys):
    (task, pred, gt), _ = CASES[case](tmp_path)
    outs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        rc, out, err = _run(cli, ["eval", "--task", task, "-i", pred, "--gt", gt, "-o", tmp_path / f"{name}.json"],
                            capsys)
        assert rc == 0, err
        outs[name] = out.replace(str(tmp_path / name), "OUT")
    assert outs["torch"] == outs["jax"] and outs["torch"].startswith(f"task {task}")
    _same_result(json.loads((tmp_path / "torch.json").read_text()), json.loads((tmp_path / "jax.json").read_text()))


def test_cli_eval_rules_match_the_jax_cli(tmp_path, capsys):
    for args in (["eval", "--task", "mask", "-i", tmp_path], ["eval", "-i", tmp_path, "--gt", tmp_path]):
        for cli in (jcli, tcli):
            with pytest.raises(SystemExit):
                cli.main([str(a) for a in args])
    capsys.readouterr()
    gguf = write_family_gguf("depthany", tmp_path)
    PILImage.fromarray(sample_image(28, 28)).save(tmp_path / "x.png")
    for args, message in (
        (["eval", "--task", "nope", "-i", tmp_path, "--gt", tmp_path], None),
        (["eval", "-m", gguf, "-i", tmp_path / "x.png", "--gt", tmp_path, "-b", "cpu"], "takes an image DIRECTORY"),
        (["eval", "-m", gguf, "-i", tmp_path, tmp_path, "--gt", tmp_path, "-b", "cpu"], "one input directory"),
        (["eval", "--task", "depth", "-i", tmp_path / "none", "--gt", tmp_path], "is not a directory"),
    ):
        if message is None:
            for cli in (jcli, tcli):
                with pytest.raises(SystemExit):
                    cli.main([str(a) for a in args])
            capsys.readouterr()
            continue
        got, want = _run(tcli, args, capsys), _run(jcli, args, capsys)
        assert got[0] == want[0] == 1 and message in got[2] and got[2] == want[2]


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    """Three seeded images, the small Depth-Anything and YOLOv9t GGUFs, and
    ground truth: depth as 16-bit PNGs, boxes as per-image .txt."""
    d = tmp_path_factory.mktemp("torch_eval_cli")
    rng = np.random.default_rng(11)
    _mkdir(d / "in")
    _mkdir(d / "gt_depth")
    _mkdir(d / "gt_boxes")
    for i, (h, w) in enumerate(((56, 70), (70, 56), (56, 56))):
        PILImage.fromarray(sample_image(h, w)[:, ::-1] if i % 2 else sample_image(h, w)).save(d / "in" / f"i{i}.png")
        g = (rng.uniform(0.05, 1.0, (h, w)) * 65535).astype(np.uint16)
        PILImage.fromarray(g).save(d / "gt_depth" / f"i{i}.png")
        (d / "gt_boxes" / f"i{i}.txt").write_text(f"person 2 3 {w // 2} {h // 2}\n{i} 10 10 {w - 2} {h - 2}\n")
    for family in ("depthany", "yolov9t"):
        write_family_gguf(family, d)
    return d


@pytest.mark.parametrize("family, gt", [("depthany", "gt_depth"), ("yolov9t", "gt_boxes")])
def test_cli_eval_with_a_model_matches_the_jax_cli(family, gt, eval_data, tmp_path, capsys):
    """eval -m: each package's bulk_run on the CPU feeds its scorer; the task
    comes from the model's family. The reports print the same lines, the
    scores agree within CLI_TOL, and the kept predictions are alike."""
    reports = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        rc, out, err = _run(cli, ["eval", "-m", eval_data / f"{family}.gguf", "-i", eval_data / "in", "--gt",
                                  eval_data / gt, "-b", "cpu", "-o", tmp_path / f"{name}.json",
                                  "--pred-out", tmp_path / f"pred_{name}"], capsys)
        assert rc == 0, err
        reports[name] = out[out.index("task "):].splitlines()[:-1]  # the last line names the -o file
    got, want = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("torch", "jax"))
    _same_result(got, want, tol=CLI_TOL)
    assert [ln.split()[0] for ln in reports["torch"]] == [ln.split()[0] for ln in reports["jax"]]
    assert reports["torch"][0] == reports["jax"][0]
    assert got["task"] == ("depth" if family == "depthany" else "detection") and got["n_images"] == 3
    if family == "depthany":
        assert 0 < got["mean"]["absrel"] < 10 and sorted(p.name for p in (tmp_path / "pred_torch").iterdir()) == [
            "i0.png", "i1.png", "i2.png"]
    else:
        assert (tmp_path / "pred_torch" / "detections.json").is_file()
