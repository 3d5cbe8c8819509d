"""The port's bulk.py and the CLI's directory input against the JAX
package's, on the CPU with the small GGUFs of tests/test_torch_api.py: both
packages' bulk_run over one directory (Depth-Anything at mixed extents,
MI-GAN with its masks paired by stem, YOLOv9t with detections.json), every
written PNG within one u8 level of the JAX one on at most 0.1% of its values
(the rule of tests/test_torch_cli.py), YOLOv9t's boxes within 1e-3 px and
confidences within 1e-4 (as bulk_run hands them to draw_detections; its JSON
rounds them to 0.1 px and 1e-4); and the per-item failure, the refusals and
their messages, and ``<verb> -i <dir>``."""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

import vision_tpu.cli as jcli
import vision_tpu_torch.cli as tcli
from test_torch_api import sample_image, write_family_gguf
from vision_tpu import api as japi
from vision_tpu import bulk as jbulk
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.errors import VispError as JaxVispError
from vision_tpu.models import yolov9t as jyolo
from vision_tpu_torch import api
from vision_tpu_torch import bulk as tbulk
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.models import yolov9t as tyolo

MAX_SHARE_OFF = 1e-3  # share of values that may differ, by one u8 level at most
BOX_TOL, CONF_TOL = 1e-3, 1e-4

EXTENTS = {  # family -> (stem, (h, w)) of its inputs
    "depthany": [("a", (126, 140)), ("b", (126, 140)), ("c", (98, 98)), ("d", (126, 140)), ("e", (98, 98)),
                 ("f", (70, 112))],
    "migan": [("x", (64, 64)), ("y", (80, 96)), ("z", (64, 64))],
    "yolov9t": [("u", (100, 120)), ("v", (80, 90)), ("w", (64, 64))],
}


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_bulk")
    return {family: write_family_gguf(family, d) for family in EXTENTS}


@pytest.fixture(scope="module")
def models(ggufs):
    """family -> (the port's model, the JAX package's), both on the CPU."""
    return {f: (api.load_model(p, backend_init("cpu")), japi.load_model(p, jax_backend_init("cpu")))
            for f, p in ggufs.items()}


def _write_images(d, specs, channels=3, seed=0):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i, (name, (h, w)) in enumerate(specs):
        if channels == 1:
            a = np.zeros((h, w), np.uint8)
            a[h // 4 : h // 2 + i * 4, w // 3 : w * 2 // 3] = 255
        else:
            a = np.roll(sample_image(h, w), 7 * i, axis=1) ^ rng.integers(0, 4, (h, w, 3), np.uint8)
        PILImage.fromarray(a).save(d / f"{name}.png")
        paths.append(str(d / f"{name}.png"))
    return paths


def _close(a_path, b_path):
    a = np.asarray(PILImage.open(a_path)).astype(int)
    b = np.asarray(PILImage.open(b_path)).astype(int)
    assert a.shape == b.shape, (a_path, a.shape, b.shape)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE_OFF, (a_path, diff.max(), (diff > 0).mean())


def _inputs(bulk, family, tmp_path):
    images = bulk.bulk_inputs(tmp_path / "in")
    return bulk.pair_masks(images, str(tmp_path / "mask")) if family == "migan" else images


@pytest.mark.parametrize("family", sorted(EXTENTS))
def test_bulk_run_matches_jax(family, models, tmp_path, monkeypatch):
    _write_images(tmp_path / "in", EXTENTS[family])
    if family == "migan":
        _write_images(tmp_path / "mask", EXTENTS[family], channels=1)
    drawn = {}  # package -> the detections bulk_run handed to draw_detections, in input order
    for name, module in (("jax", jyolo), ("torch", tyolo)):
        draw = module.draw_detections
        drawn[name] = []
        monkeypatch.setattr(module, "draw_detections", lambda img, dets, _d=draw, _l=drawn[name]: (
            _l.append(list(dets)), _d(img, dets))[1])
    logs = {"jax": [], "torch": []}
    outs = {}
    for name, bulk, model in (("jax", jbulk, models[family][1]), ("torch", tbulk, models[family][0])):
        outs[name] = bulk.bulk_run(model, _inputs(bulk, family, tmp_path), tmp_path / name, batch_size=2,
                                   conf_thres=0.3, log=logs[name].append)
    stems = [s for s, _ in EXTENTS[family]]
    want_files = [f"{s}.png" for s in stems] + (["detections.json"] if family == "yolov9t" else [])
    assert [Path(o).name for o in outs["torch"]] == [Path(o).name for o in outs["jax"]] == want_files
    for s, (h, w) in EXTENTS[family]:
        _close(tmp_path / "torch" / f"{s}.png", tmp_path / "jax" / f"{s}.png")
        assert PILImage.open(tmp_path / "torch" / f"{s}.png").size == (w, h)
    assert logs["torch"][-1].split(" in ")[0] == logs["jax"][-1].split(" in ")[0] == f"  {len(stems)} images"
    assert "occupancy" in logs["torch"][-1]
    if family == "yolov9t":
        got, want = (json.loads((tmp_path / n / "detections.json").read_text()) for n in ("torch", "jax"))
        assert got.keys() == want.keys() == set(stems)
        assert sum(map(len, got.values())) > 0
        for s in stems:
            assert [d["class"] for d in got[s]] == [d["class"] for d in want[s]], s
            for g, j in zip(got[s], want[s]):
                # the JSON's 0.1 px and 1e-4 roundings of values within BOX_TOL / CONF_TOL
                assert np.abs(np.subtract(g["box"], j["box"])).max() <= 0.1 + BOX_TOL
                assert abs(g["confidence"] - j["confidence"]) <= 1e-4 + CONF_TOL
        assert len(drawn["torch"]) == len(drawn["jax"]) == len(stems)
        for got_dets, want_dets in zip(drawn["torch"], drawn["jax"]):
            assert len(got_dets) == len(want_dets)
            for g, j in zip(got_dets, want_dets):
                assert g.class_id == j.class_id and abs(g.confidence - j.confidence) <= CONF_TOL
                assert max(abs(g.x1 - j.x1), abs(g.y1 - j.y1), abs(g.x2 - j.x2), abs(g.y2 - j.y2)) <= BOX_TOL


def test_bulk_corrupt_image_is_logged_and_skipped(models, tmp_path):
    _write_images(tmp_path / "in", [("a", (98, 98)), ("c", (98, 98))])
    (tmp_path / "in" / "b.png").write_bytes(b"not a png at all")
    logs = []
    outs = tbulk.bulk_run(models["depthany"][0], tbulk.bulk_inputs(tmp_path / "in"), tmp_path / "out",
                          log=logs.append)
    assert sorted(Path(o).name for o in outs) == ["a.png", "c.png"]
    assert any("FAILED" in line and "b.png" in line for line in logs)
    assert "1 failed" in logs[-1]
    with pytest.raises(VispError, match="all 1 inputs failed"):
        tbulk.bulk_run(models["depthany"][0], [str(tmp_path / "in" / "b.png")], tmp_path / "out2", log=logs.append)


def _error_cases(d, model_of):
    """(label, call(bulk, model)) of every refusal; the files they read."""
    _write_images(d / "dup", [("a", (98, 98))])
    (d / "dup" / "a.jpg").write_bytes(b"content never read")
    srcs = _write_images(d / "same", [("s", (98, 98))])
    _write_images(d / "img", [("x", (64, 64))])
    _write_images(d / "mask", [("y", (64, 64))], channels=1)
    (d / "empty").mkdir()
    return [
        ("duplicate_stem", lambda b: b.bulk_run(model_of(b, "depthany"), b.bulk_inputs(d / "dup"), d / "o",
                                                log=lambda *_: None)),
        ("overwrite", lambda b: b.bulk_run(model_of(b, "depthany"), srcs, d / "same", log=lambda *_: None)),
        ("not_a_directory", lambda b: b.bulk_inputs(d / "nope")),
        ("no_images", lambda b: b.bulk_inputs(d / "empty")),
        ("unsupported_model", lambda b: b.bulk_run(object(), ["x.png"], d / "o")),
        ("no_mask", lambda b: b.pair_masks(b.bulk_inputs(d / "img"), str(d / "mask"))),
    ]


@pytest.mark.parametrize("case", ["duplicate_stem", "overwrite", "not_a_directory", "no_images",
                                  "unsupported_model", "no_mask"])
def test_bulk_refusals_match_jax(case, models, tmp_path):
    """The plan is refused before any image is decoded, with the JAX
    package's message."""
    cases = dict(_error_cases(tmp_path, lambda b, f: models[f][0 if b is tbulk else 1]))
    with pytest.raises(JaxVispError) as want:
        cases[case](jbulk)
    with pytest.raises(VispError) as got:
        cases[case](tbulk)
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "o").exists() or not any((tmp_path / "o").iterdir())


def _run(cli, args, capsys):
    rc = cli.main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("verb", ["depthany", "migan"])
def test_cli_directory_input_matches_the_jax_cli(verb, ggufs, tmp_path, capsys):
    _write_images(tmp_path / "in", EXTENTS[verb][:3])
    inputs = [tmp_path / "in"]
    if verb == "migan":
        _write_images(tmp_path / "mask", EXTENTS[verb][:3], channels=1)
        inputs.append(tmp_path / "mask")
    outs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        rc, out, err = _run(cli, [verb, "-m", ggufs[verb], "-b", "cpu", "-i", *inputs, "-o", tmp_path / name],
                            capsys)
        assert rc == 0, err
        outs[name] = out
    names = {n: sorted(p.name for p in (tmp_path / n).iterdir()) for n in ("torch", "jax")}
    assert names["torch"] == names["jax"]
    for s, _ in EXTENTS[verb][:3]:
        _close(tmp_path / "torch" / f"{s}.png", tmp_path / "jax" / f"{s}.png")
    assert "Processing 3 images -> " in outs["torch"] and outs["torch"].rstrip().endswith(
        f"-> 3 files written to {tmp_path / 'torch'}/")


def test_cli_directory_rules_match_the_jax_cli(ggufs, tmp_path, capsys):
    _write_images(tmp_path / "in", EXTENTS["migan"][:1])
    _write_images(tmp_path / "in" / "nested", EXTENTS["migan"][:1])  # not an image: skipped by bulk_inputs
    (tmp_path / "empty").mkdir()
    for args, message in (
        (["migan", "-m", ggufs["migan"], "-b", "cpu", "-i", tmp_path / "in", tmp_path / "in" / "x.png"],
         "migan bulk mode takes two directories"),
        (["depthany", "-m", ggufs["depthany"], "-b", "cpu", "-i", tmp_path / "empty"], "bulk: no images"),
        (["migan", "-m", ggufs["migan"], "-b", "cpu", "-i", tmp_path / "in"], "Expected -i to be followed by 2"),
    ):
        got = _run(tcli, args + ["-o", tmp_path / "o"], capsys)
        want = _run(jcli, args + ["-o", tmp_path / "o"], capsys)
        assert got[0] == want[0] == 1 and got[2] == want[2] and message in got[2], (got, want)


def test_cli_default_output_of_a_directory_is_bulk_out(ggufs, tmp_path, capsys, monkeypatch):
    _write_images(tmp_path / "in", EXTENTS["depthany"][:2])
    monkeypatch.chdir(tmp_path)
    rc, out, err = _run(tcli, ["depthany", "-m", ggufs["depthany"], "-b", "cpu", "-i", tmp_path / "in"], capsys)
    assert rc == 0, err
    assert sorted(p.name for p in (tmp_path / "bulk_out").iterdir()) == ["a.png", "b.png"]
