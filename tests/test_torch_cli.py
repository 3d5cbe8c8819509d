"""The port's CLI against the JAX package's, both with ``-b cpu`` on the same
small GGUFs and inputs: every model verb's output file within one u8 level
of the JAX CLI's, on at most 0.1% of the values; yolov9t's detections
printed alike; ``info`` and ``compare`` printing the same lines; and the
CLI's own rules (no CPU fallback, arity, unknown verbs)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

import vision_tpu.cli as jcli
import vision_tpu_torch.cli as tcli
from test_torch_api import FAMILIES, sample_image, write_family_gguf

MAX_SHARE_OFF = 1e-3  # share of values that may differ, by one u8 level at most

# verb -> the arguments after -m/-b/-o ({d}: the data directory, {o}: the output stem)
VERBS = {
    "depthany": ["-i", "{d}/in.png"],
    "birefnet": ["-i", "{d}/in.png", "--composite", "{o}_composite.png"],
    "esrgan": ["-i", "{d}/in.png", "--tile", "32"],
    "migan": ["-i", "{d}/in.png", "{d}/mask.png"],
    "yolov9t": ["-i", "{d}/in.png", "--conf", "0.3", "--iou", "0.5"],
    "sam": ["-i", "{d}/in.png", "-p", "40", "30"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    for family in FAMILIES:
        write_family_gguf(family, d)
    PILImage.fromarray(sample_image(72, 96)).save(d / "in.png")
    mask = np.zeros((72, 96), np.uint8)
    mask[20:50, 30:70] = 255
    PILImage.fromarray(mask).save(d / "mask.png")
    return d


def _run(cli, args, capsys):
    rc = cli.main([str(a) for a in args])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _close(a_path, b_path):
    a = np.asarray(PILImage.open(a_path)).astype(int)
    b = np.asarray(PILImage.open(b_path)).astype(int)
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE_OFF, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_model_verb_matches_the_jax_cli(verb, data, tmp_path, capsys):
    outs = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        o = tmp_path / name
        extra = [a.format(d=data, o=o) for a in VERBS[verb]]
        rc, out, err = _run(cli, [verb, "-m", data / f"{verb}.gguf", "-b", "cpu", "-o", f"{o}.png", *extra], capsys)
        assert rc == 0, err
        outs[name] = out
    _close(tmp_path / "jax.png", tmp_path / "torch.png")
    if verb == "birefnet":
        _close(tmp_path / "jax_composite.png", tmp_path / "torch_composite.png")
        assert "-> image composited and saved to" in outs["torch"]
    if verb == "yolov9t":
        found = [o[o.index("Found "): o.index("-> annotated")] for o in (outs["jax"], outs["torch"])]
        assert found[0] == found[1] and found[1].count("\n") > 1
    lines = outs["torch"].splitlines()
    assert lines[0] == "Using device: cpu (cpu, float32)" and lines[-1].startswith("-> ")
    assert any(line.startswith("Loading model weights... done (") for line in lines)


@pytest.mark.parametrize("extra", [[], ["--tensors"]])
@pytest.mark.parametrize("family", ["migan", "yolov9t", "esrgan"])
def test_info_prints_as_the_jax_cli(family, extra, data, capsys):
    args = ["info", "-m", data / f"{family}.gguf", *extra]
    assert _run(tcli, args, capsys) == _run(jcli, args, capsys)


@pytest.mark.parametrize("max_rms", [None, "0.5", "0.0001"])
def test_compare_prints_as_the_jax_cli(max_rms, data, tmp_path, capsys):
    other = sample_image(72, 96)
    other[10:30, 10:40] = 0
    PILImage.fromarray(other).save(tmp_path / "other.png")
    args = ["compare", "-i", data / "in.png", tmp_path / "other.png"] + (["--max-rms", max_rms] if max_rms else [])
    got, want = _run(tcli, args, capsys), _run(jcli, args, capsys)
    assert got == want and got[0] == (2 if max_rms == "0.0001" else 0)


def test_without_b_the_cli_takes_the_card_or_fails(data, tmp_path, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(tcli, ["esrgan", "-m", data / "esrgan.gguf", "-i", data / "in.png", "-o", tmp_path / "o.png"],
                        capsys)
    assert rc == 1 and 'backend_init("cpu")' in err and not (tmp_path / "o.png").exists()


def test_input_rules(data, tmp_path, capsys):
    rc, _, err = _run(tcli, ["migan", "-m", data / "migan.gguf", "-b", "cpu", "-i", data / "in.png"], capsys)
    assert rc == 1 and "Expected -i to be followed by 2 input(s)" in err
    rc, _, err = _run(tcli, ["sam", "-m", data / "sam.gguf", "-b", "cpu", "-i", data / "in.png", "-p", "1", "2", "3"],
                      capsys)
    assert rc == 1 and "Expected 2 (point) or 4 (box)" in err
    rc, _, err = _run(tcli, ["esrgan", "-m", tmp_path / "none.gguf", "-b", "cpu", "-i", data / "in.png"], capsys)
    assert rc == 1 and "Model file not found" in err
    rc, _, err = _run(tcli, ["esrgan", "-m", data / "esrgan.gguf", "-b", "cpu", "-i", tmp_path / "none.png"], capsys)
    assert rc == 1 and "Input file not found" in err
    # a directory is bulk input (tests/test_torch_bulk.py): an empty one has no images
    rc, _, err = _run(tcli, ["esrgan", "-m", data / "esrgan.gguf", "-b", "cpu", "-i", tmp_path], capsys)
    assert rc == 1 and "bulk: no images" in err
    # serve and eval are verbs (tests/test_torch_serve_http.py, tests/test_torch_eval.py)
    assert _run(tcli, ["serve", "-i", "x"], capsys)[2] == "Error: No model specified (-m)\n"
    with pytest.raises(SystemExit):
        tcli.main(["eval", "-i", "x"])  # no --gt
    # quantize is a verb (tests/test_torch_quantize.py) that needs -m
    with pytest.raises(SystemExit):
        tcli.main(["quantize", "-i", "x"])
    assert "quantize requires -m" in capsys.readouterr().err
    for verb in ("finetune", "distill", "bench", "export"):
        with pytest.raises(SystemExit):
            tcli.main([verb, "-i", "x"])
    capsys.readouterr()


def test_the_module_entry_point_runs(data):
    res = subprocess.run([sys.executable, "-m", "vision_tpu_torch.cli", "info", "-m", str(data / "esrgan.gguf")],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "family: esrgan" in res.stdout, res.stderr
