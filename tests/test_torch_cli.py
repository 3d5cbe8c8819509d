"""The port's CLI against the JAX package's, both with ``-b cpu`` on the same
small GGUFs and inputs: every model verb's output file within one u8 level
of the JAX CLI's, on at most 0.1% of the values; yolov9t's detections
printed alike; ``info`` and ``compare`` printing the same lines; ``export``
writing the bundle the JAX CLI writes the entries of; ``--dump`` writing the
JAX CLI's files within ``compare_dumps``' bounds; ``--profile`` writing a
trace that names the ``vtt`` operators; ``bench`` handing its arguments to
the benchmark; and the CLI's own rules (no CPU fallback, arity, unknown
verbs)."""

import json
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
    # finetune and distill are verbs (tests/test_torch_finetune.py) that need their models
    assert "Model file not found: RealESRGAN-x4.gguf" in _run(tcli, ["finetune", "-i", "x"], capsys)[2]
    assert _run(tcli, ["distill", "-i", "x"], capsys)[2] == "Error: No model specified (-m)\n"
    # export is a verb (tests/test_torch_export.py) that needs -m; bench is a verb
    # (test_bench_verb_forwards_its_arguments) whose rows are the benchmark's
    assert _run(tcli, ["export"], capsys)[2] == "Error: No model specified (-m)\n"
    with pytest.raises(SystemExit):
        tcli.main(["bench", "--bench-args", "no-such-model"])
    capsys.readouterr()


def test_bench_verb_forwards_its_arguments(monkeypatch, capsys):
    """bench needs no -i, and hands --bench-args, with -b as --backend, to
    benchmark.main, which prints the JAX package's table or JSON lines."""
    import vision_tpu_torch.benchmark as tb

    calls = []

    def run_benchmark(names=None, k=8, repeats=3, device=None):
        calls.append((names, k, repeats, device))
        tf, mfu = tb.workload_mfu(6.04, 1.763, "cpu")
        return [{"name": "sam-decode", "mean_ms": 1.763, "stdev_ms": 0.001, "k": k, "gflop": 6.04,
                 "tf_per_sec": tf, "mfu": mfu}]

    monkeypatch.setattr(tb, "run_benchmark", run_benchmark)
    rc, out, err = _run(tcli, ["bench", "-b", "cpu", "--bench-args", "sam-decode", "--k", "2", "--repeats", "4"],
                        capsys)
    assert rc == 0 and calls[-1] == (["sam-decode"], 2, 4, "cpu"), err
    lines = out.splitlines()
    assert lines[0] == "host ms/iter, eager calls on the CPU timed by time.perf_counter"
    assert lines[1].startswith("| benchmark") and lines[3].startswith("| sam-decode") and "1.8ms" in lines[3]
    rc, out, _ = _run(tcli, ["bench", "--bench-args", "--json"], capsys)  # no -b: the card, every row
    assert rc == 0 and calls[-1] == (None, 8, 3, None)
    assert json.loads(out) == {"metric": "sam-decode", "value": 1.763, "unit": "ms/iter", "stdev": 0.001, "k": 8,
                               "gflop": 6.0, "tf_per_sec": 3.43}


def test_the_benchmark_module_entry_point_runs():
    res = subprocess.run([sys.executable, "-m", "vision_tpu_torch.benchmark", "--help"],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.startswith("usage: vision-bench"), res.stderr
    assert all(name in res.stdout for name in ("sam-encode-1024", "birefnet-full-1024", "sam3-vision-1008"))


def test_the_module_entry_point_runs(data):
    res = subprocess.run([sys.executable, "-m", "vision_tpu_torch.cli", "info", "-m", str(data / "esrgan.gguf")],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "family: esrgan" in res.stdout, res.stderr


@pytest.mark.parametrize("family,extra,entries", [
    ("yolov9t", ["--batch", "2"], "forward"),
    ("depthany", ["--extent", "60", "50", "--no-embed"], "forward"),
    ("esrgan", ["--extent", "16", "12"], "upscale"),
])
def test_export_verb_writes_the_jax_clis_entries(family, extra, entries, data, tmp_path, capsys):
    from vision_tpu_torch.export import load_bundle

    dst = tmp_path / "m.vxp"
    rc, out, err = _run(tcli, ["export", "-m", data / f"{family}.gguf", "-b", "cpu", "-o", dst, *extra], capsys)
    assert rc == 0, err
    assert out.splitlines()[-1].endswith(f"MB; entries: {entries})")
    rc, jout, err = _run(jcli, ["export", "-m", data / f"{family}.gguf", "-b", "cpu", "-o", tmp_path / "j.vxp",
                                *extra], capsys)
    assert rc == 0, err
    assert jout.splitlines()[-1].endswith(f"MB; entries: {entries})")
    bundle = load_bundle(dst)
    assert bundle.names == [entries] and bundle.meta["params_embedded"] == ("--no-embed" not in extra)
    if family == "yolov9t":
        assert bundle.input_specs("forward") == [[[2, 640, 640, 3], "uint8"]]
    if family != "yolov9t":  # the extent snapped to the family's grid as the JAX CLI snaps it
        from vision_tpu.export import load_bundle as jax_load_bundle

        assert bundle.meta["extent"] == jax_load_bundle(tmp_path / "j.vxp").meta["extent"]
    assert not (data / f"{family}.vxp").exists()


def test_dump_writes_the_jax_clis_feature_maps(data, tmp_path, capsys):
    from vision_tpu_torch.utils import compare_dumps

    for name, cli in (("jax", jcli), ("torch", tcli)):
        rc, out, err = _run(cli, ["yolov9t", "-m", data / "yolov9t.gguf", "-b", "cpu", "-i", data / "in.png", "-o",
                                  tmp_path / f"{name}.png", "--dump", tmp_path / f"{name}_dump"], capsys)
        assert rc == 0, err
        assert "-> dumped 22 feature maps to" in out
    report = compare_dumps(tmp_path / "jax_dump", tmp_path / "torch_dump")
    assert len(report) == 22 and all(r["status"] == "ok" for r in report.values()), report


@pytest.mark.parametrize("verb,inputs", [("yolov9t", ["{d}/in.png"]), ("esrgan", ["{d}/bulk"])])
def test_profile_writes_a_trace_of_the_inference(verb, inputs, data, tmp_path, capsys):
    import json

    (data / "bulk").mkdir(exist_ok=True)
    PILImage.fromarray(sample_image(24, 32)).save(data / "bulk" / "a.png")
    args = [verb, "-m", data / f"{verb}.gguf", "-b", "cpu", "-i", *[a.format(d=data) for a in inputs], "-o",
            tmp_path / ("out.png" if verb == "yolov9t" else "out"), "--profile", tmp_path / "prof"]
    rc, _, err = _run(tcli, args, capsys)
    assert rc == 0, err
    (trace,) = (tmp_path / "prof").glob("*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    if verb == "yolov9t":  # host-side op events are the calling thread's: bulk runs on a server thread
        assert {"vtt::conv3x3", "vtt::conv3x3_out"} <= names
