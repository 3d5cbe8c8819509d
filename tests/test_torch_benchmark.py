"""The port's vision-bench (vision_tpu_torch/benchmark.py) against the JAX
package's (vision_tpu/benchmark.py), on the CPU: the same eleven rows in the
same order; the same table and JSON lines over stubbed rows, with MFU
against the H100's dense bf16 peak; a real CPU run of the cheapest row; and
four rows' f32 outputs before the sum against the JAX rows' forwards, on the
same seeded weights and inputs. The rows' FLOP counts are held in
tests/test_torch_benchmark_flops.py (a file of their own, so that the two
halves' ~40 s each run on different workers)."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_tpu.benchmark as vb
import vision_tpu_torch.benchmark as tb
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.params import Params as JaxParams
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError

H100_SXM = "NVIDIA H100 80GB HBM3"
REL_RMS = 1e-4  # tests/test_golden.py's bound: f32 on both sides, summation order only


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU forwards here on one thread: the suite runs several
    workers at once, and a worker's eight intra-op threads among the others'
    slowed the YOLOv9t row's forward from ~1 s to over a minute."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _row(name, gflop, mean, stdev, k, kind=H100_SXM):
    tf, mfu = tb.workload_mfu(gflop, mean, kind)
    return {"name": name, "mean_ms": mean, "stdev_ms": stdev, "k": k, "gflop": gflop, "tf_per_sec": tf, "mfu": mfu}


def test_benchmark_table_and_json_output(monkeypatch, capsys):
    rows = [_row("sam-encode-1024", 79.6, 3.456, 0.12, 8), _row("yolov9t-640", 11.2, 1.6, 0.05, 256)]
    monkeypatch.setattr(tb, "run_benchmark", lambda names=None, k=8, repeats=3, device=None: rows)

    assert tb.main([]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "device ms/iter, per CUDA-graph replay, timed by CUDA events"
    assert "| sam-encode-1024" in out and "3.5ms" in out and "256" in out
    assert "TF/s" in out and "MFU" in out
    assert "23.0" in out  # 79.6 GFLOP / 3.456 ms = 23.0 TF/s
    assert "2.3%" in out  # 23.0 / 989 peak

    assert tb.main(["--json"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["metric"] == "sam-encode-1024" and lines[0]["value"] == 3.456
    assert lines[0]["gflop"] == 79.6
    assert lines[0]["tf_per_sec"] == pytest.approx(23.03, abs=0.01)
    assert lines[0]["mfu"] == pytest.approx(0.0233, abs=0.0001)
    assert lines[1]["metric"] == "yolov9t-640" and lines[1]["k"] == 256

    assert tb.main(["--backend", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "host ms/iter, eager calls on the CPU timed by time.perf_counter"


def test_benchmark_rejects_unknown_model():
    with pytest.raises(SystemExit):
        tb.main(["no-such-model"])
    with pytest.raises(VispError, match="unknown benchmark"):
        tb.run_benchmark(["no-such-model"], device="cpu")


def test_the_rows_are_the_jax_packages():
    assert list(tb.BENCHMARKS) == list(vb.BENCHMARKS) and len(tb.BENCHMARKS) == 11


def test_workload_mfu_unknown_device():
    """The CPU and unknown cards report TF/s but no MFU; rows without a
    FLOP figure report neither. The port states no TPU figure."""
    tf, mfu = tb.workload_mfu(79.6, 4.0, "cpu")
    assert tf == pytest.approx(19.9) and mfu is None
    assert tb.workload_mfu(79.6, 4.0, "TPU v5 lite") == (tf, None)
    assert tb.workload_mfu(None, 4.0, H100_SXM) == (None, None)
    assert tb.workload_mfu(0.0, 4.0, H100_SXM) == (None, None)
    assert tb.workload_mfu(79.6, 0.0, H100_SXM) == (None, None)
    assert tb.PEAK_TF_PER_SEC == {H100_SXM: 989.0, "NVIDIA H100 PCIe": 756.0, "NVIDIA H100 NVL": 835.0}


def test_run_benchmark_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VispError, match="no CUDA device"):
        tb.run_benchmark(["sam-decode"])


def test_run_benchmark_on_the_cpu(capsys):
    (row,) = tb.run_benchmark(["sam-decode"], k=2, repeats=2, device="cpu")
    assert row["name"] == "sam-decode" and row["k"] == 2
    assert math.isfinite(row["mean_ms"]) and row["mean_ms"] > 0 and math.isfinite(row["stdev_ms"])
    assert row["gflop"] == pytest.approx(6.0385, rel=1e-4) and row["tf_per_sec"] > 0 and row["mfu"] is None
    assert math.isfinite(row["value"]) and "launches" not in row  # no capture on the CPU
    assert capsys.readouterr().err.startswith("# sam-decode: ")


def _jax_forward(name):
    """The JAX row's forward before its sum (vision_tpu/benchmark.py's
    steps), every output in a list, at f32."""
    dt = jnp.float32
    if name == "sam-decode":
        from vision_tpu.models.mobile_sam import sam_encode_points, sam_predict_mask

        def forward(w, c):
            pp = JaxParams(w)
            pred = sam_predict_mask(pp, jnp.zeros((1, 64, 64, 256), dt), sam_encode_points(pp, c))
            return [pred.masks, pred.iou]
    elif name == "migan-512":
        from vision_tpu.models.migan import MiganParams, migan_generate

        def forward(w, x):
            return [migan_generate(JaxParams(w), x.astype(dt), MiganParams(resolution=512))]
    elif name == "yolov9t-640":
        from vision_tpu.models.yolov9t import Yolov9tParams, yolov9t_forward
        from vision_tpu.ops.preprocess import normalize_u8

        def forward(w, x):
            out = yolov9t_forward(JaxParams(w), normalize_u8(x, dtype=dt), Yolov9tParams())
            return [out.boxes, out.scores]
    else:
        from vision_tpu.models.depth_anything import DepthAnythingParams, depthany_predict
        from vision_tpu.models.dino import DinoParams
        from vision_tpu.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

        p = DepthAnythingParams(dino=DinoParams(14, 384, 6, 12), feature_layers=(2, 5, 8, 11))

        def forward(w, x):
            return [depthany_predict(JaxParams(w), normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, dt), p, flash=True)]
    return forward


@pytest.mark.parametrize("name", ["sam-decode", "migan-512", "yolov9t-640", "depthany-small"])
def test_row_outputs_match_the_jax_rows(name):
    """The port's forward of each row (step.forward, what the step sums)
    against the JAX row's, f32 on the CPU, each from its package's own
    random weights of the same seed and the same input."""
    step, params, x = tb.BENCHMARKS[name](backend_init("cpu"), torch.float32)
    with torch.inference_mode():
        got = [t.numpy() for t in tb._leaves(step.forward(params, x))]
        value = float(step(params, x))
    _, jparams, jx = vb.BENCHMARKS[name](jax_backend_init("cpu"), jnp.float32)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    want = [np.asarray(a) for a in jax.jit(_jax_forward(name))(jparams, jx)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        w64 = w.astype(np.float64)
        rel = np.sqrt(np.mean((g - w64) ** 2)) / np.sqrt(np.mean(w64**2))
        assert rel <= REL_RMS, rel
    # the step is the f32 sum of those outputs (to f32 summation order)
    total = sum(float(g.astype(np.float64).sum()) for g in got)
    assert abs(value - total) <= 1e-5 * sum(float(np.abs(g).astype(np.float64).sum()) for g in got)
