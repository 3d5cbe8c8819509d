"""The port's debugging and measurement tools on the CPU, against the JAX
package's: capture names and values (``dino_layer_*``, ``model.*``) of the
same weights and inputs, captures that survive a later in-place write and
refuse a CUDA-graph capture, ``dump_captures`` file names and
``compare_dumps`` reports, ``Timer``, ``trace`` writing a Chrome trace that
names the ``vtt`` operators, and ``count_flops`` equal to
``vision_tpu.utils.flops.count_flops`` for each family."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_api import write_family_gguf
from vision_tpu import api as japi
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.params import Params as JParams
from vision_tpu.ops import debug as jdebug
from vision_tpu.utils import dump as jdump
from vision_tpu.utils.flops import count_flops as jax_count_flops
from vision_tpu_torch import load_model
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.ops import debug
from vision_tpu_torch.utils import Timer, compare_dumps, dump_captures, trace
from vision_tpu_torch.utils.flops import count_flops
from vision_tpu_torch.utils.profiling import device_barrier
from torch_threads import torch_threads  # noqa: F401

REL_RMS = 1e-4  # tests/test_golden.py:23


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12))


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("utils")
    return {f: write_family_gguf(f, d) for f in ("depthany", "yolov9t", "esrgan", "migan", "birefnet", "sam")}


def _u8(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _jax_depth_captures(path, x):
    from vision_tpu.models.depth_anything import depthany_predict
    from vision_tpu.ops.preprocess import normalize_u8
    from vision_tpu.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

    jm = japi.load_model(path, jax_backend_init("cpu"))
    with jdebug.capture_context() as caps:
        depthany_predict(JParams(jm.params), normalize_u8(jnp.asarray(x), IMAGENET_MEAN, IMAGENET_STD, jnp.float32),
                         jm.p)
    return caps


def _jax_yolo_captures(path, x):
    from vision_tpu.models.yolov9t import yolov9t_forward

    jm = japi.load_model(path, jax_backend_init("cpu"))
    with jdebug.capture_context() as caps:
        yolov9t_forward(JParams(jm.params), x.astype(np.float32) / 255.0, jm.p)
    return caps


@pytest.mark.parametrize("family", ["depthany", "yolov9t"])
def test_captures_match_jax(family, ggufs):
    x = _u8(1, 1, 126, 126, 3) if family == "depthany" else _u8(1, 1, 64, 96, 3)
    model = load_model(ggufs[family], backend_init("cpu"))
    with debug.capture_context() as caps:
        assert debug.capturing()
        model._forward_u8(torch.from_numpy(x))
    assert not debug.capturing()
    jcaps = (_jax_depth_captures if family == "depthany" else _jax_yolo_captures)(ggufs[family], x)
    assert list(caps) == list(jcaps)
    assert list(caps) == ([f"dino_layer_{i}" for i in range(4)] if family == "depthany"
                          else [f"model.{i}" for i in range(22)])
    for name in caps:
        assert tuple(caps[name].shape) == tuple(jcaps[name].shape), name
        assert _rel(caps[name].numpy(), jcaps[name]) <= REL_RMS, name


def test_a_capture_is_a_copy():
    buf = torch.zeros(2, 3)
    with debug.capture_context() as caps:
        assert debug.capture("view", buf[:, 1:]) is not None
        buf.add_(1.0)  # a later layer writes into the buffer
    assert torch.equal(caps["view"], torch.zeros(2, 2))
    assert debug.capture("outside", buf) is buf  # no context: a no-op


def test_capture_refuses_a_cuda_graph_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    debug.capture("nothing", torch.ones(1))  # no context: nothing recorded, nothing refused
    with debug.capture_context(), pytest.raises(RuntimeError, match="CUDA graph"):
        debug.capture("layer", torch.ones(1))


def test_dump_names_and_files_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"model.0": rng.standard_normal((1, 4, 4, 2)).astype(np.float32), "model_0": np.ones(3, np.float32),
              "a/b.c": rng.standard_normal(5).astype(np.float32)}
    caps = {k: torch.from_numpy(v) for k, v in arrays.items()}
    caps["bf16"] = torch.from_numpy(arrays["model.0"]).bfloat16()
    jcaps = dict(arrays, bf16=jnp.asarray(arrays["model.0"]).astype(jnp.bfloat16))
    port = dump_captures(caps, tmp_path / "port")
    jax_ = jdump.dump_captures(jcaps, tmp_path / "jax")
    assert [p.rsplit("/", 1)[1] for p in port] == [p.rsplit("/", 1)[1] for p in jax_] == [
        "model_0.npy", "model_0__2.npy", "a_b_c.npy", "bf16.npy"]
    for p, j in zip(port, jax_):
        a, b = np.load(p), np.load(j)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_compare_dumps_reports_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    a = {"same": rng.standard_normal(8).astype(np.float32), "off": np.zeros(4, np.float32),
         "shape": np.zeros(3, np.float32), "only_a": np.zeros(1, np.float32)}
    b = {"same": a["same"], "off": np.full(4, 0.5, np.float32), "shape": np.zeros(4, np.float32),
         "only_b": np.zeros(1, np.float32)}
    dump_captures(a, tmp_path / "a")
    dump_captures(b, tmp_path / "b")
    report = compare_dumps(tmp_path / "a", tmp_path / "b")
    assert report == jdump.compare_dumps(tmp_path / "a", tmp_path / "b")
    assert {k: v["status"] for k, v in report.items()} == {
        "same.npy": "ok", "off.npy": "mismatch", "shape.npy": "shape_mismatch", "only_a.npy": "missing_in_b",
        "only_b.npy": "missing_in_a"}


def test_timer(capsys):
    with Timer("phase") as t:
        sum(range(1000))
    assert t.elapsed > 0 and t.elapsed_str().endswith(" ms")
    assert capsys.readouterr().out.startswith("phase: ")
    with Timer("quiet", verbose=False):
        pass
    assert capsys.readouterr().out == ""


def test_trace_writes_a_chrome_trace_naming_the_ops(tmp_path):
    from vision_tpu_torch.ops.cuda.conv3x3 import conv3x3

    x, w = torch.randn(1, 6, 6, 4), torch.randn(3, 4, 3, 3)
    with trace(str(tmp_path / "prof")):
        y = conv3x3(x, w)
        device_barrier(y)  # a CPU tensor: nothing to wait for
    files = list((tmp_path / "prof").glob("*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "vtt::conv3x3" in names


def _jax_program(family, jm, x):
    """The JAX model's program of ``family`` and its arguments."""
    if family in ("depthany", "birefnet"):
        return jm._fn((x.shape[2], x.shape[1])), (jm.params, x)
    if family == "esrgan":  # the model's own convs: the packed program's are padded to lane widths
        from vision_tpu.models.esrgan import esrgan_generate
        from vision_tpu.ops.preprocess import normalize_u8

        return lambda p, x: esrgan_generate(JParams(p), normalize_u8(x, dtype=jnp.float32), jm.p), (jm.params, x)
    if family == "yolov9t":
        return jm._run, (jm.params, x)
    if family == "sam":
        return jm._enc_single, (jm.params, x)
    return jm._run, (jm.params, x, x[..., :1])  # migan: image, mask


FLOP_INPUTS = {"depthany": (1, 126, 126, 3), "birefnet": (1, 64, 64, 3), "esrgan": (2, 24, 32, 3),
               "yolov9t": (1, 640, 640, 3), "sam": (1, 1024, 1024, 3), "migan": (1, 64, 64, 3)}


@pytest.mark.parametrize("family", sorted(FLOP_INPUTS))
def test_count_flops_matches_jax(family, ggufs):
    x = _u8(2, *FLOP_INPUTS[family])
    model = load_model(ggufs[family], backend_init("cpu"))
    jm = japi.load_model(ggufs[family], jax_backend_init("cpu"))
    fn, args = _jax_program(family, jm, jnp.asarray(x))
    want = jax_count_flops(fn, *args)
    forward = model.encode_u8 if family == "sam" else model._forward_u8
    targs = (torch.from_numpy(x),) if family != "migan" else (torch.from_numpy(x), torch.from_numpy(x[..., :1]))
    got = count_flops(forward, *targs)
    assert want > 0 and got == want
    # the trace ran on fake tensors and left none in the constant caches
    from torch._subclasses.fake_tensor import FakeTensor

    out = forward(*targs)
    assert not any(isinstance(t, FakeTensor) for t in (out if isinstance(out, tuple) else (out,)))
