"""The port's YOLOv9t (vision_tpu_torch/models/yolov9t.py) against the JAX
package's, on the same numpy weights (the torch twins of
tests/test_yolov9t.py, or random_yolov9t_params), in f32 on the CPU, where
every stride-1 3x3 conv takes the conv kernel's plain version: each block,
the decode, the whole forward, the goldens, the pre- and post-processing,
NMS (against the JAX package's, its native library and its Python loop),
the loader and YoloServer."""

import numpy as np
import pytest
import torch

import vision_tpu.native as jnative
from test_yolov9t import TAConv, TConv, TELAN1, TRepCSP, TRepConv, TRepNCSPELAN4, TSPPELAN, TYolo
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.params import Params as JParams
from vision_tpu.image import image_load_array as jax_image_load_array
from vision_tpu.models import yolov9t as jyolo
from vision_tpu.models.random_weights import random_yolov9t_params as jax_random_yolov9t_params
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.gguf import GGUFWriter
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat, image_load_array
from vision_tpu_torch.models import yolov9t as yolo
from vision_tpu_torch.models.random_weights import random_yolov9t_params
from vision_tpu_torch.ops.cuda import conv3x3 as cc
from workbench import input_tensor, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4  # f32 sums taken in another order
GOLDEN_RMS = 1e-4  # tests/test_golden.py:23


def _store(module):
    return state_dict_to_params(randomize(module).state_dict())


def _port(store):
    return Params(params_from_numpy(store, "cpu", torch.float32))


def _match(port_out, jax_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=atol, rtol=rtol)


@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (1, 1)])
def test_conv_block(k, s):
    store = _store(TConv(8, 16, k, s))
    x = to_nhwc(input_tensor(2, 8, 12, 11))
    _match(yolo.conv_block(_port(store), torch.from_numpy(x), k, s), jyolo.conv_block(JParams(store), x, k, s))


def test_conv_block_into_a_view_with_a_residual():
    """conv_block with r2 and out: the JAX block plus r2, written into a
    channel view of a wider buffer."""
    store = _store(TConv(8, 16, 3, 1))
    x = to_nhwc(input_tensor(1, 8, 9, 10))
    r2 = to_nhwc(input_tensor(1, 16, 9, 10, seed=4))
    buf = torch.zeros(1, 9, 10, 40)
    got = yolo.conv_block(_port(store), torch.from_numpy(x), 3, r2=torch.from_numpy(r2), out=buf[..., 8:24])
    assert got.data_ptr() == buf[..., 8:24].data_ptr()
    _match(buf[..., 8:24], r2 + np.asarray(jyolo.conv_block(JParams(store), x, 3)))
    assert not buf[..., :8].any() and not buf[..., 24:].any()


def test_rep_conv():
    store = _store(TRepConv(8, 16))
    x = to_nhwc(input_tensor(2, 8, 10, 9))
    _match(yolo.rep_conv(_port(store), torch.from_numpy(x)), jyolo.rep_conv(JParams(store), x))


@pytest.mark.parametrize("n,shortcut", [(1, True), (2, True), (2, False)])
def test_rep_csp(n, shortcut):
    """RepCSP and its RepBottlenecks (shortcut as the second conv's r2)."""
    store = _store(TRepCSP(16, 16, n=n, shortcut=shortcut))
    x = to_nhwc(input_tensor(1, 16, 8, 9))
    _match(yolo.rep_csp(_port(store), torch.from_numpy(x), n, shortcut), jyolo.rep_csp(JParams(store), x, n, shortcut))


@pytest.mark.parametrize("n", [1, 3])
def test_rep_ncspelan4(n):
    store = _store(TRepNCSPELAN4(16, 24, 16, 8, n=n))
    x = to_nhwc(input_tensor(2, 16, 8, 8))
    _match(yolo.rep_ncspelan4(_port(store), torch.from_numpy(x), n), jyolo.rep_ncspelan4(JParams(store), x, n))


def test_elan1():
    store = _store(TELAN1(8, 8, 8, 4))
    x = to_nhwc(input_tensor(1, 8, 8, 8))
    _match(yolo.elan1(_port(store), torch.from_numpy(x)), jyolo.elan1(JParams(store), x))


def test_aconv():
    store = _store(TAConv(8, 12))
    x = to_nhwc(input_tensor(2, 8, 9, 10))
    _match(yolo.aconv(_port(store), torch.from_numpy(x)), jyolo.aconv(JParams(store), x))


def test_sppelan():
    store = _store(TSPPELAN(8, 8, 4))
    x = to_nhwc(input_tensor(1, 8, 8, 8))
    _match(yolo.sppelan(_port(store), torch.from_numpy(x)), jyolo.sppelan(JParams(store), x))


def test_upsample2():
    x = to_nhwc(input_tensor(2, 3, 5, 7))
    _match(yolo.upsample2(torch.from_numpy(x)), jyolo.upsample2(x), atol=0, rtol=0)


def test_dfl_decode():
    logits = (np.random.default_rng(3).standard_normal((2, 10, 64)) * 3).astype(np.float32)
    _match(yolo.dfl_decode(torch.from_numpy(logits), 16), jyolo.dfl_decode(logits, 16))


def test_make_anchors_are_the_jax_packages():
    for shapes in ([(2, 3), (1, 2)], [(80, 80), (40, 40), (20, 20)]):
        for ours, theirs in zip(yolo.make_anchors(shapes), jyolo.make_anchors(shapes)):
            assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def test_dist2bbox():
    rng = np.random.default_rng(4)
    dist = rng.random((2, 7, 4)).astype(np.float32) * 5
    anchors = rng.random((7, 2)).astype(np.float32) * 20
    _match(yolo.dist2bbox(torch.from_numpy(dist), torch.from_numpy(anchors)), jyolo.dist2bbox(dist, anchors))


def test_yolov9t_forward_whole():
    """The TYolo twin (nc 4, one bottleneck), every module at once; the
    stride-1 3x3 convs on the plain version, no kernel launch."""
    store = _store(TYolo())
    x = to_nhwc(input_tensor(1, 3, 64, 64))
    before = cc.launches
    out = yolo.yolov9t_forward(_port(store), torch.from_numpy(x), yolo.Yolov9tParams(num_classes=4), n_csp=1)
    ref = jyolo.yolov9t_forward(JParams(store), x, jyolo.Yolov9tParams(num_classes=4), n_csp=1)
    assert cc.launches == before and out.boxes.dtype == out.scores.dtype == torch.float32
    _match(out.boxes, ref.boxes, atol=1e-4)  # boxes in input pixels, up to ~64
    _match(out.scores, ref.scores)


@pytest.mark.parametrize("name", ["boxes", "scores"])
def test_yolov9t_golden(name):
    """The inputs of tests/test_golden.py::test_golden_yolov9t, against the
    committed yolov9t_boxes / yolov9t_scores goldens."""
    from pathlib import Path

    store = _store(TYolo())
    x = to_nhwc(input_tensor(1, 3, 64, 64))
    out = yolo.yolov9t_forward(_port(store), torch.from_numpy(x), yolo.Yolov9tParams(num_classes=4), n_csp=1)
    got = getattr(out, name).numpy()
    golden = np.load(Path(__file__).parent / "golden" / f"yolov9t_{name}.npz")["output"]
    assert got.shape == golden.shape
    rms = float(np.sqrt(np.mean((golden - got) ** 2)))
    assert rms / (float(np.sqrt(np.mean(golden**2))) + 1e-8) < GOLDEN_RMS


def test_full_width_forward_at_64():
    """random_yolov9t_params (80 classes, three bottlenecks) at a 64x64
    input: 112 stride-1 3x3 convs through the wrapper, the JAX package's
    boxes and scores."""
    store = random_yolov9t_params(0)
    x = (np.random.default_rng(5).standard_normal((1, 64, 64, 3)) * 0.5).astype(np.float32)
    calls = []
    real = cc.conv3x3

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    cc.conv3x3 = spy
    try:
        out = yolo.yolov9t_forward(_port(store), torch.from_numpy(x))
    finally:
        cc.conv3x3 = real
    ref = jyolo.yolov9t_forward(JParams(store), x)
    assert len(calls) == 112 and out.boxes.shape == (1, 84, 4) and out.scores.shape == (1, 84, 80)
    _match(out.boxes, ref.boxes, atol=1e-4)
    _match(out.scores, ref.scores)


@pytest.mark.parametrize("kwargs", [{}, {"seed": 3, "nc": 4}])
def test_random_yolov9t_params_equal_jax(kwargs):
    ours, theirs = random_yolov9t_params(**kwargs), jax_random_yolov9t_params(**kwargs)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("w,h,size", [(200, 100, 64), (100, 200, 64), (640, 480, 640), (500, 375, 640), (33, 17, 64)])
def test_letterbox(w, h, size):
    a = np.random.default_rng(w * h).integers(0, 256, (h, w, 3), np.uint8)
    arr, gain, dw, dh = yolo.letterbox(image_load_array(a), size)
    jarr, jgain, jdw, jdh = jyolo.letterbox(jax_image_load_array(a), size)
    assert arr.shape == (size, size, 3) and np.array_equal(arr, jarr)
    assert (gain, dw, dh) == (jgain, jdw, jdh)


def test_scale_boxes():
    rng = np.random.default_rng(6)
    raw = rng.random((5, 4)) * 640
    make = lambda D: [D(*map(float, b), 0.5, i) for i, b in enumerate(raw)]  # noqa: E731
    ours = yolo.scale_boxes(make(yolo.Detection), (500, 375), 1.28, 0.0, 80.0)
    theirs = jyolo.scale_boxes(make(jyolo.Detection), (500, 375), 1.28, 0.0, 80.0)
    assert [vars(d) for d in ours] == [vars(d) for d in theirs]


# -- NMS --


def _candidates(case):
    """Seeded (boxes (A, 4), scores (A, nc)) sets: boxes clustered so that
    many overlap."""
    rng = np.random.default_rng({"random": 1, "ties": 2, "max_nms": 3, "max_det": 4, "30000": 5}[case])
    a, nc = {"random": (600, 5), "ties": (400, 3), "max_nms": (3000, 4), "max_det": (800, 2), "30000": (8400, 80)}[case]
    centers = rng.random((a, 2)) * 200
    wh = rng.random((a, 2)) * 60 + 5
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 1).astype(np.float32)
    scores = rng.random((a, nc)).astype(np.float32)
    if case == "ties":  # few distinct values: ties broken by candidate order
        scores = np.round(scores * 8) / 8
    return boxes, scores


# (conf_thres, max_det, max_nms) per case
_NMS_CASES = {
    "random": (0.3, 300, 30000),
    "ties": (0.25, 300, 30000),
    "max_nms": (0.1, 300, 500),  # more candidates than max_nms
    "max_det": (0.05, 20, 30000),  # max_det reached
    "30000": (0.25, 300, 30000),  # the served path's size: past max_nms at 30000
}


@pytest.mark.parametrize("case", list(_NMS_CASES))
def test_nms_equals_the_jax_packages(case, monkeypatch):
    """The same detections as the JAX package's non_max_suppression with its
    native library, and with its Python loop (the library made unavailable)."""
    boxes, scores = _candidates(case)
    conf, max_det, max_nms = _NMS_CASES[case]
    ours = yolo.non_max_suppression(boxes, scores, conf, 0.45, max_det, max_nms)
    assert 0 < len(ours) <= max_det
    native = jyolo.non_max_suppression(boxes, scores, conf, 0.45, max_det, max_nms)
    assert [vars(d) for d in ours] == [vars(d) for d in native]
    if case != "30000":  # the Python loop is O(n^2) at 30000 candidates
        monkeypatch.setattr(jnative, "nms_native", lambda *a, **k: None)
        loop = jyolo.non_max_suppression(boxes, scores, conf, 0.45, max_det, max_nms)
        assert [vars(d) for d in ours] == [vars(d) for d in loop]


@pytest.mark.parametrize("case", ["random", "ties", "max_det"])
def test_nms_indices_equal_the_native_library(case):
    """_nms against vision_tpu.native.nms_native on the same candidates,
    several classes, index for index."""
    boxes, scores = _candidates(case)
    a_idx, c_idx = np.nonzero(scores >= 0.2)
    args = (boxes[a_idx], scores[a_idx, c_idx], c_idx, 0.45, 7680, _NMS_CASES[case][1])
    native = jnative.nms_native(*args)
    assert native is not None, "the JAX package's native library did not load"
    assert yolo._nms(*args) == native


# -- loader, model, server --


def _write_gguf(path, store):
    w = GGUFWriter(path, "yolov9t")
    for name, a in store.items():
        w.add_tensor(name, a)
    w.write()
    return str(path)


def _distinct_scores_store(seed=9):
    """TYolo's weights (nc 4, n_csp 1) at a scale that keeps the features
    alive (He-scaled convs, BN scale near 1): the class scores of a request
    are distinct, so the top-K anchors are unambiguous. (With workbench's
    randomize, 0.1 weights and BN scales, the features die out and many
    anchors tie at the K-th score, where torch.topk and jax.lax.top_k may
    keep different ones.)"""
    rng = np.random.default_rng(seed)
    store = {}
    for k, v in state_dict_to_params(TYolo().state_dict()).items():
        if k.endswith("bn.weight"):
            store[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k.endswith("bias"):
            store[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            store[k] = (rng.standard_normal(v.shape) * np.sqrt(2.0 / np.prod(v.shape[1:]))).astype(np.float32)
    return store


@pytest.fixture(scope="module")
def tyolo_gguf(tmp_path_factory):
    """The TYolo twin as a yolov9t GGUF, with distinct class scores."""
    return _write_gguf(tmp_path_factory.mktemp("torch_yolo") / "tyolo.gguf", _distinct_scores_store())


def test_load_model_detects_params_and_matches_jax(tyolo_gguf):
    model = yolo.yolov9t_load_model(tyolo_gguf, backend_init("cpu"))
    jmodel = jyolo.yolov9t_load_model(tyolo_gguf, jax_backend_init("cpu"))
    assert model.p == yolo.Yolov9tParams(num_classes=4, n_csp=1) and model.dtype == torch.float32
    for k, v in model.params.items():
        assert np.array_equal(v.numpy(), np.asarray(jmodel.params[k])), k


def _u8_image(rng, w, h):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def test_yolo_server_matches_the_jax_server(tyolo_gguf):
    """YoloServer on the CPU against the JAX package's YoloServer on the same
    GGUF: two extents in one batch, one with its own thresholds; the top-K
    extraction (K 1024 of 8400 anchors) on distinct scores; the same
    detections to f32 summation order (boxes 1e-2 px, confidences 1e-5)."""
    from vision_tpu.image import Image as JImage
    from vision_tpu.image import ImageFormat as JImageFormat
    from vision_tpu.serve import YoloServer as JYoloServer
    from vision_tpu_torch.serve import YoloServer

    rng = np.random.default_rng(7)
    arrays = [_u8_image(rng, 160, 120), _u8_image(rng, 100, 90)]
    model = yolo.yolov9t_load_model(tyolo_gguf, backend_init("cpu"))
    jmodel = jyolo.yolov9t_load_model(tyolo_gguf, jax_backend_init("cpu"))
    results = {}
    for name, server, m, img in (("port", YoloServer, model, lambda a: Image(a, ImageFormat.rgb_u8)),
                                 ("jax", JYoloServer, jmodel, lambda a: JImage(a, JImageFormat.rgb_u8))):
        with server(m, batch_size=2, max_delay_ms=10_000, conf_thres=0.3) as srv:
            fa, fb = srv.submit(img(arrays[0])), srv.submit(img(arrays[1]), conf_thres=0.5, iou_thres=0.3)
            results[name] = [fa.result(timeout=600), fb.result(timeout=600)]
            assert srv.stats.batches == 1
    for ours, theirs in zip(results["port"], results["jax"]):
        assert len(ours) == len(theirs) > 0
        for d, e in zip(ours, theirs):
            assert d.class_id == e.class_id
            np.testing.assert_allclose([d.x1, d.y1, d.x2, d.y2], [e.x1, e.y1, e.x2, e.y2], atol=1e-2)
            assert abs(d.confidence - e.confidence) < 1e-5


def test_yolo_server_results_equal_model_compute(tyolo_gguf):
    """Every candidate through the server's top-K (K = all anchors) gives
    model.compute's detections exactly."""
    from vision_tpu_torch.serve import YoloServer

    model = yolo.yolov9t_load_model(tyolo_gguf, backend_init("cpu"))
    img = Image(_u8_image(np.random.default_rng(8), 120, 96), ImageFormat.rgb_u8)
    with YoloServer(model, batch_size=1, max_delay_ms=5, conf_thres=0.3, max_candidates=8400) as srv:
        assert srv.k == 8400
        served = srv.compute(img)
        assert srv.stats.batched_items == 1
    assert [vars(d) for d in served] == [vars(d) for d in model.compute(img, conf_thres=0.3)]


def test_yolo_server_takes_only_a_yolo_model_and_warms_up(tyolo_gguf):
    from vision_tpu_torch.serve import YoloServer

    with pytest.raises(TypeError, match="Yolov9tModel"):
        YoloServer(object())
    model = yolo.yolov9t_load_model(tyolo_gguf, backend_init("cpu"))
    with YoloServer(model, batch_size=None, max_delay_ms=5) as srv:
        assert srv.batch_size == 8
        srv.warmup()
        assert srv.stats.requests == 0 and srv.stats.batches == 0
