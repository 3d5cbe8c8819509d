"""The port's compute-graph cache (core/graph.py) on the CPU: GraphCache,
shape_bucket and snap_to_multiple against the JAX package's on the same
call sequences and grids; ForwardGraphs' keys, its one pool, its raising
capture and its replay (with a stand-in for the CUDA graph, which needs the
card); the launch counts a capture records; the five forward_u8s through
the cache, bit-equal to the eager forward; and the device constants of
ops/preprocess.py and ops/resize.py, bit-equal to their uncached form."""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from test_torch_api import sample_image, write_family_gguf
from vision_tpu.core.errors import VispError as JaxVispError
from vision_tpu.core.graph import GraphCache as JaxGraphCache
from vision_tpu.core.graph import shape_bucket as jax_shape_bucket
from vision_tpu.core.graph import snap_to_multiple as jax_snap_to_multiple
from vision_tpu_torch import api
from vision_tpu_torch.core import graph
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.graph import ForwardGraphs, GraphCache, shape_bucket, snap_to_multiple
from vision_tpu_torch.ops import cuda as ops_cuda
from vision_tpu_torch.ops import normalize_u8, resize_nhwc
from vision_tpu_torch.ops.cuda import conv3x3 as cc
from vision_tpu_torch.ops.cuda import window_attention as wa
from vision_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, _channel_constant
from vision_tpu_torch.ops.resize import _axis_weights, _device_weights, _nearest_indices
from torch_threads import torch_threads  # noqa: F401

# -- GraphCache, shape_bucket, snap_to_multiple against the JAX package --


def _drive(cache_cls, keys, fail, max_entries):
    """Run ``keys`` through a cache whose build fails for keys in ``fail``;
    the trace of (entries in recency order, builds so far, raised) per call."""
    builds = []

    def build(key):
        builds.append(key)
        if key in fail:
            raise ValueError(key)
        return lambda: key

    cache = cache_cls(build, max_entries)
    trace = []
    for k in keys:
        try:
            assert cache.get(k, k)() == k
            raised = False
        except ValueError:
            raised = True
        trace.append((list(cache._cache), len(cache), len(builds), raised))
    cache.clear()
    return trace + [len(cache)]


@pytest.mark.parametrize("max_entries", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", range(6))
def test_graph_cache_keeps_and_evicts_as_jax(seed, max_entries):
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(0, 6, 60)]
    fail = {int(k) for k in rng.integers(0, 6, seed % 3)}
    assert _drive(GraphCache, keys, fail, max_entries) == _drive(JaxGraphCache, keys, fail, max_entries)


@pytest.mark.parametrize("max_entries", [0, -1])
def test_graph_cache_needs_an_entry(max_entries):
    with pytest.raises(VispError, match="max_entries >= 1"):
        GraphCache(lambda: None, max_entries)
    with pytest.raises(JaxVispError, match="max_entries >= 1"):
        JaxGraphCache(lambda: None, max_entries)


@pytest.mark.parametrize("multiple", [1, 7, 14, 32, 128])
def test_snap_to_multiple_matches_jax(multiple):
    for x in range(0, 300):
        assert snap_to_multiple(x, multiple) == jax_snap_to_multiple(x, multiple)


@pytest.mark.parametrize("max_extent", [None, 1, 100, 128, 500, 1024, 1030])
@pytest.mark.parametrize("multiple", [1, 14, 32, 128])
def test_shape_bucket_matches_jax(multiple, max_extent):
    for extent in [(1, 1), (13, 700), (128, 128), (129, 64), (518, 518), (700, 500), (1600, 1200)]:
        try:
            want = jax_shape_bucket(extent, multiple, max_extent)
        except JaxVispError as e:
            with pytest.raises(VispError, match="cannot hold a multiple"):
                shape_bucket(extent, multiple, max_extent)
            assert "cannot hold a multiple" in str(e)
            continue
        assert shape_bucket(extent, multiple, max_extent) == want


# -- ForwardGraphs: keys, pool, no fallback, replay --


def test_forward_graphs_on_the_cpu_run_the_eager_forward():
    calls = []

    def forward(x, scale=1):
        calls.append(tuple(x.shape))
        return x * scale

    fg = ForwardGraphs(forward, torch.device("cpu"), max_entries=2)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(fg(x), x) and torch.equal(fg(x, scale=2), 2 * x) and torch.equal(fg(x), x)
    assert len(fg.cache) == 2 and fg.pool is None
    fg(torch.zeros(3, 3))  # a third key evicts the least recently used
    assert len(fg.cache) == 2 and calls == [(2, 3)] * 3 + [(3, 3)]
    assert not torch.is_inference(x) and torch.is_inference(fg(x))


class _FakeGraph:
    """Stands in for a captured CUDA graph: a replay writes 2 * static_in[0]
    into the static output, as the forward would."""

    def __init__(self, static_in, static_out):
        self.static_in, self.static_out = static_in, static_out

    def replay(self):
        self.static_out.copy_(2 * self.static_in[0])


def test_replay_copies_the_input_adds_the_tally_and_returns_a_copy():
    with torch.inference_mode():
        static_in, static_out = [torch.zeros(2, 3)], torch.zeros(2, 3)
        replay = graph._Replay(_FakeGraph(static_in, static_out), static_in, static_out,
                               {(cc.__name__, "launches"): 3}, [])
        before = cc.launches
        x = torch.arange(6.0).reshape(2, 3)
        out = replay(x)
        assert torch.equal(out, 2 * x) and out.data_ptr() != static_out.data_ptr()
        assert cc.launches == before + 3
        out2 = replay(x + 1)
        assert torch.equal(out, 2 * x) and torch.equal(out2, 2 * x + 2) and cc.launches == before + 6


def test_forward_graphs_on_the_card_capture_once_per_key_in_one_pool(monkeypatch):
    """On a CUDA device every key is captured (capture_forward) into the
    model's one pool, on the model's one capture stream (the allocator
    reuses a freed block only on the stream that freed it); a failed
    capture raises, costs no entry and never runs the forward eagerly in
    its place."""
    captured, eager, streams = [], [], []
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: streams.append(device) or ("stream", len(streams)))

    def capture(fn, args, device, pool, stream):
        if args[0].shape[0] == 3:
            raise RuntimeError("operation not permitted when stream is capturing")
        captured.append((tuple(args[0].shape), device, pool, stream))
        return lambda *a: ("replayed", tuple(a[0].shape))

    monkeypatch.setattr(graph, "capture_forward", capture)
    fg = ForwardGraphs(lambda x: eager.append(x) or x, torch.device("cuda", 0))
    assert fg(torch.zeros(2, 4)) == ("replayed", (2, 4))
    assert fg(torch.zeros(2, 4)) == ("replayed", (2, 4))
    assert fg(torch.zeros(1, 4)) == ("replayed", (1, 4))
    with pytest.raises(RuntimeError, match="stream is capturing"):
        fg(torch.zeros(3, 4))
    cuda0 = torch.device("cuda", 0)
    assert captured == [((2, 4), cuda0, ("pool",), ("stream", 1)), ((1, 4), cuda0, ("pool",), ("stream", 1))]
    assert len(fg.cache) == 2 and eager == [] and streams == [cuda0]


def test_a_capture_tallies_launches_instead_of_counting_them():
    """Launches while this thread captures go to the capture's tally (the
    kernels are recorded, not run); add_counts gives them to the counters,
    as each replay does."""
    before, masked = wa.launches, wa.masked_launches
    with ops_cuda.capture_tally() as tally:
        ops_cuda.count_launch(wa.__name__, launches=1, masked_launches=1)
        ops_cuda.count_launch(wa.__name__, launches=1, masked_launches=0)
    assert (wa.launches, wa.masked_launches) == (before, masked)
    assert dict(tally) == {(wa.__name__, "launches"): 2, (wa.__name__, "masked_launches"): 1}
    ops_cuda.count_launch(wa.__name__, launches=1)
    ops_cuda.add_counts(tally)
    assert (wa.launches, wa.masked_launches) == (before + 3, masked + 1)


def test_a_capture_keeps_the_device_constants_it_read():
    """What a device_cache'd function returns during a capture stays alive
    with the graph, evicted from the cache or not."""
    with graph._keeping() as kept:
        a = _channel_constant((0.5, 0.25), torch.device("cpu"))
        b = _device_weights(5, 3, "bilinear", False, torch.device("cpu"))
    assert kept[0] is a and kept[1] is b
    assert _channel_constant((0.5, 0.25), torch.device("cpu")) is a  # cached
    assert graph._tls.kept is None


def test_two_threads_capture_one_at_a_time_with_the_collector_off():
    """capture_forward's capture section (the capture lock, inside it the
    collector off), entered by two threads at once as two servers' first
    calls may: the second waits for the first, each captures with the
    collector off (its state read and restored under the lock), and it is
    on again after both."""
    assert gc.isenabled()
    seen, inside, release = [], threading.Event(), threading.Event()

    def first():
        with graph._capturing():
            inside.set()
            release.wait(10)
            seen.append(("first", gc.isenabled()))

    def second():
        inside.wait(10)
        with graph._capturing():
            seen.append(("second", gc.isenabled()))

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    inside.wait(10)
    time.sleep(0.2)  # the second thread is at the lock by now
    assert seen == []
    release.set()
    for t in threads:
        t.join(10)
    assert seen == [("first", False), ("second", False)] and gc.isenabled()


# -- the five forward_u8s through the cache --

# family -> (first input shapes, a second key's input shapes)
_SHAPES = {
    "depthany": ([(1, 126, 126, 3)], [(1, 126, 140, 3)]),
    "birefnet": ([(1, 64, 64, 3)], [(1, 64, 128, 3)]),
    "esrgan": ([(2, 24, 20, 3)], [(1, 16, 16, 3)]),
    "migan": ([(1, 64, 64, 3), (1, 64, 64, 1)], [(2, 64, 64, 3), (2, 64, 64, 1)]),
    "yolov9t": ([(1, 640, 640, 3)], [(2, 640, 640, 3)]),
}


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 256, s, np.uint8)) for s in shapes]


@pytest.mark.parametrize("family", sorted(_SHAPES))
def test_forward_u8_through_the_cache_equals_the_eager_forward(family, tmp_path):
    model = api.load_model(write_family_gguf(family, tmp_path), backend_init("cpu"))
    first, second = _SHAPES[family]
    x = _inputs(first, 0)
    got, want = model.forward_u8(*x), model._forward_u8(*x)
    for g, w in zip(got if isinstance(got, tuple) else [got], want if isinstance(want, tuple) else [want]):
        assert torch.equal(g, w)
    assert len(model.graphs.cache) == 1
    model.forward_u8(*_inputs(first, 1))
    assert len(model.graphs.cache) == 1
    model.forward_u8(*_inputs(second, 2))
    assert len(model.graphs.cache) == 2


@pytest.mark.parametrize("family", sorted(_SHAPES))
def test_a_dropped_model_frees_its_graphs_without_the_collector(family, tmp_path):
    """A model and its ForwardGraphs make no reference cycle: with the
    collector off, dropping a model that has run frees it and its graphs at
    once. (A cycle waits for a collection, and one that falls inside
    another model's capture frees CUDA graphs there and breaks it.)"""
    model = api.load_model(write_family_gguf(family, tmp_path), backend_init("cpu"))
    model.forward_u8(*_inputs(_SHAPES[family][0], 0))
    refs = weakref.ref(model), weakref.ref(model.graphs)
    gc.collect()
    gc.disable()
    try:
        del model
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_esrgan_keys_on_to_u8_and_the_tiles_share_one_entry(tmp_path):
    """The tiled compute runs every chunk at one (batch, tile) shape, so a
    tiled image costs one entry whatever its tile count."""
    from vision_tpu_torch.image import Image, ImageFormat

    model = api.load_model(write_family_gguf("esrgan", tmp_path), backend_init("cpu"))
    x = _inputs([(1, 16, 16, 3)], 0)[0]
    assert model.forward_u8(x).dtype == torch.uint8 and model.forward_u8(x, to_u8=False).dtype == torch.float32
    assert len(model.graphs.cache) == 2
    model.graphs.cache.clear()
    model.compute(Image(sample_image(72, 96), ImageFormat.rgb_u8), tile_size=32)
    assert len(model.graphs.cache) == 1


# -- device constants, bit-equal to their uncached form --


def test_normalize_u8_constants_are_bit_equal_to_the_uncached_form():
    x = _inputs([(2, 5, 7, 3)], 0)[0]
    xf = x.float() * (1.0 / 255.0)
    want = ((xf - torch.tensor(IMAGENET_MEAN, dtype=torch.float32)) / torch.tensor(IMAGENET_STD, dtype=torch.float32))
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, dtype), want.to(dtype))
    assert torch.equal(normalize_u8(x, dtype=torch.float32), xf)


@pytest.mark.parametrize("method,align", [("bilinear", False), ("bilinear", True), ("bicubic", False),
                                          ("catmullrom", False), ("mitchell", False), ("nearest", False)])
@pytest.mark.parametrize("size", [(9, 13), (24, 5)])
def test_resize_constants_are_bit_equal_to_the_uncached_form(method, align, size):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 10, 3)).astype(np.float32))
    if method == "nearest":
        ys = torch.from_numpy(_nearest_indices(12, size[0]))
        xs = torch.from_numpy(_nearest_indices(10, size[1]))
        want = x[:, ys][:, :, xs]
    else:
        wy = torch.tensor(_axis_weights(12, size[0], method, align))
        wx = torch.tensor(_axis_weights(10, size[1], method, align))
        want = torch.einsum("ow,nhwc->nhoc", wx, torch.einsum("oh,nhwc->nowc", wy, x))
    assert torch.equal(resize_nhwc(x, size, method, align), want)
    assert torch.equal(resize_nhwc(x, size, method, align), want)  # from the cache
