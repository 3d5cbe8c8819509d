"""The port's served SAM3 image encoder (Sam3Server on a vision-only
Sam3Model and its ``forward_u8``) on the CPU, at a small SAM3: width 64, 4
heads, 4 layers with one global layer at index 3, 4x4 windows, 112x112
images (an 8x8 patch grid), a 4x4 position table tiled 2x2, FPN 32. Against
the JAX package's ``encode_vision`` in float32 and the port's own
``encode_vision``, and the serving layer: padding, buckets, resizing,
spans, warm-up."""

import time

import numpy as np
import pytest
import torch

import vision_tpu_torch.serve as serve
from vision_tpu.core.params import Params as JParams
from vision_tpu.models import sam3 as js3
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.image import Image, ImageFormat, image_u8_to_f32
from vision_tpu_torch.models.random_weights import random_sam3_vision_params
from vision_tpu_torch.models.sam3 import Sam3Model, Sam3VitParams
from vision_tpu_torch.serve import Sam3Server
from vision_tpu_torch.utils.profiling import spans
from torch_threads import torch_threads  # noqa: F401

SMALL_VP = dict(image_size=112, patch_size=14, window_size=4, n_layers=4, n_heads=4, global_attn_indexes=(3,))
VP = Sam3VitParams(**SMALL_VP)
LEVELS = [(32, 32, 32), (16, 16, 32), (8, 8, 32), (4, 4, 32)]
WINDOW_MS = 10_000  # a batch window that covers request prep on a loaded machine
NAME, START, ATTRS, PARENT, ID = 1, 2, 7, 6, 0
SERVE_PHASES = ["serve.stack", "serve.forward", "serve.copy_back", "serve.post", "serve.deliver"]


@pytest.fixture(scope="module")
def weights():
    """The small SAM3 under det.ve.*: random_sam3_vision_params' linears
    and convs at 1 / sqrt(fan-in) and layer norms at 1 and 0, with biases
    of std 0.02 and a position table of std 0.5, comparable to the patch
    features so that its tiling shows in the levels (as the benchmark's
    SAM 3 configuration draws them)."""
    rng = np.random.default_rng(8)
    store = {}
    for k, v in random_sam3_vision_params(7, dim=64, layers=4, fpn_ch=32, mlp=256, pos_grid=4).items():
        if k.endswith("position_embeddings"):
            v = rng.standard_normal(v.shape).astype(np.float32) * 0.5
        elif k.endswith(".bias") and "layer_norm" not in k:
            v = rng.standard_normal(v.shape).astype(np.float32) * 0.02
        store[f"det.ve.{k}"] = v
    return store


def _model(weights):
    return Sam3Model({k: torch.from_numpy(v) for k, v in weights.items()}, None, 0, backend_init("cpu"), vp=VP)


@pytest.fixture(scope="module")
def model(weights):
    return _model(weights)


def _jax_levels(weights, pixels):
    """The JAX package's encode_vision in float32 on sam3_process_input's
    [-1, 1] mapping of (N, 112, 112, 3) u8 pixels: the four levels as
    float32 tensors."""
    x = (pixels.astype(np.float32) / 255.0 - 0.5) * 2.0
    out = js3.encode_vision(JParams(weights)["det.ve"], x, js3.Sam3VitParams(**SMALL_VP))
    return [torch.from_numpy(np.array(h, np.float32)) for h in out.fpn_hidden_states]


def _images(seed, n, w=112, h=112):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


@pytest.mark.parametrize("batch", [1, 3])
def test_forward_u8_matches_the_plain_reference(model, weights, batch):
    """The program computes in float32 on the CPU, as the plain reference
    (the JAX package's encode_vision) does, and returns float16: within
    half a float16 ulp of the reference (2^-11 relative), plus 1e-4 for
    float32's summation order over 4 layers and the neck."""
    pixels = _images(batch, batch)
    got = model.forward_u8(torch.from_numpy(pixels))
    want = _jax_levels(weights, pixels)
    assert [tuple(g.shape) for g in got] == [(batch, *s) for s in LEVELS]
    for g, r in zip(got, want):
        assert g.dtype == torch.float16
        err = (g.float() - r).abs()
        assert (err <= r.abs() * 2.0**-11 + 1e-4).all(), err.max().item()
        assert r.std() > 0.5  # the features spread: a fault has somewhere to show


def test_forward_u8_is_encode_vision_in_float16(model):
    """The [-1, 1] mapping on the device is sam3_process_input's, bit for
    bit: the levels are encode_vision's (a 112x112 image needs no resize)
    cast to float16."""
    pixels = _images(11, 2)
    got = model.forward_u8(torch.from_numpy(pixels))
    for i in range(2):
        levels = model.encode_vision(Image(pixels[i], ImageFormat.rgb_u8))
        for g, e in zip(got, levels):
            assert torch.equal(g[i:i + 1], e.to(torch.float16))
    mapped = image_u8_to_f32(Image(pixels[0], ImageFormat.rgb_u8), ImageFormat.rgb_f32, offset=(-0.5,) * 4,
                             scale=(2.0,) * 4).data
    for g, e in zip(got, model._encode_vision(torch.from_numpy(mapped[None]))):
        assert torch.equal(g[:1], e.to(torch.float16))


def test_a_replay_equals_the_eager_forward_one_key_a_batch_shape(weights):
    m = _model(weights)
    x = torch.from_numpy(_images(21, 4))
    for batch in (2, 4, 2):
        got, eager = m.forward_u8(x[:batch]), m._forward_u8(x[:batch])
        assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert len(m.graphs.cache) == 2 and m.graphs.captures == 0  # no graph on the CPU


def test_features_lie_in_float16s_exact_range(weights):
    """float16 holds every bfloat16 value from 2^-14 to 65504 exactly; the
    features at these weights (the reference's, rounded to the card's
    bfloat16) lie below 65504, and those below 2^-14 round to float16's
    subnormals with an error below 2^-24."""
    for lv in _jax_levels(weights, _images(31, 2)):
        bf = lv.to(torch.bfloat16).float()
        back = bf.to(torch.float16).float()
        assert bf.abs().max() < 65504
        normal = bf.abs() >= 2.0**-14
        assert torch.equal(back[normal], bf[normal])
        assert ((back - bf).abs()[~normal] < 2.0**-24).all()


@pytest.mark.parametrize("n", [1, 3])
def test_served_answers_equal_forward_u8_padding_included(model, n):
    pixels = _images(40 + n, n)
    with Sam3Server(model, batch_size=4, max_delay_ms=WINDOW_MS) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(Image(p, ImageFormat.rgb_u8)) for p in pixels]]
    assert srv.stats.batches == 1 and srv.stats.batched_items == n
    padded = np.concatenate([pixels, np.repeat(pixels[:1], 4 - n, axis=0)])  # the batch the server ran
    want = model.forward_u8(torch.from_numpy(padded))
    for i, res in enumerate(results):
        assert isinstance(res, tuple)
        assert [lv.shape for lv in res] == LEVELS
        for lv, w in zip(res, want):
            assert lv.dtype == np.float16 and lv.flags.c_contiguous and np.array_equal(lv, w[i].numpy())
        assert not any(np.shares_memory(a, b) for other in results[:i] for a in res for b in other)


def test_a_request_of_another_extent_is_resized_on_the_host(model, monkeypatch):
    """Only a request whose extent is not the model's input is resized, and
    both land in the one bucket of the processed extent."""
    calls = []
    real = serve.image_scale

    def counted(image, extent, method):
        calls.append((image.extent, extent))
        return real(image, extent, method)

    monkeypatch.setattr(serve, "image_scale", counted)
    other = Image(_images(51, 1, 100, 80)[0], ImageFormat.rgb_u8)
    same = Image(_images(52, 1)[0], ImageFormat.rgb_u8)
    with Sam3Server(model, batch_size=2, max_delay_ms=WINDOW_MS) as srv:
        a, b = srv.submit(other), srv.submit(same)
        ra, rb = a.result(timeout=300), b.result(timeout=300)
    assert calls == [((100, 80), (112, 112))]
    assert srv.stats.batches == 1
    assert [lv.shape for lv in ra] == [lv.shape for lv in rb] == LEVELS


def test_the_server_records_its_spans_and_copy_back_bytes(model):
    """Each batch has serve.stack, serve.forward, serve.copy_back,
    serve.post and serve.deliver once, in order (serve.wait waits for the
    card and is recorded on it only); the copy back's bytes are the
    answers' four float16 levels."""
    t0 = time.perf_counter_ns()
    with Sam3Server(model, batch_size=2, max_delay_ms=200) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(Image(p, ImageFormat.rgb_u8)) for p in _images(61, 3)]]
    assert len(results) == 3
    records = [r for r in spans() if r[START] >= t0]
    batches = [r for r in records if r[NAME] == "serve.batch"]
    assert sum(dict(b[ATTRS])["items"] for b in batches) == 3
    per_image = sum(2 * h * w * c for h, w, c in LEVELS)
    for b in batches:
        kids = sorted((r for r in records if r[PARENT] == b[ID]), key=lambda r: r[START])
        assert [r[NAME] for r in kids] == SERVE_PHASES
        assert dict(kids[2][ATTRS])["bytes"] == dict(b[ATTRS])["items"] * per_image
    assert not [r for r in records if r[NAME] in ("graph.capture", "serve.wait")]


def test_a_vision_only_model_serves_and_cannot_encode_text(model):
    assert model.tokenizer is None and model.n_text_layers == 0
    with pytest.raises(VispError, match="no text encoder"):
        model.encode_text("a cat")
    with Sam3Server(model, max_delay_ms=5) as srv:
        assert srv.batch_size == 4  # the per-card default
        srv.warmup()
        assert srv.stats.requests == 0 and srv.stats.batches == 0
        srv.warmup((64, 48))  # another extent: resized, the same bucket
        assert [lv.shape for lv in srv.compute(Image(_images(71, 1)[0], ImageFormat.rgb_u8))] == LEVELS


def test_the_server_takes_only_a_sam3_model():
    with pytest.raises(TypeError, match="Sam3Model"):
        Sam3Server(object())
