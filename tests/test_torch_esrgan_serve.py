"""The port's Real-ESRGAN serving path (EsrganServer on an EsrganModel) on the
CPU, with a small RRDBNet (nf 8, gc 4, 1 block, scale 4): batching by
extent, padding of partial groups, the pixel limit, and agreement with
EsrganModel.compute."""

import numpy as np
import pytest
import torch

from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.gguf import GGUFWriter
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models.esrgan import EsrganModel, EsrganParams, esrgan_load_model
from vision_tpu_torch.models.random_weights import random_esrgan_params
from vision_tpu_torch.serve import EsrganServer
from torch_threads import torch_threads  # noqa: F401

SMALL = {"nf": 8, "nb": 1, "gc": 4}
WINDOW_MS = 10_000  # a batch window that covers request prep on a loaded machine


@pytest.fixture(scope="module")
def model():
    # weights 25x random_esrgan_params' scale, so the u8 output is not all 0
    store = {k: v * 25 for k, v in random_esrgan_params(1, **SMALL).items()}
    return EsrganModel(params_from_numpy(store, "cpu", torch.float32), EsrganParams(4, 1), backend_init("cpu"))


def _img(seed, w, h):
    rng = np.random.default_rng(seed)
    return Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)


class _Spy:
    """Records the batch shape of every forward_u8 call."""

    def __init__(self, model, monkeypatch):
        self.shapes = []
        real = model.forward_u8

        def spy(x, to_u8=True):
            self.shapes.append(tuple(x.shape))
            return real(x, to_u8)

        monkeypatch.setattr(model, "forward_u8", spy)


def test_same_extent_requests_share_one_batch(model, monkeypatch):
    spy = _Spy(model, monkeypatch)
    imgs = [_img(i, 24, 20) for i in range(2)]
    with EsrganServer(model, batch_size=2, max_delay_ms=WINDOW_MS) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(im) for im in imgs]]
    assert srv.stats.requests == 2 and srv.stats.batches == 1
    assert spy.shapes == [(2, 20, 24, 3)]
    for im, res in zip(imgs, results):
        assert res.extent == (96, 80) and res.format == ImageFormat.rgba_u8
        assert (res.data[..., 3] == 255).all()


def test_two_extents_bucket_apart(model, monkeypatch):
    spy = _Spy(model, monkeypatch)
    with EsrganServer(model, batch_size=2, max_delay_ms=200) as srv:
        a, b = srv.submit(_img(1, 24, 20)), srv.submit(_img(2, 16, 12))
        ra, rb = a.result(timeout=300), b.result(timeout=300)
    assert srv.stats.batches == 2
    assert sorted(spy.shapes) == [(2, 12, 16, 3), (2, 20, 24, 3)]
    assert ra.extent == (96, 80) and rb.extent == (64, 48)


def test_partial_group_is_padded_and_sliced(model, monkeypatch):
    spy = _Spy(model, monkeypatch)
    imgs = [_img(10 + i, 20, 16) for i in range(3)]
    with EsrganServer(model, batch_size=4, max_delay_ms=WINDOW_MS) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(im) for im in imgs]]
    assert spy.shapes == [(4, 16, 20, 3)]
    assert srv.stats.batches == 1 and srv.stats.batched_items == 3 and len(results) == 3


def test_results_equal_model_compute(model):
    imgs = [_img(20 + i, 28, 18) for i in range(3)]
    with EsrganServer(model, batch_size=4, max_delay_ms=200) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(im) for im in imgs]]
    for im, res in zip(imgs, results):
        direct = model.compute(im)
        assert np.array_equal(res.data, direct.data)
        assert 5 < res.data[..., :3].mean() < 250, "the output must not be all 0 or all 255"


def test_request_past_max_pixels_raises(model):
    with EsrganServer(model, batch_size=1, max_pixels=20 * 20) as srv:
        fut = srv.submit(_img(3, 21, 20))
        with pytest.raises(ValueError, match="whole-image serving limit"):
            fut.result(timeout=60)
        assert srv.submit(_img(4, 20, 20)).result(timeout=300).extent == (80, 80)


def test_server_takes_only_an_esrgan_model():
    with pytest.raises(TypeError, match="EsrganModel"):
        EsrganServer(object())


def test_load_model_and_warmup(tmp_path):
    """random_esrgan_params -> GGUFWriter("...", "esrgan") -> esrgan_load_model
    on the CPU -> EsrganServer; warmup resets the stats."""
    path = tmp_path / "esrgan-random.gguf"
    w = GGUFWriter(path, "esrgan")
    w.add("esrgan.scale", 4)
    w.add("esrgan.block_count", 1)
    for name, a in random_esrgan_params(0, **SMALL).items():
        w.add_tensor(name, a)
    w.write()
    loaded = esrgan_load_model(str(path), backend_init("cpu"))
    assert loaded.dtype == torch.float32 and loaded.p == EsrganParams(4, 1) and len(loaded.params) == 42
    with EsrganServer(loaded, batch_size=2, max_delay_ms=5) as srv:
        srv.warmup((16, 16))
        assert srv.stats.requests == 0 and srv.stats.batches == 0
        assert srv.compute(_img(5, 16, 16)).extent == (64, 64)
