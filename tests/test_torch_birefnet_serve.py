"""The port's BiRefNet serving path on the CPU: a tiny GGUF
(random_birefnet_params("tiny"): SWIN-T widths and the 112-wide decoder,
served at 64x64) -> birefnet_load_model -> ImageServer, with its padding of
partial groups, its one extent bucket for every request extent, its warmup
at ``p.image_extent`` and its pixel limit."""

import numpy as np
import pytest
import torch

from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.gguf import GGUFWriter
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models.birefnet import birefnet_load_model
from vision_tpu_torch.models.random_weights import random_birefnet_params
from vision_tpu_torch.models.swin import SWIN_T_PARAMS
from vision_tpu_torch.serve import ImageServer
from torch_threads import torch_threads  # noqa: F401

WINDOW_MS = 10_000  # a batch window that covers request prep on a loaded machine


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = tmp_path_factory.mktemp("birefnet_serve") / "birefnet-tiny.gguf"
    w = GGUFWriter(path, "birefnet")
    w.add("birefnet.image_size", 64)
    w.add("birefnet.image_multiple", 32)
    w.add("swin.embed_dim", 96)
    for name, a in random_birefnet_params("tiny", seed=0).items():
        w.add_tensor(name, a)
    w.write()
    return birefnet_load_model(str(path), backend_init("cpu"))


def _img(seed, w, h):
    rng = np.random.default_rng(seed)
    return Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)


class _Spy:
    """Records the batch shape of every forward_u8 call."""

    def __init__(self, model, monkeypatch):
        self.shapes = []
        real = model.forward_u8

        def spy(x):
            self.shapes.append(tuple(x.shape))
            return real(x)

        monkeypatch.setattr(model, "forward_u8", spy)


def test_loaded_model(model):
    assert model.p.encoder == SWIN_T_PARAMS and model.p.image_extent == (64, 64)
    assert model.dtype == torch.float32 and model.deform_bound is None


def test_every_extent_shares_one_padded_batch(model, monkeypatch):
    """BiRefNet resizes every request to its fixed extent, so requests of
    three extents form one bucket; three requests in a batch of 4 run one
    forward of 4 (padded with the first) and come back at their extents."""
    spy = _Spy(model, monkeypatch)
    imgs = [_img(1, 64, 64), _img(2, 128, 72), _img(3, 80, 60)]
    with ImageServer(model, batch_size=4, max_delay_ms=WINDOW_MS) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(im) for im in imgs]]
    assert srv.stats.requests == 3 and srv.stats.batches == 1 and srv.stats.batched_items == 3
    assert spy.shapes == [(4, 64, 64, 3)]
    for im, res in zip(imgs, results):
        assert res.extent == im.extent and res.format == ImageFormat.alpha_u8


def test_results_equal_model_compute(model):
    imgs = [_img(10 + i, 96, 70) for i in range(2)]
    with ImageServer(model, batch_size=2, max_delay_ms=WINDOW_MS) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(im) for im in imgs]]
    for im, res in zip(imgs, results):
        assert np.array_equal(res.data, model.compute(im).data)


def test_warmup_runs_the_model_extent_and_resets_stats(model, monkeypatch):
    spy = _Spy(model, monkeypatch)
    with ImageServer(model, batch_size=2, max_delay_ms=5) as srv:
        srv.warmup()
        assert srv.stats.requests == 0 and srv.stats.batches == 0
    assert spy.shapes == [(2, 64, 64, 3)]


def test_request_past_max_pixels_raises(model):
    with ImageServer(model, batch_size=1, max_delay_ms=5, max_pixels=100 * 100) as srv:
        fut = srv.submit(_img(4, 101, 100))
        with pytest.raises(ValueError, match="max_pixels"):
            fut.result(timeout=300)
        assert srv.submit(_img(5, 100, 100)).result(timeout=300).extent == (100, 100)
