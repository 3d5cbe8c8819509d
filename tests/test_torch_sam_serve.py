"""The port's MobileSAM serving path (SamServer on a SamModel) at full size on
the CPU: random_mobile_sam_params(0), f32, the requests of
tests/test_serve.py::test_sam_server_end_to_end."""

import numpy as np
import pytest
import torch

from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.gguf import GGUFWriter
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models.mobile_sam import SamModel, SamParams, sam_load_model
from vision_tpu_torch.models.random_weights import random_mobile_sam_params
from vision_tpu_torch.serve import SamServer
from torch_threads import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def model():
    params = params_from_numpy(random_mobile_sam_params(0), "cpu", torch.float32)
    return SamModel(params, SamParams(), backend_init("cpu"))


def _images():
    rng = np.random.default_rng(7)
    img_a = Image(rng.integers(0, 255, (96, 128, 4), np.uint8), ImageFormat.rgba_u8)
    img_b = Image(rng.integers(0, 255, (96, 128, 4), np.uint8), ImageFormat.rgba_u8)
    return img_a, img_b


def test_sam_server_end_to_end(model):
    """Two point requests share one batch, the box buckets apart; the point
    mask equals the single-request SamModel path on the same image."""
    img_a, img_b = _images()
    # generous batch window: request prep (the 1024² resize) runs on the
    # prep pool after submit, so the window must cover it on a loaded machine;
    # the lone box request is flushed by close(), not by its window's end
    with SamServer(model, batch_size=2, max_delay_ms=10_000) as srv:
        f1 = srv.submit(img_a, point=(40, 30))
        f2 = srv.submit(img_b, point=(80, 60))
        f3 = srv.submit(img_a, box=((10, 10), (100, 80)))
    m1, m2, m3 = (f.result(timeout=600) for f in (f1, f2, f3))
    assert srv.stats.requests == 3 and srv.stats.batches == 2
    for m, img in ((m1, img_a), (m2, img_b), (m3, img_a)):
        assert m.extent == img.extent and m.format == ImageFormat.alpha_u8
        assert set(np.unique(m.data)) <= {0, 255}

    model.encode(img_a)
    direct = model.compute(point=(40, 30))
    np.testing.assert_array_equal(direct.data, m1.data)
    assert model.compute_batch(points=[(40, 30)])[0].data.tobytes() == direct.data.tobytes()


def test_sam_load_model_and_warmup(tmp_path):
    """GGUFWriter("...", "mobile-sam") -> sam_load_model on the CPU -> SamServer."""
    path = tmp_path / "mobile-sam-random.gguf"
    w = GGUFWriter(path, "mobile-sam")
    for name, a in random_mobile_sam_params(0).items():
        w.add_tensor(name, a)
    w.write()
    loaded = sam_load_model(str(path), backend_init("cpu"))
    assert loaded.dtype == torch.float32 and len(loaded.params) == 318
    with SamServer(loaded, batch_size=1, max_delay_ms=5) as srv:
        srv.warmup()
        assert srv.stats.requests == 0 and srv.stats.batches == 0


def test_sam_server_rejects_bad_requests(model):
    with pytest.raises(TypeError, match="SamModel"):
        SamServer(object())
    with SamServer(model, batch_size=1) as srv:
        with pytest.raises(ValueError, match="exactly one"):
            srv.submit(_images()[0])
