"""The port's serving path (GGUF -> depthany_load_model -> ImageServer) on
the CPU, against the JAX package's DepthAnythingModel on the same file."""

import numpy as np
import pytest

from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.gguf import GGUFWriter as JaxGGUFWriter
from vision_tpu.image import Image as JaxImage
from vision_tpu.image import ImageFormat as JaxImageFormat
from vision_tpu.models.depth_anything import depthany_load_model as jax_depthany_load_model
from vision_tpu.models.random_weights import random_depth_anything_params
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models.depth_anything import depthany_load_model
from vision_tpu_torch.serve import ImageServer
from torch_threads import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    """The reduced "test" Depth-Anything (64 wide, 4 layers) at image_size
    126, as tests/test_serve.py:330-338 builds it, written by the JAX
    package's writer."""
    path = tmp_path_factory.mktemp("torch_serve") / "depthany-test.gguf"
    w = JaxGGUFWriter(path, "depthanything")
    w.add("dino.patch_size", 14)
    w.add("dino.embed_dim", 64)
    w.add("dino.n_heads", 2)
    w.add("dino.n_layers", 4)
    w.add("depthanything.image_size", 126)
    w.add("depthanything.feature_layers", [0, 1, 2, 3])
    w.add("depthanything.tensor_data_layout", "torch")
    for name, a in random_depth_anything_params("test", seed=0).items():
        w.add_tensor(name, a)
    w.write()
    return str(path)


def _u8_img(rng, h, w):
    return Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)


def test_image_server_matches_jax(gguf_path):
    model = depthany_load_model(gguf_path, backend_init("cpu"))
    rng = np.random.default_rng(11)
    imgs = [_u8_img(rng, 126, 140), _u8_img(rng, 126, 140), _u8_img(rng, 98, 98)]
    # generous batch window: request prep runs on a 2-thread pool after
    # submit, so the window must cover it for the two 126x140 requests to
    # share a batch even on a machine loaded by parallel test workers; the
    # lone 98x98 one is flushed by close(), not by its window's end
    with ImageServer(model, batch_size=2, max_delay_ms=10_000) as srv:
        futures = [srv.submit(img) for img in imgs]
    results = [f.result(timeout=600) for f in futures]
    assert srv.stats.requests == 3 and srv.stats.batches == 2  # the 98x98 one buckets apart
    for img, res in zip(imgs, results):
        assert res.extent == img.extent and res.format == ImageFormat.alpha_f32
    jax_model = jax_depthany_load_model(gguf_path, jax_backend_init("cpu"))
    for img, res in zip(imgs, results):
        expected = jax_model.compute(JaxImage(img.data, JaxImageFormat.rgba_u8))
        np.testing.assert_allclose(res.data, np.asarray(expected.data), atol=1e-4)


def test_image_server_rejects_oversized_upload(gguf_path):
    model = depthany_load_model(gguf_path, backend_init("cpu"))
    rng = np.random.default_rng(12)
    with ImageServer(model, batch_size=2, max_delay_ms=5, max_pixels=256 * 256) as srv:
        fut = srv.submit(_u8_img(rng, 300, 300))
        with pytest.raises(ValueError, match="max_pixels"):
            fut.result(timeout=600)


def test_image_server_refuses_unknown_families():
    """ImageServer serves Depth-Anything, BiRefNet and MI-GAN; any other
    model is refused by name."""
    with pytest.raises(TypeError, match="does not support object"):
        ImageServer(object())
    with pytest.raises(TypeError, match="does not support SamModel"):
        ImageServer(type("SamModel", (), {})())


def test_image_server_warmup_resets_stats(gguf_path):
    model = depthany_load_model(gguf_path, backend_init("cpu"))
    with ImageServer(model, batch_size=2, max_delay_ms=5) as srv:
        srv.warmup()
        assert srv.stats.requests == 0 and srv.stats.batches == 0


@pytest.mark.parametrize(
    "server,kind,default",
    [("ImageServer", "DepthAnythingModel", 4), ("ImageServer", "BirefnetModel", 4), ("SamServer", "SamModel", 6),
     ("EsrganServer", "EsrganModel", 4), ("ImageServer", "MiganModel", 4), ("YoloServer", "Yolov9tModel", 8)],
)
def test_batch_size_none_takes_the_per_chip_default(server, kind, default):
    """As the JAX package's _resolve_batch (vision_tpu/serve.py:93-104):
    None is the family's per-chip default; an explicit size stays; 0
    raises."""
    import vision_tpu_torch.serve as serve

    cls = getattr(serve, server)
    from types import SimpleNamespace

    # the servers check their model's class name; YoloServer reads its input size
    model = type(kind, (), {"p": SimpleNamespace(input_size=640)})()
    for asked, want in ((None, default), (3, 3)):
        srv = cls(model, batch_size=asked)
        try:
            assert srv.batch_size == want
        finally:
            srv.close()
    with pytest.raises(ValueError, match="batch_size"):
        cls(model, batch_size=0)
