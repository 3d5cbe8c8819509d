"""The port's api.py against the JAX package's: model_detect_family for every
architecture string, and load_model on a small GGUF of each served family,
whose compute must agree with the JAX load_model's within the relative RMS
of tests/test_golden.py:23. The GGUF writers here also serve the graph and
CLI tests."""

import numpy as np
import pytest
import torch

from test_torch_yolov9t import _distinct_scores_store
from vision_tpu import api as japi
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.errors import VispError as JaxVispError
from vision_tpu.image import Image as JaxImage
from vision_tpu.image import ImageFormat as JaxImageFormat
from vision_tpu_torch import api
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.gguf import GGUFWriter
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models.random_weights import (
    random_birefnet_params,
    random_depth_anything_params,
    random_esrgan_params,
    random_migan_params,
    random_mobile_sam_params,
)
from torch_threads import torch_threads  # noqa: F401

REL_RMS = 1e-4  # tests/test_golden.py:23

# family -> (arch string, metadata, weights): each at a small width
FAMILIES = {
    "depthany": ("depthanything", {
        "dino.patch_size": 14, "dino.embed_dim": 64, "dino.n_heads": 2, "dino.n_layers": 4,
        "depthanything.image_size": 126, "depthanything.feature_layers": [0, 1, 2, 3],
        "depthanything.tensor_data_layout": "torch",
    }, lambda: random_depth_anything_params("test", seed=0)),
    "birefnet": ("birefnet", {"birefnet.image_size": 64, "birefnet.image_multiple": 32, "swin.embed_dim": 96},
                 lambda: random_birefnet_params("tiny", seed=0)),
    # 5x random_esrgan_params' scale: about a third of the u8 output lies
    # strictly between 0 and 255 (unscaled it is all 0, 25x mostly saturates)
    "esrgan": ("esrgan", {"esrgan.scale": 4, "esrgan.block_count": 1},
               lambda: {k: v * 5 for k, v in random_esrgan_params(1, nf=8, nb=1, gc=4).items()}),
    "migan": ("migan", {"migan.image_size": 64}, lambda: random_migan_params(64, 2)),
    "yolov9t": ("yolov9t", {}, _distinct_scores_store),
    "sam": ("mobile-sam", {}, lambda: random_mobile_sam_params(0)),
}


def write_family_gguf(family: str, directory) -> str:
    """A small GGUF of ``family`` (a key of FAMILIES) in ``directory``."""
    arch, meta, weights = FAMILIES[family]
    path = directory / f"{family}.gguf"
    w = GGUFWriter(path, arch)
    for k, v in meta.items():
        w.add(k, v)
    for k, a in weights().items():
        w.add_tensor(k, a)
    w.write()
    return str(path)


def sample_image(h=72, w=96, channels=3) -> np.ndarray:
    """A smooth, seeded u8 test image (H, W, channels)."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([(x * 3 + y) % 256, (y * 4) % 256, (x * y) % 256, 255 - (x + y) % 256], -1)[:, :, :channels]
    return (a + rng.integers(0, 8, a.shape)).clip(0, 255).astype(np.uint8)



@pytest.mark.parametrize("arch", sorted(japi._ARCH_TO_FAMILY))
def test_model_detect_family_matches_jax(arch, tmp_path):
    w = GGUFWriter(tmp_path / "m.gguf", arch)
    w.add_tensor("x", np.zeros(4, np.float32))
    w.write()
    path = str(tmp_path / "m.gguf")
    assert api.model_detect_family(path).value == japi.model_detect_family(path).value
    assert {f.value for f in api.ModelFamily} == {f.value for f in japi.ModelFamily}


def test_model_detect_family_rejects_an_unknown_arch(tmp_path):
    w = GGUFWriter(tmp_path / "m.gguf", "llama")
    w.write()
    path = str(tmp_path / "m.gguf")
    with pytest.raises(VispError, match="Unknown model architecture: 'llama'"):
        api.model_detect_family(path)
    with pytest.raises(JaxVispError, match="Unknown model architecture: 'llama'"):
        japi.model_detect_family(path)


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12))


def _compute(model, family, image, mask):
    """family's compute on one request; the result as one f32 array."""
    if family == "sam":
        model.encode(image)
        return model.compute(point=(40, 30)).data
    if family == "migan":
        return model.compute(image, mask).data
    if family == "yolov9t":
        return np.array([[d.x1, d.y1, d.x2, d.y2, d.confidence, d.class_id] for d in model.compute(image)])
    return model.compute(image).data


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_model_matches_jax(family, tmp_path):
    path = write_family_gguf(family, tmp_path)
    model = api.load_model(path, backend_init("cpu"))
    jmodel = japi.load_model(path, jax_backend_init("cpu"))
    assert type(model).__name__ == type(jmodel).__name__
    px = sample_image()
    m = np.zeros((72, 96, 1), np.uint8)
    m[20:50, 30:70] = 255
    got = _compute(model, family, Image(px, ImageFormat.rgb_u8), Image(m, ImageFormat.alpha_u8))
    want = _compute(jmodel, family, JaxImage(px, JaxImageFormat.rgb_u8), JaxImage(m, JaxImageFormat.alpha_u8))
    assert got.shape == want.shape and np.abs(np.asarray(got, np.float64)).sum() > 0
    assert _rel_rms(got, want) <= REL_RMS


def test_load_model_takes_the_card_or_raises(monkeypatch, tmp_path):
    """Without a device load_model takes backend_init()'s: with no card a
    VispError, never the CPU unasked."""
    path = write_family_gguf("yolov9t", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(VispError, match=r'backend_init\("cpu"\)'):
        api.load_model(path)


def test_package_exports():
    import vision_tpu_torch as vt

    for name in ("load_model", "model_detect_family", "GraphCache", "shape_bucket", "snap_to_multiple"):
        assert name in vt.__all__ and getattr(vt, name) is not None


@pytest.mark.parametrize("family", list(api.ModelFamily), ids=lambda f: f.value)
def test_family_loader_is_load_models_dispatch(family):
    """The CLI's model verbs load through family_loader, the dispatch
    load_model makes after detecting the family."""
    import importlib

    module, name = {"sam": ("mobile_sam", "sam_load_model"), "depth_anything": ("depth_anything",
                    "depthany_load_model")}.get(family.value, (family.value, f"{family.value}_load_model"))
    want = getattr(importlib.import_module(f"vision_tpu_torch.models.{module}"), name)
    assert api.family_loader(family) is want
