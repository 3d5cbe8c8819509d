"""The port's DINOv2 and Depth-Anything V2 (vision_tpu_torch/models) against
the JAX package's, on the same numpy inputs and the same twin weights (the
torch modules of tests/test_depth_anything.py), in f32 on the CPU; and the
whole model against the committed golden."""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_depth_anything import TDepthAnything, TDinoEmbeddings, TDinoLayer, THead, TNeck
from vision_tpu.core.params import Params as JParams
from vision_tpu.models import depth_anything as jda
from vision_tpu.models import dino as jdino
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.models import depth_anything as da
from vision_tpu_torch.models import dino
from vision_tpu_torch.ops.cuda import flash_attention as fa
from workbench import input_tensor, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3
GOLDEN = Path(__file__).parent / "golden" / "depth_anything.npz"
GOLDEN_RMS = 1e-4  # tests/test_golden.py:23

TEST_P = jda.DepthAnythingParams(
    dino=jdino.DinoParams(patch_size=14, embed_dim=32, n_heads=4, n_layers=4),
    feature_layers=(0, 1, 2, 3),
)
PORT_P = da.DepthAnythingParams(
    dino=dino.DinoParams(patch_size=14, embed_dim=32, n_heads=4, n_layers=4),
    feature_layers=(0, 1, 2, 3),
)


def _stores(module):
    """(port Params, JAX Params) over the twin's weights."""
    store = state_dict_to_params(module.state_dict())
    return Params(params_from_numpy(store, "cpu", torch.float32)), JParams(store)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _match(port_out, jax_out):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("h,w", [(56, 56), (84, 70)], ids=["native_grid", "interpolated"])
def test_prepare_tokens(h, w):
    p, jp = _stores(randomize(TDinoEmbeddings(dim=32, patch=14, grid=4)))
    x = _x(0, 2, h, w, 3)
    _match(dino.prepare_tokens(p, torch.from_numpy(x), 14), jdino.prepare_tokens(jp, x, 14))


def test_dino_layer():
    p, jp = _stores(randomize(TDinoLayer(dim=32, heads=4)))
    x = _x(1, 2, 17, 32)
    _match(dino.layer(p, torch.from_numpy(x), dino.DinoParams(n_heads=4)),
           jdino.layer(jp, x, jdino.DinoParams(n_heads=4)))


def test_neck_and_head():
    pn, jpn = _stores(randomize(TNeck()))
    ph, jph = _stores(randomize(THead()))
    pw = phh = 4
    feats = [_x(s, 1, pw * phh + 1, 32) for s in (1, 2, 3, 4)]
    fused = da.neck(pn, [torch.from_numpy(f) for f in feats], pw, phh)
    jfused = jda.neck(jpn, feats, pw, phh)
    _match(fused, jfused)
    _match(da.head(ph, fused, 56, 56, 1.0), jda.head(jph, jfused, 56, 56, 1.0))


def test_depthany_predict_full():
    p, jp = _stores(randomize(TDepthAnything()))
    x = _x(2, 1, 56, 70, 3)
    _match(da.depthany_predict(p, torch.from_numpy(x), PORT_P), jda.depthany_predict(jp, x, TEST_P))


def test_depthany_predict_golden():
    """The inputs of tests/test_golden.py::test_golden_depth_anything."""
    p, _ = _stores(randomize(TDepthAnything()))
    x = to_nhwc(input_tensor(1, 3, 56, 70))
    out = da.depthany_predict(p, torch.from_numpy(x), PORT_P).numpy()
    golden = np.load(GOLDEN)["output"]
    assert out.shape == golden.shape
    rms = float(np.sqrt(np.mean((golden - out) ** 2)))
    assert rms / (float(np.sqrt(np.mean(golden**2))) + 1e-8) < GOLDEN_RMS


def test_depthany_predict_flash_route(monkeypatch):
    """flash=True at 448x448: 32x32 patches + cls = 1025 tokens >= 1024, so
    every global attention takes the "cuda" route, which on CPU tensors is
    the kernel's plain version; held against JAX at the same extent."""
    calls = []
    plain = fa.flash_attention_plain

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    p, jp = _stores(randomize(TDepthAnything()))
    x = _x(3, 1, 448, 448, 3)
    out = da.depthany_predict(p, torch.from_numpy(x), PORT_P, flash=True)
    assert calls == [(1, 4, 1025, 8)] * 4
    _match(out, jda.depthany_predict(jp, x, TEST_P, flash=True))


@pytest.mark.parametrize(
    "layout,float_type", [(None, None), ("cwhn", None), (None, "q8_0")], ids=["whcn", "cwhn", "q8_0"]
)
def test_load_converted_gguf(tmp_path, layout, float_type):
    """A twin checkpoint through the JAX package's converter: the port's
    loader (load_weights + fixup_weights, layouts un-permuted, quantized
    blocks expanded) yields the JAX loader's arrays exactly."""
    from vision_tpu.convert.convert import convert_model
    from vision_tpu.core.gguf import model_load as jax_model_load
    from vision_tpu.core.weights import load_weights as jax_load_weights
    from vision_tpu_torch.core.gguf import model_load
    from vision_tpu_torch.core.weights import load_weights

    ckpt = tmp_path / "da.pth"
    torch.save(randomize(TDepthAnything()).state_dict(), ckpt)
    path = convert_model("depth-anything", ckpt, tmp_path / "da.gguf", float_type=float_type, layout=layout)
    jf = jax_model_load(path)
    want = jda.fixup_weights(jf, jax_load_weights(jf, as_numpy=True))
    pf = model_load(path)
    got = da.fixup_weights(pf, load_weights(pf, as_numpy=True))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)
    assert da.depthany_detect_params(pf).dino == dino.DinoParams(14, 32, 4, 4)


@pytest.mark.parametrize("extent", [(518, 518), (700, 500)], ids=["snapped", "resized"])
def test_depthany_process_input(extent):
    """The host-side f32 prep (resize to the snapped extent, ImageNet
    normalize) against the JAX package's, on the same RGBA pixels."""
    from vision_tpu.image import Image as JImage
    from vision_tpu.image import ImageFormat as JFormat
    from vision_tpu_torch.image import Image, ImageFormat

    w, h = extent
    px = np.random.default_rng(7).integers(0, 256, (h, w, 4), np.uint8)
    got = da.depthany_process_input(Image(px, ImageFormat.rgba_u8), da.DepthAnythingParams())
    want = jda.depthany_process_input(JImage(px, JFormat.rgba_u8), jda.DepthAnythingParams())
    assert got.dtype == np.float32 and got.shape == want.shape == (518, 518 if w == h else 728, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
