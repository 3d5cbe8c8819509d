"""The port's Real-ESRGAN (vision_tpu_torch/models/esrgan.py) against the JAX
package's, on the same numpy weights (the torch twin of tests/test_esrgan.py,
or random_esrgan_params), in f32 on the CPU; the ``esrgan`` golden; the
loader; EsrganModel.compute whole and tiled; the tiling engine; and the
image conversions the path uses."""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_esrgan import RRDB, RRDBNet, ResidualDenseBlock, _write_gguf
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.params import Params as JParams
from vision_tpu.image import Image as JImage
from vision_tpu.image import ImageFormat as JImageFormat
from vision_tpu.image import image_alloc as jax_image_alloc
from vision_tpu.image import image_f32_to_u8 as jax_image_f32_to_u8
from vision_tpu.image import tiling as jtiling
from vision_tpu.models import esrgan as jesrgan
from vision_tpu.models.random_weights import random_esrgan_params as jax_random_esrgan_params
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.gguf import GGUFFile, GGUFWriter
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import (
    Image,
    ImageFormat,
    TileLayout,
    image_alloc,
    image_f32_to_u8,
    tile_merge,
    tile_scale,
    tile_weights,
)
from vision_tpu_torch.models import esrgan
from vision_tpu_torch.models.random_weights import random_esrgan_params
from vision_tpu_torch.ops.cuda import conv3x3 as cc
from workbench import input_tensor, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3
GOLDEN = Path(__file__).parent / "golden" / "esrgan.npz"
GOLDEN_RMS = 1e-4  # tests/test_golden.py:23


def _store(module):
    return state_dict_to_params(randomize(module).state_dict())


def _port(store):
    return Params(params_from_numpy(store, "cpu", torch.float32))


def _match(port_out, jax_out):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=ATOL, rtol=RTOL)


def test_residual_dense_block():
    store = _store(ResidualDenseBlock(16, 8))
    x = to_nhwc(input_tensor(2, 16, 12, 11))
    _match(esrgan.residual_dense_block(_port(store), torch.from_numpy(x)),
           jesrgan.residual_dense_block(JParams(store), x))


def test_rrdb():
    store = _store(RRDB(16, 8))
    x = to_nhwc(input_tensor(1, 16, 10, 13))
    _match(esrgan.rrdb(_port(store), torch.from_numpy(x)), jesrgan.rrdb(JParams(store), x))


def test_esrgan_generate():
    """nf 16, gc 8, 2 blocks, scale 4 (the twin and random_esrgan_params only
    name scale 4's layers): every conv through conv_3x3's plain version."""
    store = _store(RRDBNet(nf=16, nb=2, gc=8, scale=4))
    x = to_nhwc(input_tensor(2, 3, 16, 12))
    before = cc.launches
    out = esrgan.esrgan_generate(_port(store), torch.from_numpy(x), esrgan.EsrganParams(4, 2))
    assert out.shape == (2, 64, 48, 3) and cc.launches == before
    _match(out, jesrgan.esrgan_generate(JParams(store), x, jesrgan.EsrganParams(4, 2)))


def test_forward_is_one_conv_call_per_conv_on_dense_block_buffers(monkeypatch):
    """esrgan_generate runs 1 + 15 nb + 5 calls of the conv wrapper at scale
    4 (351 at 23 blocks) and no concatenation: each RDB's conv1-4 write
    their growth channels into a channel view of the block's buffer with
    leaky ReLU fused, conv5 writes x + 0.2 * y into the next buffer, and
    RDB3's conv5 also takes the RRDB's residual."""
    from vision_tpu_torch.ops.cuda import conv3x3 as ccm

    calls = []
    real = ccm.conv3x3

    def spy(x, w, b=None, **kw):
        out = kw.get("out")
        calls.append((x.shape[-1], w.shape[0], kw.get("slope"), kw.get("r1") is not None, kw.get("r2") is not None,
                      out is not None and not out.is_contiguous()))
        return real(x, w, b, **kw)

    def no_cat(*args, **kwargs):
        raise AssertionError("torch.cat on the Real-ESRGAN path")

    monkeypatch.setattr(ccm, "conv3x3", spy)
    monkeypatch.setattr(torch, "cat", no_cat)
    nf, gc, nb = 16, 8, 2
    store = _store(RRDBNet(nf=nf, nb=nb, gc=gc, scale=4))
    x = to_nhwc(input_tensor(1, 3, 12, 10))
    out = esrgan.esrgan_generate(_port(store), torch.from_numpy(x), esrgan.EsrganParams(4, nb))
    assert len(calls) == 1 + 15 * nb + 5
    growth = [(nf + k * gc, gc, 0.2, False, False, True) for k in range(4)]
    rdb = growth + [(nf + 4 * gc, nf, None, True, False, True)]
    rdb3 = growth + [(nf + 4 * gc, nf, None, True, True, True)]
    assert calls[0] == (3, nf, None, False, False, True)  # the stem, into the first buffer
    assert calls[1:1 + 15 * nb] == (rdb + rdb + rdb3) * nb
    assert calls[1 + 15 * nb:] == [(nf, nf, None, True, False, False), (nf, nf, 0.2, False, False, False),
                                   (nf, nf, 0.2, False, False, False), (nf, nf, 0.2, False, False, False),
                                   (nf, 3, None, False, False, False)]
    monkeypatch.undo()
    _match(out, jesrgan.esrgan_generate(JParams(store), x, jesrgan.EsrganParams(4, nb)))


def test_esrgan_golden():
    """The inputs of tests/test_golden.py::test_golden_esrgan."""
    store = _store(RRDBNet(nf=8, nb=1, gc=4, scale=4))
    x = to_nhwc(input_tensor(1, 3, 16, 16))
    out = esrgan.esrgan_generate(_port(store), torch.from_numpy(x), esrgan.EsrganParams(4, 1)).numpy()
    golden = np.load(GOLDEN)["output"]
    assert out.shape == golden.shape
    rms = float(np.sqrt(np.mean((golden - out) ** 2)))
    assert rms / (float(np.sqrt(np.mean(golden**2))) + 1e-8) < GOLDEN_RMS


@pytest.mark.parametrize("kwargs", [{}, {"seed": 3, "nf": 16, "nb": 2, "gc": 8}])
def test_random_esrgan_params_equal_jax(kwargs):
    ours, theirs = random_esrgan_params(**kwargs), jax_random_esrgan_params(**kwargs)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_load_whcn_gguf_in_both_packages(tmp_path):
    """tests/test_esrgan.py's recipe: a torch state dict in a whcn file,
    loaded by both packages to the same weights and the same output."""
    t = randomize(RRDBNet(nf=8, nb=1, gc=4, scale=4))
    path = str(_write_gguf(tmp_path / "esrgan.gguf", t, 4, 1))
    model = esrgan.esrgan_load_model(path, backend_init("cpu"))
    jmodel = jesrgan.esrgan_load_model(path, jax_backend_init("cpu"))
    assert model.p == esrgan.EsrganParams(4, 1) and model.dtype == torch.float32
    assert sorted(model.params) == sorted(jmodel.params)
    for k, v in model.params.items():
        assert np.array_equal(v.numpy(), np.asarray(jmodel.params[k])), k
    x = to_nhwc(input_tensor(1, 3, 9, 7))
    _match(esrgan.esrgan_generate(Params(model.params), torch.from_numpy(x), model.p),
           jesrgan.esrgan_generate(JParams(jmodel.params), x, jmodel.p))


@pytest.mark.parametrize(
    "meta,match",
    [
        ({"esrgan.scale": 16, "esrgan.block_count": 23}, "unsupported scale"),
        ({"esrgan.scale": 4, "esrgan.block_count": 24}, "invalid number of blocks"),
        ({"esrgan.scale": 4}, "missing metadata key"),
    ],
)
def test_esrgan_detect_params_validation(tmp_path, meta, match):
    path = tmp_path / "bad.gguf"
    w = GGUFWriter(path, "esrgan")
    for k, v in meta.items():
        w.add(k, v)
    w.write()
    with pytest.raises(VispError, match=match):
        esrgan.esrgan_detect_params(GGUFFile(path))


def test_esrgan_detect_params_rejects_other_arch(tmp_path):
    path = tmp_path / "other.gguf"
    GGUFWriter(path, "mobile-sam").write()
    with pytest.raises(VispError, match="expected to be 'esrgan'"):
        esrgan.esrgan_detect_params(GGUFFile(path))


# -- EsrganModel.compute against the JAX package's --


@pytest.fixture(scope="module")
def models():
    """One twin's weights (std 0.1: a non-zero output, unlike
    random_esrgan_params, whose u8 output is all 0) in both packages."""
    store = _store(RRDBNet(nf=8, nb=1, gc=4, scale=4))
    model = esrgan.EsrganModel(params_from_numpy(store, "cpu", torch.float32), esrgan.EsrganParams(4, 1),
                               backend_init("cpu"))
    jmodel = jesrgan.EsrganModel(store, jesrgan.EsrganParams(4, 1), jax_backend_init("cpu"))
    return model, jmodel


def _rgb(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize(
    "h,w,kwargs",
    [
        (20, 24, {}),  # whole
        (40, 56, {"tile_size": 32, "batch": 2}),  # 4 tiles of 48x32 in 2 chunks
        (40, 56, {"tile_size": 32, "batch": 3}),  # the last chunk padded
    ],
)
def test_compute_matches_jax(models, h, w, kwargs):
    """u8 within one level (the JAX package serves the regrouped packed
    form, which agrees with this one to 2e-5 at f32) and >= 99% of pixels
    equal."""
    model, jmodel = models
    src = _rgb(h * w, h, w)
    out = model.compute(Image(src, ImageFormat.rgb_u8), **kwargs)
    jout = jmodel.compute(JImage(src, JImageFormat.rgb_u8), **kwargs)
    assert out.format == ImageFormat.rgba_u8 and out.extent == (4 * w, 4 * h)
    a, b = out.data.astype(np.int16), jout.data.astype(np.int16)
    assert (a[..., 3] == 255).all()
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() >= 0.99
    assert 5 < a[..., :3].mean() < 250, "the output must not be all 0 or all 255"


def test_compute_tiled_launch_count_and_chunks(models, monkeypatch):
    """The tiled path runs ceil(tiles / batch) forwards of ``batch`` tiles;
    on the CPU no kernel launches."""
    model, _ = models
    calls = []
    real = model.forward_u8

    def spy(x, to_u8=True):
        calls.append((tuple(x.shape), to_u8))
        return real(x, to_u8)

    monkeypatch.setattr(model, "forward_u8", spy)
    before = cc.launches
    model.compute(Image(_rgb(1, 40, 56), ImageFormat.rgb_u8), tile_size=32, batch=3)
    assert calls == [((3, 32, 48, 3), False), ((3, 32, 48, 3), False)]
    assert cc.launches == before


# -- the tiling engine and the image conversions --


@pytest.mark.parametrize(
    "extent,tile,overlap",
    [((56, 40), 32, 16), ((640, 480), 224, 16), ((1000, 300), 256, 16), ((224, 224), 224, 16),
     ((17, 300), 64, 8), ((1601, 1203), 224, 16)],
)
def test_tiling_matches_jax(extent, tile, overlap):
    ours, theirs = TileLayout(extent, tile, overlap), jtiling.TileLayout(extent, tile, overlap)
    for a, b in ((ours, theirs), (tile_scale(ours, 4), jtiling.tile_scale(theirs, 4))):
        assert (a.image_extent, a.overlap, a.n_tiles, a.tile_size) == (b.image_extent, b.overlap, b.n_tiles, b.tile_size)
        assert a.total() == b.total()
        for t in range(a.total()):
            c = a.coord(t)
            assert c == b.coord(t)
            assert (a.start(c), a.end(c), a.size(c)) == (b.start(c), b.end(c), b.size(c))
            assert (a.start(c, a.overlap), a.end(c, a.overlap)) == (b.start(c, b.overlap), b.end(c, b.overlap))
            assert np.array_equal(tile_weights(a, c), jtiling.tile_weights(b, c))


def test_tile_merge_matches_jax():
    layout = tile_scale(TileLayout((56, 40), 32, 16), 4)
    jlayout = jtiling.tile_scale(jtiling.TileLayout((56, 40), 32, 16), 4)
    rng = np.random.default_rng(2)
    dst = image_alloc(layout.image_extent, ImageFormat.rgb_f32)
    jdst = jax_image_alloc(layout.image_extent, JImageFormat.rgb_f32)
    assert dst.data.shape == jdst.data.shape and not dst.data.any()
    for t in range(layout.total()):
        tile = rng.random((layout.tile_size[1], layout.tile_size[0], 3)).astype(np.float32)
        tile_merge(Image(tile, ImageFormat.rgb_f32), dst, layout.coord(t), layout)
        jtiling.tile_merge(JImage(tile, JImageFormat.rgb_f32), jdst, layout.coord(t), jlayout)
    assert np.array_equal(dst.data, jdst.data)
    with pytest.raises(VispError, match="rgb_f32"):
        tile_merge(Image(np.zeros((4, 4, 3), np.uint8), ImageFormat.rgb_u8), dst, (0, 0), layout)


@pytest.mark.parametrize("fmt", ["rgba_u8", "rgb_u8", "alpha_u8"])
@pytest.mark.parametrize("src_fmt,channels", [("rgb_f32", 3), ("rgba_f32", 4), ("alpha_f32", 1)])
def test_image_f32_to_u8_matches_jax(fmt, src_fmt, channels):
    a = (np.random.default_rng(channels).random((5, 7, channels)) * 1.4 - 0.2).astype(np.float32)
    ours = image_f32_to_u8(Image(a, ImageFormat[src_fmt]), ImageFormat[fmt], scale=0.9, offset=0.05)
    theirs = jax_image_f32_to_u8(JImage(a, JImageFormat[src_fmt]), JImageFormat[fmt], scale=0.9, offset=0.05)
    assert ours.format == ImageFormat[fmt] and np.array_equal(ours.data, theirs.data)


def test_image_f32_to_u8_rejects_what_the_reference_does():
    with pytest.raises(VispError):
        image_f32_to_u8(Image(np.zeros((2, 2, 3), np.uint8), ImageFormat.rgb_u8), ImageFormat.rgba_u8)
    with pytest.raises(VispError, match="bgra_u8"):
        image_f32_to_u8(Image(np.zeros((2, 2, 3), np.float32), ImageFormat.rgb_f32), ImageFormat.bgra_u8)
