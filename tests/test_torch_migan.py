"""The port's MI-GAN (vision_tpu_torch/models/migan.py) against the JAX
package's, on the same numpy weights (the torch twins of tests/test_migan.py,
or random_migan_params), in f32 on the CPU: each block, the encoder, the
generator, the ``migan`` golden, the pre- and post-processing, the loader,
MiganModel and ImageServer with (image, mask) requests."""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_migan import TMigan, TSeparable, TUp
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.params import Params as JParams
from vision_tpu.image import Image as JImage
from vision_tpu.image import ImageFormat as JImageFormat
from vision_tpu.image import image_set_alpha as jax_image_set_alpha
from vision_tpu.models import migan as jmigan
from vision_tpu.models.random_weights import random_migan_params as jax_random_migan_params
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.gguf import GGUFWriter
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat, image_set_alpha
from vision_tpu_torch.models import migan
from vision_tpu_torch.models.random_weights import random_migan_params
from vision_tpu_torch.ops.cuda import conv3x3 as cc
from workbench import input_tensor, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4  # f32 sums taken in another order
GOLDEN = Path(__file__).parent / "golden" / "migan.npz"
GOLDEN_RMS = 1e-4  # tests/test_golden.py:23


def _store(module):
    return state_dict_to_params(randomize(module).state_dict())


def _port(store):
    return Params(params_from_numpy(store, "cpu", torch.float32))


def _match(port_out, jax_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=atol, rtol=rtol)


def test_lrelu_agc():
    x = to_nhwc(input_tensor(1, 4, 8, 8)) * 300
    _match(migan.lrelu_agc(torch.from_numpy(x), 0.2, 1.4142135623, 256), jmigan.lrelu_agc(x, 0.2, 1.4142135623, 256))


def test_upsample_2d():
    store = _store(TUp(6, 8))
    x = to_nhwc(input_tensor(2, 6, 8, 8))
    _match(migan.upsample_2d(_port(store), torch.from_numpy(x)), jmigan.upsample_2d(JParams(store), x))


def test_downsample_2d():
    store = {"filter.weight": (np.random.default_rng(1).standard_normal((6, 1, 3, 3)) * 0.3).astype(np.float32)}
    x = to_nhwc(input_tensor(2, 6, 16, 16))
    _match(migan.downsample_2d(_port(store), torch.from_numpy(x)), jmigan.downsample_2d(JParams(store), x))


@pytest.mark.parametrize(
    "flags,res",
    [
        ({"activation": True}, 16),
        ({"activation": True, "down": True}, 16),
        ({"activation": True, "up": True, "noise": True}, 8),
        ({"noise": True}, 16),
    ],
)
def test_separable_conv_2d(flags, res):
    """Depthwise + 1x1 with the activation, the downsample, the upsample and
    the baked noise (a nonzero strength here)."""
    store = _store(TSeparable(8, 12, 3, res, **flags))
    x = to_nhwc(input_tensor(1, 8, res, res))
    kw = {"activation": flags.get("activation", False), "downsample": flags.get("down", False),
          "upsample": flags.get("up", False), "noise": flags.get("noise", False)}
    _match(migan.separable_conv_2d(_port(store), torch.from_numpy(x), **kw),
           jmigan.separable_conv_2d(JParams(store), x, **kw), atol=1e-4)


def test_encode():
    store = _store(TMigan())
    x = to_nhwc(input_tensor(1, 4, 16, 16))
    out, feats = migan.encode(_port(store)["encoder"], torch.from_numpy(x), 16)
    jout, jfeats = jmigan.encode(JParams(store)["encoder"], x, 16)
    _match(out, jout, atol=1e-4)
    assert len(feats) == len(jfeats) == 3
    for f, jf in zip(feats, jfeats):
        _match(f, jf, atol=1e-4)


def test_migan_generate_twin():
    store = _store(TMigan())
    x = to_nhwc(input_tensor(2, 4, 16, 16))
    p = migan.MiganParams(resolution=16)
    _match(migan.migan_generate(_port(store), torch.from_numpy(x), p),
           jmigan.migan_generate(JParams(store), x, jmigan.MiganParams(resolution=16)), atol=1e-4)


def test_migan_generate_random_params_at_32():
    """random_migan_params at resolution 32 (the ladder b32 .. b4 at full
    width, 512 channels at the bottom): no hand-written kernel on the path."""
    store = random_migan_params(32, 0)
    x = (np.random.default_rng(2).standard_normal((1, 32, 32, 4)) * 0.5).astype(np.float32)
    before = cc.launches
    out = migan.migan_generate(_port(store), torch.from_numpy(x), migan.MiganParams(resolution=32))
    ref = np.asarray(jmigan.migan_generate(JParams(store), x, jmigan.MiganParams(resolution=32)))
    assert cc.launches == before and out.shape == (1, 32, 32, 3)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * scale, rtol=RTOL)


def test_migan_golden():
    """The inputs of tests/test_golden.py::test_golden_migan."""
    store = _store(TMigan())
    x = to_nhwc(input_tensor(1, 4, 16, 16))
    out = migan.migan_generate(_port(store), torch.from_numpy(x), migan.MiganParams(resolution=16)).numpy()
    golden = np.load(GOLDEN)["output"]
    assert out.shape == golden.shape
    rms = float(np.sqrt(np.mean((golden - out) ** 2)))
    assert rms / (float(np.sqrt(np.mean(golden**2))) + 1e-8) < GOLDEN_RMS


@pytest.mark.parametrize("kwargs", [{}, {"resolution": 64, "seed": 2}])
def test_random_migan_params_equal_jax(kwargs):
    ours, theirs = random_migan_params(**kwargs), jax_random_migan_params(**kwargs)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


# -- pre / post processing --


def _images(rng, w, h, image_kind, mask_kind):
    """(port image, port mask, JAX image, JAX mask) on the same pixels."""
    fmt = {"rgb": ImageFormat.rgb_u8, "rgba": ImageFormat.rgba_u8}[image_kind]
    jfmt = {"rgb": JImageFormat.rgb_u8, "rgba": JImageFormat.rgba_u8}[image_kind]
    a = rng.integers(0, 256, (h, w, 3 if image_kind == "rgb" else 4), np.uint8)
    if mask_kind == "u8":
        m = (rng.random((h, w, 1)) > 0.5).astype(np.uint8) * 255
        mf, jmf = ImageFormat.alpha_u8, JImageFormat.alpha_u8
    else:
        m = rng.random((h, w, 1)).astype(np.float32)
        mf, jmf = ImageFormat.alpha_f32, JImageFormat.alpha_f32
    return Image(a, fmt), Image(m, mf), JImage(a.copy(), jfmt), JImage(m.copy(), jmf)


@pytest.mark.parametrize("w,h", [(16, 16), (24, 20)])
@pytest.mark.parametrize("image_kind,mask_kind", [("rgb", "u8"), ("rgba", "f32")])
@pytest.mark.parametrize("invert", [True, False])
def test_migan_process_input(w, h, image_kind, mask_kind, invert):
    img, mask, jimg, jmask = _images(np.random.default_rng(w * h), w, h, image_kind, mask_kind)
    ours = migan.migan_process_input(img, mask, migan.MiganParams(16, invert))
    theirs = jmigan.migan_process_input(jimg, jmask, jmigan.MiganParams(16, invert))
    assert ours.shape == (16, 16, 4) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=0)


@pytest.mark.parametrize("w,h", [(16, 16), (30, 22)])
@pytest.mark.parametrize("image_kind,mask_kind", [("rgb", "u8"), ("rgba", "f32")])
def test_migan_process_output(w, h, image_kind, mask_kind):
    """The raw output resized to the request, * 0.5 + 0.5 to u8, the mask
    (a float mask scaled to u8, not truncated) as alpha: the JAX package's
    bytes."""
    rng = np.random.default_rng(w + h)
    img, mask, jimg, jmask = _images(rng, w, h, image_kind, mask_kind)
    raw = (rng.standard_normal((16, 16, 3)) * 0.7).astype(np.float32)
    ours = migan.migan_process_output(raw, img, mask)
    theirs = jmigan.migan_process_output(raw, jimg, jmask)
    assert ours.format == ImageFormat.rgba_u8 and ours.extent == (w, h)
    assert np.array_equal(ours.data, theirs.data)
    if mask_kind == "f32" and (w, h) == (16, 16):
        assert 0 < ours.data[..., 3].mean() < 255 and len(np.unique(ours.data[..., 3])) > 2


def test_image_set_alpha_matches_jax_and_checks():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (5, 6, 4), np.uint8)
    m = rng.integers(0, 256, (5, 6, 1), np.uint8)
    ours, theirs = Image(a.copy(), ImageFormat.bgra_u8), JImage(a.copy(), JImageFormat.bgra_u8)
    image_set_alpha(ours, Image(m, ImageFormat.alpha_u8))
    jax_image_set_alpha(theirs, JImage(m.copy(), JImageFormat.alpha_u8))
    assert np.array_equal(ours.data, theirs.data)
    with pytest.raises(VispError, match="alpha_u8"):
        image_set_alpha(ours, Image(m.astype(np.float32) / 255, ImageFormat.alpha_f32))
    with pytest.raises(VispError, match="4-channel"):
        image_set_alpha(Image(a[..., :3].copy(), ImageFormat.rgb_u8), Image(m, ImageFormat.alpha_u8))
    with pytest.raises(VispError, match="extent"):
        image_set_alpha(ours, Image(m[:4], ImageFormat.alpha_u8))


# -- loader, model, server --


@pytest.fixture(scope="module")
def migan_gguf(tmp_path_factory):
    """random_migan_params(64, 2) as a migan GGUF at image_size 64."""
    path = tmp_path_factory.mktemp("torch_migan") / "migan-64.gguf"
    w = GGUFWriter(path, "migan")
    w.add("migan.image_size", 64)
    for name, a in random_migan_params(64, 2).items():
        w.add_tensor(name, a)
    w.write()
    return str(path)


def _request(rng, w, h, image_kind="rgb"):
    """(port (image, mask), JAX (image, mask)): an RGBA request carries the
    mask in its alpha channel, as a client may send it."""
    m = np.zeros((h, w, 1), np.uint8)
    m[h // 4 : h // 2, w // 3 : 2 * w // 3] = 255
    a = rng.integers(0, 256, (h, w, 3), np.uint8)
    if image_kind == "rgba":
        a = np.concatenate([a, m], 2)
        fmt, jfmt = ImageFormat.rgba_u8, JImageFormat.rgba_u8
    else:
        fmt, jfmt = ImageFormat.rgb_u8, JImageFormat.rgb_u8
    return ((Image(a, fmt), Image(m, ImageFormat.alpha_u8)),
            (JImage(a.copy(), jfmt), JImage(m.copy(), JImageFormat.alpha_u8)))


def test_load_model_and_forward_match_jax(migan_gguf):
    """migan_load_model reads the same weights as the JAX package's; the
    on-card preprocess and generator of forward_u8 give the JAX program's
    raw output; compute gives the JAX compute's bytes to one level."""
    model = migan.migan_load_model(migan_gguf, backend_init("cpu"))
    jmodel = jmigan.migan_load_model(migan_gguf, jax_backend_init("cpu"))
    assert model.p == migan.MiganParams(64, True) and model.dtype == torch.float32
    for k, v in model.params.items():
        assert np.array_equal(v.numpy(), np.asarray(jmodel.params[k])), k
    (img, mask), (jimg, jmask) = _request(np.random.default_rng(4), 64, 64)
    x, m = img.to_rgb_u8()[None], mask.data[None]
    raw = model.forward_u8(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    jraw = np.asarray(jmodel._run(jmodel.params, x, m))
    np.testing.assert_allclose(raw, jraw, atol=1e-5 * float(np.abs(jraw).max()), rtol=RTOL)
    ours, theirs = model.compute(img, mask), jmodel.compute(jimg, jmask)
    assert ours.extent == theirs.extent == (64, 64)
    assert int(np.abs(ours.data.astype(np.int16) - theirs.data.astype(np.int16)).max()) <= 1


def test_image_server_serves_migan_like_the_jax_server(migan_gguf):
    """ImageServer with (image, mask) requests on the port's MiganModel and
    on the JAX package's: a 64x64 request, a 96x80 one and an RGBA 48x40
    one (its alpha the mask) in one batch, results within one level."""
    from vision_tpu.serve import ImageServer as JImageServer
    from vision_tpu_torch.serve import ImageServer

    rng = np.random.default_rng(5)
    reqs = [_request(rng, 64, 64), _request(rng, 96, 80), _request(rng, 48, 40, "rgba")]
    model = migan.migan_load_model(migan_gguf, backend_init("cpu"))
    jmodel = jmigan.migan_load_model(migan_gguf, jax_backend_init("cpu"))
    with ImageServer(model, batch_size=3, max_delay_ms=10_000) as srv:
        ours = [f.result(timeout=600) for f in [srv.submit(r[0]) for r in reqs]]
        assert srv.stats.batches == 1
    with JImageServer(jmodel, batch_size=3, max_delay_ms=10_000) as srv:
        theirs = [f.result(timeout=600) for f in [srv.submit(r[1]) for r in reqs]]
    for (req, _), o, t in zip(reqs, ours, theirs):
        assert o.format == ImageFormat.rgba_u8 and o.extent == req[0].extent
        assert np.array_equal(o.data[..., 3:], req[1].data)
        assert int(np.abs(o.data.astype(np.int16) - t.data.astype(np.int16)).max()) <= 1


def test_image_server_migan_prep_does_not_premultiply_mask(migan_gguf):
    """An off-resolution RGBA request (alpha = the mask) keeps its RGB
    through the resize: stb's resize premultiplies alpha, which would black
    out the region to keep (alpha 0 there) before the model sees it."""
    from vision_tpu_torch.serve import ImageServer

    model = migan.migan_load_model(migan_gguf, backend_init("cpu"))
    with ImageServer(model, batch_size=1, max_delay_ms=1) as srv:
        rgba = np.full((32, 32, 4), 200, np.uint8)
        rgba[:, :, 3] = 0
        rgba[12:20, 12:20, 3] = 255
        x, m, res, _ = srv._prepare((Image(rgba, ImageFormat.rgba_u8),
                                     Image(np.ascontiguousarray(rgba[:, :, 3:4]), ImageFormat.alpha_u8)))
        assert res == (64, 64) and x.shape == (64, 64, 3) and m.shape == (64, 64, 1) and m.dtype == np.uint8
        assert float(x[:8, :8].mean()) > 150.0


def test_image_server_migan_float_mask_and_warmup(migan_gguf):
    """A float mask is scaled to u8 for the model; warmup runs a zero mask
    and resets the stats."""
    from vision_tpu_torch.serve import ImageServer

    model = migan.migan_load_model(migan_gguf, backend_init("cpu"))
    img = Image(np.random.default_rng(6).integers(0, 256, (64, 64, 3), np.uint8), ImageFormat.rgb_u8)
    fmask = Image(np.full((64, 64, 1), 0.5, np.float32), ImageFormat.alpha_f32)
    with ImageServer(model, batch_size=2, max_delay_ms=5) as srv:
        srv.warmup()
        assert srv.stats.requests == 0 and srv.stats.batches == 0
        _, m, _, _ = srv._prepare((img, fmask))
        assert (m == 127).all()
        out = srv.compute((img, fmask))
    assert (out.data[..., 3] == 127).all()
