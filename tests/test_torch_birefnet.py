"""The port's BiRefNet (vision_tpu_torch/models/birefnet.py) against the JAX
package's, on the torch twins of tests/test_birefnet.py (SWIN_TEST encoder,
decoder width 12), in f32 on the CPU: the decoder block in the exact and the
bounded deformable form, the whole ``birefnet_predict`` and the
``birefnet`` golden; and the parts around it: random weights, the loader,
the extent functions, the pre/post processing and the deform_shift flag."""

from pathlib import Path

import numpy as np
import pytest
import torch

from test_birefnet import SWIN_TEST, TBasicDecBlk, TBirefnet
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.gguf import GGUFWriter as JaxGGUFWriter
from vision_tpu.image import Image as JImage
from vision_tpu.image import ImageFormat as JImageFormat
from vision_tpu.models import birefnet as jbiref
from vision_tpu.models.random_weights import random_birefnet_params as jax_random_birefnet_params
from vision_tpu_torch.core.device import BuildFlag, backend_init
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models import birefnet
from vision_tpu_torch.models.random_weights import random_birefnet_params
from vision_tpu_torch.ops.cuda import deform_sample as ds
from vision_tpu_torch.ops.cuda import window_attention as wa
from workbench import input_tensor, make_params, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

GOLDEN = Path(__file__).parent / "golden" / "birefnet.npz"
GOLDEN_RMS = 1e-4  # tests/test_golden.py:23
ATOL, RTOL = 1e-5, 1e-4  # f32, summation order only


def _swin_test():
    from vision_tpu_torch.models.swin import SwinLayerParams, SwinParams

    return SwinParams(SWIN_TEST.embed_dim, SWIN_TEST.window_size,
                      tuple(SwinLayerParams(lp.depth, lp.n_heads, lp.n_features) for lp in SWIN_TEST.layers))


PARAMS = birefnet.BirefnetParams(image_size=64, image_extent=(64, 64), encoder=_swin_test())
JPARAMS = jbiref.BirefnetParams(image_size=64, image_extent=(64, 64), encoder=SWIN_TEST)


def _port(store):
    return Params(params_from_numpy(store, "cpu", torch.float32))


@pytest.mark.parametrize("bound", [None, 2])
def test_decoder_block_matches_jax(bound):
    """conv_in, the deformable ASPP (1x1 aspp1 and the 1/3/7 branches, with
    the exact or the bounded sampler) and conv_out."""
    t = randomize(TBasicDecBlk(6, 10))
    x = to_nhwc(input_tensor(2, 6, 8, 8))
    out = birefnet.basic_decoder_block(_port(state_dict_to_params(t.state_dict())), torch.from_numpy(x), bound)
    expected = jbiref.basic_decoder_block(make_params(t), x, bound)
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=ATOL, rtol=RTOL)


def test_image_to_patches_matches_jax():
    x = np.arange(2 * 8 * 12 * 3, dtype=np.float32).reshape(2, 8, 12, 3)
    out = birefnet.image_to_patches(torch.from_numpy(x), 4, 3)
    assert np.array_equal(out.numpy(), np.asarray(jbiref.image_to_patches(x, 4, 3)))
    with pytest.raises(ValueError, match="does not divide"):
        birefnet.image_to_patches(torch.from_numpy(x), 3, 3)


@pytest.fixture(scope="module")
def twin():
    """The golden's twin and input (tests/test_golden.py:77-85), and the JAX
    package's prediction on them (the slow part: ~1 min of eager JAX)."""
    t = randomize(TBirefnet())
    x = to_nhwc(input_tensor(1, 3, 64, 64))
    store = state_dict_to_params(t.state_dict())
    return store, x, np.asarray(jbiref.birefnet_predict(make_params(t), x, JPARAMS))


def test_birefnet_predict_matches_jax(twin):
    store, x, expected = twin
    before = (wa.launches, ds.launches)
    out = birefnet.birefnet_predict(_port(store), torch.from_numpy(x), PARAMS)
    assert out.shape == (1, 64, 64, 1) and (wa.launches, ds.launches) == before
    np.testing.assert_allclose(out.numpy(), expected, atol=ATOL, rtol=RTOL)


def test_birefnet_golden(twin):
    store, x, _ = twin
    out = birefnet.birefnet_predict(_port(store), torch.from_numpy(x), PARAMS).numpy()
    golden = np.load(GOLDEN)["output"]
    assert out.shape == golden.shape
    rms = float(np.sqrt(np.mean((golden - out) ** 2)))
    assert rms / (float(np.sqrt(np.mean(golden**2))) + 1e-8) < GOLDEN_RMS


@pytest.mark.parametrize("seed", [0, 3])
def test_random_birefnet_params_equal_jax(seed):
    ours, theirs = random_birefnet_params("tiny", seed), jax_random_birefnet_params("tiny", seed)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def _write_twin_gguf(path, store, image_size=64):
    """The twin's weights in a "torch"-layout birefnet file with the custom
    SWIN config keys (its embed width 8 is neither preset)."""
    w = JaxGGUFWriter(path, "birefnet")
    w.add("birefnet.image_size", image_size)
    w.add("birefnet.image_multiple", 32)
    w.add("birefnet.tensor_data_layout", "torch")
    w.add("swin.embed_dim", SWIN_TEST.embed_dim)
    w.add("swin.config", "custom")
    w.add("swin.window", SWIN_TEST.window_size)
    w.add("swin.depths", [lp.depth for lp in SWIN_TEST.layers])
    w.add("swin.num_heads", [lp.n_heads for lp in SWIN_TEST.layers])
    w.add("swin.dims", [lp.n_features for lp in SWIN_TEST.layers])
    for name, a in store.items():
        w.add_tensor(name, a)
    w.write()
    return str(path)


def test_load_gguf_in_both_packages(tmp_path, twin):
    store, x, expected = twin
    path = _write_twin_gguf(tmp_path / "birefnet-twin.gguf", store)
    model = birefnet.birefnet_load_model(path, backend_init("cpu"))
    jmodel = jbiref.birefnet_load_model(path, jax_backend_init("cpu"))
    assert model.p == PARAMS and model.dtype == torch.float32 and model.deform_bound is None
    assert (jmodel.p.image_size, jmodel.p.image_multiple, jmodel.p.image_extent) == (64, 32, (64, 64))
    assert sorted(model.params) == sorted(jmodel.params)
    for k, v in model.params.items():
        assert np.array_equal(v.numpy(), np.asarray(jmodel.params[k])), k
    out = birefnet.birefnet_predict(Params(model.params), torch.from_numpy(x), model.p)
    np.testing.assert_allclose(out.numpy(), expected, atol=ATOL, rtol=RTOL)


def test_compute_post_processes_as_jax(tmp_path, twin):
    """BirefnetModel.compute on a 96x80 u8 image: the stb resize to 64x64,
    the forward, and birefnet_process_output back to 96x80, against the JAX
    package's host-side pre/post processing around the same forward."""
    store, _, _ = twin
    model = birefnet.BirefnetModel(params_from_numpy(store, "cpu", torch.float32), PARAMS, backend_init("cpu"))
    img = np.random.default_rng(5).integers(0, 256, (80, 96, 4), np.uint8)
    out = model.compute(Image(img, ImageFormat.rgba_u8))
    assert out.format == ImageFormat.alpha_u8 and out.extent == (96, 80)
    from vision_tpu.image import image_scale as jimage_scale
    from vision_tpu.image import preprocess_scale_method as jmethod

    small = jimage_scale(JImage(img, JImageFormat.rgba_u8), (64, 64), jmethod()).to_rgb_u8()
    y = model.forward_u8(torch.from_numpy(small[None]))[0].numpy()
    expected = jbiref.birefnet_process_output(y, (96, 80))
    assert np.array_equal(out.data, np.asarray(expected.data))
    batch = model.compute_batch([Image(img, ImageFormat.rgba_u8), Image(img[:64, :64], ImageFormat.rgba_u8)])
    assert [b.extent for b in batch] == [(96, 80), (64, 64)] and np.array_equal(batch[0].data, out.data)


def test_process_input_equals_jax():
    img = np.random.default_rng(6).integers(0, 256, (50, 70, 4), np.uint8)
    ours = birefnet.birefnet_process_input(Image(img, ImageFormat.rgba_u8), PARAMS)
    theirs = jbiref.birefnet_process_input(JImage(img, JImageFormat.rgba_u8), JPARAMS)
    assert ours.shape == (64, 64, 3)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-6)


@pytest.mark.parametrize(
    "size,multiple,extent,max_alloc",
    [(1024, 32, (500, 700), 1 << 40), (-1, 128, (500, 700), 1 << 40), (-1, 32, (4096, 4096), 2 << 30),
     (-1, 128, (4096, 1024), 2 << 30), (-1, 32, (1, 1), 1 << 40)],
)
def test_image_extent_equals_jax(size, multiple, extent, max_alloc):
    p = birefnet.BirefnetParams(image_size=size, image_multiple=multiple)
    jp = jbiref.BirefnetParams(image_size=size, image_multiple=multiple)
    assert birefnet.birefnet_image_extent(extent, p, max_alloc) == jbiref.birefnet_image_extent(extent, jp, max_alloc)
    extents = [extent, (extent[1], extent[0]), (300, 200)]
    assert birefnet.birefnet_batch_extent(extents, p, max_alloc) == jbiref.birefnet_batch_extent(extents, jp, max_alloc)


def test_deform_shift_flag_selects_the_bounded_form(monkeypatch, twin):
    """Off by default (the exact form, as the goldens); VISP_DEFORM_SHIFT=1
    gives the bound 2 that the JAX package takes on the TPU."""
    store, x, _ = twin
    monkeypatch.delenv("VISP_DEFORM_SHIFT", raising=False)
    params = params_from_numpy(store, "cpu", torch.float32)
    dev = backend_init("cpu")
    assert not dev.flags & BuildFlag.deform_shift
    assert birefnet.BirefnetModel(params, PARAMS, dev).deform_bound is None
    monkeypatch.setenv("VISP_DEFORM_SHIFT", "1")
    dev = backend_init("cpu")
    assert dev.flags & BuildFlag.deform_shift
    model = birefnet.BirefnetModel(params, PARAMS, dev)
    assert model.deform_bound == 2
    u8 = np.random.default_rng(7).integers(0, 256, (1, 64, 64, 3), np.uint8)
    got = model.forward_u8(torch.from_numpy(u8))
    from vision_tpu_torch.ops import IMAGENET_MEAN, IMAGENET_STD, normalize_u8

    xn = normalize_u8(torch.from_numpy(u8), IMAGENET_MEAN, IMAGENET_STD, torch.float32)
    assert torch.equal(got, birefnet.birefnet_predict(Params(params), xn, PARAMS, deform_bound=2))


def test_model_lays_out_each_deformable_conv_weight_once(monkeypatch, twin):
    """BirefnetModel lays out every deformable ASPP branch's weight for the
    fused kernel when it is made, and each forward passes those layouts to
    the kernel's calls (which lay the weight out themselves when given
    none)."""
    from vision_tpu_torch.ops.cuda.deform_conv import weight_layout

    store, _, _ = twin
    model = birefnet.BirefnetModel(params_from_numpy(store, "cpu", torch.float32), PARAMS, backend_init("cpu"))
    names = sorted(k for k in model.params if k.endswith("conv.conv.weight") and ".aspp" in k)
    assert names and sorted(model.deform_layouts) == [f"{k}_layout" for k in names]
    for k in names:
        assert torch.equal(model.deform_layouts[f"{k}_layout"], weight_layout(model.params[k], torch.float32))
    seen = []
    real = birefnet.deform_conv_2d_fused

    def spy(*args, layout=None, **kwargs):
        seen.append(layout)
        return real(*args, layout=layout, **kwargs)

    monkeypatch.setattr(birefnet, "deform_conv_2d_fused", spy)
    model.forward_u8(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    assert len(seen) == len(names)
    assert {id(t) for t in seen} == {id(t) for t in model.deform_layouts.values()}
