"""The port's MobileSAM (vision_tpu_torch/models/mobile_sam.py) against the
JAX package's, on the same numpy inputs and the same twin weights (the torch
modules of tests/test_mobile_sam.py), in f32 on the CPU unless stated; the
three SAM goldens; pre/post processing; the loader; and the routes the
attentions take."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mobile_sam import (
    TEST_CFG,
    TEST_TP,
    TAttention,
    TMaskDecoder,
    TMBConv,
    TPatchMerging,
    TTinyVit,
    TTinyVitBlock,
    TTwoWay,
    fuse_params,
)
from vision_tpu.core.params import Params as JParams
from vision_tpu.core.weights import cast_float_params as jax_cast_float_params
from vision_tpu.image import Image as JImage
from vision_tpu.image import ImageFormat as JImageFormat
from vision_tpu.models import mobile_sam as jsam
from vision_tpu.models.random_weights import random_mobile_sam_params as jax_random_mobile_sam_params
from vision_tpu.ops import nn as jnn
from vision_tpu_torch.core.device import BackendType, BuildFlag, Device
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models import mobile_sam as sam
from vision_tpu_torch.models.random_weights import random_mobile_sam_params
from vision_tpu_torch.ops import nn
from vision_tpu_torch.ops.cuda import flash_attention as fa
from vision_tpu_torch.ops.cuda import window_attention as wa
from workbench import input_tensor, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL, RTOL = 1e-4, 1e-3
GOLDEN = Path(__file__).parent / "golden"
GOLDEN_RMS = 1e-4  # tests/test_golden.py:23
BF16_REL_RMS = 2e-2  # bf16 rounds at different points in the two frameworks

PORT_TP = sam.TinyVitParams(
    img_size=TEST_TP.img_size,
    layers=tuple(sam.TinyVitLayer(*(getattr(lp, f) for f in (
        "resolution", "embed_dim", "depth", "num_heads", "window_size", "downsample"))) for lp in TEST_TP.layers),
)


def _port(store, dtype=torch.float32):
    return Params(params_from_numpy(store, "cpu", dtype))


def _stores(jp: JParams):
    """(port Params, JAX Params) over one numpy store."""
    return _port(jp.store), jp


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _match(port_out, jax_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port_out.float().numpy(), np.asarray(jax_out, np.float32), atol=atol, rtol=rtol)


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b**2)) + 1e-12))


@pytest.fixture(scope="module")
def sam_store():
    return random_mobile_sam_params(0)


# -- TinyViT pieces --


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_2d_depthwise(stride):
    store = {"weight": _x(0, 12, 1, 3, 3), "bias": _x(1, 12)}
    x = _x(2, 2, 9, 11, 12)
    _match(nn.conv_2d_depthwise(_port(store), torch.from_numpy(x), stride, 1),
           jnn.conv_2d_depthwise(JParams(store), x, stride, 1), atol=1e-5, rtol=1e-4)


def test_batch_norm_2d():
    store = {"weight": _x(3, 8), "bias": _x(4, 8)}
    x = _x(5, 2, 5, 5, 8)
    _match(nn.batch_norm_2d(_port(store), torch.from_numpy(x)), jnn.batch_norm_2d(JParams(store), x), atol=1e-6)
    store["running_mean"] = np.zeros(8, np.float32)
    with pytest.raises(Exception, match="not fused"):
        nn.batch_norm_2d(_port(store), torch.from_numpy(x))


@pytest.mark.parametrize("split_dim", [1, 2])
def test_split_qkv(split_dim):
    store = {"weight": _x(6, 48, 16), "bias": _x(7, 48)}
    x = _x(8, 2, 5, 16)
    for got, want in zip(nn.split_qkv(_port(store), torch.from_numpy(x), 2, split_dim),
                         jnn.split_qkv(JParams(store), x, 2, split_dim)):
        assert got.shape == want.shape == (2, 2, 5, 8)
        _match(got, want, atol=1e-5, rtol=1e-4)


def test_window_partition_reverse_exact():
    x = _x(9, 2, 9, 11, 5)  # not divisible by the window: zero pad
    w = sam.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jsam.window_partition(x, 4)))
    back = sam.window_reverse(w, 11, 9, 4)
    np.testing.assert_array_equal(back.numpy(), x)


def test_mb_conv():
    p, jp = _stores(fuse_params(randomize(TMBConv(8))))
    x = to_nhwc(input_tensor(1, 8, 14, 14))
    _match(sam.mb_conv(p, torch.from_numpy(x)), jsam.mb_conv(jp, x))


@pytest.mark.parametrize("ci,co,hw", [(8, 16, 14), (16, 320, 7)], ids=["stride2", "stride1_c320"])
def test_patch_merging(ci, co, hw):
    p, jp = _stores(fuse_params(randomize(TPatchMerging(ci, co))))
    x = to_nhwc(input_tensor(1, ci, hw, hw))
    out = sam.patch_merging(p, torch.from_numpy(x))
    assert out.shape == (1, (hw // 2 if co != 320 else hw) ** 2, co)
    _match(out, jsam.patch_merging(jp, x))


def test_attention_rel_bias():
    p, jp = _stores(fuse_params(randomize(TAttention(16, 2, 4))))
    x = input_tensor(3, 16, 16).numpy()
    _match(sam.attention_rel_bias(p, torch.from_numpy(x), 16, 2), jsam.attention_rel_bias(jp, x, 16, 2))


def test_tiny_vit_block():
    p, jp = _stores(fuse_params(randomize(TTinyVitBlock(16, 7, 2, 4))))
    x = input_tensor(1, 49, 16).numpy()
    _match(sam.tiny_vit_block(p, torch.from_numpy(x), 7, 16, 2, 4), jsam.tiny_vit_block(jp, x, 7, 16, 2, 4))


def test_tiny_vit():
    p, jp = _stores(fuse_params(randomize(TTinyVit(TEST_CFG, 56))))
    x = to_nhwc(input_tensor(1, 3, 56, 56))
    _match(sam.tiny_vit(p, torch.from_numpy(x), PORT_TP), jsam.tiny_vit(jp, x, TEST_TP))


# -- prompt encoder and decoder --


def test_embed_points_and_box(sam_store):
    p, jp = Params(params_from_numpy(sam_store, "cpu", torch.float32)), JParams(sam_store)
    pts = sam.sam_process_point((40, 30), (128, 96))
    box = sam.sam_process_box((10, 10), (100, 80), (128, 96))
    _match(sam.sam_encode_points(p, torch.from_numpy(pts)), jsam.sam_encode_points(jp, pts), atol=1e-5, rtol=1e-5)
    _match(sam.sam_encode_box(p, torch.from_numpy(box)), jsam.sam_encode_box(jp, box), atol=1e-5, rtol=1e-5)


def test_two_way_transformer():
    t = randomize(TTwoWay(32))
    p, jp = _stores(JParams(state_dict_to_params(t.state_dict())))
    emb = to_nhwc(input_tensor(1, 32, 8, 8))
    pe = to_nhwc(input_tensor(1, 32, 8, 8, seed=3)).reshape(1, 64, 32)
    pts = input_tensor(1, 6, 32, seed=4).numpy()
    q, k = sam.two_way_transformer(p, *(torch.from_numpy(a) for a in (emb, pe, pts)), 2, 8)
    jq, jk = jsam.two_way_transformer(jp, emb, pe, pts, 2, 8)
    _match(q, jq)
    _match(k, jk)


def _decoder_twin():
    """The inputs of tests/test_golden.py::test_golden_sam_decoder."""
    t = randomize(TMaskDecoder())
    store = state_dict_to_params(t.state_dict())
    store["dense_positional_embedding"] = to_nhwc(input_tensor(1, 32, 8, 8, seed=5))[0]
    emb = to_nhwc(input_tensor(1, 32, 8, 8))
    sparse = input_tensor(1, 2, 32, seed=6).numpy()
    dense = input_tensor(32, seed=7).numpy()
    return store, emb, sparse, dense


def test_predict_masks():
    store, emb, sparse, dense = _decoder_twin()
    pred = sam.predict_masks(_port(store), *(torch.from_numpy(a) for a in (emb, sparse, dense)))
    jpred = jsam.predict_masks(JParams(store), emb, sparse, dense)
    _match(pred.masks, jpred.masks)
    _match(pred.iou, jpred.iou)


def _full_width_inputs(store, dtype, jdtype):
    """The production decoder (256 wide, 64x64 embedding) on
    random_mobile_sam_params(0) with a point prompt, in both packages, the
    weights and the embedding in ``dtype`` and the prompt in f32."""
    emb = _x(11, 1, 64, 64, 256)
    coords = sam.sam_process_point((300, 200), (640, 480))
    p = Params(params_from_numpy(store, "cpu", dtype))
    jp = JParams(jax_cast_float_params({k: np.asarray(v) for k, v in store.items()}, jdtype))
    return p, jp, torch.from_numpy(emb).to(dtype), jnp.asarray(emb, jdtype), coords


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_full_width_decoder(sam_store, dtype):
    """f32, and bf16 weights and embedding with f32 prompts (the card's
    types): queries f32, keys bf16, masks and IoU f32, as in the JAX package."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    p, jp, emb, jemb, coords = _full_width_inputs(sam_store, tdt, jdt)
    prompt = sam.sam_encode_points(p, torch.from_numpy(coords))
    jprompt = jsam.sam_encode_points(jp, coords)
    assert prompt.dtype == torch.float32 and jprompt.dtype == jnp.float32

    # the two-way transformer as predict_masks feeds it
    dec, jdec = p["dec"], jp["dec"]
    tokens = torch.cat([torch.cat([dec.weight("iou_token.weight"), dec.weight("mask_tokens.weight")])[None].float(),
                        prompt], dim=1)
    jtokens = jnp.concatenate([jnp.concatenate([jdec.weight("iou_token.weight"),
                                                jdec.weight("mask_tokens.weight")])[None].astype(jnp.float32),
                               jprompt], axis=1)
    pe = dec.weight("dense_positional_embedding").reshape(1, -1, 256).to(tdt)
    jpe = jdec.weight("dense_positional_embedding").reshape(1, -1, 256).astype(jdt)
    q, k = sam.two_way_transformer(dec["transformer"], emb, pe, tokens, 2, 8)
    jq, jk = jsam.two_way_transformer(jdec["transformer"], jemb, jpe, jtokens, 2, 8)
    assert (q.dtype, k.dtype) == (torch.float32, tdt)
    assert (jq.dtype, jk.dtype) == (jnp.float32, jdt)

    pred = sam.sam_predict_mask(p, emb, prompt)
    jpred = jsam.sam_predict_mask(jp, jemb, jprompt)
    assert pred.masks.dtype == pred.iou.dtype == torch.float32
    assert jpred.masks.dtype == jpred.iou.dtype == jnp.float32
    assert pred.masks.shape == (1, 4, 256, 256) and pred.iou.shape == (1, 4)
    if dtype == "f32":
        _match(pred.masks, jpred.masks)
        _match(pred.iou, jpred.iou)
        _match(q, jq)
        _match(k, jk)
    else:
        for got, want in ((q, jq), (k, jk), (pred.masks, jpred.masks), (pred.iou, jpred.iou)):
            assert _rel_rms(got.float().numpy(), np.asarray(want, np.float32)) <= BF16_REL_RMS


# -- goldens (tests/test_golden.py) --


def _golden(name, out):
    golden = np.load(GOLDEN / f"{name}.npz")["output"]
    out = out.float().numpy()
    assert out.shape == golden.shape
    assert _rel_rms(out, golden) < GOLDEN_RMS


def test_golden_sam_encoder():
    p, _ = _stores(fuse_params(randomize(TTinyVit(TEST_CFG, 56))))
    _golden("sam_encoder", sam.tiny_vit(p, torch.from_numpy(to_nhwc(input_tensor(1, 3, 56, 56))), PORT_TP))


def test_golden_sam_decoder():
    store, emb, sparse, dense = _decoder_twin()
    pred = sam.predict_masks(_port(store), *(torch.from_numpy(a) for a in (emb, sparse, dense)))
    _golden("sam_decoder_masks", pred.masks)
    _golden("sam_decoder_iou", pred.iou)


# -- pre/post processing --


def _rgba(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)


@pytest.mark.parametrize("h,w", [(96, 128), (1200, 1600), (1024, 1024)], ids=["upscale", "downscale", "as_is"])
def test_sam_process_input_u8_byte_equal(h, w):
    a = _rgba(h + w, h, w)
    got = sam.sam_process_input_u8(Image(a, ImageFormat.rgba_u8))
    want = jsam.sam_process_input_u8(JImage(a, JImageFormat.rgba_u8))
    assert got.dtype == np.uint8 and got.shape == (1024, 1024, 3)
    np.testing.assert_array_equal(got, want)


def test_sam_process_input_f32():
    a = _rgba(1, 96, 128)
    got = sam.sam_process_input(Image(a, ImageFormat.rgba_u8))
    np.testing.assert_array_equal(got, jsam.sam_process_input(JImage(a, JImageFormat.rgba_u8)))


@pytest.mark.parametrize("extent", [(128, 96), (1600, 1200), (1024, 1024)])
def test_sam_process_point_and_box(extent):
    np.testing.assert_array_equal(sam.sam_process_point((40, 30), extent), jsam.sam_process_point((40, 30), extent))
    np.testing.assert_array_equal(sam.sam_process_box((10, 12), (100, 80), extent),
                                  jsam.sam_process_box((10, 12), (100, 80), extent))


@pytest.mark.parametrize("extent", [(128, 96), (640, 480), (512, 512)])
def test_sam_process_mask_identical(extent):
    masks = _x(12, 4, 256, 256)
    got = sam.sam_process_mask(masks, 2, extent)
    want = jsam.sam_process_mask(masks, 2, extent)
    assert got.format == ImageFormat.alpha_u8 and got.extent == extent
    np.testing.assert_array_equal(got.data, np.asarray(want.data))


def test_random_mobile_sam_params_equal_jax(sam_store):
    want = jax_random_mobile_sam_params(0)
    assert sam_store.keys() == want.keys()
    for name in want:
        assert sam_store[name].dtype == want[name].dtype
        np.testing.assert_array_equal(sam_store[name], want[name], err_msg=name)


def test_params_from_numpy_is_contiguous(sam_store):
    """The indexed attention biases come out of numpy's fancy indexing in a
    non-C order; the port's tensors are contiguous all the same, as the
    window kernel requires of its bias."""
    assert not sam_store["enc.layers.1.blocks.0.attn.attention_biases_indexed"].flags["C_CONTIGUOUS"]
    params = params_from_numpy(sam_store, "cpu", torch.bfloat16)
    assert all(t.is_contiguous() for t in params.values())


# -- the loader --


@pytest.fixture(scope="module")
def sam_checkpoint(tmp_path_factory):
    from test_roundtrip import build_sam_checkpoint

    path = tmp_path_factory.mktemp("torch_sam_ckpt") / "mobile_sam.pth"
    build_sam_checkpoint(path)
    return path


@pytest.mark.parametrize(
    "layout,float_type", [(None, None), ("cwhn", None), (None, "q8_0")], ids=["whcn", "cwhn", "q8_0"]
)
def test_load_converted_gguf(sam_checkpoint, tmp_path, layout, float_type):
    """The production-size twin checkpoint through the JAX package's
    converter: the port's loader (load_weights + fixup_weights) yields the
    JAX loader's arrays exactly, local_conv (stored cwhn even in whcn files)
    included."""
    from vision_tpu.convert.convert import convert_model
    from vision_tpu.core.gguf import model_load as jax_model_load
    from vision_tpu.core.weights import load_weights as jax_load_weights
    from vision_tpu_torch.core.gguf import model_load
    from vision_tpu_torch.core.weights import load_weights

    path = convert_model("sam", sam_checkpoint, tmp_path / "sam.gguf", float_type=float_type, layout=layout)
    jf = jax_model_load(path)
    want = jsam.fixup_weights(jf, jax_load_weights(jf, as_numpy=True))
    pf = model_load(path)
    got = sam.fixup_weights(pf, load_weights(pf, as_numpy=True))
    assert got.keys() == want.keys()
    assert any("local_conv" in name for name in want)
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)


# -- routes --


def _count(monkeypatch, module, name):
    calls = []
    plain = getattr(module, name)

    def counted(*args, **kw):
        calls.append(tuple(args[0].shape))
        return plain(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_window_attention_route_on_cpu(monkeypatch):
    """Every TinyViT window attention takes window_attention's plain version
    on CPU tensors (the kernel on CUDA ones), whatever the flash flag."""
    calls = _count(monkeypatch, wa, "window_attention_plain")
    p, _ = _stores(fuse_params(randomize(TTinyVit(TEST_CFG, 56))))
    x = torch.from_numpy(to_nhwc(input_tensor(1, 3, 56, 56)))
    sam.tiny_vit(p, x, PORT_TP, flash=True)
    # one block in each of the two windowed stages: 7x7 tokens in 4x4 windows
    assert calls == [(4, 16, 16), (4, 16, 320)]


def test_decoder_never_takes_the_flash_route(monkeypatch, sam_store):
    """The image-to-token attention has 4096 queries (>= CUDA_MIN_T), but the
    decoder passes no flash flag, as in the JAX package: even a model built
    with the flag set runs the naive route there."""
    flash_calls = _count(monkeypatch, fa, "flash_attention_plain")
    window_calls = _count(monkeypatch, wa, "window_attention_plain")
    dev = Device(torch.device("cpu"), BackendType.cpu, BuildFlag.flash_attention)
    model = sam.SamModel(params_from_numpy(sam_store, "cpu", torch.float32), sam.SamParams(), dev)
    assert model.flash
    emb = torch.from_numpy(_x(13, 1, 64, 64, 256))
    pred = model.decode(emb, sam.sam_process_point((3, 4), (64, 64))[None], "point")
    assert pred.masks.shape == (1, 4, 256, 256)
    assert flash_calls == [] and window_calls == []
