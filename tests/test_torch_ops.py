"""The port's ops (vision_tpu_torch/ops) against their JAX counterparts on
the same numpy inputs and weights, in f32 on the CPU."""

import numpy as np
import pytest
import torch

from vision_tpu.core.params import Params as JParams
from vision_tpu.ops import nn as jnn
from vision_tpu.ops.preprocess import normalize_u8 as j_normalize_u8
from vision_tpu.ops.resize import resize_nhwc as j_resize_nhwc
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.ops import nn
from vision_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, normalize_u8
from vision_tpu_torch.ops.resize import resize_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL, RTOL = 1e-5, 1e-4


def _both(store):
    """(port Params, JAX Params) over one numpy store."""
    return Params(params_from_numpy(store, "cpu", torch.float32)), JParams(store)


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _match(port_out, jax_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=atol, rtol=rtol)


def test_linear():
    rng = np.random.default_rng(0)
    store = {"weight": _randn(rng, 24, 16, scale=0.25), "bias": _randn(rng, 24)}
    x = _randn(rng, 2, 5, 16)
    p, jp = _both(store)
    _match(nn.linear(p, torch.from_numpy(x)), jnn.linear(jp, x))


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm(eps):
    rng = np.random.default_rng(1)
    store = {"weight": _randn(rng, 32), "bias": _randn(rng, 32)}
    x = _randn(rng, 3, 7, 32, scale=3.0) + 1.5
    p, jp = _both(store)
    _match(nn.layer_norm(p, torch.from_numpy(x), eps), jnn.layer_norm(jp, x, eps))


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (3, 2, 0)])
def test_conv_2d(k, stride, pad):
    rng = np.random.default_rng(2)
    store = {"weight": _randn(rng, 6, 4, k, k, scale=0.3), "bias": _randn(rng, 6)}
    x = _randn(rng, 2, 9, 11, 4)
    p, jp = _both(store)
    _match(nn.conv_2d(p, torch.from_numpy(x), stride, pad), jnn.conv_2d(jp, x, stride, pad))


@pytest.mark.parametrize("stride", [4, 2])
def test_conv_transpose_2d(stride):
    rng = np.random.default_rng(3)
    store = {"weight": _randn(rng, 5, 7, stride, stride, scale=0.3), "bias": _randn(rng, 7)}
    x = _randn(rng, 2, 4, 6, 5)
    p, jp = _both(store)
    _match(nn.conv_transpose_2d(p, torch.from_numpy(x), stride), jnn.conv_transpose_2d(jp, x, stride))


def test_patch_embed():
    rng = np.random.default_rng(4)
    store = {"projection.weight": _randn(rng, 16, 3, 14, 14, scale=0.05), "projection.bias": _randn(rng, 16)}
    x = _randn(rng, 2, 28, 42, 3)
    p, jp = _both(store)
    _match(nn.patch_embed(p, torch.from_numpy(x), 14), jnn.patch_embed(jp, x, 14))


def test_gelu_tanh():
    x = _randn(np.random.default_rng(5), 4, 33, scale=3.0)
    _match(nn.gelu(torch.from_numpy(x)), jnn.gelu(x))


def test_normalize_u8():
    x = np.random.default_rng(6).integers(0, 256, (2, 5, 7, 3), np.uint8)
    out = normalize_u8(torch.from_numpy(x), IMAGENET_MEAN, IMAGENET_STD, torch.float32)
    import jax.numpy as jnp

    _match(out, j_normalize_u8(x, IMAGENET_MEAN, IMAGENET_STD, jnp.float32))


@pytest.mark.parametrize(
    "size,method,align_corners",
    [
        ((23, 17), "bilinear", True),
        ((5, 4), "bilinear", True),
        ((23, 17), "bilinear", False),
        ((20, 26), "bicubic", False),
        ((6, 5), "bicubic", False),
    ],
)
def test_resize_nhwc(size, method, align_corners):
    x = _randn(np.random.default_rng(7), 2, 11, 9, 3)
    out = resize_nhwc(torch.from_numpy(x), size, method, align_corners)
    assert out.shape == (2, *size, 3)
    _match(out, j_resize_nhwc(x, size, method, align_corners), atol=1e-5, rtol=0)


# -- mixed types: f32 prompts through bf16 weights (the SAM decoder on the
# card) follow the JAX package's promotion --

BF16_ATOL, BF16_RTOL = 2e-2, 2e-2  # one bf16 rounding of outputs of magnitude ~1


def _typed(a, name):
    import jax.numpy as jnp

    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _match_typed(port_out, jax_out):
    import jax.numpy as jnp

    want = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16}[jax_out.dtype]
    assert port_out.dtype == want
    np.testing.assert_allclose(
        port_out.float().numpy(), np.asarray(jax_out.astype(jnp.float32)), atol=BF16_ATOL, rtol=BF16_RTOL
    )


@pytest.mark.parametrize("x_t,w_t", [("f32", "bf16"), ("bf16", "bf16"), ("bf16", "f32"), ("f32", "f32")])
def test_linear_mixed_types(x_t, w_t):
    """f32 x with bf16 weights gives f32 (the product in the promoted type,
    cast to x's type, the bias added with promotion), as in the JAX package."""
    rng = np.random.default_rng(8)
    w, b, x = _randn(rng, 24, 16, scale=0.25), _randn(rng, 24), _randn(rng, 2, 5, 16)
    tw, jw = _typed(w, w_t)
    tb, jb = _typed(b, w_t)
    tx, jx = _typed(x, x_t)
    _match_typed(nn.linear(Params({"weight": tw, "bias": tb}), tx), jnn.linear(JParams({"weight": jw, "bias": jb}), jx))


@pytest.mark.parametrize("q_t,kv_t", [("bf16", "f32"), ("f32", "bf16"), ("bf16", "bf16")])
@pytest.mark.parametrize("route", ["naive", "fused_logits"])
def test_attention_core_mixed_types(q_t, kv_t, route):
    """The SAM decoder's image-to-token attention takes bf16 q and f32 k/v:
    logits in f32 (naive) or the promoted type (fused_logits), p in q's type,
    PV in the promoted type, the output in q's type."""
    rng = np.random.default_rng(9)
    q, k, v = _randn(rng, 1, 2, 40, 16), _randn(rng, 1, 2, 7, 16), _randn(rng, 1, 2, 7, 16)
    mask = _randn(rng, 40, 7) if route == "fused_logits" else None
    flash = route == "fused_logits"
    assert nn.attention_route(40, mask is not None, flash) == route
    tq, jq = _typed(q, q_t)
    tk, jk = _typed(k, kv_t)
    tv, jv = _typed(v, kv_t)
    tm = None if mask is None else torch.from_numpy(mask)
    out = nn.attention_core(tq, tk, tv, tm, None, flash)
    _match_typed(out, jnn.attention_core(jq, jk, jv, mask, None, flash))


def test_attention_core_mixed_types_every_route():
    """The routes JAX cannot take mixed (its xla_fused form raises) and the
    "cuda" route on CPU tensors still accept them, output in q's type."""
    rng = np.random.default_rng(10)
    q = torch.from_numpy(_randn(rng, 1, 2, 1030, 16)).to(torch.bfloat16)
    k, v = torch.from_numpy(_randn(rng, 1, 2, 9, 16)), torch.from_numpy(_randn(rng, 1, 2, 9, 16))
    ref = nn.attention_core(q, k, v)  # naive
    for t_q in (1030, 100):  # cuda, xla_fused
        route = nn.attention_route(t_q, False, True, cuda_ok=True)
        out = nn.attention_core(q[:, :, :t_q], k, v, None, None, True)
        assert route in ("cuda", "xla_fused") and out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), ref[:, :, :t_q].float().numpy(), atol=BF16_ATOL, rtol=BF16_RTOL)


# -- the JAX package's remaining small ops (YOLOv9t's silu and avg_pool_2d) --


def test_silu():
    x = _randn(np.random.default_rng(20), 3, 5, 7, scale=4.0)
    _match(nn.silu(torch.from_numpy(x)), jnn.silu(x))


def test_gelu_erf_and_gelu_tanh():
    x = _randn(np.random.default_rng(21), 4, 9, scale=3.0)
    _match(nn.gelu_erf(torch.from_numpy(x)), jnn.gelu_erf(x))
    _match(nn.gelu_tanh(torch.from_numpy(x)), jnn.gelu_tanh(x))


@pytest.mark.parametrize(
    "kernel,stride,pad,include",
    [(2, 1, 0, True), (2, None, 0, True), (3, 1, 1, True), (3, 2, 1, False), (5, 1, 2, False)],
)
def test_avg_pool_2d(kernel, stride, pad, include):
    """The f32 window sum over kernel^2, or over the cells inside the input
    (count_include_pad False), windows where they fit (YOLOv9t's AConv:
    kernel 2, stride 1)."""
    x = _randn(np.random.default_rng(22), 2, 9, 11, 3)
    _match(nn.avg_pool_2d(torch.from_numpy(x), kernel, stride, pad, include),
           jnn.avg_pool_2d(x, kernel, stride, pad, include))


def test_avg_pool_2d_bf16_sums_in_f32():
    import jax.numpy as jnp

    x = _randn(np.random.default_rng(23), 1, 8, 8, 4)
    got = nn.avg_pool_2d(torch.from_numpy(x).to(torch.bfloat16), 2, 1)
    want = np.asarray(jnn.avg_pool_2d(jnp.asarray(x, jnp.bfloat16), 2, 1).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("pad_h,pad_w,value", [((1, 2), (0, 3), 0.0), ((0, 0), (2, 2), -1.5)])
def test_pad_nhwc(pad_h, pad_w, value):
    x = _randn(np.random.default_rng(24), 2, 4, 5, 3)
    _match(nn.pad_nhwc(torch.from_numpy(x), pad_h, pad_w, value), jnn.pad_nhwc(x, pad_h, pad_w, value), atol=0, rtol=0)


@pytest.mark.parametrize("mode,align", [("bilinear", False), ("bicubic", True), ("nearest", False)])
def test_interpolate(mode, align):
    from vision_tpu.ops.resize import interpolate as j_interpolate
    from vision_tpu_torch.ops import interpolate

    x = _randn(np.random.default_rng(25), 1, 6, 7, 2)
    _match(interpolate(torch.from_numpy(x), (11, 5), mode, align), j_interpolate(x, (11, 5), mode, align))
