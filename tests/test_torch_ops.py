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
