"""The fused deformable conv (vision_tpu_torch/ops/cuda/deform_conv.py) on the
CPU, where it runs its plain PyTorch version, against the JAX package's
``deform_conv_2d`` and ``deform_conv_2d_shift``, and with its epilogue
against the JAX composition deform -> + bias -> batch_norm_2d -> relu that
BiRefNet's ASPP branches run; its channel views; and the wrapper's rules.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.core.params import Params as JParams
from vision_tpu.ops import deform as jdeform
from vision_tpu.ops import nn as jnn
from vision_tpu_torch.ops import deform
from vision_tpu_torch.ops.cuda import deform_conv as dc
from torch_threads import torch_threads  # noqa: F401

# f32 sums of up to 49 * 5 products of values ~1, taken in another order
F32_ATOL = 1e-5


def _inputs(seed, b, h, w, cin, cout, k, stride, pad, off_scale=3.0, with_mask=True):
    rng = np.random.default_rng(seed)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, k, k)) * 0.2).astype(np.float32)
    off = rng.uniform(-off_scale, off_scale, (b, ho, wo, 2 * k * k)).astype(np.float32)
    mask = (rng.random((b, ho, wo, k * k)) * 2.0).astype(np.float32) if with_mask else None
    return x, wt, off, mask


def _epilogue(seed, cout):
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    scale = (rng.random(cout) + 0.5).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.5).astype(np.float32)
    return bias, scale, shift


def _t(a):
    return None if a is None else torch.from_numpy(a)


CONVS = [(1, 1, 0), (3, 1, 1), (7, 1, 3), (3, 2, 1), (7, 2, 2)]


@pytest.mark.parametrize("k,stride,pad", CONVS)
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("bound", [None, 2])
def test_plain_matches_jax_f32(k, stride, pad, with_mask, bound):
    """No epilogue: the exact form against deform_conv_2d, the bounded one
    (offsets to +-4 against the bound 2) against deform_conv_2d_shift."""
    x, wt, off, mask = _inputs(k + 10 * stride + pad, 2, 9, 11, 5, 7, k, stride, pad,
                               off_scale=3.0 if bound is None else 4.0, with_mask=with_mask)
    if bound is None:
        expected = jdeform.deform_conv_2d(x, wt, off, mask, stride, pad)
    else:
        expected = jdeform.deform_conv_2d_shift(x, wt, off, mask, stride, pad, bound=bound)
    out = dc.deform_conv_plain(_t(x), _t(wt), _t(off), _t(mask), k, k, stride, pad, bound)
    assert out.dtype == torch.float32 and out.shape == expected.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=F32_ATOL, rtol=0)


def _jax_branch(x, wt, off, mask, pad, bias, scale, shift, dtype=jnp.float32):
    """What the JAX package's ASPP branch computes: deform_conv_2d, + bias,
    batch_norm_2d, relu, each rounding to ``dtype``."""
    c = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    y = jdeform.deform_conv_2d(c(x), c(wt), c(off), c(mask), 1, pad) + c(bias)
    y = jnn.batch_norm_2d(JParams({"weight": c(scale), "bias": c(shift)}), y)
    return np.asarray(jnn.relu(y).astype(jnp.float32))


@pytest.mark.parametrize("k,pad", [(1, 0), (3, 1), (7, 3)])
def test_epilogue_matches_jax_composition_f32(k, pad):
    x, wt, off, mask = _inputs(k, 2, 10, 9, 6, 8, k, 1, pad)
    bias, scale, shift = _epilogue(k, 8)
    expected = _jax_branch(x, wt, off, mask, pad, bias, scale, shift)
    out = dc.deform_conv_plain(_t(x), _t(wt), _t(off), _t(mask), k, k, 1, pad, bias=_t(bias), scale=_t(scale),
                               shift=_t(shift), relu=True)
    assert (out.numpy() >= 0).all() and (out.numpy() == 0).any()
    np.testing.assert_allclose(out.numpy(), expected, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("k,pad", [(3, 1), (7, 3)])
def test_epilogue_bf16_is_no_less_precise_than_jax(k, pad):
    """bf16 inputs: the fused form rounds once, the JAX composition after
    the conv, the bias add, the BatchNorm's product and sum and the ReLU.
    Against the f32 result on the same bf16 values, the port's RMS error is
    no larger."""
    x, wt, off, mask = _inputs(20 + k, 1, 16, 16, 32, 28, k, 1, pad)
    bias, scale, shift = _epilogue(21 + k, 28)
    rb = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x, wt, off, mask, bias, scale, shift = (rb(a) for a in (x, wt, off, mask, bias, scale, shift))
    exact = _jax_branch(x, wt, off, mask, pad, bias, scale, shift)
    jax_bf16 = _jax_branch(x, wt, off, mask, pad, bias, scale, shift, dtype=jnp.bfloat16)
    tb = torch.bfloat16
    got = deform.deform_conv_2d_fused(*(_t(a).to(tb) for a in (x, wt, off, mask)), 1, pad,
                                      bias=_t(bias).to(tb), scale=_t(scale).to(tb), shift=_t(shift).to(tb),
                                      relu=True)
    assert got.dtype == tb
    rms = lambda a: float(np.sqrt(np.mean((a - exact) ** 2)))  # noqa: E731
    assert rms(got.float().numpy()) <= rms(jax_bf16), (rms(got.float().numpy()), rms(jax_bf16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_views_leave_the_other_channels_unchanged(dtype):
    """Written into channels 7..14 of a 21-channel buffer: exactly the
    contiguous result there, every other channel as it was."""
    x, wt, off, mask = _inputs(5, 2, 8, 9, 6, 7, 3, 1, 1)
    bias, scale, shift = (_t(a).to(dtype) for a in _epilogue(5, 7))
    args = [_t(a).to(dtype) for a in (x, wt, off, mask)]
    kw = {"bias": bias, "scale": scale, "shift": shift, "relu": True}
    want = dc.deform_conv(*args, 3, 3, 1, 1, **kw)
    buf = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 8, 9, 21)).astype(np.float32)).to(dtype)
    before = buf.clone()
    got = dc.deform_conv(*args, 3, 3, 1, 1, **kw, out=buf[..., 7:14])
    assert got.data_ptr() == buf[..., 7:14].data_ptr()
    assert torch.equal(buf[..., 7:14], want)
    assert torch.equal(buf[..., :7], before[..., :7]) and torch.equal(buf[..., 14:], before[..., 14:])


def test_ops_forms_are_the_kernel_without_an_epilogue():
    x, wt, off, mask = (_t(a) for a in _inputs(8, 1, 7, 7, 4, 3, 3, 1, 1))
    plain = dc.deform_conv_plain(x, wt, off, mask, 3, 3, 1, 1)
    assert torch.equal(deform.deform_conv_2d(x, wt, off, mask, 1, 1), plain)
    assert torch.equal(deform.deform_conv_2d_shift(x, wt, off, mask, 1, 1, bound=2),
                       dc.deform_conv_plain(x, wt, off, mask, 3, 3, 1, 1, 2))


# -- the wrapper --


def test_cpu_call_takes_the_plain_version_and_counts_no_launch():
    x, wt, off, mask = (_t(a) for a in _inputs(1, 2, 6, 7, 8, 5, 3, 1, 1))
    before = dc.launches
    out = dc.deform_conv(x, wt, off, mask, 3, 3, 1, 1, relu=True)
    assert dc.launches == before
    assert torch.equal(out, dc.deform_conv_plain(x, wt, off, mask, 3, 3, 1, 1, relu=True))


@pytest.mark.parametrize("meta", ["x", "weight", "offset", "mask", "bias", "out", "layout"])
def test_non_cpu_tensors_never_fall_back(meta):
    """Any tensor off the CPU sends the call to the kernel, which raises
    here for want of a CUDA device."""
    args = {"x": torch.zeros(1, 8, 8, 16), "weight": torch.zeros(4, 16, 3, 3), "offset": torch.zeros(1, 8, 8, 18),
            "mask": torch.zeros(1, 8, 8, 9), "bias": torch.zeros(4), "out": torch.zeros(1, 8, 8, 4),
            "layout": torch.zeros(9, 16, 32)}
    args[meta] = torch.empty(args[meta].shape, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        dc.deform_conv(args["x"], args["weight"], args["offset"], args["mask"], 3, 3, 1, 1, bias=args["bias"],
                       out=args["out"], layout=args["layout"])


def _misaligned(shape):
    flat = torch.zeros(int(np.prod(shape)) + 1)
    return flat[1:].view(shape)  # 4 bytes past a 16-byte boundary


X, W, OFF, MASK = (1, 6, 6, 8), (4, 8, 3, 3), (1, 6, 6, 18), (1, 6, 6, 9)
OUT = (1, 6, 6, 4)


@pytest.mark.parametrize(
    "x,w,offset,mask,kw,match",
    [
        (torch.zeros(X, dtype=torch.float16), torch.zeros(W), torch.zeros(OFF), None, {}, "x dtype"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF, dtype=torch.float16), None, {}, "offset and mask"),
        (torch.zeros(6, 6, 8), torch.zeros(W), torch.zeros(OFF), None, {}, r"\(B, H, W, Cin\)"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(1, 6, 6, 8), None, {}, r"2 \* 9"),
        (torch.zeros(X), torch.zeros(4, 5, 3, 3), torch.zeros(OFF), None, {}, "weight must be"),
        (torch.zeros(X), torch.zeros(W, dtype=torch.int32), torch.zeros(OFF), None, {}, "weight must be"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), torch.zeros(1, 6, 6, 4), {}, r"mask must be"),
        (torch.zeros(1, 6, 6, 0), torch.zeros(4, 0, 3, 3), torch.zeros(OFF), None, {}, "empty"),
        (torch.empty(1, 2, 2, 8, device="meta"), torch.empty(4, 8, 1, 1, device="meta"),
         torch.empty(1, 2**16, 2**16, 2, device="meta"), None, {"k": 1}, "32-bit"),
        (torch.zeros(1, 6, 6, 300, dtype=torch.bfloat16), torch.zeros(4, 300, 3, 3), torch.zeros(OFF), None, {},
         "staged tiles"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None, {"bias": torch.zeros(5)}, r"bias must be"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None, {"scale": torch.zeros(4, dtype=torch.int64)},
         r"scale must be"),
        (torch.zeros(1, 8, 6, 6).permute(0, 2, 3, 1), torch.zeros(W), torch.zeros(OFF), None, {}, "contiguous"),
        (_misaligned(X), torch.zeros(W), torch.zeros(OFF), None, {}, "16-byte"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None, {"out": torch.zeros(1, 6, 6, 5)}, "out must be"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None, {"out": torch.zeros(1, 6, 6, 8)[..., ::2]},
         "channel view"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None, {"out": torch.zeros(1, 6, 6, 12)[..., 4:8]},
         "CUDA device"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), torch.zeros(MASK), {}, "CUDA device"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None, {"layout": torch.zeros(9, 8, 16)}, "layout must be"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None,
         {"layout": torch.zeros(9, 8, 32, dtype=torch.bfloat16)}, "layout must be"),
        (torch.zeros(X), torch.zeros(W), torch.zeros(OFF), None, {"layout": torch.zeros(9, 8, 32)}, "CUDA device"),
    ],
)
def test_checks_reject_what_the_kernel_does_not_take(x, w, offset, mask, kw, match):
    k = kw.pop("k", 3)
    with pytest.raises(ValueError, match=match):
        dc._check(x, w, offset, mask, k, k, 1, 1, **kw)


def test_checks_reject_an_out_over_an_input():
    store = torch.zeros(6 * 6 * 12)
    x, out = store[: 6 * 6 * 8].view(X), store[6 * 6 * 8 :].view(OUT)
    with pytest.raises(ValueError, match="shares a buffer"):
        dc._check(x, torch.zeros(W), torch.zeros(OFF), None, 3, 3, 1, 1, out=out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_layout_is_the_kernels(dtype):
    """bf16: (k^2, Cout up to the 32 or 64 tile, Cin up to 64); f32: (k^2,
    Cin, Cout up to 32); zero padded. Nothing is kept: an in-place change
    to the weight shows in the next layout."""
    wt = torch.from_numpy(_inputs(3, 1, 4, 4, 20, 40, 3, 1, 1)[1])
    wc = dc.weight_layout(wt, dtype)
    if dtype == torch.bfloat16:
        assert wc.shape == (9, 64, 64)
        assert torch.equal(wc[:, :40, :20], wt.permute(2, 3, 0, 1).reshape(9, 40, 20).to(dtype))
        assert not wc[:, 40:].any() and not wc[:, :, 20:].any()
    else:
        assert wc.shape == (9, 20, 64)
        assert torch.equal(wc[:, :, :40], wt.permute(2, 3, 1, 0).reshape(9, 20, 40))
        assert not wc[:, :, 40:].any()
    wt.mul_(2.0)
    assert torch.equal(dc.weight_layout(wt, dtype), 2 * wc)
