"""The port's 3x3 conv (vision_tpu_torch/ops/cuda/conv3x3.py) against the TPU
kernel it replaces, the Pallas ``kernel`` of ``conv_rowblock`` in
scripts/exp_pallas_conv.py, run in interpret mode on the CPU; against
``jax.lax.conv_general_dilated`` where the probe does not reach (batch > 1,
ragged H and W); and the wrapper's routing and checks.

The script's text is executed with a ``__name__`` other than
``"__main__"``, so its TPU benchmark does not run. On the CPU the wrapper
runs its plain PyTorch version, which these tests hold against the Pallas
kernel; the CUDA kernel itself is checked against the same plain version on
the card by chip_smoke.py."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu_torch.core.params import Params
from vision_tpu_torch.ops import nn
from vision_tpu_torch.ops.cuda import conv3x3 as cc
from torch_threads import torch_threads  # noqa: F401

PROBE = Path(__file__).resolve().parents[1] / "scripts" / "exp_pallas_conv.py"
F32_ATOL = 1e-5  # f32 sums over up to 9 * 192 terms, taken in another order


@pytest.fixture(scope="module")
def conv_rowblock():
    ns = {"__file__": str(PROBE), "__name__": "exp_pallas_conv"}
    exec(compile(PROBE.read_text(), str(PROBE), "exec"), ns)
    return ns["conv_rowblock"]


def _inputs(seed, n, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h, w, cin)) * 0.5).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    return x, wt


def _hwio(wt):
    return np.ascontiguousarray(wt.transpose(2, 3, 1, 0))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (7 stored mantissa bits against
    float32's 23)."""
    return np.spacing(np.abs(v).astype(np.float32)) * 2.0**16


@pytest.mark.parametrize("variant", ["slices", "roll"])
@pytest.mark.parametrize(
    "h,w,cin,cout,th",
    [
        (16, 16, 3, 8, 8),  # the stem's Cin
        (16, 16, 8, 3, 16),  # the last conv's Cout
        (32, 24, 64, 32, 16),  # RDB conv1
        (16, 16, 192, 64, 8),  # RDB conv5
    ],
)
def test_plain_matches_pallas_kernel_f32(conv_rowblock, variant, h, w, cin, cout, th):
    x, wt = _inputs(h * 1000 + cin, 1, h, w, cin, cout)
    expected = np.asarray(conv_rowblock(jnp.asarray(x), jnp.asarray(_hwio(wt)), variant, th=th, interpret=True))
    out = cc.conv3x3(torch.from_numpy(x), torch.from_numpy(wt))
    assert out.shape == (1, h, w, cout) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["slices", "roll"])
@pytest.mark.parametrize("h,w,cin,cout", [(16, 16, 3, 8), (16, 16, 64, 32)])
def test_plain_matches_pallas_kernel_bf16(conv_rowblock, variant, h, w, cin, cout):
    """bf16 inputs, f32 sums, one rounding to bf16: the two differ only where
    the f32 sums round to neighbouring bf16 values, one bf16 ulp apart (plus
    the f32 sums' own order error, F32_ATOL, where they cancel to near 0
    and the ulp is smaller than it)."""
    x, wt = _inputs(cout, 1, h, w, cin, cout)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(_hwio(wt), jnp.bfloat16)
    expected = np.asarray(conv_rowblock(xb, wb, variant, th=8, interpret=True).astype(jnp.float32))
    out = cc.conv3x3(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wt).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(expected)))
    assert (np.abs(got - expected) <= ulp + F32_ATOL).all(), float(np.abs(got - expected).max())
    assert (got == expected).mean() > 0.99


@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [
        (3, 7, 13, 5, 6),  # batch, ragged H and W
        (2, 1, 9, 16, 3),  # one row
        (2, 13, 1, 4, 4),  # one column
        (4, 5, 6, 20, 12),
    ],
)
def test_plain_matches_lax_conv(n, h, w, cin, cout):
    x, wt = _inputs(n * h * w, n, h, w, cin, cout)
    expected = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(_hwio(wt)), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST,
    )
    out = cc.conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt))
    np.testing.assert_allclose(out.numpy(), np.asarray(expected), atol=F32_ATOL, rtol=1e-5)


def test_cpu_call_takes_the_plain_version_and_counts_no_launch():
    x, wt = (torch.from_numpy(a) for a in _inputs(1, 2, 9, 11, 6, 5))
    before = cc.launches
    out = cc.conv3x3(x, wt)
    assert cc.launches == before
    assert torch.equal(out, cc.conv3x3_plain(x, wt))


def test_non_cpu_tensors_never_fall_back():
    x = torch.empty(1, 8, 8, 16, device="meta")
    w = torch.empty(8, 16, 3, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cc.conv3x3(x, w)
    with pytest.raises(ValueError, match="CUDA device"):
        cc.conv3x3(torch.zeros(1, 8, 8, 16), w)


def _misaligned(shape):
    flat = torch.zeros(int(np.prod(shape)) + 1)
    return flat[1:].view(shape)  # 4 bytes past a 16-byte boundary


@pytest.mark.parametrize(
    "x,w,match",
    [
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3, dtype=torch.bfloat16), "dtype"),
        (torch.zeros(1, 4, 4, 8, dtype=torch.float16), torch.zeros(2, 8, 3, 3, dtype=torch.float16), "dtype"),
        (torch.zeros(4, 4, 8), torch.zeros(2, 8, 3, 3), r"\(N, H, W, Cin\)"),
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 5, 5), r"\(Cout, Cin, 3, 3\)"),
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 6, 3, 3), r"\(Cout, Cin, 3, 3\)"),
        (torch.zeros(1, 0, 4, 8), torch.zeros(2, 8, 3, 3), "empty"),
        (torch.empty(1, 2**31, 1, 1, device="meta"), torch.empty(1, 1, 3, 3, device="meta"), "32-bit"),
        (torch.zeros(1, 8, 4, 4).transpose(1, 2), torch.zeros(2, 4, 3, 3), "contiguous"),
        (_misaligned((1, 4, 4, 8)), torch.zeros(2, 8, 3, 3), "16-byte"),
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3), "CUDA device"),
    ],
)
def test_checks_reject_what_the_kernel_does_not_take(x, w, match):
    with pytest.raises(ValueError, match=match):
        cc._check(x, w)


def test_conv_3x3_adds_the_bias_in_x_type():
    """ops/nn.py conv_3x3 against the JAX package's conv_2d(p, x, 1, 1), in
    f32 and in bf16. The JAX package rounds the conv's f32 sum to bf16 and
    adds the bias in bf16; the port adds the bias to the f32 sum and rounds
    once, so the two differ by at most half an ulp of the rounded conv and
    one ulp of the result (plus the f32 sums' own order error)."""
    from vision_tpu.core.params import Params as JParams
    from vision_tpu.ops import nn as jnn

    x, wt = _inputs(5, 2, 6, 7, 12, 8)
    b = np.random.default_rng(6).standard_normal(8).astype(np.float32)
    store = {"c.weight": wt, "c.bias": b}
    expected = np.asarray(jnn.conv_2d(JParams(store)["c"], x, 1, 1))
    p = Params({k: torch.from_numpy(v) for k, v in store.items()})
    np.testing.assert_allclose(nn.conv_3x3(p["c"], torch.from_numpy(x)).numpy(), expected, atol=F32_ATOL, rtol=1e-5)

    jb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in store.items()}
    expected_bf16 = np.asarray(jnn.conv_2d(JParams(jb)["c"], jnp.asarray(x, jnp.bfloat16), 1, 1).astype(jnp.float32))
    pb = Params({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in store.items()})
    got = nn.conv_3x3(pb["c"], torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jconv = {k: v for k, v in jb.items() if k != "c.bias"}
    conv_bf16 = np.asarray(jnn.conv_2d(JParams(jconv)["c"], jnp.asarray(x, jnp.bfloat16), 1, 1).astype(jnp.float32))
    diff = np.abs(got.float().numpy() - expected_bf16)
    assert (diff <= 0.5 * _bf16_ulp(conv_bf16) + _bf16_ulp(expected_bf16) + F32_ATOL).all(), float(diff.max())


def test_conv_3x3_rejects_other_kernel_sizes():
    p = Params({"c.weight": torch.zeros(4, 8, 1, 1)})
    with pytest.raises(ValueError, match=r"\(O, I, 3, 3\)"):
        nn.conv_3x3(p["c"], torch.zeros(1, 4, 4, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leaky_relu_matches_jax(dtype):
    from vision_tpu.ops import nn as jnn

    x = np.random.default_rng(8).standard_normal((3, 5, 4)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    expected = np.asarray(jnn.leaky_relu(jnp.asarray(x, jdt), 0.2).astype(jnp.float32))
    got = nn.leaky_relu(torch.from_numpy(x).to(dtype), 0.2)
    assert got.dtype == dtype
    # torch multiplies by the f32 slope, JAX by the slope rounded to bf16
    tol = 0 if dtype == torch.float32 else 2 * _bf16_ulp(np.abs(expected))
    assert (np.abs(got.float().numpy() - expected) <= tol + 1e-7).all()


# -- the fused epilogue and the channel views --


def _jax_rdb_tail(jnn, JParams, x, w, b, slope=None, r1=None, s1=None, r2=None, s2=None, dtype=jnp.float32):
    """The JAX package's plain composition of what the fused epilogue does:
    conv_2d (+ bias), leaky_relu, then x + s * y residuals, each in dtype."""
    p = JParams({"c.weight": jnp.asarray(w, dtype), "c.bias": jnp.asarray(b, dtype)})["c"]
    y = jnn.conv_2d(p, jnp.asarray(x, dtype), 1, 1)
    if slope is not None:
        y = jnn.leaky_relu(y, slope)
    if r1 is not None:
        y = jnp.asarray(r1, dtype) + s1 * y
    if r2 is not None:
        y = jnp.asarray(r2, dtype) + s2 * y
    return np.asarray(y.astype(jnp.float32))


_FORMS = {
    # the Real-ESRGAN path's forms: growth conv, conv5, RDB3's conv5 with the RRDB's residual, trunk + skip
    "leaky": dict(slope=0.2),
    "residual": dict(r1=True, s1=0.2),
    "double residual": dict(r1=True, s1=0.2, r2=True, s2=0.2),
    "skip": dict(r1=True, s1=1.0),
}


def _form_inputs(form, n, h, w, cin, cout, seed):
    x, wt = _inputs(seed, n, h, w, cin, cout)
    rng = np.random.default_rng(seed + 1)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    kw = dict(_FORMS[form])
    for r in ("r1", "r2"):
        if kw.get(r):
            kw[r] = (rng.standard_normal((n, h, w, cout)) * 0.5).astype(np.float32)
    return x, wt, b, kw


@pytest.mark.parametrize("form", list(_FORMS))
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 11, 16, 8), (1, 16, 16, 24, 12)])
def test_fused_epilogue_matches_jax_composition_f32(form, n, h, w, cin, cout):
    from vision_tpu.core.params import Params as JParams
    from vision_tpu.ops import nn as jnn

    x, wt, b, kw = _form_inputs(form, n, h, w, cin, cout, n * h + cin)
    expected = _jax_rdb_tail(jnn, JParams, x, wt, b, **kw)
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = cc.conv3x3(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b), **t)
    np.testing.assert_allclose(got.numpy(), expected, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("form", list(_FORMS))
def test_fused_epilogue_bf16_is_no_less_precise_than_jax(form):
    """bf16 inputs and weights: the fused form rounds once, so it is within
    half a bf16 ulp of the f32 result (plus the sums' order error), and its
    RMS error is no larger than the JAX composition's, which rounds after
    the conv, the bias, the leaky ReLU and each residual sum."""
    from vision_tpu.core.params import Params as JParams
    from vision_tpu.ops import nn as jnn

    x, wt, b, kw = _form_inputs(form, 2, 12, 13, 32, 16, 77)
    rb = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x, wt, b = rb(x), rb(wt), rb(b)
    kw = {k: (rb(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    exact = _jax_rdb_tail(jnn, JParams, x, wt, b, **kw)  # f32 on bf16 values
    jax_bf16 = _jax_rdb_tail(jnn, JParams, x, wt, b, dtype=jnp.bfloat16, **kw)
    t = {k: (torch.from_numpy(v).to(torch.bfloat16) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = cc.conv3x3(*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, wt, b)), **t)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - exact) <= 0.5 * _bf16_ulp(exact) + F32_ATOL).all()
    rms = lambda a: float(np.sqrt(np.mean((a - exact) ** 2)))  # noqa: E731
    assert rms(got) <= rms(jax_bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_views_equal_the_contiguous_computation(dtype):
    """A read of a channel prefix of a wider buffer and a write into a
    channel slice give exactly the contiguous computation's values, and
    leave every other channel as it was."""
    x, wt = _inputs(3, 2, 10, 9, 48, 32)
    b = np.random.default_rng(4).standard_normal(16).astype(np.float32)
    buf = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 10, 9, 96)).astype(np.float32)).to(dtype)
    buf[..., :48] = torch.from_numpy(x).to(dtype)
    w16 = torch.from_numpy(wt[:16]).to(dtype)
    b16 = torch.from_numpy(b).to(dtype)
    want = cc.conv3x3(buf[..., :48].contiguous(), w16, b16, slope=0.2)
    before = buf.clone()
    got = cc.conv3x3(buf[..., :48], w16, b16, slope=0.2, out=buf[..., 48:64])
    assert got.data_ptr() == buf[..., 48:64].data_ptr()
    assert torch.equal(buf[..., 48:64], want)
    assert torch.equal(buf[..., :48], before[..., :48]) and torch.equal(buf[..., 64:], before[..., 64:])
    # a residual read from a view, the result over that very view
    r = buf[..., 64:80]
    want = cc.conv3x3(buf[..., :48].contiguous(), w16, b16, r1=r.contiguous(), s1=0.2)
    cc.conv3x3(buf[..., :48], w16, b16, r1=r, s1=0.2, out=r)
    assert torch.equal(buf[..., 64:80], want)


def _buf(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype)


_B = _buf(1, 4, 4, 32)  # one (1, 4, 4, 32) buffer for the overlap cases


@pytest.mark.parametrize(
    "x,w,kw,match",
    [
        # a view whose channels run past its buffer's pixel
        (torch.zeros(1 * 4 * 4 * 8 + 4).as_strided((1, 4, 4, 6), (128, 32, 8, 1), 4), torch.zeros(2, 6, 3, 3), {},
         "run past"),
        # rows not packed: not a channel view of an NHWC buffer
        (torch.zeros(1, 4, 6, 8)[:, :, :4], torch.zeros(2, 8, 3, 3), {}, "channel view"),
        # a residual of the wrong shape, or type
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3), {"r1": torch.zeros(1, 4, 4, 3), "s1": 0.2}, "residual r1"),
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3), {"r2": torch.zeros(1, 4, 4, 2, dtype=torch.bfloat16)},
         "residual r2"),
        # a scale without its residual
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3), {"s1": 0.2}, "without the residual"),
        # out overlaps x's channels in the same buffer
        (_B[..., :16], torch.zeros(8, 16, 3, 3), {"out": _B[..., 12:20]}, "overlaps"),
        (_B[..., 8:24], torch.zeros(8, 16, 3, 3), {"out": _B[..., :8]}, "CUDA device"),  # disjoint: fine up to the device
        # out of the wrong shape, a bias of the wrong shape
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3), {"out": torch.zeros(1, 4, 4, 3)}, "out must be"),
        (torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3), {"b": torch.zeros(3)}, "bias"),
        # a channel stride the kernel cannot take
        (torch.zeros(1, 4, 4, 16)[..., ::2], torch.zeros(2, 8, 3, 3), {}, "channel view"),
        # more input channels than the bf16 kernel stages
        (torch.zeros(1, 2, 2, 968, dtype=torch.bfloat16), torch.zeros(2, 968, 3, 3, dtype=torch.bfloat16), {},
         "staged weight"),
    ],
)
def test_checks_reject_the_epilogue_faults(x, w, kw, match):
    kw = dict(kw)
    b = kw.pop("b", None)
    with pytest.raises(ValueError, match=match):
        cc._check(x, w, b, **kw)


# -- YOLOv9t's epilogue forms: a fused BatchNorm, SiLU, r1 before the SiLU, r2 after --


def _jax_yolo_conv(jnn, JParams, x, w, scale, shift, r1=None, r2=None, dtype=jnp.float32):
    """The JAX package's composition (vision_tpu/models/yolov9t.py
    conv_block and rep_conv): conv_2d, batch_norm_2d, + the RepConv's 1x1
    branch (r1), silu, + the bottleneck's shortcut (r2), each in dtype."""
    p = JParams({k: jnp.asarray(v, dtype) for k, v in
                 (("conv.weight", w), ("bn.weight", scale), ("bn.bias", shift))})
    y = jnn.batch_norm_2d(p["bn"], jnn.conv_2d(p["conv"], jnp.asarray(x, dtype), 1, 1))
    if r1 is not None:
        y = y + jnp.asarray(r1, dtype)
    y = jnn.silu(y)
    if r2 is not None:
        y = jnp.asarray(r2, dtype) + y
    return np.asarray(y.astype(jnp.float32))


_YOLO_FORMS = {
    # conv_block(p, x, 3); + the RepBottleneck's shortcut; RepConv's 3x3 branch with the 1x1 one as r1
    "bn silu": (),
    "bn silu + shortcut": ("r2",),
    "rep_conv": ("r1",),
}


def _yolo_inputs(form, n, h, w, cin, cout, seed):
    x, wt = _inputs(seed, n, h, w, cin, cout)
    rng = np.random.default_rng(seed + 1)
    scale = (1.0 + rng.standard_normal(cout) * 0.1).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = {r: (rng.standard_normal((n, h, w, cout)) * 0.5).astype(np.float32) for r in _YOLO_FORMS[form]}
    return x, wt, scale, shift, res


@pytest.mark.parametrize("form", list(_YOLO_FORMS))
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 9, 11, 16, 16), (1, 20, 20, 64, 80)])
def test_yolo_epilogue_matches_jax_composition_f32(form, n, h, w, cin, cout):
    """conv3x3 with scale, shift, silu and r1 / r2 against conv_2d ->
    batch_norm_2d (-> + r1) -> silu (-> + r2) in the JAX package, f32: the
    sums' order only (F32_ATOL)."""
    from vision_tpu.core.params import Params as JParams
    from vision_tpu.ops import nn as jnn

    x, wt, scale, shift, res = _yolo_inputs(form, n, h, w, cin, cout, n * h + cin)
    expected = _jax_yolo_conv(jnn, JParams, x, wt, scale, shift, **res)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = cc.conv3x3(t(x), t(wt), scale=t(scale), shift=t(shift), silu=True, **{k: t(v) for k, v in res.items()})
    np.testing.assert_allclose(got.numpy(), expected, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("form", list(_YOLO_FORMS))
def test_yolo_epilogue_bf16_is_no_less_precise_than_jax(form):
    """bf16 inputs, weights, BN and residuals: the fused form rounds once, so
    it is within half a bf16 ulp of the f32 result on the same values (plus
    the sums' order error), and its RMS error is no larger than the JAX
    composition's, which rounds after the conv, the BN's product and sum,
    the branch sum, the SiLU and the shortcut."""
    from vision_tpu.core.params import Params as JParams
    from vision_tpu.ops import nn as jnn

    x, wt, scale, shift, res = _yolo_inputs(form, 2, 12, 13, 32, 16, 91)
    rb = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    x, wt, scale, shift = (rb(a) for a in (x, wt, scale, shift))
    res = {k: rb(v) for k, v in res.items()}
    exact = _jax_yolo_conv(jnn, JParams, x, wt, scale, shift, **res)  # f32 on bf16 values
    jax_bf16 = _jax_yolo_conv(jnn, JParams, x, wt, scale, shift, dtype=jnp.bfloat16, **res)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = cc.conv3x3(tb(x), tb(wt), scale=tb(scale), shift=tb(shift), silu=True, **{k: tb(v) for k, v in res.items()})
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - exact) <= 0.5 * _bf16_ulp(exact) + F32_ATOL).all()
    rms = lambda a: float(np.sqrt(np.mean((a - exact) ** 2)))  # noqa: E731
    assert rms(got) <= rms(jax_bf16), (rms(got), rms(jax_bf16))


def test_esrgan_forms_keep_their_results_beside_the_new_epilogue():
    """Real-ESRGAN never passes a slope with r1, so placing the activation
    after r1 leaves its forms as they were: the leaky form, the residual
    forms and an explicit identity scale and zero shift give the earlier
    epilogue's values ``r2 + s2 * (r1 + s1 * act(conv + b))`` exactly."""
    x, wt = (torch.from_numpy(a) for a in _inputs(12, 2, 9, 10, 24, 16))
    rng = np.random.default_rng(13)
    b, r1, r2 = (torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32)) for s in
                 ((16,), (2, 9, 10, 16), (2, 9, 10, 16)))
    acc = cc.conv3x3_plain(x, wt) + b
    leaky = torch.where(acc >= 0, acc, acc * 0.2)
    assert torch.equal(cc.conv3x3(x, wt, b, slope=0.2), leaky)
    assert torch.equal(cc.conv3x3(x, wt, b, r1=r1, s1=0.2, r2=r2, s2=0.2), r2 + 0.2 * (r1 + 0.2 * acc))
    ones, zeros = torch.ones(16), torch.zeros(16)
    assert torch.equal(cc.conv3x3(x, wt, b, scale=ones, shift=zeros, slope=0.2), leaky)


def test_conv_3x3_fused_takes_a_fused_batchnorm():
    """ops/nn.py conv_3x3_fused with ``bn`` is the kernel's scale and shift;
    a BatchNorm with running statistics (not fused at conversion) raises,
    as batch_norm_2d does."""
    from vision_tpu_torch.core.errors import VispError

    x, wt = (torch.from_numpy(a) for a in _inputs(14, 1, 6, 7, 8, 8))
    rng = np.random.default_rng(15)
    scale, shift = (torch.from_numpy(rng.standard_normal(8).astype(np.float32)) for _ in range(2))
    p = Params({"c.conv.weight": wt, "c.bn.weight": scale, "c.bn.bias": shift})
    want = cc.conv3x3(x, wt, scale=scale, shift=shift, silu=True)
    assert torch.equal(nn.conv_3x3_fused(p["c"]["conv"], x, bn=p["c"]["bn"], silu=True), want)
    stats = Params({**p.store, "c.bn.running_mean": torch.zeros(8)})
    with pytest.raises(VispError, match="not fused"):
        nn.conv_3x3_fused(stats["c"]["conv"], x, bn=stats["c"]["bn"])


@pytest.mark.parametrize(
    "kw,match",
    [
        ({"silu": True, "slope": 0.2}, "one activation"),
        ({"silu": 1}, "silu must be a bool"),
        ({"scale": torch.zeros(3)}, "scale must be"),
        ({"shift": torch.zeros(2, dtype=torch.bfloat16)}, "shift must be"),
        ({"scale": torch.zeros(2), "shift": torch.zeros(2), "silu": True}, "CUDA device"),  # fine up to the device
    ],
)
def test_checks_reject_the_yolo_epilogue_faults(kw, match):
    with pytest.raises(ValueError, match=match):
        cc._check(torch.zeros(1, 4, 4, 8), torch.zeros(2, 8, 3, 3), **kw)
