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
    f32 and in bf16 (conv with f32 sums, rounded, then a bf16 bias add)."""
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
    # two bf16 roundings (conv, bias add): at most one ulp each
    diff = np.abs(got.float().numpy() - expected_bf16)
    assert (diff <= 2 * _bf16_ulp(np.abs(expected_bf16))).all(), float(diff.max())


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
