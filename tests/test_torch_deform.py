"""The port's deformable conv (vision_tpu_torch/ops/deform.py) and its sampler
(vision_tpu_torch/ops/cuda/deform_sample.py) against the JAX package's
``deform_conv_2d`` and ``deform_conv_2d_shift``, and against the TPU kernels
the sampler replaces: the seven Pallas bodies of the bounded-form probes
scripts/exp_deform_pallas{,3,4,5}.py that compute the real tent-weighted
window MAC, run in interpret mode on the CPU.

The probe scripts run their TPU benchmark at import and have no
``__main__`` guard, so they are neither imported nor executed whole: each is
parsed, and only its imports (but the JAX package's), its upper-case
constants and its ``def``s run; the test then sets the small shape the
bodies read at call time. On the CPU the wrapper runs its plain PyTorch
version, which these tests hold against both; the CUDA kernel itself is
checked against the same plain version on the card by chip_smoke.py."""

import ast
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vision_tpu.ops import deform as jdeform
from vision_tpu_torch.ops import deform
from vision_tpu_torch.ops.cuda import deform_sample as ds
from torch_threads import torch_threads  # noqa: F401

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
# f32 sums of up to 49 * 6 products of values ~1, taken in another order
F32_ATOL, F32_RTOL = 1e-5, 1e-5


def _inputs(seed, b, h, w, cin, cout, k, stride, pad, off_scale=3.0, with_mask=True):
    rng = np.random.default_rng(seed)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, k, k)) * 0.2).astype(np.float32)
    off = rng.uniform(-off_scale, off_scale, (b, ho, wo, 2 * k * k)).astype(np.float32)
    mask = (rng.random((b, ho, wo, k * k)) * 2.0).astype(np.float32) if with_mask else None
    return x, wt, off, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


CONVS = [(1, 1, 0), (3, 1, 1), (7, 1, 3), (3, 2, 1), (3, 1, 0)]


@pytest.mark.parametrize("k,stride,pad", CONVS)
def test_deform_conv_2d_matches_jax(k, stride, pad):
    x, wt, off, mask = _inputs(k * 10 + stride, 2, 10, 12, 5, 7, k, stride, pad)
    expected = np.asarray(jdeform.deform_conv_2d(x, wt, off, mask, stride, pad))
    out = deform.deform_conv_2d(_t(x), _t(wt), _t(off), _t(mask), stride, pad)
    assert out.shape == expected.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), expected, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("k,stride,pad", CONVS)
@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_sampler_columns_match_jax(k, stride, pad, with_mask):
    """deform_sample_plain's columns against the JAX deform_conv_2d with a
    selector weight that copies tap t, channel c to output channel
    t * Cin + c: each output is one sample times 1, so the two agree to
    the last bit of their f32 blends (up to one FMA rounding)."""
    cin, kk = 3, k * k
    x, _, off, mask = _inputs(k + 100 * stride, 2, 9, 11, cin, 1, k, stride, pad, with_mask=with_mask)
    sel = np.zeros((kk * cin, cin, k, k), np.float32)
    for t in range(kk):
        for c in range(cin):
            sel[t * cin + c, c, t // k, t % k] = 1.0
    expected = np.asarray(jdeform.deform_conv_2d(x, sel, off, mask, stride, pad))
    cols = ds.deform_sample_plain(_t(x), _t(off), _t(mask), k, k, stride, pad)
    assert cols.shape == (*off.shape[:3], kk, cin) and cols.dtype == torch.float32
    np.testing.assert_allclose(cols.reshape(*off.shape[:3], kk * cin).numpy(), expected, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k,stride,pad", CONVS)
def test_shift_form_matches_jax_past_the_bound(k, stride, pad):
    """Offsets up to +-5 against the bound 2: both clamp, then sample."""
    x, wt, off, mask = _inputs(k + 7, 1, 11, 9, 6, 4, k, stride, pad, off_scale=5.0)
    expected = np.asarray(jdeform.deform_conv_2d_shift(x, wt, off, mask, stride, pad, bound=2))
    out = deform.deform_conv_2d_shift(_t(x), _t(wt), _t(off), _t(mask), stride, pad, bound=2)
    np.testing.assert_allclose(out.numpy(), expected, atol=F32_ATOL, rtol=F32_RTOL)
    clamped = np.asarray(jdeform.deform_conv_2d(x, wt, np.clip(off, -2, 2), mask, stride, pad))
    np.testing.assert_allclose(out.numpy(), clamped, atol=F32_ATOL, rtol=F32_RTOL)


def test_shift_form_bf16_is_within_the_jax_bf16_error():
    """bf16 at BiRefNet's k = 7: the JAX shift form rounds each tent-weighted
    window to bf16 before summing 25 of them; the port blends in f32 and
    rounds each column once, then runs one bf16 product with f32 sums. Held
    against the f32 result, the port's error is no larger than the JAX
    form's (plus a quarter, for the product's own bf16 rounding), and each
    is below 1% relative RMS (bf16 keeps 8 significant bits, 0.4%)."""
    x, wt, off, mask = _inputs(3, 1, 16, 16, 16, 8, 7, 1, 3, off_scale=2.0)
    exact = np.asarray(jdeform.deform_conv_2d_shift(x, wt, off, mask, 1, 3, bound=2))
    bf = jnp.bfloat16
    jax_bf16 = np.asarray(jdeform.deform_conv_2d_shift(
        jnp.asarray(x, bf), jnp.asarray(wt, bf), jnp.asarray(off, bf), jnp.asarray(mask, bf), 1, 3, bound=2
    ).astype(jnp.float32))
    tb = torch.bfloat16
    out = deform.deform_conv_2d_shift(_t(x).to(tb), _t(wt).to(tb), _t(off).to(tb), _t(mask).to(tb), 1, 3, bound=2)
    assert out.dtype == tb

    def rel_rms(a):
        return float(np.sqrt(np.mean((a - exact) ** 2)) / np.sqrt(np.mean(exact**2)))

    port_err, jax_err = rel_rms(out.float().numpy()), rel_rms(jax_bf16)
    assert port_err < 1e-2 and jax_err < 1e-2
    assert port_err <= 1.25 * jax_err, (port_err, jax_err)


def test_exact_form_bf16_is_within_the_jax_bf16_error():
    """bf16 at BiRefNet's k = 7, Cin 112, Cout 28, inputs rounded to bf16
    first: the JAX exact form blends in f32, multiplies in f32 and rounds
    once; the port feeds the product f32 columns (the kernel a bf16 hi/lo
    pair) and rounds once too. Held against the f32 result on the same bf16
    values, the port's relative RMS error is at most 1.1x the JAX form's
    (columns rounded to bf16 before the product gave 1.42x)."""
    x, wt, off, mask = _inputs(0, 1, 32, 32, 112, 28, 7, 1, 3, off_scale=3.0)
    bf = jnp.bfloat16
    x, wt, off, mask = (np.array(jnp.asarray(a, bf).astype(jnp.float32)) for a in (x, wt, off, mask))
    exact = np.asarray(jdeform.deform_conv_2d(x, wt, off, mask, 1, 3))
    jax_bf16 = np.asarray(jdeform.deform_conv_2d(*(jnp.asarray(a, bf) for a in (x, wt, off, mask)), 1, 3)
                          .astype(jnp.float32))
    tb = torch.bfloat16
    out = deform.deform_conv_2d(*(_t(a).to(tb) for a in (x, wt, off, mask)), 1, 3)
    assert out.dtype == tb

    def rel_rms(a):
        return float(np.sqrt(np.mean((a - exact) ** 2)) / np.sqrt(np.mean(exact**2)))

    port_err, jax_err = rel_rms(out.float().numpy()), rel_rms(jax_bf16)
    assert jax_err < 1e-2
    assert port_err <= 1.1 * jax_err, (port_err, jax_err)


def test_zero_offsets_equal_a_conv():
    x, wt, off, _ = _inputs(9, 2, 8, 8, 4, 6, 3, 1, 1)
    expected = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2), _t(wt), padding=1).permute(0, 2, 3, 1)
    out = deform.deform_conv_2d(_t(x), _t(wt), torch.zeros_like(_t(off)), None, 1, 1)
    np.testing.assert_allclose(out.numpy(), expected.numpy(), atol=F32_ATOL, rtol=F32_RTOL)


# -- the Pallas bodies of the probes, in interpret mode --


def _probe_namespace(name: str) -> dict:
    """The probe's imports (but vision_tpu), upper-case constants and defs."""
    path = SCRIPTS / name
    keep = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            if all(m.split(".")[0] != "vision_tpu" for m in mods):
                keep.append(node)
        elif isinstance(node, ast.FunctionDef):
            keep.append(node)
        elif isinstance(node, ast.Assign):
            names = [e.id for t in node.targets for e in (t.elts if isinstance(t, ast.Tuple) else [t])
                     if isinstance(e, ast.Name)]
            if names and all(n.isupper() for n in names):
                keep.append(node)
    ns = {"__file__": str(path), "__name__": path.stem}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"), ns)
    return ns


def _rolled_body(ns):
    # this JAX release's pltpu.roll takes only non-negative shifts; the
    # body's roll by -dx along an axis of WPAD is the roll by WPAD - dx
    real = ns["pltpu"]
    ns["pltpu"] = types.SimpleNamespace(roll=lambda a, shift, axis: real.roll(a, shift % a.shape[axis], axis))
    return ns["make_kernel"]("rolled")


BODIES = {
    "sliced": ("exp_deform_pallas.py", lambda ns: ns["make_kernel"]("sliced")),
    "rolled": ("exp_deform_pallas.py", _rolled_body),
    "dy_fori_dx_static": ("exp_deform_pallas3.py", lambda ns: ns["dy_fori_dx_static"]),
    "r25(sliced)": ("exp_deform_pallas4.py", lambda ns: ns["r25"](True)),
    "s25r": ("exp_deform_pallas4.py", lambda ns: ns["s25r"]),
    "roll25": ("exp_deform_pallas5.py", lambda ns: ns["roll25"]),
    "hyb": ("exp_deform_pallas5.py", lambda ns: ns["hyb"]),
}
HO = WO = 32
C, HB = 16, 8
WPAD = WO + 8  # the probes' halo: two zero columns on the left, six on the right


@pytest.mark.parametrize("body", list(BODIES))
def test_plain_sampler_matches_pallas_body(body):
    """The probes shift columns only: coefficient plane d = 5 * dy + dx
    weights x[:, dx : dx + WO] for dx in 0..4, whatever dy. With planes
    dy = 2 (the zero row shift) holding the tent weights
    relu(1 - |off - (dx - 2)|) of a column offset field in [-2, 2], the
    other planes zero and the halo columns zero, each body is a horizontal
    bilinear sample of the image x[:, 2 : 2 + WO] at column w + off: the
    port's sampler with a 1x1 tap, offsets (0, off) and no mask. Tolerance:
    the sampler (as the JAX package's deform_conv_2d) takes its weights from
    the f32 position w + off, whose fraction carries up to an ulp of w
    (3.8e-6 below 32) where the tent weights of ``off`` alone carry an ulp
    of 2; times |x| <= ~5."""
    script, make = BODIES[body]
    ns = _probe_namespace(script)
    kern = make(ns)
    ns.update(HO=HO, WO=WO, C=C, HB=HB, WPAD=WPAD)
    call = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((HO, WO, C), jnp.float32),
        grid=(HO // HB,),
        in_specs=[pl.BlockSpec((HB, WPAD, C), lambda h: (h, 0, 0)), pl.BlockSpec((25, HB, WO), lambda h: (0, h, 0))],
        out_specs=pl.BlockSpec((HB, WO, C), lambda h: (h, 0, 0)),
        interpret=True,
    )
    rng = np.random.default_rng(len(body))
    img = rng.standard_normal((HO, WO, C)).astype(np.float32)
    x = np.zeros((HO, WPAD, C), np.float32)
    x[:, 2 : 2 + WO] = img
    off = rng.uniform(-2, 2, (HO, WO)).astype(np.float32)
    coef = np.zeros((25, HO, WO), np.float32)
    for dx in range(5):
        coef[10 + dx] = np.maximum(0.0, 1.0 - np.abs(off - (dx - 2)))
    expected = np.asarray(call(jnp.asarray(x), jnp.asarray(coef)))
    offset = np.stack([np.zeros_like(off), off], axis=-1)[None]  # (1, HO, WO, 2): (dy, dx)
    cols = ds.deform_sample(_t(img[None]), _t(offset), None, 1, 1, 1, 0, bound=2)
    assert cols.shape == (1, HO, WO, 1, C)
    np.testing.assert_allclose(cols[0, :, :, 0].numpy(), expected, atol=4e-5, rtol=0)


# -- the wrapper --


def test_cpu_call_takes_the_plain_version_and_counts_no_launch():
    x, _, off, mask = _inputs(1, 2, 6, 7, 8, 1, 3, 1, 1)
    before = ds.launches
    out = ds.deform_sample(_t(x), _t(off), _t(mask), 3, 3, 1, 1)
    assert ds.launches == before
    assert torch.equal(out, ds.deform_sample_plain(_t(x), _t(off), _t(mask), 3, 3, 1, 1))


def test_non_cpu_tensors_never_fall_back():
    x = torch.empty(1, 8, 8, 16, device="meta")
    off = torch.empty(1, 8, 8, 18, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ds.deform_sample(x, off, None, 3, 3, 1, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        ds.deform_sample(torch.zeros(1, 8, 8, 16), off, None, 3, 3, 1, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        ds.deform_sample(torch.zeros(1, 8, 8, 16), torch.zeros(1, 8, 8, 18), torch.empty(1, 8, 8, 9, device="meta"),
                         3, 3, 1, 1)


def _misaligned(shape):
    flat = torch.zeros(int(np.prod(shape)) + 1)
    return flat[1:].view(shape)  # 4 bytes past a 16-byte boundary


X, OFF, MASK = (1, 6, 6, 8), (1, 6, 6, 18), (1, 6, 6, 9)


@pytest.mark.parametrize(
    "x,offset,mask,k,match",
    [
        (torch.zeros(X, dtype=torch.float16), torch.zeros(OFF), None, 3, "x dtype"),
        (torch.zeros(X), torch.zeros(OFF, dtype=torch.float16), None, 3, "offset and mask"),
        (torch.zeros(X), torch.zeros(OFF), None, 0, "kh, kw, stride"),
        (torch.zeros(6, 6, 8), torch.zeros(OFF), None, 3, r"\(B, H, W, Cin\)"),
        (torch.zeros(X), torch.zeros(1, 6, 6, 8), None, 3, r"2 \* 9"),
        (torch.zeros(X), torch.zeros(OFF), torch.zeros(1, 6, 6, 4), 3, r"mask must be \(B, Ho, Wo, 9\)"),
        (torch.zeros(1, 6, 6, 0), torch.zeros(OFF), None, 3, "empty"),
        (torch.empty(1, 2, 2, 8, device="meta"), torch.empty(1, 2**16, 2**16, 2, device="meta"), None, 1, "32-bit"),
        (torch.zeros(1, 8, 6, 6).permute(0, 2, 3, 1), torch.zeros(OFF), None, 3, "contiguous"),
        (_misaligned(X), torch.zeros(OFF), None, 3, "16-byte"),
        (torch.zeros(X), torch.zeros(OFF), torch.zeros(MASK), 3, "CUDA device"),
    ],
)
def test_checks_reject_what_the_kernel_does_not_take(x, offset, mask, k, match):
    with pytest.raises(ValueError, match=match):
        ds._check(x, offset, mask, k, k, 1, 1)


def test_deform_conv_rejects_a_weight_of_other_width():
    x, wt, off, _ = _inputs(2, 1, 5, 5, 4, 3, 3, 1, 1)
    with pytest.raises(ValueError, match="input channels"):
        deform.deform_conv_2d(_t(x), torch.zeros(3, 5, 3, 3), _t(off), None, 1, 1)
