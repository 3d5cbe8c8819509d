"""The fused deformable convolution v2 on Hopper, and its plain PyTorch
version.

``deform_conv`` computes, for every output pixel p and output channel co,

    acc[p, co] = sum over taps t = ky * kw + kx and channels c of
                 mask[p, t] * bilinear(x[b, :, :, c], py, px) * weight[co, c, ky, kx]
    py = oy * stride - pad + ky + offset[p, 2t],  px = ox * stride - pad + kx + offset[p, 2t + 1]
    out[p, co] = act(scale[co] * (acc[p, co] + bias[co]) + shift[co])

zero outside the image, with the offsets clamped to [-bound, bound] first
when ``bound`` is given; ``act`` is ReLU when ``relu`` is set; ``bias``,
``scale`` and ``shift`` are optional and applied in f32; one rounding to
x's type. x is (B, H, W, Cin) NHWC in bf16 or f32; the weight (Cout, Cin,
kh, kw) torch-canonical; offset (B, Ho, Wo, 2 * kh * kw) and mask (B, Ho,
Wo, kh * kw) or None in any float type, read as f32. ``out`` may be a
channel view of a wider NHWC buffer (``buf[..., i:i + Cout]``), written in
place: BiRefNet's deformable ASPP writes its four branches into one buffer.

It replaces the Pallas bodies of scripts/exp_deform_pallas.py (``sliced``,
``rolled``), exp_deform_pallas2.py (``d0``..``d4``), exp_deform_pallas3.py
(``dy_fori_dx_static`` and its aligned pieces), exp_deform_pallas4.py
(``r25``, ``s25r``) and exp_deform_pallas5.py (``roll25``, ``hyb``): the
tent-weighted 25-window MAC of the bounded form, of which at most 4
coefficients are nonzero, together with the ``jnp.matmul`` by the weight
that the JAX package runs after it. The kernel (csrc/deform_conv.cu) blends
each 8 x 8 pixel tile's columns into shared memory, tap by tap (each warp
load reading whole corner rows), and multiplies them there with wgmma, so
no column reaches device memory; the bf16 columns enter the product as a
bf16 hi/lo pair, so the product sees them to ~16 bits, as the JAX exact
form's f32 product does. f32 runs as FMA loops. Its consumer on the port's path is every deformable conv of
BiRefNet's decoder (models/birefnet.py through ops/deform.py): 20 launches
per forward, each with its branch's bias, BatchNorm and ReLU.

The wrapper calls the operator ``vtt::deform_conv`` (``vtt::deform_conv_out``
with ``out``; ops/cuda/library.py): on CPU tensors its implementation is
:func:`deform_conv_plain`, on CUDA tensors :func:`launch`, which runs the
kernel or raises. ``launches`` counts kernel launches.

Under autograd (grad mode on and an input that requires grad) the wrapper
goes through :class:`DeformConvFn`: the same forward route, with the
weight laid out from the live weight at the call (a ``layout`` made
earlier would be stale after an optimiser step, so one is refused there,
as is ``out``), and a backward of PyTorch ops.
"""

from __future__ import annotations

import threading

import torch

from . import count_launch
from .conv3x3 import _detached, _pixel_stride
from .deform_sample import deform_sample_plain

__all__ = ["DeformConvFn", "deform_conv", "deform_conv_plain", "launches", "weight_layout"]

launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
# the bf16 kernel's blend covers a pixel's channels in at most two passes of
# 16 lanes x 8 channels
_BF16_MAX_CIN = 256
# the bf16 kernel's input-channel tile: one 128-byte swizzled row of bf16
_BF16_K_TILE = 64


def _tile_n(cout: int, dtype) -> int:
    """The kernel's output-channel tile (csrc/deform_conv.cu ``tile_n``)."""
    return 64 if dtype == torch.bfloat16 and cout > 32 else 32


def deform_conv_plain(x, weight, offset, mask, kh: int, kw: int, stride: int = 1, pad: int = 0, bound=None, *,
                      bias=None, scale=None, shift=None, relu: bool = False, out=None):
    """The kernel's function in plain PyTorch: the f32 columns of
    :func:`deform_sample_plain` times the weight in f32, then ``+ bias``,
    ``* scale``, ``+ shift`` and ReLU in f32, one cast to x's type. Returns
    (B, Ho, Wo, Cout), or writes it into ``out`` and returns ``out``."""
    b = x.shape[0]
    cout, cin = weight.shape[:2]
    cols = deform_sample_plain(x, offset, mask, kh, kw, stride, pad, bound, dtype=torch.float32)
    ho, wo = cols.shape[1], cols.shape[2]
    wmat = weight.float().permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    acc = torch.matmul(cols.view(b * ho * wo, kh * kw * cin), wmat).view(b, ho, wo, cout)
    if bias is not None:
        acc += bias.float()
    # not in place below: autograd of this version (DeformConvFn's backward)
    # needs acc for scale's gradient and for the ReLU's
    if scale is not None:
        acc = acc * scale.float()
    if shift is not None:
        acc += shift.float()
    if relu:
        acc = acc.clamp(min=0.0)
    if out is None:
        return acc.to(x.dtype)
    return out.copy_(acc)


def _check(x, weight, offset, mask, kh: int, kw: int, stride: int, pad: int, *, bias=None, scale=None, shift=None,
           out=None, layout=None) -> None:
    """Raise on what the kernel does not take. The device is checked last,
    so every other rule can be shown on CPU tensors."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"deform_conv: x dtype must be float32 or bfloat16 (got {x.dtype})")
    if not all(t.dtype in _DTYPES for t in (offset, mask) if t is not None):
        raise ValueError("deform_conv: offset and mask must be float32 or bfloat16 once read as floats")
    if min(kh, kw, stride) < 1 or pad < 0:
        raise ValueError(f"deform_conv: need kh, kw, stride >= 1 and pad >= 0 (got {kh}, {kw}, {stride}, {pad})")
    kk = kh * kw
    if x.ndim != 4 or offset.ndim != 4 or offset.shape[0] != x.shape[0] or offset.shape[3] != 2 * kk:
        raise ValueError(
            f"deform_conv: x must be (B, H, W, Cin) and offset (B, Ho, Wo, 2 * {kk}) "
            f"(got {tuple(x.shape)}, {tuple(offset.shape)})"
        )
    b, h, w, cin = x.shape
    if weight.ndim != 4 or tuple(weight.shape[1:]) != (cin, kh, kw) or not weight.is_floating_point():
        raise ValueError(f"deform_conv: the weight must be a float (Cout, {cin}, {kh}, {kw}) (got "
                         f"{tuple(weight.shape)} {weight.dtype})")
    cout = weight.shape[0]
    if mask is not None and tuple(mask.shape) != (*offset.shape[:3], kk):
        raise ValueError(f"deform_conv: mask must be (B, Ho, Wo, {kk}) (got {tuple(mask.shape)})")
    if x.numel() == 0 or offset.numel() == 0 or cout == 0:
        raise ValueError(f"deform_conv: empty input {tuple(x.shape)}, offset {tuple(offset.shape)} or weight "
                         f"{tuple(weight.shape)}")
    if offset.shape[0] * offset.shape[1] * offset.shape[2] * kk > _INT_MAX or h * w > _INT_MAX:
        raise ValueError("deform_conv: B * Ho * Wo * kh * kw or H * W is past the kernel's 32-bit rows")
    if x.dtype == torch.bfloat16 and cin > _BF16_MAX_CIN:
        raise ValueError(f"deform_conv: Cin {cin} is past the bf16 kernel's staged tiles (at most {_BF16_MAX_CIN})")
    for name, v in (("bias", bias), ("scale", scale), ("shift", shift)):
        if v is not None and (tuple(v.shape) != (cout,) or not v.is_floating_point()):
            raise ValueError(f"deform_conv: {name} must be a float ({cout},) (got {tuple(v.shape)} {v.dtype})")
    if layout is not None and (tuple(layout.shape) != _layout_shape(weight, x.dtype) or layout.dtype != x.dtype
                               or not layout.is_contiguous()):
        raise ValueError(f"deform_conv: layout must be weight_layout(weight, {x.dtype}), a contiguous "
                         f"{_layout_shape(weight, x.dtype)} (got {tuple(layout.shape)} {layout.dtype})")
    inputs = tuple(t for t in (x, offset, mask) if t is not None)
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("deform_conv: x, offset and mask must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("deform_conv: x must start on a 16-byte boundary")
    if out is not None:
        want = (b, offset.shape[1], offset.shape[2], cout)
        if tuple(out.shape) != want or out.dtype != x.dtype:
            raise ValueError(f"deform_conv: out must be {want} {x.dtype} (got {tuple(out.shape)} {out.dtype})")
        _pixel_stride(out, "out", "deform_conv")
        if any(out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr() for t in inputs):
            raise ValueError("deform_conv: out shares a buffer with x, offset or mask")
    tensors = inputs + tuple(t for t in (weight, bias, scale, shift, out, layout) if t is not None)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(
            "deform_conv: every tensor must lie on one CUDA device "
            f"(got {', '.join(str(t.device) for t in tensors)})"
        )


def _layout_shape(weight, dtype) -> tuple[int, int, int]:
    cout, cin, kh, kw = weight.shape
    np_ = -(-cout // _tile_n(cout, dtype)) * _tile_n(cout, dtype)
    if dtype == torch.bfloat16:
        return kh * kw, np_, -(-cin // _BF16_K_TILE) * _BF16_K_TILE
    return kh * kw, cin, np_


def weight_layout(weight, dtype) -> torch.Tensor:
    """The (Cout, Cin, kh, kw) weight laid out as the kernel reads it for x
    of type ``dtype``, zero padded: bf16 (kh kw, Np, Kp) with Kp = Cin
    rounded up to 64; f32 (kh kw, Cin, Np); Np = Cout rounded up to the
    kernel's output-channel tile. Two device passes: a caller that holds the
    weight (the model) makes it once and passes it as ``layout``."""
    cout, cin, kh, kw = weight.shape
    wc = torch.zeros(_layout_shape(weight, dtype), dtype=dtype, device=weight.device)
    if dtype == torch.bfloat16:
        wc[:, :cout, :cin] = weight.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin)
    else:
        wc[:, :, :cout] = weight.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout)
    return wc


def deform_conv(x, weight, offset, mask, kh: int, kw: int, stride: int = 1, pad: int = 0, bound=None, *,
                bias=None, scale=None, shift=None, relu: bool = False, out=None, layout=None) -> torch.Tensor:
    """The deformable conv with its epilogue (see the module docstring);
    ``bound``: None for the exact form, else the offsets' clamp; ``layout``:
    :func:`weight_layout` of the weight for x's type, or None to lay it out
    at this call (the plain version reads the weight). Returns (B, Ho, Wo,
    Cout) in x's type: ``out`` when given, written in place. Runs the
    operator ``vtt::deform_conv``, or ``vtt::deform_conv_out`` with ``out``
    (ops/cuda/library.py)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, offset, mask, bias, scale, shift)):
        if out is not None or layout is not None:
            raise ValueError("deform_conv: out and layout cannot be given under autograd (an input requires grad): "
                             "the output is a fresh tensor and the weight is laid out at the call")
        return DeformConvFn.apply(x, weight, offset, mask, bias, scale, shift, kh, kw, stride, pad, bound, relu)
    args = (x, weight, offset, mask, int(kh), int(kw), int(stride), int(pad), None if bound is None else float(bound),
            bias, scale, shift, bool(relu), layout)
    if out is None:
        return torch.ops.vtt.deform_conv(*args)
    torch.ops.vtt.deform_conv_out(*args, out)
    return out


def launch(x, weight, offset, mask, kh, kw, stride, pad, bound, bias, scale, shift, relu, layout,
           out=None) -> torch.Tensor:
    """The kernel on CUDA tensors (the CUDA implementation of both
    operators): check, launch on the current stream into ``out`` or a fresh
    tensor, count; returns the output."""
    # any other float type is read as f32
    offset = offset if offset.dtype in _DTYPES else offset.float()
    if mask is not None and mask.dtype not in _DTYPES:
        mask = mask.float()
    _check(x, weight, offset, mask, kh, kw, stride, pad, bias=bias, scale=scale, shift=shift, out=out, layout=layout)
    from .build import load_library

    lib = load_library()
    b, h, w, cin = x.shape
    ho, wo = offset.shape[1], offset.shape[2]
    cout = weight.shape[0]
    wc = weight_layout(weight, x.dtype) if layout is None else layout
    np_ = wc.shape[1] if x.dtype == torch.bfloat16 else wc.shape[2]
    kp = wc.shape[2] if x.dtype == torch.bfloat16 else -(-cin // 16) * 16
    epi = [v for v in (bias, scale, shift) if v is not None]
    # the epilogue's vectors in one type the kernel reads: theirs, or f32
    epi_dtype = epi[0].dtype if epi and all(v.dtype == epi[0].dtype for v in epi) else torch.float32
    epi_dtype = epi_dtype if epi_dtype in _DTYPES else torch.float32
    epi = [None if v is None else v.to(epi_dtype).contiguous() for v in (bias, scale, shift)]
    if out is None:
        out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vtt_deform_conv_fwd(
            x.data_ptr(), wc.data_ptr(), np_, kp, offset.data_ptr(), _DTYPES[offset.dtype],
            None if mask is None else mask.data_ptr(), 0 if mask is None else _DTYPES[mask.dtype],
            *(None if v is None else v.data_ptr() for v in epi), _DTYPES[epi_dtype], int(bool(relu)),
            out.data_ptr(), out.stride(2),
            b, h, w, cin, ho, wo, kh, kw, stride, pad, -1.0 if bound is None else float(bound), cout,
            _DTYPES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"deform_conv: kernel launch failed with cudaError {err}")
    count_launch(__name__, launches=1)
    return out


class DeformConvFn(torch.autograd.Function):
    """:func:`deform_conv` with gradients for x, the weight, the offsets
    (through the bilinear weights), the modulation mask, the bias, scale and
    shift (BiRefNet's BatchNorm, fused at conversion into the float leaves
    ``bn.weight`` and ``bn.bias``, trains through these two, as the JAX
    package trains the same leaves).

    Forward: the wrapper's route (the kernel on CUDA tensors, one counted
    launch, the weight laid out from the live weight; the plain version on
    CPU ones). Backward: :func:`deform_conv_plain` recomputed under autograd
    from the saved inputs (f32 columns, the product, the epilogue) and
    differentiated by PyTorch, the counterpart of XLA's autodiff of the JAX
    package's gather form. The ReLU's mask is the recomputed f32 result's."""

    @staticmethod
    def forward(ctx, x, weight, offset, mask, bias, scale, shift, kh, kw, stride, pad, bound, relu):
        x_, w_, o_, m_, b_, sc_, sh_ = _detached(x, weight, offset, mask, bias, scale, shift)
        out = deform_conv(x_, w_, o_, m_, kh, kw, stride, pad, bound, bias=b_, scale=sc_, shift=sh_, relu=relu)
        ctx.save_for_backward(x, weight, offset, mask, bias, scale, shift)
        ctx.conv = (kh, kw, stride, pad, bound, relu)
        return out

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        kh, kw, stride, pad, bound, relu = ctx.conv
        want = [t is not None and need for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            x, weight, offset, mask, bias, scale, shift = (
                None if t is None else t.detach().requires_grad_(w) for t, w in zip(saved, want))
            y = deform_conv_plain(x, weight, offset, mask, kh, kw, stride, pad, bound, bias=bias, scale=scale,
                                  shift=shift, relu=relu)
            leaves = [t for t, w in zip((x, weight, offset, mask, bias, scale, shift), want) if w]
            grads = iter(torch.autograd.grad(y, leaves, grad))
        return (*(next(grads) if w else None for w in want), None, None, None, None, None, None)
