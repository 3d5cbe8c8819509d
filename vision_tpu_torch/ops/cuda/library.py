"""The hand-written kernels as PyTorch operators, in the ``vtt`` namespace.

Each kernel entry point is one custom operator of a ``torch.library``
library (two where the wrapper takes ``out=``: an operator cannot return an
alias of an input, so the ``_out`` form writes into ``out``, which may be a
channel view of a wider buffer, and returns nothing):

    vtt::flash_attention                      ops/cuda/flash_attention.py
    vtt::window_attention                     ops/cuda/window_attention.py
    vtt::conv3x3, vtt::conv3x3_out            ops/cuda/conv3x3.py
    vtt::deform_conv, vtt::deform_conv_out    ops/cuda/deform_conv.py
    vtt::deform_sample                        ops/cuda/deform_sample.py
    vtt::dequant                              ops/cuda/dequant.py

Each has a CPU implementation, the kernel's plain version; a CUDA one, the
wrapper module's ``launch`` (its checks, which read data pointers, the
launch on the current stream and the launch count); a fake implementation,
which gives the output's shape and type from the inputs' and runs nothing,
so ``torch.export``, ``FakeTensorMode`` and ``torch.library.opcheck`` go
through it; and a flop formula (``torch.utils.flop_counter``): matrix
product and convolution multiply-adds times 2, as the JAX package's
``utils/flops.py`` counts them, 0 for the sampler and the dequant. A call
with a CUDA tensor among its inputs dispatches to the CUDA implementation,
which launches the kernel or raises (as it does for a meta tensor that is
no fake one); no CUDA tensor reaches a plain version. The operators have no
autograd formula: the wrappers' autograd functions (``Conv3x3Fn``,
``WindowAttentionFn``, ``DeformConvFn``) call them in their forwards.

The operators are defined by schema on a ``torch.library.Library``
(``define``, ``impl``, ``register_fake``), not by
``torch.library.custom_op``, whose first call in a process imports
``torch._dynamo`` (the CLI's first forward on the card took ~10 s more)
and whose every call takes ~3x the host time.

Importing this module registers the operators (the package imports it);
it builds nothing: the kernel library is compiled at the first launch.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from . import conv3x3 as _conv3x3
from . import deform_conv as _deform_conv
from . import deform_sample as _deform_sample
from . import dequant as _dequant
from . import flash_attention as _flash
from . import window_attention as _window

__all__ = ["OPS"]

_lib = torch.library.Library("vtt", "DEF")  # holds the registrations for the life of the process


def _fake_check(ok: bool, op: str, what: str) -> None:
    if not ok:
        raise ValueError(f"vtt::{op}: {what}")


def _late(module, name: str):
    """``module.<name>``, looked up at each call (a test may replace it)."""
    return lambda *args: getattr(module, name)(*args)


def _define(schema: str, cpu, cuda, fake) -> None:
    """Define ``vtt::<schema>`` with its CPU, CUDA and fake implementations.
    PyTorch runs the fake one for fake tensors (``FakeTensorMode``,
    ``torch.export``, ``opcheck``) and for meta tensors; a meta tensor that
    is no fake one lies off the card like any other, so it goes to ``cuda``,
    whose checks raise."""
    name = schema.split("(", 1)[0]
    _lib.define(schema)
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")

    def fake_or_raise(*args):
        if not any(isinstance(a, FakeTensor) for a in args if isinstance(a, Tensor)):
            return cuda(*args)
        return fake(*args)

    torch.library.register_fake(f"vtt::{name}", fake_or_raise, lib=_lib)


# -- flash attention ---------------------------------------------------------


def _flash_fake(q, k, v, scale):
    _fake_check(q.ndim == 4 and k.ndim == 4 and v.shape == k.shape, "flash_attention", "q, k, v must be (B, H, T, D)")
    return torch.empty_like(q)


_define("flash_attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
        _late(_flash, "flash_attention_plain"), _late(_flash, "launch"), _flash_fake)


@register_flop_formula(torch.ops.vtt.flash_attention)
def _(q, k, v, *args, **kwargs) -> int:
    b, h, tq, d = q
    return 4 * b * h * tq * k[2] * d


# -- window attention --------------------------------------------------------


def _window_fake(q, k, v, bias, n_heads, scale, window_mask):
    _fake_check(q.ndim == 3 and k.shape == q.shape and v.shape == q.shape, "window_attention",
                "q, k, v must share one (NW, T, C) shape")
    return torch.empty_like(q)


_define("window_attention(Tensor q, Tensor k, Tensor v, Tensor? bias, int n_heads, float scale, "
        "Tensor? window_mask) -> Tensor", _late(_window, "window_attention_plain"), _late(_window, "launch"),
        _window_fake)


@register_flop_formula(torch.ops.vtt.window_attention)
def _(q, *args, **kwargs) -> int:
    nw, t, c = q
    return 4 * nw * t * t * c


# -- 3x3 conv ----------------------------------------------------------------

_CONV3X3_ARGS = ("Tensor x, Tensor w, Tensor? b, Tensor? scale, Tensor? shift, bool silu, float? slope, Tensor? r1, "
                 "float s1, Tensor? r2, float s2")


def _conv3x3_cpu(x, w, b, scale, shift, silu, slope, r1, s1, r2, s2, out=None):
    return _conv3x3.conv3x3_plain(x, w, b, scale=scale, shift=shift, silu=silu, slope=slope, r1=r1, s1=s1, r2=r2,
                                  s2=s2, out=out)


def _conv3x3_shape(x, w) -> tuple:
    _fake_check(x.ndim == 4 and w.ndim == 4 and tuple(w.shape[1:]) == (x.shape[3], 3, 3), "conv3x3",
                "x must be (N, H, W, Cin) and w (Cout, Cin, 3, 3)")
    return (*x.shape[:3], w.shape[0])


def _conv3x3_fake(x, w, b, scale, shift, silu, slope, r1, s1, r2, s2):
    return x.new_empty(_conv3x3_shape(x, w))


def _conv3x3_out_cpu(*args) -> None:
    _conv3x3_cpu(*args)


def _conv3x3_out_cuda(*args) -> None:
    _conv3x3.launch(*args)


def _conv3x3_out_fake(x, w, b, scale, shift, silu, slope, r1, s1, r2, s2, out) -> None:
    _fake_check(tuple(out.shape) == _conv3x3_shape(x, w) and out.dtype == x.dtype, "conv3x3_out",
                "out must be (N, H, W, Cout) in x's type")


_define(f"conv3x3({_CONV3X3_ARGS}) -> Tensor", _conv3x3_cpu, _late(_conv3x3, "launch"), _conv3x3_fake)
_define(f"conv3x3_out({_CONV3X3_ARGS}, Tensor(a!) out) -> ()", _conv3x3_out_cpu, _conv3x3_out_cuda,
        _conv3x3_out_fake)


@register_flop_formula([torch.ops.vtt.conv3x3, torch.ops.vtt.conv3x3_out])
def _(x, w, *args, **kwargs) -> int:
    n, h, wd, cin = x
    return 2 * n * h * wd * w[0] * cin * 9


# -- fused deformable conv ---------------------------------------------------

_DEFORM_CONV_ARGS = ("Tensor x, Tensor weight, Tensor offset, Tensor? mask, int kh, int kw, int stride, int pad, "
                     "float? bound, Tensor? bias, Tensor? scale, Tensor? shift, bool relu, Tensor? layout")


def _deform_conv_cpu(x, weight, offset, mask, kh, kw, stride, pad, bound, bias, scale, shift, relu, layout,
                     out=None):
    return _deform_conv.deform_conv_plain(x, weight, offset, mask, kh, kw, stride, pad, bound, bias=bias,
                                          scale=scale, shift=shift, relu=relu, out=out)


def _deform_shape(x, weight, offset, kh, kw) -> tuple:
    _fake_check(x.ndim == 4 and offset.ndim == 4 and offset.shape[3] == 2 * kh * kw
                and tuple(weight.shape[1:]) == (x.shape[3], kh, kw), "deform_conv",
                "x must be (B, H, W, Cin), offset (B, Ho, Wo, 2 kh kw) and the weight (Cout, Cin, kh, kw)")
    return (*offset.shape[:3], weight.shape[0])


def _deform_conv_fake(x, weight, offset, mask, kh, kw, stride, pad, bound, bias, scale, shift, relu, layout):
    return x.new_empty(_deform_shape(x, weight, offset, kh, kw))


def _deform_conv_out_cpu(*args) -> None:
    _deform_conv_cpu(*args)


def _deform_conv_out_cuda(*args) -> None:
    _deform_conv.launch(*args)


def _deform_conv_out_fake(x, weight, offset, mask, kh, kw, stride, pad, bound, bias, scale, shift, relu, layout,
                          out) -> None:
    _fake_check(tuple(out.shape) == _deform_shape(x, weight, offset, kh, kw) and out.dtype == x.dtype,
                "deform_conv_out", "out must be (B, Ho, Wo, Cout) in x's type")


_define(f"deform_conv({_DEFORM_CONV_ARGS}) -> Tensor", _deform_conv_cpu, _late(_deform_conv, "launch"),
        _deform_conv_fake)
_define(f"deform_conv_out({_DEFORM_CONV_ARGS}, Tensor(a!) out) -> ()", _deform_conv_out_cpu, _deform_conv_out_cuda,
        _deform_conv_out_fake)


@register_flop_formula([torch.ops.vtt.deform_conv, torch.ops.vtt.deform_conv_out])
def _(x, weight, offset, *args, **kwargs) -> int:
    cout, cin, kh, kw = weight
    return 2 * offset[0] * offset[1] * offset[2] * cout * cin * kh * kw


# -- deformable-conv sampler -------------------------------------------------


def _deform_sample_fake(x, offset, mask, kh, kw, stride, pad, bound):
    _fake_check(x.ndim == 4 and offset.ndim == 4 and offset.shape[3] == 2 * kh * kw, "deform_sample",
                "x must be (B, H, W, Cin) and offset (B, Ho, Wo, 2 kh kw)")
    return x.new_empty((*offset.shape[:3], kh * kw, x.shape[3]))


_define("deform_sample(Tensor x, Tensor offset, Tensor? mask, int kh, int kw, int stride, int pad, float? bound) "
        "-> Tensor", _late(_deform_sample, "deform_sample_plain"),
        _late(_deform_sample, "launch"), _deform_sample_fake)


@register_flop_formula(torch.ops.vtt.deform_sample)
def _(*args, **kwargs) -> int:
    return 0  # gathers and elementwise multiply-adds: no product, as the JAX counter counts them


# -- block dequant -----------------------------------------------------------


def _dequant_fake(q, scale, minv, file_shape, permute, dtype):
    _fake_check(q.dtype == torch.int8 and q.numel() == math.prod(file_shape), "dequant",
                "q must hold the file shape's int8 levels")
    return q.new_empty(_dequant._out_shape(file_shape, permute), dtype=dtype)


_define("dequant(Tensor q, Tensor scale, Tensor? minv, int[] file_shape, int[]? permute, ScalarType dtype) -> Tensor",
        _late(_dequant, "dequant_plain"), _late(_dequant, "launch"), _dequant_fake)


@register_flop_formula(torch.ops.vtt.dequant)
def _(*args, **kwargs) -> int:
    return 0


OPS = ("flash_attention", "window_attention", "conv3x3", "conv3x3_out", "deform_conv", "deform_conv_out",
       "deform_sample", "dequant")  # the vtt ops this module registers
