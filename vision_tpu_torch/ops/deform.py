"""Deformable convolution v2 (offset + modulation mask) — a port of
vision_tpu/ops/deform.py.

Semantics follow torchvision.ops.deform_conv2d (what BiRefNet trains with):
for each output position p0 and kernel tap k, sample the input bilinearly at
``p0*stride - pad + k + offset_k``, scale by the modulation mask, then apply
the conv weight. Offsets are per-output-pixel (y, x) pairs laid out
[2*K*K] with tap-major (dy0, dx0, dy1, dx1, ...); out-of-bounds samples are
zero.

Every form goes through ops/cuda/deform_conv.py: the fused hand-written
kernel on a CUDA tensor (the columns are sampled into shared memory and
multiplied there, never written to device memory), its plain version on a
CPU one (f32 columns times the weight in f32). Either way the product sees
the columns at better than bf16 precision and the result is rounded once
to x's type, as the JAX package's exact form (f32 blend, f32 product,
``out.astype(x.dtype)``). :func:`deform_conv_2d_fused` adds the kernel's
epilogue, ``act(scale * (conv + bias) + shift)`` in f32 before that one
rounding, and writes into a channel view when given ``out``: BiRefNet's
deformable ASPP takes it.

``deform_conv_2d_shift`` is the JAX package's gather-free bounded form: the
same function with the offsets clamped to [-bound, bound]. The kernel
evaluates the 4 bilinear corners in either form, so on the card the two
cost the same. Where the JAX shift form multiplies each window by its
tent weight in the input type (bf16 on the TPU), the port blends in f32:
at f32 the two agree to rounding, in bf16 the port is the more precise.
"""

from __future__ import annotations

import torch

from .cuda.deform_conv import deform_conv

__all__ = ["deform_conv_2d", "deform_conv_2d_fused", "deform_conv_2d_shift"]


def deform_conv_2d_fused(x, weight, offset, mask=None, stride: int = 1, pad: int = 0, bound=None, *, bias=None,
                         scale=None, shift=None, relu: bool = False, out=None, layout=None) -> torch.Tensor:
    """Deformable conv v2 with the kernel's epilogue: ``act(scale * (conv +
    bias) + shift)`` in f32 (each term optional, ``act`` ReLU when ``relu``),
    one rounding to x's type; ``bound`` clamps the offsets (None: the exact
    form); with ``out`` (a (B, Ho, Wo, Cout) channel view of a wider NHWC
    buffer) the result is written there; ``layout``, the weight as the
    kernel reads it (ops/cuda/deform_conv.weight_layout), spares the call
    laying it out. Other arguments as :func:`deform_conv_2d`."""
    cout, cin, kh, kw = weight.shape
    if cin != x.shape[3]:
        raise ValueError(f"deform_conv: weight {tuple(weight.shape)} does not take {x.shape[3]} input channels")
    return deform_conv(
        x.contiguous(), weight, offset.contiguous(), None if mask is None else mask.contiguous(), kh, kw, stride, pad,
        bound, bias=bias, scale=scale, shift=shift, relu=relu, out=out, layout=layout,
    )


def deform_conv_2d_shift(x, weight, offset, mask=None, stride: int = 1, pad: int = 0, bound: int = 4):
    """Deformable conv v2 with offsets clamped to [-bound, bound] (exact
    bilinear sampling while |offset| <= bound). Arguments as
    :func:`deform_conv_2d`."""
    return deform_conv_2d_fused(x, weight, offset, mask, stride, pad, bound)


def deform_conv_2d(x, weight, offset, mask=None, stride: int = 1, pad: int = 0):
    """Deformable conv v2.

    x:      (B, H, W, Cin)   NHWC input
    weight: (Cout, Cin, kH, kW)  torch-canonical kernel
    offset: (B, Ho, Wo, 2*kH*kW) per-pixel (dy, dx) pairs, tap-major
    mask:   (B, Ho, Wo, kH*kW) modulation (already sigmoid*2 scaled) or None
    Returns (B, Ho, Wo, Cout) in x's type.
    """
    return deform_conv_2d_fused(x, weight, offset, mask, stride, pad)
