"""Deformable convolution v2 (offset + modulation mask) — a port of
vision_tpu/ops/deform.py.

Semantics follow torchvision.ops.deform_conv2d (what BiRefNet trains with):
for each output position p0 and kernel tap k, sample the input bilinearly at
``p0*stride - pad + k + offset_k``, scale by the modulation mask, then apply
the conv weight. Offsets are per-output-pixel (y, x) pairs laid out
[2*K*K] with tap-major (dy0, dx0, dy1, dx1, ...); out-of-bounds samples are
zero.

Both forms are the modulated columns of ops/cuda/deform_sample.py (the
hand-written sampler on a CUDA tensor, its plain version on a CPU one) times
the weight permuted to (K*K*Cin, Cout), in ONE matrix product with f32
accumulation and one rounding to x's type, as the JAX package's
``out.astype(x.dtype)``. The product stays a library call, as it is
``jnp.matmul`` outside any Pallas kernel in the JAX package. The columns
are freed when the product returns.

``deform_conv_2d_shift`` is the JAX package's gather-free bounded form: the
same function with the offsets clamped to [-bound, bound]. The sampler
evaluates the 4 bilinear corners in either form, so on the card the two
cost the same. Where the JAX shift form multiplies each window by its
tent weight in the input type (bf16 on the TPU), the port blends in f32 and
rounds the columns once: at f32 the two agree to rounding, in bf16 the port
is the more precise.
"""

from __future__ import annotations

import torch

from .cuda.deform_sample import deform_sample

__all__ = ["deform_conv_2d", "deform_conv_2d_shift"]


def _deform_conv(x, weight, offset, mask, stride: int, pad: int, bound) -> torch.Tensor:
    b = x.shape[0]
    cout, cin, kh, kw = weight.shape
    if cin != x.shape[3]:
        raise ValueError(f"deform_conv: weight {tuple(weight.shape)} does not take {x.shape[3]} input channels")
    ho, wo = offset.shape[1], offset.shape[2]
    cols = deform_sample(
        x.contiguous(), offset.contiguous(), None if mask is None else mask.contiguous(), kh, kw, stride, pad, bound
    )
    wmat = weight.to(x.dtype).permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)
    return torch.matmul(cols.view(b * ho * wo, kh * kw * cin), wmat).view(b, ho, wo, cout)


def deform_conv_2d_shift(x, weight, offset, mask=None, stride: int = 1, pad: int = 0, bound: int = 4):
    """Deformable conv v2 with offsets clamped to [-bound, bound] (exact
    bilinear sampling while |offset| <= bound). Arguments as
    :func:`deform_conv_2d`."""
    return _deform_conv(x, weight, offset, mask, stride, pad, bound)


def deform_conv_2d(x, weight, offset, mask=None, stride: int = 1, pad: int = 0):
    """Deformable conv v2.

    x:      (B, H, W, Cin)   NHWC input
    weight: (Cout, Cin, kH, kW)  torch-canonical kernel
    offset: (B, Ho, Wo, 2*kH*kW) per-pixel (dy, dx) pairs, tap-major
    mask:   (B, Ho, Wo, kH*kW) modulation (already sigmoid*2 scaled) or None
    Returns (B, Ho, Wo, Cout) in x's type.
    """
    return _deform_conv(x, weight, offset, mask, stride, pad, None)
