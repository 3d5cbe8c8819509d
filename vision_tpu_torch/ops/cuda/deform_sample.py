"""Deformable-conv v2 sampling on Hopper, and its plain PyTorch version.

``deform_sample`` builds the modulated columns of a deformable conv: for
every output pixel, tap k = ky * kw + kx and channel c,

    cols[b, oy, ox, k, c] = mask[b, oy, ox, k] * bilinear(x[b, :, :, c], py, px)
    py = oy * stride - pad + ky + offset[b, oy, ox, 2k]
    px = ox * stride - pad + kx + offset[b, oy, ox, 2k + 1]

zero outside the image, with the offsets clamped to [-bound, bound] first
when ``bound`` is given (the bounded form, ``deform_conv_2d_shift``). x is
(B, H, W, Cin) NHWC in bf16 or f32; offset (B, Ho, Wo, 2 * kh * kw) and mask
(B, Ho, Wo, kh * kw) or None in any float type, read as f32; the columns
(B, Ho, Wo, kh * kw, Cin) are in x's type.

It replaces the Pallas bodies of scripts/exp_deform_pallas.py (``sliced``,
``rolled``), exp_deform_pallas2.py (``d0``..``d4``), exp_deform_pallas3.py
(``dy_fori_dx_static`` and its aligned pieces), exp_deform_pallas4.py
(``r25``, ``s25r``) and exp_deform_pallas5.py (``roll25``, ``hyb``): the
tent-weighted 25-window MAC of the bounded form, of which at most 4
coefficients are nonzero. The kernel (csrc/deform_sample.cu) evaluates only
those 4 bilinear corners, per (pixel, tap) in f32, blends Cin channels from
4 rows in 16-byte loads, multiplies by the mask in f32 and rounds once. Its
bound is bytes: the columns written, plus x, the offsets and the mask read
once. It is the standalone column kernel: no served path launches it, since
BiRefNet's deformable convs take the fused kernel (ops/cuda/deform_conv.py),
which never writes the columns; its plain version gives that kernel's plain
version its f32 columns.

The wrapper calls the operator ``vtt::deform_sample`` (ops/cuda/library.py):
on CPU tensors its implementation is :func:`deform_sample_plain` (the
4-corner gather of the JAX package's ``_gather_pixels``,
vision_tpu/ops/deform.py:30-42), on CUDA tensors :func:`launch`, which runs
the kernel or raises. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import threading

import torch

from . import count_launch

__all__ = ["deform_sample", "deform_sample_plain", "launches"]

launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def _gather(x_flat: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """x_flat (B, H*W, C) at integer (iy, ix) of shape (B, N), as f32, zero
    outside the image."""
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).unsqueeze(-1).expand(-1, -1, x_flat.shape[-1])
    return torch.gather(x_flat, 1, idx).float() * inb.unsqueeze(-1)


def deform_sample_plain(x, offset, mask, kh: int, kw: int, stride: int = 1, pad: int = 0, bound=None, dtype=None):
    """The kernel's arithmetic in plain PyTorch: 4-corner bilinear samples
    with f32 coordinates and weights, summed in the order corner 00, 01, 10,
    11, times the mask, cast once to ``dtype`` (default x's type). Returns
    (B, Ho, Wo, kh * kw, Cin)."""
    b, h, w, cin = x.shape
    ho, wo = offset.shape[1], offset.shape[2]
    kk = kh * kw
    off = offset.float().reshape(b, ho, wo, kk, 2)
    if bound is not None:
        off = off.clamp(-bound, bound)
    dev = x.device
    ky = torch.arange(kh, device=dev).repeat_interleave(kw)
    kx = torch.arange(kw, device=dev).repeat(kh)
    base_y = (torch.arange(ho, device=dev) * stride - pad)[:, None, None] + ky  # (Ho, 1, kk)
    base_x = (torch.arange(wo, device=dev) * stride - pad)[None, :, None] + kx  # (1, Wo, kk)
    py = base_y.float() + off[..., 0]  # (B, Ho, Wo, kk)
    px = base_x.float() + off[..., 1]
    y0f, x0f = torch.floor(py), torch.floor(px)
    fy, fx = py - y0f, px - x0f
    y0, x0 = y0f.long().reshape(b, -1), x0f.long().reshape(b, -1)
    weights = ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)
    x_flat = x.reshape(b, h * w, cin)
    s = None
    for (cy, cx), wt in zip(((0, 0), (0, 1), (1, 0), (1, 1)), weights):
        term = _gather(x_flat, y0 + cy, x0 + cx, h, w) * wt.reshape(b, -1, 1)
        s = term if s is None else s.add_(term)
    if mask is not None:
        s = s * mask.float().reshape(b, -1, 1)  # not in place: autograd needs s for the mask's gradient
    return s.reshape(b, ho, wo, kk, cin).to(dtype or x.dtype)


def _check(x, offset, mask, kh: int, kw: int, stride: int, pad: int) -> None:
    """Raise on what the kernel does not take. The device is checked last,
    so every other rule can be shown on CPU tensors."""
    tensors = tuple(t for t in (x, offset, mask) if t is not None)
    if x.dtype not in _DTYPES:
        raise ValueError(f"deform_sample: x dtype must be float32 or bfloat16 (got {x.dtype})")
    if not all(t.dtype in _DTYPES for t in tensors[1:]):
        raise ValueError("deform_sample: offset and mask must be float32 or bfloat16 once read as floats")
    if min(kh, kw, stride) < 1 or pad < 0:
        raise ValueError(f"deform_sample: need kh, kw, stride >= 1 and pad >= 0 (got {kh}, {kw}, {stride}, {pad})")
    kk = kh * kw
    if x.ndim != 4 or offset.ndim != 4 or offset.shape[0] != x.shape[0] or offset.shape[3] != 2 * kk:
        raise ValueError(
            f"deform_sample: x must be (B, H, W, Cin) and offset (B, Ho, Wo, 2 * {kk}) "
            f"(got {tuple(x.shape)}, {tuple(offset.shape)})"
        )
    if mask is not None and tuple(mask.shape) != (*offset.shape[:3], kk):
        raise ValueError(f"deform_sample: mask must be (B, Ho, Wo, {kk}) (got {tuple(mask.shape)})")
    if x.numel() == 0 or offset.numel() == 0:
        raise ValueError(f"deform_sample: empty input {tuple(x.shape)} or offset {tuple(offset.shape)}")
    if offset.shape[0] * offset.shape[1] * offset.shape[2] * kk > _INT_MAX:
        raise ValueError("deform_sample: B * Ho * Wo * kh * kw is past the kernel's 32-bit rows")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("deform_sample: x, offset and mask must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("deform_sample: x must start on a 16-byte boundary")
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(
            "deform_sample: x, offset and mask must lie on one CUDA device "
            f"(got {', '.join(str(t.device) for t in tensors)})"
        )


def deform_sample(x, offset, mask, kh: int, kw: int, stride: int = 1, pad: int = 0, bound=None) -> torch.Tensor:
    """The modulated deformable-conv columns (B, Ho, Wo, kh * kw, Cin) in x's
    type; ``bound``: None for the exact form, else the offsets' clamp.
    Runs the operator ``vtt::deform_sample`` (ops/cuda/library.py)."""
    return torch.ops.vtt.deform_sample(x, offset, mask, int(kh), int(kw), int(stride), int(pad),
                                       None if bound is None else float(bound))


def launch(x, offset, mask, kh: int, kw: int, stride: int, pad: int, bound) -> torch.Tensor:
    """The kernel on CUDA tensors (the operator's CUDA implementation):
    check, launch on the current stream, count."""
    # any other float type is read as f32
    offset = offset if offset.dtype in _DTYPES else offset.float()
    if mask is not None and mask.dtype not in _DTYPES:
        mask = mask.float()
    _check(x, offset, mask, kh, kw, stride, pad)
    from .build import load_library

    lib = load_library()
    b, h, w, cin = x.shape
    ho, wo = offset.shape[1], offset.shape[2]
    out = torch.empty((b, ho, wo, kh * kw, cin), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vtt_deform_sample_fwd(
            x.data_ptr(), offset.data_ptr(), _DTYPES[offset.dtype],
            None if mask is None else mask.data_ptr(), 0 if mask is None else _DTYPES[mask.dtype],
            out.data_ptr(), b, h, w, cin, ho, wo, kh, kw, stride, pad,
            -1.0 if bound is None else float(bound), _DTYPES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"deform_sample: kernel launch failed with cudaError {err}")
    count_launch(__name__, launches=1)
    return out
