"""What the plain references share: the precision they compute in, and the
bilinear resize as two products by interpolation matrices.

Plain PyTorch only: nothing here imports the program under test.

``Precision("f32")`` is the reference proper: every product in float32 with
TF32 off (:func:`exact_matmul`). ``Precision("fp8")`` is the control: the
same function with both operands of every product (linear layers,
convolutions, attention's two products, the deformable conv's product)
rounded to float8 e4m3 with one scale a tensor (its largest magnitude maps to
448), the products summed in float32 as fp8 tensor cores sum them; the
elementwise work stays float32. It is the precision step below the bfloat16
that the configurations serve in.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["Precision", "exact_matmul", "resize_bilinear_ac"]

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


class Precision:
    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r} (f32 or fp8)")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as this precision holds a product's operand (float32 values)."""
        if self.name == "f32":
            return t
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv2d(self, x, w, b=None, stride: int = 1, padding: int = 0):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


@contextlib.contextmanager
def exact_matmul():
    """float32 products in float32 on the card: TF32 off for cuBLAS and
    cuDNN while the block runs, the settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _axis_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) bilinear weights with align_corners=True (torch's
    ``F.interpolate`` semantics): output i samples input i (n_in - 1) /
    (n_out - 1), a single output samples input 0."""
    if n_out > 1:
        pos = torch.arange(n_out, dtype=torch.float64) * ((n_in - 1) / (n_out - 1))
    else:
        pos = torch.zeros(1, dtype=torch.float64)
    lo = torch.floor(pos)
    frac = pos - lo
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    for tap, tw in ((lo, 1.0 - frac), (lo + 1, frac)):
        w.index_put_((rows, tap.long().clamp(0, n_in - 1)), tw, accumulate=True)
    return w.to(torch.float32).to(device)


def resize_bilinear_ac(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(N, H, W, C) float32 to (N, Ho, Wo, C), bilinear with
    align_corners=True, as two products: rows, then columns (a length-1 axis
    as a plain matrix product)."""
    n, h, w, c = x.shape
    ho, wo = size
    if (h, w) == (ho, wo):
        return x
    wy = _axis_matrix(h, ho, x.device)
    wx = _axis_matrix(w, wo, x.device)
    if h > 1:
        out = torch.einsum("oh,nhwc->nowc", wy, x)
    else:
        out = torch.matmul(wy, x.reshape(n, 1, w * c)).reshape(n, ho, w, c)
    return torch.einsum("ow,nhwc->nhoc", wx, out) if w > 1 else torch.matmul(wx, out)
