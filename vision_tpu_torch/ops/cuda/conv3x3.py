"""The 3x3, stride-1, pad-1 convolution on Hopper, and its plain PyTorch
version.

``conv3x3`` replaces the Pallas kernel ``kernel`` of ``conv_rowblock`` in
scripts/exp_pallas_conv.py (launched there through ``pl.pallas_call``):

    out[n, y, x, co] = sum over dy, dx, ci of pad1(x)[n, y+dy, x+dx, ci] * w[co, ci, dy, dx]

with x (N, H, W, Cin) NHWC, the weight in its torch-canonical (Cout, Cin, 3,
3) layout, f32 accumulation, the output in x's type and no bias (the probe
takes one (1, H, W, C) image with an HWIO weight; the kernel adds the batch
axis). Its consumer on the port's path is every conv of Real-ESRGAN's
RRDBNet (models/esrgan.py, through ops/nn.py ``conv_3x3``): 351 launches per
forward at scale 4 with 23 blocks.

The kernel (csrc/conv3x3.cu) is an implicit GEMM over 16 x 16 pixel tiles
whose input tile and one-pixel halo it stages in shared memory, 16 channels
at a time, so each input pixel is read from device memory about once per
output-channel tile; at the RRDB shapes it is bound by bytes (the 192 -> 64
conv by the tensor cores). A CPU tensor goes to :func:`conv3x3_plain`; a
CUDA tensor goes to the kernel or raises. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

__all__ = ["conv3x3", "conv3x3_plain", "launches"]

launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 16  # the kernel's output tile is 16 x 16 pixels
_INT_MAX = 2**31 - 1


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The Pallas ``slices`` body in plain PyTorch: nine tap products of the
    zero-padded input with ``w[:, :, dy, dx]``, each in f32 from the inputs'
    values, summed in f32 and cast to x's type. x: (N, H, W, Cin); w: (Cout,
    Cin, 3, 3). Returns (N, H, W, Cout)."""
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n, h, wd, w.shape[0]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += torch.matmul(xp[:, dy : dy + h, dx : dx + wd, :].float(), wf[:, :, dy, dx].t())
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernel does not take. The device is checked last,
    so every other rule can be shown on CPU tensors."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"conv3x3: x and w must share one dtype, float32 or bfloat16 (got {x.dtype}, {w.dtype})")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[1:]) != (x.shape[3], 3, 3):
        raise ValueError(
            f"conv3x3: x must be (N, H, W, Cin) and w (Cout, Cin, 3, 3) (got {tuple(x.shape)}, {tuple(w.shape)})"
        )
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"conv3x3: empty input {tuple(x.shape)} or weight {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    tiles = n * -(-h // _TILE) * -(-wd // _TILE)
    if max(n, h, wd, cin, w.shape[0], tiles, w.numel()) > _INT_MAX:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} or w {tuple(w.shape)} is past the kernel's 32-bit grid")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3: x and w must start on a 16-byte boundary")
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"conv3x3: x and w must lie on one CUDA device (got {x.device}, {w.device})")


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 pad-1 conv, x: (N, H, W, Cin), w: (Cout, Cin, 3, 3), no
    bias. Returns (N, H, W, Cout) in x's type."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_plain(x, w)
    _check(x, w)
    from .build import load_library

    lib = load_library()
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vtt_conv3x3_fwd(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, _DTYPES[x.dtype], stream
        )
    if err != 0:
        raise RuntimeError(f"conv3x3: kernel launch failed with cudaError {err}")
    with _count_lock:
        launches += 1
    return out
