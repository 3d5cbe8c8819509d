"""The 3x3, stride-1, pad-1 convolution on Hopper with a fused epilogue, and
its plain PyTorch version.

``conv3x3`` replaces the Pallas kernel ``kernel`` of ``conv_rowblock`` in
scripts/exp_pallas_conv.py (launched there through ``pl.pallas_call``):

    acc[n, y, x, co] = sum over dy, dx, ci of pad1(x)[n, y+dy, x+dx, ci] * w[co, ci, dy, dx]
    v[n, y, x, co]   = scale[co] * (acc + b[co]) + shift[co]
    out[n, y, x, co] = r2 + s2 * act(r1 + s1 * v)

with x (N, H, W, Cin) NHWC, the weight in its torch-canonical (Cout, Cin, 3,
3) layout, ``act`` the identity, leaky ReLU (``slope``) or SiLU (``silu``);
``b``, ``scale``, ``shift`` (a fused BatchNorm), ``r1`` and ``r2`` optional;
the sum and the whole epilogue in f32, rounded once to x's type (the probe
takes one (1, H, W, C) image with an HWIO weight and no epilogue; the kernel
adds the batch axis). x, ``out``, ``r1`` and ``r2`` may be channel views of
wider NHWC buffers (``buf[..., i:i + C]``): the kernel reads and writes them
in place, so no concatenation is needed. Its consumers on the port's paths,
through ops/nn.py ``conv_3x3_fused``:

* every conv of Real-ESRGAN's RRDBNet (models/esrgan.py): 351 launches per
  forward at scale 4 with 23 blocks, with bias, leaky ReLU and residuals
  (it never gives ``slope`` with ``r1``, so act's place beside r1 does not
  matter to it);
* YOLOv9t's 112 stride-1 3x3 convs a forward (models/yolov9t.py), each with
  its BatchNorm and SiLU; a RepConv's 1x1 branch is ``r1``, a
  RepBottleneck's shortcut ``r2``.

The bf16 kernel (csrc/conv3x3.cu) is a persistent implicit GEMM on wgmma:
pixel tiles 16 wide, the halo tile by TMA into an mbarrier ring that a
producer warp fills, the weight staged in shared memory once per block;
f32 (the CPU-parity type) runs as FMA loops. A CPU tensor goes to :func:`conv3x3_plain`; a CUDA tensor goes to
the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

__all__ = ["conv3x3", "conv3x3_plain", "launches"]

launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_H, _TILE_W = 8, 16  # the kernel's smallest output tile
_INT_MAX = 2**31 - 1
# the bf16 kernel stages a block's whole weight (9 x Cin rounded up to 16 x
# at least 8 output channels, bf16) beside its 90 KB halo ring in the 227 KB
# a block may hold
_BF16_MAX_CIN = 960


def conv3x3_plain(x, w, b=None, *, scale=None, shift=None, silu=False, slope=None, r1=None, s1=1.0, r2=None,
                  s2=1.0, out=None):
    """The Pallas ``slices`` body in plain PyTorch, with the epilogue: nine
    tap products of the zero-padded input with ``w[:, :, dy, dx]``, each in
    f32 from the inputs' values, summed in f32; then, in f32, ``+ b``, ``*
    scale``, ``+ shift``, ``r1 + s1 * y``, the activation (leaky ReLU with
    ``slope``, SiLU with ``silu``, else none), ``r2 + s2 * y``; one cast to
    x's type. x: (N, H, W, Cin); w: (Cout, Cin, 3, 3). Returns (N, H, W,
    Cout), or writes it into ``out`` and returns ``out``."""
    n, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((n, h, wd, w.shape[0]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += torch.matmul(xp[:, dy : dy + h, dx : dx + wd, :].float(), wf[:, :, dy, dx].t())
    if b is not None:
        acc += b.float()
    if scale is not None:
        acc *= scale.float()
    if shift is not None:
        acc += shift.float()
    if r1 is not None:
        acc = r1.float() + s1 * acc
    if slope is not None:
        acc = torch.where(acc >= 0, acc, acc * slope)
    if silu:
        acc = acc * torch.sigmoid(acc)
    if r2 is not None:
        acc = r2.float() + s2 * acc
    if out is None:
        return acc.to(x.dtype)
    return out.copy_(acc)


def _pixel_stride(t: torch.Tensor, name: str, kernel: str = "conv3x3") -> int:
    """The pixel stride of ``t``, a channel view of an NHWC buffer whose
    pixels, rows and images are packed; raise otherwise (``kernel`` names
    the caller in the message; deform_conv checks its ``out`` here too)."""
    n, h, wd, c = t.shape
    ps = t.stride(2)
    if t.stride(3) != 1 or ps < c or (h > 1 and t.stride(1) != wd * ps) or (n > 1 and t.stride(0) != h * wd * ps):
        raise ValueError(
            f"{kernel}: {name} must be contiguous or a channel view of a contiguous NHWC buffer "
            f"(got strides {t.stride()} for shape {tuple(t.shape)})"
        )
    if ps > c and t.storage_offset() % ps + c > ps:  # a view's offset counts from its storage's start
        raise ValueError(f"{kernel}: {name}'s channels run past its buffer's {ps}-channel pixel")
    if ps > _INT_MAX:
        raise ValueError(f"{kernel}: {name}'s pixel stride {ps} is past the kernel's 32-bit grid")
    return ps


def _overlap(x: torch.Tensor, out: torch.Tensor) -> bool:
    """Whether ``out``'s elements meet ``x``'s (both (N, H, W, C) views of
    packed pixels): the channel ranges of views of one buffer, else the
    spans they cover in one storage."""
    if x.untyped_storage().data_ptr() != out.untyped_storage().data_ptr():
        return False
    xs, os_, ps = x.storage_offset(), out.storage_offset(), x.stride(2)
    if out.stride(2) == ps:
        pixels = x.shape[0] * x.shape[1] * x.shape[2]
        if xs // ps + pixels <= os_ // ps or os_ // ps + pixels <= xs // ps:
            return False
        return xs % ps < os_ % ps + out.shape[3] and os_ % ps < xs % ps + x.shape[3]
    end = lambda t, so: so + sum((d - 1) * st for d, st in zip(t.shape, t.stride())) + 1  # noqa: E731
    return xs < end(out, os_) and os_ < end(x, xs)


def _check(x, w, b=None, *, scale=None, shift=None, silu=False, slope=None, r1=None, s1=1.0, r2=None, s2=1.0,
           out=None) -> None:
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
    cout = w.shape[0]
    tiles = n * -(-h // _TILE_H) * -(-wd // _TILE_W)
    if max(n, h, wd, cin, cout, tiles, w.numel()) > _INT_MAX:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} or w {tuple(w.shape)} is past the kernel's 32-bit grid")
    if x.dtype == torch.bfloat16 and cin > _BF16_MAX_CIN:
        raise ValueError(f"conv3x3: Cin {cin} is past the bf16 kernel's staged weight (at most {_BF16_MAX_CIN})")
    _pixel_stride(x, "x")
    if not w.is_contiguous():
        raise ValueError("conv3x3: w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3: x and w must start on a 16-byte boundary")
    for name, v in (("the bias", b), ("scale", scale), ("shift", shift)):
        if v is not None and (v.dtype != x.dtype or tuple(v.shape) != (cout,) or not v.is_contiguous()):
            raise ValueError(f"conv3x3: {name} must be a contiguous ({cout},) {x.dtype} (got {tuple(v.shape)} {v.dtype})")
    if slope is not None and not isinstance(slope, (int, float)):
        raise ValueError(f"conv3x3: slope must be a number or None (got {type(slope).__name__})")
    if not isinstance(silu, bool):
        raise ValueError(f"conv3x3: silu must be a bool (got {silu!r})")
    if silu and slope is not None:
        raise ValueError("conv3x3: one activation at most: silu and a leaky ReLU slope were both given")
    want = (n, h, wd, cout)
    for name, r, s in (("r1", r1, s1), ("r2", r2, s2)):
        if r is None:
            if s != 1.0:
                raise ValueError(f"conv3x3: s{name[1]} = {s} is given without the residual {name}")
            continue
        if tuple(r.shape) != want or r.dtype != x.dtype:
            raise ValueError(f"conv3x3: the residual {name} must be {want} {x.dtype} (got {tuple(r.shape)} {r.dtype})")
        _pixel_stride(r, name)
    if out is not None:
        if tuple(out.shape) != want or out.dtype != x.dtype:
            raise ValueError(f"conv3x3: out must be {want} {x.dtype} (got {tuple(out.shape)} {out.dtype})")
        _pixel_stride(out, "out")
        if _overlap(x, out):
            raise ValueError("conv3x3: out overlaps x's channels in the same buffer")
    others = [t for t in (b, scale, shift, r1, r2, out) if t is not None]
    if not (x.is_cuda and w.device == x.device and all(t.device == x.device for t in others)):
        raise ValueError(
            f"conv3x3: x, w and the epilogue's tensors must lie on one CUDA device "
            f"(got {x.device}, {w.device}, {[str(t.device) for t in others]})"
        )


def conv3x3(x, w, b=None, *, scale=None, shift=None, silu=False, slope=None, r1=None, s1=1.0, r2=None, s2=1.0,
            out=None):
    """3x3 stride-1 pad-1 conv with the epilogue ``r2 + s2 * act(r1 + s1 *
    (scale * (conv + b) + shift))`` (see the module docstring). x: (N, H, W,
    Cin), w: (Cout, Cin, 3, 3), b, scale and shift: (Cout,) or None, slope:
    leaky ReLU's slope or None, silu: SiLU as the activation (not with a
    slope), r1 and r2: (N, H, W, Cout) or None, out: (N, H, W, Cout) or None;
    x, r1, r2 and out may be channel views of wider buffers. Returns (N, H,
    W, Cout) in x's type: ``out`` when given, written in place."""
    global launches
    epilogue = dict(scale=scale, shift=shift, silu=silu, slope=slope, r1=r1, s1=s1, r2=r2, s2=s2, out=out)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_plain(x, w, b, **epilogue)
    _check(x, w, b, **epilogue)
    from .build import load_library

    lib = load_library()
    n, h, wd, cin = x.shape
    cout = w.shape[0]
    if out is None:
        out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    ps = lambda t: 0 if t is None else t.stride(2)  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        act = 2 if silu else int(slope is not None)
        err = lib.vtt_conv3x3_fwd(
            x.data_ptr(), x.stride(2), w.data_ptr(), ptr(b), ptr(scale), ptr(shift), out.data_ptr(), out.stride(2),
            ptr(r1), ps(r1), float(s1), ptr(r2), ps(r2), float(s2),
            act, float(slope or 0.0), n, h, wd, cin, cout, _DTYPES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3: kernel launch failed with cudaError {err}")
    with _count_lock:
        launches += 1
    return out
