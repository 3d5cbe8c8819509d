"""Fused mask-free attention on Hopper, and its plain PyTorch version.

``flash_attention`` replaces the Pallas kernel ``_attn_kernel`` at
vision_tpu/ops/pallas/flash_attention.py:26 (launched by ``_flash_attention``
through ``pl.pallas_call``); its consumer on the port's path is DINOv2's
global attention inside Depth-Anything V2 (models/dino.py), at head dim 64,
and SAM3's four global RoPE layers (models/sam3.py), at head dim 80.

The kernel (csrc/flash_attention.cu) cannot hold a whole K/V row the way the
Pallas kernel holds it in VMEM: a 518x728 request's 1925 keys at D = 64,
bf16, make a 493 KB row against 227 KB of shared memory per block. It tiles
K/V with an online softmax instead. In bf16 it is bound by operations (~700
FLOP per byte at the Depth-Anything shapes; at D = 64 the softmax's ex2 and
FP32 work weighs as much as the products), so it is built for Hopper's
tensor cores: one block per (128-row q tile, b*h) of two consumer
warpgroups and a producer warp; K/V tiles of 128 keys arrive by TMA into a
4-stage mbarrier ring while earlier tiles are multiplied; S = Q K^T and
O += P V run as wgmma, P from registers and V read as MN-major, so nothing
is transposed; the two warpgroups take turns on the tensor cores, so one's
softmax (one FFMA and one ex2 a logit) overlaps the other's products. At
head dim 80 each tile is five 16-column boxes at 32-byte swizzle: one k16
step of Q K^T a box, and P V one wgmma of N 80. f32 (the CPU-parity type)
runs as FMA loops.

The wrapper calls the operator ``vtt::flash_attention`` (ops/cuda/library.py):
on CPU tensors its implementation is :func:`flash_attention_plain`, on CUDA
tensors :func:`launch`, which runs the kernel or raises. ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import threading

import torch

from . import count_launch

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_plain", "launches"]

launches = 0
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)  # the kernel's instances; attention_route sends no other to it


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The Pallas body in plain PyTorch: f32 logits and softmax, ``p`` cast
    to v's dtype, PV accumulated in f32, output in q's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take. The device is checked last,
    so every other rule can be shown on CPU tensors."""
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtype must be float32 or bfloat16 for all of q, k, v "
                         f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, T, D)")
    b, h, tq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree"
        )
    if tq == 0 or k.shape[2] == 0 or not 0 < b * h <= 65535:
        raise ValueError(f"flash_attention: empty or oversized problem {tuple(q.shape)} x {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start on a 16-byte boundary")
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q, k, v must lie on one CUDA device "
            f"(got {q.device}, {k.device}, {v.device})"
        )


def flash_attention(q, k, v, scale: float | None = None, mask=None) -> torch.Tensor:
    """Fused softmax(q k^T * scale) v. q: (B, H, Tq, D), k, v: (B, H, Tk, D);
    returns (B, H, Tq, D) in q's dtype, through the operator
    ``vtt::flash_attention`` (ops/cuda/library.py).

    The kernel supports NO mask (its consumers are mask-free global
    attentions; attention_core routes masked shapes elsewhere), so a mask
    raises rather than being silently ignored."""
    if mask is not None:
        raise ValueError(
            "flash_attention does not support masks; use attention_core (it routes "
            "masked shapes to the plain paths)"
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.ops.vtt.flash_attention(q, k, v, float(scale))


def launch(q, k, v, scale: float) -> torch.Tensor:
    """The kernel on CUDA tensors (the operator's CUDA implementation):
    check, launch on the current stream, count."""
    _check(q, k, v)
    from .build import load_library

    lib = load_library()
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, tq, k.shape[2], d, _DTYPES[q.dtype], float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with cudaError {err}")
    count_launch(__name__, launches=1)
    return out
