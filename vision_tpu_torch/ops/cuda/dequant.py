"""Block dequantization of an int8-resident weight on Hopper, and its plain
PyTorch version.

``dequant`` turns a weight that quantized residency keeps on the card as
int8 levels and per-32-block f32 scales (and minimums, for Q4_1 and Q5_1)
back into its canonical float tensor: ``q * scale (+ minv)`` in f32,
reshaped to the file's shape, permuted to the canonical layout, cast to
bf16 or f32, contiguous. It implements the JAX package's
``QuantResident.dequant`` (vision_tpu/core/quant.py), which XLA fuses into
the consumer of the weight inside the jitted graph; there is no Pallas
kernel behind it. The plain form takes five passes over f32 intermediates
(cast, scale, minimum, permute, cast); the kernel (csrc/dequant.cu) one,
bound by bytes: 1.125 bytes an element read (1.25 with minimums), 2 (bf16)
or 4 (f32) written.

A CPU tensor goes to :func:`dequant_plain`; a CUDA tensor goes to the
kernel or raises. The result is always a fresh contiguous tensor (the conv
and deformable-conv kernels take only contiguous weights). ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import count_launch

__all__ = ["BLOCK", "dequant", "dequant_plain", "launches"]

launches = 0
_count_lock = threading.Lock()

BLOCK = 32  # elements a scale (and minimum) covers
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _out_shape(file_shape: tuple, permute: tuple | None) -> tuple:
    return tuple(file_shape) if permute is None else tuple(file_shape[i] for i in permute)


def dequant_plain(q: torch.Tensor, scale: torch.Tensor, minv: torch.Tensor | None, file_shape: tuple,
                  permute: tuple | None, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's dequant in plain PyTorch: the int8 levels cast to
    f32, times their block's scale, plus its minimum where there is one,
    reshaped to ``file_shape``, permuted by ``permute``, cast to ``dtype``;
    a fresh contiguous tensor."""
    v = q.reshape(-1, BLOCK).to(torch.float32) * scale[:, None]
    if minv is not None:
        v = v + minv[:, None]
    v = v.reshape(tuple(file_shape))
    if permute is not None:
        v = v.permute(tuple(permute))
    return v.to(dtype).contiguous()


def _check(q, scale, minv, file_shape, permute, dtype) -> int:
    """Raise on what the kernel does not take; return n. The device is
    checked last, so every other rule can be shown on CPU tensors."""
    n = q.numel()
    if q.dtype != torch.int8 or scale.dtype != torch.float32 or (minv is not None and minv.dtype != torch.float32):
        raise ValueError(f"dequant: q must be int8 and scale, minv float32 (got {q.dtype}, {scale.dtype}, "
                         f"{None if minv is None else minv.dtype})")
    if dtype not in _DTYPES:
        raise ValueError(f"dequant: output dtype must be float32 or bfloat16 (got {dtype})")
    if n == 0 or n % BLOCK or n >= 2**31 or math.prod(file_shape) != n:
        raise ValueError(f"dequant: {n} levels for file shape {tuple(file_shape)} (a nonzero multiple of {BLOCK} "
                         f"below 2^31 is needed)")
    if scale.numel() != n // BLOCK or (minv is not None and minv.numel() != n // BLOCK):
        raise ValueError(f"dequant: {n // BLOCK} blocks need as many scales (and minimums), got {scale.numel()}"
                         f"{'' if minv is None else f' and {minv.numel()}'}")
    if len(file_shape) > 4:
        raise ValueError(f"dequant: at most 4 dims (file shape {tuple(file_shape)})")
    if permute is not None and sorted(permute) != list(range(len(file_shape))):
        raise ValueError(f"dequant: {tuple(permute)} is no permutation of {len(file_shape)} dims")
    tensors = [t for t in (q, scale, minv) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dequant: q, scale and minv must be contiguous")
    if q.data_ptr() % 16:
        raise ValueError("dequant: q must start on a 16-byte boundary")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"dequant: q, scale and minv must lie on one CUDA device (got "
                         f"{', '.join(str(t.device) for t in tensors)})")
    return n


def _source_strides(file_shape: tuple, permute: tuple) -> tuple[list[int], list[int]]:
    """The output's shape and, for each of its dims, the source offset of one
    step along it, each padded to 4 dims with leading (1, 0)."""
    fstride = [math.prod(file_shape[i + 1:]) for i in range(len(file_shape))]
    shape = [file_shape[i] for i in permute]
    stride = [fstride[i] for i in permute]
    pad = 4 - len(shape)
    return [1] * pad + shape, [0] * pad + stride


def dequant(q: torch.Tensor, scale: torch.Tensor, minv: torch.Tensor | None, file_shape: tuple,
            permute: tuple | None, dtype: torch.dtype) -> torch.Tensor:
    """The canonical tensor of an int8-resident weight: ``q`` int8 (n,) in
    the file's C order, ``scale`` f32 (n / 32,), ``minv`` f32 (n / 32,) or
    None, ``file_shape`` the file's C-order shape (at most 4 dims),
    ``permute`` the transpose to the canonical layout or None; returns a
    fresh contiguous tensor of the canonical shape in ``dtype`` (float32 or
    bfloat16 on the card), on q's device."""
    if all(t is None or t.device.type == "cpu" for t in (q, scale, minv)):
        return dequant_plain(q, scale, minv, file_shape, permute, dtype)
    n = _check(q, scale, minv, file_shape, permute, dtype)
    from .build import load_library

    lib = load_library()
    out = torch.empty(_out_shape(file_shape, permute), dtype=dtype, device=q.device)
    identity = permute is None or tuple(permute) == tuple(range(len(file_shape)))
    shape, stride = _source_strides(tuple(file_shape), tuple(permute or range(len(file_shape))))
    c_shape, c_stride = (ctypes.c_int * 4)(*shape), (ctypes.c_int * 4)(*stride)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vtt_dequant_fwd(
            q.data_ptr(), scale.data_ptr(), None if minv is None else minv.data_ptr(), out.data_ptr(), n,
            c_shape, c_stride, int(identity), _DTYPES[dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"dequant: kernel launch failed with cudaError {err}")
    count_launch(__name__, launches=1)
    return out
