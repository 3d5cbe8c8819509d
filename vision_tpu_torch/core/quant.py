"""Quantized weight residency — the port of vision_tpu/core/quant.py.

The reference's ggml runtime computes directly from quantized blocks: a Q8_0
model stays ~1 byte an element in memory (src/visp/ml.cpp:283-360). Here,
as in the JAX package, a block-quantized tensor stays on the device as int8
levels and per-32-block f32 scales (and minimums for Q4_1 / Q5_1), ~1.125
bytes an element against 2 for bf16, and is dequantized at each use. The
JAX package emits that dequant inside the jitted graph, where XLA fuses it
into the consumer; the port has no such fusion, so on the card it is one
hand-written kernel a weight (ops/cuda/dequant.py) that writes the
canonical tensor in one pass, recorded into the forward's CUDA graph like
every other launch. The numbers are the expanded load's, bit for bit: the
same f32 product and sum, the same round-to-nearest-even cast.

``Params.find`` (core/params.py) dequantizes transparently, so model code
is unchanged. Seven GGUF block formats reduce exactly to this form: the
five legacy 32-block ones plus IQ4_NL / IQ4_XS, whose non-linear grid
values are int8 and whose scales are per-32 (gguf.py ``_RESIDENT_TYPES``).
K-quants expand at load instead.

A :class:`QuantResident` holds numpy arrays between ``load_weights(...,
as_numpy=True)`` and the move to the device (``to``, which
``weights.params_from_numpy`` calls), and torch tensors after.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from .errors import raise_error

__all__ = ["QuantResident", "is_quant", "quantize_resident", "quantize_store", "store_nbytes"]

_BLOCK = 32

# canonical conv-kernel-size set for the is_conv_2d shape heuristic
# (reference convert.py:110-117); weights.py and convert/convert.py import
# it from here so the three layout paths can never desync
_CONV_KERNEL_SIZES = (1, 3, 4, 7, 14)


def _tensor(a) -> torch.Tensor | None:
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclass(frozen=True)
class QuantResident:
    """A block-quantized tensor kept in integer form.

    ``q``: int8 levels, flat ``(n,)`` in FILE-layout C order.
    ``scale``: f32 ``(n // 32,)`` per-block scales.
    ``minv``: f32 per-block minimums for affine formats (Q4_1/Q5_1), or None.
    ``file_shape``: C-order shape the flat data reshapes to.
    ``permute``: transpose applied after reshape (cwhn un-permute), or None.
    ``dtype``: the torch dtype the dequant casts to.
    """

    q: Any
    scale: Any
    minv: Any
    file_shape: tuple
    permute: tuple | None
    dtype: torch.dtype

    # -- array-like surface so shape-sniffing code works untouched --
    @property
    def shape(self) -> tuple:
        if self.permute is None:
            return self.file_shape
        return tuple(self.file_shape[i] for i in self.permute)

    @property
    def ndim(self) -> int:
        return len(self.file_shape)

    @property
    def nbytes(self) -> int:
        n = int(self.q.nbytes) + int(self.scale.nbytes)
        if self.minv is not None:
            n += int(self.minv.nbytes)
        return n

    def dequant(self) -> torch.Tensor:
        """The canonical tensor in ``dtype``, fresh and contiguous: the
        kernel for CUDA tensors (which raises rather than fall back), the
        plain form for CPU ones."""
        # imported here: the ops package imports core (params) itself
        from ..ops.cuda.dequant import dequant as _dequant

        return _dequant(_tensor(self.q), _tensor(self.scale), _tensor(self.minv), self.file_shape, self.permute,
                        self.dtype)

    def astype(self, dtype: torch.dtype) -> "QuantResident":
        """Retarget the dequant dtype (cheap: metadata only)."""
        return replace(self, dtype=dtype)

    def to(self, device: torch.device | str) -> "QuantResident":
        """Move the integer payload to ``device`` (the counterpart of the JAX
        package's ``put``): q, scale and minv go there once, at load, and a
        forward makes no copy from the host."""
        return replace(
            self,
            q=_tensor(self.q).to(device),
            scale=_tensor(self.scale).to(device),
            minv=None if self.minv is None else _tensor(self.minv).to(device),
        )

    def unpermute_cwhn(self, name: str, trusted: bool = False) -> "QuantResident":
        """Resident analog of weights.unpermute_cwhn (same shape heuristics;
        ``trusted`` = named by the file's conv2d_weights list, which
        overrides the kernel-size gate)."""
        s = self.file_shape
        if self.permute is not None:
            return self
        if trusted:
            if len(s) != 4:
                raise_error("conv2d_weights names non-4D tensor '{}' ({}D)", name, len(s))
            if s[2] == 1 and s[0] == s[1]:
                return replace(self, permute=(3, 2, 0, 1))  # (H,W,1,C) -> (C,1,H,W)
            return replace(self, permute=(0, 3, 1, 2))  # (O,H,W,I) -> (O,I,H,W)
        if len(s) != 4 or not name.endswith("weight"):
            return self
        if s[2] == 1 and s[0] == s[1] and s[0] in _CONV_KERNEL_SIZES:
            return replace(self, permute=(3, 2, 0, 1))  # (H,W,1,C) -> (C,1,H,W)
        if s[1] == s[2] and s[1] in _CONV_KERNEL_SIZES:
            return replace(self, permute=(0, 3, 1, 2))  # (O,H,W,I) -> (O,I,H,W)
        return self


def is_quant(v: Any) -> bool:
    return isinstance(v, QuantResident)


def quantize_resident(a: np.ndarray, dtype: torch.dtype = torch.bfloat16) -> QuantResident:
    """Q8_0-style absmax quantization of a float array into residency form
    (numpy-backed; ``to`` moves it). Halves any model's device footprint at
    load with no file change (the file-side analog is the converter's
    quantized output)."""
    from .gguf import q8_0_block_levels

    a = np.asarray(a, np.float32)
    q, scale = q8_0_block_levels(a)  # raises on a non-multiple-of-32 size
    return QuantResident(q.reshape(-1), scale, None, tuple(a.shape), None, dtype)


def _is_float(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_floating_point()
    dt = np.dtype(getattr(v, "dtype", np.dtype("O")))
    # ml_dtypes' bfloat16 is not a numpy floating subtype
    return np.issubdtype(dt, np.floating) or dt.name == "bfloat16"


def _size(v) -> int:
    return v.numel() if isinstance(v, torch.Tensor) else int(getattr(v, "size", 0))


def quantize_store(
    params: dict, dtype: torch.dtype = torch.bfloat16, min_elements: int = 4096, skip=("positional",)
) -> dict:
    """Quantize every large float tensor of a parameter store in memory: a
    float tensor of at least ``min_elements`` elements, a multiple of 32,
    whose name holds none of ``skip``. A torch tensor's resident goes to the
    tensor's device; a numpy array's stays numpy-backed."""
    out = {}
    for k, v in params.items():
        eligible = (
            not is_quant(v)
            and _is_float(v)
            and _size(v) >= min_elements
            and _size(v) % _BLOCK == 0
            and not any(s in k for s in skip)
        )
        if not eligible:
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = quantize_resident(v.detach().float().cpu().numpy(), dtype).to(v.device)
        else:
            out[k] = quantize_resident(np.asarray(v, np.float32), dtype)
    return out


def store_nbytes(params: dict) -> int:
    """Resident bytes of a parameter store (tensors, arrays and residents)."""
    return sum(int(v.nbytes) if hasattr(v, "nbytes") else int(np.asarray(v).nbytes) for v in params.values())
