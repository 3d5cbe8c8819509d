"""GGUF file reader/writer in pure Python + numpy.

A numpy-only copy of ``vision_tpu/core/gguf.py`` (the JAX package's module
imports jax through its package ``__init__``), without the quantized-
residency decomposition and the requantizer, which wait for the port's
quantization work. Replacement for the reference's gguf/ggml-backed
model_file (reference: src/visp/ml.cpp:203-281, include/visp/ml.h:83-103). The loader
must consume the exact .gguf files produced by the reference's
scripts/convert.py — including per-arch metadata KVs (``{arch}.image_size``
etc.), ``{arch}.tensor_data_layout``, the ``{arch}.conv2d_weights`` index
list, and string-array KVs (SAM3 tokenizer vocab/merges).

Format (GGUF v3): magic 'GGUF', version u32, n_tensors u64, n_kv u64,
KV pairs, tensor infos, alignment padding, tensor data blob. Tensor dims are
stored in ggml order: ne[0] is the fastest-varying dimension, so a C-order
numpy array's shape is ``reversed(ne)`` — we return arrays in that "torch
shape" convention, matching what the converter wrote.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from enum import IntEnum
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from .errors import raise_error

__all__ = [
    "GGMLType",
    "GGUFValueType",
    "GGUFFile",
    "GGUFWriter",
    "model_load",
    "GGUF_MAGIC",
]

GGUF_MAGIC = b"GGUF"
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ4_NL = 20
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    BF16 = 30


_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_GGML_NP_DTYPE = {
    GGMLType.F32: np.dtype(np.float32),
    GGMLType.F16: np.dtype(np.float16),
    GGMLType.I8: np.dtype(np.int8),
    GGMLType.I16: np.dtype(np.int16),
    GGMLType.I32: np.dtype(np.int32),
    GGMLType.I64: np.dtype(np.int64),
    GGMLType.F64: np.dtype(np.float64),
    # BF16 has no numpy dtype: stored as uint16, expanded on read.
    GGMLType.BF16: np.dtype(np.uint16),
}


def ggml_type_of(a: np.ndarray) -> GGMLType:
    m = {
        np.dtype(np.float32): GGMLType.F32,
        np.dtype(np.float16): GGMLType.F16,
        np.dtype(np.int8): GGMLType.I8,
        np.dtype(np.int16): GGMLType.I16,
        np.dtype(np.int32): GGMLType.I32,
        np.dtype(np.int64): GGMLType.I64,
        np.dtype(np.float64): GGMLType.F64,
    }
    dt = np.dtype(a.dtype)
    if str(dt) == "bfloat16":
        return GGMLType.BF16
    if dt not in m:
        raise_error("unsupported numpy dtype for gguf: {}", dt)
    return m[dt]


def bf16_to_f32(raw_u16: np.ndarray) -> np.ndarray:
    return (raw_u16.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 (stored as uint16), NaN-safe (the
    rounding carry would otherwise overflow a NaN's exponent into +-0)."""
    a = np.asarray(x, np.float32)
    u = a.view(np.uint32)
    rounding = 0x7FFF + ((u >> 16) & 1)
    out = ((u + rounding) >> 16).astype(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        out = np.where(nan, ((u >> 16) | 0x0040).astype(np.uint16), out)
    return out


def dequantize_q8_0(raw: bytes, n_elements: int) -> np.ndarray:
    """Q8_0: blocks of 32 int8 values with one f16 scale (34 bytes/block)."""
    n_blocks = n_elements // 32
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * 34).reshape(n_blocks, 34)
    scales = buf[:, :2].copy().view(np.float16).astype(np.float32)
    q = buf[:, 2:].copy().view(np.int8).astype(np.float32)
    return (q * scales).reshape(-1)


def _nibbles(qs: np.ndarray) -> np.ndarray:
    """ggml nibble order: byte j of a block holds elements j (low nibble)
    and j+16 (high nibble). qs: (n_blocks, 16) u8 -> (n_blocks, 32) f32."""
    return np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.float32)


def _high_bits(qh: np.ndarray) -> np.ndarray:
    """Q5 high bits: little-endian u32 per block, bit i belongs to element i.
    qh: (n_blocks, 4) u8 -> (n_blocks, 32) f32 in {0, 16}."""
    bits = np.unpackbits(qh, axis=1, bitorder="little").astype(np.float32)
    return bits * 16.0


def dequantize_q4_0(raw: bytes, n_elements: int) -> np.ndarray:
    """Q4_0: f16 scale + 16 nibble bytes (18 bytes / 32 elements);
    v = (q - 8) * d."""
    n_blocks = n_elements // 32
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * 18).reshape(n_blocks, 18)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)
    return ((_nibbles(buf[:, 2:]) - 8.0) * d).reshape(-1)


def dequantize_q4_1(raw: bytes, n_elements: int) -> np.ndarray:
    """Q4_1: f16 scale + f16 min + 16 nibble bytes (20 bytes / 32);
    v = q * d + m."""
    n_blocks = n_elements // 32
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * 20).reshape(n_blocks, 20)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)
    m = buf[:, 2:4].copy().view(np.float16).astype(np.float32)
    return (_nibbles(buf[:, 4:]) * d + m).reshape(-1)


def dequantize_q5_0(raw: bytes, n_elements: int) -> np.ndarray:
    """Q5_0: f16 scale + u32 high bits + 16 nibble bytes (22 bytes / 32);
    v = ((qh_i << 4 | q_i) - 16) * d."""
    n_blocks = n_elements // 32
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * 22).reshape(n_blocks, 22)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)
    q = _nibbles(buf[:, 6:]) + _high_bits(buf[:, 2:6])
    return ((q - 16.0) * d).reshape(-1)


def dequantize_q5_1(raw: bytes, n_elements: int) -> np.ndarray:
    """Q5_1: f16 scale + f16 min + u32 high bits + 16 nibble bytes
    (24 bytes / 32); v = (qh_i << 4 | q_i) * d + m."""
    n_blocks = n_elements // 32
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * 24).reshape(n_blocks, 24)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)
    m = buf[:, 2:4].copy().view(np.float16).astype(np.float32)
    q = _nibbles(buf[:, 8:]) + _high_bits(buf[:, 4:8])
    return (q * d + m).reshape(-1)


# -- K-quants (super-blocks of 256; llama.cpp "Q4_K_M"-class files). The
# reference reads these through ggml's dequantize_row_q*_K; the layouts
# below mirror ggml-quants.c exactly. Dequant-only: our converter and the
# requantize verb emit q8_0, but user-supplied K-quant GGUFs must load. --


def _k_scale_min(scales12: np.ndarray):
    """Unpack the 12-byte table of 8 (scale, min) 6-bit pairs used by
    Q4_K/Q5_K (ggml get_scale_min_k4): pairs 0-3 live in the low 6 bits of
    bytes j / j+4; pairs 4-7 split across the nibbles of bytes j+4 and the
    high 2 bits of bytes j-4 / j."""
    q = scales12
    sc = np.empty((q.shape[0], 8), np.float32)
    mn = np.empty((q.shape[0], 8), np.float32)
    for j in range(4):
        sc[:, j] = q[:, j] & 63
        mn[:, j] = q[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (q[:, j + 4] & 0x0F) | ((q[:, j - 4] >> 6) << 4)
        mn[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, mn


def dequantize_q4_k(raw: bytes, n_elements: int) -> np.ndarray:
    """Q4_K: d/dmin f16 + 12-byte 6-bit scale/min table + 128 nibble bytes
    (144 bytes / 256). Per 64-element group, 32 bytes hold the low-nibble
    sub-block then the high-nibble sub-block; v = d*sc[j]*q - dmin*mn[j]."""
    nb = n_elements // 256
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * 144).reshape(nb, 144)
    d = buf[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = buf[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _k_scale_min(buf[:, 4:16])
    q = buf[:, 16:].reshape(nb, 4, 32)
    out = np.empty((nb, 8, 32), np.float32)
    out[:, 0::2] = q & 0x0F
    out[:, 1::2] = q >> 4
    out = out * (d * sc)[:, :, None] - (dmin * mn)[:, :, None]
    return out.reshape(-1)


def dequantize_q5_k(raw: bytes, n_elements: int) -> np.ndarray:
    """Q5_K: Q4_K layout + 32 high-bit bytes (176 bytes / 256); sub-block j
    takes its fifth bit from bit j of qh[l]."""
    nb = n_elements // 256
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * 176).reshape(nb, 176)
    d = buf[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = buf[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _k_scale_min(buf[:, 4:16])
    qh = buf[:, 16:48]
    q = buf[:, 48:].reshape(nb, 4, 32)
    out = np.empty((nb, 8, 32), np.float32)
    out[:, 0::2] = q & 0x0F
    out[:, 1::2] = q >> 4
    out += ((qh[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1) * 16.0
    out = out * (d * sc)[:, :, None] - (dmin * mn)[:, :, None]
    return out.reshape(-1)


def dequantize_q2_k(raw: bytes, n_elements: int) -> np.ndarray:
    """Q2_K: 16 scale bytes (4-bit scale low / 4-bit min high) + 64 two-bit
    bytes + d/dmin f16 (84 bytes / 256); v = d*sc[s]*q - dmin*mn[s] over 16
    sub-blocks of 16, quants packed as bits (2j, 2j+1) of q-byte l within
    each 128-element half (ggml dequantize_row_q2_K)."""
    nb = n_elements // 256
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * 84).reshape(nb, 84)
    scales = buf[:, :16]
    qs = buf[:, 16:80].reshape(nb, 2, 32)  # two halves of 32 bytes
    d = buf[:, 80:82].copy().view(np.float16).astype(np.float32)
    dmin = buf[:, 82:84].copy().view(np.float16).astype(np.float32)
    shifts = np.arange(4, dtype=np.uint8) * 2
    # (nb, half, j, l): two-bit values for sub-blocks (half*4 + j)*2 + l//16
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3
    q = q.reshape(nb, 16, 16).astype(np.float32)  # 16 sub-blocks of 16
    sc = (scales & 0x0F).astype(np.float32)
    mn = (scales >> 4).astype(np.float32)
    out = q * (d * sc)[:, :, None] - (dmin * mn)[:, :, None]
    return out.reshape(-1)


def dequantize_q3_k(raw: bytes, n_elements: int) -> np.ndarray:
    """Q3_K: 32 high-bit-mask bytes + 64 two-bit bytes + 12 packed 6-bit
    scale bytes + d f16 (110 bytes / 256); v = d*(sc[s]-32) * (q - (hm?0:4))
    with sub-block s's high bit at mask bit s of hmask[l%32]
    (ggml dequantize_row_q3_K, kmask unpack)."""
    nb = n_elements // 256
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * 110).reshape(nb, 110)
    hmask = buf[:, :32]
    qs = buf[:, 32:96].reshape(nb, 2, 32)
    sc12 = buf[:, 96:108]
    d = buf[:, 108:110].copy().view(np.float16).astype(np.float32)
    # 16 6-bit signed scales (kmask unpack): scale s takes its low 4 bits
    # from byte s (s<8: low nibble) or byte s-8 (s>=8: high nibble), and its
    # high 2 bits from byte 8 + s%4 at shift 2*(s//4)
    s07_lo = sc12[:, :8] & 0x0F          # scales 0-7 low 4
    s8f_lo = sc12[:, :8] >> 4            # scales 8-15 low 4
    hi_src = sc12[:, 8:12]               # bytes c+8
    hi = np.empty((nb, 16), np.uint8)
    for s in range(16):
        byte = hi_src[:, s % 4]
        shift = 2 * (s // 4)
        hi[:, s] = (byte >> shift) & 3
    sc = np.concatenate([s07_lo, s8f_lo], axis=1).astype(np.int16) | (
        hi.astype(np.int16) << 4
    )
    sc = sc.astype(np.float32) - 32.0    # (nb, 16) signed scales
    shifts = np.arange(4, dtype=np.uint8) * 2
    q = (qs[:, :, None, :] >> shifts[None, None, :, None]) & 3  # (nb,2,4,32)
    q = q.reshape(nb, 16, 16).astype(np.float32)
    # high bit: the mask pointer never advances in ggml — sub-block s reads
    # bit s//2 (one bit per (half, j) pair, m <<= 1 eight times) of hmask
    # bytes (s%2)*16..+16; an ABSENT high bit means subtract 4
    hsel = np.empty((nb, 16, 16), np.uint8)
    for s in range(16):
        hsel[:, s] = (hmask[:, (s % 2) * 16 : (s % 2) * 16 + 16] >> (s // 2)) & 1
    q = q - np.where(hsel.astype(bool), np.float32(0.0), np.float32(4.0))
    out = q * (d * sc)[:, :, None]
    return out.reshape(-1)


def dequantize_q6_k(raw: bytes, n_elements: int) -> np.ndarray:
    """Q6_K: 128 low-nibble bytes + 64 two-bit-high bytes + 16 int8 scales
    + d f16 (210 bytes / 256); v = d * sc[l//16 + 2k] * (q - 32) with the
    ggml half-block interleave (dequantize_row_q6_K)."""
    nb = n_elements // 256
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * 210).reshape(nb, 210)
    ql = buf[:, :128].reshape(nb, 2, 64)
    qh = buf[:, 128:192].reshape(nb, 2, 32)
    sc = buf[:, 192:208].copy().view(np.int8).astype(np.float32).reshape(nb, 2, 4, 2)
    d = buf[:, 208:210].copy().view(np.float16).astype(np.float32)
    q1 = (ql[:, :, :32] & 0x0F) | (((qh >> 0) & 3) << 4)
    q2 = (ql[:, :, 32:] & 0x0F) | (((qh >> 2) & 3) << 4)
    q3 = (ql[:, :, :32] >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (ql[:, :, 32:] >> 4) | (((qh >> 6) & 3) << 4)
    q = np.stack([q1, q2, q3, q4], axis=2).astype(np.float32) - 32.0  # (nb,2,4,32)
    out = q * np.repeat(sc, 16, axis=3) * d[:, :, None, None]
    return out.reshape(-1)


def dequantize_q8_k(raw: bytes, n_elements: int) -> np.ndarray:
    """Q8_K: f32 scale + 256 int8 + 16 int16 group sums (292 bytes / 256);
    v = d * q. The bsums are a dot-product aid ggml ignores on dequant."""
    nb = n_elements // 256
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * 292).reshape(nb, 292)
    d = buf[:, 0:4].copy().view(np.float32)
    q = buf[:, 4:260].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


# The IQ4 non-linear 4-bit level table (ggml kvalues_iq4nl): 16 hand-tuned
# int8 values replacing the uniform (q-8) grid — denser near zero where
# gaussian weights concentrate. IQ4_NL/IQ4_XS are the only IQ formats whose
# layout is fully determined by this public table; the codebook formats
# (IQ1_*/IQ2_*/IQ3_*) depend on large trained lattice grids that cannot be
# derived from the format spec, so this reader intentionally rejects them.
_IQ4_KVALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32,
)


def _iq4_nl_unpack(raw: bytes, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """IQ4_NL payload -> (d f32 (nb, 1), kvalue indices (nb, 32)) — the one
    unpack shared by the IQ4 dequantizers."""
    n_blocks = n_elements // 32
    buf = np.frombuffer(raw, dtype=np.uint8, count=n_blocks * 18).reshape(n_blocks, 18)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)
    idx = np.concatenate([buf[:, 2:] & 0x0F, buf[:, 2:] >> 4], axis=1)
    return d, idx


def _iq4_xs_unpack(raw: bytes, n_elements: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IQ4_XS payload -> (d f32 (nb, 1), sub-block scales ls (nb, 8),
    kvalue indices (nb, 8, 32)); shared like :func:`_iq4_nl_unpack`."""
    nb = n_elements // 256
    buf = np.frombuffer(raw, dtype=np.uint8, count=nb * 136).reshape(nb, 136)
    d = buf[:, :2].copy().view(np.float16).astype(np.float32)  # (nb, 1)
    sh = buf[:, 2:4].copy().view(np.uint16).astype(np.uint32)  # (nb, 1)
    sl = buf[:, 4:8]  # (nb, 4)
    ib = np.arange(8)
    lo = (sl[:, ib // 2] >> (4 * (ib % 2))) & 0x0F  # (nb, 8)
    hi = (sh >> (2 * ib)) & 3
    ls = (lo | (hi << 4)).astype(np.float32) - 32.0  # (nb, 8)
    qs = buf[:, 8:].reshape(nb, 8, 16)
    idx = np.concatenate([qs & 0x0F, qs >> 4], axis=2)  # (nb, 8, 32)
    return d, ls, idx


def dequantize_iq4_nl(raw: bytes, n_elements: int) -> np.ndarray:
    """IQ4_NL: f16 scale + 16 nibble bytes (18 bytes / 32 elements);
    v = d * kvalues[q] with the q4_0 nibble order."""
    d, idx = _iq4_nl_unpack(raw, n_elements)
    return (_IQ4_KVALUES[idx] * d).reshape(-1)


def dequantize_iq4_xs(raw: bytes, n_elements: int) -> np.ndarray:
    """IQ4_XS super-block (136 bytes / 256): f16 d + u16 scales_h +
    4x u8 scales_l + 128 nibble bytes. Sub-block ib (32 elems) scale is the
    6-bit ls = scales_l nibble | (scales_h 2-bit << 4), value d*(ls-32);
    nibble order within each sub-block matches q4_0."""
    d, ls, idx = _iq4_xs_unpack(raw, n_elements)
    return (_IQ4_KVALUES[idx] * (d[:, :, None] * ls[:, :, None])).reshape(-1)


# ggml_type -> (dequant fn, elements per block, bytes per block)
_DEQUANTIZE = {
    GGMLType.Q4_0: (dequantize_q4_0, 32, 18),
    GGMLType.Q4_1: (dequantize_q4_1, 32, 20),
    GGMLType.Q5_0: (dequantize_q5_0, 32, 22),
    GGMLType.Q5_1: (dequantize_q5_1, 32, 24),
    GGMLType.Q8_0: (dequantize_q8_0, 32, 34),
    GGMLType.Q2_K: (dequantize_q2_k, 256, 84),
    GGMLType.Q3_K: (dequantize_q3_k, 256, 110),
    GGMLType.Q4_K: (dequantize_q4_k, 256, 144),
    GGMLType.Q5_K: (dequantize_q5_k, 256, 176),
    GGMLType.Q6_K: (dequantize_q6_k, 256, 210),
    GGMLType.Q8_K: (dequantize_q8_k, 256, 292),
    GGMLType.IQ4_NL: (dequantize_iq4_nl, 32, 18),
    GGMLType.IQ4_XS: (dequantize_iq4_xs, 256, 136),
}


class _RawBlob:
    """Pre-encoded tensor payload for GGUFWriter.add_raw_tensor."""

    def __init__(self, shape: tuple[int, ...], blob: bytes):
        self.shape = shape
        self.blob = blob

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # torch/C-order shape (reversed ne)
    ggml_type: GGMLType
    offset: int  # relative to data section start

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def n_bytes(self) -> int:
        if self.ggml_type in _DEQUANTIZE:
            _, block_elems, block_bytes = _DEQUANTIZE[self.ggml_type]
            return (self.n_elements // block_elems) * block_bytes
        if self.ggml_type == GGMLType.Q8_1:  # readable span; dequant unsupported
            return (self.n_elements // 32) * 36
        if self.ggml_type not in _GGML_NP_DTYPE:
            raise_error("unsupported ggml tensor type: {}", getattr(self.ggml_type, "name", self.ggml_type))
        return self.n_elements * _GGML_NP_DTYPE[self.ggml_type].itemsize


def _read_string(f: BinaryIO, limit: int) -> str:
    """``limit``: total file size — a declared length past it means a corrupt
    header; raising ValueError (caught by the open-time handler) beats
    letting f.read(n) attempt a ~2^50-byte allocation (MemoryError/OOM)."""
    (n,) = struct.unpack("<Q", f.read(8))
    if n > limit:
        raise ValueError(f"string length {n} exceeds file size {limit}")
    return f.read(n).decode("utf-8")


def _read_array(f: BinaryIO, limit: int) -> tuple[GGUFValueType, list]:
    """ARRAY payload: element type + count + values; etype returned so the
    reader can record it for faithful rewrites."""
    etype = GGUFValueType(struct.unpack("<I", f.read(4))[0])
    (count,) = struct.unpack("<Q", f.read(8))
    if count > limit:  # every element occupies >= 1 byte in the file
        raise ValueError(f"array count {count} exceeds file size {limit}")
    if etype in _SCALAR_FMT and etype != GGUFValueType.BOOL:
        fmt = _SCALAR_FMT[etype]
        size = struct.calcsize(fmt)
        data = f.read(size * count)
        return etype, (list(struct.unpack(f"<{count}{fmt[-1]}", data)) if count else [])
    return etype, [_read_value(f, etype, limit) for _ in range(count)]


def _read_value(f: BinaryIO, vtype: GGUFValueType, limit: int) -> Any:
    if vtype == GGUFValueType.STRING:
        return _read_string(f, limit)
    if vtype == GGUFValueType.ARRAY:
        return _read_array(f, limit)[1]
    fmt = _SCALAR_FMT[vtype]
    (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
    return v


# general.file_type (the gguf LLAMA_FTYPE_* convention) -> the float type:
# f32, f16, bf16 and the block types of the JAX package's requantizer
# (vision_tpu/core/gguf.py REQUANTIZE_TYPES)
_FILE_TYPES = {
    0: GGMLType.F32, 1: GGMLType.F16, 2: GGMLType.Q4_0, 3: GGMLType.Q4_1, 7: GGMLType.Q8_0, 8: GGMLType.Q5_0,
    9: GGMLType.Q5_1, 10: GGMLType.Q2_K, 11: GGMLType.Q3_K, 14: GGMLType.Q4_K, 16: GGMLType.Q5_K,
    18: GGMLType.Q6_K, 25: GGMLType.IQ4_NL, 30: GGMLType.IQ4_XS, 32: GGMLType.BF16,
}


class GGUFFile:
    """Parsed GGUF file: metadata KV dict + lazily-readable tensors.

    Mirrors the reference model_file API (ml.h:85-100): ``arch()``,
    ``float_type()``, ``tensor_layout()``, typed KV getters.
    """

    def __init__(self, path: str | Path):
        self.path = str(path)
        self.metadata: dict[str, Any] = {}
        self.kv_types: dict[str, tuple[GGUFValueType, GGUFValueType | None]] = {}
        self.tensors: dict[str, TensorInfo] = {}
        with open(path, "rb") as f:
            f.seek(0, 2)
            file_size = f.tell()
            f.seek(0)
            magic = f.read(4)
            if magic != GGUF_MAGIC:
                raise_error("{}: not a GGUF file (bad magic)", self.path)
            try:
                (self.version,) = struct.unpack("<I", f.read(4))
                if self.version < 2:
                    raise_error("{}: unsupported GGUF version {}", self.path, self.version)
                n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
                if n_tensors > file_size or n_kv > file_size:
                    raise ValueError(f"header counts {n_tensors}/{n_kv} exceed file size")
                for _ in range(n_kv):
                    key = _read_string(f, file_size)
                    vtype = GGUFValueType(struct.unpack("<I", f.read(4))[0])
                    # record the stored type (for arrays, the element type
                    # too) so a read -> rewrite preserves
                    # f64 / u64 / i64 KVs instead of re-deriving a narrower
                    # type from the Python value
                    if vtype == GGUFValueType.ARRAY:
                        etype, val = _read_array(f, file_size)
                        self.kv_types[key] = (vtype, etype)
                        self.metadata[key] = val
                    else:
                        self.kv_types[key] = (vtype, None)
                        self.metadata[key] = _read_value(f, vtype, file_size)
                infos = []
                for _ in range(n_tensors):
                    name = _read_string(f, file_size)
                    (n_dims,) = struct.unpack("<I", f.read(4))
                    if n_dims > 8:  # GGML_MAX_DIMS is 4; a huge count = corruption
                        raise ValueError(f"tensor '{name}' claims {n_dims} dims")
                    ne = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                    (type_int,) = struct.unpack("<I", f.read(4))
                    try:
                        ggml_type = GGMLType(type_int)
                    except ValueError:
                        # type this reader doesn't know (e.g. an IQ format):
                        # the file still opens; reading THAT tensor errors
                        ggml_type = type_int  # type: ignore[assignment]
                    (offset,) = struct.unpack("<Q", f.read(8))
                    infos.append(TensorInfo(name, tuple(reversed(ne)), ggml_type, offset))
            except (struct.error, ValueError, UnicodeDecodeError, MemoryError, OverflowError) as e:
                raise_error("{}: corrupt GGUF header (truncated?): {}", self.path, e)
            align = self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT)
            try:
                align = int(align)
            except (TypeError, ValueError):
                align = 0
            if align < 1:
                raise_error(
                    "{}: invalid general.alignment {!r} (need a positive integer)",
                    self.path, self.metadata.get("general.alignment"),
                )
            self.alignment = align
            pos = f.tell()
            self.data_offset = (pos + self.alignment - 1) // self.alignment * self.alignment
        for info in infos:
            self.tensors[info.name] = info
        # validate tensor spans up front: a truncated or corrupt file fails
        # here with a clear error instead of a reshape error mid-load. Spans
        # of enum-known but unreadable types (e.g. Q8_K) are skipped — such a
        # file still opens; only reading THAT tensor errors.
        avail = max(file_size - self.data_offset, 0)
        if infos and avail == 0:
            raise_error("{}: file ends before the tensor data section (truncated?)", self.path)
        for info in infos:
            try:
                need = info.n_bytes
            except Exception:
                continue  # unsupported type: fails at tensor() access instead
            blk = _DEQUANTIZE[info.ggml_type][1] if info.ggml_type in _DEQUANTIZE else 1
            if info.n_elements % blk:
                raise_error(
                    "{}: tensor '{}' has {} elements, not a multiple of the "
                    "{}-element {} block",
                    self.path, info.name, info.n_elements, blk, info.ggml_type.name,
                )
            if info.offset + need > avail:
                raise_error(
                    "{}: tensor '{}' spans past end of file (truncated?): "
                    "needs {} bytes at offset {}, data section has {}",
                    self.path, info.name, need, info.offset, avail,
                )
        # Memory-map the data section once; individual tensors are zero-copy
        # views (cast/permute happens at device transfer, see weights.py).
        # A metadata-only file (zero tensors) may legitimately end before
        # the aligned data offset — nothing to map.
        if avail > 0:
            self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r", offset=self.data_offset)
        else:
            self._mmap = np.zeros(0, np.uint8)

    # -- metadata accessors (reference ml.cpp:219-281) --

    @property
    def arch(self) -> str:
        return str(self.metadata.get("general.architecture", ""))

    @property
    def float_type(self) -> GGMLType:
        return _FILE_TYPES.get(int(self.metadata.get("general.file_type", 0)), GGMLType.F32)

    @property
    def tensor_layout(self) -> str:
        return str(self.metadata.get(f"{self.arch}.tensor_data_layout", ""))

    def conv2d_weight_indices(self) -> list[int]:
        """Indices (into tensor order) of conv weights needing layout permute
        (reference find_conv2d_weight_indices, ml.cpp:435-445)."""
        return [int(i) for i in self.metadata.get(f"{self.arch}.conv2d_weights", [])]

    def get_int(self, key: str, default: int | None = None) -> int:
        if key not in self.metadata:
            if default is not None:
                return default
            raise_error("{}: missing metadata key '{}'", self.path, key)
        return int(self.metadata[key])

    def get_float(self, key: str, default: float | None = None) -> float:
        if key not in self.metadata:
            if default is not None:
                return default
            raise_error("{}: missing metadata key '{}'", self.path, key)
        return float(self.metadata[key])

    def get_string(self, key: str, default: str | None = None) -> str:
        if key not in self.metadata:
            if default is not None:
                return default
            raise_error("{}: missing metadata key '{}'", self.path, key)
        return str(self.metadata[key])

    def get_array(self, key: str) -> list:
        v = self.metadata.get(key, [])
        if not isinstance(v, list):
            raise_error("{}: metadata key '{}' is not an array", self.path, key)
        return v

    # -- tensor access --

    def __contains__(self, name: str) -> bool:
        return name in self.tensors

    def tensor_names(self) -> list[str]:
        return list(self.tensors.keys())

    def raw(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        return self._mmap[info.offset : info.offset + info.n_bytes]

    def tensor(self, name: str, dtype: np.dtype | None = None) -> np.ndarray:
        """Read one tensor as numpy in C-order (torch) shape.

        BF16 and Q8_0 are expanded to f32; ``dtype`` casts on top.
        """
        if name not in self.tensors:
            raise_error("{}: no tensor named '{}'", self.path, name)
        info = self.tensors[name]
        raw = self.raw(name)
        if info.ggml_type in _DEQUANTIZE:
            dequant = _DEQUANTIZE[info.ggml_type][0]
            arr = dequant(raw.tobytes(), info.n_elements).reshape(info.shape)
        elif info.ggml_type == GGMLType.BF16:
            arr = bf16_to_f32(raw.view(np.uint16)).reshape(info.shape)
        elif info.ggml_type in _GGML_NP_DTYPE:
            arr = raw.view(_GGML_NP_DTYPE[info.ggml_type]).reshape(info.shape)
        else:
            raise_error(
                "{}: tensor '{}' has unsupported ggml type {}",
                self.path, name, getattr(info.ggml_type, "name", info.ggml_type),
            )
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        return arr

    def is_quantized(self, name: str) -> bool:
        return self.tensors[name].ggml_type in _DEQUANTIZE

    def load_all(self, dtype: np.dtype | None = None) -> dict[str, np.ndarray]:
        return {name: self.tensor(name, dtype) for name in self.tensors}


def model_load(path: str | Path | GGUFFile) -> GGUFFile:
    """Open a .gguf file (reference model_load, ml.cpp:206-217). An
    already-open GGUFFile passes through, so api.load_model can parse the
    header once and hand it to the family loader."""
    if isinstance(path, GGUFFile):
        return path
    return GGUFFile(path)


# ---------------------------------------------------------------------------
# Writer — used by the converter (convert/convert.py) and round-trip tests.
# ---------------------------------------------------------------------------


def _value_type_of(v: Any) -> GGUFValueType:
    if isinstance(v, (bool, np.bool_)):
        return GGUFValueType.BOOL
    if isinstance(v, (int, np.integer)):
        v = int(v)
        if v >= 2**63:  # INT64 can't pack it; the format has UINT64
            return GGUFValueType.UINT64
        return GGUFValueType.INT64 if (v < 0 or v >= 2**32) else GGUFValueType.UINT32
    if isinstance(v, (float, np.floating)):
        # FLOAT32 by default (gguf-py convention); a FLOAT64 source KV is
        # preserved via the explicit vtype recorded by the reader
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise_error("unsupported gguf metadata value: {!r}", v)


def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _write_value(
    f: BinaryIO,
    v: Any,
    vtype: GGUFValueType | None = None,
    etype: GGUFValueType | None = None,
) -> None:
    """Type tag + payload. ``vtype``/``etype`` (array element type) override
    the value-derived types — the reader records them so read -> rewrite
    preserves f64/u64/i64 KVs exactly."""
    if vtype is None:
        vtype = _value_type_of(v)
    f.write(struct.pack("<I", int(vtype)))
    _write_value_body(f, v, vtype, etype)


def _write_value_body(
    f: BinaryIO, v: Any, vtype: GGUFValueType, etype: GGUFValueType | None = None
) -> None:
    if vtype == GGUFValueType.STRING:
        _write_string(f, v)
    elif vtype == GGUFValueType.ARRAY:
        seq = list(v)
        if etype is None:
            if seq and isinstance(seq[0], (list, tuple, np.ndarray)):
                etype = GGUFValueType.ARRAY  # GGUF-legal nested array
            else:
                etype = _value_type_of(seq[0]) if seq else GGUFValueType.INT32
            # widen integer arrays to one element type (bools stay BOOL:
            # Python bool subclasses int and numpy ints are not int, so
            # test the resolved etype rather than isinstance)
            if seq and etype in (GGUFValueType.UINT32, GGUFValueType.INT32, GGUFValueType.INT64, GGUFValueType.UINT64):
                ints = [int(x) for x in seq]
                if any(x >= 2**63 for x in ints):
                    etype = GGUFValueType.UINT64
                elif all(-(2**31) <= x < 2**31 for x in ints):
                    etype = GGUFValueType.INT32
                else:
                    etype = GGUFValueType.INT64
                seq = ints
        f.write(struct.pack("<I", int(etype)))
        f.write(struct.pack("<Q", len(seq)))
        for x in seq:
            if etype == GGUFValueType.ARRAY:
                # nested element = its own etype + count + values (no outer
                # type tag); sub-element types re-derived from the values
                _write_value_body(f, x, GGUFValueType.ARRAY)
            elif etype == GGUFValueType.STRING:
                _write_string(f, x)
            elif etype == GGUFValueType.BOOL:
                f.write(struct.pack(_SCALAR_FMT[etype], bool(x)))
            elif etype in (GGUFValueType.FLOAT32, GGUFValueType.FLOAT64):
                f.write(struct.pack(_SCALAR_FMT[etype], float(x)))
            else:
                f.write(struct.pack(_SCALAR_FMT[etype], int(x)))
    elif vtype == GGUFValueType.BOOL:
        f.write(struct.pack(_SCALAR_FMT[vtype], bool(v)))
    elif vtype in (GGUFValueType.FLOAT32, GGUFValueType.FLOAT64):
        f.write(struct.pack(_SCALAR_FMT[vtype], float(v)))
    else:
        f.write(struct.pack(_SCALAR_FMT[vtype], int(v)))


class GGUFWriter:
    """Minimal GGUF v3 writer, format-compatible with gguf-py output."""

    def __init__(self, path: str | Path, arch: str):
        self.path = str(path)
        self.kv: dict[str, Any] = {"general.architecture": arch}
        self.kv_types: dict[str, tuple[GGUFValueType, GGUFValueType | None]] = {}
        self._tensors: list[tuple[str, np.ndarray, GGMLType]] = []
        self.alignment = GGUF_DEFAULT_ALIGNMENT

    def add(
        self,
        key: str,
        value: Any,
        vtype: tuple[GGUFValueType, GGUFValueType | None] | None = None,
    ) -> None:
        """``vtype``: optional (value type, array element type) pair — pass
        ``GGUFFile.kv_types[key]`` when echoing a read KV so f64/u64/i64
        storage types survive the round-trip."""
        self.kv[key] = value
        if vtype is not None:
            self.kv_types[key] = vtype
        else:
            self.kv_types.pop(key, None)

    def add_tensor(self, name: str, array: np.ndarray, ggml_type: GGMLType | None = None) -> None:
        if len(name.encode()) >= 64:
            raise_error("tensor name too long for GGUF (>=64 chars): {}", name)
        a = np.ascontiguousarray(array)
        if ggml_type is None:
            ggml_type = ggml_type_of(a)
        self._tensors.append((name, a, ggml_type))

    def add_raw_tensor(self, name: str, shape: tuple[int, ...], ggml_type: GGMLType, blob: bytes) -> None:
        """Add a tensor whose data bytes are already in final (e.g.
        quantized-block) form."""
        if len(name.encode()) >= 64:  # GGML_MAX_NAME — same gate as add_tensor
            raise_error("tensor name too long for GGUF (>=64 chars): {}", name)
        self._tensors.append((name, _RawBlob(tuple(shape), blob), ggml_type))

    def write(self) -> None:
        # honor a caller-supplied general.alignment KV: the layout below
        # MUST pad with the same value a reader will parse back, or every
        # tensor offset is silently shifted (a rewriter copies the KV
        # from its source file verbatim)
        self.alignment = int(self.kv.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        if self.alignment < 1:
            raise_error("general.alignment must be >= 1, got {}", self.alignment)
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<I", 3))
            f.write(struct.pack("<QQ", len(self._tensors), len(self.kv)))
            for k, v in self.kv.items():
                _write_string(f, k)
                vt, et = self.kv_types.get(k, (None, None))
                _write_value(f, v, vt, et)
            blobs: list[bytes] = []
            offset = 0
            for name, a, gt in self._tensors:
                if isinstance(a, _RawBlob):
                    blob = a.blob
                elif gt == GGMLType.BF16 and a.dtype != np.uint16:
                    blob = f32_to_bf16(a.astype(np.float32)).tobytes()
                elif gt == GGMLType.F16:
                    blob = a.astype(np.float16).tobytes()
                elif gt == GGMLType.F32:
                    blob = a.astype(np.float32).tobytes()
                else:
                    blob = a.tobytes()
                _write_string(f, name)
                ne = tuple(reversed(a.shape)) if a.ndim > 0 else (1,)
                f.write(struct.pack("<I", len(ne)))
                f.write(struct.pack(f"<{len(ne)}Q", *ne))
                f.write(struct.pack("<I", int(gt)))
                f.write(struct.pack("<Q", offset))
                blobs.append(blob)
                offset += len(blob)
                offset = (offset + self.alignment - 1) // self.alignment * self.alignment
            pos = f.tell()
            pad = (pos + self.alignment - 1) // self.alignment * self.alignment - pos
            f.write(b"\x00" * pad)
            for i, blob in enumerate(blobs):
                f.write(blob)
                if i != len(blobs) - 1:
                    pad = (len(blob) + self.alignment - 1) // self.alignment * self.alignment - len(blob)
                    f.write(b"\x00" * pad)
