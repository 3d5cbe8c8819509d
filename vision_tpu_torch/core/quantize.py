"""Block-quantization ENCODERS for every GGUF format the reader accepts.

A numpy-only copy of ``vision_tpu/core/quantize.py`` for the port (the JAX
package's module imports jax through its package ``__init__``); its bytes
are the JAX module's, format for format (tests/test_torch_quantize.py).

gguf.py holds the decoders (``dequantize_*``) that let the loader consume
reference-produced files (reference consumer: src/visp/ml.cpp:283-360);
this module is the other direction — ``vision-cli-torch quantize`` /
``vision-convert-torch -q`` can now *emit* the same formats, closing the
read/write asymmetry the reference inherits from delegating file
production to llama-quantize/gguf-py.

Two layers per format, tested separately (tests/test_quantize.py, on the JAX
package's copy):

* ``_fit_*``   — choose block parameters (scales/mins/levels) for the data.
  Legacy 32-block formats use the ggml reference rules verbatim (absmax /
  min-max with the exact truncating-round semantics), so q4_0/q4_1/q5_0/
  q5_1/q8_0 files match llama-quantize byte-for-byte. K-quant super-blocks
  use an alternating least-squares fit (init min-max / signed-absmax, then
  re-solve (scale, min) given levels and re-quantize given scales) — a
  fresh formulation of the same objective ggml's make_qx_quants /
  make_qkx2_quants search over; encodings are format-valid and within a
  few percent of ggml's RMS, not byte-identical.
* ``_pack_*``  — bit-pack parameters into the wire layout. Exact inverses
  of gguf.py's decoders; verified field-for-field by the pack tests.

Every encoder takes f32 data whose size divides the block (32 legacy /
256 K) and returns the raw block bytes ``dequantize_*`` reads back.
"""

from __future__ import annotations

import numpy as np

from .errors import raise_error
from .gguf import _IQ4_KVALUES, GGMLType, q8_0_block_levels, quantize_q8_0

__all__ = ["QUANTIZERS", "quantize_blocks", "block_size"]


def _safe_inv(x: np.ndarray) -> np.ndarray:
    """1/x with 0 -> 0 (the ggml ``id = d ? 1/d : 0`` idiom), NaN-free."""
    return np.where(x != 0, 1.0 / np.where(x == 0, 1.0, x), 0.0)


def _blocks(x: np.ndarray, block: int, fmt: str) -> np.ndarray:
    a = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if a.size % block != 0:
        raise_error("quantize_{}: size {} not a multiple of {}", fmt, a.size, block)
    return a.reshape(-1, block)


def _f16_bytes(d: np.ndarray) -> np.ndarray:
    """f32 (nb,) -> (nb, 2) u8 little-endian f16."""
    return d.astype(np.float16).reshape(-1, 1).view(np.uint8)


def _f16_round(d: np.ndarray) -> np.ndarray:
    """The f32 value the decoder will actually see after f16 storage."""
    return d.astype(np.float16).astype(np.float32)


# ---------------------------------------------------------------- legacy 32


def _trunc_round(v: np.ndarray, off: float, hi: float) -> np.ndarray:
    """ggml legacy-quantizer rounding: ``MIN(hi, (int)(v + off))`` — the
    level offset and the half are added in ONE f32 addition exactly as the
    reference's ``x0 + 8.5f`` is (two separate adds can round differently
    in f32), then truncate toward zero (values here are >= -0.5 so this is
    floor), then clamp. Matches quantize_row_q4_0_ref et al. byte-exactly;
    v must already be f32 so the python-float ``off`` doesn't upcast."""
    return np.clip(np.floor(v + off), 0, hi)


def _signed_extreme(b: np.ndarray) -> np.ndarray:
    """Per block, the value with the largest magnitude KEEPING ITS SIGN
    (ggml ``if (amax < fabsf(v)) { amax = fabsf(v); max = v; }``)."""
    idx = np.abs(b).argmax(axis=1)
    return b[np.arange(b.shape[0]), idx]


def _pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(nb, 32) int levels 0..15 -> (nb, 16) bytes; inverse of
    gguf._nibbles (element j low nibble, j+16 high)."""
    q = q.astype(np.uint8)
    return q[:, :16] | (q[:, 16:] << 4)


def _pack_high_bits(hb: np.ndarray) -> np.ndarray:
    """(nb, 32) 0/1 -> (nb, 4) bytes; inverse of gguf._high_bits
    (little-endian u32, bit i = element i)."""
    return np.packbits(hb.astype(np.uint8), axis=1, bitorder="little")


def quantize_q4_0(x: np.ndarray) -> bytes:
    b = _blocks(x, 32, "q4_0")
    d = _signed_extreme(b) / -8.0
    # ggml computes levels with the PRE-f16 f32 reciprocal (id = 1/d before
    # GGML_FP32_TO_FP16 storage) — required for llama-quantize byte parity.
    q = _trunc_round(b * _safe_inv(d)[:, None], 8.5, 15)
    out = np.empty((b.shape[0], 18), np.uint8)
    out[:, :2] = _f16_bytes(d)
    out[:, 2:] = _pack_nibbles(q)
    return out.tobytes()


def quantize_q4_1(x: np.ndarray) -> bytes:
    b = _blocks(x, 32, "q4_1")
    mn = b.min(axis=1)
    d = (b.max(axis=1) - mn) / 15.0
    # f32 d and min in the level math (ggml quantize_row_q4_1_ref).
    q = _trunc_round((b - mn[:, None]) * _safe_inv(d)[:, None], 0.5, 15)
    out = np.empty((b.shape[0], 20), np.uint8)
    out[:, :2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(mn)
    out[:, 4:] = _pack_nibbles(q)
    return out.tobytes()


def quantize_q5_0(x: np.ndarray) -> bytes:
    b = _blocks(x, 32, "q5_0")
    d = _signed_extreme(b) / -16.0
    q = _trunc_round(b * _safe_inv(d)[:, None], 16.5, 31).astype(np.uint8)
    out = np.empty((b.shape[0], 22), np.uint8)
    out[:, :2] = _f16_bytes(d)
    out[:, 2:6] = _pack_high_bits(q >> 4)
    out[:, 6:] = _pack_nibbles(q & 0x0F)
    return out.tobytes()


def quantize_q5_1(x: np.ndarray) -> bytes:
    b = _blocks(x, 32, "q5_1")
    mn = b.min(axis=1)
    d = (b.max(axis=1) - mn) / 31.0
    q = _trunc_round((b - mn[:, None]) * _safe_inv(d)[:, None], 0.5, 31).astype(np.uint8)
    out = np.empty((b.shape[0], 24), np.uint8)
    out[:, :2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(mn)
    out[:, 4:8] = _pack_high_bits(q >> 4)
    out[:, 8:] = _pack_nibbles(q & 0x0F)
    return out.tobytes()


# ------------------------------------------------------------- K-quant fits


def _fit_minmax(sub: np.ndarray, nmax: int, iters: int = 3):
    """Fit ``x ~= S*q - M`` per sub-block with q in [0, nmax], S >= 0,
    M >= 0 (the Q2_K/Q4_K/Q5_K affine form: offset is -dmin*mn <= 0, so a
    positive minimum clamps M to 0 — same constraint ggml enforces).

    Alternating least squares: init S/M from the range, then repeat
    (quantize levels; re-solve the 2x2 normal equations for S, M given the
    levels; project to the constraint set). sub: (n, k) -> (S (n,), M (n,)).
    Final levels are NOT returned — every caller recomputes them against
    the f16/6-bit-coded scales the decoder will actually see
    (_requant_affine)."""
    mn = np.minimum(sub.min(axis=1), 0.0)
    S = (sub.max(axis=1) - mn) / nmax
    M = -mn
    k = sub.shape[1]
    for _ in range(iters):
        q = np.clip(np.round((sub + M[:, None]) * _safe_inv(S)[:, None]), 0, nmax)
        # minimize sum((S*q - M - x)^2) over (S, M)
        sq, sqq = q.sum(axis=1), (q * q).sum(axis=1)
        sx, sqx = sub.sum(axis=1), (q * sub).sum(axis=1)
        det = sqq * k - sq * sq
        ok = det > 1e-12
        S_new = np.where(ok, (sqx * k - sq * sx) / np.where(ok, det, 1.0), S)
        M_new = np.where(ok, (S_new * sq - sx) / k, M)
        # constraint projection; fall back to range init where degenerate
        bad = (S_new <= 0) | (M_new < 0)
        S = np.where(bad, (sub.max(axis=1) - np.minimum(sub.min(axis=1), 0)) / nmax, S_new)
        M = np.where(bad, -np.minimum(sub.min(axis=1), 0.0), np.maximum(M_new, 0.0))
    return S, M


def _fit_signed(sub: np.ndarray, lmin: int, lmax: int, iters: int = 3):
    """Fit ``x ~= s*q`` per sub-block with q in [lmin, lmax] and s free-
    signed (Q3_K/Q6_K sub-scales are signed). Init maps the extreme value
    to lmin — when the extreme is positive s comes out negative, which the
    signed scale represents and which buys the asymmetric range's extra
    level (the same trick ggml's max/-32 init uses). Then alternate
    (quantize; least-squares re-solve s = <x,q>/<q,q>). Returns s (n,);
    callers recompute final levels against the coded scales."""
    ext = _signed_extreme(sub)
    s = ext / lmin
    for _ in range(iters):
        q = np.clip(np.round(sub * _safe_inv(s)[:, None]), lmin, lmax)
        qq = (q * q).sum(axis=1)
        ok = qq > 0
        s = np.where(ok, (q * sub).sum(axis=1) / np.where(ok, qq, 1.0), s)
    return s


def _super_scale(v: np.ndarray, smax: int):
    """Quantize per-sub values v (nb, ns) >= 0 to smax levels under one f16
    super-scale d per block: returns (d_f32_after_f16 (nb,), code (nb, ns)
    u8)."""
    d = v.max(axis=1) / smax
    dv = _f16_round(d)
    code = np.clip(np.round(v * _safe_inv(dv)[:, None]), 0, smax).astype(np.uint8)
    return d, dv, code


def _requant_affine(sub, dv, sc, mv, mn, nmax):
    """Final levels against the scales the DECODER will see:
    q = round((x + dmin*mn) / (d*sc)) in [0, nmax]."""
    S = dv[:, None] * sc.astype(np.float32)
    M = mv[:, None] * mn.astype(np.float32)
    inv = _safe_inv(S)
    return np.clip(np.round((sub + M[:, :, None]) * inv[:, :, None]), 0, nmax).astype(np.uint8)


# ------------------------------------------------------------ K-quant packs


def _pack_k_scale_min(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Inverse of gguf._k_scale_min: 8 (scale, min) 6-bit pairs -> 12
    bytes. sc/mn: (nb, 8) u8 in 0..63."""
    nb = sc.shape[0]
    out = np.empty((nb, 12), np.uint8)
    out[:, 0:4] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 4:8] = (mn[:, :4] & 63) | ((mn[:, 4:] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:] & 0x0F) | ((mn[:, 4:] & 0x0F) << 4)
    return out


def _pack_k_nibbles(q: np.ndarray) -> np.ndarray:
    """Inverse of the Q4_K/Q5_K quant layout: q (nb, 8, 32) levels ->
    (nb, 128) bytes where byte group g holds sub-block 2g in the low
    nibble and 2g+1 in the high."""
    lo = q[:, 0::2].astype(np.uint8) & 0x0F
    hi = q[:, 1::2].astype(np.uint8) & 0x0F
    return (lo | (hi << 4)).reshape(q.shape[0], 128)


def _pack_2bit_halves(q: np.ndarray) -> np.ndarray:
    """Inverse of the Q2_K/Q3_K 2-bit layout: q (nb, 16, 16) values 0..3 ->
    (nb, 64) bytes; byte l of half h packs sub-blocks h*8+2j.. at bit 2j."""
    nb = q.shape[0]
    g = q.reshape(nb, 2, 4, 32).astype(np.uint8)  # (nb, half, j, l)
    shifts = np.arange(4, dtype=np.uint8) * 2
    return (g << shifts[None, None, :, None]).sum(axis=2, dtype=np.uint8).reshape(nb, 64)


def quantize_q4_k(x: np.ndarray) -> bytes:
    b = _blocks(x, 256, "q4_k")
    nb = b.shape[0]
    sub = b.reshape(nb, 8, 32)
    S, M = _fit_minmax(sub.reshape(nb * 8, 32), 15)
    d, dv, sc = _super_scale(S.reshape(nb, 8), 63)
    dmin, mv, mn = _super_scale(M.reshape(nb, 8), 63)
    q = _requant_affine(sub, dv, sc, mv, mn, 15)
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_k_scale_min(sc, mn)
    out[:, 16:] = _pack_k_nibbles(q)
    return out.tobytes()


def quantize_q5_k(x: np.ndarray) -> bytes:
    b = _blocks(x, 256, "q5_k")
    nb = b.shape[0]
    sub = b.reshape(nb, 8, 32)
    S, M = _fit_minmax(sub.reshape(nb * 8, 32), 31)
    d, dv, sc = _super_scale(S.reshape(nb, 8), 63)
    dmin, mv, mn = _super_scale(M.reshape(nb, 8), 63)
    q = _requant_affine(sub, dv, sc, mv, mn, 31)
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:16] = _pack_k_scale_min(sc, mn)
    # high bits: bit j of qh byte l = bit 4 of sub-block j, element l
    out[:, 16:48] = (
        ((q >> 4) & 1) << np.arange(8, dtype=np.uint8)[None, :, None]
    ).sum(axis=1, dtype=np.uint8)
    out[:, 48:] = _pack_k_nibbles(q & 0x0F)
    return out.tobytes()


def quantize_q2_k(x: np.ndarray) -> bytes:
    b = _blocks(x, 256, "q2_k")
    nb = b.shape[0]
    sub = b.reshape(nb, 16, 16)
    S, M = _fit_minmax(sub.reshape(nb * 16, 16), 3)
    d, dv, sc = _super_scale(S.reshape(nb, 16), 15)
    dmin, mv, mn = _super_scale(M.reshape(nb, 16), 15)
    q = _requant_affine(sub, dv, sc, mv, mn, 3)
    out = np.empty((nb, 84), np.uint8)
    out[:, :16] = sc | (mn << 4)
    out[:, 16:80] = _pack_2bit_halves(q)
    out[:, 80:82] = _f16_bytes(d)
    out[:, 82:84] = _f16_bytes(dmin)
    return out.tobytes()


def quantize_q3_k(x: np.ndarray) -> bytes:
    b = _blocks(x, 256, "q3_k")
    nb = b.shape[0]
    sub = b.reshape(nb, 16, 16)
    s = _fit_signed(sub.reshape(nb * 16, 16), -4, 3)
    s = s.reshape(nb, 16)
    # signed 6-bit effective scale (sc_stored - 32) under one f16 d
    d = np.abs(s).max(axis=1) / 31.0
    dv = _f16_round(d)
    eff = np.clip(np.round(s * _safe_inv(dv)[:, None]), -32, 31)
    Sf = dv[:, None] * eff
    qe = np.clip(np.round(sub * _safe_inv(Sf)[:, :, None]), -4, 3)
    q3 = (qe + 4.0).astype(np.uint8)  # 0..7: low 2 bits -> qs, bit 2 -> hmask
    out = np.empty((nb, 110), np.uint8)
    # hmask byte h*16+e, bit j <- high bit of sub-block 2j+h, element e
    hb = (q3 >> 2).reshape(nb, 8, 2, 16)  # sub s = 2j + h -> (j, h)
    out[:, :32] = (
        (hb << np.arange(8, dtype=np.uint8)[None, :, None, None])
        .sum(axis=1, dtype=np.uint8)
        .reshape(nb, 32)
    )
    out[:, 32:96] = _pack_2bit_halves(q3 & 3)
    sc = (eff + 32.0).astype(np.uint8)  # 0..63
    sc12 = np.empty((nb, 12), np.uint8)
    sc12[:, :8] = (sc[:, :8] & 0x0F) | ((sc[:, 8:] & 0x0F) << 4)
    hi = sc >> 4  # 2 bits each
    sc12[:, 8:] = (
        hi[:, 0:4] | (hi[:, 4:8] << 2) | (hi[:, 8:12] << 4) | (hi[:, 12:16] << 6)
    )
    out[:, 96:108] = sc12
    out[:, 108:110] = _f16_bytes(d)
    return out.tobytes()


def quantize_q6_k(x: np.ndarray) -> bytes:
    b = _blocks(x, 256, "q6_k")
    nb = b.shape[0]
    sub = b.reshape(nb, 16, 16)
    s = _fit_signed(sub.reshape(nb * 16, 16), -32, 31)
    s = s.reshape(nb, 16)
    d = np.abs(s).max(axis=1) / 127.0
    dv = _f16_round(d)
    sc = np.clip(np.round(s * _safe_inv(dv)[:, None]), -128, 127)
    Sf = dv[:, None] * sc
    q = (np.clip(np.round(sub * _safe_inv(Sf)[:, :, None]), -32, 31) + 32.0).astype(np.uint8)
    # natural order (nb, 2 half, 4 group, 32) — see dequantize_q6_k
    g = q.reshape(nb, 2, 4, 32)
    out = np.empty((nb, 210), np.uint8)
    ql = np.empty((nb, 2, 64), np.uint8)
    ql[:, :, :32] = (g[:, :, 0] & 0x0F) | ((g[:, :, 2] & 0x0F) << 4)
    ql[:, :, 32:] = (g[:, :, 1] & 0x0F) | ((g[:, :, 3] & 0x0F) << 4)
    out[:, :128] = ql.reshape(nb, 128)
    out[:, 128:192] = (
        (g[:, :, 0] >> 4)
        | ((g[:, :, 1] >> 4) << 2)
        | ((g[:, :, 2] >> 4) << 4)
        | ((g[:, :, 3] >> 4) << 6)
    ).reshape(nb, 64)
    out[:, 192:208] = sc.astype(np.int8).view(np.uint8)
    out[:, 208:210] = _f16_bytes(d)
    return out.tobytes()


def quantize_q8_k(x: np.ndarray) -> bytes:
    b = _blocks(x, 256, "q8_k")
    nb = b.shape[0]
    # same absmax/round-half-away-from-zero semantics as Q8_0, 256-block
    q, d = q8_0_block_levels(b, block=256)
    out = np.empty((nb, 292), np.uint8)
    out[:, 0:4] = d.reshape(-1, 1).view(np.uint8)
    out[:, 4:260] = q.view(np.uint8)
    bsums = q.astype(np.int16).reshape(nb, 16, 16).sum(axis=2, dtype=np.int16)
    out[:, 260:292] = bsums.view(np.uint8)
    return out.tobytes()


# -------------------------------------------------------- IQ4 (non-linear)

# midpoints between consecutive kvalues: nearest-level quantization onto
# the non-uniform grid is one searchsorted against these
_IQ4_MID = (_IQ4_KVALUES[:-1] + _IQ4_KVALUES[1:]) / 2.0


def _iq4_nearest(v: np.ndarray) -> np.ndarray:
    """Index of the nearest _IQ4_KVALUES entry for each scaled value."""
    return np.searchsorted(_IQ4_MID, v).astype(np.uint8)


def _fit_iq4(sub: np.ndarray, iters: int = 3):
    """Fit ``x ~= s * kvalues[q]`` per row with s free-signed. Init maps
    the signed extreme to kvalues[0] (-127, the grid's largest-magnitude
    entry — ggml's iq4 init does the same), then alternate (nearest-level
    quantize; least-squares re-solve s = <x,k(q)>/<k(q),k(q)>)."""
    s = _signed_extreme(sub) / float(_IQ4_KVALUES[0])
    for _ in range(iters):
        kq = _IQ4_KVALUES[_iq4_nearest(sub * _safe_inv(s)[:, None])]
        kk = (kq * kq).sum(axis=1)
        ok = kk > 0
        s = np.where(ok, (kq * sub).sum(axis=1) / np.where(ok, kk, 1.0), s)
    return s


def quantize_iq4_nl(x: np.ndarray) -> bytes:
    b = _blocks(x, 32, "iq4_nl")
    d = _fit_iq4(b)
    # final levels against the f16-stored scale the decoder will see
    idx = _iq4_nearest(b * _safe_inv(_f16_round(d))[:, None])
    out = np.empty((b.shape[0], 18), np.uint8)
    out[:, :2] = _f16_bytes(d)
    out[:, 2:] = idx[:, :16] | (idx[:, 16:] << 4)
    return out.tobytes()


def quantize_iq4_xs(x: np.ndarray) -> bytes:
    b = _blocks(x, 256, "iq4_xs")
    nb = b.shape[0]
    sub = b.reshape(nb, 8, 32)
    s = _fit_iq4(sub.reshape(nb * 8, 32)).reshape(nb, 8)
    # 6-bit signed sub-scales (ls - 32) under one f16 super-scale d
    d = np.abs(s).max(axis=1) / 31.0
    dv = _f16_round(d)
    ls = np.clip(np.round(s * _safe_inv(dv)[:, None]), -32, 31)
    Sf = dv[:, None] * ls
    idx = _iq4_nearest(sub * _safe_inv(Sf)[:, :, None])
    lsq = (ls + 32.0).astype(np.uint8)  # 0..63
    out = np.empty((nb, 136), np.uint8)
    out[:, 0:2] = _f16_bytes(d)
    # scales_h: little-endian u16, bits 2*ib..2*ib+1 = top 2 bits of ls[ib]
    sh = ((lsq.astype(np.uint32) >> 4) << (2 * np.arange(8, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32
    )
    out[:, 2:4] = sh.astype(np.uint16).reshape(-1, 1).view(np.uint8)
    # scales_l: byte k = low nibble of ls[2k] | low nibble of ls[2k+1] << 4
    out[:, 4:8] = (lsq[:, 0::2] & 0x0F) | ((lsq[:, 1::2] & 0x0F) << 4)
    out[:, 8:] = (idx[:, :, :16] | (idx[:, :, 16:] << 4)).reshape(nb, 128)
    return out.tobytes()


# ggml_type -> (encoder, elements per block)
QUANTIZERS = {
    GGMLType.Q4_0: (quantize_q4_0, 32),
    GGMLType.Q4_1: (quantize_q4_1, 32),
    GGMLType.Q5_0: (quantize_q5_0, 32),
    GGMLType.Q5_1: (quantize_q5_1, 32),
    GGMLType.Q8_0: (quantize_q8_0, 32),
    GGMLType.Q2_K: (quantize_q2_k, 256),
    GGMLType.Q3_K: (quantize_q3_k, 256),
    GGMLType.Q4_K: (quantize_q4_k, 256),
    GGMLType.Q5_K: (quantize_q5_k, 256),
    GGMLType.Q6_K: (quantize_q6_k, 256),
    GGMLType.Q8_K: (quantize_q8_k, 256),
    GGMLType.IQ4_NL: (quantize_iq4_nl, 32),
    GGMLType.IQ4_XS: (quantize_iq4_xs, 256),
}


def block_size(ggml_type: GGMLType) -> int:
    """Elements per quantization block for a writable type."""
    return QUANTIZERS[ggml_type][1]


def quantize_blocks(ggml_type: GGMLType, x: np.ndarray) -> bytes:
    """f32 array -> raw block bytes of ``ggml_type`` (size must divide the
    type's block)."""
    if ggml_type not in QUANTIZERS:
        raise_error("quantize: no encoder for ggml type {}", ggml_type.name)
    return QUANTIZERS[ggml_type][0](x)
