"""PNG read and write in numpy and the standard library's ``zlib``, so that
the port loads and saves images without PIL.

Scope (what ``image_load`` / ``image_save`` exchange): 8-bit samples, no
interlacing, colour types 0 (gray), 2 (RGB), 3 (palette, with ``tRNS``
alpha), 4 (gray + alpha) and 6 (RGBA). Beside it, :func:`read_png16` reads
16-bit gray (the usual encoding of depth ground truth, which the JAX
package's evaluator reads through PIL's ``I;16``). A file outside both
raises :class:`PngUnsupported`. The decoded pixels follow what the JAX
package's ``image_load`` makes of a file through PIL: gray stays one
channel, gray + alpha becomes RGBA, a palette becomes RGB, or RGBA when the
file has a ``tRNS`` chunk; a ``tRNS`` colour key of a gray or RGB file is
ignored. :func:`encode_png` makes the bytes :func:`write_png` writes (the
HTTP front end answers with them).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..core.errors import VispError

__all__ = ["PNG_SIGNATURE", "PngUnsupported", "encode_png", "read_png", "read_png16", "write_png"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngUnsupported(VispError):
    """A well-formed PNG outside this codec's scope (bit depth, interlace)."""


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if pos + 12 + n > len(data):
            raise VispError(f"PNG: chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise VispError(f"PNG: chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise VispError("PNG: no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ft: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Undo the scanline filters. ft: (H,) filter types; f: (H, W, bpp)
    filtered bytes. With the Average or Paeth filter a pixel depends on its
    left, upper and upper-left neighbours, so the pixels of one
    anti-diagonal r + c = d are independent: the loop runs over the H + W -
    1 diagonals, each one vectorised. The pixels go into a copy of the
    image with a zero row above and a zero column on the left, where the
    neighbours of pixel i (flat) are i - 1, i - (W + 1) and i - (W + 2);
    the scratch space is that copy and one diagonal's worth."""
    h, w, bpp = f.shape
    if ft.max(initial=0) <= 2:
        # None, Sub and Up only (this module's own files): each row at once
        out = np.empty_like(f)
        prev = np.zeros((w, bpp), np.uint8)
        for y, t in enumerate(ft):
            row = f[y] + prev if t == 2 else np.cumsum(f[y], axis=0, dtype=np.uint8) if t == 1 else f[y]
            out[y] = prev = row
        return out
    xs = np.zeros((h + 1, w + 1, bpp), np.uint8)
    flat, fflat = xs.reshape(-1, bpp), f.reshape(-1, bpp)
    types = ft[:, None]
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        i = r * w + (d + w + 2)  # pixel (r, d - r) of the padded copy
        a = flat[i - 1].astype(np.int16)  # left
        b = flat[i - (w + 1)].astype(np.int16)  # up
        t = types[r]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(t == 3, (a + b) >> 1, np.where(
            t == 4, _paeth(a, b, flat[i - (w + 2)].astype(np.int16)), 0))))
        flat[i] = fflat[r * (w - 1) + d] + pred.astype(np.uint8)
    return np.ascontiguousarray(xs[1:, 1:])


def _decode(data: bytes):
    """The chunks of a PNG, checked, and its scanlines decompressed: (IHDR
    fields, PLTE as (n, 3) u8 or None, tRNS bytes or None, the raw image
    data as u8). Raises :class:`VispError` on a damaged file."""
    if not data.startswith(PNG_SIGNATURE):
        raise VispError("PNG: bad signature")
    header = palette = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise VispError("PNG: no IHDR or IDAT chunk")
    if header[3] not in _CHANNELS:
        raise VispError(f"PNG: unknown colour type {header[3]}")
    return header, palette, trns, b"".join(idat)


def _scanlines(idat: bytes, w: int, h: int, bpp: int, ctype: int) -> np.ndarray:
    """Decompress and unfilter the image data: (H, W, bpp) bytes, bpp the
    bytes of one pixel."""
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise VispError(f"PNG: image data does not inflate: {e}") from None
    if raw.size != h * (1 + w * bpp):
        raise VispError(f"PNG: {raw.size} bytes of image data for {w}x{h}, colour type {ctype}")
    raw = raw.reshape(h, 1 + w * bpp)
    if raw[:, 0].max(initial=0) > 4:
        raise VispError("PNG: unknown scanline filter")
    return _unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, bpp))


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 pixels, C in 1, 3, 4 (see the module
    docstring). Raises :class:`VispError` on a damaged file and
    :class:`PngUnsupported` outside the scope."""
    (w, h, depth, ctype, _, _, interlace), palette, trns, idat = _decode(data)
    if depth != 8 or interlace:
        raise PngUnsupported(f"PNG: bit depth {depth}, interlace {interlace} (8-bit, not interlaced only)")
    px = _scanlines(idat, w, h, _CHANNELS[ctype], ctype)
    if ctype == 4:  # gray + alpha -> RGBA
        return np.ascontiguousarray(px[:, :, [0, 0, 0, 1]])
    if ctype == 3:
        if palette is None:
            raise VispError("PNG: palette image without PLTE")
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[: len(palette), :3] = palette
        if trns is not None:
            table[: len(trns), 3] = trns
        return np.ascontiguousarray(table[px[:, :, 0]][:, :, : 4 if trns is not None else 3])
    return px


def read_png16(data: bytes) -> np.ndarray:
    """16-bit gray PNG bytes -> (H, W, 1) uint16 samples (PNG stores them
    big-endian; PIL reads such a file as mode ``I;16``). Raises
    :class:`VispError` on a damaged file and :class:`PngUnsupported` for any
    other bit depth or colour type, or an interlaced file."""
    (w, h, depth, ctype, _, _, interlace), _, _, idat = _decode(data)
    if depth != 16 or ctype != 0 or interlace:
        raise PngUnsupported(f"PNG: bit depth {depth}, colour type {ctype}, interlace {interlace} "
                             "(16-bit gray, not interlaced only)")
    px = _scanlines(idat, w, h, 2, ctype)
    return ((px[:, :, 0].astype(np.uint16) << 8) | px[:, :, 1])[:, :, None]


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, C) uint8 pixels, C in 1, 3, 4 (gray, RGB, RGBA), as the bytes
    of an 8-bit PNG. Every scanline takes the Up filter (the byte above
    subtracted), which zlib then compresses at its default level."""
    a = np.ascontiguousarray(pixels)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (1, 3, 4):
        raise VispError(f"PNG: cannot write pixels of shape {a.shape} and type {a.dtype}")
    h, w, c = a.shape
    rows = a.reshape(h, w * c)
    up = np.empty((h, 1 + w * c), np.uint8)
    up[:, 0] = 2
    up[:, 1:] = rows
    up[1:, 1:] -= rows[:-1]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (
        PNG_SIGNATURE
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(up.tobytes()))
        + chunk(b"IEND", b"")
    )


def write_png(path: str | Path, pixels: np.ndarray) -> None:
    """Write (H, W, C) uint8 pixels as an 8-bit PNG (:func:`encode_png`)."""
    Path(path).write_bytes(encode_png(pixels))
