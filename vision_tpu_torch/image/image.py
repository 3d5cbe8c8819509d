"""Image containers and algorithms (numpy host path).

A copy of the parts of vision_tpu/image/image.py that the ported slices use,
with the same semantics contract with the reference implementation
(src/visp/image.cpp, src/visp/image-impl.h). File IO, the box blur, erosion
and the foreground estimate wait for the slices that call them; the tiling
engine is in tiling.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

import numpy as np

from ..core.errors import raise_error

__all__ = [
    "ImageFormat",
    "Image",
    "n_channels",
    "is_float",
    "channel_map",
    "alpha_channel",
    "image_alloc",
    "image_load_array",
    "image_u8_to_f32",
    "image_f32_to_u8",
    "image_scale",
    "preprocess_scale_method",
    "image_normalize",
]


class ImageFormat(Enum):
    """Pixel formats (reference image.h:16-28)."""

    rgba_u8 = "rgba_u8"
    bgra_u8 = "bgra_u8"
    argb_u8 = "argb_u8"
    rgb_u8 = "rgb_u8"
    alpha_u8 = "alpha_u8"
    rgba_f32 = "rgba_f32"
    rgb_f32 = "rgb_f32"
    alpha_f32 = "alpha_f32"


_N_CHANNELS = {
    ImageFormat.rgba_u8: 4,
    ImageFormat.bgra_u8: 4,
    ImageFormat.argb_u8: 4,
    ImageFormat.rgb_u8: 3,
    ImageFormat.alpha_u8: 1,
    ImageFormat.rgba_f32: 4,
    ImageFormat.rgb_f32: 3,
    ImageFormat.alpha_f32: 1,
}

# dst-lane -> src-channel maps (reference image.cpp:45-55)
_CHANNEL_MAP = {
    ImageFormat.bgra_u8: (2, 1, 0, 3),
    ImageFormat.argb_u8: (1, 2, 3, 0),
    ImageFormat.alpha_u8: (0, 0, 0, 0),
    ImageFormat.alpha_f32: (0, 0, 0, 0),
    ImageFormat.rgb_u8: (0, 1, 2, 0),
    ImageFormat.rgb_f32: (0, 1, 2, 0),
}

_ALPHA_CHANNEL = {
    ImageFormat.bgra_u8: 3,
    ImageFormat.argb_u8: 0,
    ImageFormat.alpha_u8: 0,
    ImageFormat.alpha_f32: 0,
    ImageFormat.rgb_u8: -1,
    ImageFormat.rgb_f32: -1,
    ImageFormat.rgba_u8: 3,
    ImageFormat.rgba_f32: 3,
}


def n_channels(fmt: ImageFormat) -> int:
    return _N_CHANNELS[fmt]


def is_float(fmt: ImageFormat) -> bool:
    return fmt in (ImageFormat.rgba_f32, ImageFormat.rgb_f32, ImageFormat.alpha_f32)


def channel_map(fmt: ImageFormat) -> tuple[int, int, int, int]:
    return _CHANNEL_MAP.get(fmt, (0, 1, 2, 3))


def alpha_channel(fmt: ImageFormat) -> int:
    return _ALPHA_CHANNEL[fmt]


@dataclass(eq=False)
class Image:
    """Owning pixel container: (H, W, C) numpy array + format.

    Collapses the reference's image_view/image_span/image_data trio
    (image.h:37-98) — numpy views provide non-owning references natively.
    ``extent`` is (width, height) like the reference. ``eq=False``:
    a generated __eq__ would tuple-compare the arrays and raise the numpy
    ambiguous-truth-value error; identity comparison is the useful default
    (compare pixels with image_difference_rms).
    """

    data: np.ndarray  # (H, W, C), uint8 or float32
    format: ImageFormat

    def __post_init__(self):
        if self.data.ndim == 2:
            self.data = self.data[:, :, None]
        want = np.float32 if is_float(self.format) else np.uint8
        if self.data.dtype != want:
            raise_error("image dtype {} does not match format {}", self.data.dtype, self.format)
        if self.data.shape[2] != n_channels(self.format):
            raise_error(
                "image has {} channels, format {} expects {}",
                self.data.shape[2], self.format, n_channels(self.format),
            )

    @property
    def extent(self) -> tuple[int, int]:
        return (self.data.shape[1], self.data.shape[0])

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def channels(self) -> int:
        return self.data.shape[2]

    @property
    def n_pixels(self) -> int:
        """(reference image.h:60)."""
        return self.data.shape[0] * self.data.shape[1]

    @property
    def n_bytes(self) -> int:
        """(reference image.h:61)."""
        return self.data.nbytes

    def load_f32x4(self) -> np.ndarray:
        """Read pixels through the reference's 4-lane load semantics
        (image-impl.h:17-55): u8 normalized to [0,1]; alpha splats to all
        lanes; rgb gets lane-3 = 1.0 (f32) or 1/255 (u8 — the reference
        divides the whole {r,g,b,1} vector by 255). Returns (H, W, 4) f32."""
        a = self.data.astype(np.float32)
        u8 = not is_float(self.format)
        if u8:
            a = a / 255.0
        c = self.channels
        if c == 1:
            return np.repeat(a, 4, axis=2)
        if c == 3:
            lane3 = np.full_like(a[:, :, :1], (1.0 / 255.0) if u8 else 1.0)
            return np.concatenate([a, lane3], axis=2)
        m = channel_map(self.format)
        return a[:, :, list(m)]

    def to_rgb_u8(self) -> np.ndarray:
        """(H, W, 3) uint8 in RGB order regardless of stored format —
        channel-map aware (bgra/argb), grayscale replicated, f32 scaled."""
        a = self.data
        if is_float(self.format):
            a = (np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
        if self.channels == 1:
            return np.repeat(a, 3, axis=2)
        m = channel_map(self.format)
        return np.ascontiguousarray(a[:, :, list(m[:3])])

    def copy(self) -> "Image":
        return Image(self.data.copy(), self.format)


def _store_u8(f32x4: np.ndarray, fmt: ImageFormat) -> np.ndarray:
    """Reference image_store semantics: clamp [0,1], *255, truncate."""
    v = np.clip(f32x4, 0.0, 1.0) * 255.0
    v = v.astype(np.uint8)  # C-style truncation
    return v[:, :, : n_channels(fmt)]


def image_alloc(extent: tuple[int, int], fmt: ImageFormat) -> Image:
    """A zeroed image of ``extent`` = (width, height)."""
    dtype = np.float32 if is_float(fmt) else np.uint8
    return Image(np.zeros((extent[1], extent[0], n_channels(fmt)), dtype), fmt)


def _format_from_channels(c: int, float_: bool = False) -> ImageFormat:
    if float_:
        return {1: ImageFormat.alpha_f32, 3: ImageFormat.rgb_f32, 4: ImageFormat.rgba_f32}[c]
    return {1: ImageFormat.alpha_u8, 3: ImageFormat.rgb_u8, 4: ImageFormat.rgba_u8}[c]


def image_load_array(array: np.ndarray, fmt: ImageFormat | None = None) -> Image:
    """Wrap an (H, W) or (H, W, C) array as an Image; the format follows the
    channel count and dtype unless given."""
    a = np.asarray(array)
    if a.ndim == 2:
        a = a[:, :, None]
    if fmt is None:
        fmt = _format_from_channels(a.shape[2], float_=np.issubdtype(a.dtype, np.floating))
    dtype = np.float32 if is_float(fmt) else np.uint8
    return Image(np.ascontiguousarray(a.astype(dtype)), fmt)


def image_u8_to_f32(
    src: Image,
    dst_format: ImageFormat | Image,
    offset=(0.0, 0.0, 0.0, 0.0),
    scale=(1.0, 1.0, 1.0, 1.0),
    tile_offset: tuple[int, int] = (0, 0),
    dst_extent: tuple[int, int] | None = None,
) -> Image:
    """(src/255 + offset) * scale with replicate-padded tiled reads
    (reference image.cpp:215-255)."""
    if isinstance(dst_format, Image):
        dst = dst_format
        dst_format_ = dst.format
        dst_extent = dst.extent
    else:
        dst = None
        dst_format_ = dst_format
        if dst_extent is None:
            dst_extent = src.extent
    if is_float(src.format) or not is_float(dst_format_):
        raise_error("image_u8_to_f32 requires u8 source and f32 destination")
    def _lane4(v, neutral: float) -> np.ndarray:
        # rgb-only constants (e.g. the shared IMAGENET_MEAN/STD 3-tuples)
        # get a neutral 4th lane instead of a broadcast error
        v = np.asarray(v, np.float32)
        if v.ndim == 1 and v.shape[0] == 3:
            v = np.concatenate([v, np.float32([neutral])])
        return np.asarray(np.broadcast_to(v, (4,)))

    offset = _lane4(offset, 0.0)
    scale = _lane4(scale, 1.0)

    dw, dh = dst_extent
    ox, oy = tile_offset
    xs = np.minimum(np.arange(dw) + ox, src.width - 1)
    ys = np.minimum(np.arange(dh) + oy, src.height - 1)
    pix = src.load_f32x4()[np.ix_(ys, xs)]  # (dh, dw, 4)
    out4 = (pix + offset) * scale
    c = n_channels(dst_format_)
    out = out4[:, :, :c].astype(np.float32)
    if dst is not None:
        dst.data[:] = out
        return dst
    return Image(np.ascontiguousarray(out), dst_format_)


def image_f32_to_u8(
    src: Image, dst_format: ImageFormat, scale: float = 1.0, offset: float = 0.0
) -> Image:
    """src * scale + offset, clamp, truncate (reference image.cpp:257-288)."""
    if not is_float(src.format) or is_float(dst_format):
        raise_error("image_f32_to_u8 requires f32 source and u8 destination")
    if dst_format in (ImageFormat.bgra_u8, ImageFormat.argb_u8):
        # the store is unmapped RGBA lane order; the reference's image_data
        # target likewise asserts bgra/argb are not supported for writing
        raise_error("image_f32_to_u8 does not support writing {}", dst_format)
    out4 = src.load_f32x4() * np.float32(scale) + np.float32(offset)
    return Image(np.ascontiguousarray(_store_u8(out4, dst_format)), dst_format)


def image_set_alpha(img: Image, alpha: Image) -> None:
    """Write an alpha mask into a 4-channel u8 image's alpha channel, in
    place (reference image.cpp:310-323; the JAX package's
    image/image.py:324)."""
    if img.extent != alpha.extent:
        raise_error("extent mismatch in image_set_alpha")
    if is_float(img.format) or img.channels != 4:
        raise_error("image_set_alpha requires 4-channel u8 image")
    if alpha.format != ImageFormat.alpha_u8:
        # the reference asserts alpha.format == alpha_u8 (image.cpp:313); a
        # f32 mask would silently truncate to 0/1 here
        raise_error("image_set_alpha requires an alpha_u8 mask")
    img.data[:, :, channel_map(img.format)[3]] = alpha.data[:, :, 0]


def _bilinear_resize_f32(a: np.ndarray, target: tuple[int, int]) -> np.ndarray:
    """Bilinear resize, half-pixel centers, clamped edges — the shared
    resize_matrix weights (identical semantics) via the BLAS contraction."""
    from ..ops.resize import resize_matrix

    tw, th = target
    wy = resize_matrix(a.shape[0], th, "bilinear", False)
    wx = resize_matrix(a.shape[1], tw, "bilinear", False)
    squeeze = a.ndim == 2
    out = _resize_apply(wy, wx, a[:, :, None] if squeeze else a)
    return out[:, :, 0] if squeeze else out


def _srgb_to_linear(u: np.ndarray) -> np.ndarray:
    return np.where(u <= 0.04045, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)


_SRGB_LUT: np.ndarray | None = None


def _srgb_lut() -> np.ndarray:
    """u8 -> linear f32 as an exact 256-entry table (u8 quantization makes
    the sRGB decode a lookup — identical values, no per-pixel powf)."""
    global _SRGB_LUT
    if _SRGB_LUT is None:
        _SRGB_LUT = _srgb_to_linear(np.arange(256, dtype=np.float32) / 255.0).astype(np.float32)
    return _SRGB_LUT


def _resize_apply(wy: np.ndarray, wx: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Separable resize via BLAS: (Oh,h)@(h,w,c) then (w-contraction) with
    (Ow,w). Replaces np.einsum, which runs naive loops for these shapes
    (measured 14 s for one 720p->1024² resize; this path is the serving
    prep hot loop)."""
    out = np.tensordot(wy, a, axes=(1, 0))  # (Oh, w, c)
    out = np.tensordot(out, wx, axes=(1, 1))  # (Oh, c, Ow)
    return np.moveaxis(out, 2, 1)  # (Oh, Ow, c)


def _linear_to_srgb(v: np.ndarray) -> np.ndarray:
    v = np.clip(v, 0.0, 1.0)
    return np.where(v <= 0.0031308, v * 12.92, 1.055 * v ** (1 / 2.4) - 0.055)


_STB_ALPHA_EPS = 1.0 / (1 << 20)  # STBIR_ALPHA_EPSILON (stb v1)


def _stb_axis_matrices(img: Image, target: tuple[int, int]):
    """stb v1 STBIR_FILTER_DEFAULT resolves PER AXIS: Catmull-Rom when
    upsampling, scaled Mitchell otherwise — stbir__use_upsampling is
    ``ratio > 1``, so an UNCHANGED axis takes the Mitchell (downsample)
    filter and is softened slightly, exactly like stb."""
    from ..ops.resize import resize_matrix

    fy = "catmullrom" if target[1] > img.height else "mitchell"
    fx = "catmullrom" if target[0] > img.width else "mitchell"
    return (
        resize_matrix(img.height, target[1], fy, False),
        resize_matrix(img.width, target[0], fx, False),
    )


def _image_scale_stb_u8(img: Image, target: tuple[int, int]) -> Image:
    """stb_image_resize v1-compatible u8 path (reference image.cpp:338-343
    calls stbir_resize_uint8_generic with FILTER_DEFAULT, COLORSPACE_SRGB,
    flags=0): Catmull-Rom up / scaled Mitchell down per axis, sRGB-aware
    color channels, the alpha channel filtered linearly, and
    alpha-premultiplied resampling with STBIR_ALPHA_EPSILON (transparent
    texels keep their color through the resize)."""
    ach = alpha_channel(img.format)
    if img.channels == 1:
        # alpha_u8: the sole channel IS the alpha channel (reference
        # alpha_channel()=0) — filtered LINEARLY, no sRGB decode/encode
        lin = img.data.astype(np.float32) / 255.0
    else:
        lin = _srgb_lut()[img.data]  # exact u8 sRGB decode, no per-pixel powf
        if ach is not None and ach >= 0:
            lin[:, :, ach] = img.data[:, :, ach].astype(np.float32) / 255.0
    if img.channels == 4:
        # premultiply with the stb epsilon: alpha' = alpha + eps keeps the
        # color of fully transparent pixels recoverable after filtering
        alpha = lin[:, :, ach] + _STB_ALPHA_EPS
        for ch in range(4):
            if ch != ach:
                lin[:, :, ch] = lin[:, :, ch] * alpha
        lin[:, :, ach] = alpha
    wy, wx = _stb_axis_matrices(img, target)
    out = _resize_apply(wy, wx, lin)
    if img.channels == 4:
        alpha_r = out[:, :, ach]  # includes the filtered epsilon: never 0
        for ch in range(4):
            if ch != ach:
                out[:, :, ch] = out[:, :, ch] / alpha_r
        out[:, :, ach] = alpha_r - _STB_ALPHA_EPS
    u8 = np.empty((target[1], target[0], img.channels), np.float32)
    if img.channels == 1:
        u8[:, :, 0] = np.clip(out[:, :, 0], 0.0, 1.0)
    else:
        for ch in range(img.channels):
            if ch != ach:
                u8[:, :, ch] = _linear_to_srgb(out[:, :, ch])
            else:
                u8[:, :, ch] = np.clip(out[:, :, ch], 0.0, 1.0)
    return Image(np.ascontiguousarray((u8 * 255.0 + 0.5).astype(np.uint8)), img.format)


def preprocess_scale_method() -> str:
    """Resize semantics for model pre/post-processing paths: "stb" —
    byte-compatible with the reference's image_scale (image.cpp:328-356) so
    outputs match its golden images — unless VISP_RESIZE=torch selects PIL
    bilinear (the semantics the models were trained with)."""
    import os

    return (
        "torch"
        if os.environ.get("VISP_RESIZE", "").lower() in ("torch", "pil", "bilinear")
        else "stb"
    )


def _image_scale_stb_f32(img: Image, target: tuple[int, int]) -> Image:
    """stb float path (reference image.cpp:333-337: FILTER_DEFAULT,
    COLORSPACE_LINEAR, flags=0): Catmull-Rom up / scaled Mitchell down per
    axis, CLAMP edges, no sRGB. stb v1 gates STBIR_ALPHA_EPSILON on
    ``type != STBIR_TYPE_FLOAT`` — the float path premultiplies by RAW
    alpha and unpremultiplies with ``alpha ? 1/alpha : 0``, so fully
    transparent pixels come out with color 0 (unlike the u8 path)."""
    ach = alpha_channel(img.format)
    a = img.data.astype(np.float32)  # astype copies: safe to write below
    premult = img.channels == 4 and ach is not None and ach >= 0
    if premult:
        alpha = a[:, :, ach].copy()
        for ch in range(4):
            if ch != ach:
                a[:, :, ch] = a[:, :, ch] * alpha
    wy, wx = _stb_axis_matrices(img, target)
    out = _resize_apply(wy, wx, a)
    if premult:
        alpha_r = out[:, :, ach]
        with np.errstate(divide="ignore"):
            recip = np.where(alpha_r != 0.0, 1.0 / alpha_r, 0.0)
        for ch in range(4):
            if ch != ach:
                out[:, :, ch] = out[:, :, ch] * recip
    return Image(np.ascontiguousarray(out.astype(np.float32)), img.format)


def image_scale(img: Image, target: tuple[int, int], method: str = "auto") -> Image:
    """Resize (reference image_scale, image.cpp:328-356: stb Catmull-Rom,
    CLAMP edges; sRGB-aware for u8).

    method="auto" uses PIL bilinear for u8 (matching the torch-side
    preprocessing the models were trained with) and half-pixel-center
    bilinear for f32; method="stb" reproduces the reference's
    stb_image_resize semantics (Catmull-Rom + sRGB + alpha premultiply for
    u8, Catmull-Rom linear for f32). Model pre/post-processing paths pass
    ``preprocess_scale_method()`` (stb by default, VISP_RESIZE=torch to
    opt out)."""
    if target == img.extent:
        return img.copy()
    if is_float(img.format):
        if method == "stb":
            return _image_scale_stb_f32(img, target)
        out = _bilinear_resize_f32(img.data.astype(np.float32), target)
        return Image(np.ascontiguousarray(out.astype(np.float32)), img.format)
    if method == "stb":
        return _image_scale_stb_u8(img, target)
    from PIL import Image as PILImage

    a = img.data
    mode = {1: "L", 3: "RGB", 4: "RGBA"}[a.shape[2]]
    pil = PILImage.fromarray(a.squeeze(2) if mode == "L" else a, mode)
    out = np.asarray(pil.resize(target, PILImage.BILINEAR))
    if out.ndim == 2:
        out = out[:, :, None]
    return Image(np.ascontiguousarray(out), img.format)


def image_normalize(src: Image, min_val: float = 0.0, max_val: float = 1.0) -> Image:
    """Per-channel min/max rescale (reference image.cpp:537-582)."""
    if not is_float(src.format):
        raise_error("image_normalize requires float format")
    a = src.data.astype(np.float32)
    lo = a.min(axis=(0, 1))
    hi = a.max(axis=(0, 1))
    delta = hi - lo
    delta = np.where(delta < 1e-5, 1.0, delta)
    scale = (max_val - min_val) / delta
    out = (a - lo) * scale + min_val
    return Image(np.ascontiguousarray(out.astype(np.float32)), src.format)


