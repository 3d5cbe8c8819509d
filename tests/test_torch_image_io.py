"""The port's image layer against the JAX package's: PNG files through the
port's own codec (image/png.py) both ways against PIL and the JAX
image_load, other formats through PIL, the filters and composites (exact for
u8, atol 1e-5 for f32), the host-ops library against its numpy forms, psnr
and ssim, and YOLOv9t's draw_detections with and without PIL."""

import io
import struct
import sys
import tracemalloc
import zlib

import numpy as np
import pytest
from PIL import Image as PILImage
from PIL import ImageDraw

from test_torch_api import sample_image
from vision_tpu import image as jimage
from vision_tpu.models import yolov9t as jyolo
from vision_tpu.utils import metrics as jmetrics
from vision_tpu_torch import image as timage
from vision_tpu_torch import native
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.image import png
from vision_tpu_torch.image.image import box_blur_plain, erosion_plain
from vision_tpu_torch.models import yolov9t as tyolo
from vision_tpu_torch.utils import metrics as tmetrics

F32_ATOL = 1e-5


def _same(port_img, jax_img, atol=0.0):
    assert port_img.format.value == jax_img.format.value
    assert port_img.data.dtype == jax_img.data.dtype and port_img.data.shape == jax_img.data.shape
    if atol:
        np.testing.assert_allclose(port_img.data, jax_img.data, atol=atol, rtol=0)
    else:
        np.testing.assert_array_equal(port_img.data, jax_img.data)


def _without_pil(monkeypatch):
    """Make ``from PIL import ...`` raise ImportError, as on a machine
    without PIL."""
    monkeypatch.setitem(sys.modules, "PIL", None)


# -- PNG --


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("hw", [(1, 1), (7, 5), (72, 96)])
def test_port_written_png_decodes_in_pil(tmp_path, channels, hw):
    px = sample_image(*hw, channels=max(channels, 3))[:, :, :channels]
    timage.image_save(timage.image_load_array(px), tmp_path / "a.png")
    pil = np.asarray(PILImage.open(tmp_path / "a.png"))
    np.testing.assert_array_equal(pil.reshape(px.shape), px)
    assert PILImage.open(tmp_path / "a.png").mode == {1: "L", 3: "RGB", 4: "RGBA"}[channels]


def _pil_files(tmp_path):
    """PIL-written PNGs of every colour type in scope, with an image whose
    scanlines PIL filters with Average and Paeth, not only None/Sub/Up."""
    rgb = sample_image(61, 83)
    gray = rgb[:, :, 0]
    files = {
        "RGB": PILImage.fromarray(rgb),
        "RGBA": PILImage.fromarray(sample_image(61, 83, 4)),
        "L": PILImage.fromarray(gray),
        "LA": PILImage.fromarray(np.stack([gray, rgb[:, :, 1]], -1), "LA"),
        "P": PILImage.fromarray(rgb).quantize(40),
    }
    out = {}
    for name, pil in files.items():
        out[name] = tmp_path / f"{name}.png"
        pil.save(out[name])
    pal = files["P"]
    pal.save(tmp_path / "P_trns_one.png", transparency=3)  # one transparent index
    pal.save(tmp_path / "P_trns_table.png", transparency=bytes(range(0, 240, 6)))  # an alpha per entry
    out["P_trns_one"], out["P_trns_table"] = tmp_path / "P_trns_one.png", tmp_path / "P_trns_table.png"
    PILImage.fromarray(rgb).save(tmp_path / "RGB_key.png", transparency=(1, 2, 3))  # an RGB colour key
    out["RGB_key"] = tmp_path / "RGB_key.png"
    PILImage.fromarray(rgb).save(tmp_path / "RGB_opt.png", optimize=True, compress_level=9)
    out["RGB_opt"] = tmp_path / "RGB_opt.png"
    return out


@pytest.mark.parametrize("kind", ["RGB", "RGBA", "L", "LA", "P", "P_trns_one", "P_trns_table", "RGB_key", "RGB_opt"])
def test_pil_written_png_loads_as_the_jax_image_load(tmp_path, kind, monkeypatch):
    path = _pil_files(tmp_path)[kind]
    want = jimage.image_load(path)
    _same(timage.image_load(path), want)
    _without_pil(monkeypatch)  # the port's codec alone
    _same(timage.image_load(path), want)


def test_png_scanline_filters_all_decode():
    """Each of the five filters, and a mix, through both decoding paths."""
    rng = np.random.default_rng(3)
    f = rng.integers(0, 256, (23, 17, 3)).astype(np.uint8)

    def loop(ft, f):
        h, w, bpp = f.shape
        f = f.astype(np.int64)
        x = np.zeros((h, w, bpp), np.int64)
        for r in range(h):
            for c in range(w):
                a, b, d = (x[r, c - 1] if c else 0), (x[r - 1, c] if r else 0), (x[r - 1, c - 1] if r and c else 0)
                p = a + b - d
                paeth = np.where((abs(p - a) <= abs(p - b)) & (abs(p - a) <= abs(p - d)), a,
                                 np.where(abs(p - b) <= abs(p - d), b, d))
                x[r, c] = (f[r, c] + [0, a, b, (a + b) // 2, paeth][ft[r]]) % 256
        return x.astype(np.uint8)

    for ft in [np.full(23, t, np.uint8) for t in range(5)] + [rng.integers(0, 5, 23).astype(np.uint8),
                                                             rng.integers(0, 3, 23).astype(np.uint8)]:
        np.testing.assert_array_equal(png._unfilter(ft, f), loop(ft, f))


def _filtered_png(x: np.ndarray, ft: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of pixels ``x`` (H, W, 3) whose row y takes scanline
    filter ``ft[y]`` (0 None ... 4 Paeth)."""
    h, w, bpp = x.shape
    xi = x.astype(np.int16)
    a = np.zeros_like(xi)
    a[:, 1:] = xi[:, :-1]
    b = np.zeros_like(xi)
    b[1:] = xi[:-1]
    c = np.zeros_like(xi)
    c[1:, 1:] = xi[:-1, :-1]
    pred = np.stack([np.zeros_like(xi), a, b, (a + b) >> 1, png._paeth(a, b, c)])[ft, np.arange(h)]
    rows = np.empty((h, 1 + w * bpp), np.uint8)
    rows[:, 0] = ft
    rows[:, 1:] = ((xi - pred) % 256).astype(np.uint8).reshape(h, w * bpp)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (png.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def test_tall_paeth_png_decodes_as_pil_in_memory_linear_in_its_pixels():
    """A 4000-row, 300-column RGB PNG, Paeth rows with a few of every other
    filter, decodes to PIL's pixels, and the decoder's peak allocation stays
    within 8x the image's bytes (a skewed copy of H (H + W) pixels would
    need ~57x here)."""
    rng = np.random.default_rng(5)
    h, w = 4000, 300
    y, x = np.mgrid[0:h, 0:w]
    px = np.stack([(x + y) % 256, (2 * x) % 256, (y // 3) % 256], -1) + rng.integers(0, 9, (h, w, 3))
    px = px.clip(0, 255).astype(np.uint8)
    ft = np.where(rng.random(h) < 0.9, 4, rng.integers(0, 4, h)).astype(np.uint8)
    data = _filtered_png(px, ft)
    tracemalloc.start()
    try:
        got = png.read_png(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, np.asarray(PILImage.open(io.BytesIO(data))))
    np.testing.assert_array_equal(got, px)
    assert peak <= 8 * px.nbytes, f"read_png peaked at {peak} bytes for a {px.nbytes}-byte image"


def test_png_outside_the_codec_goes_through_pil(tmp_path, monkeypatch):
    """A 16-bit PNG is outside the codec: PIL reads it as the JAX package
    does; without PIL the error names it."""
    PILImage.fromarray(np.arange(120, dtype=np.uint16).reshape(10, 12) * 500).save(tmp_path / "g16.png")
    _same(timage.image_load(tmp_path / "g16.png"), jimage.image_load(tmp_path / "g16.png"))
    _without_pil(monkeypatch)
    with pytest.raises(VispError, match="PIL"):
        timage.image_load(tmp_path / "g16.png")


def test_other_formats_go_through_pil(tmp_path, monkeypatch):
    img = timage.image_load_array(sample_image(40, 48))
    timage.image_save(img, tmp_path / "a.jpg")
    jimage.image_save(jimage.image_load_array(sample_image(40, 48)), tmp_path / "b.jpg")
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    _same(timage.image_load(tmp_path / "a.jpg"), jimage.image_load(tmp_path / "a.jpg"))
    _without_pil(monkeypatch)
    with pytest.raises(VispError, match="PIL is not installed"):
        timage.image_load(tmp_path / "a.jpg")
    with pytest.raises(VispError, match="PIL is not installed"):
        timage.image_save(img, tmp_path / "c.jpg")


def test_damaged_png_raises(tmp_path):
    timage.image_save(timage.image_load_array(sample_image(8, 8)), tmp_path / "a.png")
    data = bytearray((tmp_path / "a.png").read_bytes())
    data[40] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    (tmp_path / "b.png").write_bytes(bytes(data))
    with pytest.raises(VispError, match="CRC"):
        timage.image_load(tmp_path / "b.png")
    with pytest.raises(VispError, match="Failed to load image"):
        timage.image_load(tmp_path / "missing.png")
    with pytest.raises(VispError, match="Unsupported image format for saving"):
        timage.image_save(timage.image_load_array(np.zeros((2, 2, 3), np.float32)), tmp_path / "f.png")


# -- filters and composites against the JAX package --


def _f32(rng, h, w, c):
    return rng.random((h, w, c), dtype=np.float32)


@pytest.mark.parametrize("radius", [1, 5, 30])
@pytest.mark.parametrize("fmt,c", [("alpha_f32", 1), ("rgba_f32", 4)])
def test_image_blur_matches_jax(radius, fmt, c):
    a = _f32(np.random.default_rng(radius), 37, 53, c)
    got = timage.image_blur(timage.Image(a, timage.ImageFormat[fmt]), radius)
    _same(got, jimage.image_blur(jimage.Image(a, jimage.ImageFormat[fmt]), radius), atol=F32_ATOL)
    with pytest.raises(VispError, match="blur radius"):
        timage.image_blur(timage.Image(a, timage.ImageFormat[fmt]), 0)


@pytest.mark.parametrize("radius", [0, 1, 4])
@pytest.mark.parametrize("fmt", ["alpha_u8", "alpha_f32"])
def test_image_erosion_matches_jax(radius, fmt):
    rng = np.random.default_rng(radius)
    a = rng.integers(0, 256, (29, 31, 1)).astype(np.uint8) if fmt == "alpha_u8" else _f32(rng, 29, 31, 1)
    got = timage.image_erosion(timage.Image(a, timage.ImageFormat[fmt]), radius)
    _same(got, jimage.image_erosion(jimage.Image(a, jimage.ImageFormat[fmt]), radius), atol=F32_ATOL * (fmt != "alpha_u8"))


@pytest.mark.parametrize("radius", [3, 30])
def test_image_estimate_foreground_matches_jax(radius):
    rng = np.random.default_rng(radius)
    img, mask = _f32(rng, 40, 50, 4), _f32(rng, 40, 50, 1)
    got = timage.image_estimate_foreground(timage.Image(img, timage.ImageFormat.rgba_f32),
                                           timage.Image(mask, timage.ImageFormat.alpha_f32), radius)
    want = jimage.image_estimate_foreground(jimage.Image(img, jimage.ImageFormat.rgba_f32),
                                            jimage.Image(mask, jimage.ImageFormat.alpha_f32), radius)
    _same(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("fg_fmt,c", [("rgba_u8", 4), ("rgb_u8", 3), ("rgba_f32", 4)])
def test_image_alpha_composite_matches_jax(fg_fmt, c):
    rng = np.random.default_rng(c)
    fg = rng.integers(0, 256, (17, 19, c)).astype(np.uint8) if "u8" in fg_fmt else _f32(rng, 17, 19, c)
    bg = rng.integers(0, 256, (17, 19, 4)).astype(np.uint8)
    mask = rng.integers(0, 256, (17, 19, 1)).astype(np.uint8)
    got = timage.image_alpha_composite(timage.Image(fg, timage.ImageFormat[fg_fmt]),
                                       timage.Image(bg, timage.ImageFormat.rgba_u8),
                                       timage.Image(mask, timage.ImageFormat.alpha_u8))
    want = jimage.image_alpha_composite(jimage.Image(fg, jimage.ImageFormat[fg_fmt]),
                                        jimage.Image(bg, jimage.ImageFormat.rgba_u8),
                                        jimage.Image(mask, jimage.ImageFormat.alpha_u8))
    _same(got, want)


@pytest.mark.parametrize("fmt,c,u8", [("rgba_u8", 4, True), ("rgb_u8", 3, True), ("alpha_u8", 1, True),
                                      ("rgb_f32", 3, False), ("alpha_f32", 1, False)])
def test_difference_rms_to_mask_and_clear_match_jax(fmt, c, u8):
    rng = np.random.default_rng(c)
    a, b = ((rng.integers(0, 256, (13, 11, c)).astype(np.uint8) for _ in range(2)) if u8
            else (_f32(rng, 13, 11, c) for _ in range(2)))
    t = (timage.Image(a.copy(), timage.ImageFormat[fmt]), timage.Image(b, timage.ImageFormat[fmt]))
    j = (jimage.Image(a.copy(), jimage.ImageFormat[fmt]), jimage.Image(b, jimage.ImageFormat[fmt]))
    assert timage.image_difference_rms(*t) == jimage.image_difference_rms(*j)
    if u8:
        _same(timage.image_to_mask(t[0]), jimage.image_to_mask(j[0]))
    timage.image_clear(t[0])
    jimage.image_clear(j[0])
    _same(t[0], j[0])
    with pytest.raises(VispError, match="extent mismatch"):
        timage.image_difference_rms(t[0], timage.image_alloc((3, 3), timage.ImageFormat[fmt]))


# -- the host-ops library against its numpy forms --


@pytest.mark.parametrize("radius", [0, 1, 2, 17, 60])
@pytest.mark.parametrize("shape", [(1, 1, 1), (9, 40, 4), (33, 7, 3)])
def test_native_box_blur_matches_numpy(shape, radius):
    a = _f32(np.random.default_rng(radius), *shape)
    np.testing.assert_allclose(native.box_blur(a, radius), box_blur_plain(a, radius), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("radius", [0, 1, 3, 50])
@pytest.mark.parametrize("shape", [(1, 1), (9, 40), (33, 7)])
def test_native_erosion_matches_numpy(shape, radius):
    a = _f32(np.random.default_rng(radius), *shape, 1)
    np.testing.assert_array_equal(native.erosion_f32(a, radius), erosion_plain(a, radius)[:, :, 0])


def test_native_rejects_bad_sizes():
    with pytest.raises(ValueError, match="radius"):
        native.box_blur(np.zeros((2, 2, 1), np.float32), -1)
    with pytest.raises(ValueError, match="one channel"):
        native.erosion_f32(np.zeros((2, 2, 2), np.float32), 1)


def test_native_library_builds_into_build():
    native.load_library()
    path = native.library_path()
    assert path.parent.name == "vision_tpu_torch" and path.parent.parent.name == "build" and path.exists()


# -- psnr / ssim --


@pytest.mark.parametrize("window", [11, 7])
@pytest.mark.parametrize("noise", [0.01, 0.2])
def test_psnr_ssim_match_jax(noise, window):
    rng = np.random.default_rng(int(noise * 100) + window)
    a = _f32(rng, 40, 50, 3)
    b = np.clip(a + rng.normal(0, noise, a.shape).astype(np.float32), 0, 1)
    np.testing.assert_allclose(tmetrics.psnr(a, b), float(jmetrics.psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.ssim(a, b, window=window), float(jmetrics.ssim(a, b, window=window)), rtol=1e-6)
    np.testing.assert_allclose(tmetrics.ssim(a[None], b[None]), float(jmetrics.ssim(a[None], b[None])), rtol=1e-6)
    assert tmetrics.psnr(a, a) == float("inf")


# -- draw_detections --


def _detections(module, extent):
    rng = np.random.default_rng(5)
    w, h = extent
    dets = []
    for i in range(12):
        x1, y1 = max(rng.uniform(-5, w), 0.0), max(rng.uniform(-5, h), 0.0)
        dets.append(module.Detection(x1, y1, min(x1 + rng.uniform(0, 40), w), min(y1 + rng.uniform(0, 30), h),
                                     float(rng.random()), int(rng.integers(0, 90))))  # ids past 80 too
    return dets


def test_get_class_color_matches_jax():
    for c in range(200):
        assert tyolo.get_class_color(c) == jyolo.get_class_color(c)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_draw_detections_matches_jax(channels):
    px = sample_image(72, 96, max(channels, 3))[:, :, :channels]
    got = tyolo.draw_detections(timage.image_load_array(px), _detections(tyolo, (96, 72)))
    _same(got, jyolo.draw_detections(jimage.image_load_array(px), _detections(jyolo, (96, 72))))


def test_draw_detections_without_pil_colours_the_boxes_and_bars_pil_would(monkeypatch):
    """Without PIL: the outlines and label bars on PIL's pixels, the bar 6
    pixels a character wide, no text."""
    px = sample_image(72, 96)
    dets = _detections(tyolo, (96, 72))
    pil = PILImage.fromarray(px.copy())
    draw = ImageDraw.Draw(pil)
    for d in dets:
        color = tyolo.get_class_color(d.class_id)
        label = f"{tyolo._class_name(d.class_id)} {d.confidence:.2f}"
        draw.rectangle([d.x1, d.y1, d.x2, d.y2], outline=color, width=2)
        draw.rectangle([d.x1, max(0, d.y1 - 12), d.x1 + 6 * len(label) + 4, d.y1], fill=color)
    want = np.asarray(pil)
    _without_pil(monkeypatch)
    got = tyolo.draw_detections(timage.image_load_array(px), dets)
    assert got.format == timage.ImageFormat.rgb_u8
    np.testing.assert_array_equal(got.data, want)


@pytest.mark.parametrize("width", [1, 2, 3])
def test_numpy_rectangles_are_pils(width):
    rng = np.random.default_rng(width)
    for k in range(300):
        h, w = rng.integers(5, 40, 2)
        x0, y0 = rng.uniform(-3, w + 2), rng.uniform(-3, h + 2)
        x1, y1 = x0 + rng.uniform(0, 20) * (k % 5 != 0), y0 + rng.uniform(0, 20) * (k % 7 != 0)
        fill = bool(k % 2)
        a = np.zeros((h, w, 3), np.uint8)
        pil = PILImage.fromarray(a.copy())
        if fill:
            ImageDraw.Draw(pil).rectangle([x0, y0, x1, y1], fill=(1, 2, 3))
        else:
            ImageDraw.Draw(pil).rectangle([x0, y0, x1, y1], outline=(1, 2, 3), width=width)
        tyolo._rectangle(a, (x0, y0, x1, y1), (1, 2, 3), fill=fill, width=width)
        np.testing.assert_array_equal(a, np.asarray(pil), err_msg=f"{(h, w)} {(x0, y0, x1, y1)} fill={fill}")


def test_png_round_trip_without_pil(tmp_path, monkeypatch):
    _without_pil(monkeypatch)
    for c in (1, 3, 4):
        img = timage.image_load_array(sample_image(30, 20, 4)[:, :, :c])
        timage.image_save(img, tmp_path / f"{c}.png")
        back = timage.image_load(tmp_path / f"{c}.png")
        assert back.format == img.format and timage.image_difference_rms(img, back) == 0


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_result_u8_is_the_jax_endpoints_conversion(channels, dtype):
    """The u8 pixels the port's front ends write of a server result are the
    JAX HTTP endpoint's: floats by clip, x 255, + 0.5 (half levels, values
    outside [0, 1]), u8 as given; read back from the JAX package's PNG."""
    from vision_tpu import serve_http as jhttp
    from vision_tpu_torch.image.image import result_u8

    rng = np.random.default_rng(channels)
    if dtype == np.float32:
        a = rng.uniform(-0.2, 1.2, (6, 7, channels)).astype(np.float32)
        a.flat[:4] = (np.arange(4, dtype=np.float32) + 0.5) / 255  # exactly half a level
    else:
        a = rng.integers(0, 256, (6, 7, channels), dtype=np.uint8)
    fmt = {1: jimage.ImageFormat.alpha_f32, 3: jimage.ImageFormat.rgb_f32, 4: jimage.ImageFormat.rgba_f32}
    if dtype == np.uint8:
        fmt = {1: jimage.ImageFormat.alpha_u8, 3: jimage.ImageFormat.rgb_u8, 4: jimage.ImageFormat.rgba_u8}
    want = np.asarray(PILImage.open(io.BytesIO(jhttp._png_bytes(jimage.Image(a, fmt[channels])))))
    got = result_u8(a)
    assert got.dtype == np.uint8 and got.shape == a.shape
    np.testing.assert_array_equal(got, want.reshape(a.shape))
    np.testing.assert_array_equal(result_u8(a[:, :, 0]), got[:, :, :1])  # a 2-D map gains its channel axis
