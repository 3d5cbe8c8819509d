"""Python side of the model-level C ABI — the port of vision_tpu/capi.py
(reference src/visp/c-api.cpp).

The native shim ``native/c_api.cpp`` embeds CPython and calls the functions
in this module with primitive-typed arguments (ints, bytes), keeping all
marshalling here. Families and formats cross the ABI as integers:

  family: 0=sam 1=birefnet 2=depth_anything 3=migan 4=esrgan 5=yolov9t
          (reference vision.h model_family order; -1 = detect from file)
  format: index into FORMATS below (reference image.h image_format order)

``model_compute`` mirrors the reference's per-family model_funcs
(c-api.cpp:30-118): sam consumes one image + a 2-int point or 4-int box
prompt; migan consumes image + alpha_u8 mask; the rest consume one image.
Family 5 (yolov9t) extends past the reference's five image->image families:
it consumes one image plus optional [conf, iou] thresholds in permille and
returns the image with the detections drawn.

Device codes: 0 is the default device, which in the port is the CUDA card
(``backend_init()`` raises without one; the JAX package falls back to the
CPU there), 1 the CPU, 2 the card."""

from __future__ import annotations

import threading

import numpy as np

from .core.device import BackendType, backend_init
from .image import Image, ImageFormat, image_f32_to_u8, image_normalize

FAMILIES = ("sam", "birefnet", "depth_anything", "migan", "esrgan", "yolov9t")
FORMATS = (
    ImageFormat.rgba_u8,
    ImageFormat.bgra_u8,
    ImageFormat.argb_u8,
    ImageFormat.rgb_u8,
    ImageFormat.alpha_u8,
    ImageFormat.rgba_f32,
    ImageFormat.rgb_f32,
    ImageFormat.alpha_f32,
)


def device_init(type_int: int):
    """0 = the default device (the card), 1 = cpu, 2 = the card."""
    if type_int == 1:
        return backend_init(BackendType.cpu)
    if type_int == 2:
        return backend_init(BackendType.gpu)
    return backend_init()


def device_type(device) -> int:
    return {BackendType.cpu: 1, BackendType.gpu: 2}.get(device.type, 0)


def device_name(device) -> str:
    if device.torch_device.type == "cuda":
        import torch

        return torch.cuda.get_device_name(device.torch_device)
    return "cpu"


def model_detect_family(file) -> int:
    """``file``: path or an already-open GGUFFile (the shim's load path
    opens the header once and detects on the same object)."""
    from . import api

    fam = api.model_detect_family(file)
    if fam.value not in FAMILIES:
        raise ValueError(
            f"model family '{fam.value}' is not exposed through the C API "
            f"(supported: {', '.join(FAMILIES)})"
        )
    return FAMILIES.index(fam.value)


def model_load(filepath: str, device, family_int: int):
    from . import api
    from .core.gguf import model_load as gguf_open

    if family_int != -1 and not 0 <= family_int < len(FAMILIES):
        raise ValueError(f"unknown model family code {family_int} (-1 = detect)")
    f = gguf_open(filepath)  # ONE header parse: detect + load share it
    detected = model_detect_family(f)
    if family_int != -1 and family_int != detected:
        raise ValueError(
            f"model file is '{FAMILIES[detected]}' but family "
            f"{FAMILIES[family_int]!r} was requested"
        )
    model = api.load_model(f, device)
    # the lock serializes stateful per-handle paths (sam encode -> compute)
    # so the shim's any-thread contract holds per model handle
    return (model, detected, threading.Lock())


def _image_from_raw(width: int, height: int, stride: int, fmt_int: int, data: bytes) -> Image:
    if not 0 <= fmt_int < len(FORMATS):
        raise ValueError(f"invalid image format code {fmt_int}")
    fmt = FORMATS[fmt_int]
    from .image.image import is_float, n_channels

    ch = n_channels(fmt)  # the image module's tables are authoritative
    itemsize = 4 if is_float(fmt) else 1
    dtype = np.float32 if itemsize == 4 else np.uint8
    raw = np.frombuffer(data, dtype=np.uint8)
    row_bytes = width * ch * itemsize
    if raw.size == height * stride:
        rows = raw.reshape(height, stride)[:, :row_bytes]
    elif raw.size == stride * (height - 1) + row_bytes:
        # the shim copies only the pixel bytes of the final row (an unpadded
        # last row in the caller's buffer must not be overread)
        head = raw[: stride * (height - 1)].reshape(max(height - 1, 0), stride)[:, :row_bytes]
        rows = np.concatenate([head, raw[stride * (height - 1) :][None, :row_bytes]], axis=0)
    else:
        raise ValueError(
            f"image payload of {raw.size} bytes does not match "
            f"{width}x{height} stride {stride} format {fmt.value}"
        )
    pixels = rows.reshape(height, width, ch * itemsize)
    arr = pixels.view(dtype).reshape(height, width, ch)
    return Image(np.ascontiguousarray(arr), fmt)


def model_compute(handle, images: list, args: list[int]):
    """images: list of (width, height, stride, fmt_int, data_bytes).
    Returns (np_u8_or_f32_buffer, width, height, stride, fmt_int)."""
    model, family_int, lock = handle
    family = FAMILIES[family_int]
    imgs = [_image_from_raw(*im) for im in images]

    if family == "sam":
        _expect(imgs, 1)
        # encode() stores the embedding on the model handle; concurrent
        # computes on one handle must not interleave encode and compute
        with lock:
            model.encode(imgs[0])
            if len(args) == 2:
                out = model.compute(point=(args[0], args[1]))
            elif len(args) == 4:
                out = model.compute(box=((args[0], args[1]), (args[2], args[3])))
            else:
                raise ValueError(
                    f"sam: bad number of arguments ({len(args)}), must be 2 or 4"
                )
    elif family == "birefnet":
        _expect(imgs, 1)
        from .models.birefnet import birefnet_compute

        out = birefnet_compute(model, imgs[0])
    elif family == "depth_anything":
        _expect(imgs, 1)
        from .models.depth_anything import depthany_compute

        out = depthany_compute(model, imgs[0])
        if out.format != ImageFormat.alpha_u8:
            out = image_f32_to_u8(image_normalize(out), ImageFormat.alpha_u8)
    elif family == "migan":
        _expect(imgs, 2)
        if imgs[1].format != ImageFormat.alpha_u8:
            raise ValueError("migan: second input image (mask) must be alpha_u8 format")
        from .models.migan import migan_compute

        out = migan_compute(model, imgs[0], imgs[1])
    elif family == "esrgan":
        _expect(imgs, 1)
        from .models.esrgan import esrgan_compute

        out = esrgan_compute(model, imgs[0])
    elif family == "yolov9t":
        _expect(imgs, 1)
        if len(args) not in (0, 2):
            raise ValueError(
                f"yolov9t: bad number of arguments ({len(args)}), must be 0 or 2 "
                "([conf, iou] thresholds in permille)"
            )
        conf = args[0] / 1000.0 if args else 0.25
        iou = args[1] / 1000.0 if args else 0.45
        from .models.yolov9t import draw_detections

        dets = model.compute(imgs[0], conf_thres=conf, iou_thres=iou)
        # draw_detections needs RGB u8 pixel order; f32/bgra/argb inputs
        # would draw with swapped channels
        canvas = imgs[0]
        if canvas.format != ImageFormat.rgb_u8:
            canvas = Image(np.ascontiguousarray(canvas.to_rgb_u8()), ImageFormat.rgb_u8)
        out = draw_detections(canvas, dets)
    else:
        raise ValueError(f"Unsupported model family {family_int}")

    data = np.ascontiguousarray(out.data)
    fmt_int = FORMATS.index(out.format)
    stride = data.shape[1] * data.shape[2] * data.itemsize
    return (data.reshape(-1).view(np.uint8), out.width, out.height, stride, fmt_int)


def _expect(imgs, n):
    if len(imgs) != n:
        raise ValueError(f"Expected {n} input images, but got {len(imgs)}.")
