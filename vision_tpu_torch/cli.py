"""Command-line interface — the port of vision_tpu/cli.py for the verbs the
port serves:

    python -m vision_tpu_torch.cli <sam|birefnet|depthany|migan|esrgan|yolov9t|info|compare> [options]

with the reference's options (-i/-o/-m/-p, --composite, --tile, --conf,
--iou), ``info``'s ``--tensors`` and ``compare``'s ``--max-rms``, the model
search paths (./models, $VISION_MODEL_DIR, XDG data dirs — reference
cli.cpp:248-282) and per-phase timing lines (cli.cpp:203-216,320-325).
``-b`` takes ``cpu`` or ``gpu``; without it the CLI takes the card and
fails without one. The JAX CLI's other verbs (serve, quantize, eval,
finetune, distill, bench, export), its bulk and video inputs and its
``--dump`` / ``--profile`` flags wait for their modules.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

from .core.device import backend_init
from .core.errors import VispError

USAGE_COMMANDS = {
    "sam": "MobileSAM image segmentation",
    "birefnet": "BirefNet background removal",
    "depthany": "Depth-Anything depth estimation",
    "migan": "MI-GAN inpainting",
    "esrgan": "ESRGAN/Real-ESRGAN upscaling",
    "yolov9t": "YOLOv9t object detection",
    "info": "inspect a .gguf: metadata, detected family, tensor/type breakdown",
    "compare": "compare two images: RMS (reference image_difference_rms semantics), PSNR, SSIM",
}

# reference per-command default model files (cli.cpp:395-567,
# inference_yolov9t.cpp:306), resolved through the same search paths
DEFAULT_MODELS = {
    "sam": "MobileSAM-F16.gguf",
    "birefnet": "BiRefNet-lite-F16.gguf",
    "depthany": "DepthAnythingV2-Small-F32.gguf",
    "migan": "MIGAN-512-places2-F16.gguf",
    "esrgan": "RealESRGAN-x4.gguf",
    "yolov9t": "yolov9t_converted-F16.gguf",
}

# exact input arity per model verb (reference require_inputs, cli.cpp:104-108)
REQUIRED_INPUTS = {
    "sam": (1, "<image>"), "birefnet": (1, "<image>"), "depthany": (1, "<image>"),
    "esrgan": (1, "<image>"), "yolov9t": (1, "<image>"), "migan": (2, "<image> <mask>"),
}


class _Timer:
    def __init__(self, label):
        self.label = label

    def __enter__(self):
        print(f"{self.label}... ", end="", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"done ({time.perf_counter() - self.t0:.2f}s)")
        else:
            print("failed")  # terminate the phase line so the error starts fresh


def find_model(name_or_path: str) -> str:
    """Model search paths (reference find_model, cli.cpp:248-282)."""
    p = Path(name_or_path)
    if p.exists():
        return str(p)
    candidates = [Path("models")]
    if env := os.environ.get("VISION_MODEL_DIR"):
        candidates.append(Path(env))
    xdg = os.environ.get("XDG_DATA_HOME") or (Path.home() / ".local" / "share")
    candidates.append(Path(xdg) / "vision_tpu" / "models")
    for c in candidates:
        if (c / name_or_path).exists():
            return str(c / name_or_path)
    raise VispError(f"Model file not found: {name_or_path}")


def _composite(image, mask, output_path):
    """--composite via foreground estimation (reference cli.cpp:327-347)."""
    from .image import ImageFormat, image_estimate_foreground, image_f32_to_u8, image_save, image_u8_to_f32

    img_f = image_u8_to_f32(image, ImageFormat.rgba_f32)
    mask_f = image_u8_to_f32(mask, ImageFormat.alpha_f32)
    fg = image_estimate_foreground(img_f, mask_f)
    image_save(image_f32_to_u8(fg, ImageFormat.rgba_u8), output_path)
    print(f"-> image composited and saved to {output_path}")


def _device(args):
    dev = backend_init(args.backend)
    print(f"Using device: {dev.torch_device} ({dev.type.name}, {str(dev.preferred_float_type).removeprefix('torch.')})")
    return dev


def _compare(args, parser) -> int:
    """RMS (reference image_difference_rms), PSNR and SSIM of two images,
    on the host."""
    from .image import image_difference_rms, image_load
    from .utils.metrics import psnr, ssim

    if len(args.input) != 2:
        parser.error("compare needs exactly two images: -i A B")
    try:
        a, b = (image_load(p) for p in args.input)
        rms = image_difference_rms(a, b)
    except VispError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    fa, fb = a.load_f32x4()[:, :, :3], b.load_f32x4()[:, :, :3]
    # SSIM's 11x11 window needs the image to be at least that big
    win = min(11, fa.shape[0], fa.shape[1])
    print(f"rms  {rms:.6f}")
    print(f"psnr {psnr(fa, fb):.2f} dB")
    print(f"ssim {ssim(fa, fb, window=win):.5f}")
    if args.max_rms is not None and rms > args.max_rms:
        print(f"FAIL: rms {rms:.6f} > --max-rms {args.max_rms}", file=sys.stderr)
        return 2
    return 0


def _info(args, parser) -> int:
    """Metadata-only inspection of a GGUF: no device, no tensor reads."""
    from .api import model_detect_family
    from .core.gguf import model_load

    if not args.model:
        parser.error("info requires -m <model.gguf>")
    try:
        path = find_model(args.model)
        file = model_load(path)
    except VispError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        family = model_detect_family(file).value
    except VispError:
        family = "unknown"
    ftype = file.float_type
    print(f"{path} ({Path(path).stat().st_size / 1e6:.1f} MB, GGUF v{file.version})")
    print(f"  architecture: {file.arch or '(none)'}  family: {family}")
    print(f"  file type: {getattr(ftype, 'name', ftype)}  alignment: {file.alignment}")
    print(f"  {len(file.metadata)} metadata keys:")
    for key, val in file.metadata.items():
        text = f"[{len(val)} x {type(val[0]).__name__}]" if isinstance(val, list) and len(val) > 8 else repr(val)
        print(f"    {key} = {text}")
    by_type: dict = {}
    total_elems = total_bytes = 0
    for info in file.tensors.values():
        tname = getattr(info.ggml_type, "name", str(info.ggml_type))
        try:
            nbytes = info.n_bytes
        except VispError:
            nbytes = 0  # unknown type: still listed, size unavailable
        cnt, els, byt = by_type.get(tname, (0, 0, 0))
        by_type[tname] = (cnt + 1, els + info.n_elements, byt + nbytes)
        total_elems += info.n_elements
        total_bytes += nbytes
    print(f"  {len(file.tensors)} tensors, {total_elems / 1e6:.1f} M parameters, "
          f"{total_bytes / 1e6:.1f} MB tensor data:")
    for tname, (cnt, els, byt) in sorted(by_type.items(), key=lambda kv: -kv[1][2]):
        print(f"    {tname:<7} {cnt:>4} tensors  {els / 1e6:>8.1f} M  {byt / 1e6:>8.1f} MB")
    if args.tensors:
        width = max(len(n) for n in file.tensors) if file.tensors else 0
        for info in file.tensors.values():
            tname = getattr(info.ggml_type, "name", str(info.ggml_type))
            shape = "x".join(str(d) for d in info.shape)
            print(f"    {info.name:<{width}}  {tname:<7} {shape}")
    return 0


def _run_model(args) -> None:
    """One model verb: load, infer, save (reference cli.cpp run_* and
    inference_yolov9t.cpp)."""
    from .image import ImageFormat, image_f32_to_u8, image_load, image_save

    if not args.model and args.command not in DEFAULT_MODELS:
        raise VispError("No model specified (-m)")
    model_path = find_model(args.model or DEFAULT_MODELS[args.command])
    n_req, names = REQUIRED_INPUTS[args.command]
    if len(args.input) != n_req:
        raise VispError(f"Expected -i to be followed by {n_req} input(s): {names} - but found {len(args.input)}")
    for inp in args.input:
        if not Path(inp).is_file():
            raise VispError(f"Input file not found: {inp}")
    if args.command == "sam" and args.prompt and len(args.prompt) not in (2, 4):
        raise VispError(f"Expected 2 (point) or 4 (box) numbers for -p, got {len(args.prompt)}")
    dev = _device(args)

    if args.command == "sam":
        from .models.mobile_sam import sam_load_model

        with _Timer("Loading model weights"):
            model = sam_load_model(model_path, dev)
        image = image_load(args.input[0])
        with _Timer("Encoding image"):
            model.encode(image)
        prompt = args.prompt or [image.width // 2, image.height // 2]
        with _Timer("Predicting mask"):
            if len(prompt) >= 4:
                mask = model.compute(box=((prompt[0], prompt[1]), (prompt[2], prompt[3])))
            else:
                mask = model.compute(point=(prompt[0], prompt[1]))
        image_save(mask, args.output)
        print(f"-> mask saved to {args.output}")
        if args.composite:
            _composite(image, mask, args.composite)

    elif args.command == "birefnet":
        from .models.birefnet import birefnet_load_model

        with _Timer("Loading model weights"):
            model = birefnet_load_model(model_path, dev)
        image = image_load(args.input[0])
        with _Timer("Running inference"):
            mask = model.compute(image)
        image_save(mask, args.output)
        print(f"-> mask saved to {args.output}")
        if args.composite:
            _composite(image, mask, args.composite)

    elif args.command == "depthany":
        from .models.depth_anything import depthany_load_model

        with _Timer("Loading model weights"):
            model = depthany_load_model(model_path, dev)
        image = image_load(args.input[0])
        with _Timer("Running inference"):
            depth = model.compute(image)
        image_save(image_f32_to_u8(depth, ImageFormat.alpha_u8), args.output)
        print(f"-> depth map saved to {args.output}")

    elif args.command == "migan":
        from .models.migan import migan_load_model

        with _Timer("Loading model weights"):
            model = migan_load_model(model_path, dev)
        image = image_load(args.input[0])
        mask = image_load(args.input[1])
        with _Timer("Running inference"):
            out = model.compute(image, mask)
        image_save(out, args.output)
        print(f"-> inpainted image saved to {args.output}")

    elif args.command == "esrgan":
        from .models.esrgan import esrgan_load_model

        with _Timer("Loading model weights"):
            model = esrgan_load_model(model_path, dev)
        image = image_load(args.input[0])
        # no --tile: compute's default tile size
        tile = args.tile if args.tile > 0 else None
        with _Timer("Running inference"):
            out = model.compute(image, tile_size=tile)
        image_save(out, args.output)
        print(f"-> upscaled image saved to {args.output}")

    else:  # yolov9t
        from .models.yolov9t import COCO_CLASS_NAMES, draw_detections, yolov9t_load_model

        with _Timer("Loading model weights"):
            model = yolov9t_load_model(model_path, dev)
        image = image_load(args.input[0])
        with _Timer("Running inference"):
            dets = model.compute(image, args.conf, args.iou)
        print(f"Found {len(dets)} objects:")
        for d in dets:
            name = COCO_CLASS_NAMES[d.class_id] if d.class_id < len(COCO_CLASS_NAMES) else str(d.class_id)
            print(f"  {name:>14s} {d.confidence:.2f} [{d.x1:.0f}, {d.y1:.0f}, {d.x2:.0f}, {d.y2:.0f}]")
        image_save(draw_detections(image, dets), args.output)
        print(f"-> annotated image saved to {args.output}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vision-cli-torch", description="Vision model inference on an NVIDIA GPU")
    parser.add_argument("command", choices=list(USAGE_COMMANDS), help="model to run")
    parser.add_argument("-i", "--input", nargs="+", default=None, help="input image(s)")
    parser.add_argument("-o", "--output", default=None, help="output file")
    parser.add_argument("-m", "--model", default=None, help="model file (.gguf)")
    parser.add_argument("-p", "--prompt", nargs="+", type=int, default=None, help="prompt coords")
    parser.add_argument("-b", "--backend", default=None, choices=["cpu", "gpu"],
                        help="device (default: the GPU; there is no fallback to the CPU)")
    parser.add_argument("--composite", default=None, help="composite input image with mask")
    parser.add_argument("--tile", type=int, default=-1, help="tile size for large images")
    parser.add_argument("--conf", type=float, default=0.25, help="yolo confidence threshold")
    parser.add_argument("--iou", type=float, default=0.45, help="yolo IoU threshold")
    parser.add_argument("--tensors", action="store_true", help="info: also print the full per-tensor table")
    parser.add_argument("--max-rms", type=float, default=None, metavar="T",
                        help="compare: exit 2 if RMS exceeds T (scripted regression gating)")
    args = parser.parse_args(argv)
    if args.input is None and args.command != "info":
        parser.error("-i/--input is required")
    if args.command == "compare":
        return _compare(args, parser)
    if args.command == "info":
        return _info(args, parser)
    if args.output is None:
        args.output = "output.png"
    try:
        _run_model(args)
    except VispError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
