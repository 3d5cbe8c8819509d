"""Command-line interface — the port of vision_tpu/cli.py for the verbs the
port serves:

    python -m vision_tpu_torch.cli <sam|birefnet|depthany|migan|esrgan|yolov9t|serve|quantize|info|compare|eval|
                                    finetune|distill|export> [options]

with the reference's options (-i/-o/-m/-p, --composite, --tile, --conf,
--iou), the model search paths (./models, $VISION_MODEL_DIR, XDG data dirs —
reference cli.cpp:248-282) and per-phase timing lines (cli.cpp:203-216,
320-325). A model verb given a directory as -i runs every image in it
through the family's batching server (bulk.py; MI-GAN takes an image and a
mask directory), and one given a video runs its frames (video.py, which
needs OpenCV; MI-GAN takes a video and one mask image). ``serve`` puts the
-m model and every --extra-model behind the HTTP front end (serve_http.py),
``eval`` scores a prediction directory against ground truth (evaluate.py),
after running -m over the -i images when given a model; ``quantize``
rewrites a GGUF at another float type (core/gguf.py requantize_gguf, no
device), ``info`` inspects a GGUF and ``compare`` two images. ``finetune``
runs a family's recipe on -m (finetune.py: Real-ESRGAN self-supervised,
BiRefNet on ``--masks``) and ``distill`` trains a Depth-Anything
``--student`` against the -m teacher (``--lora``, ``--lora-out``,
``--qlora``); ``--adapter`` merges a LoRA adapter file into -m first
(api.merge_adapter) on every verb that loads -m. ``export`` writes -m's
tensor forwards as a deployment bundle (export.py: ``--extent``, ``--batch``,
``--no-embed``; load it with ``export.load_bundle``). ``--profile DIR``
records a ``torch.profiler`` trace of a model verb's inference phase (and of
bulk, video and ``eval -m`` runs) into DIR (utils/profiling.py); ``--dump
DIR`` (yolov9t) writes each layer's output of one eager forward as .npy
files (ops/debug.py, utils/dump.py). ``-b`` takes ``cpu`` or ``gpu``;
without it the CLI takes the card and fails without one. ``--dp N`` serves
``serve`` and a model verb's directory or video input over N ranks, one
card each (parallel/): under torchrun the ranks are its world; otherwise
the CLI starts ranks 1..N-1 itself (``torch.multiprocessing``, spawn). Rank
0 serves, the others follow. ``finetune --dp`` waits for the training
meshes, and the JAX CLI's ``bench`` verb for the benchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path

from .api import ModelFamily, family_loader
from .core.device import backend_init
from .core.errors import VispError

USAGE_COMMANDS = {
    "sam": "MobileSAM image segmentation",
    "birefnet": "BirefNet background removal",
    "depthany": "Depth-Anything depth estimation",
    "migan": "MI-GAN inpainting",
    "esrgan": "ESRGAN/Real-ESRGAN upscaling",
    "yolov9t": "YOLOv9t object detection",
    "serve": "HTTP serving (batched endpoints for every served family: -m and each --extra-model)",
    "quantize": "rewrite a .gguf at a different float type (q8_0, q4_0/1, q5_0/1, K-quants, iq4_nl/xs, f16, f32)",
    "info": "inspect a .gguf: metadata, detected family, tensor/type breakdown",
    "compare": "compare two images: RMS (reference image_difference_rms semantics), PSNR, SSIM",
    "eval": "score a prediction directory against ground truth (mask IoU/F1, depth AbsRel/delta1, PSNR/SSIM, "
            "detection mAP); with -m, run the model on -i first",
    "finetune": "fine-tune a .gguf on your images: esrgan (self-supervised SR) or birefnet (supervised masks, "
                "--masks DIR)",
    "distill": "distill a depth-anything teacher .gguf (-m) into a smaller --student on unlabeled images",
    "export": "export -m's programs as a deployment bundle (torch.export; load with export.load_bundle)",
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
    "finetune": "RealESRGAN-x4.gguf",
}

# family -> serve_forever's keyword for its model
SERVE_MODELS = {"sam": "sam_model", "esrgan": "esrgan_model", "birefnet": "birefnet_model",
                "depth_anything": "depthany_model", "migan": "migan_model", "yolov9t": "yolo_model"}
# model verb -> its family
VERB_FAMILIES = {"sam": ModelFamily.sam, "birefnet": ModelFamily.birefnet, "depthany": ModelFamily.depth_anything,
                 "migan": ModelFamily.migan, "esrgan": ModelFamily.esrgan, "yolov9t": ModelFamily.yolov9t}

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


def _model_path(args) -> str:
    """-m (or the verb's default model) resolved through the search paths,
    with ``--adapter`` merged into it (a temporary merged GGUF) when given."""
    if not args.model and args.command not in DEFAULT_MODELS:
        raise VispError("No model specified (-m)")
    path = find_model(args.model or DEFAULT_MODELS[args.command])
    if args.adapter:
        if not Path(args.adapter).is_file():
            raise VispError(f"Adapter file not found: {args.adapter}")
        from .api import merge_adapter

        path = merge_adapter(path, args.adapter)
    return path


def _profile(args):
    """torch.profiler trace context for the inference phase (--profile DIR);
    a no-op context when the flag is absent."""
    import contextlib

    if not args.profile:
        return contextlib.nullcontext()
    from .utils.profiling import trace

    return trace(args.profile)


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


def _quantize(args, parser) -> int:
    """A pure file rewrite (core/gguf.py requantize_gguf): no device, no
    model load; with --verify the per-tensor reconstruction error."""
    from .core.gguf import requantize_gguf

    if not args.model:
        parser.error("quantize requires -m <in.gguf>")
    try:
        src = find_model(args.model)
        dst = args.output
        if dst is None:  # no -o: derive a gguf name next to the source
            dst = str(Path(src).with_suffix("")) + f"-{args.type.upper()}.gguf"
        stats = [] if args.verify else None
        with _Timer(f"Quantizing to {args.type}"):
            out = requantize_gguf(src, dst, args.type, stats_out=stats)
    except VispError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if stats:
        width = max(len(n) for n, _, _ in stats)
        for n, tname, rms in stats:
            err = "  (int, copied)" if rms is None else f"  rel-rms {rms:.4f}"
            print(f"  {n:<{width}}  {tname:<7}{err}")
        lossy = [r for _, _, r in stats if r]
        if lossy:
            print(f"  worst rel-rms {max(lossy):.4f} over {len(lossy)} quantized tensors")
    print(f"-> {out} ({Path(out).stat().st_size / 1e6:.1f} MB, "
          f"from {Path(src).stat().st_size / 1e6:.1f} MB)")
    return 0


def _dp_worker(rank: int, n: int, address: str, argv: list) -> None:
    """A rank the CLI started: run the same command as rank ``rank`` of the
    world at ``address`` (it follows rank 0 once its models are loaded).
    Ctrl-C reaches rank 0 alone: rank 0 stops this rank when it exits."""
    import signal

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    os.environ["VISP_DP_WORLD"] = f"{address}|{n}|{rank}"
    code = main(argv)
    if code:
        sys.exit(code)


class _DpWorld:
    """``--dp N``: the process group and the mesh of a serving command, and
    the ranks the CLI started (stopped and joined on exit)."""

    def __init__(self, args):
        self.mesh, self.procs, self.store, self.joined = None, [], None, False
        n = args.dp
        if not n:
            return
        if n < 1:
            raise VispError(f"--dp must be >= 1, got {n}")
        if args.batch is not None and args.batch % n:
            raise VispError(f"--batch {args.batch} must be divisible by --dp {n}")
        from .parallel.sharding import cards_available, init_distributed, make_mesh

        device = "cpu" if args.backend == "cpu" else "cuda"
        t0 = time.perf_counter()
        if n > cards_available(device):  # before any rank starts: two ranks never share a card
            make_mesh(n, device=device)
        import torch.distributed as dist

        started = os.environ.get("VISP_DP_WORLD")
        self.joined = not dist.is_initialized()  # a world this command makes it also ends
        if not self.joined:
            pass  # the process's own world (a caller that made one)
        elif started:
            address, size, rank = started.split("|")
            init_distributed(address, int(size), int(rank), device=device)
        elif "WORLD_SIZE" in os.environ:
            init_distributed(device=device)
        else:  # --dp 1 too: one rank's world is made as N ranks' is
            import tempfile

            import torch.multiprocessing as mp

            self.store = tempfile.mkdtemp(prefix="visp-dp-")
            address = "file://" + os.path.join(self.store, "store")
            ctx = mp.get_context("spawn")
            for rank in range(1, n):
                p = ctx.Process(target=_dp_worker, args=(rank, n, address, args._argv), daemon=True)
                p.start()
                self.procs.append(p)
            init_distributed(address, n, 0, device=device)
        self.mesh = make_mesh(n, device=device)
        if self.mesh.get_coordinate() is not None:
            from .parallel.runner import world_rank

            print(f"dp mesh: {n} rank(s) on {device}, this rank {world_rank()} ({time.perf_counter() - t0:.2f} s)")

    def follow(self) -> bool:
        """On a following rank, serve rank 0's calls until it stops; True there."""
        from .parallel.runner import follow, is_worker

        if self.mesh is None or not is_worker():
            return False
        follow()
        return True

    def close(self) -> None:
        if self.mesh is None:
            return
        from .parallel.runner import stop_workers

        try:
            stop_workers()
        except Exception as e:  # noqa: BLE001 — a rank already failed; end the ones left
            print(f"dp: stopping the ranks failed ({e}); terminating them", file=sys.stderr)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
        if self.joined:
            import torch.distributed as dist

            # before its store goes: the group's own threads read the store until it ends
            dist.destroy_process_group()
        if self.store is not None:
            shutil.rmtree(self.store, ignore_errors=True)


def _run_model(args) -> None:
    """One model verb: load, infer, save (reference cli.cpp run_* and
    inference_yolov9t.cpp)."""
    from .image import ImageFormat, image_f32_to_u8, image_load, image_save

    model_path = _model_path(args)
    n_req, names = REQUIRED_INPUTS[args.command]
    if len(args.input) != n_req:
        raise VispError(f"Expected -i to be followed by {n_req} input(s): {names} - but found {len(args.input)}")
    for inp in args.input:
        if not Path(inp).exists():
            raise VispError(f"Input file not found: {inp}")
    if args.command == "sam" and args.prompt and len(args.prompt) not in (2, 4):
        raise VispError(f"Expected 2 (point) or 4 (box) numbers for -p, got {len(args.prompt)}")
    from .video import is_video

    if os.path.isdir(args.input[0]) or is_video(args.input[0]):
        world = _DpWorld(args)
        try:
            _run_many(args, model_path, _device(args), world)
        finally:
            world.close()
        return
    if args.dp:
        raise VispError("--dp applies to serve and to directory and video inputs")
    dev = _device(args)

    with _Timer("Loading model weights"):
        model = family_loader(VERB_FAMILIES[args.command])(model_path, dev)
    image = image_load(args.input[0])
    if args.command == "sam":
        prompt = args.prompt or [image.width // 2, image.height // 2]
        with _profile(args):
            with _Timer("Encoding image"):
                model.encode(image)
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
        with _profile(args), _Timer("Running inference"):
            mask = model.compute(image)
        image_save(mask, args.output)
        print(f"-> mask saved to {args.output}")
        if args.composite:
            _composite(image, mask, args.composite)

    elif args.command == "depthany":
        with _profile(args), _Timer("Running inference"):
            depth = model.compute(image)
        image_save(image_f32_to_u8(depth, ImageFormat.alpha_u8), args.output)
        print(f"-> depth map saved to {args.output}")

    elif args.command == "migan":
        mask = image_load(args.input[1])
        with _profile(args), _Timer("Running inference"):
            out = model.compute(image, mask)
        image_save(out, args.output)
        print(f"-> inpainted image saved to {args.output}")

    elif args.command == "esrgan":
        # no --tile: compute's default tile size
        tile = args.tile if args.tile > 0 else None
        with _profile(args), _Timer("Running inference"):
            out = model.compute(image, tile_size=tile)
        image_save(out, args.output)
        print(f"-> upscaled image saved to {args.output}")

    else:  # yolov9t
        from .models.yolov9t import COCO_CLASS_NAMES, draw_detections

        if args.dump:
            _dump_yolov9t(model, image, args.dump)
        with _profile(args), _Timer("Running inference"):
            dets = model.compute(image, args.conf, args.iou)
        print(f"Found {len(dets)} objects:")
        for d in dets:
            name = COCO_CLASS_NAMES[d.class_id] if d.class_id < len(COCO_CLASS_NAMES) else str(d.class_id)
            print(f"  {name:>14s} {d.confidence:.2f} [{d.x1:.0f}, {d.y1:.0f}, {d.x2:.0f}, {d.y2:.0f}]")
        image_save(draw_detections(image, dets), args.output)
        print(f"-> annotated image saved to {args.output}")


def _dump_yolov9t(model, image, out_dir: str) -> None:
    """--dump: one eager forward of the letterboxed image under a capture
    context (not the CUDA graph, where captures are refused), each layer's
    output written as .npy (the reference's --dump-keys)."""
    import torch

    from .models.yolov9t import letterbox
    from .ops.debug import capture_context
    from .utils import dump_captures

    arr, _, _, _ = letterbox(image, model.p.input_size)
    with capture_context() as caps:
        model._forward_u8(torch.from_numpy(arr[None]))
    written = dump_captures(caps, out_dir)
    print(f"-> dumped {len(written)} feature maps to {out_dir}")


def _export(args) -> None:
    """``export``: -m's tensor forwards as a bundle (export.py) at -o
    (default: the model's path with the suffix .vxp)."""
    from .api import load_model
    from .export import export_model

    model_path = _model_path(args)
    dev = _device(args)
    with _Timer("Loading model weights"):
        model = load_model(model_path, dev)
    dst = args.output or str(Path(model_path).with_suffix(".vxp"))
    with _Timer("Exporting programs"):
        names = export_model(model, dst, extent=tuple(args.extent) if args.extent else None,
                             batch=args.batch if args.batch is not None else 1, embed_params=not args.no_embed)
    print(f"-> {dst} ({Path(dst).stat().st_size / 1e6:.1f} MB; entries: {', '.join(names)})")


def _run_many(args, model_path: str, dev, world: _DpWorld) -> None:
    """A model verb over a directory of images (bulk.py: one batched forward
    per same-extent group, an output per input stem) or over a video's
    frames (video.py: the results re-encoded at the source frame rate).
    With ``--dp`` each group splits over the ranks of ``world``."""
    from functools import partial

    from .video import is_video

    load = family_loader(VERB_FAMILIES[args.command])
    if world.mesh is not None:
        load = partial(load, mesh=world.mesh)
    if not os.path.isdir(args.input[0]) and is_video(args.input[0]):
        from .video import video_run

        mask = None
        if args.command == "migan":
            if len(args.input) != 2 or is_video(args.input[1]):
                raise VispError("migan video mode takes -i <video> <mask-image> "
                                "(one static mask applied to every frame)")
            mask = args.input[1]
        with _Timer("Loading model weights"):
            model = load(model_path, dev)
        if world.follow():
            return
        print(f"Processing {args.input[0]} -> {args.output}")
        with _profile(args):
            dets = video_run(model, args.input[0], args.output, prompt=args.prompt, mask=mask,
                             conf_thres=args.conf, iou_thres=args.iou, batch_size=args.batch)
        if dets is not None:
            dst = Path(args.output).with_suffix(".detections.json")
            dst.write_text(json.dumps(dets, indent=1))
            print(f"-> {dst} ({sum(len(d) for d in dets)} detections)")
        print(f"-> {args.output}")
        return
    from .bulk import bulk_inputs, bulk_run, pair_masks

    inputs = bulk_inputs(args.input[0])
    if args.command == "migan":
        if not os.path.isdir(args.input[1]):
            raise VispError("migan bulk mode takes two directories: -i <images> <masks> "
                            "(masks matched to images by filename stem)")
        inputs = pair_masks(inputs, args.input[1])
    with _Timer("Loading model weights"):
        model = load(model_path, dev)
    if world.follow():
        return
    print(f"Processing {len(inputs)} images -> {args.output}/")
    with _profile(args):
        outs = bulk_run(model, inputs, args.output, prompt=args.prompt, conf_thres=args.conf, iou_thres=args.iou,
                        batch_size=args.batch)
    print(f"-> {len(outs)} files written to {args.output}/")


def _serve(args) -> None:
    """The HTTP front end over the -m model and each --extra-model (their
    families detected from the files), until interrupted; with ``--dp`` over
    the ranks of a mesh (rank 0 serves HTTP, the others follow)."""
    from .api import model_detect_family
    from .core.gguf import model_load
    from .serve_http import serve_forever

    # resolve EVERY served model path before device init: a typo'd
    # --extra-model must fail in milliseconds, as -m does
    paths = [_model_path(args)]
    if args.esrgan_model:  # alias of --extra-model for an ESRGAN file
        paths.append(find_model(args.esrgan_model))
    paths += [find_model(m) for m in args.extra_model]
    for inp in args.input or []:
        if not Path(inp).exists():
            raise VispError(f"Input file not found: {inp}")
    world = _DpWorld(args)
    try:
        dev = _device(args)
        models = {}
        with _Timer("Loading model weights"):
            for path in paths:
                file = model_load(path)
                family = model_detect_family(file)
                if family.value not in SERVE_MODELS:
                    raise VispError(f"serve does not support {family.value} models")
                key = SERVE_MODELS[family.value]
                if key in models:
                    raise VispError(f"two models of one family given ({key})")
                models[key] = family_loader(family)(file, dev, mesh=world.mesh)
        if not world.follow():
            serve_forever(batch_size=args.batch, host=args.host, port=args.port, warmup=args.warmup, **models)
    finally:
        world.close()


def _eval(args, parser) -> int:
    """Dataset scoring (evaluate.py). Two modes:
      scoring-only:  eval --task mask -i <pred dir> --gt <gt dir>  (no device)
      with a model:  eval -m model.gguf -i <images dir> --gt <gt dir>
    The second runs bulk inference first (the -i directory through the
    family's batching server, on the card unless -b cpu) and scores the
    fresh predictions."""
    import tempfile

    from .evaluate import evaluate, format_report, task_for_family

    if not args.gt:
        parser.error("eval requires --gt <ground-truth dir (or JSON)>")
    try:
        if args.model:
            from .api import load_model, model_detect_family
            from .bulk import bulk_inputs, bulk_run, pair_masks
            from .core.gguf import model_load

            model_path = _model_path(args)
            family = model_detect_family(model_load(model_path)).value
            task = args.task or task_for_family(family)
            if not os.path.isdir(args.input[0]):
                raise VispError(f"eval with -m takes an image DIRECTORY as -i (got '{args.input[0]}')")
            inputs = bulk_inputs(args.input[0])
            if family == "migan":
                if len(args.input) != 2 or not os.path.isdir(args.input[1]):
                    raise VispError("eval migan takes two directories: -i <images> <masks>")
                inputs = pair_masks(inputs, args.input[1])
            elif len(args.input) != 1:
                raise VispError("eval takes one input directory: -i <images>")
            dev = _device(args)
            with tempfile.TemporaryDirectory(prefix="vision-eval-") as tmp:
                pred_dir = args.pred_out or tmp
                with _Timer("Loading model weights"):
                    model = load_model(model_path, dev)
                print(f"Predicting {len(inputs)} images" + (f" -> {pred_dir}/" if args.pred_out else ""))
                with _profile(args):
                    bulk_run(model, inputs, pred_dir, prompt=args.prompt, conf_thres=args.conf,
                             iou_thres=args.iou, batch_size=args.batch)
                result = evaluate(task, pred_dir, args.gt, align_depth=not args.no_align)
        else:
            if not args.task:
                parser.error("eval without -m requires --task")
            result = evaluate(args.task, args.input[0], args.gt, align_depth=not args.no_align)
    except VispError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(format_report(result))
    if args.output:
        Path(args.output).write_text(json.dumps(result, indent=1))
        print(f"-> {args.output}")
    return 0


# finetune's flags that only the BiRefNet recipe and distill take
_NOT_ESRGAN = (("lora", "--lora"), ("lora_out", "--lora-out"), ("qlora", "--qlora"), ("masks", "--masks"))


def _train(args) -> None:
    """``finetune`` (the -m model's family recipe) or ``distill`` (the
    --student against the -m teacher): every path and the image list are
    checked before the device starts; the result is exported to -o."""
    from .api import model_detect_family
    from .core.gguf import model_load
    from .finetune import list_images

    if args.dp:
        raise VispError(f"{args.command} --dp: the training meshes (create_train_state / make_train_step over a "
                        "mesh) wait for their queue item; train on one card without --dp")
    model_path = _model_path(args)
    images = list_images(args.input)
    if args.steps < 1 or (args.batch is not None and args.batch < 1):
        raise VispError(f"{args.command}: --steps and --batch must be >= 1")
    batch = args.batch if args.batch is not None else 4
    common = dict(steps=args.steps, lr=args.lr, batch=batch, trainable=args.train_filter, ckpt_dir=args.ckpt,
                  ckpt_every=args.ckpt_every, log=print)
    if args.command == "finetune":
        from .finetune import finetune

        family = model_detect_family(model_load(model_path)).value
        if family == "birefnet":
            if args.masks is not None:
                # a missing or mismatched mask directory fails before the device starts
                from .bulk import pair_masks

                pair_masks(images, args.masks)
            kw = dict(masks=args.masks, size=args.size or 256, augment=not args.no_augment, lora_rank=args.lora,
                      lora_out=args.lora_out, qlora=args.qlora)
        else:
            given = [flag for name, flag in _NOT_ESRGAN if getattr(args, name) not in (None, False)]
            if given and family == "esrgan":
                raise VispError(f"finetune (esrgan): {', '.join(given)} apply to the birefnet recipe and distill "
                                f"only")
            kw = dict(patch=args.patch, ema_decay=args.ema)
        dev = _device(args)
        with _Timer("Fine-tuning"):
            stats = finetune(model_path, images, args.output, device=dev, **common, **kw)
    else:
        from .finetune import distill_depthany

        if not args.student:
            raise VispError("distill: --student <gguf> is required (-m is the teacher)")
        student = find_model(args.student)
        dev = _device(args)
        with _Timer("Distilling"):
            stats = distill_depthany(model_path, student, images, args.output, size=args.size or 252,
                                     lora_rank=args.lora, lora_out=args.lora_out, qlora=args.qlora, device=dev,
                                     **common)
    if stats["first_loss"] is not None:
        print(f"loss {stats['first_loss']:.5f} -> {stats['last_loss']:.5f} over {stats['steps']} steps "
              f"({len(images)} images)")
    else:  # resumed at or past --steps: nothing left to train
        print(f"already trained to step {stats['steps']} (resumed); exported as-is")
    if stats.get("lora_out"):
        print(f"-> {stats['lora_out']} (adapters)")
    print(f"-> {stats['out']}")


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
    parser.add_argument("--dump", default=None, metavar="DIR",
                        help="dump per-layer feature maps as .npy (yolov9t; reference --dump-keys)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="record a torch.profiler trace (Chrome JSON) of the inference phase into DIR")
    parser.add_argument("--extent", nargs=2, type=int, default=None, metavar=("W", "H"),
                        help="export: input geometry for the extent-dynamic families (birefnet/depthany snap it to "
                        "their grids, esrgan takes it verbatim); fixed-input families ignore it")
    parser.add_argument("--no-embed", action="store_true",
                        help="export: program-only bundle; call() then takes the param dict first instead of the "
                        "weights riding along")
    from .core.gguf import REQUANTIZE_TYPES

    parser.add_argument("--type", "-t", default="q8_0", choices=list(REQUANTIZE_TYPES),
                        help="quantize: target float storage type")
    parser.add_argument("--verify", action="store_true",
                        help="quantize: report per-tensor reconstruction error (rel-RMS) after writing, like "
                        "llama-quantize's per-tensor stats")
    parser.add_argument("--tensors", action="store_true", help="info: also print the full per-tensor table")
    parser.add_argument("--max-rms", type=float, default=None, metavar="T",
                        help="compare: exit 2 if RMS exceeds T (scripted regression gating)")
    parser.add_argument("--port", type=int, default=8000, help="serve: listen port (0: any free port)")
    parser.add_argument("--host", default="127.0.0.1", help="serve: bind address")
    parser.add_argument("--esrgan-model", default=None,
                        help="serve: additionally load this ESRGAN gguf next to the -m model")
    parser.add_argument("--batch", type=int, default=None,
                        help="serve/bulk/video/eval: max batch size (default: each service's own - sam 6, "
                        "esrgan/birefnet/depthany/migan 4, yolo 8); finetune/distill: training batch size (default 4); "
                        "export: the image entries' batch (default 1)")
    parser.add_argument("--warmup", action="store_true",
                        help="serve: run one batch of every service before listening")
    parser.add_argument("--extra-model", action="append", default=[], metavar="GGUF",
                        help="serve: load an additional model (family auto-detected; repeatable)")
    from .evaluate import TASKS as EVAL_TASKS

    parser.add_argument("--task", default=None, choices=list(EVAL_TASKS),
                        help="eval: what the predictions are (default: inferred from the -m model's family; "
                        "required when scoring without a model)")
    parser.add_argument("--gt", default=None, metavar="PATH",
                        help="eval: ground-truth directory (detection: .txt dir or JSON), files matched to "
                        "predictions by stem")
    parser.add_argument("--no-align", action="store_true",
                        help="eval: score depth WITHOUT scale/shift-aligning the relative prediction to the "
                        "ground truth first")
    parser.add_argument("--pred-out", default=None, metavar="DIR",
                        help="eval with -m: keep the generated predictions here (default: a temporary directory)")
    parser.add_argument("--adapter", default=None, metavar="GGUF",
                        help="merge this LoRA adapter file (save_lora / --lora-out) into -m at load: one base model "
                        "and small per-task adapters")
    parser.add_argument("--steps", type=int, default=200, help="finetune/distill: optimizer steps")
    parser.add_argument("--lr", type=float, default=1e-4, help="finetune/distill: Adam learning rate")
    parser.add_argument("--patch", type=int, default=64,
                        help="finetune (esrgan): HR patch size (must divide by the model scale)")
    parser.add_argument("--ema", type=float, default=None, metavar="DECAY",
                        help="finetune (esrgan): track and export EMA weights at this decay (e.g. 0.999)")
    parser.add_argument("--ckpt", default=None, metavar="DIR",
                        help="finetune/distill: checkpoint the training state here and resume a rerun from the "
                        "newest step_* save")
    parser.add_argument("--ckpt-every", type=int, default=50, metavar="N",
                        help="finetune/distill: checkpoint every N optimizer steps (the final step always saves)")
    parser.add_argument("--train-filter", default=None, metavar="REGEX",
                        help="finetune/distill: train only params whose dotted name matches (default: every float "
                        "param)")
    parser.add_argument("--student", default=None, metavar="GGUF",
                        help="distill: the student model to train (-m is the frozen teacher)")
    parser.add_argument("--size", type=int, default=None,
                        help="distill/finetune (birefnet): square training resolution (snapped to the model's grid; "
                        "default 252 / 256)")
    parser.add_argument("--masks", default=None, metavar="DIR",
                        help="finetune (birefnet): directory of same-stem ground-truth masks (grayscale image or .npy "
                        "in [0, 1]) for the -i images")
    parser.add_argument("--no-augment", action="store_true",
                        help="finetune (birefnet): no flip / color-jitter augmentation")
    parser.add_argument("--lora", type=int, default=None, metavar="RANK",
                        help="distill/finetune (birefnet): train LoRA adapters of this rank instead of the full "
                        "params (merged into the exported file)")
    parser.add_argument("--lora-out", default=None, metavar="GGUF",
                        help="distill/finetune (birefnet): with --lora, also save the unmerged adapters as a GGUF "
                        "adapter file")
    parser.add_argument("--qlora", action="store_true",
                        help="distill/finetune (birefnet), with --lora: keep the frozen base block-quantized "
                        "(int8-resident) under the adapters")
    parser.add_argument("--dp", type=int, default=0, metavar="N",
                        help="serve / directory / video -i: split each batch over N ranks, one card each (rank 0 "
                        "serves; under torchrun its world, else the CLI starts ranks 1..N-1); --batch must divide "
                        "by N")
    args = parser.parse_args(argv)
    args._argv = list(sys.argv[1:] if argv is None else argv)
    if args.input is None and args.command not in ("serve", "quantize", "info", "export"):
        parser.error("-i/--input is required")
    if args.output is None and args.command in ("finetune", "distill"):
        args.output = {"finetune": "finetuned.gguf", "distill": "distilled.gguf"}[args.command]
    if args.output is None and args.command in REQUIRED_INPUTS:
        # directory input = bulk mode (output is a directory); video
        # input = video mode (output is a video)
        from .video import is_video

        if os.path.isdir(args.input[0]):
            args.output = "bulk_out"
        else:
            args.output = "output.mp4" if is_video(args.input[0]) else "output.png"
    if args.input and (args.tile > 0 or args.composite) and not os.path.isdir(args.input[0]):
        from .video import is_video

        if is_video(args.input[0]):
            # both options belong to the single-image paths; accepting and
            # ignoring them would surprise (esrgan video frames run through
            # the whole-image server, capped at ~1 MP/frame)
            print(
                "Error: --tile/--composite are not supported in video mode; "
                "esrgan video frames must fit the whole-image server cap "
                "(~1 MP) — for larger frames extract them to a directory and "
                "use bulk mode, which reports and skips over-cap items",
                file=sys.stderr,
            )
            return 1
    if args.command == "compare":
        return _compare(args, parser)
    if args.command == "quantize":
        return _quantize(args, parser)
    if args.command == "info":
        return _info(args, parser)
    if args.command == "eval":
        return _eval(args, parser)
    try:
        if args.command == "serve":
            _serve(args)
        elif args.command in ("finetune", "distill"):
            _train(args)
        elif args.command == "export":
            _export(args)
        else:
            _run_model(args)
    except VispError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
