"""Per-family fine-tuning recipes (the ``finetune`` and ``distill`` verbs) —
a port of vision_tpu/finetune.py.

Load a deployable GGUF, fine-tune it, export a GGUF. Recipes: Real-ESRGAN
(self-supervised SR: random HR patches, a bicubic LR made on the device,
L1(model(LR), HR)), BiRefNet (supervised masks: same-stem (image, mask)
pairs, BCE + soft-IoU, flip and color jitter on the device) and
Depth-Anything distillation (a frozen teacher's depth as the target,
scale- and shift-invariant L1; optionally LoRA adapters on the student,
over an int8-resident base with ``qlora``). Training keeps f32 master
weights and runs an f32 forward, as the JAX package does; the teacher runs
at the device's inference type.

The step runs eagerly (train.make_train_step): host threads decode images
and cut patches (train.data_loader), ``prefetch_to_device`` copies them
ahead from pinned memory, and on the card the forward launches the
hand-written kernels through their autograd functions (Real-ESRGAN's 351
3x3 convs; BiRefNet's 48 window attentions and 20 deformable convs; the
distillation's student takes none, its dequant kernel aside under
``qlora``), the backward PyTorch ops. Each augmentation draws from a
``torch.Generator`` seeded from the recipe's numpy generator, so a run
reproduces from its seed (with other draws than the JAX package's).

Each recipe takes a ``mesh`` of parallel/ (dp, or dp x tp): every rank
runs the same loop over the same global batches (each loads them whole),
the state is placed by ``create_train_state(mesh=)`` and each rank steps
on its dp rows (train.py). The augmentation draws for the global batch and
each rank applies its rows' draws, so a dp-N step is the one-device step.
The first rank alone logs, writes the checkpoints' file and the outputs.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from .core.errors import raise_error

__all__ = ["distill_depthany", "esrgan_loss", "finetune", "finetune_birefnet", "finetune_esrgan", "list_images",
           "mask_loss", "ssi_loss"]

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".gif")


def list_images(inputs: Sequence[str]) -> list[str]:
    """Expand files/directories into a sorted list of image paths."""
    out: list[str] = []
    for item in inputs:
        if os.path.isdir(item):
            out.extend(os.path.join(item, f) for f in sorted(os.listdir(item)) if f.lower().endswith(_IMG_EXTS))
        else:
            out.append(item)
    if not out:
        raise_error("finetune: no images found in {}", list(inputs))
    return out


def _patch_load(patch: int, seed: int) -> Callable[[tuple], np.ndarray]:
    """Decode one image and cut a random (patch, patch, 3) f32 crop in [0,
    1], reflect-padding images smaller than the patch. Items are ``(index,
    path)`` pairs and the crop's generator is keyed on ``(seed, index)``, so
    the crops do not depend on the worker threads' order (and equal the JAX
    package's)."""
    from .image import image_load

    def load(item: tuple) -> np.ndarray:
        idx, path = item
        a = image_load(path).load_f32x4()[:, :, :3]
        h, w, _ = a.shape
        if h < patch or w < patch:
            a = np.pad(a, ((0, max(0, patch - h)), (0, max(0, patch - w)), (0, 0)), mode="reflect")
            h, w, _ = a.shape
        rng = np.random.default_rng([seed, idx])
        y0 = int(rng.integers(0, h - patch + 1))
        x0 = int(rng.integers(0, w - patch + 1))
        return np.ascontiguousarray(a[y0 : y0 + patch, x0 : x0 + patch])

    return load


def _ckpt_resume(tree, ckpt_dir, log):
    """Resume ``tree`` (a TrainState or a (state, ema) pair) from the newest
    ``step_*`` checkpoint under ``ckpt_dir``. Returns ``(tree, done)``."""
    if not ckpt_dir:
        return tree, 0
    from .train import TrainState, latest_checkpoint, restore_checkpoint

    latest = latest_checkpoint(ckpt_dir)
    if latest is None:
        return tree, 0
    tree = restore_checkpoint(latest, tree)
    state = tree if isinstance(tree, TrainState) else tree[0]
    if log is not None:
        log(f"resumed from {latest} (step {state.step})")
    return tree, state.step


def _ckpt_save(tree, ckpt_dir, every, done, steps):
    """Periodic and final checkpoint, durable before the next step."""
    if ckpt_dir and (done % max(int(every), 1) == 0 or done >= steps):
        from .train import save_checkpoint

        save_checkpoint(os.path.join(os.fspath(ckpt_dir), f"step_{done}"), tree)


def _items(items: list, batch: int) -> list:
    """A folder smaller than one batch still trains: its items repeat up to
    the batch size (each draw crops anew)."""
    return list(items) if len(items) >= batch else [items[i % len(items)] for i in range(batch)]


def _check_steps(steps: int, batch: int, verb: str = "finetune", mesh=None) -> None:
    if steps < 1 or batch < 1:
        raise_error("{}: steps and batch must be >= 1, got {} / {}", verb, steps, batch)
    if mesh is not None:
        from .parallel.sharding import mesh_shape

        dp = mesh_shape(mesh)["dp"]
        if batch % dp:
            raise_error("{}: batch {} must be divisible by the mesh's dp {}", verb, batch, dp)


def _first_rank(mesh) -> bool:
    """Whether this process logs and writes: always without a mesh, the
    mesh's first rank with one."""
    return mesh is None or all(c == 0 for c in mesh.get_coordinate())


def _write_out(params: dict, mesh, write: Callable[[dict], dict]) -> dict:
    """``write(params)`` on the first rank, with a meshed state's params
    gathered whole first (every rank takes part in the gather)."""
    if mesh is not None:
        from .train import full_params

        params = full_params(params)
    return write(params) if _first_rank(mesh) else {}


def esrgan_loss(p, patch: int) -> Callable:
    """Real-ESRGAN's self-supervised loss: the HR batch (N, patch, patch,
    3) bicubic-downscaled by the model's scale on its device, the model's
    upscale of that, and the mean absolute error against the HR batch."""
    from .core.params import Params
    from .models.esrgan import esrgan_generate
    from .ops.resize import resize_nhwc

    lo = patch // p.scale

    def loss_fn(params, hr):
        sr = esrgan_generate(Params(params), resize_nhwc(hr, (lo, lo), method="bicubic"), p)
        return torch.mean(torch.abs(sr - hr))

    return loss_fn


def _train_loop(state, step, tree_of, epochs, ckpt_dir, ckpt_every, steps, done, log, on_step=None,
                verb: str = "finetune"):
    """Run ``step`` over the batches of successive ``epochs()`` until
    ``steps`` updates; returns (state, first loss, last loss)."""
    first = last = None
    while done < steps:
        got = False
        for batch in epochs():
            got = True
            state, metrics = step(state, batch)
            if on_step is not None:
                on_step(state)
            last = float(metrics["loss"])
            if first is None:
                first = last
            done += 1
            _ckpt_save(tree_of(state), ckpt_dir, ckpt_every, done, steps)
            if log is not None and (done == 1 or done % 10 == 0 or done == steps):
                log(f"step {done}/{steps}  loss {last:.5f}")
            if done >= steps:
                break
        if not got:
            raise_error("{}: dataset produced no batches", verb)
    return state, first, last


def finetune_esrgan(model, images: Sequence[str], dst: str | os.PathLike, steps: int = 200, lr: float = 1e-4,
                    batch: int = 4, patch: int = 64, ema_decay: float | None = None, trainable=None, seed: int = 0,
                    device=None, mesh=None, workers: int = 4, ckpt_dir: str | os.PathLike | None = None,
                    ckpt_every: int = 50, log: Callable[[str], None] | None = None) -> dict:
    """Self-supervised SR fine-tune of an ESRGAN GGUF on a folder of images.

    Each step takes ``batch`` random ``patch``-sized HR crops and one Adam
    step on :func:`esrgan_loss`. ``ema_decay`` also tracks EMA weights
    (what Real-ESRGAN ships) and exports those. ``device``: a port Device
    (default: the card). Writes the tuned params to ``dst`` (f32, the
    source's KVs) and returns ``{"out", "steps", "first_loss",
    "last_loss"}``. ``ckpt_dir`` checkpoints the (state, EMA) pair every
    ``ckpt_every`` steps, and a rerun resumes from the newest save (the data
    order restarts from ``seed``). ``mesh``: train over it (module
    docstring); the EMA is kept over the placed params, shard by shard."""
    from .core.device import backend_init
    from .core.gguf import GGUFFile
    from .core.weights import load_weights
    from .models.esrgan import esrgan_detect_params
    from .train import adam, create_train_state, data_loader, ema_update, export_gguf, make_train_step
    from .train import prefetch_to_device

    file = model if isinstance(model, GGUFFile) else GGUFFile(os.fspath(model))
    p = esrgan_detect_params(file)
    if patch % p.scale:
        raise_error("finetune: patch size {} must be divisible by the model scale {}", patch, p.scale)
    _check_steps(steps, batch, mesh=mesh)
    device = device or backend_init()
    log = log if _first_rank(mesh) else None
    params = load_weights(file, device, float_dtype=torch.float32)
    state = create_train_state(params, adam(lr), mesh=mesh, trainable=trainable)
    step = make_train_step(esrgan_loss(p, patch), mesh=mesh, trainable=trainable)
    ema = {k: v.detach().clone() for k, v in state.params.items()} if ema_decay is not None else None
    tree, done = _ckpt_resume((state, ema) if ema is not None else state, ckpt_dir, log)
    state, ema = tree if ema is not None else (tree, None)
    rng = np.random.default_rng(seed)
    items = _items(list(images), batch)

    def epochs():
        ep_seed = int(rng.integers(2**31))
        epoch = data_loader(list(enumerate(items)), batch, load=_patch_load(patch, ep_seed), workers=workers,
                            shuffle=True, seed=ep_seed)
        return prefetch_to_device(epoch, device=device.torch_device, mesh=mesh)

    def track(st):
        nonlocal ema
        if ema is not None:
            ema = ema_update(ema, st.params, decay=ema_decay)

    state, first, last = _train_loop(state, step, lambda st: (st, ema) if ema is not None else st, epochs, ckpt_dir,
                                     ckpt_every, steps, done, log, on_step=track)
    _write_out(ema if ema is not None else state.params, mesh, lambda out: export_gguf(out, dst, source=file))
    return {"out": os.fspath(dst), "steps": state.step, "first_loss": first, "last_loss": last}


def _ssi_normalize(d: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-image scale-and-shift-invariant normalization (MiDaS eq. 5-6):
    subtract the median (the mean of the two middle values for an even
    count, as ``jnp.median``), divide by the mean absolute deviation."""
    flat = d.reshape(d.shape[0], -1).float()
    med = torch.quantile(flat, 0.5, dim=1, keepdim=True)
    dev = torch.mean(torch.abs(flat - med), dim=1, keepdim=True)
    return (flat - med) / (dev + eps)


def ssi_loss(sp) -> Callable:
    """The distillation loss: the student's depth of the batch's images
    against the teacher's target, both per-image median/MAD normalized, L1.
    The batch is ``(x, target)``."""
    from .core.params import Params
    from .models.depth_anything import depthany_predict

    def loss_fn(params, batch):
        x, target = batch
        s = depthany_predict(Params(params), x, sp)
        return torch.mean(torch.abs(_ssi_normalize(s) - _ssi_normalize(target)))

    return loss_fn


def _resize_load(size: int) -> Callable[[str], np.ndarray]:
    """Decode one image, square-resize it to (size, size), ImageNet-normalize
    (the host half of the distillation's input pipeline)."""
    from .image import ImageFormat, image_load, image_scale, image_u8_to_f32, preprocess_scale_method
    from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

    def load(path: str) -> np.ndarray:
        img = image_load(path)
        if img.extent != (size, size):
            img = image_scale(img, (size, size), preprocess_scale_method())
        out = image_u8_to_f32(img, ImageFormat.rgb_f32, offset=tuple(-m for m in IMAGENET_MEAN),
                              scale=tuple(1.0 / s for s in IMAGENET_STD))
        return np.ascontiguousarray(out.data[:, :, :3])

    return load


def _student_params(s_np: dict, trainable, lora_rank, qlora: bool, seed: int, verb: str):
    """The student's host store with LoRA (and QLoRA) applied as asked, and
    its ``trainable``."""
    if qlora and lora_rank is None:
        raise_error("{}: qlora requires lora_rank (the base is frozen quantized)", verb)
    if lora_rank is None:
        return s_np, trainable
    from .lora import LORA_TRAINABLE, add_lora

    if trainable is not None:
        raise_error("{}: pass either lora_rank or trainable, not both", verb)
    if lora_rank < 1:
        raise_error("{}: lora_rank must be >= 1, got {}", verb, lora_rank)
    if qlora:
        # the base block-quantized in memory: adapters attach next to the
        # int8-resident (frozen) weights
        from .core.quant import quantize_store

        s_np = quantize_store(s_np, dtype=torch.float32)
    return add_lora(s_np, rank=lora_rank, seed=seed), LORA_TRAINABLE


def _export(params: dict, dst, source, lora_rank, lora_out, mesh=None) -> dict:
    """Save the adapters (``lora_out``), merge them, and export (on the
    first rank of a mesh, from the params gathered whole)."""
    from .train import export_gguf

    def write(params):
        if lora_rank is not None:
            from .lora import merge_lora, save_lora

            if lora_out is not None:
                save_lora(params, lora_out, arch=source.arch)
            params = merge_lora(params)
        export_gguf(params, dst, source=source)

    _write_out(params, mesh, write)
    result = {"out": os.fspath(dst)}
    if lora_rank is not None and lora_out is not None:
        result["lora_out"] = os.fspath(lora_out)
    return result


def distill_depthany(teacher, student, images: Sequence[str], dst: str | os.PathLike, steps: int = 200,
                     lr: float = 1e-4, batch: int = 4, size: int = 252, trainable=None, lora_rank: int | None = None,
                     lora_out: str | os.PathLike | None = None, qlora: bool = False, seed: int = 0, device=None,
                     mesh=None, workers: int = 4, ckpt_dir: str | os.PathLike | None = None, ckpt_every: int = 50,
                     log: Callable[[str], None] | None = None) -> dict:
    """Knowledge distillation for Depth-Anything: train a small student GGUF
    against a larger teacher's depth on unlabeled images.

    Each step resizes ``batch`` images to ``size``² (a multiple of the 14-px
    patch), runs the frozen teacher (at the device's inference type, no
    grad) for the target and takes one Adam step on :func:`ssi_loss`.
    ``lora_rank`` trains only LoRA adapters on the student's linears and 1x1
    convs and merges them into the export (``lora_out`` also saves the
    unmerged adapter file); ``qlora`` keeps the student's base
    int8-resident and frozen under them. Writes the student to ``dst`` (f32,
    the student's KVs) and returns ``{"out", "steps", "first_loss",
    "last_loss"}`` (and ``"lora_out"``). ``mesh``: train over it (module
    docstring); the teacher is placed by ``shard_params`` and runs on each
    rank's dp rows, whose targets are all that rank's loss needs. Under
    ``qlora`` the int8 residents stay whole on every rank, as the JAX
    package's ``shard_params`` places them (replicated)."""
    from .core.device import backend_init
    from .core.gguf import GGUFFile
    from .core.params import Params
    from .core.weights import load_weights, params_from_numpy
    from .models.depth_anything import depthany_detect_params, depthany_predict, fixup_weights
    from .parallel.tp import is_dtensor
    from .train import adam, create_train_state, data_loader, make_train_step, prefetch_to_device

    tfile = teacher if isinstance(teacher, GGUFFile) else GGUFFile(os.fspath(teacher))
    sfile = student if isinstance(student, GGUFFile) else GGUFFile(os.fspath(student))
    tp, sp = depthany_detect_params(tfile), depthany_detect_params(sfile)
    mult = max(tp.image_multiple, sp.image_multiple)
    if size % mult or size < mult:
        raise_error("distill: size {} must be a positive multiple of the patch size {}", size, mult)
    _check_steps(steps, batch, "distill", mesh)
    device = device or backend_init()
    log = log if _first_rank(mesh) else None
    t_np = fixup_weights(tfile, load_weights(tfile, as_numpy=True))
    s_np, trainable = _student_params(fixup_weights(sfile, load_weights(sfile, as_numpy=True)), trainable,
                                      lora_rank, qlora, seed, "distill")
    s_params = params_from_numpy(s_np, device.torch_device, torch.float32)
    t_params = params_from_numpy(t_np, device.torch_device, device.preferred_float_type)
    if mesh is not None:
        from .parallel.sharding import mesh_params

        t_params = mesh_params(t_params, mesh, device)

    @torch.no_grad()
    def teacher_fwd(x):
        if not is_dtensor(x):
            return depthany_predict(Params(t_params), x.to(device.preferred_float_type), tp)
        from torch.distributed.tensor import DTensor

        rows = depthany_predict(Params(t_params), x.to_local().to(device.preferred_float_type), tp)
        return DTensor.from_local(rows, x.device_mesh, x.placements, run_check=False)

    state = create_train_state(s_params, adam(lr), mesh=mesh, trainable=trainable)
    step = make_train_step(ssi_loss(sp), mesh=mesh, trainable=trainable)
    state, done = _ckpt_resume(state, ckpt_dir, log)
    rng = np.random.default_rng(seed)
    items = _items(list(images), batch)

    def epochs():
        epoch = data_loader(items, batch, load=_resize_load(size), workers=workers, shuffle=True,
                            seed=int(rng.integers(2**31)))
        return ((x, teacher_fwd(x)) for x in prefetch_to_device(epoch, device=device.torch_device, mesh=mesh))

    state, first, last = _train_loop(state, step, lambda st: st, epochs, ckpt_dir, ckpt_every, steps, done, log,
                                     verb="distill")
    result = _export(state.params, dst, sfile, lora_rank, lora_out, mesh)
    return {**result, "steps": state.step, "first_loss": first, "last_loss": last}


def _mask_load(size: int) -> Callable[[tuple], tuple]:
    """Host half of the mask fine-tune's pipeline: one (image, mask) pair
    square-resized to ``size``², as ``(rgb [0, 1] f32, mask (H, W, 1) [0, 1]
    f32)``; the image goes un-normalized (the step jitters it first).
    Masks read through the eval loaders (grayscale PNG, .npy, color)."""
    from .evaluate import _gray, _load_map, _resize_to
    from .image import ImageFormat, image_load, image_scale, image_u8_to_f32, preprocess_scale_method

    def load(pair: tuple) -> tuple:
        img_p, mask_p = pair
        img = image_load(img_p)
        if img.extent != (size, size):
            img = image_scale(img, (size, size), preprocess_scale_method())
        x = image_u8_to_f32(img, ImageFormat.rgb_f32).data[:, :, :3]
        m = _resize_to(_gray(_load_map(mask_p)), (size, size))[:, :, None]
        return np.ascontiguousarray(x), np.ascontiguousarray(np.clip(m, 0.0, 1.0))

    return load


def mask_loss(bp, augment: bool = True) -> Callable:
    """BiRefNet's supervised loss on a batch ``(x [0, 1], mask, (seed,
    total), rows)``: x and mask hold rows ``rows`` (int64) of a batch of
    ``total`` samples (all of them, ``torch.arange(total)``, on one
    device). With ``augment``, a consistent horizontal flip of image and
    mask and a color jitter of the image (0.2 brightness, contrast and
    saturation), drawn for the whole batch from a ``torch.Generator``
    seeded with ``seed``, each row taking its own draws (ops/augment.py);
    ImageNet normalization; BCE + (1 - soft IoU) of ``birefnet_predict``
    against the mask. The IoU term is a mean over the rows, so the loss of
    a batch is the mean of its rows' losses over any equal split."""
    from .core.params import Params
    from .models.birefnet import birefnet_predict
    from .ops.augment import color_jitter, random_flip
    from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

    def loss_fn(params, batch):
        x, m, (seed, total), rows = batch
        if augment:
            gen = torch.Generator().manual_seed(int(seed))
            both = random_flip(gen, torch.cat([x, m], dim=-1), rows=rows, total=total)
            x, m = both[..., :3], both[..., 3:]
            x = color_jitter(gen, x, brightness=0.2, contrast=0.2, saturation=0.2, rows=rows, total=total)
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        pm = birefnet_predict(Params(params), (x - mean) / std, bp)
        eps = 1e-6
        bce = -torch.mean(m * torch.log(pm + eps) + (1 - m) * torch.log(1 - pm + eps))
        inter = torch.sum(pm * m, dim=(1, 2, 3))
        union = torch.sum(pm, dim=(1, 2, 3)) + torch.sum(m, dim=(1, 2, 3)) - inter
        return bce + (1.0 - torch.mean((inter + 1.0) / (union + 1.0)))

    return loss_fn


def finetune_birefnet(model, images: Sequence[str], dst: str | os.PathLike, masks: str | None = None,
                      steps: int = 200, lr: float = 1e-4, batch: int = 4, size: int = 256, augment: bool = True,
                      trainable=None, lora_rank: int | None = None, lora_out: str | os.PathLike | None = None,
                      qlora: bool = False, seed: int = 0, device=None, mesh=None, workers: int = 4,
                      ckpt_dir: str | os.PathLike | None = None, ckpt_every: int = 50,
                      log: Callable[[str], None] | None = None) -> dict:
    """Supervised mask fine-tune of a BiRefNet GGUF on (image, mask) pairs
    (a folder of images and same-stem masks, grayscale images or .npy in
    [0, 1]).

    Each step resizes ``batch`` pairs to ``size``² (snapped up to the
    model's ``image_multiple``) and takes one Adam step on
    :func:`mask_loss` (augmented unless ``augment`` is off). ``lora_rank``
    trains only LoRA adapters (SWIN's linears outside the window qkv, the
    decoder's 1x1 convs) and merges them into the export; ``lora_out`` also
    saves the adapter file. Writes the tuned model to ``dst`` (f32, source
    KVs) and returns ``{"out", "steps", "first_loss", "last_loss"}``.
    ``mesh``: train over it (module docstring); each batch carries its
    augmentation seed, the batch size and the row indices, which the step
    splits over dp with the images."""
    from .bulk import pair_masks
    from .core.device import backend_init
    from .core.gguf import GGUFFile
    from .core.graph import snap_to_multiple
    from .core.weights import load_weights, params_from_numpy
    from .models.birefnet import birefnet_detect_params, fixup_weights
    from .train import adam, create_train_state, data_loader, make_train_step, prefetch_to_device

    file = model if isinstance(model, GGUFFile) else GGUFFile(os.fspath(model))
    bp = birefnet_detect_params(file)
    if masks is None:
        raise_error("finetune(birefnet): pass masks=<dir of same-stem ground-truth masks>")
    _check_steps(steps, batch, mesh=mesh)
    log = log if _first_rank(mesh) else None
    s = snap_to_multiple(max(int(size), bp.image_multiple), bp.image_multiple)
    if s != size and log is not None:
        log(f"size {size} -> {s} (model grid: multiples of {bp.image_multiple})")
    pairs = pair_masks(list(images), masks)
    device = device or backend_init()
    s_np, trainable = _student_params(fixup_weights(file, load_weights(file, as_numpy=True)), trainable,
                                      lora_rank, qlora, seed, "finetune")
    params = params_from_numpy(s_np, device.torch_device, torch.float32)
    state = create_train_state(params, adam(lr), mesh=mesh, trainable=trainable)
    step = make_train_step(mask_loss(bp, augment), mesh=mesh, trainable=trainable)
    state, done = _ckpt_resume(state, ckpt_dir, log)
    rng = np.random.default_rng(seed)
    items = _items(pairs, batch)
    rows = torch.arange(batch)

    def epochs():
        epoch = data_loader(items, batch, load=_mask_load(s), workers=workers, shuffle=True,
                            seed=int(rng.integers(2**31)))
        # one augmentation seed a batch, kept on the host with the batch size; the row
        # indices (host) split over dp with the images
        return ((x, m, (int(rng.integers(2**62)), batch), rows)
                for x, m in prefetch_to_device(epoch, device=device.torch_device, mesh=mesh))

    state, first, last = _train_loop(state, step, lambda st: st, epochs, ckpt_dir, ckpt_every, steps, done, log)
    result = _export(state.params, dst, file, lora_rank, lora_out, mesh)
    return {**result, "steps": state.step, "first_loss": first, "last_loss": last}


_RECIPES = {"esrgan": finetune_esrgan, "birefnet": finetune_birefnet}


def finetune(model, images: Sequence[str], dst, **kw) -> dict:
    """Family-dispatching fine-tune: detect the GGUF's family and run its
    recipe, esrgan (self-supervised SR) or birefnet (supervised masks, pass
    ``masks=<dir>``). Other families train through the ``train`` API with a
    task loss of their own."""
    from .api import model_detect_family
    from .core.gguf import GGUFFile

    file = model if isinstance(model, GGUFFile) else GGUFFile(os.fspath(model))
    family = model_detect_family(file).value
    recipe = _RECIPES.get(family)
    if recipe is None:
        raise_error(
            "finetune: no self-supervised recipe for family '{}' (have: {}); use the vision_tpu_torch.train API "
            "with a task loss instead", family, ", ".join(sorted(_RECIPES)),
        )
    return recipe(file, images, dst, **kw)
