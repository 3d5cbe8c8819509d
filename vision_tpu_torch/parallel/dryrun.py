"""The multi-card dry run — a port of ``__graft_entry__.dryrun_multichip``:
every model family through its production loader path and server on an
n-rank mesh, each held against the same model on one rank, and a meshed
training step.

  1. MobileSAM's encoder over a dp x tp mesh (``SamModel.encode_batch``);
  2. Real-ESRGAN's tiled ``compute`` with the tile batch split over dp;
  3. SAM3's vision encoder tensor-, sequence- and pipeline-parallel (the
     window-major trunk over tp, sp and pp), and BiRefNet's dp x tp
     ``compute_batch``;
  4. Depth-Anything (dp x tp) and MI-GAN (dp) through ``ImageServer`` and
     YOLOv9t (dp) through ``YoloServer``, one full batch each;
  5. a dp x tp Adam step of a small DINOv2 through
     ``create_train_state(..., fsdp=True, fsdp_min_size=1024)`` and
     ``make_train_step(mesh)`` (every rank in lock step), against the same
     step on one rank.

tp is 2 where n is even and at least 4, as in the JAX package. Run it on n cards
(``device="cuda"``) or n CPU processes (``"cpu"``, gloo); under torchrun
every rank calls it, elsewhere it starts the n ranks itself.
"""

from __future__ import annotations

import os
import tempfile
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the dry run over ``n_devices`` ranks; raises if a rank fails or
    a meshed output departs from its one-rank reference."""
    if dist.is_initialized():
        if dist.get_world_size() < n_devices:
            from ..core.errors import raise_error

            raise_error("dryrun_multichip: need {} ranks, have {}", n_devices, dist.get_world_size())
        _run(n_devices, device)
        return
    from .sharding import cards_available, make_mesh

    if n_devices > cards_available(device):
        make_mesh(n_devices, device=device)  # its error, before any rank starts
    import torch.multiprocessing as mp

    address = "file://" + os.path.join(tempfile.mkdtemp(prefix="visp-dryrun-"), "store")
    mp.spawn(_rank_main, args=(n_devices, address, device), nprocs=n_devices, join=True)


def _rank_main(rank: int, n: int, address: str, device: str) -> None:
    from .sharding import init_distributed

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    init_distributed(address, n, rank, device=device)
    try:
        _run(n, device)
    finally:
        dist.destroy_process_group()


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12))


def _run(n: int, device: str) -> None:
    """Every rank: SAM3's tp, sp and pp checks in lock step, then the meshed
    models are built in one order on every rank; rank 0 runs the served
    checks while the others follow it."""
    from ..core.device import backend_init
    from .runner import follow, stop_workers
    from .sharding import mesh_shape

    dev = backend_init("cpu" if device == "cpu" else "gpu")
    tp = 2 if n % 2 == 0 and n >= 4 else 1
    sam3 = sam3_checks(n, tp, dev, device)
    train_step_check(n, tp, dev, device)
    built = _build(n, tp, dev, device)
    if dist.get_rank() != 0:
        follow()
        return
    try:
        for check in (_check_sam, _check_esrgan, _check_birefnet, _check_servers):
            check(built, dev)
    finally:
        stop_workers()
    _say(f"dryrun {n} ranks ok ({device}); mesh dp x tp = {mesh_shape(built['mesh_tp'])}; SAM3 tp / sp / pp at "
         f"{' / '.join(str(m) for m in sam3)}")


def _sam3_case(dev):
    """The dry run's reduced SAM3 vision encoder (__graft_entry__.py:369-379):
    4 layers of width 64 and 4 heads, a 32 px image in patches of 4 (an
    8x8 grid, 2x2 windows of 4x4), f32 on ``dev``; its window stack."""
    from ..core.weights import params_from_numpy
    from ..models.random_weights import random_sam3_vision_params
    from ..models.sam3 import Sam3VitParams, sam3_pack_vision_weights

    vp = Sam3VitParams(image_size=32, patch_size=4, window_size=4, n_layers=4, n_heads=4,
                       global_attn_indexes=(1, 3))
    store = dict(random_sam3_vision_params(dim=64, layers=4))
    rng = np.random.default_rng(17)
    store["backbone.embeddings.patch_embeddings.projection.weight"] = (
        rng.standard_normal((64, 3, 4, 4)).astype(np.float32) * 0.05)
    params = params_from_numpy(store, dev.torch_device, torch.float32)
    return vp, params, sam3_pack_vision_weights(params, vp, prefix="backbone."), rng


def sam3_checks(n: int, tp: int, dev, device: str) -> list:
    """Steps 3a, 3c and 3d on every rank in lock step, each against the
    unsharded window-major trunk at max |delta| < 2e-5: SAM3's vision
    encoder with Megatron tp (sam3_shard_vision); sequence-parallel (the
    2x2 = 4 windows over sp 4 where n divides by 4, else sp 2, composed
    with tp 2 where n divides by sp * 2); pipeline-parallel (the trunk's 2
    uniform stages over pp 2, tp 2 where n divides by 4, a 3-image batch as
    GPipe microbatches, from stage weights each rank holds only its slice
    of). Where n is odd, sp and pp run at 1 (the JAX package skips them):
    the same paths on meshes of one. Returns the meshes' shapes."""
    from ..core.params import Params
    from ..models.sam3 import encode_vision, encode_vision_pipelined, sam3_pipeline_weights, sam3_shard_vision
    from .sharding import make_mesh, mesh_shape

    vp, params, stack, rng = _sam3_case(dev)
    x = torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32)).to(dev.torch_device)

    def fpn(p, s, xx, mesh=None):
        with torch.inference_mode():
            return [f.cpu().numpy() for f in encode_vision(Params(p), xx, vp, win_stack=s, mesh=mesh).fpn_hidden_states]

    def check(what, got, expected):
        delta = max(float(np.abs(g - e).max()) for g, e in zip(got, expected))
        assert delta < 2e-5, f"{what} SAM3 vision parity max|delta|={delta}"
        return delta

    expected = fpn(params, stack, x)
    ran = []
    mesh = make_mesh(n, tp=tp, device=device)
    delta = check("sharded", fpn(*sam3_shard_vision(params, stack, mesh, vp), x), expected)
    _say(f"dryrun SAM3 tp-sharded vision parity ok: mesh={mesh_shape(mesh)} fpn_scales={len(expected)} "
         f"max|delta|={delta:.2e}")
    ran.append(mesh_shape(mesh))

    sp = 4 if n % 4 == 0 else 2 if n % 2 == 0 else 1
    mesh = make_mesh(n, tp=2 if n % (sp * 2) == 0 else 1, sp=sp, device=device)
    delta = check("sp-sharded", fpn(*sam3_shard_vision(params, stack, mesh, vp), x, mesh), expected)
    _say(f"dryrun SAM3 sequence-parallel vision parity ok: mesh={mesh_shape(mesh)} fpn_scales={len(expected)} "
         f"max|delta|={delta:.2e}")
    ran.append(mesh_shape(mesh))

    mesh = make_mesh(n, pp=2 if n % 2 == 0 else 1, tp=2 if n % 4 == 0 else 1, device=device)
    imgs = torch.from_numpy(rng.random((3, 32, 32, 3)).astype(np.float32)).to(dev.torch_device)
    stage_w = sam3_pipeline_weights(Params(params)["backbone"], stack, vp, mesh)
    with torch.inference_mode():
        got = [f.cpu().numpy() for f in encode_vision_pipelined(Params(params), imgs, vp, stage_weights=stage_w,
                                                                mesh=mesh).fpn_hidden_states]
    delta = check("pp-pipelined", got, fpn(params, stack, imgs))
    _say(f"dryrun SAM3 pipeline-parallel vision parity ok: mesh={mesh_shape(mesh)} microbatches=3 "
         f"max|delta|={delta:.2e}")
    ran.append(mesh_shape(mesh))
    return ran


def train_case(dim: int = 64, heads: int = 4, layers: int = 3, grid: int = 4, seed: int = 0):
    """Step 5's small DINOv2 (patch 14, ``grid``² patches): its numpy
    weights and DinoParams (__graft_entry__.py:86-121)."""
    from ..models.dino import DinoParams

    rng = np.random.default_rng(seed)
    p: dict = {}

    def lin(name, ci, co):
        p[f"{name}.weight"] = (rng.standard_normal((co, ci)) * ci**-0.5).astype(np.float32)
        p[f"{name}.bias"] = np.zeros(co, np.float32)

    def ln(name, c):
        p[f"{name}.weight"] = np.ones(c, np.float32)
        p[f"{name}.bias"] = np.zeros(c, np.float32)

    p["embeddings.cls_token"] = np.zeros((1, 1, dim), np.float32)
    p["embeddings.position_embeddings"] = (rng.standard_normal((1, grid * grid + 1, dim)) * 0.02).astype(np.float32)
    p["embeddings.patch_embeddings.projection.weight"] = (rng.standard_normal((dim, 3, 14, 14)) * 0.02).astype(
        np.float32)
    p["embeddings.patch_embeddings.projection.bias"] = np.zeros(dim, np.float32)
    for i in range(layers):
        base = f"encoder.layer.{i}"
        ln(f"{base}.norm1", dim)
        ln(f"{base}.norm2", dim)
        for qkv in ("query", "key", "value"):
            lin(f"{base}.attention.attention.{qkv}", dim, dim)
        lin(f"{base}.attention.output.dense", dim, dim)
        p[f"{base}.layer_scale1.lambda1"] = np.full(dim, 0.1, np.float32)
        p[f"{base}.layer_scale2.lambda1"] = np.full(dim, 0.1, np.float32)
        lin(f"{base}.mlp.fc1", dim, dim * 4)
        lin(f"{base}.mlp.fc2", dim * 4, dim)
    ln("layernorm", dim)
    return p, DinoParams(patch_size=14, embed_dim=dim, n_heads=heads, n_layers=layers)


# step 5's rules: the defaults and the JAX dry run's extra q/k/v / output.dense patterns
TRAIN_RULES_EXTRA = ((r".*\b(query|key|value)\.weight$", 0), (r".*\b(query|key|value)\.bias$", 0),
                     (r".*\boutput\.dense\.weight$", 1))


def train_loss(dp):
    """Step 5's loss: the mean square of the last layer's features."""
    from ..core.params import Params
    from ..models.dino import dino_get_intermediate_layers

    def loss_fn(weights, batch):
        feats = dino_get_intermediate_layers(Params(weights), batch, [dp.n_layers - 1], dp)
        return torch.mean(feats[-1].float() ** 2)

    return loss_fn


def train_step_check(n: int, tp: int, dev, device: str) -> None:
    """Step 5, on every rank in lock step: one adam step of the small DINOv2
    over dp x tp with fsdp (the patch embedding's 37632 elements pass
    ``fsdp_min_size`` 1024, and at tp 1 the MLP's too), against the step
    on this rank alone."""
    from ..train import adam, create_train_state, full_params, make_train_step
    from .sharding import DEFAULT_TP_RULES, make_mesh, mesh_shape

    p, dp = train_case()
    mesh = make_mesh(n, tp=tp, device=device)
    # each state takes its own copy (the optimizer updates what it is given in place)
    state = create_train_state({k: v.copy() for k, v in p.items()}, adam(1e-3), mesh=mesh,
                               rules=DEFAULT_TP_RULES + TRAIN_RULES_EXTRA, fsdp=True, fsdp_min_size=1024)
    step = make_train_step(train_loss(dp), mesh=mesh)
    batch = torch.from_numpy(np.random.default_rng(1).random((max(n, 2), 56, 56, 3)).astype(np.float32))
    batch = batch.to(dev.torch_device)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    name = "encoder.layer.0.mlp.fc1.weight"
    moved = full_params({name: state.params[name]})[name]
    delta = float((moved.float().cpu() - torch.from_numpy(p[name])).abs().max())
    assert delta > 0, "the meshed step left the fc1 weight where it was"
    assert state.step == 1, state.step
    one = create_train_state({k: torch.from_numpy(v.copy()).to(dev.torch_device) for k, v in p.items()}, adam(1e-3))
    one, ref = make_train_step(train_loss(dp))(one, batch)
    gap = abs(loss - float(ref["loss"])) / abs(float(ref["loss"]))
    assert gap <= 1e-5, f"meshed step loss {loss} vs one rank's {float(ref['loss'])}"
    _say(f"dryrun dp x tp fsdp train step ok: mesh={mesh_shape(mesh)} loss={loss:.6f} (one rank: "
         f"{float(ref['loss']):.6f}) fc1 max|update|={delta:.2e} step={state.step}")


def _build(n: int, tp: int, dev, device: str) -> dict:
    """The meshed models of steps 1-4, built in this order on every rank."""
    from ..models.birefnet import BirefnetModel, BirefnetParams
    from ..models.depth_anything import DepthAnythingModel, DepthAnythingParams
    from ..models.dino import DinoParams
    from ..models.esrgan import EsrganModel, EsrganParams
    from ..models.migan import MiganModel, MiganParams
    from ..models.mobile_sam import SamModel, SamParams
    from ..models.random_weights import (
        random_birefnet_params,
        random_depth_anything_params,
        random_esrgan_params,
        random_migan_params,
        random_mobile_sam_params,
        random_yolov9t_params,
    )
    from ..models.swin import SWIN_T_PARAMS
    from ..models.yolov9t import Yolov9tModel, Yolov9tParams
    from .sharding import make_mesh

    def put(store):
        from ..core.weights import params_from_numpy

        return params_from_numpy(store, dev.torch_device, dev.preferred_float_type)

    mesh_tp = make_mesh(n, tp=tp, device=device)
    mesh_dp = make_mesh(n, device=device)
    da_mesh = make_mesh(n, tp=2, device=device) if n % 2 == 0 else mesh_dp
    b = {"mesh_tp": mesh_tp, "mesh_dp": mesh_dp, "da_mesh": da_mesh}
    b["sam"] = (random_mobile_sam_params(seed=0), SamParams())
    b["sam_mesh"] = SamModel(put(b["sam"][0]), SamParams(), dev, mesh=mesh_tp)
    b["esrgan"] = (random_esrgan_params(seed=1, nf=8, nb=1, gc=4), EsrganParams(4, 1))
    b["esrgan_mesh"] = EsrganModel(put(b["esrgan"][0]), b["esrgan"][1], dev, mesh=mesh_dp)
    b["birefnet"] = (random_birefnet_params("tiny"),
                     BirefnetParams(image_size=64, image_extent=(64, 64), encoder=SWIN_T_PARAMS))
    b["birefnet_mesh"] = BirefnetModel(put(b["birefnet"][0]), b["birefnet"][1], dev, mesh=mesh_tp)
    b["migan"] = (random_migan_params(64), MiganParams(resolution=64))
    b["migan_mesh"] = MiganModel(put(b["migan"][0]), b["migan"][1], dev, mesh=mesh_dp)
    b["depthany"] = (random_depth_anything_params("test"),
                     DepthAnythingParams(dino=DinoParams(embed_dim=64, n_heads=2, n_layers=4), image_size=126,
                                         feature_layers=(0, 1, 2, 3)))
    b["depthany_mesh"] = DepthAnythingModel(put(b["depthany"][0]), b["depthany"][1], dev, mesh=da_mesh)
    b["yolo"] = (random_yolov9t_params(), Yolov9tParams(input_size=160))
    b["yolo_mesh"] = Yolov9tModel(put(b["yolo"][0]), b["yolo"][1], dev, mesh=mesh_dp)
    b["put"] = put
    return b


def _dp(mesh) -> int:
    from .sharding import mesh_shape

    return mesh_shape(mesh)["dp"]


def _check_sam(b: dict, dev) -> None:
    """Step 1: the encoder through SamModel.encode_batch over dp x tp."""
    from ..image import image_load_array
    from ..models.mobile_sam import SamModel, SamParams
    from .sharding import mesh_shape

    dp = _dp(b["mesh_tp"])
    uniq = np.random.default_rng(7).integers(0, 256, (1024, 1024, 3)).astype(np.uint8)
    images = [image_load_array(uniq)] * dp
    emb = b["sam_mesh"].encode_batch(images).float().cpu().numpy()
    single = SamModel(b["put"](b["sam"][0]), SamParams(), dev)
    single.encode(images[0])
    ref = single.embed.float().cpu().numpy()[0]
    assert emb.shape[0] == dp, emb.shape
    delta = _agree("sharded SAM encode parity", emb, np.broadcast_to(ref, emb.shape), 2e-5, dev)
    _say(f"dryrun sharded SAM encode parity ok: mesh={mesh_shape(b['mesh_tp'])} batch={dp} embed={emb.shape} "
         f"max|delta|={delta:.2e}")


def _agree(what: str, got, ref, cpu_max: float, dev) -> float:
    """A meshed output against one rank's: within the JAX package's max
    |delta| on f32 CPU ranks; on bf16 cards, where a shard's batch may tile
    the products differently, within a relative RMS of 2e-2. Returns the
    reading."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if dev.preferred_float_type == torch.float32:
        delta = float(np.abs(got - ref).max())
        assert delta <= cpu_max, f"{what} max|delta|={delta}"
        return delta
    rel = _rel_rms(got, ref)
    assert rel <= 2e-2, f"{what} relative RMS {rel}"
    return rel


def _check_esrgan(b: dict, dev) -> None:
    """Step 2: the tiled Real-ESRGAN path, its tile batch split over dp."""
    from ..image import image_load_array
    from ..models.esrgan import EsrganModel
    from .sharding import mesh_shape

    n = _dp(b["mesh_dp"])
    img = image_load_array(np.random.default_rng(3).integers(0, 256, (40, 56, 3)).astype(np.uint8))
    ref = EsrganModel(b["put"](b["esrgan"][0]), b["esrgan"][1], dev).compute(img, tile_size=32, batch=2)
    out = b["esrgan_mesh"].compute(img, tile_size=32, batch=n)
    assert out.extent == ref.extent, (out.extent, ref.extent)
    delta = _agree("sharded ESRGAN tile parity", out.data, ref.data, 1, dev)
    _say(f"dryrun sharded ESRGAN tiled parity ok: mesh={mesh_shape(b['mesh_dp'])} tiles dp-sharded, "
         f"out={out.extent} max|delta|={delta}")


def _check_birefnet(b: dict, dev) -> None:
    """Step 3b: BiRefNet's compute_batch over dp x tp."""
    from ..image import image_load_array
    from ..models.birefnet import BirefnetModel
    from .sharding import mesh_shape

    dp = _dp(b["mesh_tp"])
    rng = np.random.default_rng(9)
    imgs = [image_load_array(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)) for _ in range(dp)]
    out = b["birefnet_mesh"].compute_batch(imgs)
    ref = BirefnetModel(b["put"](b["birefnet"][0]), b["birefnet"][1], dev).compute(imgs[0])
    delta = _agree("sharded birefnet parity", out[0].data, ref.data, 1, dev)
    _say(f"dryrun sharded BiRefNet parity ok: mesh={mesh_shape(b['mesh_tp'])} batch={dp} mask={out[0].extent} "
         f"max|delta|={delta}")


def _check_servers(b: dict, dev) -> None:
    """Step 4: MI-GAN and Depth-Anything through ImageServer, YOLOv9t
    through YoloServer, each one full batch, against one rank's compute."""
    from ..image import Image, ImageFormat
    from ..models.depth_anything import DepthAnythingModel
    from ..models.migan import MiganModel
    from ..models.yolov9t import Yolov9tModel
    from ..serve import ImageServer, YoloServer
    from .sharding import mesh_shape

    rng = np.random.default_rng(23)
    dp = _dp(b["mesh_dp"])
    mask = Image((rng.random((64, 64, 1)) > 0.5).astype(np.uint8) * 255, ImageFormat.alpha_u8)
    imgs = [Image(rng.integers(0, 255, (64, 64, 4), np.uint8), ImageFormat.rgba_u8) for _ in range(dp)]
    with ImageServer(b["migan_mesh"], batch_size=dp, max_delay_ms=10_000) as srv:
        outs = [f.result(timeout=600) for f in [srv.submit((im, mask)) for im in imgs]]
    assert srv.stats.batches == 1, srv.stats
    single = MiganModel(b["put"](b["migan"][0]), b["migan"][1], dev)
    for im, out in zip(imgs[:2], outs[:2]):
        ref = single.compute(im, mask)
        _agree("sharded MI-GAN serving parity", out.data, ref.data, 0, dev)
    _say(f"dryrun MI-GAN dp-served parity ok: mesh={mesh_shape(b['mesh_dp'])} batch={dp}")

    da_dp = _dp(b["da_mesh"])
    da_imgs = [Image(rng.integers(0, 255, (126, 140, 4), np.uint8), ImageFormat.rgba_u8) for _ in range(da_dp)]
    with ImageServer(b["depthany_mesh"], batch_size=da_dp, max_delay_ms=10_000) as srv:
        da_outs = [f.result(timeout=600) for f in [srv.submit(im) for im in da_imgs]]
    assert srv.stats.batches == 1, srv.stats
    single = DepthAnythingModel(b["put"](b["depthany"][0]), b["depthany"][1], dev)
    delta = 0.0
    for im, out in zip(da_imgs[:2], da_outs[:2]):
        ref = single.compute(im)
        # tp reductions reorder float sums; the depth map is u8-quantized
        # downstream so <=1e-3 is well inside output precision
        delta = _agree("sharded Depth-Anything serving parity", out.data, ref.data, 1e-3, dev)
    _say(f"dryrun Depth-Anything dp x tp-served parity ok: mesh={mesh_shape(b['da_mesh'])} batch={da_dp} "
         f"max|delta|={delta:.2e}")

    yp = b["yolo"][1]
    y_imgs = [Image(rng.integers(0, 255, (120, 160, 3), np.uint8), ImageFormat.rgb_u8) for _ in range(dp)]
    n_anchors = sum((yp.input_size // st) ** 2 for st in (8, 16, 32))
    with YoloServer(b["yolo_mesh"], batch_size=dp, max_delay_ms=10_000, conf_thres=0.001,
                    max_candidates=n_anchors) as srv:
        dets = [f.result(timeout=600) for f in [srv.submit(im) for im in y_imgs]]
    assert srv.stats.batches == 1, srv.stats
    single = Yolov9tModel(b["put"](b["yolo"][0]), yp, dev)
    for im, det in zip(y_imgs[:2], dets[:2]):
        ref = single.compute(im, conf_thres=0.001)
        got = [(d.class_id, round(d.confidence, 5)) for d in det]
        exp = [(d.class_id, round(d.confidence, 5)) for d in ref]
        if dev.preferred_float_type == torch.float32:
            assert got == exp, f"sharded YOLOv9t serving parity: {got[:3]} vs {exp[:3]}"
        else:  # bf16: a shard's batch may round a near-tie score the other way
            kept = sum((Counter((c, round(f, 2)) for c, f in got) & Counter((c, round(f, 2)) for c, f in exp)).values())
            assert kept >= 0.9 * len(exp), f"sharded YOLOv9t serving parity: {kept} of {len(exp)} kept alike"
    _say(f"dryrun YOLOv9t dp-served parity ok: mesh={mesh_shape(b['mesh_dp'])} batch={dp}")
