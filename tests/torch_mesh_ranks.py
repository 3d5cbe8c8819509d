"""The rank side of the port's mesh tests (tests/test_torch_parallel*.py):
one gloo world of CPU ranks, each a process of its own that imports no JAX.

    python tests/torch_mesh_ranks.py SUITE RANK N ADDRESS OUT

Every rank joins the world at ADDRESS (a ``file://`` store), runs SUITE
(``parallel``, ``models``, ``serving`` or ``train``) and rank 0 pickles its numpy
results to OUT, which the test module's fixture reads and holds against
the JAX package in the pytest process. :class:`World` starts the ranks;
its ``results()`` waits for them.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from torch_threads import TORCH_THREADS

HERE = Path(__file__).resolve().parent

# the inputs both sides draw (the JAX side in the pytest process)
DINO_HEADS, DINO_DIM = 4, 64
SAM_IMAGES = ((96, 128), (96, 128))


def dino_attention_params(seed: int = 3) -> dict:
    """DINOv2-named attention + MLP weights (tests/test_parallel.py:74-80)."""
    rng = np.random.default_rng(seed)
    d = DINO_DIM
    params = {}
    for n in ("attention.attention.query", "attention.attention.key", "attention.attention.value",
              "attention.output.dense"):
        params[f"{n}.weight"] = rng.standard_normal((d, d)).astype(np.float32) * 0.1
        params[f"{n}.bias"] = rng.standard_normal((d,)).astype(np.float32) * 0.1
    params["mlp.fc1.weight"] = rng.standard_normal((4 * d, d)).astype(np.float32) * 0.1
    params["mlp.fc1.bias"] = rng.standard_normal((4 * d,)).astype(np.float32) * 0.1
    params["mlp.fc2.weight"] = rng.standard_normal((d, 4 * d)).astype(np.float32) * 0.1
    params["mlp.fc2.bias"] = rng.standard_normal((d,)).astype(np.float32) * 0.1
    return params


def dino_input(seed: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((4, 10, DINO_DIM)).astype(np.float32)


def pipeline_inputs():
    """tests/test_parallel.py:375-378: 4 stages of a stacked linear + tanh."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 16, 16)).astype(np.float32) * 0.3
    b = rng.standard_normal((4, 16)).astype(np.float32)
    xs = rng.standard_normal((3, 5, 16)).astype(np.float32)
    return w, b, xs


def sam3_case():
    """The dry run's reduced SAM3 vision encoder (__graft_entry__.py:369-379)."""
    from vision_tpu_torch.models.random_weights import random_sam3_vision_params

    store = dict(random_sam3_vision_params(dim=64, layers=4))
    rng = np.random.default_rng(17)
    store["backbone.embeddings.patch_embeddings.projection.weight"] = (
        rng.standard_normal((64, 3, 4, 4)).astype(np.float32) * 0.05)
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    vp = dict(image_size=32, patch_size=4, window_size=4, n_layers=4, n_heads=4, global_attn_indexes=(1, 3))
    return store, x, vp


def sam3_scan_images(batch: int, seed: int = 3) -> np.ndarray:
    """Images of the reduced SAM3 (32 px, an 8x8 patch grid of 2x2 windows)."""
    return np.random.default_rng(seed + batch).random((batch, 32, 32, 3)).astype(np.float32)


SAM3_SCAN_MESHES = {"sp2tp2": (2, 2), "sp4": (1, 4)}  # key -> (tp, sp), 4 ranks each
# 4 windows an image: at batch 3 an sp rank's windows span two images (6 at sp 2, 3 at sp 4)
SAM3_SCAN_BATCHES = (1, 2, 3)
SAM3_PP_IMAGES = 3  # the JAX dry run's microbatches (__graft_entry__.py:429-441)
# a trunk whose global layers reach the flash route (1024 tokens: 128 px in
# patches of 4, 16 windows of 8x8)
SAM3_FLASH_VP = dict(image_size=128, patch_size=4, window_size=8, n_layers=4, n_heads=4, global_attn_indexes=(1, 3))


def clip_case(width: int = 64, layers: int = 2, vocab: int = 50, t: int = 8):
    """A small CLIP text encoder under SAM3's names (``te.text_model.*``;
    16 heads, as sam3.py's clip_attention has them), token ids and the
    tokenizer's causal 0 / -inf mask."""
    rng = np.random.default_rng(31)
    store = {}

    def lin(name, ci, co):
        store[f"{name}.weight"] = (rng.standard_normal((co, ci)) * ci**-0.5).astype(np.float32)
        store[f"{name}.bias"] = (rng.standard_normal(co) * 0.1).astype(np.float32)

    def ln(name):
        store[f"{name}.weight"] = (1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
        store[f"{name}.bias"] = (0.1 * rng.standard_normal(width)).astype(np.float32)

    base = "te.text_model"
    store[f"{base}.embeddings.token_embedding.weight"] = rng.standard_normal((vocab, width)).astype(np.float32)
    store[f"{base}.embeddings.position_embedding.weight"] = rng.standard_normal((t, width)).astype(np.float32)
    for i in range(layers):
        layer = f"{base}.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{layer}.self_attn.{proj}", width, width)
        lin(f"{layer}.mlp.fc1", width, 4 * width)
        lin(f"{layer}.mlp.fc2", 4 * width, width)
        ln(f"{layer}.layer_norm1")
        ln(f"{layer}.layer_norm2")
    ln(f"{base}.final_layer_norm")
    ids = rng.integers(0, vocab, (2, t)).astype(np.int32)
    mask = np.triu(np.full((t, t), -np.inf, np.float32), 1)
    return store, ids, mask, layers


def sam_images():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (h, w, 4), np.uint8) for h, w in SAM_IMAGES]


def depthany_case():
    from vision_tpu_torch.models.random_weights import random_depth_anything_params

    rng = np.random.default_rng(23)
    return random_depth_anything_params("test"), [rng.integers(0, 255, (126, 140, 4), np.uint8) for _ in range(4)]


def migan_case():
    from vision_tpu_torch.models.random_weights import random_migan_params

    rng = np.random.default_rng(24)
    mask = (rng.random((64, 64, 1)) > 0.5).astype(np.uint8) * 255
    return random_migan_params(64, 2), [rng.integers(0, 255, (64, 64, 4), np.uint8) for _ in range(4)], mask


def yolo_case():
    from vision_tpu_torch.models.random_weights import random_yolov9t_params

    rng = np.random.default_rng(25)
    return random_yolov9t_params(), [rng.integers(0, 255, (120, 160, 3), np.uint8) for _ in range(4)]


def birefnet_case():
    from vision_tpu_torch.models.random_weights import random_birefnet_params

    rng = np.random.default_rng(9)
    return random_birefnet_params("tiny"), [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8) for _ in range(2)]


def esrgan_case():
    from vision_tpu_torch.models.random_weights import random_esrgan_params

    return (random_esrgan_params(seed=1, nf=8, nb=1, gc=4),
            np.random.default_rng(3).integers(0, 256, (40, 56, 3)).astype(np.uint8))


# -- the training meshes' problems (tests/test_train.py, test_lora.py) --

TRAIN_LR = 5e-2  # tests/test_torch_train.py LR
RECIPE_LR = 1e-3
RECIPE_STEPS = 2
RECIPE_BATCH = 4  # one row a rank of the recipes' dp-4 mesh
SAM_EXPORT_SIZE = 512  # tests/test_export.py:248-265's TinyViT geometry
SAM_EXPORT_LAYERS = ((128, 64, 2, 2, 7, True), (64, 128, 2, 4, 7, True), (32, 160, 6, 5, 14, True),
                     (32, 320, 2, 10, 7, False))


def sam_export_frames() -> np.ndarray:
    """tests/test_export.py:292-293's two frames, stacked."""
    rng = np.random.default_rng(11)
    return np.stack([rng.integers(0, 256, (SAM_EXPORT_SIZE,) * 2 + (3,)).astype(np.uint8) for _ in range(2)])


def train_problem(seed: int = 0):
    """tests/test_train.py:28-37: a linear head and an int buffer."""
    rng = np.random.default_rng(seed)
    params = {
        "head.w.weight": (rng.normal(size=(4, 8)) * 0.1).astype(np.float32),
        "head.w.bias": np.zeros(4, np.float32),
        "buf.count": np.array([1, 2, 3], np.int32),
    }
    w_true = rng.normal(size=(4, 8)).astype(np.float32)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    return params, (x, x @ w_true.T)


def fsdp_problem():
    """tests/test_train.py:155-163: a (512, 130) table fsdp shards and a head."""
    rng = np.random.default_rng(0)
    params = {
        "big.table": (rng.normal(size=(512, 130)) * 0.02).astype(np.float32),
        "head.w.weight": (rng.normal(size=(4, 8)) * 0.1).astype(np.float32),
    }
    return params, (rng.normal(size=(16, 8)).astype(np.float32), rng.normal(size=(16, 4)).astype(np.float32))


def lora_problem():
    """tests/test_lora.py:32-41 and :274-277."""
    rng = np.random.default_rng(0)
    base = {
        "enc.fc1.weight": (rng.normal(size=(24, 16)) * 0.2).astype(np.float32),
        "enc.fc1.bias": (rng.normal(size=(24,)) * 0.1).astype(np.float32),
        "enc.fc2.weight": (rng.normal(size=(8, 24)) * 0.2).astype(np.float32),
        "enc.norm.weight": np.ones(16, np.float32),
        "enc.conv.weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
        "buf.idx": np.arange(3, dtype=np.int32),
    }
    rng = np.random.default_rng(8)
    return base, (rng.normal(size=(16, 16)).astype(np.float32), rng.normal(size=(16, 8)).astype(np.float32))


def dino_train_batch() -> np.ndarray:
    """The dry run's step-5 batch (__graft_entry__.py:142), 4 rows."""
    return np.random.default_rng(1).random((4, 56, 56, 3)).astype(np.float32)


DINO_LOSS_CHANNELS = 16  # the first features of the last layer: a loss the final layer norm does not make constant


# -- the suites (every rank runs them; rank 0's dict is the result) --


def _error(fn) -> str | None:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the message is the result
        return f"{type(e).__name__}: {e}"
    return None


def suite_parallel(rank: int, n: int) -> dict:
    import torch
    import torch.distributed as dist

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models.birefnet import swin_heads
    from vision_tpu_torch.models.random_weights import random_depth_anything_params
    from vision_tpu_torch.models.dino import self_attention
    from vision_tpu_torch.models.mobile_sam import TinyVitParams, tiny_vit_heads
    from vision_tpu_torch.models.random_weights import random_birefnet_params, random_mobile_sam_params
    from vision_tpu_torch.models.sam3 import Sam3VitParams, sam3_heads
    from vision_tpu_torch.models.swin import SWIN_T_PARAMS
    from vision_tpu_torch.ops import nn
    from vision_tpu_torch.parallel import (
        SAM3_TP_RULES,
        init_distributed,
        make_mesh,
        pipeline_apply,
        shard_params,
        sharded_forward,
        stage_sharding,
        training_step,
    )
    from vision_tpu_torch.parallel.sharding import mesh_shape
    from vision_tpu_torch.parallel.tp import tp_dim, ungroup_qkv
    from vision_tpu_torch.serve import _resolve_batch

    r: dict = {}
    init_distributed("tcp://localhost:1", 99, 7, device="cpu")  # idempotent: a live group stays as it is
    r["world_after_second_init"] = dist.get_world_size()
    cases = {"4,tp2": (4, 2, 1, 1), "4": (4, 1, 1, 1), "4,tp2,sp2": (4, 2, 2, 1), "4,pp2,tp2": (4, 2, 1, 2),
             "2": (2, 1, 1, 1), "4,tp4": (4, 4, 1, 1)}
    r["mesh_shapes"] = {k: mesh_shape(make_mesh(m, tp=t, sp=s, pp=p, device="cpu")) for k, (m, t, s, p) in cases.items()}
    r["mesh_errors"] = {
        "4,tp3": _error(lambda: make_mesh(4, tp=3, device="cpu")),
        "8": _error(lambda: make_mesh(8, device="cpu")),
        "0": _error(lambda: make_mesh(0, device="cpu")),
        "4,tp0": _error(lambda: make_mesh(4, tp=0, device="cpu")),
    }
    # what the serving meshes refuse: a served model on a mesh with sp or pp
    # (SAM3 alone takes them), a meshed export, a CUDA model on a CPU mesh
    from vision_tpu_torch.core.device import BackendType, Device, backend_init
    from vision_tpu_torch.export import export_model
    from vision_tpu_torch.models.depth_anything import DepthAnythingModel, DepthAnythingParams
    from vision_tpu_torch.models.dino import DinoParams

    cpu = backend_init("cpu")
    da_p = DepthAnythingParams(dino=DinoParams(embed_dim=64, n_heads=2, n_layers=4), image_size=126,
                               feature_layers=(0, 1, 2, 3))
    da_store = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in random_depth_anything_params("test").items()}
    r["refusals"] = {
        "served sp": _error(lambda: DepthAnythingModel(da_store, da_p, cpu, mesh=make_mesh(4, sp=2, device="cpu"))),
        "cuda model": _error(lambda: DepthAnythingModel(da_store, da_p, Device(torch.device("cuda"), BackendType.gpu),
                                                        mesh=make_mesh(4, device="cpu"))),
    }
    meshed = DepthAnythingModel(da_store, da_p, cpu, mesh=make_mesh(4, tp=2, device="cpu"))
    r["refusals"]["export"] = _error(lambda: export_model(meshed, "never.vxp"))
    sub = make_mesh(2, device="cpu").get_coordinate() is not None
    flags = [torch.zeros(1) for _ in range(n)]
    dist.all_gather(flags, torch.tensor([float(sub)]))
    r["in_sub_mesh"] = [bool(f.item()) for f in flags]

    # placements of every family that tp-shards, at tp 2 and 4
    stores = {
        "sam": (random_mobile_sam_params(0), None, tiny_vit_heads(TinyVitParams()), "per_head"),
        "birefnet": ({k: v for k, v in random_birefnet_params("tiny", 0).items()}, None, swin_heads(SWIN_T_PARAMS),
                     "global"),
    }
    sam3_store, _, vp = sam3_case()
    stores["sam3"] = (sam3_store, SAM3_TP_RULES, sam3_heads(Sam3VitParams(**vp)), "global")
    from vision_tpu_torch.models.random_weights import random_depth_anything_params

    stores["depthany"] = (random_depth_anything_params("test"), None, lambda name: 2 if ".attention." in name else None,
                          "global")
    r["placements"] = {}
    r["regroup_ok"] = {}
    for tp in (2, 4):
        mesh = make_mesh(4, tp=tp, device="cpu")
        for fam, (store, rules, heads, layout) in stores.items():
            kw = {"heads": heads, "qkv_layout": layout}
            if rules is not None:
                kw["rules"] = rules
            t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in store.items()}
            sharded = shard_params(t, mesh, **kw)
            r["placements"][(fam, tp)] = {k: tp_dim(v) for k, v in sharded.items()}
            # the local shards put back together (and un-regrouped) are the weights
            ok = True
            group = mesh.get_group("tp")
            for k, v in sharded.items():
                d = tp_dim(v)
                if d is None:
                    ok &= torch.equal(v.to_local(), t[k])
                    continue
                parts = [torch.empty_like(v.to_local()) for _ in range(tp)]
                dist.all_gather(parts, v.to_local().contiguous(), group=group)
                whole = torch.cat(parts, d)
                if layout == "global" and k.endswith(("qkv.weight", "qkv.bias")):
                    whole = ungroup_qkv(whole, tp)
                ok &= torch.equal(whole, t[k])
            r["regroup_ok"][(fam, tp)] = bool(ok)

    mesh = make_mesh(4, device="cpu")
    r["resolve"] = {
        "none,6": _resolve_batch(None, 6, mesh), "none,8": _resolve_batch(None, 8, mesh),
        "8,6": _resolve_batch(8, 6, mesh), "none,6,nomesh": _resolve_batch(None, 6, None),
        "4,6,nomesh": _resolve_batch(4, 6, None),
        "6,6": _error(lambda: _resolve_batch(6, 6, mesh)), "0,6": _error(lambda: _resolve_batch(0, 6, None)),
    }

    w, b, xs = (torch.from_numpy(a) for a in pipeline_inputs())
    stage = lambda ws, x: torch.tanh(x @ ws["w"] + ws["b"])  # noqa: E731
    r["pipeline"] = {}
    for key, (tp, pp) in {"pp4": (1, 4), "pp2,tp2": (2, 2)}.items():
        pmesh = make_mesh(4, tp=tp, pp=pp, device="cpu")
        if pp == 4:
            weights = {"w": w, "b": b}
        else:  # two stages of two layers each, the caller grouping them
            weights = {"w": w.reshape(2, 2, 16, 16), "b": b.reshape(2, 2, 16)}
            stage = lambda ws, x: torch.tanh(torch.tanh(x @ ws["w"][0] + ws["b"][0]) @ ws["w"][1] + ws["b"][1])  # noqa: E731
        r["pipeline"][key] = pipeline_apply(stage, weights, xs, pmesh).numpy()
    pmesh = make_mesh(4, pp=4, device="cpu")
    from torch.distributed.tensor import DTensor

    placed = {k: DTensor.from_local(v.chunk(4)[pmesh.get_local_rank("pp")], pmesh, stage_sharding(pmesh),
                                    run_check=False) for k, v in {"w": w, "b": b}.items()}
    stage = lambda ws, x: torch.tanh(x @ ws["w"] + ws["b"])  # noqa: E731
    r["pipeline"]["pp4,placed"] = pipeline_apply(stage, placed, xs, pmesh).numpy()
    r["pipeline_errors"] = {
        "axis": _error(lambda: pipeline_apply(stage, {"w": w, "b": b}, xs, pmesh, axis="xx")),
        "stages": _error(lambda: pipeline_apply(stage, {"w": w[:3], "b": b}, xs, pmesh)),
        "empty": _error(lambda: pipeline_apply(stage, {"w": w, "b": b}, xs[:0], pmesh)),
    }

    # sharded_forward and training_step over dp 2 x tp 2
    mesh = make_mesh(4, tp=2, device="cpu")
    params = {k: torch.from_numpy(v) for k, v in dino_attention_params().items()}
    x = torch.from_numpy(dino_input())

    def block(weights, xx):
        p = Params(weights)
        y = xx + self_attention(p["attention"], xx, DINO_HEADS, flash=False)
        return y + nn.linear(p["mlp.fc2"], nn.gelu(nn.linear(p["mlp.fc1"], y)))

    sharded = shard_params(params, mesh)
    r["sharded_specs"] = {k: tp_dim(v) for k, v in sharded.items()}
    r["sharded_forward"] = sharded_forward(block, mesh)(sharded, x).numpy()
    step = training_step(lambda weights, batch: torch.mean(block(weights, batch) ** 2), mesh, lr=0.1)
    loss, new = step(sharded, x)
    r["train_loss"] = float(loss)
    r["train_params"] = {k: v.full_tensor().numpy() for k, v in new.items()}
    return r


def _flaky(rank: int):
    """An entry that raises on the ranks in ``fail_on`` and doubles its shard elsewhere."""
    from vision_tpu_torch.core.errors import raise_error

    def fn(t, fail_on=()):
        if rank in fail_on:
            raise_error("rank {} refuses this batch", rank)
        return t * 2

    return fn


def _models(rank: int, build, drive) -> dict:
    """Build the meshed models on every rank (one order), then rank 0
    drives them while the others follow."""
    from vision_tpu_torch.parallel.runner import follow, stop_workers

    r: dict = {}
    built = build(r)
    if rank != 0:
        try:
            follow()
        except Exception:  # noqa: BLE001 — after a rank died on purpose the others lose their peer
            traceback.print_exc()
        return r
    try:
        drive(built, r)
    finally:
        if "dead_call" not in r:
            stop_workers()
    return r


def _put(store):
    import torch

    from vision_tpu_torch.core.weights import params_from_numpy

    return params_from_numpy(store, "cpu", torch.float32)


def suite_models(rank: int, n: int) -> dict:
    """The tensor-parallel families: SAM3's trunk (in lock step), then
    MobileSAM, BiRefNet and Depth-Anything meshed, and a rank that dies."""
    import torch

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.image import Image, ImageFormat, image_load_array
    from vision_tpu_torch.models.birefnet import BirefnetModel, BirefnetParams
    from vision_tpu_torch.models.depth_anything import DepthAnythingModel, DepthAnythingParams
    from vision_tpu_torch.models.dino import DinoParams
    from vision_tpu_torch.models.mobile_sam import SamModel, SamParams
    from vision_tpu_torch.models.random_weights import random_mobile_sam_params
    import torch.distributed as dist

    from vision_tpu_torch.models.sam3 import (ClipTokenizer, Sam3Model, Sam3VitParams, encode_text, encode_vision,
                                              sam3_heads)
    from vision_tpu_torch.models.swin import SWIN_T_PARAMS
    from vision_tpu_torch.parallel import SAM3_TP_RULES, make_mesh
    from vision_tpu_torch.parallel.runner import MeshEntry, register_model
    from vision_tpu_torch.parallel.sharding import mesh_params
    from vision_tpu_torch.serve import ImageServer, SamServer

    dev = backend_init("cpu")
    rgba = lambda a: Image(a, ImageFormat.rgba_u8)  # noqa: E731

    def build(r):
        # SAM3's trunk + neck at tp 2 (dp 2 x tp 2) and tp 4, every rank in lock step
        store, x, vp = sam3_case()
        vp = Sam3VitParams(**vp)
        for tp in (2, 4):
            mesh = make_mesh(4, tp=tp, device="cpu")
            local = mesh_params(_put(store), mesh, dev, SAM3_TP_RULES, heads=sam3_heads(vp))
            with torch.inference_mode():
                r[f"sam3_tp{tp}"] = [f.numpy() for f in encode_vision(Params(local), torch.from_numpy(x),
                                                                      vp).fpn_hidden_states]
        _sam3_scan(r, dev, vp)
        # SAM3's CLIP text encoder at tp 2 and 4: q/k/v sharded, out_proj whole (the heads gathered before it)
        store, ids, mask, layers = clip_case()
        for tp in (2, 4):
            mesh = make_mesh(4, tp=tp, device="cpu")
            local = mesh_params(_put(store), mesh, dev, SAM3_TP_RULES, heads=sam3_heads(vp))
            with torch.inference_mode():
                r[f"clip_tp{tp}"] = encode_text(Params(local), torch.from_numpy(ids), torch.from_numpy(mask),
                                                n_layers=layers).numpy()
        mesh_22 = make_mesh(4, tp=2, device="cpu")
        b = {"sam": SamModel(_put(random_mobile_sam_params(0)), SamParams(), dev, mesh=mesh_22)}
        bp = BirefnetParams(image_size=64, image_extent=(64, 64), encoder=SWIN_T_PARAMS)
        b["bir"] = BirefnetModel(_put(birefnet_case()[0]), bp, dev, mesh=mesh_22)
        dap = DepthAnythingParams(dino=DinoParams(embed_dim=64, n_heads=2, n_layers=4), image_size=126,
                                  feature_layers=(0, 1, 2, 3))
        b["da"] = DepthAnythingModel(_put(depthany_case()[0]), dap, dev, mesh=mesh_22)
        b["da2"] = DepthAnythingModel(_put(depthany_case()[0]), dap, dev, mesh=make_mesh(2, tp=2, device="cpu"))
        # Sam3Model on an sp 2 x tp 2 mesh: rank 0's encode_vision runs the sequence-parallel trunk on every rank
        b["sam3"] = Sam3Model(_put({f"det.ve.{k}": v for k, v in sam3_case()[0].items()}),
                              ClipTokenizer(vocab={}, bpe_rank={}), 8, dev, vp=vp,
                              mesh=make_mesh(4, tp=2, sp=2, device="cpu"))
        # an entry that raises on every rank of a dp 2 x tp 2 mesh: that call fails, the world serves on
        b["tp_flaky"] = MeshEntry(register_model(), "tp_flaky", _flaky(rank), mesh_22, dev.torch_device)
        # a last model whose entry ends rank 3 mid-call: rank 0 must fail, not hang
        b["dying"] = MeshEntry(register_model(), "die", lambda t: os._exit(3) if rank == 3 else t,
                               make_mesh(4, device="cpu"), dev.torch_device)
        return b

    def drive(b, r):
        r["tp_model_error"] = _error(lambda: b["tp_flaky"](torch.ones(4, 2), fail_on=(0, 1, 2, 3)))
        counts: dict = {}
        with _collectives(dist, counts):
            r["sam3_model_sp"] = [f.numpy() for f in b["sam3"].encode_vision(Image(sam3_model_image(),
                                                                                   ImageFormat.rgba_u8))]
        r["sam3_model_sp_gathers"] = counts.get("all_gather_into_tensor", 0)
        t0 = time.monotonic()
        sam_imgs = [image_load_array(a[..., :3].copy()) for a in sam_images()]
        r["sam_encode"] = b["sam"].encode_batch(sam_imgs).numpy()
        with SamServer(b["sam"], batch_size=2, max_delay_ms=10_000) as srv:
            futs = [srv.submit(rgba(a), point=(40 + 20 * i, 30)) for i, a in enumerate(sam_images())]
            r["sam_server"] = [f.result(timeout=300).data for f in futs]
        r["sam_server_batch"] = srv.batch_size
        _, bir_imgs = birefnet_case()
        r["birefnet"] = [m.data for m in b["bir"].compute_batch([image_load_array(a) for a in bir_imgs])]
        r["birefnet_raw"] = b["bir"].forward_u8(torch.from_numpy(np.stack(bir_imgs))).numpy()
        _, da_imgs = depthany_case()
        with ImageServer(b["da"], batch_size=None, max_delay_ms=10_000) as srv:
            r["depthany_batch"] = srv.batch_size
            r["depthany"] = [f.result(timeout=300).data for f in [srv.submit(rgba(a)) for a in da_imgs[:2]]]
        with ImageServer(b["da2"], batch_size=2, max_delay_ms=10_000) as srv:
            r["depthany_tp2"] = [f.result(timeout=300).data for f in [srv.submit(rgba(a)) for a in da_imgs[:2]]]
        x = torch.from_numpy(np.stack([a[:, :126, :3] for a in da_imgs]))
        r["depthany_raw"] = b["da"].forward_u8(x).numpy()
        r["seconds_served"] = time.monotonic() - t0
        # the dead rank: the call that loses it raises, and a server's
        # futures fail after it (never hang)
        t1 = time.monotonic()
        r["dead_call"] = _error(lambda: b["dying"](torch.zeros(4, 2)))
        with ImageServer(b["da"], batch_size=None, max_delay_ms=5) as srv:
            r["dead_future"] = _error(lambda: srv.submit(rgba(da_imgs[0])).result(timeout=120))
        r["dead_seconds"] = time.monotonic() - t1

    return _models(rank, build, drive)


def sam3_model_image() -> np.ndarray:
    return np.random.default_rng(41).integers(0, 256, (40, 48, 4), np.uint8)


def _sam3_scan(r: dict, dev, vp) -> None:
    """SAM3's window-major trunk on every rank in lock step: sequence-
    parallel at sp 2 x tp 2 and sp 4 (batch 1, 2 and 3; the K/V
    all-gathers counted), the pipeline trunk at pp 2 x tp 2 (3 images, from stage
    weights and from the whole stack; each rank's local stage-weight
    shapes), the refusals, and the sp trunk's flash route against the
    unmeshed one at 1024 tokens."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models.sam3 import (
        Sam3VitParams,
        encode_vision,
        encode_vision_pipelined,
        sam3_pack_vision_weights,
        sam3_pipeline_weights,
        sam3_shard_vision,
    )
    from vision_tpu_torch.ops.cuda import flash_attention as fa
    from vision_tpu_torch.parallel import make_mesh

    store = sam3_case()[0]
    p = _put(store)
    stack = sam3_pack_vision_weights(p, vp, prefix="backbone.")

    def fpn(out):
        return [f.numpy() for f in out.fpn_hidden_states]

    r["sam3_gathers"] = {}
    for key, (tp, sp) in SAM3_SCAN_MESHES.items():
        mesh = make_mesh(4, tp=tp, sp=sp, device="cpu")
        flat, placed = sam3_shard_vision(p, stack, mesh, vp)
        for batch in SAM3_SCAN_BATCHES:
            counts: dict = {}
            with torch.inference_mode(), _collectives(dist, counts):
                r[f"sam3_{key}_b{batch}"] = fpn(encode_vision(Params(flat), torch.from_numpy(sam3_scan_images(batch)),
                                                              vp, win_stack=placed, mesh=mesh))
            r["sam3_gathers"][(key, batch)] = counts.get("all_gather_into_tensor", 0)
    x = torch.from_numpy(sam3_scan_images(1))
    mesh = make_mesh(4, sp=4, device="cpu")
    r["sam3_sp_no_scan"] = _error(lambda: encode_vision(Params(p), x, vp, mesh=mesh))
    mesh3 = make_mesh(3, sp=3, device="cpu")  # 4 windows over sp 3; rank 3 is outside the mesh
    if mesh3.get_coordinate() is not None:
        r["sam3_sp3"] = _error(lambda: encode_vision(Params(p), x, vp, win_stack=stack, mesh=mesh3))

    mesh = make_mesh(4, pp=2, tp=2, device="cpu")
    imgs = torch.from_numpy(sam3_scan_images(SAM3_PP_IMAGES))
    stage_w = sam3_pipeline_weights(Params(p)["backbone"], stack, vp, mesh)
    from_flat = sam3_pipeline_weights(Params(p)["backbone"], None, vp, mesh)
    with torch.inference_mode():
        r["sam3_pp_stage"] = fpn(encode_vision_pipelined(Params(p), imgs, vp, stage_weights=stage_w, mesh=mesh))
        r["sam3_pp_stack"] = fpn(encode_vision_pipelined(Params(p), imgs, vp, win_stack=stack, mesh=mesh))
        r["sam3_pp_flat"] = fpn(encode_vision_pipelined(Params(p), imgs, vp, stage_weights=from_flat, mesh=mesh))
    mine = {(part, leaf): (tuple(v.shape), tuple(v.to_local().shape),
                           bool(torch.equal(v.to_local(), from_flat[part][leaf].to_local())))
            for part, leaves in stage_w.items() for leaf, v in leaves.items()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.get_local_rank("pp"), mine))
    r["sam3_pp_local"] = every
    flat_vp = dataclasses.replace(vp, global_attn_indexes=(1, 2))  # win glb glb win: not uniform
    r["sam3_pp_errors"] = {
        "uniform": _error(lambda: encode_vision_pipelined(Params(p), imgs, flat_vp, win_stack=stack, mesh=mesh)),
        "stages": _error(lambda: encode_vision_pipelined(Params(p), imgs, vp, win_stack=stack,
                                                         mesh=make_mesh(4, pp=4, device="cpu"))),
    }

    # the sp trunk's global layers on the flash route (the kernel's plain version on the CPU) at 1024 tokens
    fvp = Sam3VitParams(**SAM3_FLASH_VP)
    xf = torch.from_numpy(np.random.default_rng(9).random((1, 128, 128, 3)).astype(np.float32))
    mesh = make_mesh(4, tp=2, sp=2, device="cpu")
    fstack = sam3_pack_vision_weights(p, fvp, prefix="backbone.")
    flat, placed = sam3_shard_vision(p, fstack, mesh, fvp)
    kernel, calls = fa.flash_attention, []

    def counted(q, k, v, **kw):  # the kernel's entry point: its plain version on CPU tensors
        calls.append((tuple(q.shape), tuple(k.shape)))
        return kernel(q, k, v, **kw)

    fa.flash_attention = counted
    try:
        with torch.inference_mode():
            r["sam3_sp_flash"] = fpn(encode_vision(Params(flat), xf, fvp, flash=True, win_stack=placed, mesh=mesh))
    finally:
        fa.flash_attention = kernel
    r["sam3_sp_flash_calls"] = calls
    with torch.inference_mode():
        r["sam3_flash_ref"] = fpn(encode_vision(Params(p), xf, fvp, flash=True, win_stack=fstack))
        r["sam3_einsum_ref"] = fpn(encode_vision(Params(p), xf, fvp, win_stack=fstack))


def suite_serving(rank: int, n: int) -> dict:
    """The dp-only families: Real-ESRGAN's tiled path, MI-GAN and YOLOv9t
    through their servers, at dp 4 (and dp 2 on ranks 0-1)."""
    import torch

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.image import Image, ImageFormat, image_load_array
    from vision_tpu_torch.models.esrgan import EsrganModel, EsrganParams
    from vision_tpu_torch.models.migan import MiganModel, MiganParams
    from vision_tpu_torch.models.yolov9t import Yolov9tModel, Yolov9tParams
    from vision_tpu_torch.parallel import make_mesh
    from vision_tpu_torch.parallel.runner import MeshEntry, register_model
    from vision_tpu_torch.serve import ImageServer, YoloServer

    dev = backend_init("cpu")
    rgba = lambda a: Image(a, ImageFormat.rgba_u8)  # noqa: E731
    yp = Yolov9tParams(input_size=160)

    def build(r):
        mesh_4, mesh_2 = make_mesh(4, device="cpu"), make_mesh(2, device="cpu")
        esr_store = esrgan_case()[0]
        mg_store = migan_case()[0]
        return {
            "esr": EsrganModel(_put(esr_store), EsrganParams(4, 1), dev, mesh=mesh_4),
            "esr2": EsrganModel(_put(esr_store), EsrganParams(4, 1), dev, mesh=mesh_2),
            "mg": MiganModel(_put(mg_store), MiganParams(resolution=64), dev, mesh=mesh_4),
            "mg2": MiganModel(_put(mg_store), MiganParams(resolution=64), dev, mesh=mesh_2),
            "yl": Yolov9tModel(_put(yolo_case()[0]), yp, dev, mesh=mesh_4),
            "flaky": MeshEntry(register_model(), "flaky", _flaky(rank), mesh_4, dev.torch_device),
        }

    def drive(b, r):
        # an entry that raises on one rank fails that call alone; every call after it is served
        r["model_error_rank1"] = _error(lambda: b["flaky"](torch.ones(4, 2), fail_on=(1,)))
        r["model_error_rank0"] = _error(lambda: b["flaky"](torch.ones(4, 2), fail_on=(0,)))
        r["after_model_errors"] = b["flaky"](torch.arange(8.0).reshape(4, 2)).numpy()
        _, esr_img = esrgan_case()
        r["esrgan_tiled"] = b["esr"].compute(image_load_array(esr_img), tile_size=32, batch=4).data
        r["esrgan_tiled_dp2"] = b["esr2"].compute(image_load_array(esr_img), tile_size=32, batch=2).data
        r["esrgan_batch_error"] = _error(lambda: b["esr"].compute(image_load_array(esr_img), tile_size=32, batch=2))
        _, mg_imgs, mg_mask = migan_case()
        mask = Image(mg_mask, ImageFormat.alpha_u8)
        with ImageServer(b["mg"], batch_size=4, max_delay_ms=10_000) as srv:
            r["migan"] = [f.result(timeout=300).data for f in [srv.submit((rgba(a), mask)) for a in mg_imgs]]
            r["migan_batches"] = srv.stats.batches
        with ImageServer(b["mg2"], batch_size=2, max_delay_ms=10_000) as srv:
            r["migan_dp2"] = [f.result(timeout=300).data for f in [srv.submit((rgba(a), mask)) for a in mg_imgs[:2]]]
        xs = torch.from_numpy(np.stack([a[..., :3] for a in mg_imgs]))
        ms = torch.from_numpy(np.stack([mg_mask] * 4))
        r["migan_raw"] = b["mg"].forward_u8(xs, ms).numpy()
        r["migan_raw_dp2"] = b["mg2"].forward_u8(xs[:2], ms[:2]).numpy()
        _, yl_imgs = yolo_case()
        n_anchors = sum((yp.input_size // st) ** 2 for st in (8, 16, 32))
        with YoloServer(b["yl"], batch_size=4, max_delay_ms=10_000, conf_thres=0.001, max_candidates=n_anchors) as srv:
            dets = [f.result(timeout=300) for f in [srv.submit(Image(a, ImageFormat.rgb_u8)) for a in yl_imgs]]
        r["yolo"] = [[(d.class_id, d.confidence, d.x1, d.y1, d.x2, d.y2) for d in ds] for ds in dets]
        x = torch.from_numpy(np.stack([np.pad(a, ((20, 20), (0, 0), (0, 0))) for a in yl_imgs]))
        r["yolo_raw"] = [t.numpy() for t in b["yl"].forward_u8(x)]

    return _models(rank, build, drive)


def _train_losses():
    import torch

    def linear_loss(p, batch):  # tests/test_train.py:40-43
        x, y = batch
        return torch.mean((x @ p["head.w.weight"].T + p["head.w.bias"] - y) ** 2)

    def fsdp_loss(p, batch):  # tests/test_train.py:165-169, through Params, the table looked up twice
        from vision_tpu_torch.core.params import Params

        pp, (x, y) = Params(p), batch
        table = 0.5 * (pp.weight("big.table") + pp.weight("big.table"))
        return torch.mean((x @ pp.weight("head.w.weight").T - y) ** 2) + 1e-3 * torch.mean(table**2)

    def lora_loss(p, batch):  # tests/test_lora.py:44-47, 279-281
        from vision_tpu_torch.core.params import Params
        from vision_tpu_torch.ops.nn import linear

        x, y = batch
        h = torch.relu(linear(Params(p)["enc"]["fc1"], x))
        return torch.mean((linear(Params(p)["enc"]["fc2"], h) - y) ** 2)

    return linear_loss, fsdp_loss, lora_loss


def _copy(params: dict) -> dict:
    """A store the state may take over (create_train_state updates what it
    is given in place)."""
    return {k: v.clone() if hasattr(v, "clone") else np.array(v) for k, v in params.items()}


def _np_params(params) -> dict:
    from vision_tpu_torch import train

    return {k: v.detach().float().numpy() for k, v in train.full_params(params).items() if hasattr(v, "detach")}


def _collectives(dist, counts: dict):
    """Count the calls of torch.distributed's all-gathers into a tensor and
    reduce-scatters (the fsdp gather's two) into ``counts`` while the block
    runs."""
    import contextlib

    @contextlib.contextmanager
    def counting():
        names = ("all_gather_into_tensor", "reduce_scatter_tensor")
        orig = {name: getattr(dist, name) for name in names}

        def counted(name):
            def call(*a, **k):
                counts[name] = counts.get(name, 0) + 1
                return orig[name](*a, **k)
            return call

        for name in names:
            setattr(dist, name, counted(name))
        try:
            yield counts
        finally:
            for name in names:
                setattr(dist, name, orig[name])

    return counting()


def suite_train(rank: int, n: int) -> dict:
    """The training meshes on dp 4 x tp 2 (every rank in lock step): the
    fsdp step, mesh parity and a sharded restore, prefetch placements and
    the accumulated step, LoRA on dp 8, a DINOv2 SGD step over dp x tp;
    then the three recipes on a dp-4 mesh (ranks 0-3) against each run on
    one rank alone (ranks 4-6, meanwhile), and the meshed SAM export on a
    dp-2 mesh (ranks 0-1)."""
    import functools

    import torch
    import torch.distributed as dist

    from vision_tpu_torch import train
    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.parallel import make_mesh
    from vision_tpu_torch.parallel.dryrun import TRAIN_RULES_EXTRA, train_case
    from vision_tpu_torch.parallel.sharding import DEFAULT_TP_RULES
    from vision_tpu_torch.parallel.tp import is_fsdp

    linear_loss, fsdp_loss, lora_loss = _train_losses()
    r: dict = {}
    t = lambda batch: tuple(torch.from_numpy(np.array(b)) for b in batch)  # noqa: E731
    mesh = make_mesh(8, tp=2, device="cpu")
    mesh_dp8 = make_mesh(8, device="cpu")
    mesh_dp4 = make_mesh(4, device="cpu")
    mesh_dp2 = make_mesh(2, device="cpu")

    # the fsdp step (tests/test_train.py:149)
    params, batch = fsdp_problem()
    st = train.create_train_state(_copy(params), train.adam(1e-2), mesh=mesh, fsdp=True, fsdp_min_size=1024)
    ref = train.create_train_state(_copy(params), train.adam(1e-2))
    step, ref_step = train.make_train_step(fsdp_loss, mesh=mesh), train.make_train_step(fsdp_loss)
    r["fsdp_loss"], r["fsdp_collectives"] = [], {}
    for i in range(2):
        with _collectives(dist, r["fsdp_collectives"] if i == 0 else {}):
            st, m = step(st, t(batch))
        ref, rm = ref_step(ref, t(batch))
        r["fsdp_loss"].append((float(m["loss"]), float(rm["loss"])))
    r["fsdp_placements"] = {k: [str(p) for p in v.placements] for k, v in st.params.items()}
    r["fsdp_local"] = tuple(st.params["big.table"].to_local().shape)
    slots = st.optimizer.state_dict()["state"].values()
    r["fsdp_slots"] = {k: tuple(s["exp_avg"].shape) for k, s in zip(st.names, slots)}
    r["fsdp_params"], r["fsdp_ref"] = _np_params(st.params), _np_params(ref.params)

    # mesh parity and a sharded restore (tests/test_train.py:378)
    params, batch = train_problem()
    ms = train.create_train_state(_copy(params), train.adam(TRAIN_LR), mesh=mesh)
    mstep = train.make_train_step(linear_loss, mesh=mesh)
    r["parity_loss"] = []
    for _ in range(2):
        ms, mm = mstep(ms, t(batch))
        r["parity_loss"].append(float(mm["loss"]))
    r["parity_params"] = _np_params(ms.params)
    path = train.save_checkpoint(os.path.join(os.getcwd(), "ck", "step_2"), ms)
    fresh = train.create_train_state(_copy(params), train.adam(TRAIN_LR), mesh=mesh)
    restored = train.restore_checkpoint(path, fresh)
    r["restore_placements"] = all(restored.params[k].placements == ms.params[k].placements for k in ms.names)
    r["restore_equal"] = all(torch.equal(restored.params[k].to_local(), ms.params[k].to_local()) for k in ms.names)
    a, b = ms.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    r["restore_slots_equal"] = all(torch.equal(a[i][key], b[i][key]) for i in a for key in a[i])
    r["restore_buffer"] = restored.params["buf.count"].to_local().tolist()
    stepped, _ = mstep(restored, t(batch))
    r["restore_step"] = stepped.step

    # prefetch placements and the accumulated mesh step (tests/test_train.py:289, 305)
    out = list(train.prefetch_to_device(iter([(np.zeros((8, 2), np.float32),)] * 3), size=2, mesh=mesh))
    r["prefetch"] = (len(out), [str(p) for p in out[0][0].placements], tuple(out[0][0].to_local().shape))
    out = list(train.prefetch_to_device(iter([(np.zeros((3, 4, 8), np.float32),)] * 2), mesh=mesh, accum=3))
    r["prefetch_accum"] = ([str(p) for p in out[0][0].placements], tuple(out[0][0].to_local().shape))
    r["prefetch_bad"] = _error(lambda: next(train.prefetch_to_device(iter([(np.zeros((3, 4, 8)),)]), mesh=mesh,
                                                                    accum=0)))
    params, (x, y) = train_problem()
    sgd = functools.partial(torch.optim.SGD, lr=0.1)
    full = train.make_train_step(linear_loss, mesh=mesh)
    acc = train.make_train_step(linear_loss, mesh=mesh, accum=4)
    s_full = train.create_train_state(_copy(params), sgd, mesh=mesh)
    s_acc = train.create_train_state(_copy(params), sgd, mesh=mesh)
    (bx, by), = list(train.prefetch_to_device(iter([(x, y)]), mesh=mesh))
    s_full, mf = full(s_full, (bx, by))
    (ax, ay), = list(train.prefetch_to_device(iter([(x.reshape(4, 4, 8), y.reshape(4, 4, 4))]), mesh=mesh, accum=4))
    s_acc, ma = acc(s_acc, (ax, ay))
    r["accum"] = (float(mf["loss"]), float(ma["loss"]), _np_params(s_full.params), _np_params(s_acc.params))

    # LoRA on a dp mesh (tests/test_lora.py:270)
    from vision_tpu_torch.lora import LORA_TRAINABLE, add_lora

    base, batch = lora_problem()
    adapted = add_lora(base, rank=4, seed=3)
    single = train.create_train_state(_copy(adapted), train.adam(1e-2),
                                      trainable=LORA_TRAINABLE)
    meshed = train.create_train_state(_copy(adapted), train.adam(1e-2), mesh=mesh_dp8, trainable=LORA_TRAINABLE)
    sstep = train.make_train_step(lora_loss, trainable=LORA_TRAINABLE)
    mstep = train.make_train_step(lora_loss, mesh=mesh_dp8, trainable=LORA_TRAINABLE)
    r["lora_loss"] = []
    for _ in range(3):
        single, sm = sstep(single, t(batch))
        meshed, mm = mstep(meshed, t(batch))
        r["lora_loss"].append((float(mm["loss"]), float(sm["loss"])))
    r["lora_params"], r["lora_single"] = _np_params(meshed.params), _np_params(single.params)

    # a DINOv2 SGD step over dp x tp with fsdp: Megatron's operators carry the gradients
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models.dino import dino_get_intermediate_layers

    dparams, dp = train_case()

    def dino_loss(weights, x):
        feats = dino_get_intermediate_layers(Params(weights), x, [dp.n_layers - 1], dp)
        return torch.mean(feats[-1][..., :DINO_LOSS_CHANNELS].float() ** 2)

    sgd1 = functools.partial(torch.optim.SGD, lr=1.0)
    st = train.create_train_state(_copy(dparams), sgd1, mesh=mesh, rules=DEFAULT_TP_RULES + TRAIN_RULES_EXTRA,
                                  fsdp=True, fsdp_min_size=1024)
    r["dino_fsdp"] = sum(map(is_fsdp, st.params.values()))
    with _collectives(dist, {}) as r["dino_collectives"]:
        st, m = train.make_train_step(dino_loss, mesh=mesh)(st, torch.from_numpy(dino_train_batch()))
    r["dino_loss"] = float(m["loss"])
    r["dino_params"] = _np_params(st.params)
    r["dino_placements"] = {k: [str(p) for p in v.placements] for k, v in st.params.items()}

    # the recipes on a dp-4 mesh (ranks 0-3), then one rank alone
    from vision_tpu_torch import finetune as ft

    dev = backend_init("cpu")
    images = ft.list_images(["imgs"])
    kw = dict(steps=RECIPE_STEPS, lr=RECIPE_LR, batch=RECIPE_BATCH, device=dev, workers=1)
    runs = {
        "esrgan": lambda out, m: ft.finetune_esrgan("esrgan.gguf", images, out, patch=8, ema_decay=0.5, mesh=m, **kw),
        "birefnet": lambda out, m: ft.finetune_birefnet("birefnet.gguf", images, out, masks="masks", size=64, mesh=m,
                                                        **kw),
        "distill": lambda out, m: ft.distill_depthany("depthany.gguf", "depthany.gguf", images, out, size=28,
                                                      lora_rank=2, qlora=True, mesh=m, **kw),
    }
    # ranks 0-3 run the three on the mesh while ranks 4-6 run one each alone
    alone = {4: "esrgan", 5: "birefnet", 6: "distill"}
    meshed = {name: run(f"{name}-dp4.gguf", mesh_dp4) for name, run in runs.items()} if rank < 4 else {}
    if rank in alone:
        single = runs[alone[rank]](f"{alone[rank]}-one.gguf", None)
        with open(f"{alone[rank]}-one.pkl", "wb") as f:
            pickle.dump((single["first_loss"], single["last_loss"]), f)
    dist.barrier()
    if rank == 0:
        r["recipes"] = {}
        for name, m in meshed.items():
            with open(f"{name}-one.pkl", "rb") as f:
                r["recipes"][name] = (m["first_loss"], m["last_loss"], *pickle.load(f))
        r["recipe_bad_batch"] = _error(lambda: ft.finetune_esrgan("esrgan.gguf", images, "never.gguf", patch=8,
                                                                  mesh=mesh_dp4, **{**kw, "batch": 3}))

    # the meshed SAM export (tests/test_export.py:238-300) on dp 2, and its refusals
    from vision_tpu_torch import export
    from vision_tpu_torch.image import image_load_array
    from vision_tpu_torch.models.migan import MiganModel, MiganParams
    from vision_tpu_torch.models.mobile_sam import SamModel, SamParams, TinyVitLayer, TinyVitParams
    from vision_tpu_torch.models.random_weights import random_migan_params, random_mobile_sam_params

    tv = TinyVitParams(img_size=SAM_EXPORT_SIZE, layers=tuple(TinyVitLayer(*lay) for lay in SAM_EXPORT_LAYERS))
    store = _put(random_mobile_sam_params(seed=0))
    sp = SamParams(image_size=SAM_EXPORT_SIZE)
    sam_tp = SamModel(store, sp, dev, mesh=mesh, tiny_vit=tv)
    r["export_refusals"] = {
        "tp": _error(lambda: export.export_model(sam_tp, "x.vxp", batch=4, embed_params=False, entries=("encode",))),
        "embed": _error(lambda: export.export_model(sam_tp, "x.vxp")),
    }
    mg = MiganModel(_put(random_migan_params(64)), MiganParams(resolution=64), dev, mesh=mesh_dp2)
    r["export_refusals"]["migan"] = _error(lambda: export.export_model(mg, "x.vxp", embed_params=False))
    if rank < 2:
        sam = SamModel(store, sp, dev, mesh=mesh_dp2, tiny_vit=tv)
        r["export_refusals"]["batch"] = _error(lambda: export.export_model(sam, "x.vxp", batch=3, embed_params=False))
        names = export.export_model(sam, f"sam_dp2_{rank}.vxp", batch=2, embed_params=False, entries=("encode",))
        bundle = export.load_bundle(f"sam_dp2_{rank}.vxp")
        frames = sam_export_frames()
        got = bundle.call_sharded("encode", store, torch.from_numpy(frames))
        if rank == 0:
            one = SamModel(store, sp, dev, tiny_vit=tv)
            want = one.encode_batch([image_load_array(f) for f in frames])
            r["export"] = (names, bundle.meta["mesh"], bundle.input_specs("encode"), got.float().numpy(),
                           want.float().numpy())
            r["export_unknown"] = _error(lambda: export.export_model(sam, "y.vxp", batch=2, embed_params=False,
                                                                     entries=("nope",)))
    dist.barrier()
    return r


SUITES = {"parallel": suite_parallel, "models": suite_models, "serving": suite_serving, "train": suite_train}


class World:
    """n rank processes of one suite; :meth:`results` waits for rank 0's."""

    def __init__(self, suite: str, n: int, tmp: Path, timeout: float = 240.0):
        self.out = tmp / f"{suite}.pkl"
        self.timeout = timeout
        address = "file://" + str(tmp / f"{suite}.store")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(HERE.parent), str(HERE)]), VISP_DIST_TIMEOUT="120",
                   OMP_NUM_THREADS=str(TORCH_THREADS))
        self.logs = [open(tmp / f"{suite}.rank{r}.log", "w+") for r in range(n)]
        self.procs = [
            subprocess.Popen([sys.executable, str(HERE / "torch_mesh_ranks.py"), suite, str(r), str(n), address,
                              str(self.out)], env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp))
            for r, log in enumerate(self.logs)
        ]

    def results(self) -> dict:
        """Rank 0's results (raises with its log if it failed); the other
        ranks are ended once rank 0 is done."""
        try:
            rc = self.procs[0].wait(timeout=self.timeout)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    try:
                        p.wait(timeout=30)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
        self.logs[0].seek(0)
        log = self.logs[0].read()
        for f in self.logs:
            f.close()
        if rc != 0 or not self.out.exists():
            raise RuntimeError(f"rank 0 exited {rc}:\n{log[-6000:]}")
        with open(self.out, "rb") as f:
            return pickle.load(f)


def main(argv) -> int:
    suite, rank, n, address, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    import torch

    torch.set_num_threads(TORCH_THREADS)
    from vision_tpu_torch.parallel import init_distributed

    init_distributed(address, n, rank, device="cpu")
    res = SUITES[suite](rank, n)
    if rank == 0:
        assert "jax" not in sys.modules, "a rank imported jax"
        with open(out + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(out + ".tmp", out)
    sys.stdout.flush()
    os._exit(0)  # no teardown: in the models suite a rank died on purpose


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
