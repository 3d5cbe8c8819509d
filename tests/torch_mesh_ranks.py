"""The rank side of the port's mesh tests (tests/test_torch_parallel*.py):
one gloo world of CPU ranks, each a process of its own that imports no JAX.

    python tests/torch_mesh_ranks.py SUITE RANK N ADDRESS OUT

Every rank joins the world at ADDRESS (a ``file://`` store), runs SUITE
(``parallel``, ``models`` or ``serving``) and rank 0 pickles its numpy
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


def ungroup_qkv(t, tp: int):
    """The inverse of parallel/tp.py's ``regroup_qkv``: a fused qkv shard
    put back together, its rows back in [q..|k..|v..] order."""
    s = t.shape
    return t.reshape(tp, 3, s[0] // (3 * tp), *s[1:]).transpose(0, 1).reshape(s)


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
    from vision_tpu_torch.parallel.tp import tp_dim
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
    # what the serving meshes refuse: SAM3's sp / pp (the scan trunk waits),
    # a served model on a mesh with sp or pp, a meshed export, a CUDA model
    # on a CPU mesh
    from vision_tpu_torch.core.device import BackendType, Device, backend_init
    from vision_tpu_torch.export import export_model
    from vision_tpu_torch.models.depth_anything import DepthAnythingModel, DepthAnythingParams
    from vision_tpu_torch.models.dino import DinoParams
    from vision_tpu_torch.models.sam3 import Sam3Model

    cpu = backend_init("cpu")
    da_p = DepthAnythingParams(dino=DinoParams(embed_dim=64, n_heads=2, n_layers=4), image_size=126,
                               feature_layers=(0, 1, 2, 3))
    da_store = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in random_depth_anything_params("test").items()}
    r["refusals"] = {
        "sam3 sp": _error(lambda: Sam3Model({}, None, 32, cpu, mesh=make_mesh(4, sp=2, device="cpu"))),
        "sam3 pp": _error(lambda: Sam3Model({}, None, 32, cpu, mesh=make_mesh(4, pp=4, device="cpu"))),
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
    from vision_tpu_torch.models.sam3 import Sam3VitParams, encode_text, encode_vision, sam3_heads
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
        # an entry that raises on every rank of a dp 2 x tp 2 mesh: that call fails, the world serves on
        b["tp_flaky"] = MeshEntry(register_model(), "tp_flaky", _flaky(rank), mesh_22, dev.torch_device)
        # a last model whose entry ends rank 3 mid-call: rank 0 must fail, not hang
        b["dying"] = MeshEntry(register_model(), "die", lambda t: os._exit(3) if rank == 3 else t,
                               make_mesh(4, device="cpu"), dev.torch_device)
        return b

    def drive(b, r):
        r["tp_model_error"] = _error(lambda: b["tp_flaky"](torch.ones(4, 2), fail_on=(0, 1, 2, 3)))
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


SUITES = {"parallel": suite_parallel, "models": suite_models, "serving": suite_serving}


class World:
    """n rank processes of one suite; :meth:`results` waits for rank 0's."""

    def __init__(self, suite: str, n: int, tmp: Path, timeout: float = 240.0):
        self.out = tmp / f"{suite}.pkl"
        self.timeout = timeout
        address = "file://" + str(tmp / f"{suite}.store")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(HERE.parent), str(HERE)]), VISP_DIST_TIMEOUT="120",
                   OMP_NUM_THREADS="2")
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

    torch.set_num_threads(2)
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
