"""The port's tensor-parallel families against the JAX package's at the
same mesh shape, on a gloo world of 4 CPU ranks (f32).

One world is started per module (tests/torch_mesh_ranks.py, suite
``models``; its ranks import no JAX): MobileSAM's encoder and SamServer at
dp 2 x tp 2, SAM3's trunk and neck at tp 2 and tp 4, its window-major
trunk sequence-parallel (sp 2 x tp 2 and sp 4; Sam3Model at sp 2 x tp 2)
and pipeline-parallel (pp 2 x tp 2), BiRefNet at dp 2 x tp 2,
Depth-Anything through ImageServer at dp 2 x tp 2 and at tp 2 on two
ranks, then a rank that dies mid-call. The JAX side runs here on its 8
virtual CPU devices while the ranks work. Each holds the JAX meshed
function within relative RMS 1e-4 (tests/test_golden.py:23). The dp-only
families are in test_torch_parallel_serving.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_ranks import (
    SAM3_PP_IMAGES,
    SAM3_SCAN_BATCHES,
    SAM3_SCAN_MESHES,
    World,
    birefnet_case,
    clip_case,
    depthany_case,
    sam3_case,
    sam3_model_image,
    sam3_scan_images,
    sam_images,
)
from vision_tpu.core.device import BackendType
from vision_tpu.core.device import backend_init as jbackend_init
from vision_tpu.core.params import Params as JParams
from vision_tpu.image import Image as JImage
from vision_tpu.image import ImageFormat as JImageFormat
from vision_tpu.image import image_load_array as jimage_load_array
from vision_tpu.models import birefnet as jbir
from vision_tpu.models import depth_anything as jda
from vision_tpu.models import mobile_sam as jsam
from vision_tpu.models import sam3 as jsam3
from vision_tpu.models.dino import DinoParams as JDinoParams
from vision_tpu.models.swin import SWIN_T_PARAMS as JSWIN_T
from vision_tpu.parallel import SAM3_TP_RULES as JSAM3_TP_RULES
from vision_tpu.parallel import make_mesh as jmake_mesh
from vision_tpu.parallel import shard_params as jshard_params
from vision_tpu.serve import ImageServer as JImageServer
from vision_tpu.serve import SamServer as JSamServer
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.models.random_weights import random_mobile_sam_params
from torch_threads import torch_threads  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

REL_RMS = 1e-4  # tests/test_golden.py:23
ATOL_STACK = 1e-4  # tests/test_torch_sam3.py:33, a stack of layers against JAX


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return {"world": World("models", 4, tmp_path_factory.mktemp("mesh_models"), timeout=300)}


def _jimg(a):
    return JImage(np.ascontiguousarray(a), JImageFormat.rgba_u8 if a.shape[-1] == 4 else JImageFormat.rgb_u8)


@pytest.fixture(scope="module")
def jax_side(started):
    """The JAX package's meshed functions at the port's mesh shapes,
    computed while the ranks run."""
    dev = jbackend_init(BackendType.cpu)
    out = {}
    m22, m2tp = jmake_mesh(4, tp=2), jmake_mesh(2, tp=2)
    sam = jsam.SamModel(random_mobile_sam_params(0), jsam.SamParams(), dev, mesh=m22)
    out["sam_encode"] = np.asarray(sam.encode_batch([jimage_load_array(a[..., :3].copy()) for a in sam_images()]))
    with JSamServer(sam, batch_size=2, max_delay_ms=10_000) as srv:
        futs = [srv.submit(_jimg(a), point=(40 + 20 * i, 30)) for i, a in enumerate(sam_images())]
        out["sam_server"] = [f.result(timeout=600).data for f in futs]

    bir_store, bir_imgs = birefnet_case()
    bp = jbir.BirefnetParams(image_size=64, image_extent=(64, 64), encoder=JSWIN_T)
    out["birefnet"] = [m.data for m in jbir.BirefnetModel(bir_store, bp, dev, mesh=m22).compute_batch(
        [jimage_load_array(a) for a in bir_imgs])]

    store, x, vp = sam3_case()
    jvp = jsam3.Sam3VitParams(**vp)
    fn = jax.jit(lambda p, xx: jsam3.encode_vision(JParams(p), xx, jvp).fpn_hidden_states)
    for tp in (2, 4):
        out[f"sam3_tp{tp}"] = [np.asarray(f) for f in fn(jshard_params(store, jmake_mesh(4, tp=tp), JSAM3_TP_RULES),
                                                         jnp.asarray(x))]

    out.update(_jax_sam3_scan(store, jvp))

    store, ids, mask, layers = clip_case()
    text = jax.jit(lambda p, i, m: jsam3.encode_text(JParams(p), i, m, n_layers=layers))
    for tp in (2, 4):
        out[f"clip_tp{tp}"] = np.asarray(text(jshard_params(store, jmake_mesh(4, tp=tp), JSAM3_TP_RULES),
                                              jnp.asarray(ids), jnp.asarray(mask)))

    da_store, da_imgs = depthany_case()
    dap = jda.DepthAnythingParams(dino=JDinoParams(embed_dim=64, n_heads=2, n_layers=4), image_size=126,
                                  feature_layers=(0, 1, 2, 3))
    with JImageServer(jda.DepthAnythingModel(da_store, dap, dev, mesh=m22), batch_size=None,
                      max_delay_ms=10_000) as srv:
        out["depthany_batch"] = srv.batch_size
        out["depthany"] = [f.result(timeout=600).data for f in [srv.submit(_jimg(a)) for a in da_imgs[:2]]]
    with JImageServer(jda.DepthAnythingModel(da_store, dap, dev, mesh=m2tp), batch_size=2,
                      max_delay_ms=10_000) as srv:
        out["depthany_tp2"] = [f.result(timeout=600).data for f in [srv.submit(_jimg(a)) for a in da_imgs[:2]]]

    return out


def _jax_sam3_scan(store: dict, jvp) -> dict:
    """The JAX package's window-major SAM3 trunk at the ranks' meshes:
    sequence-parallel (sam3_shard_vision + encode_vision(mesh=)), Sam3Model
    on an sp mesh, pipeline-parallel from stage weights and from the stack,
    and the refusals' texts."""
    out = {}
    stack = jsam3.sam3_pack_vision_weights(store, jvp, prefix="backbone.")
    for key, (tp, sp) in SAM3_SCAN_MESHES.items():
        mesh = jmake_mesh(4, tp=tp, sp=sp)
        sharded, sstack = jsam3.sam3_shard_vision(store, stack, mesh)
        fn = jax.jit(lambda p, st, xx, mesh=mesh: jsam3.encode_vision(JParams(p), xx, jvp, win_stack=st,
                                                                       mesh=mesh).fpn_hidden_states)
        for batch in SAM3_SCAN_BATCHES:
            xb = jnp.asarray(sam3_scan_images(batch))
            out[f"sam3_{key}_b{batch}"] = [np.asarray(f) for f in fn(sharded, sstack, xb)]
    model = jsam3.Sam3Model({f"det.ve.{k}": v for k, v in store.items()}, jsam3.ClipTokenizer(vocab={}, bpe_rank={}), 8,
                            jbackend_init(BackendType.cpu), vp=jvp, mesh=jmake_mesh(4, tp=2, sp=2))
    out["sam3_model_sp"] = [np.asarray(f) for f in model.encode_vision(JImage(sam3_model_image(),
                                                                                JImageFormat.rgba_u8))]
    x = jnp.asarray(sam3_scan_images(1))
    refusals = {"sam3_sp_no_scan": lambda: jsam3.encode_vision(JParams(store), x, jvp, mesh=jmake_mesh(4, sp=4)),
                "sam3_sp3": lambda: jsam3.encode_vision(JParams(store), x, jvp, win_stack=stack,
                                                        mesh=jmake_mesh(3, sp=3))}
    for key, call in refusals.items():
        with pytest.raises(ValueError) as err:
            call()
        out[key] = f"ValueError: {err.value}"
    mesh = jmake_mesh(4, pp=2, tp=2)
    imgs = jnp.asarray(sam3_scan_images(SAM3_PP_IMAGES))
    stage_w = jsam3.sam3_pipeline_weights(JParams(store)["backbone"], stack, jvp, mesh)
    out["sam3_pp_stage"] = [np.asarray(f) for f in jax.jit(lambda p, sw, xx: jsam3.encode_vision_pipelined(
        JParams(p), xx, jvp, stage_weights=sw, mesh=mesh).fpn_hidden_states)(store, stage_w, imgs)]
    out["sam3_pp_stack"] = [np.asarray(f) for f in jax.jit(lambda p, st, xx: jsam3.encode_vision_pipelined(
        JParams(p), xx, jvp, win_stack=st, mesh=mesh).fpn_hidden_states)(store, stack, imgs)]
    out["sam3_pp_stage_shapes"] = {(part, k): tuple(v.shape) for part, t in stage_w.items() for k, v in t.items()}
    errors = {}
    for key, (vp_, m) in {"uniform": (dataclasses.replace(jvp, global_attn_indexes=(1, 2)), mesh),
                          "stages": (jvp, jmake_mesh(4, pp=4))}.items():
        with pytest.raises(ValueError) as err:
            jsam3.encode_vision_pipelined(JParams(store), imgs, vp_, win_stack=stack, mesh=m)
        errors[key] = f"ValueError: {err.value}"
    out["sam3_pp_errors"] = errors
    return out


@pytest.fixture(scope="module")
def r(started, jax_side):
    return started["world"].results()


@pytest.mark.parametrize("key", ["sam_encode", "sam3_tp2", "sam3_tp4", "clip_tp2", "clip_tp4"])
def test_tensor_parallel_encoders_match_jax(r, jax_side, key):
    """MobileSAM's encoder at dp 2 x tp 2 (TinyViT's 5-head stage whole on
    every rank), SAM3's trunk + neck at tp 2 and 4, and SAM3's CLIP text
    encoder at tp 2 and 4 (its q / k / v column-parallel, its out_proj,
    which no rule shards, after the heads are gathered)."""
    got, want = r[key], jax_side[key]
    for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]):
        assert g.shape == w.shape
        assert _rel_rms(g, w) < REL_RMS


SAM3_SCAN_KEYS = [f"sam3_{m}_b{b}" for m in SAM3_SCAN_MESHES for b in SAM3_SCAN_BATCHES]


@pytest.fixture(scope="module")
def sam3_unmeshed():
    """The port's unmeshed window-major trunk on each case's images (and
    Sam3Model without a mesh), here in the pytest process."""
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.image import Image, ImageFormat
    from vision_tpu_torch.models import sam3 as s3

    store, _, vp = sam3_case()
    vp = s3.Sam3VitParams(**vp)
    p = params_from_numpy(store, "cpu", torch.float32)
    stack = s3.sam3_pack_vision_weights(p, vp, prefix="backbone.")

    def fpn(batch):
        with torch.inference_mode():
            out = s3.encode_vision(Params(p), torch.from_numpy(sam3_scan_images(batch)), vp, win_stack=stack)
        return [f.numpy() for f in out.fpn_hidden_states]

    out = {f"sam3_{m}_b{b}": fpn(b) for m in SAM3_SCAN_MESHES for b in SAM3_SCAN_BATCHES}
    out["sam3_pp_stage"] = out["sam3_pp_stack"] = fpn(SAM3_PP_IMAGES)
    model = s3.Sam3Model({f"det.ve.{k}": v for k, v in p.items()}, s3.ClipTokenizer(vocab={}, bpe_rank={}), 8,
                         backend_init("cpu"), vp=vp)
    out["sam3_model_sp"] = [f.numpy() for f in model.encode_vision(Image(sam3_model_image(), ImageFormat.rgba_u8))]
    return out


@pytest.mark.parametrize("key", SAM3_SCAN_KEYS + ["sam3_model_sp", "sam3_pp_stage", "sam3_pp_stack"])
def test_sam3_sequence_and_pipeline_parallel_match_jax(r, jax_side, sam3_unmeshed, key):
    """SAM3's window-major trunk + neck meshed: sequence-parallel at sp 2 x
    tp 2 and sp 4, batch 1, 2 and 3 (4 windows an image: at batch 3 a
    rank's windows span two images, 6 at sp 2 and 3 at sp 4, and each image's
    queries attend to its own keys only), Sam3Model's encode_vision on an
    sp 2 x tp 2 mesh through the runner, and encode_vision_pipelined at pp
    2 x tp 2 over 3 images from sam3_pipeline_weights and from the whole
    stack. Against the JAX package's meshed functions at the same mesh
    shapes within relative RMS 1e-4 and max |delta| ATOL_STACK (the port's
    bound for a SAM3 stack against JAX, tests/test_torch_sam3.py:33: the
    unmeshed trunks of the two packages already differ at 2e-5 on these
    outputs); against the port's own unmeshed trunk within
    max |delta| 2e-5, as the JAX tests hold a meshed trunk against one
    device (tests/test_parallel.py:272-323)."""
    got, want, one = r[key], jax_side[key], sam3_unmeshed[key]
    assert len(got) == len(want) == len(one) == 4
    for g, w, o in zip(got, want, one):
        assert g.shape == w.shape == o.shape
        assert _rel_rms(g, w) < REL_RMS
        assert float(np.abs(g - w).max()) <= ATOL_STACK
        assert float(np.abs(g - o).max()) <= 2e-5


def test_sam3_sp_gathers_k_and_v_once_a_global_layer(r):
    """Each sp encode all-gathers K and V once a global layer (2 global
    layers) and the trunk's output once before the neck: 5 gathers at
    every batch; Sam3Model's sp encode the same on rank 0."""
    assert r["sam3_gathers"] == {(m, b): 2 * 2 + 1 for m in SAM3_SCAN_MESHES for b in SAM3_SCAN_BATCHES}
    assert r["sam3_model_sp_gathers"] == 5


def test_sam3_pipeline_ranks_hold_only_their_stage(r, jax_side):
    """Each pp rank's stage weights: the global shape the JAX stage stack's,
    the local one its (1, ...) slice, the same bits as the slice stacked
    straight from the flat weights (win_stack=None), whose trunk gives the
    same output; each tp pair holds both stages."""
    ranks = r["sam3_pp_local"]
    assert sorted(k for k, _ in ranks) == [0, 0, 1, 1]
    for _, mine in ranks:
        assert set(mine) == set(jax_side["sam3_pp_stage_shapes"])
        for key, (shape, local, same) in mine.items():
            assert shape == jax_side["sam3_pp_stage_shapes"][key], key
            assert local == (1, *shape[1:]) and same, key
    assert all(np.array_equal(a, b) for a, b in zip(r["sam3_pp_flat"], r["sam3_pp_stage"]))


def test_sam3_mesh_refusals_are_the_jax_packages(r, jax_side):
    """sp without the window-major trunk, sp not dividing batch x windows
    (4 windows over sp 3), a trunk that is no uniform (win^k glb)* under pp
    and stages that do not divide over pp raise the JAX package's errors."""
    assert r["sam3_sp_no_scan"] == jax_side["sam3_sp_no_scan"]
    assert r["sam3_sp3"] == jax_side["sam3_sp3"]
    assert r["sam3_pp_errors"] == jax_side["sam3_pp_errors"]


def test_sam3_sp_flash_route_matches_the_unmeshed_trunk(r):
    """At 1024 tokens the global layers take the flash route: on sp 2 x tp 2
    each rank's 512 queries against the gathered keys through the kernel's
    plain version, against the unmeshed trunk's whole layers on the same
    route (f32), and both near the einsum form. Rank 0 calls the kernel's
    entry point once a global layer: its 2 of 4 heads, 512 queries against
    the image's 1024 keys."""
    assert r["sam3_sp_flash_calls"] == [((1, 2, 512, 16), (1, 2, 1024, 16))] * 2
    for g, w, e in zip(r["sam3_sp_flash"], r["sam3_flash_ref"], r["sam3_einsum_ref"]):
        assert _rel_rms(g, w) < REL_RMS and float(np.abs(g - w).max()) <= 2e-5
        assert _rel_rms(w, e) < REL_RMS


@pytest.mark.parametrize("key", ["sam_server", "birefnet", "depthany", "depthany_tp2"])
def test_served_outputs_match_jax(r, jax_side, key):
    """Each server's (or compute path's) results from the meshed model
    against the JAX package's meshed model at the same mesh shape."""
    got, want = r[key], jax_side[key]
    got, want = (got, want) if isinstance(got, list) else ([got], [want])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel_rms(g, w) < REL_RMS


def test_server_batches_scale_with_dp(r, jax_side):
    assert r["sam_server_batch"] == 2
    assert r["depthany_batch"] == jax_side["depthany_batch"] == 8  # 4 a card x dp 2


@pytest.fixture(scope="module")
def unmeshed():
    """The port's families without a mesh, on this process."""
    dev = backend_init("cpu")
    put = lambda store: params_from_numpy(store, "cpu", torch.float32)  # noqa: E731
    return dev, put


def test_birefnet_and_depthany_raw_match_the_unmeshed_port(r, unmeshed):
    """The dp 2 x tp 2 forwards against the unmeshed port (the tp sums run
    in another order: the JAX bound)."""
    from vision_tpu_torch.models.birefnet import BirefnetModel, BirefnetParams
    from vision_tpu_torch.models.depth_anything import DepthAnythingModel, DepthAnythingParams
    from vision_tpu_torch.models.dino import DinoParams
    from vision_tpu_torch.models.swin import SWIN_T_PARAMS

    dev, put = unmeshed
    bir_store, bir_imgs = birefnet_case()
    bir = BirefnetModel(put(bir_store), BirefnetParams(image_size=64, image_extent=(64, 64), encoder=SWIN_T_PARAMS),
                        dev)
    assert _rel_rms(r["birefnet_raw"], bir.forward_u8(torch.from_numpy(np.stack(bir_imgs))).numpy()) < REL_RMS
    da_store, da_imgs = depthany_case()
    da = DepthAnythingModel(put(da_store), DepthAnythingParams(dino=DinoParams(embed_dim=64, n_heads=2, n_layers=4),
                                                               image_size=126, feature_layers=(0, 1, 2, 3)), dev)
    x = torch.from_numpy(np.stack([a[:, :126, :3] for a in da_imgs]))
    assert _rel_rms(r["depthany_raw"], da.forward_u8(x).numpy()) < REL_RMS


def test_a_dead_rank_fails_the_call_and_the_futures(r):
    """A rank that exits mid-call makes rank 0's call raise, and a server's
    later futures fail with that error at once: nothing hangs."""
    assert r["dead_call"] is not None
    assert r["dead_future"] is not None and "a rank failed earlier" in r["dead_future"]
    assert r["dead_seconds"] < 60


def test_an_entry_that_raises_on_every_tp_rank_fails_its_call_alone(r):
    """An error on all four ranks of a dp 2 x tp 2 mesh (its tp groups stay
    in step) fails that call with rank 0's own error; every family above
    was served after it."""
    assert r["tp_model_error"] == "VispError: rank 0 refuses this batch"
