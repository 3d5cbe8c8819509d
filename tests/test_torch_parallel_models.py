"""The port's tensor-parallel families against the JAX package's at the
same mesh shape, on a gloo world of 4 CPU ranks (f32).

One world is started per module (tests/torch_mesh_ranks.py, suite
``models``; its ranks import no JAX): MobileSAM's encoder and SamServer at
dp 2 x tp 2, SAM3's trunk and neck at tp 2 and tp 4, BiRefNet at dp 2 x tp
2, Depth-Anything through ImageServer at dp 2 x tp 2 and at tp 2 on two
ranks, then a rank that dies mid-call. The JAX side runs here on its 8
virtual CPU devices while the ranks work. Each holds the JAX meshed
function within relative RMS 1e-4 (tests/test_golden.py:23). The dp-only
families are in test_torch_parallel_serving.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_ranks import World, birefnet_case, clip_case, depthany_case, sam3_case, sam_images
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

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

REL_RMS = 1e-4  # tests/test_golden.py:23


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
