"""The port's dp-only families against the JAX package's at the same mesh
shape, on a gloo world of 4 CPU ranks (f32).

One world is started per module (tests/torch_mesh_ranks.py, suite
``serving``; its ranks import no JAX): Real-ESRGAN's tiled path at dp 4
and dp 2, MI-GAN through ImageServer at dp 4 and dp 2 (and its raw
forward), YOLOv9t through YoloServer at dp 4 (and its raw forward). The
JAX side runs here on its 8 virtual CPU devices while the ranks work. Each
holds the JAX meshed function within relative RMS 1e-4
(tests/test_golden.py:23), and the port's own unmeshed forward within
1e-5. No weight of these families matches a tp rule, so they are dp only,
as in the JAX package."""

import jax
import numpy as np
import pytest
import torch

from torch_mesh_ranks import World, esrgan_case, migan_case, yolo_case
from vision_tpu.core.device import BackendType
from vision_tpu.core.device import backend_init as jbackend_init
from vision_tpu.image import Image as JImage
from vision_tpu.image import ImageFormat as JImageFormat
from vision_tpu.image import image_load_array as jimage_load_array
from vision_tpu.models import esrgan as jesr
from vision_tpu.models import migan as jmg
from vision_tpu.models import yolov9t as jyolo
from vision_tpu.parallel import make_mesh as jmake_mesh
from vision_tpu.serve import ImageServer as JImageServer
from vision_tpu.serve import YoloServer as JYoloServer
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat, image_load_array
from vision_tpu_torch.models.esrgan import EsrganModel, EsrganParams
from vision_tpu_torch.models.migan import MiganModel, MiganParams
from vision_tpu_torch.models.yolov9t import Yolov9tModel, Yolov9tParams
from torch_threads import torch_threads  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

REL_RMS = 1e-4  # tests/test_golden.py:23
DP_REL_RMS = 1e-5  # a dp-only mesh against the port's own unmeshed forward


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12))


def _jimg(a):
    return JImage(np.ascontiguousarray(a), JImageFormat.rgba_u8 if a.shape[-1] == 4 else JImageFormat.rgb_u8)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World("serving", 4, tmp_path_factory.mktemp("mesh_serving"))


@pytest.fixture(scope="module")
def jax_side(world):
    """The JAX package's meshed models at the port's mesh shapes, run while
    the ranks work."""
    dev = jbackend_init(BackendType.cpu)
    out = {}
    m4, m2 = jmake_mesh(4), jmake_mesh(2)
    esr_store, esr_img = esrgan_case()
    for key, mesh, batch in (("esrgan_tiled", m4, 4), ("esrgan_tiled_dp2", m2, 2)):
        out[key] = jesr.EsrganModel(esr_store, jesr.EsrganParams(4, 1), dev, mesh=mesh).compute(
            jimage_load_array(esr_img), tile_size=32, batch=batch).data

    mg_store, mg_imgs, mg_mask = migan_case()
    mask = JImage(mg_mask, JImageFormat.alpha_u8)
    xs = np.stack([a[..., :3] for a in mg_imgs])
    ms = np.stack([mg_mask] * 4)
    for key, mesh, k in (("migan", m4, 4), ("migan_dp2", m2, 2)):
        model = jmg.MiganModel(mg_store, jmg.MiganParams(resolution=64), dev, mesh=mesh)
        with JImageServer(model, batch_size=k, max_delay_ms=10_000) as srv:
            out[key] = [f.result(timeout=600).data for f in [srv.submit((_jimg(a), mask)) for a in mg_imgs[:k]]]
        out[key.replace("migan", "migan_raw")] = np.asarray(model._run_sharded(model.params, xs[:k], ms[:k]))

    yl_store, yl_imgs = yolo_case()
    yp = jyolo.Yolov9tParams(input_size=160)
    n_anchors = sum((yp.input_size // st) ** 2 for st in (8, 16, 32))
    with JYoloServer(jyolo.Yolov9tModel(yl_store, yp, dev, mesh=m4), batch_size=4, max_delay_ms=10_000,
                     conf_thres=0.001, max_candidates=n_anchors) as srv:
        dets = [f.result(timeout=600) for f in [srv.submit(_jimg(a)) for a in yl_imgs]]
    out["yolo"] = [[(d.class_id, d.confidence, d.x1, d.y1, d.x2, d.y2) for d in ds] for ds in dets]
    return out


@pytest.fixture(scope="module")
def r(world, jax_side):
    return world.results()


@pytest.mark.parametrize("key", ["esrgan_tiled", "esrgan_tiled_dp2", "migan_raw", "migan_raw_dp2"])
def test_dp_outputs_match_jax(r, jax_side, key):
    """Real-ESRGAN's tiled output (tile batch over dp) and MI-GAN's raw
    generator output (the served pixels of these random weights saturate,
    so a rounding flips a pixel 0 <-> 255: the raw output is the one to
    hold; vision_tpu_torch skill notes) against the JAX meshed model's."""
    got, want = r[key], jax_side[key]
    assert got.shape == want.shape
    assert _rel_rms(got, want) < REL_RMS


def test_servers_batch_and_refuse_an_uneven_tile_batch(r):
    assert r["migan_batches"] == 1
    assert r["esrgan_batch_error"] == "ValueError: tile batch 2 not divisible by mesh dp=4"


@pytest.mark.parametrize("key", ["migan", "migan_dp2"])
def test_migan_served_images_match_jax(r, jax_side, key):
    """The served rgba images: equal to the JAX meshed server's but for
    saturated pixels a rounding flips (at most 0.1% of the values)."""
    for got, want in zip(r[key], jax_side[key]):
        assert got.shape == want.shape
        assert np.mean(got != want) <= 1e-3


def test_yolo_server_matches_jax(r, jax_side):
    """YOLOv9t served at dp 4: the same detections (class, confidence) as
    the JAX package's meshed YoloServer, boxes within 1e-3 px."""
    assert any(r["yolo"])
    for got, want in zip(r["yolo"], jax_side["yolo"]):
        assert [(c, round(s, 4)) for c, s, *_ in got] == [(c, round(s, 4)) for c, s, *_ in want]
        if got:
            np.testing.assert_allclose(np.array([b[2:] for b in got]), np.array([b[2:] for b in want]), atol=1e-3)


def test_dp_only_meshes_match_the_unmeshed_port(r):
    """Real-ESRGAN (tiled), MI-GAN (served and raw) and YOLOv9t (raw) over
    dp against the same port model without a mesh: relative RMS < 1e-5."""
    dev = backend_init("cpu")
    put = lambda store: params_from_numpy(store, "cpu", torch.float32)  # noqa: E731
    esr_store, esr_img = esrgan_case()
    esr = EsrganModel(put(esr_store), EsrganParams(4, 1), dev)
    assert _rel_rms(r["esrgan_tiled"], esr.compute(image_load_array(esr_img), tile_size=32, batch=2).data) < DP_REL_RMS
    mg_store, mg_imgs, mg_mask = migan_case()
    mg = MiganModel(put(mg_store), MiganParams(resolution=64), dev)
    for got, a in zip(r["migan"], mg_imgs):
        want = mg.compute(Image(a, ImageFormat.rgba_u8), Image(mg_mask, ImageFormat.alpha_u8)).data
        assert _rel_rms(got, want) < DP_REL_RMS
    xs = torch.from_numpy(np.stack([a[..., :3] for a in mg_imgs]))
    assert _rel_rms(r["migan_raw"], mg.forward_u8(xs, torch.from_numpy(np.stack([mg_mask] * 4))).numpy()) < DP_REL_RMS
    yl_store, yl_imgs = yolo_case()
    yl = Yolov9tModel(put(yl_store), Yolov9tParams(input_size=160), dev)
    x = torch.from_numpy(np.stack([np.pad(a, ((20, 20), (0, 0), (0, 0))) for a in yl_imgs]))
    for got, want in zip(r["yolo_raw"], yl.forward_u8(x)):
        assert _rel_rms(got, want.numpy()) < DP_REL_RMS


def test_an_entry_that_raises_fails_its_call_alone(r):
    """An error in one rank's forward (dp 4) fails that call on rank 0,
    with rank 0's own error or one that counts the ranks that raised, and
    the world serves on: the next call, and every served result above,
    came after it."""
    assert r["model_error_rank1"] == "VispError: mesh: flaky raised on 1 rank(s); their logs say why"
    assert r["model_error_rank0"] == "VispError: rank 0 refuses this batch"
    np.testing.assert_array_equal(r["after_model_errors"], np.arange(8.0).reshape(4, 2) * 2)
