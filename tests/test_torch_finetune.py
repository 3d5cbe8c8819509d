"""The port's fine-tuning recipes and their verbs (vision_tpu_torch/finetune.py,
cli.py finetune / distill / --adapter) against the JAX package's, at the JAX
tests' tiny sizes on the CPU: the input pipeline (the same patches and
images in the same order for a seed), the first step's loss (relative 1e-5)
and per-leaf gradients (relative RMS 1e-4) of the Real-ESRGAN and
Depth-Anything losses, each recipe's first loss against the JAX recipe's on
the same files; then training, EMA, export, checkpoint resume, LoRA / QLoRA
distillation and the verbs. BiRefNet's recipe is in
test_torch_finetune_birefnet.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_esrgan import RRDBNet, _write_gguf
from test_torch_api import write_family_gguf
from vision_tpu import finetune as jft
from vision_tpu.core.params import Params as JParams
from vision_tpu_torch import finetune as ft
from vision_tpu_torch.cli import main
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.gguf import GGUFFile
from vision_tpu_torch.core.weights import load_weights
from vision_tpu_torch.image import Image, ImageFormat, image_save
from vision_tpu_torch.ops.cuda import conv3x3 as cc
from workbench import randomize

LOSS_RTOL = 1e-5
GRAD_REL_RMS = 1e-4  # per leaf, f32: summation order only
GRAD_FLOOR = 1e-2  # see assert_step_matches


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-30))


def img_dir(tmp_path, n=3, size=(24, 20), seed=0, name="imgs"):
    d = tmp_path / name
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        image_save(Image(rng.integers(0, 256, (*size, 3), np.uint8), ImageFormat.rgb_u8), str(d / f"im{i}.png"))
    (d / "notes.txt").write_text("ignored")  # non-image files are skipped
    return d


def esrgan_gguf(tmp_path):
    return str(_write_gguf(tmp_path / "esrgan.gguf", randomize(RRDBNet(nf=8, nb=1, gc=4, scale=4)), 4, 1))


def depth_ggufs(tmp_path):
    """A Depth-Anything "test" teacher and student (random weights, seeds 0
    and 1; the metadata of test_torch_api's small depthany GGUF)."""
    from test_torch_api import FAMILIES
    from vision_tpu_torch.core.gguf import GGUFWriter
    from vision_tpu_torch.models.random_weights import random_depth_anything_params

    arch, meta, _ = FAMILIES["depthany"]
    paths = []
    for name, seed in (("teacher", 0), ("student", 1)):
        w = GGUFWriter(tmp_path / f"{name}.gguf", arch)
        for k, v in meta.items():
            w.add(k, v)
        for k, a in random_depth_anything_params("test", seed=seed).items():
            w.add_tensor(k, a)
        w.write()
        paths.append(str(tmp_path / f"{name}.gguf"))
    return tuple(paths)


def _grads(loss_fn, store: dict, batch):
    """The loss and every float leaf's gradient (zeros for a leaf the loss
    does not reach, as jax.grad gives)."""
    t = {k: torch.tensor(v, requires_grad=np.issubdtype(v.dtype, np.floating)) for k, v in store.items()}
    names = [k for k, v in t.items() if v.requires_grad]
    loss = loss_fn(t, batch)
    grads = torch.autograd.grad(loss, [t[k] for k in names], allow_unused=True)
    return float(loss.detach()), {k: np.zeros(store[k].shape, np.float32) if g is None else g.numpy()
                                  for k, g in zip(names, grads)}


def _jgrads(loss_fn, store: dict, batch):
    fl = {k: jnp.asarray(v) for k, v in store.items() if np.issubdtype(v.dtype, np.floating)}
    rest = {k: v for k, v in store.items() if k not in fl}
    loss, g = jax.value_and_grad(lambda f: loss_fn({**rest, **f}, batch))(fl)
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def assert_step_matches(ours, theirs):
    """The losses within LOSS_RTOL; each leaf's gradient within GRAD_REL_RMS
    of its RMS, or of GRAD_FLOOR x the RMS of all the gradients where that is
    larger (attention's key biases get a gradient that is zero in exact
    arithmetic, since the softmax ignores a shift along the keys: both
    packages return rounding noise there)."""
    (loss, g), (jloss, jg) = ours, theirs
    assert np.isfinite(loss) and abs(loss - jloss) <= LOSS_RTOL * abs(jloss), (loss, jloss)
    assert set(g) == set(jg)
    overall = np.sqrt(np.mean(np.concatenate([np.asarray(v, np.float64).ravel() for v in jg.values()]) ** 2))
    for k in g:
        a, b = np.asarray(g[k], np.float64), np.asarray(jg[k], np.float64)
        err = np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), GRAD_FLOOR * overall)
        assert err <= GRAD_REL_RMS, (k, err)


def test_list_images_matches_jax(tmp_path):
    d = img_dir(tmp_path)
    files = ft.list_images([str(d)])
    assert files == jft.list_images([str(d)]) and len(files) == 3
    assert ft.list_images([files[0], str(d)]) == jft.list_images([files[0], str(d)])
    (tmp_path / "empty").mkdir()
    with pytest.raises(VispError, match="no images"):
        ft.list_images([str(tmp_path / "empty")])


def test_esrgan_patches_and_first_step_match_jax(tmp_path):
    """The recipe's host pipeline cuts the JAX package's patches (reflect
    padding for an image smaller than the patch included), and the first
    step's L1 loss (bicubic LR made from the HR batch, the 1-block RRDBNet)
    and every leaf's gradient agree with jax.value_and_grad of the JAX
    recipe's loss."""
    from vision_tpu.models.esrgan import esrgan_detect_params as jdetect
    from vision_tpu.models.esrgan import esrgan_generate as jgenerate
    from vision_tpu.ops.resize import resize_nhwc as jresize
    from vision_tpu_torch.models.esrgan import esrgan_detect_params

    d = img_dir(tmp_path)
    small = img_dir(tmp_path, n=1, size=(6, 5), name="small")
    items = list(enumerate(ft.list_images([str(d), str(small)])))
    ours = np.stack([ft._patch_load(8, 11)(it) for it in items])
    theirs = np.stack([jft._patch_load(8, 11)(it) for it in items])
    np.testing.assert_array_equal(ours, theirs)
    path = esrgan_gguf(tmp_path)
    f = GGUFFile(path)
    store = load_weights(f, as_numpy=True)
    p, jp = esrgan_detect_params(f), jdetect(f)
    hr = ours[:2]

    def jloss(params, hr):
        sr = jgenerate(JParams(params), jresize(hr, (2, 2), method="bicubic"), jp)
        return jnp.mean(jnp.abs(sr - hr))

    before = cc.launches
    assert_step_matches(_grads(ft.esrgan_loss(p, 8), store, torch.from_numpy(hr)), _jgrads(jloss, store, hr))
    assert cc.launches == before  # the CPU route launches nothing


def test_finetune_esrgan_first_loss_matches_the_jax_recipe_and_trains(tmp_path):
    """Both recipes on the same files and seed: the same first batch, so the
    same first loss; the port's run then trains, exports a file that loads
    through the model path with the source's KVs, and moved the weights."""
    from vision_tpu_torch.models.esrgan import esrgan_detect_params, esrgan_load_model

    src = esrgan_gguf(tmp_path)
    images = ft.list_images([str(img_dir(tmp_path))])
    lines = []
    stats = ft.finetune_esrgan(src, images, tmp_path / "t.gguf", steps=4, lr=1e-3, batch=2, patch=8, seed=0,
                               device=backend_init("cpu"), log=lines.append)
    jstats = jft.finetune_esrgan(src, images, tmp_path / "j.gguf", steps=1, lr=1e-3, batch=2, patch=8, seed=0)
    assert abs(stats["first_loss"] - jstats["first_loss"]) <= LOSS_RTOL * jstats["first_loss"]
    assert stats["steps"] == 4 and np.isfinite(stats["last_loss"]) and lines[0].startswith("step 1/4")
    f = GGUFFile(str(tmp_path / "t.gguf"))
    assert esrgan_detect_params(f).n_blocks == 1 and f.metadata["esrgan.tensor_data_layout"] == "torch"
    w0 = GGUFFile(src).tensor("model.0.weight", np.float32)
    assert not np.array_equal(w0, f.tensor("model.0.weight", np.float32))
    model = esrgan_load_model(str(tmp_path / "t.gguf"), backend_init("cpu"))
    assert model.compute(Image(np.zeros((6, 7, 3), np.uint8), ImageFormat.rgb_u8)).extent == (28, 24)


def test_finetune_esrgan_ema_small_folder_and_validation(tmp_path):
    src = esrgan_gguf(tmp_path)
    images = ft.list_images([str(img_dir(tmp_path, n=1))])  # fewer images than the batch
    dev = backend_init("cpu")
    stats = ft.finetune_esrgan(src, images, tmp_path / "e.gguf", steps=2, lr=1e-3, batch=3, patch=8, ema_decay=0.5,
                               device=dev)
    raw = ft.finetune_esrgan(src, images, tmp_path / "r.gguf", steps=2, lr=1e-3, batch=3, patch=8, device=dev)
    assert stats["steps"] == 2 and stats["first_loss"] == raw["first_loss"]
    w_src, w_ema, w_raw = (GGUFFile(str(p)).tensor("model.0.weight", np.float32)
                           for p in (src, tmp_path / "e.gguf", tmp_path / "r.gguf"))
    # at decay 0.5 the EMA lies strictly between the source and the trained weight
    assert not np.array_equal(w_ema, w_src) and not np.array_equal(w_ema, w_raw)
    with pytest.raises(VispError, match="divisible"):
        ft.finetune_esrgan(src, images, tmp_path / "x.gguf", patch=10, steps=1, device=dev)
    with pytest.raises(VispError, match="steps and batch"):
        ft.finetune_esrgan(src, images, tmp_path / "x.gguf", steps=0, device=dev)
    with pytest.raises(VispError, match="no self-supervised recipe"):
        ft.finetune(write_family_gguf("depthany", tmp_path), images, tmp_path / "x.gguf", device=dev)


def test_finetune_checkpoint_resume_and_determinism(tmp_path):
    """--ckpt: periodic and final saves; a rerun resumes from the newest
    step_* (optimizer and EMA state carried), so 2 + 2 resumed steps export
    what 4 unbroken steps do when the data repeats; a resume at --steps
    exports without training; one seed, one result."""
    src = esrgan_gguf(tmp_path)
    images = ft.list_images([str(img_dir(tmp_path, n=2))])
    dev = backend_init("cpu")
    kw = dict(lr=1e-3, batch=2, patch=8, seed=0, device=dev, ema_decay=0.9)
    ck = tmp_path / "ck"
    ft.finetune_esrgan(src, images, tmp_path / "a.gguf", steps=2, ckpt_dir=ck, ckpt_every=1, **kw)
    assert sorted(p.name for p in ck.iterdir()) == ["step_1", "step_2"]
    lines = []
    s2 = ft.finetune_esrgan(src, images, tmp_path / "b.gguf", steps=2, ckpt_dir=ck, log=lines.append, **kw)
    assert s2["steps"] == 2 and s2["first_loss"] is None and any("resumed" in line for line in lines)
    a, b = GGUFFile(str(tmp_path / "a.gguf")), GGUFFile(str(tmp_path / "b.gguf"))
    for name in a.tensors:
        np.testing.assert_array_equal(a.tensor(name), b.tensor(name))
    s3 = ft.finetune_esrgan(src, images, tmp_path / "c.gguf", steps=3, ckpt_dir=ck, **kw)
    assert s3["steps"] == 3 and (ck / "step_3").is_dir()
    again = ft.finetune_esrgan(src, images, tmp_path / "d.gguf", steps=2, **kw)
    for name in a.tensors:
        np.testing.assert_array_equal(a.tensor(name), GGUFFile(str(tmp_path / "d.gguf")).tensor(name))
    assert again["steps"] == 2


def test_distill_first_step_matches_jax(tmp_path):
    """The distillation's host pipeline resizes the JAX package's images; on
    one batch and the teacher's target, the student's first-step loss
    (scale- and shift-invariant L1, the median as jnp.median's) and every
    leaf's gradient agree with the JAX loss's; the teacher's forward equals
    the JAX teacher's."""
    from vision_tpu.models import depth_anything as jda
    from vision_tpu_torch.core.params import Params
    from vision_tpu_torch.models import depth_anything as da

    teacher, student = depth_ggufs(tmp_path)
    paths = ft.list_images([str(img_dir(tmp_path, size=(30, 31)))])
    x = np.stack([ft._resize_load(28)(p) for p in paths])
    np.testing.assert_array_equal(x, np.stack([jft._resize_load(28)(p) for p in paths]))
    tf, sf = GGUFFile(teacher), GGUFFile(student)
    t_store = da.fixup_weights(tf, load_weights(tf, as_numpy=True))
    s_store = da.fixup_weights(sf, load_weights(sf, as_numpy=True))
    tp, sp = da.depthany_detect_params(tf), da.depthany_detect_params(sf)
    with torch.no_grad():
        target = da.depthany_predict(Params({k: torch.from_numpy(np.array(v)) for k, v in t_store.items()}),
                                     torch.from_numpy(x), tp).numpy()
    jtarget = np.asarray(jda.depthany_predict(JParams(t_store), x, jda.depthany_detect_params(tf)))
    np.testing.assert_allclose(target, jtarget, atol=1e-4, rtol=1e-4)
    jsp = jda.depthany_detect_params(sf)

    def jloss(params, batch):
        xx, tt = batch
        s = jda.depthany_predict(JParams(params), xx, jsp)
        return jnp.mean(jnp.abs(jft._ssi_normalize(s) - jft._ssi_normalize(tt)))

    assert_step_matches(_grads(ft.ssi_loss(sp), s_store, (torch.from_numpy(x), torch.from_numpy(np.array(jtarget)))),
                        _jgrads(jloss, s_store, (x, jtarget)))
    odd = np.random.default_rng(0).random((2, 7, 5, 1)).astype(np.float32)  # an odd count: one middle
    for d in (odd, odd[:, :6]):
        np.testing.assert_allclose(ft._ssi_normalize(torch.from_numpy(d)).numpy(),
                                   np.asarray(jft._ssi_normalize(d)), atol=1e-5)


@pytest.mark.parametrize("mode", ["full", "lora", "qlora"])
def test_distill_recipe_matches_the_jax_first_loss_and_exports(tmp_path, mode):
    """distill_depthany on the same files and seed as the JAX recipe: the
    same first loss (LoRA's B starts at 0; QLoRA's int8 base dequantizes to
    the JAX package's values); the port then trains, its LoRA adapters
    moved, the export merges them and loads through the depth model."""
    from vision_tpu_torch.models.depth_anything import depthany_load_model

    teacher, student = depth_ggufs(tmp_path)
    images = ft.list_images([str(img_dir(tmp_path, size=(30, 31)))])
    kw = dict(lr=5e-2, batch=2, size=28, seed=0)
    if mode != "full":
        kw.update(lora_rank=2, qlora=mode == "qlora")
    stats = ft.distill_depthany(teacher, student, images, tmp_path / "d.gguf", steps=2, device=backend_init("cpu"),
                                lora_out=tmp_path / "ad.gguf" if mode != "full" else None, **kw)
    jstats = jft.distill_depthany(teacher, student, images, tmp_path / "jd.gguf", steps=1, **kw)
    assert abs(stats["first_loss"] - jstats["first_loss"]) <= LOSS_RTOL * jstats["first_loss"]
    assert stats["steps"] == 2 and np.isfinite(stats["last_loss"])
    f = GGUFFile(str(tmp_path / "d.gguf"))
    assert f.arch == "depthanything" and not any(".lora_" in n for n in f.tensors)
    if mode != "full":
        ad = GGUFFile(str(tmp_path / "ad.gguf"))
        assert ad.metadata["adapter.type"] == "lora" and stats["lora_out"] == str(tmp_path / "ad.gguf")
        assert any(np.abs(ad.tensor(n)).max() > 0 for n in ad.tensors if n.endswith(".lora_b"))
    model = depthany_load_model(str(tmp_path / "d.gguf"), backend_init("cpu"))
    depth = model.compute(Image(np.zeros((30, 31, 3), np.uint8), ImageFormat.rgb_u8))
    assert depth.extent == (31, 30)


def test_distill_validation(tmp_path):
    teacher, student = depth_ggufs(tmp_path)
    images = ft.list_images([str(img_dir(tmp_path))])
    dev = backend_init("cpu")
    for kw, msg in ((dict(size=30), "multiple of the patch"), (dict(qlora=True), "qlora requires lora_rank"),
                    (dict(lora_rank=2, trainable=".*"), "either lora_rank or trainable"),
                    (dict(steps=0), "steps and batch")):
        with pytest.raises(VispError, match=msg):
            ft.distill_depthany(teacher, student, images, tmp_path / "x.gguf", device=dev, **{"steps": 1, **kw})
    with pytest.raises(VispError):
        ft.distill_depthany(esrgan_gguf(tmp_path), student, images, tmp_path / "x.gguf", steps=1, device=dev)


def test_cli_finetune_and_its_esrgan_flag_errors(tmp_path, capsys):
    src = esrgan_gguf(tmp_path)
    d = img_dir(tmp_path)
    out = tmp_path / "t.gguf"
    rc = main(["finetune", "-m", src, "-i", str(d), "-o", str(out), "--steps", "2", "--batch", "2", "--patch", "8",
               "--ema", "0.9", "-b", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and out.exists() and re.search(r"loss [0-9.]+ -> [0-9.]+ over 2 steps \(3 images\)", text)
    # the flags of the BiRefNet recipe and distill raise for ESRGAN, not dropped
    for flags in (["--lora", "2"], ["--lora-out", str(tmp_path / "a.gguf")], ["--qlora"], ["--masks", str(d)]):
        rc = main(["finetune", "-m", src, "-i", str(d), "-o", str(out), "--steps", "1", "-b", "cpu", *flags])
        err = capsys.readouterr().err
        assert rc == 1 and "apply to the birefnet recipe and distill only" in err and flags[0] in err
    assert main(["finetune", "-m", src, "-i", str(d), "--steps", "0", "-b", "cpu"]) == 1
    assert "--steps and --batch must be >= 1" in capsys.readouterr().err


def test_cli_distill_lora_and_adapter_flag(tmp_path, capsys, monkeypatch):
    """distill with --lora --qlora --lora-out writes the merged student and
    the adapter file; --adapter then merges that file into the student for a
    model verb, whose output equals the merged file's."""
    teacher, student = depth_ggufs(tmp_path)
    d = img_dir(tmp_path, size=(30, 30))
    monkeypatch.chdir(tmp_path)
    rc = main(["distill", "-m", teacher, "--student", student, "-i", str(d), "--steps", "2", "--batch", "2",
               "--size", "28", "--lr", "5e-2", "--lora", "2", "--qlora", "--lora-out", "ad.gguf", "-b", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and (tmp_path / "distilled.gguf").exists() and (tmp_path / "ad.gguf").exists()
    assert "-> ad.gguf (adapters)" in text and "over 2 steps" in text
    img = str(d / "im0.png")
    assert main(["depthany", "-m", student, "-i", img, "-o", "with.png", "--adapter", "ad.gguf", "-b", "cpu"]) == 0
    from vision_tpu_torch.api import merge_adapter

    merge_adapter(student, "ad.gguf", dst="merged.gguf")
    assert main(["depthany", "-m", "merged.gguf", "-i", img, "-o", "merged.png", "-b", "cpu"]) == 0
    assert (tmp_path / "with.png").read_bytes() == (tmp_path / "merged.png").read_bytes()
    assert main(["depthany", "-m", student, "-i", img, "--adapter", "missing.gguf", "-b", "cpu"]) == 1
    assert "Adapter file not found" in capsys.readouterr().err
    assert main(["distill", "-m", teacher, "-i", str(d), "-b", "cpu"]) == 1
    assert "--student <gguf> is required" in capsys.readouterr().err
