"""The port's BiRefNet mask fine-tune (vision_tpu_torch/finetune.py
finetune_birefnet, mask_loss; the ``finetune --masks`` verb) against the JAX
package's: the (image, mask) pipeline, and the first step's loss (relative
1e-5) and every leaf's gradient (relative RMS 1e-4) of the BCE + soft-IoU
loss through the whole model (SWIN with its masked window attention, the
deformable ASPP decoder with its BatchNorms) on the tiny twin of
tests/test_birefnet.py at 64x64, augmentation off (its draws differ
between the packages). This file is apart from test_torch_finetune.py
because the JAX side is slow to build: its 20 exact deformable convs unroll
300 bilinear taps. Jitted whole, the decoder's autodiff compiles for several
minutes on the CPU, so the decoder runs op by op (about 10^5 small programs,
compiled with XLA's optimisations off) and only the encoder is jitted. Then
the port's recipe and verb."""

import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_birefnet import SWIN_TEST, TBirefnet
from test_torch_api import write_family_gguf
from test_torch_finetune import assert_step_matches, img_dir
from vision_tpu import finetune as jft
from vision_tpu.core.params import Params as JParams
from vision_tpu.models import birefnet as jbiref
from vision_tpu.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from vision_tpu_torch import finetune as ft
from vision_tpu_torch.cli import main
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.core.gguf import GGUFFile
from vision_tpu_torch.image import Image, ImageFormat, image_save
from vision_tpu_torch.models import birefnet
from vision_tpu_torch.models.swin import SwinLayerParams, SwinParams
from workbench import randomize, state_dict_to_params
from torch_threads import torch_threads  # noqa: F401


def mask_dir(tmp_path, stems, size=(30, 30), seed=1):
    d = tmp_path / "masks"
    d.mkdir()
    rng = np.random.default_rng(seed)
    for s in stems:
        a = ((rng.random((*size, 1)) > 0.5) * 255).astype(np.uint8)
        image_save(Image(a, ImageFormat.alpha_u8), str(d / f"{s}.png"))
    return d


@contextlib.contextmanager
def _unoptimized_jax():
    """XLA's optimisations off for the programs compiled inside: the JAX
    side of the first step compiles thousands of small programs that each
    run once, where optimising costs more than it saves."""
    was = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


def test_mask_pipeline_matches_jax(tmp_path):
    d = img_dir(tmp_path, size=(30, 31))
    md = mask_dir(tmp_path, [f"im{i}" for i in range(3)])
    from vision_tpu_torch.bulk import pair_masks

    for pair in pair_masks(ft.list_images([str(d)]), str(md)):
        ours, theirs = ft._mask_load(64)(pair), jft._mask_load(64)(pair)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_birefnet_first_step_matches_jax():
    """One (image, mask) batch, augmentation off: the port's mask_loss and its
    gradients (through WindowAttentionFn, DeformConvFn and the ASPP's
    autograd-safe form) against jax.value_and_grad of the JAX recipe's
    loss."""
    store = state_dict_to_params(randomize(TBirefnet()).state_dict())
    rng = np.random.default_rng(0)
    x = rng.random((1, 64, 64, 3), dtype=np.float32)
    m = (rng.random((1, 64, 64, 1)) > 0.5).astype(np.float32)
    enc = SwinParams(SWIN_TEST.embed_dim, SWIN_TEST.window_size,
                     tuple(SwinLayerParams(lp.depth, lp.n_heads, lp.n_features) for lp in SWIN_TEST.layers))
    bp = birefnet.BirefnetParams(image_size=64, image_extent=(64, 64), encoder=enc)
    t = {k: torch.tensor(v, requires_grad=True) for k, v in store.items()}
    loss = ft.mask_loss(bp, augment=False)(t, (torch.from_numpy(x), torch.from_numpy(m), (0, 1), torch.arange(1)))
    grads = torch.autograd.grad(loss, list(t.values()))
    ours = float(loss.detach()), {k: g.numpy() for k, g in zip(t, grads)}

    xn = (x - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD, np.float32)
    st = {k: jnp.asarray(v) for k, v in store.items()}

    def head(s, feats):  # the rest of birefnet_predict and the JAX recipe's loss
        f = list(feats)
        f[3] = jbiref.basic_decoder_block(JParams(s)["squeeze_module"][0], f[3], None)
        pm = jbiref.decode(JParams(s)["decoder"], xn, f, None)
        eps = 1e-6
        bce = -jnp.mean(m * jnp.log(pm + eps) + (1 - m) * jnp.log(1 - pm + eps))
        inter = jnp.sum(pm * m, axis=(1, 2, 3))
        union = jnp.sum(pm, axis=(1, 2, 3)) + jnp.sum(m, axis=(1, 2, 3)) - inter
        return bce + (1.0 - jnp.mean((inter + 1.0) / (union + 1.0)))

    with _unoptimized_jax():
        feats, enc_vjp = jax.vjp(jax.jit(lambda s: jbiref.encode(JParams(s), xn, SWIN_TEST)), st)
        jloss, (g_head, g_feats) = jax.value_and_grad(head, argnums=(0, 1))(st, feats)
        (g_enc,) = enc_vjp(g_feats)
    theirs = float(jloss), {k: np.asarray(g_head[k]) + np.asarray(g_enc[k]) for k in st}
    assert_step_matches(ours, theirs)


def test_finetune_birefnet_trains_exports_and_reproduces(tmp_path):
    """The recipe on SWIN-T "tiny" at 64x64 with augmentation: trains (finite
    losses, float weights moved, the BatchNorm's among them), exports a GGUF
    that loads through the model path; one seed, one result; LoRA trains
    only adapters and saves them."""
    src = write_family_gguf("birefnet", tmp_path)
    d = img_dir(tmp_path, size=(30, 30))
    md = mask_dir(tmp_path, [f"im{i}" for i in range(3)])
    images = ft.list_images([str(d)])
    dev = backend_init("cpu")
    kw = dict(masks=str(md), steps=2, lr=1e-3, batch=2, size=50, device=dev)
    lines = []
    stats = ft.finetune_birefnet(src, images, tmp_path / "a.gguf", log=lines.append, **kw)
    assert "size 50 -> 64 (model grid: multiples of 32)" in lines[0]
    assert stats["steps"] == 2 and np.isfinite(stats["first_loss"]) and np.isfinite(stats["last_loss"])
    a, s = GGUFFile(str(tmp_path / "a.gguf")), GGUFFile(src)
    moved = {n for n in s.tensors if not np.array_equal(s.tensor(n, np.float32), a.tensor(n, np.float32))}
    assert any(".bn." in n for n in moved) and any("relative_position_bias_table" in n for n in moved)
    model = birefnet.birefnet_load_model(str(tmp_path / "a.gguf"), dev)
    assert model.compute(Image(np.zeros((40, 50, 3), np.uint8), ImageFormat.rgb_u8)).extent == (50, 40)
    again = ft.finetune_birefnet(src, images, tmp_path / "b.gguf", **kw)
    assert again["last_loss"] == stats["last_loss"]
    b = GGUFFile(str(tmp_path / "b.gguf"))
    for n in a.tensors:
        np.testing.assert_array_equal(a.tensor(n), b.tensor(n))
    lo = ft.finetune_birefnet(src, images, tmp_path / "l.gguf", lora_rank=2, lora_out=tmp_path / "ad.gguf", **kw)
    assert lo["lora_out"] == str(tmp_path / "ad.gguf")
    assert GGUFFile(str(tmp_path / "ad.gguf")).metadata["adapter.type"] == "lora"
    with pytest.raises(VispError, match="masks"):
        ft.finetune_birefnet(src, images, tmp_path / "x.gguf", steps=1, device=dev)


def test_cli_finetune_birefnet_masks(tmp_path, capsys):
    src = write_family_gguf("birefnet", tmp_path)
    d = img_dir(tmp_path, size=(30, 30))
    md = mask_dir(tmp_path, [f"im{i}" for i in range(3)])
    out = tmp_path / "t.gguf"
    rc = main(["finetune", "-m", src, "-i", str(d), "-o", str(out), "--masks", str(md), "--steps", "2", "--batch",
               "2", "--size", "40", "--no-augment", "-b", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and out.exists() and "size 40 -> 64" in text
    assert re.search(r"loss [0-9.]+ -> [0-9.]+ over 2 steps \(3 images\)", text)
    bad = tmp_path / "badmasks"
    bad.mkdir()
    (bad / "im0.png").write_bytes((md / "im0.png").read_bytes())
    rc = main(["finetune", "-m", src, "-i", str(d), "-o", str(out), "--masks", str(bad), "-b", "cpu"])
    captured = capsys.readouterr()
    assert rc == 1 and "Using device" not in captured.out  # fails before the device starts
