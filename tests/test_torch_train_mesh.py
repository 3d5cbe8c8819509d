"""The port's training meshes (vision_tpu_torch/train.py, finetune.py and
export.py over parallel/) against the JAX package's, on one gloo world of 8
CPU ranks, dp 4 x tp 2 as the JAX package's ``make_mesh(8, tp=2)``.

The world (tests/torch_mesh_ranks.py, suite ``train``; its ranks import no
JAX) runs every meshed case; the JAX side runs here, on its 8 virtual CPU
devices, while the ranks work, on the same numpy inputs. The cases follow
tests/test_train.py (the fsdp step :149, mesh parity and a sharded restore
:378, prefetch placements and the accumulated step :289, :305),
tests/test_lora.py:270 (LoRA on a dp mesh), a DINOv2 SGD step over dp x tp
(the gradients through the tp operators), the three recipes at twin width
on a dp-4 mesh against one rank, and tests/test_export.py:238-300 (the
meshed SAM export, ``call_sharded`` and the refusals). Beside the world,
the CLI's ``finetune --dp 2 -b cpu`` runs (its rank 1 started by the CLI)
and its ``--dp 1`` run (which ``chip_smoke.py`` phase 46 holds byte-equal to
the run without ``--dp`` on the card). Tolerances are
tests/test_torch_train.py's: loss rtol 1e-5, parameters ``PARAM_ATOL`` (a
few x lr); where both sides are the port, the JAX tests' own parity bounds.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_api import write_family_gguf
from torch_mesh_ranks import (
    DINO_LOSS_CHANNELS,
    RECIPE_BATCH,
    RECIPE_LR,
    SAM_EXPORT_LAYERS,
    SAM_EXPORT_SIZE,
    TRAIN_LR,
    World,
    dino_train_batch,
    fsdp_problem,
    lora_problem,
    sam_export_frames,
    train_problem,
)
from vision_tpu import train as jtrain
from vision_tpu.core.params import Params as JParams
from vision_tpu.export import export_model as jexport_model, load_bundle as jload_bundle
from vision_tpu.lora import LORA_TRAINABLE, add_lora as jadd_lora
from vision_tpu.models.dino import dino_get_intermediate_layers as jdino_layers
from vision_tpu.ops.nn import linear as jlinear
from vision_tpu.parallel import make_mesh as jmake_mesh
from vision_tpu_torch import finetune as ft
from vision_tpu_torch.core.gguf import GGUFFile
from vision_tpu_torch.parallel.dryrun import train_case

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

LOSS_RTOL = 1e-5  # tests/test_torch_train.py
PARAM_ATOL = 3 * TRAIN_LR  # tests/test_torch_train.py: a few x lr
RECIPE_ATOL = 3 * RECIPE_LR
CLI_ATOL = 3 * 1e-4  # a few x the CLI's --lr default
ROOT = Path(__file__).resolve().parent.parent


def _popen(args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "VISP_DIST_TIMEOUT": "120", "OMP_NUM_THREADS": "2"}
    return subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=cwd, env=env)


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-30))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The twins' GGUFs and a folder of images and masks, then the world
    and the CLI's runs (--dp 2, --dp 1), started at once."""
    from vision_tpu_torch.image import Image, ImageFormat, image_save

    tmp = tmp_path_factory.mktemp("train_mesh")
    for family in ("esrgan", "birefnet", "depthany"):
        write_family_gguf(family, tmp)
    (tmp / "imgs").mkdir()
    (tmp / "masks").mkdir()
    rng = np.random.default_rng(0)
    for i in range(RECIPE_BATCH):
        image_save(Image(rng.integers(0, 256, (48, 64, 3), np.uint8), ImageFormat.rgb_u8),
                   str(tmp / "imgs" / f"im{i}.png"))
        image_save(Image((rng.random((48, 64, 1)) > 0.5).astype(np.uint8) * 255, ImageFormat.alpha_u8),
                   str(tmp / "masks" / f"im{i}.png"))
    out = {"tmp": tmp, "world": World("train", 8, tmp, timeout=400)}
    out["cli"] = [sys.executable, "-m", "vision_tpu_torch.cli", "finetune", "-m", str(tmp / "esrgan.gguf"), "-i",
                  str(tmp / "imgs"), "--steps", "2", "--batch", "2", "--patch", "8", "-b", "cpu"]
    for name, extra in (("dp2", ["--dp", "2"]), ("dp1", ["--dp", "1"])):
        out[f"cli_{name}"] = _popen(out["cli"] + ["-o", str(tmp / f"cli-{name}.gguf")] + extra, tmp)
    return out


@pytest.fixture(scope="module")
def r(world):
    return world["world"].results()


def _jstep(loss, opt, params, batch, steps, mesh=None, **kw):
    state = jtrain.create_train_state(params, opt, mesh=mesh, **kw)
    step = jtrain.make_train_step(loss, opt, mesh=mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, {k: np.asarray(v, np.float32) for k, v in state.params.items()}


@pytest.fixture(scope="module")
def jax_side(world):
    """The JAX package's steps on the same problems, while the ranks run."""
    out = {}
    mesh = jmake_mesh(8, tp=2)

    def linear_loss(p, batch):
        x, y = batch
        return jnp.mean((x @ p["head.w.weight"].T + p["head.w.bias"] - y) ** 2)

    def fsdp_loss(p, batch):
        x, y = batch
        return jnp.mean((x @ p["head.w.weight"].T - y) ** 2) + 1e-3 * jnp.mean(p["big.table"] ** 2)

    params, batch = fsdp_problem()
    out["fsdp"] = _jstep(fsdp_loss, optax.adam(1e-2), params, batch, 2, mesh, fsdp=True, fsdp_min_size=1024)
    params, batch = train_problem()
    out["parity"] = _jstep(linear_loss, optax.adam(TRAIN_LR), params, batch, 2, mesh)
    x, y = batch
    acc_state = jtrain.create_train_state(params, optax.sgd(0.1), mesh=mesh)
    (ax,), = list(jtrain.prefetch_to_device(iter([(x.reshape(4, 4, 8),)]), mesh=mesh, accum=4))
    (ay,), = list(jtrain.prefetch_to_device(iter([(y.reshape(4, 4, 4),)]), mesh=mesh, accum=4))
    acc_state, m = jtrain.make_train_step(linear_loss, optax.sgd(0.1), mesh=mesh, accum=4)(acc_state, (ax, ay))
    out["accum"] = (float(m["loss"]), {k: np.asarray(v) for k, v in acc_state.params.items()})

    base, batch = lora_problem()

    def lora_loss(p, b):
        bx, by = b
        h = jax.nn.relu(jlinear(JParams(p)["enc"]["fc1"], bx))
        return jnp.mean((jlinear(JParams(p)["enc"]["fc2"], h) - by) ** 2)

    adapted = jadd_lora(base, rank=4, seed=3)
    state = jtrain.create_train_state(adapted, optax.adam(1e-2), mesh=jmake_mesh(8), trainable=LORA_TRAINABLE)
    step = jtrain.make_train_step(lora_loss, optax.adam(1e-2), mesh=jmake_mesh(8), trainable=LORA_TRAINABLE)
    out["lora_loss"] = []
    for _ in range(3):
        state, m = step(state, batch)
        out["lora_loss"].append(float(m["loss"]))
    out["lora_params"] = {k: np.asarray(v) for k, v in state.params.items() if "lora" in k}

    dparams, dp = train_case()
    from jax.sharding import PartitionSpec as P

    from vision_tpu.parallel.sharding import DEFAULT_TP_RULES

    rules = DEFAULT_TP_RULES + ((r".*\b(query|key|value)\.weight$", P("tp", None)),  # __graft_entry__.py:123-127
                                (r".*\b(query|key|value)\.bias$", P("tp")),
                                (r".*\boutput\.dense\.weight$", P(None, "tp")))

    def dino_loss(weights, xb):
        feats = jdino_layers(JParams(weights), xb, [dp.n_layers - 1], dp)
        return jnp.mean(feats[-1][..., :DINO_LOSS_CHANNELS].astype(jnp.float32) ** 2)

    out["dino"] = _jstep(dino_loss, optax.sgd(1.0), dparams, jnp.asarray(dino_train_batch()), 1, mesh, rules=rules,
                         fsdp=True, fsdp_min_size=1024)

    from vision_tpu.core.device import backend_init as jbackend_init
    from vision_tpu.models.migan import MiganModel as JMigan, MiganParams as JMiganParams
    from vision_tpu.models.random_weights import random_migan_params

    migan = JMigan(random_migan_params(64), JMiganParams(resolution=64), jbackend_init("cpu"))
    migan.mesh = object()  # refused before the mesh is read (tests/test_export.py:238-248)
    try:
        jexport_model(migan, world["tmp"] / "never.vxp", embed_params=False)
    except Exception as e:  # noqa: BLE001 — the message is the reference
        out["migan_refusal"] = f"VispError: {e}"

    # the meshed SAM export on dp 2 and its call_sharded (tests/test_export.py:250-296)
    from vision_tpu.models.mobile_sam import SamModel as JSam, SamParams as JSamParams
    from vision_tpu.models.mobile_sam import TinyVitLayer as JLayer, TinyVitParams as JTinyVit
    from vision_tpu.models.random_weights import random_mobile_sam_params as jrandom_sam

    params = jrandom_sam(seed=0)
    tv = JTinyVit(img_size=SAM_EXPORT_SIZE, layers=tuple(JLayer(*lay) for lay in SAM_EXPORT_LAYERS))
    sam = JSam(params, JSamParams(image_size=SAM_EXPORT_SIZE), jbackend_init("cpu"), mesh=jmake_mesh(2), tiny_vit=tv)
    dst = world["tmp"] / "jax_sam_dp2.vxp"
    jexport_model(sam, dst, batch=2, embed_params=False, entries=("encode",))
    out["sam_export"] = np.asarray(jload_bundle(dst).call_sharded("encode", params, sam_export_frames()), np.float32)
    return out


def _placements(axis: str, dim: int | None) -> list:
    """``str`` of each placement along (dp, pp, sp, tp): ``dim`` sharded over ``axis``, the rest replicated."""
    return [f"S({dim})" if a == axis and dim is not None else "R" for a in ("dp", "pp", "sp", "tp")]


def test_fsdp_step_matches_jax(r, jax_side):
    """tests/test_train.py:149: the table sharded over dp (its Adam slots
    too), the head replicated; two steps as the JAX package's and as the
    port's single-device step. A step gathers the table once, though the
    loss looks it up twice, and reduce-scatters its gradient once."""
    assert r["fsdp_collectives"] == {"all_gather_into_tensor": 1, "reduce_scatter_tensor": 1}
    assert r["fsdp_placements"]["big.table"] == _placements("dp", 0)
    assert r["fsdp_placements"]["head.w.weight"] == _placements("dp", None)
    assert r["fsdp_local"] == (128, 130) and r["fsdp_slots"]["big.table"] == (128, 130)
    jlosses, jparams = jax_side["fsdp"]
    for (got, one), want in zip(r["fsdp_loss"], jlosses):
        assert abs(got - want) <= LOSS_RTOL * abs(want) and abs(got - one) <= 1e-6 * abs(one)
    for k, want in jparams.items():
        np.testing.assert_allclose(r["fsdp_params"][k], want, atol=PARAM_ATOL)
        np.testing.assert_allclose(r["fsdp_params"][k], r["fsdp_ref"][k], rtol=2e-6, atol=2e-7)


def test_mesh_parity_and_sharded_restore(r, jax_side):
    """tests/test_train.py:378: two meshed Adam steps as the JAX package's;
    a restore lands in the saved placements, bit for bit (slots and the
    int buffer too), and steps on to step 3."""
    jlosses, jparams = jax_side["parity"]
    for got, want in zip(r["parity_loss"], jlosses):
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    for k in ("head.w.weight", "head.w.bias"):
        np.testing.assert_allclose(r["parity_params"][k], jparams[k], atol=PARAM_ATOL)
    assert r["restore_placements"] and r["restore_equal"] and r["restore_slots_equal"]
    assert r["restore_buffer"] == [1, 2, 3] and r["restore_step"] == 3


def test_prefetch_placement_and_accumulated_step(r, jax_side):
    """tests/test_train.py:289, 305: prefetch gives each rank its dp rows
    (axis 1 with accum), refuses accum 0; the accumulated mesh step equals
    the full-batch one and the JAX package's."""
    n, placements, local = r["prefetch"]
    assert n == 3 and placements == _placements("dp", 0) and local == (2, 2)
    placements, local = r["prefetch_accum"]
    assert placements == _placements("dp", 1) and local == (3, 1, 8)
    assert "size and accum must be >= 1" in r["prefetch_bad"]
    full_loss, acc_loss, full, acc = r["accum"]
    jloss, jparams = jax_side["accum"]
    np.testing.assert_allclose(acc["head.w.weight"], full["head.w.weight"], atol=2e-6)
    assert abs(acc_loss - full_loss) <= 1e-6 and abs(acc_loss - jloss) <= LOSS_RTOL * abs(jloss)
    np.testing.assert_allclose(acc["head.w.weight"], jparams["head.w.weight"], atol=PARAM_ATOL)


def test_lora_step_on_a_dp_mesh(r, jax_side):
    """tests/test_lora.py:270: three LoRA steps on dp 8 as on one rank and
    as the JAX package's."""
    for (got, one), want in zip(r["lora_loss"], jax_side["lora_loss"]):
        assert abs(got - one) < 1e-6 and abs(got - want) <= LOSS_RTOL * abs(want)
    np.testing.assert_allclose(r["lora_params"]["enc.fc1.lora_b"], r["lora_single"]["enc.fc1.lora_b"], atol=1e-6,
                               rtol=1e-6)
    for k, want in jax_side["lora_params"].items():
        np.testing.assert_allclose(r["lora_params"][k], want, atol=PARAM_ATOL)


def test_dino_step_over_dp_and_tp_matches_jax(r, jax_side):
    """An SGD step (lr 1) of the dry run's DINOv2 over dp 4 x tp 2 with
    fsdp: q / k / v and fc1 column-parallel, output.dense and fc2
    row-parallel, the patch embedding fsdp-sharded; every update (minus
    the gradient) as the JAX package's, to relative RMS 1e-5. The step
    gathers each fsdp leaf once and reduce-scatters each one's gradient
    once."""
    assert r["dino_fsdp"] > 0
    assert r["dino_collectives"] == {"all_gather_into_tensor": r["dino_fsdp"], "reduce_scatter_tensor": r["dino_fsdp"]}
    pl = r["dino_placements"]
    assert pl["encoder.layer.0.attention.attention.query.weight"] == _placements("tp", 0)
    assert pl["encoder.layer.0.mlp.fc2.weight"] == _placements("tp", 1)
    assert pl["embeddings.patch_embeddings.projection.weight"] == _placements("dp", 0)
    jlosses, jparams = jax_side["dino"]
    assert abs(r["dino_loss"] - jlosses[0]) <= LOSS_RTOL * abs(jlosses[0])
    p0, _ = train_case()
    for k, want in jparams.items():
        got, want = r["dino_params"][k] - p0[k], want - p0[k]
        if k.endswith("key.bias"):  # no gradient: the softmax does not see a shift of every key
            assert np.abs(got).max() < 1e-8 and np.abs(want).max() < 1e-8, k
        else:  # both sides reorder the f32 sums over 8 devices: the loss's relative bound
            assert _rel_rms(got, want) <= LOSS_RTOL, k


def test_recipes_on_a_dp_mesh_match_one_rank(r, world):
    """Real-ESRGAN (with its EMA), BiRefNet (augmented) and the QLoRA
    distillation on a dp-4 mesh, one row a rank: the losses and the
    exported files as one rank's run."""
    for name, (first, last, one_first, one_last) in r["recipes"].items():
        assert abs(first - one_first) <= LOSS_RTOL * abs(one_first), name
        assert abs(last - one_last) <= LOSS_RTOL * abs(one_last), name
        meshed, one = GGUFFile(str(world["tmp"] / f"{name}-dp4.gguf")), GGUFFile(str(world["tmp"] / f"{name}-one.gguf"))
        assert meshed.metadata == one.metadata and sorted(meshed.tensors) == sorted(one.tensors)
        for t in one.tensors:
            np.testing.assert_allclose(meshed.tensor(t, np.float32), one.tensor(t, np.float32), atol=RECIPE_ATOL,
                                       err_msg=f"{name} {t}")
    assert r["recipe_bad_batch"] == "VispError: finetune: batch 3 must be divisible by the mesh's dp 4"


def test_birefnet_augmentation_draws_for_the_global_batch():
    """The BiRefNet recipe's first batch flips some rows and not others, and
    each row of a split batch is augmented as in the whole one: given its
    ``rows`` and the batch's ``total``, ops.augment's random_flip and
    color_jitter draw for the whole batch and apply the row's own draws, as
    mask_loss calls them on a dp rank. A row given another row's index
    gets other draws."""
    from vision_tpu_torch.ops.augment import color_jitter, random_flip

    rng = np.random.default_rng(0)  # finetune_birefnet(seed=0)'s draws: the loader's seed, then the batch's
    rng.integers(2**31)
    seed = int(rng.integers(2**62))
    gen = torch.Generator().manual_seed(seed)
    flips = torch.rand(RECIPE_BATCH, generator=gen) < 0.5
    assert flips.any() and not flips.all(), flips
    data = np.random.default_rng(5)
    x = torch.from_numpy(data.random((RECIPE_BATCH, 16, 16, 3)).astype(np.float32))

    def augment(x, rows=None, total=None):
        gen = torch.Generator().manual_seed(seed)
        return color_jitter(gen, random_flip(gen, x, rows=rows, total=total), 0.2, 0.2, 0.2, rows=rows, total=total)

    whole = augment(x)
    for i in range(RECIPE_BATCH):
        assert torch.equal(augment(x[i:i + 1], torch.tensor([i]), RECIPE_BATCH), whole[i:i + 1]), i
    assert torch.equal(augment(x[2:], torch.arange(2, RECIPE_BATCH), RECIPE_BATCH), whole[2:])
    assert not torch.equal(augment(x[1:2], torch.tensor([0]), RECIPE_BATCH), whole[1:2])


def test_meshed_sam_export_and_call_sharded(r, jax_side):
    """tests/test_export.py:238-300: a dp-2 meshed SamModel exports its
    encode (embed_params=False) with meta["mesh"], one rank's program at
    batch / dp; call_sharded on both ranks equals the JAX package's meshed
    bundle's call_sharded on the same weights and frames (relative RMS
    1e-4, as the model tests hold the port to JAX) and the port's unmeshed
    encode (test_export.py's bound); the JAX package's refusals."""
    names, mesh, inputs, got, want = r["export"]
    assert names == ["encode"] and mesh == {"dp": 2, "pp": 1, "sp": 1, "tp": 1}
    assert inputs[-1] == [[1, SAM_EXPORT_SIZE, SAM_EXPORT_SIZE, 3], "uint8"]
    assert got.shape == want.shape == jax_side["sam_export"].shape
    assert _rel_rms(got, jax_side["sam_export"]) <= 1e-4
    np.testing.assert_allclose(got, want, atol=2e-5)
    e = r["export_refusals"]
    assert e["migan"] == jax_side["migan_refusal"]
    assert "pass embed_params=False" in e["embed"] and "supports dp-only meshes" in e["tp"]
    assert "batch 3 must divide over the mesh dp axis (2)" in e["batch"]
    assert "unknown entries" in r["export_unknown"]


def test_cli_finetune_dp_matches_one_rank(world, r):
    """``finetune --dp 2 -b cpu`` (rank 1 started by the CLI) trains and
    writes what ``--dp 1`` writes, to the recipes' tolerance (a step's
    gradients are summed in another order over two ranks)."""
    tmp = world["tmp"]
    outs = {}
    for name in ("dp2", "dp1"):
        outs[name], _ = world[f"cli_{name}"].communicate(timeout=300)
        assert world[f"cli_{name}"].returncode == 0, outs[name][-4000:]
    assert "dp mesh: 2 rank(s) on cpu" in outs["dp2"] and outs["dp2"].count("\n-> ") == 1  # rank 0 alone reports
    assert "dp mesh: 1 rank(s) on cpu" in outs["dp1"]
    one, dp2 = GGUFFile(str(tmp / "cli-dp1.gguf")), GGUFFile(str(tmp / "cli-dp2.gguf"))
    assert dp2.metadata == one.metadata
    for t in one.tensors:
        np.testing.assert_allclose(dp2.tensor(t, np.float32), one.tensor(t, np.float32), atol=CLI_ATOL)


def test_cli_refuses_a_batch_that_does_not_divide_before_any_device(world, capsys, monkeypatch):
    """``--batch 3 --dp 2`` fails before a rank or device starts (no card
    is asked for, no mesh printed); so does ``distill``'s default batch 4
    over ``--dp 3``."""
    import vision_tpu_torch.cli as tcli

    monkeypatch.setattr(tcli, "_device", lambda args: pytest.fail("a device was started"))
    tmp = world["tmp"]
    assert tcli.main(["finetune", "-m", str(tmp / "esrgan.gguf"), "-i", str(tmp / "imgs"), "--dp", "2", "--batch", "3",
                      "-o", str(tmp / "never.gguf")]) == 1
    err = capsys.readouterr()
    assert "--batch 3 must be divisible by --dp 2" in err.err and "dp mesh" not in err.out
    assert tcli.main(["distill", "-m", str(tmp / "depthany.gguf"), "--student", str(tmp / "depthany.gguf"), "-i",
                      str(tmp / "imgs"), "--dp", "3", "-o", str(tmp / "never.gguf")]) == 1
    assert "--batch 4 must be divisible by --dp 3" in capsys.readouterr().err
    assert not (tmp / "never.gguf").exists()
