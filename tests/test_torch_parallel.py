"""The port's parallel/ (vision_tpu_torch/parallel) against the JAX package's
vision_tpu/parallel, on a gloo world of 4 CPU ranks.

One world is started per module (tests/torch_mesh_ranks.py, suite
``parallel``; its ranks import no JAX) and runs every check there; the
JAX side runs here, on its 8 virtual CPU devices (tests/conftest.py),
while the ranks work. The cases follow tests/test_parallel.py: make_mesh
shapes and errors, shard_params placements (with the head-misaligned
names the port leaves replicated), _resolve_batch with a mesh,
pipeline_apply on toy stages, sharded_forward and training_step, and
init_distributed's idempotence; a single process without a group is
checked in a subprocess. Beside the world, two more subprocesses run
while the JAX side works: ``dryrun_multichip(4, device="cpu")`` and the
CLI's ``depthany -i DIR --dp 2 -b cpu`` (its rank 1 started by the CLI),
held against the one-rank run; and the CLI's refusals of ``--dp`` run
here."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_api import sample_image, write_family_gguf
from torch_mesh_ranks import (
    DINO_HEADS,
    World,
    dino_attention_params,
    dino_input,
    pipeline_inputs,
    sam3_case,
)
from vision_tpu.core.params import Params as JParams
from vision_tpu.models.dino import self_attention as jself_attention
from vision_tpu.ops import nn as jnn
from vision_tpu.parallel import (
    SAM3_TP_RULES as JSAM3_TP_RULES,
    make_mesh as jmake_mesh,
    pipeline_apply as jpipeline_apply,
    shard_params as jshard_params,
    sharded_forward as jsharded_forward,
    training_step as jtraining_step,
)
from vision_tpu.serve import _resolve_batch as jresolve_batch
from vision_tpu_torch.models.random_weights import (
    random_birefnet_params,
    random_depth_anything_params,
    random_mobile_sam_params,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

REL_RMS = 1e-4  # tests/test_golden.py:23

SINGLE = r"""
import torch
from vision_tpu_torch.core.device import BackendType, Device
from vision_tpu_torch.parallel import init_distributed, make_mesh
from vision_tpu_torch.parallel.sharding import mesh_params, mesh_shape
import torch.distributed as dist

def err(fn):
    try:
        fn()
    except Exception as e:
        return str(e)
mesh = make_mesh(1, device="cpu")
print("SHAPE", mesh_shape(mesh))
print("WORLD", dist.get_world_size())
print("TWO", err(lambda: make_mesh(2, device="cpu")))
if not torch.cuda.is_available():
    print("CUDA", err(lambda: make_mesh(1, device="cuda")))
init_distributed("tcp://localhost:1", 4, 2, device="cpu")  # a live group stays as it is
print("AGAIN", dist.get_world_size(), dist.get_rank())
card = Device(torch.device("cuda"), BackendType.gpu)
print("CPUMESH", err(lambda: mesh_params({"w": torch.zeros(2)}, mesh, card)))
"""


ROOT = Path(__file__).resolve().parent.parent


def _popen(args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "VISP_DIST_TIMEOUT": "120"}
    return subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=cwd, env=env)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world, the single-process check, the dry run and the CLI's
    --dp 2 directory run, all started at once."""
    tmp = tmp_path_factory.mktemp("mesh")
    out = {"world": World("parallel", 4, tmp), "single": _popen([sys.executable, "-c", SINGLE], tmp), "tmp": tmp}
    out["dryrun"] = _popen([sys.executable, "-c", "from vision_tpu_torch.parallel import dryrun_multichip; "
                            "dryrun_multichip(4, device='cpu')"], tmp)
    out["gguf"] = write_family_gguf("depthany", tmp)
    out["src"] = src = tmp / "images"
    src.mkdir()
    from vision_tpu_torch.image import Image, ImageFormat, image_save

    for i in range(3):
        image_save(Image(np.roll(sample_image(), 7 * i, 1), ImageFormat.rgb_u8), str(src / f"im{i}.png"))
    out["cli"] = [sys.executable, "-m", "vision_tpu_torch.cli", "depthany", "-m", out["gguf"], "-i", str(src),
                  "-b", "cpu"]
    out["cli_dp"] = _popen(out["cli"] + ["-o", str(tmp / "dp"), "--dp", "2"], tmp)
    return out


@pytest.fixture(scope="module")
def jax_side(world):
    """The JAX package's side, computed while the ranks run."""
    out = {}
    # shard_params' specs at tp 2 and 4
    sam3_store, _, _ = sam3_case()
    stores = {"sam": (random_mobile_sam_params(0), None), "birefnet": (random_birefnet_params("tiny", 0), None),
              "sam3": (sam3_store, JSAM3_TP_RULES), "depthany": (random_depth_anything_params("test"), None)}
    out["specs"] = {}
    for tp in (2, 4):
        mesh = jmake_mesh(8, tp=tp)
        for fam, (store, rules) in stores.items():
            sharded = jshard_params(store, mesh, rules) if rules else jshard_params(store, mesh)
            out["specs"][(fam, tp)] = {k: v.sharding.spec for k, v in sharded.items()}
    # pipeline
    w, b, xs = pipeline_inputs()
    ref = xs
    for i in range(4):
        ref = np.tanh(ref @ w[i] + b[i])
    out["pipeline_ref"] = ref
    out["pipeline"] = np.asarray(jpipeline_apply(lambda ws, x: jnp.tanh(x @ ws["w"] + ws["b"]),
                                                 {"w": w, "b": b}, xs, jmake_mesh(8, pp=4, tp=2)))
    errs = {}
    for key, fn in {
        "stages": lambda: jpipeline_apply(lambda ws, x: x, {"w": w[:3], "b": b}, xs, jmake_mesh(4, pp=4)),
        "empty": lambda: jpipeline_apply(lambda ws, x: x, {"w": w, "b": b}, xs[:0], jmake_mesh(4, pp=4)),
        "axis": lambda: jpipeline_apply(lambda ws, x: x, {"w": w, "b": b}, xs, jmake_mesh(4, pp=4), axis="xx"),
    }.items():
        with pytest.raises(ValueError) as e:
            fn()
        errs[key] = str(e.value)
    out["pipeline_errors"] = errs
    # sharded_forward and training_step at dp 2 x tp 2
    mesh = jmake_mesh(4, tp=2)
    params = dino_attention_params()
    x = dino_input()

    def block(weights, xx):
        p = JParams(weights)
        y = xx + jself_attention(p["attention"], xx, DINO_HEADS, flash=False)
        return y + jnn.linear(p["mlp.fc2"], jnn.gelu(jnn.linear(p["mlp.fc1"], y)))

    out["forward_ref"] = np.asarray(block(params, x))
    sharded = jshard_params(params, mesh)
    out["sharded_specs"] = {k: v.sharding.spec for k, v in sharded.items()}
    out["sharded_forward"] = np.asarray(jsharded_forward(block, mesh)(sharded, jnp.asarray(x)))
    step = jtraining_step(lambda weights, batch: jnp.mean(block(weights, batch) ** 2), mesh, lr=0.1)
    with mesh:
        loss, new = step(jshard_params(params, mesh), jnp.asarray(x))
    out["train_loss"] = float(loss)
    out["train_params"] = {k: np.asarray(v) for k, v in new.items()}
    out["mesh_shapes"] = {k: dict(jmake_mesh(m, tp=t, sp=s, pp=p).shape) for k, (m, t, s, p) in MESH_CASES.items()}
    out["resolve"] = {"none,6": jresolve_batch(None, 6, jmake_mesh(4)), "none,8": jresolve_batch(None, 8, jmake_mesh(4)),
                      "8,6": jresolve_batch(8, 6, jmake_mesh(4)), "none,6,nomesh": jresolve_batch(None, 6, None),
                      "4,6,nomesh": jresolve_batch(4, 6, None)}
    return out


MESH_CASES = {"4,tp2": (4, 2, 1, 1), "4": (4, 1, 1, 1), "4,tp2,sp2": (4, 2, 2, 1), "4,pp2,tp2": (4, 2, 1, 2),
              "2": (2, 1, 1, 1), "4,tp4": (4, 4, 1, 1)}


@pytest.fixture(scope="module")
def r(world, jax_side):
    return world["world"].results()


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12))


def _spec_dim(spec) -> int | None:
    """A JAX PartitionSpec's tp dimension, or None (replicated)."""
    for i, ax in enumerate(spec):
        if ax == "tp":
            return i
    return None


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_make_mesh_shapes_match_jax(r, jax_side, case):
    assert r["mesh_shapes"][case] == jax_side["mesh_shapes"][case]


def test_make_mesh_errors(r):
    """The JAX package's checks and texts (vision_tpu/parallel/sharding.py:135-146)."""
    e = r["mesh_errors"]
    assert e["4,tp3"] == "VispError: make_mesh: n_devices 4 not divisible by pp 1 * sp 1 * tp 3"
    assert e["8"] == "VispError: make_mesh: need 8 devices, have 4"
    assert e["0"] == "VispError: make_mesh: need n_devices >= 1 and tp/sp/pp >= 1, got 0 / 1 / 1 / 1"
    assert e["4,tp0"] == "VispError: make_mesh: need n_devices >= 1 and tp/sp/pp >= 1, got 4 / 0 / 1 / 1"
    assert r["in_sub_mesh"] == [True, True, False, False]  # make_mesh(2) takes ranks 0 and 1


def test_what_the_serving_meshes_refuse(r):
    """A served model takes dp and tp only (SAM3, which takes sp and pp too,
    is held in test_torch_sam3_scan.py); a CUDA model on a CPU mesh is
    refused, and so is a meshed export of any family but SAM, with the JAX
    package's reason."""
    e = r["refusals"]
    assert e["served sp"] == "VispError: serving meshes take dp and tp axes only, got {'dp': 2, 'pp': 1, 'sp': 2, 'tp': 1}"
    assert e["cuda model"] == "VispError: a cpu mesh needs a cpu model, got cuda"
    assert e["export"] == ("VispError: export_model: meshed DepthAnythingModel doesn't export — dp-sharded export is "
                           "supported for SamModel only; construct without a mesh and shard at the call site")


def test_single_process_world_and_idempotent_init(world, r):
    """A process without a group gets a world of one; a CUDA mesh without
    cards and a mesh over the ranks there are raise; a second
    init_distributed leaves the live group as it is; a CUDA model on a CPU
    mesh raises (no rank runs on the CPU unless asked)."""
    out, _ = world["single"].communicate(timeout=120)
    assert world["single"].returncode == 0, out
    lines = dict(line.split(" ", 1) for line in out.splitlines() if line.split(" ", 1)[0].isupper())
    assert lines["SHAPE"] == "{'dp': 1, 'pp': 1, 'sp': 1, 'tp': 1}"
    assert lines["WORLD"] == "1"
    assert lines["TWO"] == "make_mesh: need 2 devices, have 1"
    if "CUDA" in lines:
        assert lines["CUDA"] == "make_mesh: need 1 devices, have 0"
    assert lines["AGAIN"] == "1 0"
    assert lines["CPUMESH"] == "a cpu mesh needs a cpu model, got cuda"
    assert r["world_after_second_init"] == 4


# head-misaligned attention weights: JAX shards them (XLA reshards after),
# the port keeps them whole so that every rank holds whole heads
def _misaligned(fam: str, tp: int) -> set:
    names = ("qkv.weight", "qkv.bias", "proj.weight")
    if fam == "sam":  # TinyViT heads per stage 2 / 4 / 5 / 10 (stage 0 is MBConv)
        stages = {2: [(2, 6)], 4: [(2, 6), (3, 2)]}[tp]
        return {f"enc.layers.{s}.blocks.{b}.attn.{n}" for s, depth in stages for b in range(depth) for n in names}
    if fam == "birefnet":  # SWIN-T heads per stage 3 / 6 / 12 / 24
        stages = {2: [0], 4: [0, 1]}[tp]
        return {f"bb.layers.{s}.blocks.{b}.attn.{n}" for s in stages for b in range(2) for n in names}
    if fam == "depthany" and tp == 4:  # 2 heads
        return {f"backbone.encoder.layer.{i}.attention.{n}" for i in range(4)
                for n in ("attention.query.weight", "attention.query.bias", "attention.key.weight",
                          "attention.key.bias", "attention.value.weight", "attention.value.bias",
                          "output.dense.weight")}
    return set()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("fam", ["sam", "birefnet", "sam3", "depthany"])
def test_shard_params_shards_what_jax_shards(r, jax_side, fam, tp):
    """shard_params places Shard(d) exactly where the JAX rules place
    P(.., "tp", ..) on the same dimension, except the head-misaligned
    attention weights listed above, which stay replicated; every local
    shard, put back together (fused qkv rows un-regrouped), is the weight."""
    port = r["placements"][(fam, tp)]
    jaxs = {k: _spec_dim(v) for k, v in jax_side["specs"][(fam, tp)].items()}
    assert set(port) == set(jaxs)
    differ = {k for k in port if port[k] != jaxs[k]}
    assert differ == _misaligned(fam, tp)
    assert all(port[k] is None and jaxs[k] is not None for k in differ)
    assert sum(d is not None for d in port.values()) > 0
    assert r["regroup_ok"][(fam, tp)]


def test_resolve_batch_with_a_mesh(r, jax_side):
    """tests/test_serve.py:539-552: the per-card default times dp; an
    explicit size must divide by dp."""
    for k, v in jax_side["resolve"].items():
        assert r["resolve"][k] == v, k
    assert r["resolve"]["none,6"] == 24 and r["resolve"]["none,8"] == 32
    assert r["resolve"]["6,6"] == "ValueError: batch_size 6 not divisible by mesh dp=4"
    assert r["resolve"]["0,6"] == "ValueError: batch_size must be >= 1, got 0"


@pytest.mark.parametrize("case", ["pp4", "pp2,tp2", "pp4,placed"])
def test_pipeline_apply_matches_jax(r, jax_side, case):
    """GPipe over the pp group equals the stages applied in turn and the
    JAX package's pipeline_apply (tests/test_parallel.py:368), with idle tp
    ranks, two layers a stage, and stage-placed DTensor weights."""
    got = r["pipeline"][case]
    np.testing.assert_allclose(got, jax_side["pipeline_ref"], atol=1e-5)
    assert _rel_rms(got, jax_side["pipeline"]) < REL_RMS


@pytest.mark.parametrize("case", ["axis", "stages", "empty"])
def test_pipeline_apply_errors_match_jax(r, jax_side, case):
    got, want = r["pipeline_errors"][case], jax_side["pipeline_errors"][case]
    assert got.startswith("ValueError: ")
    if case == "axis":  # the texts name each package's mesh
        assert re.sub(r":.*", "", got[12:]) == re.sub(r":.*", "", want) == "mesh has no 'xx' axis"
    else:
        assert got[12:] == want


def test_sharded_forward_matches_jax(r, jax_side):
    """A DINOv2 attention + MLP block over dp 2 x tp 2: q/k/v and fc1
    column-parallel, output.dense and fc2 row-parallel, as the JAX rules
    place them."""
    assert r["sharded_specs"] == {k: _spec_dim(v) for k, v in jax_side["sharded_specs"].items()}
    got = r["sharded_forward"]
    assert _rel_rms(got, jax_side["sharded_forward"]) < REL_RMS
    assert _rel_rms(got, jax_side["forward_ref"]) < REL_RMS


def test_training_step_matches_jax(r, jax_side):
    """One SGD step over dp 2 x tp 2: the dp-averaged loss and every
    updated weight (tp shards put back together) as the JAX step's."""
    assert abs(r["train_loss"] - jax_side["train_loss"]) <= 1e-5 * abs(jax_side["train_loss"])
    moved = 0
    for k, want in jax_side["train_params"].items():
        got = r["train_params"][k]
        assert _rel_rms(got, want) < REL_RMS, k
        moved += not np.array_equal(got, dino_attention_params()[k])
    assert moved == len(jax_side["train_params"])


def test_dryrun_multichip_on_four_cpu_ranks(world, r):
    """The port of __graft_entry__.dryrun_multichip steps 1-5 on 4 CPU ranks,
    SAM3's sequence- and pipeline-parallel checks among them at the JAX
    dry run's meshes (sp 4; pp 2 x tp 2)."""
    out, _ = world["dryrun"].communicate(timeout=300)
    assert world["dryrun"].returncode == 0, out[-4000:]
    for step in ("SAM3 tp-sharded vision", "SAM3 sequence-parallel vision", "SAM3 pipeline-parallel vision",
                 "dp x tp fsdp train step", "sharded SAM encode", "sharded ESRGAN tiled", "sharded BiRefNet",
                 "MI-GAN dp-served", "Depth-Anything dp x tp-served", "YOLOv9t dp-served", "4 ranks ok"):
        assert f"dryrun {step}" in out, step
    assert "sequence-parallel vision parity ok: mesh={'dp': 1, 'pp': 1, 'sp': 4, 'tp': 1}" in out
    assert "pipeline-parallel vision parity ok: mesh={'dp': 1, 'pp': 2, 'sp': 1, 'tp': 2} microbatches=3" in out


def test_cli_dp_directory_matches_one_rank(world, r):
    """``depthany -i DIR --dp 2 -b cpu`` (rank 1 started by the CLI) writes
    the files the one-rank run writes."""
    out, _ = world["cli_dp"].communicate(timeout=300)
    assert world["cli_dp"].returncode == 0, out[-4000:]
    assert "dp mesh: 2 rank(s) on cpu" in out
    ref = subprocess.run(world["cli"] + ["-o", str(world["tmp"] / "one")], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert ref.returncode == 0, ref.stderr
    names = sorted(p.name for p in (world["tmp"] / "one").iterdir())
    assert names == sorted(p.name for p in (world["tmp"] / "dp").iterdir()) and len(names) == 3
    for name in names:
        assert (world["tmp"] / "dp" / name).read_bytes() == (world["tmp"] / "one" / name).read_bytes()


@pytest.mark.parametrize("cards", [0, 1])
def test_cli_dp_refuses_a_cuda_mesh_with_too_few_cards(world, cards, monkeypatch, capsys):
    """``--dp 2`` on the card (no -b) with no card or one: make_mesh's
    message, before any rank starts; ``finetune --dp`` with a batch that
    does not divide by it is refused before any device starts; ``--dp`` on
    a single image names the inputs it applies to."""
    import vision_tpu_torch.cli as tcli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    args = ["-m", world["gguf"], "-i", str(world["src"]), "-o", str(world["tmp"] / f"never{cards}"), "--dp", "2"]
    assert tcli.main(["depthany", *args]) == 1
    assert f"make_mesh: need 2 devices, have {cards}" in capsys.readouterr().err
    assert tcli.main(["serve", *args[:2], "--dp", "2"]) == 1
    assert f"make_mesh: need 2 devices, have {cards}" in capsys.readouterr().err
    assert tcli.main(["finetune", "-m", world["gguf"], "-i", str(world["src"]), "--dp", "2", "--batch", "3", "-b",
                      "cpu"]) == 1
    assert "--batch 3 must be divisible by --dp 2" in capsys.readouterr().err
    one = str(world["src"] / "im0.png")
    assert tcli.main(["depthany", "-m", world["gguf"], "-i", one, "--dp", "2", "-b", "cpu"]) == 1
    assert "--dp applies to serve and to directory and video inputs" in capsys.readouterr().err
