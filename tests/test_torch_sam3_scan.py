"""The port's window-major SAM3 trunk (vision_tpu_torch/models/sam3.py:
sam3_window_runs, sam3_pack_vision_weights, vision_transformer_scan,
encode_vision(win_stack=), Sam3Model's stack, the pipeline's stage layout)
against the JAX package's, in f32 on the CPU, at the reduced configuration
of tests/test_parallel.py:246-249 (4 layers of width 64, 4 heads, a 32 px
image in patches of 4: 2x2 windows of 4x4 patches). The meshed forms (sp,
pp) run in the 4-rank world of test_torch_parallel_models.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_ranks import sam3_case
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.params import Params as JParams
from vision_tpu.image import Image as JImage
from vision_tpu.image import ImageFormat as JImageFormat
from vision_tpu.models import sam3 as js3
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models import sam3 as s3

REL_RMS = 1e-4  # tests/test_golden.py:23
MAX_ABS = 2e-5  # tests/test_parallel.py:272 and the JAX dry run's SAM3 checks


def _rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-12))


def _close(got, want, max_abs=MAX_ABS):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert _rel_rms(got, want) < REL_RMS
    assert float(np.abs(got - want).max()) <= max_abs


@pytest.fixture(scope="module")
def case():
    store, _, vp = sam3_case()
    p = params_from_numpy(store, "cpu", torch.float32)
    return {"store": store, "p": p, "vp": s3.Sam3VitParams(**vp), "jvp": js3.Sam3VitParams(**vp),
            "stack": s3.sam3_pack_vision_weights(p, s3.Sam3VitParams(**vp), prefix="backbone."),
            "jstack": js3.sam3_pack_vision_weights(store, js3.Sam3VitParams(**vp), prefix="backbone.")}


def _images(batch: int, side: int = 32) -> np.ndarray:
    return np.random.default_rng(3 + batch).random((batch, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("vp", [
    {},  # ViT-H: 32 layers, globals 7, 15, 23, 31
    dict(n_layers=4, global_attn_indexes=(1, 3)),
    dict(n_layers=5, global_attn_indexes=(0, 2)),
    dict(n_layers=6, global_attn_indexes=(4, 5)),
    dict(n_layers=3, global_attn_indexes=()),
])
def test_window_runs_match_jax(vp):
    assert s3.sam3_window_runs(s3.Sam3VitParams(**vp)) == js3.sam3_window_runs(js3.Sam3VitParams(**vp))


def test_packed_stack_matches_jax(case):
    """One (n_window_layers, ...) tensor a leaf, bit for bit the JAX stack."""
    assert set(case["stack"]) == set(case["jstack"]) == set(s3._SAM3_LAYER_LEAVES)
    for leaf, v in case["stack"].items():
        assert v.shape[0] == 2
        np.testing.assert_array_equal(v.numpy(), np.asarray(case["jstack"][leaf]), err_msg=leaf)


def test_window_layers_are_views_of_the_stack(case):
    layers = s3.window_layers(case["stack"])
    assert len(layers) == 2
    for i, layer in enumerate(layers):
        for leaf, v in layer.items():
            assert v.untyped_storage().data_ptr() == case["stack"][leaf].untyped_storage().data_ptr()
            assert torch.equal(v, case["stack"][leaf][i])


def test_window_major_tables_match_jax(case):
    """The global layers' RoPE tables in window-major token order, as the
    JAX trunk builds them (vision_tpu/models/sam3.py:552-561), and a
    sequence-parallel rank's rows of them."""
    nwh = nww = 2
    win, hd, scale = 4, 16, 4 / 8
    ii, jj, rr, ss = np.meshgrid(np.arange(nwh), np.arange(nww), np.arange(win), np.arange(win), indexing="ij")
    px = ((jj * win + ss).reshape(-1)).astype(np.float64) * scale
    py = ((ii * win + rr).reshape(-1)).astype(np.float64) * scale
    want = js3._rope_tables_pos(px, py, hd)
    got = s3._window_major_tables(nwh, nww, win, hd, scale, torch.device("cpu"), torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # windows 3..5 of a 2-image batch: the last window of image 0, the first two of image 1
    rows = s3._window_rows(nwh, nww, win, hd, scale, 3, 3, torch.device("cpu"), torch.float32)
    for r, w in zip(rows, want):
        np.testing.assert_array_equal(r.numpy(), np.concatenate([w[48:64], w[0:32]]))


@pytest.mark.parametrize("batch", [1, 2])
def test_vision_transformer_scan_matches_jax(case, batch):
    """The trunk at the native grid, batch 1 and 2, from the stack and from
    its per-layer views."""
    x = _images(batch)
    want = js3.vision_transformer_scan(JParams(case["store"])["backbone"], case["jstack"], jnp.asarray(x),
                                       case["jvp"])
    p = Params(case["p"])["backbone"]
    with torch.inference_mode():
        got = s3.vision_transformer_scan(p, case["stack"], torch.from_numpy(x), case["vp"])
        from_views = s3.vision_transformer_scan(p, s3.window_layers(case["stack"]), torch.from_numpy(x), case["vp"])
    assert got.shape == (batch, 8, 8, 64)
    _close(got, want)
    assert torch.equal(from_views, got)


def test_scan_trunk_matches_the_spatial_trunk(case):
    """The same math in another token order: within MAX_ABS of the port's
    spatial trunk on the same weights."""
    x = torch.from_numpy(_images(2))
    p = Params(case["p"])["backbone"]
    with torch.inference_mode():
        _close(s3.vision_transformer_scan(p, case["stack"], x, case["vp"]), s3.vision_transformer(p, x, case["vp"]))


def test_encode_vision_with_win_stack_matches_jax(case):
    """encode_vision(win_stack=) takes the window-major trunk where the grid
    divides into windows, and the spatial one where it does not (a 36 px
    image: a 9x9 grid), as the JAX package dispatches."""
    for side in (32, 36):
        x = _images(1, side)
        want = js3.encode_vision(JParams(case["store"]), jnp.asarray(x), case["jvp"], win_stack=case["jstack"])
        with torch.inference_mode():
            got = s3.encode_vision(Params(case["p"]), torch.from_numpy(x), case["vp"], win_stack=case["stack"])
        assert len(got.fpn_hidden_states) == 4
        for g, w in zip(got.fpn_hidden_states, want.fpn_hidden_states):
            _close(g, w)


def _models(case):
    store = {f"det.ve.{k}": v for k, v in case["store"].items()}
    jm = js3.Sam3Model(store, js3.ClipTokenizer(vocab={}, bpe_rank={}), 8, jax_backend_init("cpu"), vp=case["jvp"])
    caller = params_from_numpy(store, "cpu", torch.float32)
    pm = s3.Sam3Model(caller, s3.ClipTokenizer(vocab={}, bpe_rank={}), 8, backend_init("cpu"), vp=case["vp"])
    return jm, pm, caller


def test_sam3_model_stacks_drops_the_flat_copies_and_matches_jax(case):
    """Sam3Model's first encode stacks the window layers under
    det.ve.backbone.window_stack.* and drops their flat copies from its
    params (the caller's dict keeps them), the global layers stay flat;
    encode_vision runs the window-major trunk, against the JAX package's
    Sam3Model; a model built from the stacked params encodes the same."""
    jm, pm, caller = _models(case)
    window = [f"det.ve.backbone.layers.{i}.{leaf}" for i in (0, 2) for leaf in s3._SAM3_LAYER_LEAVES]
    assert all(k in pm.params for k in window) and pm.scan  # stacked at the first use
    img = np.random.default_rng(14).integers(0, 256, (40, 64, 4), np.uint8)
    got = pm.encode_vision(Image(img, ImageFormat.rgba_u8))
    want = jm.encode_vision(JImage(img, JImageFormat.rgba_u8))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)
    assert not any(k in pm.params for k in window)
    assert all(k in caller for k in window)
    assert all(f"det.ve.backbone.layers.{i}.{leaf}" in pm.params for i in (1, 3) for leaf in s3._SAM3_LAYER_LEAVES)
    stack = {leaf: pm.params[f"det.ve.backbone.window_stack.{leaf}"] for leaf in s3._SAM3_LAYER_LEAVES}
    for leaf, v in stack.items():
        assert torch.equal(v, case["stack"][leaf]), leaf
    again = s3.Sam3Model(pm.params, pm.tokenizer, 8, backend_init("cpu"), vp=case["vp"])
    for a, b in zip(again.encode_vision(Image(img, ImageFormat.rgba_u8)), got):
        assert torch.equal(a, b)
    assert again.params["det.ve.backbone.window_stack.mlp.fc1.weight"] is stack["mlp.fc1.weight"]


def test_sam3_model_keeps_the_spatial_trunk_where_the_grid_does_not_divide(case):
    """A 36 px model (a 9x9 grid of 4x4 windows) stacks nothing and runs the
    spatial trunk, as the JAX model's encode_vision falls back."""
    vp, jvp = dataclasses.replace(case["vp"], image_size=36), dataclasses.replace(case["jvp"], image_size=36)
    store = {f"det.ve.{k}": v for k, v in case["store"].items()}
    jm = js3.Sam3Model(store, js3.ClipTokenizer(vocab={}, bpe_rank={}), 8, jax_backend_init("cpu"), vp=jvp)
    pm = s3.Sam3Model(params_from_numpy(store, "cpu", torch.float32), s3.ClipTokenizer(vocab={}, bpe_rank={}), 8,
                      backend_init("cpu"), vp=vp)
    img = np.random.default_rng(15).integers(0, 256, (30, 50, 4), np.uint8)
    for g, w in zip(pm.encode_vision(Image(img, ImageFormat.rgba_u8)), jm.encode_vision(JImage(img,
                                                                                              JImageFormat.rgba_u8))):
        _close(g, w)
    assert not pm.scan and not any("window_stack" in k for k in pm.params)


@pytest.mark.parametrize("vp,pp", [
    (dict(n_layers=4, global_attn_indexes=(1, 3)), 1),
    (dict(n_layers=4, global_attn_indexes=(1, 3)), 2),
    ({}, 4),
    ({}, 2),
])
def test_stage_layout_matches_jax(vp, pp):
    assert s3._sam3_stage_layout(s3.Sam3VitParams(**vp), pp) == js3._sam3_stage_layout(js3.Sam3VitParams(**vp), pp)


@pytest.mark.parametrize("vp,pp", [
    (dict(n_layers=4, global_attn_indexes=(1, 2)), 1),  # win glb glb win: not (win^k glb)*
    (dict(n_layers=5, global_attn_indexes=(1, 4)), 1),  # runs of 1 and 2 window layers
    (dict(n_layers=4, global_attn_indexes=(1, 3)), 4),  # 2 stages over pp 4
    ({}, 3),
])
def test_stage_layout_errors_match_jax(vp, pp):
    with pytest.raises(ValueError) as want:
        js3._sam3_stage_layout(js3.Sam3VitParams(**vp), pp)
    with pytest.raises(ValueError) as got:
        s3._sam3_stage_layout(s3.Sam3VitParams(**vp), pp)
    assert str(got.value) == str(want.value)


def test_pipelined_encode_needs_a_mesh_and_weights(case):
    """encode_vision_pipelined without a mesh, or with neither stage weights
    nor a stack, raises the JAX package's error."""
    x = _images(2)
    with pytest.raises(ValueError) as want:
        js3.encode_vision_pipelined(JParams(case["store"]), jnp.asarray(x), case["jvp"], win_stack=case["jstack"])
    for kw in ({"win_stack": case["stack"]}, {"mesh": object()}):
        with pytest.raises(ValueError) as got:
            s3.encode_vision_pipelined(Params(case["p"]), torch.from_numpy(x), case["vp"], **kw)
        assert str(got.value) == str(want.value)
