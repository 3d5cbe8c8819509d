"""The port's SAM3 (vision_tpu_torch/models/sam3.py) against the JAX
package's, on the same numpy inputs and the same twin weights (the torch
modules of tests/test_sam3.py), in f32 on the CPU unless a test says
otherwise; the trunk against the committed sam3_vision golden; and one
global layer at head dim 80 on the flash route, whose CPU form is the
kernel's plain version."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sam3 import TClipText, TFpnLayer, TRopeAttention, TVisionLayer, TVit, _mini_tokenizer
from vision_tpu.core.device import backend_init as jax_backend_init
from vision_tpu.core.gguf import GGUFFile as JGGUFFile
from vision_tpu.core.params import Params as JParams
from vision_tpu.models import random_weights as jrw
from vision_tpu.models import sam3 as js3
from vision_tpu.ops import max_pool_2d as jax_max_pool_2d
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.gguf import GGUFFile, GGUFWriter
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models import random_weights as rw
from vision_tpu_torch.models import sam3 as s3
from vision_tpu_torch.ops import max_pool_2d
from vision_tpu_torch.ops.cuda import flash_attention as fa
from vision_tpu_torch.ops.nn import attention_route
from workbench import input_tensor, randomize, state_dict_to_params, to_nhwc
from torch_threads import torch_threads  # noqa: F401

ATOL_ONE, ATOL_STACK = 1e-5, 1e-4  # a single function; a stack of layers
GOLDEN = Path(__file__).parent / "golden" / "sam3_vision.npz"
GOLDEN_RMS = 1e-4  # tests/test_golden.py:23
SMALL_VP = dict(image_size=16, patch_size=4, window_size=2, n_layers=3, n_heads=2, global_attn_indexes=(1,))
# random_sam3_vision_params' patch conv is 14 wide: a 4x4 grid, the 72x72 table tiled
RANDOM_VP = dict(SMALL_VP, image_size=56, patch_size=14)


def _stores(store: dict):
    """(port Params, JAX Params) over one numpy store."""
    return Params(params_from_numpy(store, "cpu", torch.float32)), JParams(store)


def _module_stores(module, prefix: str = ""):
    return _stores(state_dict_to_params(module.state_dict(), prefix))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _match(port_out, jax_out, atol=ATOL_ONE, rtol=0.0):
    np.testing.assert_allclose(port_out.detach().float().numpy(), np.asarray(jax_out, np.float32), atol=atol,
                               rtol=rtol)


# -- tokenizer --


@pytest.mark.parametrize("text,max_tokens", [
    ("abc", 8), ("ab", 6), ("AB! 1", 8), ("", 4), ("abc ab a b c 1 ! zz abc abc", 6), ("a  b\tc", 32),
])
def test_tokenizer_matches_jax(text, max_tokens):
    """tests/test_sam3.py:49-90's cases (and truncation, an empty prompt,
    unknown characters): the same ids and the same 0/-inf mask."""
    jt = _mini_tokenizer()
    pt = s3.ClipTokenizer(vocab=dict(jt.vocab), bpe_rank=dict(jt.bpe_rank), bos_token_id=jt.bos_token_id,
                          eos_token_id=jt.eos_token_id, pad_token_id=jt.pad_token_id, unk_token_id=jt.unk_token_id)
    want, got = jt.tokenize(text, max_tokens), pt.tokenize(text, max_tokens)
    np.testing.assert_array_equal(got.token_ids, want.token_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)
    assert got.token_ids.dtype == np.int32 and got.attention_mask.dtype == np.float32
    # every row attends to at least one key: no all -inf row, no NaN downstream
    assert (got.attention_mask == 0).any(axis=1).all()


def test_tokenizer_from_gguf_round_trip(tmp_path):
    """The port's GGUFWriter -> GGUFFile.get_array -> clip_tokenizer_init,
    against the JAX package's reader of the same file."""
    path = tmp_path / "t.gguf"
    w = GGUFWriter(path, "sam3")
    w.add("tokenizer.ggml.tokens", ["<unk>", "h", "i</w>", "hi</w>", "a", "b</w>", "ab</w>"])
    w.add("tokenizer.ggml.merges", ["h i</w>", "a b</w>"])
    w.add("tokenizer.ggml.bos_token_id", 10)
    w.add("tokenizer.ggml.eos_token_id", 11)
    w.add("tokenizer.ggml.padding_token_id", 11)
    w.add("tokenizer.ggml.unknown_token_id", 0)
    w.write()
    pt = s3.clip_tokenizer_init(GGUFFile(path))
    jt = js3.clip_tokenizer_init(JGGUFFile(path))
    assert list(pt.tokenize("hi", 4).token_ids) == [10, 3, 11, 11]
    for text in ("hi", "hi ab x", "AB hi!"):
        want, got = jt.tokenize(text, 8), pt.tokenize(text, 8)
        np.testing.assert_array_equal(got.token_ids, want.token_ids)
        np.testing.assert_array_equal(got.attention_mask, want.attention_mask)


# -- CLIP text encoder --


def _causal_mask(t):
    return np.triu(np.full((t, t), -np.inf, np.float32), 1)


def test_clip_encode_text_matches_jax(monkeypatch):
    """4 heads (both packages hardcode 16 through clip_attention's default;
    patched in both, as tests/test_sam3.py does)."""
    p, jp = _module_stores(randomize(TClipText()))
    ids = np.array([[5, 9, 2, 2, 2, 2, 2, 2], [1, 3, 4, 7, 2, 2, 2, 2]])
    mask = _causal_mask(8)
    jorig, porig = js3.clip_attention, s3.clip_attention
    monkeypatch.setattr(js3, "clip_attention", lambda pp, x, m, n_heads=4: jorig(pp, x, m, 4))
    monkeypatch.setattr(s3, "clip_attention", lambda pp, x, m, n_heads=4: porig(pp, x, m, 4))
    want = js3.clip_encode_text(jp, ids, mask, n_layers=2)
    got = s3.clip_encode_text(p, torch.from_numpy(ids), torch.from_numpy(mask), n_layers=2)
    _match(got, want, ATOL_STACK)


@pytest.mark.parametrize("projection", [False, True], ids=["no_projection", "text_projection"])
def test_encode_text_matches_jax(projection):
    """16 heads of 2 at width 32, the tokenizer's mask (rows past EOS
    attend to 0..EOS), with and without the optional text projection."""
    store = state_dict_to_params(randomize(TClipText(dim=32, heads=16)).state_dict(), "te.text_model.")
    if projection:
        rng = np.random.default_rng(4)
        store["text_projection.weight"] = (rng.standard_normal((24, 32)) * 0.1).astype(np.float32)
        store["text_projection.bias"] = (rng.standard_normal(24) * 0.1).astype(np.float32)
    p, jp = _stores(store)
    toks = _mini_tokenizer().tokenize("ab c!", 8)
    ids, mask = toks.token_ids[None].astype(np.int64), toks.attention_mask
    want = js3.encode_text(jp, ids, mask, n_layers=2)
    got = s3.encode_text(p, torch.from_numpy(ids), torch.from_numpy(mask), n_layers=2)
    assert got.shape == (1, 8, 24 if projection else 32)
    assert torch.isfinite(got).all()
    _match(got, want, ATOL_STACK)


# -- RoPE --


@pytest.mark.parametrize("layout,shape", [("bhtd", (2, 3, 12, 8)), ("bthd", (2, 12, 3, 8)), ("bhtd", (1, 2, 9, 80))])
def test_apply_rope_2d_matches_jax(layout, shape):
    x = _x(1, *shape)
    for n_rows, scale in ((3, 1.0), (4, 0.5)):
        want = js3.apply_rope_2d(x, n_rows, scale, layout=layout)
        got = s3.apply_rope_2d(torch.from_numpy(x), n_rows, scale, layout=layout)
        _match(got, want)


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_rope_tables_pos_on_permuted_positions(layout):
    """Explicit (permuted) positions through _apply_rope_tables, both
    layouts; the tables are the same float64-built numpy arrays."""
    perm = np.random.default_rng(2).permutation(16)
    px, py = (perm % 4).astype(np.float64) * 0.5, (perm // 4).astype(np.float64) * 0.5
    jt, pt = js3._rope_tables_pos(px, py, 16), s3._rope_tables_pos(px, py, 16)
    for a, b in zip(jt, pt):
        np.testing.assert_array_equal(a, b)
    x = _x(3, 2, 2, 16, 16) if layout == "bhtd" else _x(3, 2, 16, 2, 16)
    tables = tuple(torch.from_numpy(a) for a in pt)
    _match(s3._apply_rope_tables(torch.from_numpy(x), tables, layout), js3._apply_rope_tables(x, jt, layout))


def test_rope_tensors_are_cast_to_x_type_and_cached():
    """The tables go to x's type before use (a bf16 model rotates with bf16
    tables, as the JAX package does) and are made once per key."""
    a = s3._rope_tensors(16, 4, 8, 1.0, torch.device("cpu"), torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in a)
    assert s3._rope_tensors(16, 4, 8, 1.0, torch.device("cpu"), torch.bfloat16) is a


# -- rope attention --


@pytest.mark.parametrize("flash", [False, True], ids=["window_form", "global_form"])
def test_rope_attention_matches_jax(flash):
    p, jp = _module_stores(randomize(TRopeAttention(16, 4, 3, 1.0)))
    x = _x(5, 2, 9, 16)
    want = js3.rope_attention(jp, x, 4, 3, 0.5, flash=flash)
    got = s3.rope_attention(p, torch.from_numpy(x), 4, 3, 0.5, flash=flash)
    _match(got, want)


def test_rope_attention_window_form_bf16_matches_jax_bf16():
    """bf16 weights and x through the window form at head dim 80: RoPE with
    bf16 tables, the logits (and the scale, 1/sqrt(80)) rounded to bf16
    before the f32 softmax, the probabilities cast back. Held against the
    JAX package's bf16 result within half a bf16 ulp of each element (the
    two agree exactly here); logits kept in f32 miss it by up to 3e-2."""
    store = state_dict_to_params(randomize(TRopeAttention(160, 2, 6, 1.0)).state_dict())
    x = _x(6, 2, 36, 160)
    jstore = {k: jnp.asarray(v, jnp.bfloat16) for k, v in store.items()}
    want = np.asarray(js3.rope_attention(JParams(jstore), jnp.asarray(x, jnp.bfloat16), 2, 6, 1.0), np.float32)
    pstore = params_from_numpy(store, "cpu", torch.bfloat16)
    got = s3.rope_attention(Params(pstore), torch.from_numpy(x).to(torch.bfloat16), 2, 6, 1.0)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= np.abs(want) * 2.0**-9 + 1e-6).all(), float(err.max())


# -- vision layers and trunk --


@pytest.mark.parametrize("window,n_rows,scale", [(2, 2, 1.0), (3, 3, 1.0), (0, 4, 0.5)],
                         ids=["window", "window_padded", "global"])
def test_vision_layer_matches_jax(window, n_rows, scale):
    p, jp = _module_stores(randomize(TVisionLayer(8, 2, window, n_rows, scale)))
    x = _x(7, 2, 4, 4, 8)
    want = js3.vision_layer(jp, x, window, 2, n_rows, scale)
    got = s3.vision_layer(p, torch.from_numpy(x), window, 2, n_rows, scale)
    _match(got, want, ATOL_STACK)


def test_vision_layer_tokens_matches_jax():
    p, jp = _module_stores(randomize(TVisionLayer(8, 2, 0, 3, 1.0)))
    x = _x(8, 2, 9, 8)
    _match(s3._vision_layer_tokens(p, torch.from_numpy(x), 2, 3, 1.0),
           js3._vision_layer_tokens(jp, x, 2, 3, 1.0), ATOL_STACK)


@pytest.mark.parametrize("img", [16, 24], ids=["native_grid", "tiled_pos"])
def test_vision_transformer_matches_jax(img):
    p, jp = _module_stores(randomize(TVit()))
    x = to_nhwc(input_tensor(1, 3, img, img))
    want = js3.vision_transformer(jp, x, js3.Sam3VitParams(**SMALL_VP))
    got = s3.vision_transformer(p, torch.from_numpy(x), s3.Sam3VitParams(**SMALL_VP))
    _match(got, want, ATOL_STACK)


def test_vision_transformer_matches_golden():
    """The port's trunk against tests/golden/sam3_vision.npz (the same TVit,
    input and Sam3VitParams as tests/test_golden.py:127-135)."""
    p, _ = _module_stores(randomize(TVit()))
    out = s3.vision_transformer(p, torch.from_numpy(to_nhwc(input_tensor(1, 3, 16, 16))),
                                s3.Sam3VitParams(**SMALL_VP)).numpy()
    golden = np.load(GOLDEN)["output"]
    assert out.shape == golden.shape
    rel = np.sqrt(np.mean((out - golden) ** 2)) / (np.sqrt(np.mean(golden**2)) + 1e-8)
    assert rel < GOLDEN_RMS, rel


def test_global_layer_head_dim_80_on_the_flash_route(monkeypatch):
    """One global layer at head dim 80 (dim 160, 2 heads) over 1024 tokens
    (image 128, patch 4) with the flash flag on: the port's "cuda" route,
    whose CPU form is the kernel's plain version, against the JAX
    package's vision_layer(..., flash=True) (xla_fused on the CPU) and
    against the same layer with its attention in the Pallas kernel, run in
    interpret mode as tests/test_torch_flash_attention.py runs it."""
    import vision_tpu.ops.pallas as jpallas
    from vision_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash

    assert attention_route(1024, False, True, cuda_ok=True, head_dim=80) == "cuda"
    p, jp = _module_stores(randomize(TVisionLayer(160, 2, 0, 32, 0.75)))
    x = _x(9, 1, 32, 32, 160)
    calls = []
    plain = fa.flash_attention_plain

    def counted(q, k, v, scale):
        calls.append(tuple(q.shape))
        return plain(q, k, v, scale)

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    got = s3.vision_layer(p, torch.from_numpy(x), 0, 2, 32, 0.75, flash=True)
    assert calls == [(1, 2, 1024, 80)]
    _match(got, js3.vision_layer(jp, x, 0, 2, 32, 0.75, flash=True), ATOL_STACK)
    monkeypatch.setattr(jpallas, "pallas_available", lambda: True)
    monkeypatch.setattr(jpallas, "flash_attention",
                        lambda q, k, v, scale=None: pallas_flash(q, k, v, scale=scale, interpret=True))
    _match(got, js3.vision_layer(jp, x, 0, 2, 32, 0.75, flash=True), ATOL_STACK)


# -- neck --


def test_sine_position_embedding_matches_jax():
    for w, h, nf in ((3, 4, 6), (9, 7, 16)):
        np.testing.assert_array_equal(s3.sine_position_embedding(w, h, nf), js3.sine_position_embedding(w, h, nf))


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_fpn_layer_matches_jax(index):
    p, jp = _module_stores(randomize(TFpnLayer(8, 6, index)))
    x = _x(10, 1, 8, 8, 8)
    _match(s3.fpn_layer(p, torch.from_numpy(x), index), js3.fpn_layer(jp, x, index))


@pytest.mark.parametrize("kernel,stride,pad,hw", [(2, 2, 0, (8, 8)), (2, 2, 0, (7, 9)), (3, 2, 1, (8, 7)),
                                                  (5, 1, 2, (6, 6)), (3, 3, 1, (10, 11))])
def test_max_pool_2d_matches_jax(kernel, stride, pad, hw):
    x = _x(11, 2, *hw, 3) - 3.0  # all negative: padding must not win a window
    want = jax_max_pool_2d(x, kernel, stride, pad)
    got = max_pool_2d(torch.from_numpy(x), kernel, stride, pad)
    assert tuple(got.shape) == want.shape
    _match(got, want, 0.0)


def test_max_pool_2d_pads_with_the_lowest_finite_value():
    """As the JAX op: a window over -inf and padding yields the dtype's
    lowest finite value, not -inf."""
    x = np.full((1, 2, 2, 1), -np.inf, np.float32)
    want = np.asarray(jax_max_pool_2d(x, 3, 1, 1))
    got = max_pool_2d(torch.from_numpy(x), 3, 1, 1).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == np.finfo(np.float32).min).all()


def _vit_neck_store(seed=0, dim=16, layers=3, fpn_ch=8):
    return {f"det.ve.{k}": v for k, v in rw.random_sam3_vision_params(seed, dim, layers, fpn_ch).items()}


def test_encode_vision_matches_jax():
    store = _vit_neck_store()
    p, jp = _stores(store)
    x = _x(12, 1, 56, 56, 3)
    want = js3.encode_vision(jp["det.ve"], x, js3.Sam3VitParams(**RANDOM_VP))
    got = s3.encode_vision(p["det.ve"], torch.from_numpy(x), s3.Sam3VitParams(**RANDOM_VP))
    assert [tuple(h.shape) for h in got.fpn_hidden_states] == [(1, 16, 16, 8), (1, 8, 8, 8), (1, 4, 4, 8),
                                                               (1, 2, 2, 8)]
    for a, b in zip(got.fpn_hidden_states, want.fpn_hidden_states):
        _match(a, b, ATOL_STACK)
    for a, b in zip(got.fpn_position_encoding, want.fpn_position_encoding):
        _match(a, b, 0.0)


def test_sam3_process_input_matches_jax():
    from vision_tpu.image import Image as JImage, ImageFormat as JImageFormat

    rgba = np.random.default_rng(13).integers(0, 256, (30, 50, 4), np.uint8)
    want = js3.sam3_process_input(JImage(rgba, JImageFormat.rgba_u8), 28)
    got = s3.sam3_process_input(Image(rgba, ImageFormat.rgba_u8), 28)
    assert got.shape == (28, 28, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- model --


def _model_store():
    store = _vit_neck_store(1)
    text = state_dict_to_params(randomize(TClipText(dim=32, heads=16)).state_dict(), "det.te.text_model.")
    return {**store, **text}


def _tokenizer(cls):
    jt = _mini_tokenizer()
    return cls(vocab=dict(jt.vocab), bpe_rank=dict(jt.bpe_rank), bos_token_id=jt.bos_token_id,
               eos_token_id=jt.eos_token_id, pad_token_id=jt.pad_token_id, unk_token_id=jt.unk_token_id)


def test_sam3_model_matches_jax_model():
    """Sam3Model on the CPU against the JAX package's Sam3Model from the
    same params, tokenizer and a small vp (both run their window-major
    scan trunks)."""
    store = _model_store()
    jm = js3.Sam3Model(store, _tokenizer(js3.ClipTokenizer), 8, jax_backend_init("cpu"),
                       vp=js3.Sam3VitParams(**RANDOM_VP))
    pm = s3.Sam3Model(params_from_numpy(store, "cpu", torch.float32), _tokenizer(s3.ClipTokenizer), 8,
                      backend_init("cpu"), vp=s3.Sam3VitParams(**RANDOM_VP))
    assert pm.n_text_layers == 2 and not pm.flash
    for text in ("abc", "ab c!"):
        _match(pm.encode_text(text), jm.encode_text(text), ATOL_STACK)
    from vision_tpu.image import Image as JImage, ImageFormat as JImageFormat

    rgba = np.random.default_rng(14).integers(0, 256, (40, 64, 4), np.uint8)
    got = pm.encode_vision(Image(rgba, ImageFormat.rgba_u8))
    want = jm.encode_vision(JImage(rgba, JImageFormat.rgba_u8))
    assert len(got) == 4
    for a, b in zip(got, want):
        _match(a, b, ATOL_STACK)


def test_sam3_load_model_from_gguf(tmp_path):
    """sam3_load_model on the CPU: tokenizer and max_length from the
    metadata, weights through load_weights, the text depth from the keys."""
    store = _model_store()
    path = tmp_path / "sam3.gguf"
    w = GGUFWriter(path, "sam3")
    jt = _mini_tokenizer()
    w.add("tokenizer.ggml.tokens", sorted(jt.vocab, key=jt.vocab.get))
    w.add("tokenizer.ggml.merges", [f"{a} {b}" for (a, b) in sorted(jt.bpe_rank, key=jt.bpe_rank.get)])
    for key, v in (("bos", jt.bos_token_id), ("eos", jt.eos_token_id), ("padding", jt.pad_token_id),
                   ("unknown", jt.unk_token_id)):
        w.add(f"tokenizer.ggml.{key}_token_id", v)
    w.add("sam3.tokenizer.max_length", 8)
    for k, v in store.items():
        w.add_tensor(k, v)
    w.write()
    m = s3.sam3_load_model(str(path), backend_init("cpu"))
    assert m.max_tokens == 8 and m.n_text_layers == 2 and m.tokenizer.vocab == jt.vocab
    assert m.tokenizer.bpe_rank == jt.bpe_rank
    out = m.encode_text("abc")
    assert out.shape == (1, 8, 32) and torch.isfinite(out).all()


def test_random_sam3_vision_params_match_jax():
    want = jrw.random_sam3_vision_params(0, dim=32, layers=2, fpn_ch=16)
    got = rw.random_sam3_vision_params(0, dim=32, layers=2, fpn_ch=16)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
