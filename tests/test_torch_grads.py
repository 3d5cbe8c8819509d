"""Gradients through the port's hand-written-kernel wrappers, on the CPU
route: each autograd function (ops/cuda Conv3x3Fn, WindowAttentionFn,
DeformConvFn: the forward the kernel's route, the backward PyTorch ops)
against ``jax.grad`` of the JAX package's function on the same numpy inputs
(relative RMS within 1e-4 per leaf, f32: summation order only), and against
autograd of the kernel's plain version; the routing rules under grad."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_tpu.core.params import Params as JParams
from vision_tpu.models import birefnet as jbiref
from vision_tpu.models import swin as jswin
from vision_tpu.ops import deform as jdeform
from vision_tpu.ops import nn as jnn
from vision_tpu_torch.core.params import Params
from vision_tpu_torch.models import birefnet, swin
from vision_tpu_torch.ops import deform, nn
from vision_tpu_torch.ops.cuda import conv3x3 as cc
from vision_tpu_torch.ops.cuda import deform_conv as dcm
from vision_tpu_torch.ops.cuda import window_attention as wa

REL_RMS = 1e-4  # per leaf, f32 on the CPU
# a function's gradients against autograd of its plain version: the same
# math in f32, reductions (bias, scale, shift sums) in another order
PLAIN_REL_RMS = 1e-5


def rel_rms(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.sqrt(np.mean(b**2)), 1e-30))


def leaves(store: dict) -> dict:
    """The store as f32 CPU tensors that require grad."""
    return {k: torch.tensor(v, dtype=torch.float32, requires_grad=True) for k, v in store.items()}


def port_grads(fn, store: dict, cot: np.ndarray) -> tuple[np.ndarray, dict]:
    """fn(tensors) -> output; the output and d<output, cot>/d leaf."""
    t = leaves(store)
    out = fn(t)
    grads = torch.autograd.grad(out, list(t.values()), torch.from_numpy(cot))
    return out.detach().numpy(), {k: g.numpy() for k, g in zip(t, grads)}


def jax_grads(fn, store: dict, cot: np.ndarray) -> tuple[np.ndarray, dict]:
    out, vjp = jax.vjp(fn, {k: jnp.asarray(v) for k, v in store.items()})
    (g,) = vjp(jnp.asarray(cot))
    return np.asarray(out), {k: np.asarray(v) for k, v in g.items()}


def assert_grads(port, ref, rel=REL_RMS):
    (out, g), (jout, jg) = port, ref
    assert out.shape == jout.shape and rel_rms(out, jout) <= rel, rel_rms(out, jout)
    assert set(g) == set(jg)
    for k in g:
        assert g[k].shape == jg[k].shape, k
        err = rel_rms(g[k], jg[k])
        assert err <= rel, f"{k}: relative RMS {err:.3g}"


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# conv3x3 with its epilogue forms: name -> (the residuals and BatchNorm it
# takes, its scalar keywords, the JAX package's composition of conv_2d and
# the same epilogue)
CONV_FORMS = {
    "bias + leaky (ESRGAN conv1-4, upsample, hr)": ((), dict(slope=0.2), lambda y, p: jnn.leaky_relu(y, 0.2)),
    "bias, no activation (last conv)": ((), {}, lambda y, p: y),
    "x + 0.2 * y (conv5)": (("r1",), dict(s1=0.2), lambda y, p: p["r1"] + 0.2 * y),
    "r2 + 0.2 * (x + 0.2 * y) (RDB3's conv5)": (
        ("r1", "r2"), dict(s1=0.2, s2=0.2), lambda y, p: p["r2"] + 0.2 * (p["r1"] + 0.2 * y)),
    "trunk + skip": (("r1",), {}, lambda y, p: p["r1"] + y),
    "BN + SiLU (YOLOv9t)": (("bn",), dict(silu=True), lambda y, p: jnn.silu(y * p["bn.weight"] + p["bn.bias"])),
    "BN + SiLU + r1 + r2 (RepConv, shortcut)": (
        ("bn", "r1", "r2"), dict(silu=True),
        lambda y, p: p["r2"] + jnn.silu(p["r1"] + (y * p["bn.weight"] + p["bn.bias"]))),
}


def _conv_store(rng, n, h, w, ci, co, takes):
    store = {"x": _rand(rng, n, h, w, ci), "weight": _rand(rng, co, ci, 3, 3, scale=0.3), "bias": _rand(rng, co)}
    for r in ("r1", "r2"):
        if r in takes:
            store[r] = _rand(rng, n, h, w, co)
    if "bn" in takes:
        store |= {"bn.weight": _rand(rng, co), "bn.bias": _rand(rng, co)}
    return store


@pytest.mark.parametrize("form", sorted(CONV_FORMS))
def test_conv3x3_fused_grads_match_jax(form):
    """conv_3x3_fused under autograd (Conv3x3Fn) against jax.grad of the JAX
    package's conv_2d(p, x, 1, 1) and the same epilogue, every leaf: x,
    weight, bias, the BatchNorm's scale and shift, r1 and r2."""
    rng = np.random.default_rng(0)
    takes, kw, jax_epi = CONV_FORMS[form]
    store = _conv_store(rng, 2, 7, 9, 6, 5, takes)
    cot = _rand(rng, 2, 7, 9, 5)

    def port(t):
        out = nn.conv_3x3_fused(Params(t), t["x"], bn=Params(t)["bn"] if "bn" in takes else None,
                                r1=t.get("r1"), r2=t.get("r2"), **kw)
        assert type(out.grad_fn).__name__ == "Conv3x3FnBackward"
        return out

    def ref(p):
        return jax_epi(jnn.conv_2d(JParams(p), p["x"], 1, 1), p)

    assert_grads(port_grads(port, store, cot), jax_grads(ref, store, cot))


@pytest.mark.parametrize("form", sorted(CONV_FORMS))
def test_conv3x3_fn_matches_autograd_of_its_plain_version(form):
    """The same forms: Conv3x3Fn's output equals the plain version's as
    serving runs it (on tensors that do not require grad) bit for bit, and
    its gradients autograd's of the plain version (PLAIN_REL_RMS)."""
    rng = np.random.default_rng(1)
    takes, kw, _ = CONV_FORMS[form]
    store = _conv_store(rng, 1, 5, 6, 4, 3, takes)
    cot = torch.from_numpy(_rand(rng, 1, 5, 6, 3))

    def run(fn, t):
        return fn(t["x"], t["weight"], t["bias"], scale=t.get("bn.weight"), shift=t.get("bn.bias"), r1=t.get("r1"),
                  r2=t.get("r2"), **kw)

    t = leaves(store)
    out = run(cc.conv3x3, t)
    g1 = torch.autograd.grad(out, list(t.values()), cot)
    assert torch.equal(out.detach(), run(cc.conv3x3_plain, {k: torch.from_numpy(v) for k, v in store.items()}))
    t = leaves(store)
    g2 = torch.autograd.grad(run(cc.conv3x3_plain, t), list(t.values()), cot)
    for a, b in zip(g1, g2):
        assert rel_rms(a, b) <= PLAIN_REL_RMS


def _swin_store(rng, c, heads, window):
    n = (2 * window - 1) ** 2
    return {"qkv.weight": _rand(rng, 3 * c, c, scale=0.3), "qkv.bias": _rand(rng, 3 * c, scale=0.1),
            "proj.weight": _rand(rng, c, c, scale=0.3), "proj.bias": _rand(rng, c, scale=0.1),
            "relative_position_bias_table": _rand(rng, n, heads)}


@pytest.mark.parametrize("masked", [False, True])
def test_swin_window_attention_grads_match_jax(masked):
    """SWIN's window attention (the window kernel's route through
    attention_windows, WindowAttentionFn): gradients for x, the qkv and proj
    weights and biases and the relative-position table (its gather
    scatters back), with and without the shifted-window mask (whose -inf
    entries must give no NaN), against jax.grad of the JAX package's
    swin.window_attention (one combined mask there)."""
    rng = np.random.default_rng(2)
    c, heads, window = 16, 2, 4
    side = 8  # 2 x 2 windows of 16 tokens an image
    store = _swin_store(rng, c, heads, window) | {"x": _rand(rng, 2 * 4, window * window, c)}
    mask = swin.compute_attention_mask(side, side, window) if masked else None
    assert not masked or np.isinf(mask).any()
    cot = _rand(rng, 2 * 4, window * window, c)

    def port(t):
        m = None if mask is None else torch.from_numpy(np.array(mask))
        return swin.window_attention(Params(t), t["x"], m, heads, window)

    out, g = port_grads(port, store, cot)
    assert all(np.isfinite(v).all() for v in g.values())
    assert_grads((out, g), jax_grads(lambda p: jswin.window_attention(JParams(p), p["x"], mask, heads, window),
                                     store, cot))


def test_attention_windows_bias_grad_matches_jax():
    """attention_windows with a raw (1, H, T, T) bias leaf and a per-window
    mask (window b takes mask b % nW): the bias's gradient is summed over
    the windows; the mask gets none. The JAX package takes one combined
    mask, bias + tiled window mask."""
    rng = np.random.default_rng(3)
    nw, t, c, heads = 6, 9, 12, 3
    wm = np.zeros((3, t, t), np.float32)
    wm[1, :4, 4:] = wm[1, 4:, :4] = -np.inf
    wm[2, ::2, 1::2] = -5.0
    store = {"qkv.weight": _rand(rng, 3 * c, c, scale=0.3), "qkv.bias": _rand(rng, 3 * c),
             "proj.weight": _rand(rng, c, c, scale=0.3), "proj.bias": _rand(rng, c),
             "x": _rand(rng, nw, t, c), "bias": _rand(rng, 1, heads, t, t)}
    cot = _rand(rng, nw, t, c)
    scale = 0.4

    def port(tt):
        m = torch.from_numpy(wm)
        return nn.attention_windows(Params(tt), tt["x"], heads, 2, tt["bias"], scale, window_mask=m)

    def ref(p):
        return jnn.attention_windows(JParams(p), p["x"], heads, 2, p["bias"] + np.tile(wm, (2, 1, 1))[:, None], scale)

    assert_grads(port_grads(port, store, cot), jax_grads(ref, store, cot))


def test_window_attention_fn_matches_autograd_of_its_plain_version():
    rng = np.random.default_rng(4)
    nw, t, heads, hd = 4, 10, 2, 4
    store = {"q": _rand(rng, nw, t, heads * hd), "k": _rand(rng, nw, t, heads * hd),
             "v": _rand(rng, nw, t, heads * hd), "bias": _rand(rng, heads, t, t)}
    wm = np.zeros((2, t, t), np.float32)
    wm[1, :5, 5:] = -np.inf
    cot = torch.from_numpy(_rand(rng, nw, t, heads * hd))
    outs = []
    for fn in (wa.window_attention, wa.window_attention_plain):
        tt = leaves(store)
        out = fn(tt["q"], tt["k"], tt["v"], tt["bias"], heads, 0.5, torch.from_numpy(wm))
        outs.append((out.detach(), torch.autograd.grad(out, list(tt.values()), cot)))
    (o1, g1), (o2, g2) = outs
    assert torch.equal(o1, o2)
    for a, b in zip(g1, g2):
        assert rel_rms(a, b) <= PLAIN_REL_RMS


@pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (3, 1, 1), (3, 2, 1), (7, 1, 3)])
def test_deform_conv_grads_match_jax(k, stride, pad):
    """deform_conv_2d_fused under autograd (DeformConvFn) with the ASPP's
    epilogue (bias, BatchNorm scale and shift, ReLU) against jax.grad of the
    JAX package's deform_conv_2d and the same epilogue: gradients for x,
    the weight, the offsets (through the bilinear weights, samples partly
    outside the image), the modulation mask, bias, scale and shift."""
    rng = np.random.default_rng(5)
    b, h, w, ci, co = 2, 8, 9, 5, 4
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    store = {"x": _rand(rng, b, h, w, ci), "weight": _rand(rng, co, ci, k, k, scale=0.3),
             "offset": _rand(rng, b, ho, wo, 2 * k * k, scale=1.5),
             "mask": rng.uniform(0.1, 1.9, (b, ho, wo, k * k)).astype(np.float32),
             "bias": _rand(rng, co), "scale": _rand(rng, co), "shift": _rand(rng, co)}
    cot = _rand(rng, b, ho, wo, co)

    def port(t):
        out = deform.deform_conv_2d_fused(t["x"], t["weight"], t["offset"], t["mask"], stride, pad, bias=t["bias"],
                                          scale=t["scale"], shift=t["shift"], relu=True)
        assert "DeformConvFn" in type(out.grad_fn).__name__
        return out

    def ref(p):
        y = jdeform.deform_conv_2d(p["x"], p["weight"], p["offset"], p["mask"], stride, pad)
        return jnp.maximum((y + p["bias"]) * p["scale"] + p["shift"], 0.0)

    assert_grads(port_grads(port, store, cot), jax_grads(ref, store, cot))


@pytest.mark.parametrize("bound", [None, 2])
def test_aspp_module_grads_match_jax(bound):
    """BiRefNet's deformable ASPP branch (offset and modulator convs, the
    deformable conv, its bias, the BatchNorm fused at conversion, ReLU) as
    the training forward runs it (no weight layout), exact and bounded,
    against jax.grad of the JAX package's aspp_module_deformable: the
    BatchNorm's float leaves train through the kernel's scale and shift."""
    rng = np.random.default_rng(6)
    ci, co, k = 6, 4, 3
    store = {"conv.offset.weight": _rand(rng, 2 * k * k, ci, k, k, scale=0.2),
             "conv.offset.bias": _rand(rng, 2 * k * k, scale=0.2),
             "conv.modulator.weight": _rand(rng, k * k, ci, k, k, scale=0.2),
             "conv.modulator.bias": _rand(rng, k * k, scale=0.2), "conv.conv.weight": _rand(rng, co, ci, k, k),
             "conv.conv.bias": _rand(rng, co), "bn.weight": _rand(rng, co), "bn.bias": _rand(rng, co),
             "x": _rand(rng, 2, 7, 8, ci)}
    cot = _rand(rng, 2, 7, 8, co)
    port = lambda t: birefnet.aspp_module_deformable(Params(t), t["x"], k // 2, bound)  # noqa: E731
    ref = lambda p: jbiref.aspp_module_deformable(JParams(p), p["x"], k // 2, bound)  # noqa: E731
    assert_grads(port_grads(port, store, cot), jax_grads(ref, store, cot))


def test_deform_conv_fn_matches_autograd_of_its_plain_version():
    rng = np.random.default_rng(7)
    store = {"x": _rand(rng, 1, 6, 7, 3), "weight": _rand(rng, 2, 3, 3, 3), "offset": _rand(rng, 1, 6, 7, 18),
             "mask": _rand(rng, 1, 6, 7, 9), "bias": _rand(rng, 2), "scale": _rand(rng, 2), "shift": _rand(rng, 2)}
    cot = torch.from_numpy(_rand(rng, 1, 6, 7, 2))
    outs = []
    for fn in (dcm.deform_conv, dcm.deform_conv_plain):
        t = leaves(store)
        out = fn(t["x"], t["weight"], t["offset"], t["mask"], 3, 3, 1, 1, bias=t["bias"], scale=t["scale"],
                 shift=t["shift"], relu=True)
        outs.append((out.detach(), torch.autograd.grad(out, list(t.values()), cot)))
    (o1, g1), (o2, g2) = outs
    assert torch.equal(o1, o2)
    for a, b in zip(g1, g2):
        assert rel_rms(a, b) <= PLAIN_REL_RMS


def test_routing_under_grad():
    """A wrapper takes its autograd function only when grad mode is on and
    an input requires grad; under grad ``out`` (and the deform conv's
    ``layout``, stale after an optimiser step) raise; the forward launches
    nothing on the CPU and equals the serving route bit for bit."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_rand(rng, 1, 4, 5, 3))
    w = torch.from_numpy(_rand(rng, 2, 3, 3, 3))
    plain = cc.conv3x3(x, w)
    assert plain.grad_fn is None
    wg = w.clone().requires_grad_()
    with torch.no_grad():
        assert cc.conv3x3(x, wg).grad_fn is None
    before = cc.launches
    out = cc.conv3x3(x, wg)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain) and cc.launches == before
    with pytest.raises(ValueError, match="out cannot be written under autograd"):
        cc.conv3x3(x, wg, out=torch.empty_like(plain))
    off = torch.zeros(1, 4, 5, 18)
    layout = dcm.weight_layout(wg.detach(), torch.float32)
    with pytest.raises(ValueError, match="under autograd"):
        dcm.deform_conv(x, wg, off, None, 3, 3, 1, 1, layout=layout)
    with pytest.raises(ValueError, match="under autograd"):
        dcm.deform_conv(x, wg, off, None, 3, 3, 1, 1, out=torch.empty(1, 4, 5, 2))
    q = torch.from_numpy(_rand(rng, 2, 4, 8)).requires_grad_()
    o = wa.window_attention(q, q, q, None, 2, 0.5)
    assert type(o.grad_fn).__name__ == "WindowAttentionFnBackward"


def test_birefnet_aspp_deformable_autograd_form_equals_the_buffer_form():
    """When autograd records BiRefNet's ASPP concatenates fresh branches
    instead of writing into one buffer: the same values bit for bit."""
    from test_birefnet import TBasicDecBlk
    from vision_tpu_torch.core.weights import params_from_numpy
    from workbench import randomize, state_dict_to_params

    store = params_from_numpy(state_dict_to_params(randomize(TBasicDecBlk(6, 10)).state_dict()), "cpu",
                              torch.float32)
    x = torch.from_numpy(_rand(np.random.default_rng(9), 2, 8, 8, 6))
    with torch.no_grad():
        served = birefnet.basic_decoder_block(Params(store), x)
    trained = birefnet.basic_decoder_block(Params({k: v.requires_grad_() for k, v in store.items()}), x)
    assert trained.grad_fn is not None and torch.equal(trained.detach(), served)


def test_esrgan_autograd_form_equals_the_serving_form(monkeypatch):
    """When autograd records, esrgan_generate takes its autograd-safe form
    (fresh conv outputs, torch.cat dense blocks): the same conv calls and the
    serving form's output bit for bit at f32; the stem's weight gets a
    gradient. With nothing requiring grad it stays on its buffers."""
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.models import esrgan
    from vision_tpu_torch.models.random_weights import random_esrgan_params

    store = params_from_numpy(random_esrgan_params(0, nf=8, nb=2, gc=4), "cpu", torch.float32)
    x = torch.from_numpy(np.random.default_rng(10).random((2, 6, 5, 3), dtype=np.float32))
    calls = []
    real = cc.conv3x3

    def spy(*a, **kw):  # the calls of the model (Conv3x3Fn's forward calls the wrapper again, grad off)
        if torch.is_grad_enabled():
            calls.append(kw.get("out") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(cc, "conv3x3", spy)
    served = esrgan.esrgan_generate(Params(store), x, esrgan.EsrganParams(4, 2))
    assert len(calls) == 1 + 15 * 2 + 5 and calls[0]  # buffers: the stem writes into one
    calls.clear()
    trained = esrgan.esrgan_generate(Params({k: v.requires_grad_() for k, v in store.items()}), x,
                                     esrgan.EsrganParams(4, 2))
    assert len(calls) == 1 + 15 * 2 + 5 and not any(calls)
    assert torch.equal(trained.detach(), served)
    (g,) = torch.autograd.grad(trained.square().mean(), [store["model.0.weight"]])
    assert g.abs().sum() > 0


def test_training_after_serving_in_one_process():
    """The device-cached constants a served forward makes under
    inference_mode (the resize tables, SWIN's relative-position index and
    shift masks) are built outside inference mode, so a training forward
    after it can save them for its backward."""
    from vision_tpu_torch.core.weights import params_from_numpy
    from vision_tpu_torch.models import esrgan
    from vision_tpu_torch.models.random_weights import random_esrgan_params
    from vision_tpu_torch.ops import resize

    for cached in (resize._device_nearest, resize._device_weights, swin._device_mask, swin._device_index):
        cached.cache_clear()
    store = params_from_numpy(random_esrgan_params(0, nf=8, nb=1, gc=4), "cpu", torch.float32)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((1, 6, 6, 3), dtype=np.float32))
    wstore = {k: torch.from_numpy(v) for k, v in _swin_store(rng, 8, 2, 3).items()}
    tokens = torch.from_numpy(_rand(rng, 4, 9, 8))
    cpu = torch.device("cpu")
    with torch.inference_mode():  # serving first: the caches fill here
        esrgan.esrgan_generate(Params(store), resize.resize_nhwc(x, (4, 4), "bicubic"), esrgan.EsrganParams(4, 1))
        swin.window_attention(Params(wstore), tokens, swin._device_mask(6, 6, 3, cpu), 2, 3)
    trained = {k: v.clone().requires_grad_() for k, v in store.items()}
    out = esrgan.esrgan_generate(Params(trained), resize.resize_nhwc(x, (4, 4), "bicubic"), esrgan.EsrganParams(4, 1))
    table = wstore["relative_position_bias_table"].clone().requires_grad_()
    att = swin.window_attention(Params(wstore | {"relative_position_bias_table": table}), tokens,
                                swin._device_mask(6, 6, 3, cpu), 2, 3)
    grads = torch.autograd.grad(out.square().mean() + att.square().mean(), [trained["model.0.weight"], table])
    assert all(g.abs().sum() > 0 for g in grads)
