"""The port's augmentation ops (vision_tpu_torch/ops/augment.py) against the
JAX package's (vision_tpu/ops/augment.py), each with its draws fixed: the
draws the JAX op makes from a key are made here with the same jax.random
calls and handed to the port's ``_apply`` form, and the outputs compared
(f32, 1e-6 absolute; crops, flips, erasing and the mixers' permutations are
exact). Then each public op with a ``torch.Generator``: the same generator
state gives the same batch bit for bit, and the errors."""

import math

import jax
import numpy as np
import pytest
import torch

from vision_tpu.ops import augment as jaug
from vision_tpu_torch.core.errors import VispError
from vision_tpu_torch.ops import augment as aug
from torch_threads import torch_threads  # noqa: F401

ATOL = 1e-6


def _x(n=4, h=12, w=10, c=3, seed=0):
    return np.random.default_rng(seed).random((n, h, w, c), dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=atol, rtol=0)


def test_rgb_to_grayscale_and_hsv_helpers_match_jax():
    x = _x()
    _close(aug.rgb_to_grayscale(_t(x)), jaug.rgb_to_grayscale(x))
    _close(aug.rgb_to_grayscale(_t(x), keepdims=False), jaug.rgb_to_grayscale(x, keepdims=False))
    x[0, 0, 0] = (0.5, 0.5, 0.5)  # gray: d = 0
    x[0, 0, 1] = 0.0  # black: mx = 0
    for a, b in zip(aug._rgb_to_hsv(_t(x)), jaug._rgb_to_hsv(x)):
        _close(a, b)
    h, s, v = (np.asarray(t) for t in jaug._rgb_to_hsv(x))
    _close(aug._hsv_to_rgb(_t(h), _t(s), _t(v)), jaug._hsv_to_rgb(h, s, v))


@pytest.mark.parametrize("p,axis", [(0.5, 2), (0.7, 1)])
def test_random_flip_matches_jax(p, axis):
    x, key = _x(n=8), jax.random.PRNGKey(3)
    flip = np.asarray(jax.random.bernoulli(key, p, (8,)))
    assert 0 < flip.sum() < 8
    assert torch.equal(aug._flip_apply(_t(x), _t(flip), axis), _t(jaug.random_flip(key, x, p, axis)))


def test_random_crop_matches_jax():
    x, key = _x(), jax.random.PRNGKey(4)
    ky, kx = jax.random.split(key)
    y0 = np.asarray(jax.random.randint(ky, (4,), 0, 12 - 5 + 1))
    x0 = np.asarray(jax.random.randint(kx, (4,), 0, 10 - 6 + 1))
    assert torch.equal(aug._crop_apply(_t(x), _t(y0), _t(x0), (5, 6)), _t(jaug.random_crop(key, x, (5, 6))))


@pytest.mark.parametrize("size,scale,ratio", [((7, 9), (0.08, 1.0), (3 / 4, 4 / 3)),
                                              ((16, 16), (0.5, 2.0), (0.2, 5.0))])
def test_random_resized_crop_matches_jax(size, scale, ratio):
    """Includes boxes that clamp to the image (area fraction past 1, wide
    aspects) and an upscale."""
    x, key = _x(), jax.random.PRNGKey(5)
    ka, kr, ky, kx = jax.random.split(key, 4)
    frac = jax.random.uniform(ka, (4,), minval=scale[0], maxval=scale[1])
    logr = jax.random.uniform(kr, (4,), minval=np.log(ratio[0]), maxval=np.log(ratio[1]))
    uy, ux = jax.random.uniform(ky, (4,)), jax.random.uniform(kx, (4,))
    ours = aug._resized_crop_apply(_t(x), *(_t(a) for a in (frac, logr, uy, ux)), size)
    _close(ours, jaug.random_resized_crop(key, x, size, scale, ratio))


@pytest.mark.parametrize("kw", [dict(brightness=0.4), dict(contrast=0.3), dict(saturation=0.5), dict(hue=0.2),
                                dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1)])
def test_color_jitter_matches_jax(kw):
    x, key = _x(), jax.random.PRNGKey(6)
    kb, kc, ks, kh = jax.random.split(key, 4)

    def factor(k, v):
        return _t(jax.random.uniform(k, (4, 1, 1, 1), minval=max(0.0, 1.0 - v), maxval=1.0 + v)) if v else None

    hue = kw.get("hue", 0.0)
    shift = _t(jax.random.uniform(kh, (4, 1, 1), minval=-hue, maxval=hue)) if hue else None
    ours = aug._jitter_apply(_t(x), factor(kb, kw.get("brightness", 0.0)), factor(kc, kw.get("contrast", 0.0)),
                             factor(ks, kw.get("saturation", 0.0)), shift)
    _close(ours, jaug.color_jitter(key, x, **kw), atol=2e-6)


def test_random_erasing_matches_jax():
    x, key = _x(n=8), jax.random.PRNGKey(7)
    p, scale, ratio = 0.6, (0.02, 0.33), (0.3, 3.3)
    kp, ka, kr, ky, kx = jax.random.split(key, 5)
    on = jax.random.bernoulli(kp, p, (8,))
    frac = jax.random.uniform(ka, (8,), minval=scale[0], maxval=scale[1])
    logr = jax.random.uniform(kr, (8,), minval=np.log(ratio[0]), maxval=np.log(ratio[1]))
    uy, ux = jax.random.uniform(ky, (8,)), jax.random.uniform(kx, (8,))
    ours = aug._erase_apply(_t(x), *(_t(a) for a in (on, frac, logr, uy, ux)), 0.25)
    assert torch.equal(ours, _t(jaug.random_erasing(key, x, p, scale, ratio, 0.25)))


def test_mixup_matches_jax():
    x, key = _x(), jax.random.PRNGKey(8)
    y = np.eye(4, dtype=np.float32)
    kl, kp = jax.random.split(key)
    lam, perm = float(jax.random.beta(kl, 0.4, 0.4)), np.asarray(jax.random.permutation(kp, 4))
    xo, yo, lo = aug._mixup_apply(_t(x), {"y": _t(y)}, lam, _t(perm))
    jx, jy, jl = jaug.mixup(key, x, {"y": y}, 0.4)
    _close(xo, jx)
    _close(yo["y"], jy["y"])
    assert math.isclose(float(lo), float(jl), rel_tol=1e-6)


def test_cutmix_matches_jax():
    x, key = _x(h=16, w=20), jax.random.PRNGKey(9)
    y = np.eye(4, dtype=np.float32)
    kl, kp, ky, kx = jax.random.split(key, 4)
    lam, perm = float(jax.random.beta(kl, 1.0, 1.0)), np.asarray(jax.random.permutation(kp, 4))
    uy, ux = float(jax.random.uniform(ky)), float(jax.random.uniform(kx))
    xo, yo, lo = aug._cutmix_apply(_t(x), _t(y), lam, _t(perm), uy, ux)
    jx, jy, jl = jaug.cutmix(key, x, y, 1.0)
    assert torch.equal(xo, _t(jx))
    assert 0.0 < float(lo) < 1.0 and math.isclose(float(lo), float(jl), rel_tol=1e-6)
    _close(yo, jy)


OPS = {
    "random_flip": lambda g, x: aug.random_flip(g, x),
    "random_crop": lambda g, x: aug.random_crop(g, x, (5, 6)),
    "random_resized_crop": lambda g, x: aug.random_resized_crop(g, x, (8, 8)),
    "color_jitter": lambda g, x: aug.color_jitter(g, x, 0.2, 0.2, 0.2, 0.1),
    "random_erasing": lambda g, x: aug.random_erasing(g, x, p=0.9),
    "mixup": lambda g, x: aug.mixup(g, x, x[..., :1])[0],
    "cutmix": lambda g, x: aug.cutmix(g, x, x[..., :1])[0],
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_generator_reproduces_its_batch(op):
    """One seed, one batch, bit for bit; the shapes are static; another seed
    draws another batch."""
    x = _t(_x(n=8))
    a = OPS[op](torch.Generator().manual_seed(1), x)
    b = OPS[op](torch.Generator().manual_seed(1), x)
    c = OPS[op](torch.Generator().manual_seed(2), x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == x.dtype and (a.shape == x.shape or op in ("random_crop", "random_resized_crop"))


def test_errors():
    g, x = torch.Generator().manual_seed(0), _t(_x())
    with pytest.raises(VispError, match="exceeds input"):
        aug.random_crop(g, x, (13, 4))
    with pytest.raises(VispError, match="hue"):
        aug.color_jitter(g, x, hue=0.6)


@pytest.mark.parametrize("op", ["random_flip", "color_jitter"])
@pytest.mark.parametrize("rows", [[0, 1], [3], [5, 6, 7], [2, 4]])
def test_rows_of_a_batch_take_the_whole_batchs_draws(op, rows):
    """With ``rows`` and ``total`` an op draws for the whole batch and
    applies each row's own draws: rows of a batch augmented alone equal
    those rows of the whole batch (a data-parallel shard), bit for bit; a
    row count that is not x's is refused."""
    ops = {"random_flip": lambda g, x, **k: aug.random_flip(g, x, **k),
           "color_jitter": lambda g, x, **k: aug.color_jitter(g, x, 0.2, 0.2, 0.2, 0.1, **k)}
    x = _t(_x(n=8))
    whole = ops[op](torch.Generator().manual_seed(3), x)
    idx = torch.tensor(rows)
    assert torch.equal(ops[op](torch.Generator().manual_seed(3), x[idx], rows=idx, total=8), whole[idx])
    with pytest.raises(VispError, match="rows needs total"):
        ops[op](torch.Generator().manual_seed(3), x[idx], rows=idx)
    with pytest.raises(VispError, match="rows needs total"):
        ops[op](torch.Generator().manual_seed(3), x, rows=idx, total=8)
