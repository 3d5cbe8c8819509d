"""Batched data augmentation on the device — a port of
vision_tpu/ops/augment.py.

Every op takes a batched NHWC float tensor in [0, 1] (labels where noted)
and an explicit ``torch.Generator`` where the JAX package takes a
``jax.random`` key: the op draws its per-sample numbers from the generator
(on the generator's device; they are a few values a sample), then applies
them with tensor ops on x's device, with static output shapes. The same
generator state reproduces the same batch bit for bit; the numbers differ
from the JAX package's for the same seed (``torch.Generator`` and
``jax.random`` are different streams), so the tests feed both packages the
same draws through each op's ``_apply`` form.

``random_flip`` and ``color_jitter`` also take ``rows`` and ``total``: x
then holds those rows (int64 indices) of a batch of ``total`` samples, the
op draws for the whole batch and each row takes its own draws, so that a
data-parallel shard is augmented as it is in the whole batch.

The set mirrors the torchvision/timm recipe (flip, crop, resized crop,
color jitter, erasing) plus the batch mixers (mixup, cutmix), with the JAX
package's deviations from torch: ``random_resized_crop`` clamps its box to
the image instead of a 10-try rejection loop, and ``color_jitter`` applies
brightness -> contrast -> saturation -> hue in that fixed order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.errors import raise_error

__all__ = [
    "random_flip",
    "random_crop",
    "random_resized_crop",
    "color_jitter",
    "random_erasing",
    "mixup",
    "cutmix",
    "rgb_to_grayscale",
]

_GRAY = (0.299, 0.587, 0.114)  # ITU-R 601 (torch)


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _beta(gen: torch.Generator, alpha: float) -> float:
    """One Beta(alpha, alpha) draw (torch's Beta sampler takes no
    generator: numpy's, seeded from this one)."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())
    return float(np.random.default_rng(seed).beta(alpha, alpha))


def rgb_to_grayscale(x: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    """(..., 3) RGB -> luminance; ``keepdims`` keeps a size-1 channel."""
    g = torch.matmul(x, torch.tensor(_GRAY, dtype=x.dtype, device=x.device))
    return g[..., None] if keepdims else g


def _drawn(x: torch.Tensor, rows, total) -> int:
    """How many samples an op draws for: x's, or ``total`` with ``rows``."""
    if rows is None:
        return x.shape[0]
    if total is None or len(rows) != x.shape[0]:
        raise_error("augment: rows needs total and one index a sample of x, got {} rows for {} samples",
                    len(rows), x.shape[0])
    return int(total)


def _of_rows(draw: torch.Tensor, rows) -> torch.Tensor:
    return draw if rows is None else draw[rows.to(draw.device)]


def _flip_apply(x: torch.Tensor, flip: torch.Tensor, axis: int = 2) -> torch.Tensor:
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return torch.where(flip.to(x.device).reshape(shape), torch.flip(x, (axis,)), x)


def random_flip(gen: torch.Generator, x: torch.Tensor, p: float = 0.5, axis: int = 2, rows=None,
                total: int | None = None) -> torch.Tensor:
    """Per-sample flip along ``axis`` (2 = horizontal for NHWC) with
    probability ``p`` (``rows`` / ``total``: the module docstring)."""
    flip = torch.rand(_drawn(x, rows, total), generator=gen, device=gen.device) < p
    return _flip_apply(x, _of_rows(flip, rows), axis)


def _crop_apply(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    n = x.shape[0]
    th, tw = size
    dev = x.device
    rows = y0.to(dev)[:, None] + torch.arange(th, device=dev)
    cols = x0.to(dev)[:, None] + torch.arange(tw, device=dev)
    return x[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]


def random_crop(gen: torch.Generator, x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Per-sample random (th, tw) crop of a (N, H, W, C) batch."""
    n, h, w, _ = x.shape
    th, tw = size
    if th > h or tw > w:
        raise_error("random_crop: size {} exceeds input {}", (th, tw), (h, w))
    y0 = torch.randint(0, h - th + 1, (n,), generator=gen, device=gen.device)
    x0 = torch.randint(0, w - tw + 1, (n,), generator=gen, device=gen.device)
    return _crop_apply(x, y0, x0, size)


def _bilinear_box(x: torch.Tensor, y0, x0, ch, cw, out_hw: tuple[int, int]) -> torch.Tensor:
    """Sample each image's (continuous) box [y0, y0 + ch) x [x0, x0 + cw) onto
    a static (oh, ow) grid with bilinear weights (gathers). y0, x0, ch, cw:
    (N,) f32."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    dev = x.device
    ys = y0[:, None] + (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) * ch[:, None] / oh - 0.5
    xs = x0[:, None] + (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) * cw[:, None] / ow - 0.5
    yf = ys.clamp(0.0, h - 1.0)
    xf = xs.clamp(0.0, w - 1.0)
    yi = torch.floor(yf).long().clamp(0, h - 2) if h > 1 else torch.zeros_like(yf, dtype=torch.long)
    xi = torch.floor(xf).long().clamp(0, w - 2) if w > 1 else torch.zeros_like(xf, dtype=torch.long)
    wy = (yf - yi).to(x.dtype)[:, :, None, None]
    wx = (xf - xi).to(x.dtype)[:, None, :, None]
    b = torch.arange(n, device=dev)[:, None]
    r0 = x[b, yi]  # (N, oh, W, C)
    r1 = x[b, torch.clamp(yi + 1, max=h - 1)]

    def at(r, idx):  # r (N, oh, W, C) at columns idx (N, ow) -> (N, oh, ow, C)
        return torch.gather(r, 2, idx[:, None, :, None].expand(n, oh, ow, c))

    xi1 = torch.clamp(xi + 1, max=w - 1)
    top = at(r0, xi) * (1 - wx) + at(r0, xi1) * wx
    bot = at(r1, xi) * (1 - wx) + at(r1, xi1) * wx
    return top * (1 - wy) + bot * wy


def _resized_crop_apply(x, frac, logr, uy, ux, size: tuple[int, int]) -> torch.Tensor:
    """The box of area fraction ``frac`` and aspect exp(``logr``) (clamped
    to the image), placed at (``uy``, ``ux``) of the room left, resampled to
    ``size``. Draws: (N,) f32 each."""
    _, h, w, _ = x.shape
    frac, logr, uy, ux = (t.to(x.device, torch.float32) for t in (frac, logr, uy, ux))
    aspect = torch.exp(logr)  # w / h
    area = frac * (h * w)
    cw = torch.sqrt(area * aspect).clamp(1.0, float(w))
    ch = torch.sqrt(area / aspect).clamp(1.0, float(h))
    return _bilinear_box(x, uy * (h - ch), ux * (w - cw), ch, cw, size)


def random_resized_crop(gen: torch.Generator, x: torch.Tensor, size: tuple[int, int],
                        scale: tuple[float, float] = (0.08, 1.0),
                        ratio: tuple[float, float] = (3 / 4, 4 / 3)) -> torch.Tensor:
    """Per-sample random box (area fraction ~ U(scale), aspect ~
    log-U(ratio), clamped to the image) resampled bilinearly to ``size``:
    the torchvision semantics minus the rejection loop (an oversized box
    clamps to the image bounds)."""
    n = x.shape[0]
    frac = _uniform(gen, (n,), scale[0], scale[1])
    logr = _uniform(gen, (n,), math.log(ratio[0]), math.log(ratio[1]))
    return _resized_crop_apply(x, frac, logr, _uniform(gen, (n,)), _uniform(gen, (n,)), size)


# ---------------------------------------------------------------------------
# color


def _rgb_to_hsv(rgb: torch.Tensor):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d == 0, torch.zeros_like(h), h) / 6.0
    s = torch.where(mx == 0, torch.zeros_like(d), d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return h, s, mx


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = torch.zeros_like(v)
        for k, val in reversed(list(enumerate(vals))):
            out = torch.where(i == k, val, out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)], dim=-1)


def _jitter_apply(x: torch.Tensor, fb=None, fc=None, fs=None, shift=None) -> torch.Tensor:
    """Brightness, contrast and saturation factors (N, 1, 1, 1) and a hue
    shift (N, 1, 1) in turns, each optional, in that order."""
    if fb is not None:
        x = torch.clamp(x * fb.to(x.device, x.dtype), 0.0, 1.0)
    if fc is not None:
        mean = rgb_to_grayscale(x).mean(dim=(1, 2, 3), keepdim=True)
        x = torch.clamp((x - mean) * fc.to(x.device, x.dtype) + mean, 0.0, 1.0)
    if fs is not None:
        gray = rgb_to_grayscale(x)
        x = torch.clamp(gray + (x - gray) * fs.to(x.device, x.dtype), 0.0, 1.0)
    if shift is not None:
        h, s, v = _rgb_to_hsv(x)
        x = torch.clamp(_hsv_to_rgb(torch.remainder(h + shift.to(x.device, x.dtype), 1.0), s, v), 0.0, 1.0)
    return x


def color_jitter(gen: torch.Generator, x: torch.Tensor, brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0, rows=None, total: int | None = None) -> torch.Tensor:
    """Per-sample photometric jitter on (N, H, W, 3) RGB in [0, 1]: factors
    uniform in ``[max(0, 1 - v), 1 + v]`` as torchvision draws them, a hue
    shift uniform in ``[-hue, hue]`` turns (``hue <= 0.5``), applied
    brightness -> contrast -> saturation -> hue, clipped to [0, 1]
    (``rows`` / ``total``: the module docstring)."""
    n = _drawn(x, rows, total)
    if hue > 0.5:
        raise_error("color_jitter: hue must be <= 0.5 (turns), got {}", hue)

    def factor(v):
        return _of_rows(_uniform(gen, (n, 1, 1, 1), max(0.0, 1.0 - v), 1.0 + v), rows) if v else None

    fb, fc, fs = factor(brightness), factor(contrast), factor(saturation)
    shift = _of_rows(_uniform(gen, (n, 1, 1), -hue, hue), rows) if hue else None
    return _jitter_apply(x, fb, fc, fs, shift)


def _erase_apply(x: torch.Tensor, on, frac, logr, uy, ux, value: float = 0.0) -> torch.Tensor:
    """Fill, where ``on``, the box of area fraction ``frac`` and aspect
    exp(``logr``) (clamped to the image) at (``uy``, ``ux``) of the room
    left with ``value``. Draws: (N,) each."""
    _, h, w, _ = x.shape
    dev = x.device
    frac, logr, uy, ux = (t.to(dev, torch.float32) for t in (frac, logr, uy, ux))
    aspect = torch.exp(logr)
    area = frac * (h * w)
    bw = torch.sqrt(area * aspect).clamp(1.0, float(w))
    bh = torch.sqrt(area / aspect).clamp(1.0, float(h))
    y0 = uy * (h - bh)
    x0 = ux * (w - bw)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < (y0 + bh)[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < (x0 + bw)[:, None, None]))
    mask = (inside & on.to(dev)[:, None, None])[..., None]
    return torch.where(mask, torch.tensor(value, dtype=x.dtype, device=dev), x)


def random_erasing(gen: torch.Generator, x: torch.Tensor, p: float = 0.5, scale: tuple[float, float] = (0.02, 0.33),
                   ratio: tuple[float, float] = (0.3, 3.3), value: float = 0.0) -> torch.Tensor:
    """Per-sample rectangle erase (Zhong et al.; timm's random_erase): with
    probability ``p`` a box of area fraction ~ U(scale) and aspect ~
    log-U(ratio), clamped to the image, is filled with ``value``."""
    n = x.shape[0]
    on = torch.rand(n, generator=gen, device=gen.device) < p
    frac = _uniform(gen, (n,), scale[0], scale[1])
    logr = _uniform(gen, (n,), math.log(ratio[0]), math.log(ratio[1]))
    return _erase_apply(x, on, frac, logr, _uniform(gen, (n,)), _uniform(gen, (n,)), value)


# ---------------------------------------------------------------------------
# batch mixers


def _mix_tree(y, lam: torch.Tensor, perm: torch.Tensor):
    if isinstance(y, (tuple, list)):
        return type(y)(_mix_tree(v, lam, perm) for v in y)
    if isinstance(y, dict):
        return {k: _mix_tree(v, lam, perm) for k, v in y.items()}
    lam = lam.to(y.device, y.dtype)
    return lam * y + (1 - lam) * y[perm.to(y.device)]


def _mixup_apply(x, y, lam: float, perm: torch.Tensor):
    lam = torch.tensor(lam, dtype=torch.float32)
    return _mix_tree(x, lam, perm), _mix_tree(y, lam, perm), lam


def mixup(gen: torch.Generator, x: torch.Tensor, y, alpha: float = 0.2):
    """Mixup (Zhang et al.): convex-combine each sample with a random
    partner, ``lam ~ Beta(alpha, alpha)`` once a batch (as timm); ``y`` is a
    float label tensor (or tuple / dict of them) with the batch axis first.
    Returns ``(x', y', lam)``."""
    lam = _beta(gen, alpha)
    return _mixup_apply(x, y, lam, torch.randperm(x.shape[0], generator=gen, device=gen.device))


def _cutmix_apply(x, y, lam: float, perm: torch.Tensor, uy, ux):
    _, h, w, _ = x.shape
    dev = x.device
    cut = math.sqrt(1.0 - lam)
    bh, bw = cut * h, cut * w
    cy, cx = float(uy) * h, float(ux) * w
    y0, y1 = min(max(cy - bh / 2, 0), h), min(max(cy + bh / 2, 0), h)
    x0, x1 = min(max(cx - bw / 2, 0), w), min(max(cx + bw / 2, 0), w)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    box = ((ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1))[None, :, :, None]
    perm = perm.to(dev)
    mixed = torch.where(box, x[perm], x)
    lam_true = torch.tensor(1.0 - ((y1 - y0) * (x1 - x0)) / (h * w), dtype=torch.float32)
    return mixed, _mix_tree(y, lam_true, perm), lam_true


def cutmix(gen: torch.Generator, x: torch.Tensor, y, alpha: float = 1.0):
    """CutMix (Yun et al.): paste a random box from a partner sample. One
    ``lam ~ Beta(alpha, alpha)`` a batch sets the box area ``1 - lam``; the
    returned ``lam`` is the area actually pasted after clamping at the
    borders, and the labels mix with it. Returns ``(x', y', lam)``."""
    lam = _beta(gen, alpha)
    perm = torch.randperm(x.shape[0], generator=gen, device=gen.device)
    uy, ux = _uniform(gen, (2,)).tolist()
    return _cutmix_apply(x, y, lam, perm, uy, ux)
