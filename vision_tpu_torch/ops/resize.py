"""Interpolation / resize ops for NHWC tensors (a port of
vision_tpu/ops/resize.py).

Re-provides the reference's resize family with exact-match semantics
(SURVEY.md 'hard part' #2): ggml_interpolate bilinear/bicubic with and
without align_corners (reference ml.cpp:782-788, dino.cpp:26) and nearest
upscale (ggml_upscale). Semantics follow torch.nn.functional.interpolate,
which is what the reference models were converted from and parity-tested
against.

As in the JAX package, separable interpolation is two dense weight-matrix
contractions (out = Wy @ x @ Wx^T per channel) whose matrices are built with
numpy (the same code, so both packages resample identically); the
contractions run as ``torch.einsum`` in f32. Nearest is an index gather.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["resize_nhwc", "resize_matrix", "interpolate"]


def _nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """torch 'nearest' source index per output: floor(dst * n_in / n_out) —
    the single rule shared by the gather path and the matrix path."""
    src = np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)
    return np.clip(src, 0, n_in - 1)


@lru_cache(maxsize=32)
def _axis_weights(n_in: int, n_out: int, method: str, align_corners: bool) -> np.ndarray:
    """Cached (n_out, n_in) axis matrix, frozen read-only: entries are
    shared with every future caller of the same shape, and a big axis
    (4096->1024 is 16 MB) makes an unbounded cache a serving-path leak."""
    w = _axis_weights_impl(n_in, n_out, method, align_corners)
    w.setflags(write=False)
    return w


def _axis_weights_impl(n_in: int, n_out: int, method: str, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) interpolation matrix for one axis (torch semantics)."""
    if method == "nearest":
        src = _nearest_indices(n_in, n_out)
        w = np.zeros((n_out, n_in), np.float32)
        w[np.arange(n_out), src] = 1.0
        return w

    if align_corners:
        # torch area_pixel_compute_scale: scale is 0 when n_out == 1, so
        # the single output sample reads source index 0 (not the center)
        x = np.arange(n_out) * ((n_in - 1) / (n_out - 1)) if n_out > 1 else np.zeros(1)
    else:
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5

    w = np.zeros((n_out, n_in), np.float32)
    if method in ("bicubic", "catmullrom", "mitchell"):
        if method == "mitchell":
            # Mitchell-Netravali B=C=1/3 — stb_image_resize v1's DEFAULT
            # DOWNSAMPLE filter (STBIR_DEFAULT_FILTER_DOWNSAMPLE); support 2
            B = C = 1.0 / 3.0

            def k(t):
                t = np.abs(t)
                t2, t3 = t * t, t * t * t
                return np.where(
                    t < 1,
                    ((12 - 9 * B - 6 * C) * t3 + (-18 + 12 * B + 6 * C) * t2 + (6 - 2 * B))
                    / 6.0,
                    np.where(
                        t < 2,
                        ((-B - 6 * C) * t3 + (6 * B + 30 * C) * t2
                         + (-12 * B - 48 * C) * t + (8 * B + 24 * C)) / 6.0,
                        0.0,
                    ),
                )
        else:
            # Keys cubic kernel: A=-0.75 (torch 'bicubic'), A=-0.5
            # (Catmull-Rom, stb's default UPSAMPLE filter)
            A = -0.75 if method == "bicubic" else -0.5

            def k(t):
                t = np.abs(t)
                return np.where(
                    t <= 1,
                    ((A + 2) * t - (A + 3)) * t * t + 1,
                    np.where(t < 2, ((A * t - 5 * A) * t + 8 * A) * t - 4 * A, 0.0),
                )

        if method in ("catmullrom", "mitchell") and n_out < n_in:
            # stbir DOWNSCALE semantics: the filter support scales with the
            # minification ratio (anti-aliasing) and each row is normalized
            # — a fixed 4-tap kernel would alias. torch 'bicubic'
            # (antialias=False) keeps fixed taps, so only the stb filters
            # take this path.
            scale = n_out / n_in
            support = 2.0 / scale
            first = np.floor(x - support).astype(np.int64)
            n_taps = int(np.ceil(2 * support)) + 2
            for j in range(n_taps):
                tap = first + j
                tw = k((tap - x) * scale)
                idx = np.clip(tap, 0, n_in - 1)
                np.add.at(w, (np.arange(n_out), idx), tw.astype(np.float32))
            w /= w.sum(axis=1, keepdims=True)
            return w

        x0 = np.floor(x).astype(np.int64)
        f = x - x0
        for j in range(-1, 3):
            tap = x0 + j
            tw = k(j - f)
            idx = np.clip(tap, 0, n_in - 1)
            np.add.at(w, (np.arange(n_out), idx), tw)
        return w
    if method == "bilinear":
        x0 = np.floor(x).astype(np.int64)
        f = (x - x0).astype(np.float64)
        for tap, tw in ((x0, 1.0 - f), (x0 + 1, f)):
            idx = np.clip(tap, 0, n_in - 1)
            np.add.at(w, (np.arange(n_out), idx), tw)
        return w
    raise ValueError(f"unknown resize method: {method}")


def resize_matrix(n_in: int, n_out: int, method: str, align_corners: bool) -> np.ndarray:
    return _axis_weights(n_in, n_out, method, align_corners)


def resize_nhwc(
    x: torch.Tensor,
    size: tuple[int, int],
    method: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize (N, H, W, C) [or (H, W, C)] to spatial ``size`` = (H_out, W_out)."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    n, h, w, c = x.shape
    h_out, w_out = size
    if (h, w) == (h_out, w_out):
        return x[0] if squeeze else x
    dt = x.dtype
    if method == "nearest":
        ys = torch.from_numpy(_nearest_indices(h, h_out)).to(x.device)
        xs = torch.from_numpy(_nearest_indices(w, w_out)).to(x.device)
        out = x[:, ys][:, :, xs]
        return out[0] if squeeze else out
    # torch.tensor copies: the cached matrices are read-only numpy arrays
    wy = torch.tensor(_axis_weights(h, h_out, method, align_corners), device=x.device)
    wx = torch.tensor(_axis_weights(w, w_out, method, align_corners), device=x.device)
    xf = x.float()
    # contract H: (h_out,h) x (n,h,w,c) -> (n,h_out,w,c)
    out = torch.einsum("oh,nhwc->nowc", wy, xf)
    # contract W: (o,w) x (n,h_out,w,c) -> (n,h_out,o,c)
    out = torch.einsum("ow,nhwc->nhoc", wx, out)
    out = out.to(dt)
    return out[0] if squeeze else out


def interpolate(x: torch.Tensor, size: tuple[int, int], mode: str = "bilinear", align_corners: bool = False):
    """Alias mirroring the reference's ``interpolate`` sugar (ml.cpp:782-788),
    as the JAX package's ops/resize.py:164."""
    return resize_nhwc(x, size, mode, align_corners)
