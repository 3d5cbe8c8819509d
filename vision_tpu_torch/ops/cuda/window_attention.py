"""Windowed multi-head attention with a per-head additive bias and an
optional per-window mask on Hopper, and its plain PyTorch version.

``window_attention`` replaces the Pallas kernel ``_kernel`` of
scripts/exp_winattn2.py (launched by that script's ``window_attention``
through ``pl.pallas_call``): for every window w and head h,

    out[w, :, h] = softmax(q[w, :, h] * scale . k[w, :, h]^T + bias[h] + mask[w % nW]) . v[w, :, h]

with q, k, v of shape (NW, T, C), C = H * hd, head h in channels
[h*hd, (h+1)*hd) (no head transposes), ``bias`` (H, T, T) shared by all
windows, or None, and ``window_mask`` (nW, T, T) in float32, or None: window
w takes mask ``w % nW``, so a mask made for one image's windows serves a
batch whose windows are ordered (image, window row, window column), as
SWIN's ``window_partition`` orders them. The mask may hold -inf (SWIN's
shifted-window zones); no row may be all -inf. Its consumers on the port's
path are every TinyViT block of the MobileSAM encoder (models/mobile_sam.py:
a bias, no mask; 10 launches per encoder batch) and every SWIN block of
BiRefNet's encoder (models/swin.py: the relative-position bias, and the
shift mask in every second block; 48 launches per BiRefNet forward at
SWIN-L, 24 of them masked), both through ops/nn.py ``attention_windows``.

Rounding follows the Pallas body: q is scaled in f32 and rounded to its type;
logits, the bias and mask adds and the softmax are f32; the probabilities
are rounded to v's type; PV accumulates in f32; the output is in q's type.
(The JAX package's XLA ``attention_windows`` keeps its logits in the input
type instead.)

The kernel (csrc/window_attention.cu) holds one (window, head) whole in
shared memory (T <= 256), so it needs no online softmax; it is bound by
launch and occupancy (thousands of tiny blocks), not by bytes. A CPU tensor
goes to :func:`window_attention_plain`; a CUDA tensor goes to the kernel or
raises. ``launches`` counts kernel launches, ``masked_launches`` those of
them that carried a ``window_mask``.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["window_attention", "window_attention_plain", "launches", "masked_launches"]

launches = 0
masked_launches = 0  # the launches of those that carried a window_mask
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_DTYPES = {torch.float32: 1, torch.bfloat16: 2}  # 0: no bias
_HEAD_DIMS = (32,)  # every TinyViT stage and every SWIN-T/-L stage
MAX_T = 256  # the kernel keeps a window's keys whole in shared memory


def window_attention_plain(q, k, v, bias, n_heads: int, scale: float, window_mask=None) -> torch.Tensor:
    """The Pallas body in plain PyTorch. q, k, v: (NW, T, C); bias: None or
    any form broadcastable to (NW, H, T, T); window_mask: None or (nW, T, T)
    with NW a multiple of nW, window w taking mask w % nW. Returns (NW, T, C)
    in q's type."""
    nw, t, c = q.shape
    hd = c // n_heads
    heads = lambda z: z.reshape(nw, t, n_heads, hd).transpose(1, 2).float()  # noqa: E731
    qs = (q.float() * scale).to(q.dtype)
    logits = torch.matmul(heads(qs), heads(k).transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.float()
    if window_mask is not None:
        n_masks = window_mask.shape[0]
        logits = logits.reshape(nw // n_masks, n_masks, n_heads, t, t) + window_mask.float()[None, :, None]
        logits = logits.reshape(nw, n_heads, t, t)
    p = torch.softmax(logits, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), heads(v))
    return out.transpose(1, 2).reshape(nw, t, c).to(q.dtype)


def _shared_bias(bias: torch.Tensor, n_heads: int, t: int) -> torch.Tensor:
    """The (H, T, T) view of a bias shared by all windows; any other form
    raises (a mask that differs per window goes in ``window_mask``)."""
    if bias.ndim == 4 and bias.shape[0] == 1:
        bias = bias[0]
    if bias.shape != (n_heads, t, t):
        raise ValueError(
            f"window_attention: the kernel takes a bias shared by all windows, (1, H, T, T) or "
            f"(H, T, T) = ({n_heads}, {t}, {t}); got {tuple(bias.shape)}. A mask that differs "
            f"per window goes in window_mask, (nW, T, T)"
        )
    return bias


def _check_window_mask(window_mask: torch.Tensor, nw: int, t: int) -> None:
    """The kernel takes a float32 (nW, T, T) mask with NW a multiple of nW."""
    if window_mask.ndim != 3 or window_mask.shape[1:] != (t, t) or not 0 < window_mask.shape[0] <= nw \
            or nw % window_mask.shape[0]:
        raise ValueError(
            f"window_attention: window_mask must be (nW, T, T) = (nW, {t}, {t}) with NW={nw} a multiple "
            f"of nW; got {tuple(window_mask.shape)}"
        )
    if window_mask.dtype != torch.float32:
        raise ValueError(f"window_attention: window_mask dtype must be float32 (got {window_mask.dtype})")


def _check(q, k, v, bias, n_heads: int, window_mask=None) -> None:
    tensors = tuple(x for x in (q, k, v, bias, window_mask) if x is not None)
    if not all(x.is_cuda for x in tensors) or len({x.device for x in tensors}) != 1:
        raise ValueError(
            "window_attention: q, k, v, bias and window_mask must lie on one CUDA device "
            f"(got {', '.join(str(x.device) for x in tensors)})"
        )
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"window_attention: dtype must be float32 or bfloat16 for all of q, k, v "
                         f"(got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"window_attention: q, k, v must share one (NW, T, C) shape "
            f"(got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)})"
        )
    nw, t, c = q.shape
    if n_heads < 1 or c % n_heads or c // n_heads not in _HEAD_DIMS:
        raise ValueError(f"window_attention: C={c} over {n_heads} heads must give a head dim in {_HEAD_DIMS}")
    if not 0 < t <= MAX_T or nw == 0 or nw * n_heads >= 2**31:
        raise ValueError(f"window_attention: need 0 < T <= {MAX_T} and NW > 0 (got NW={nw}, T={t})")
    if bias is not None and bias.dtype not in _BIAS_DTYPES:
        raise ValueError(f"window_attention: bias dtype must be float32 or bfloat16 (got {bias.dtype})")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("window_attention: q, k, v, bias and window_mask must be contiguous")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("window_attention: q, k, v, bias and window_mask must start on a 16-byte boundary")


def window_attention(q, k, v, bias, n_heads: int, scale: float, window_mask=None) -> torch.Tensor:
    """Windowed attention, q, k, v: (NW, T, C); bias: None, (1, H, T, T) or
    (H, T, T), read in its own type and added in f32; window_mask: None or
    (nW, T, T) float32, window w taking mask w % nW, added in f32. Returns
    (NW, T, C) in q's type."""
    global launches, masked_launches
    if all(x.device.type == "cpu" for x in (q, k, v, bias, window_mask) if x is not None):
        return window_attention_plain(q, k, v, bias, n_heads, scale, window_mask)
    if bias is not None:
        bias = _shared_bias(bias, n_heads, q.shape[1])
    if window_mask is not None:
        _check_window_mask(window_mask, q.shape[0], q.shape[1])
    _check(q, k, v, bias, n_heads, window_mask)
    from .build import load_library

    lib = load_library()
    nw, t, c = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vtt_window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
            None if window_mask is None else window_mask.data_ptr(),
            0 if window_mask is None else window_mask.shape[0], out.data_ptr(), nw, t, n_heads, c // n_heads,
            _DTYPES[q.dtype], 0 if bias is None else _BIAS_DTYPES[bias.dtype], float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"window_attention: kernel launch failed with cudaError {err}")
    with _count_lock:
        launches += 1
        masked_launches += window_mask is not None
    return out
