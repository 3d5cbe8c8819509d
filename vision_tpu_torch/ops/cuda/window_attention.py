"""Windowed multi-head attention with a per-head additive bias and an
optional per-window mask on Hopper, and its plain PyTorch version.

``window_attention`` replaces the Pallas kernel ``_kernel`` at
scripts/exp_winattn2.py:19 (launched by that script's ``window_attention``
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

The kernel (csrc/window_attention.cu) is bound by bytes on the card: a
(window, head) problem at SWIN-L's T 144 moves 37 KB of q, k, v and o for
2.7 MFLOP, and its logits need T x T bias and mask values, 124 KB if read per
logit. So a block takes one mask class (window w takes mask w % nW: the same
window position in every image) or a run of windows, times a group of heads;
it stages the class's mask and its heads' biases in shared memory once, and
reads them from there for every problem; one warp per 16-row tile; the next
problem's q, k and v arrive by cp.async into a double buffer while this one
computes, and the fragments come through ldmatrix (``.trans`` for V). The
launch plan, :func:`window_plan`, mirrors the kernel library's own (which
``vtt_window_attention_plan`` reports), so the CPU tests can hold it to
covering every (window, head) once and filling two waves of the card. It
replaces the one-block-per-(window, head) kernel that read the bias and mask
per logit.

The wrapper calls the operator ``vtt::window_attention``
(ops/cuda/library.py): on CPU tensors its implementation is
:func:`window_attention_plain`, on CUDA tensors :func:`launch`, which runs
the kernel or raises. ``launches`` counts kernel launches, ``masked_launches``
those of them that carried a ``window_mask``.

Under autograd (grad mode on and q, k, v or the bias requiring grad) the
wrapper goes through :class:`WindowAttentionFn`: the forward is the same
route, the backward PyTorch ops that recompute the probabilities at the
forward's rounding. The bias gets its gradient (SWIN's relative-position
table is a trainable leaf: the gather that builds the bias scatters it
back); the window mask gets none.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from . import count_launch
from .conv3x3 import _detached

__all__ = ["WindowAttentionFn", "window_attention", "window_attention_plain", "window_plan", "WindowPlan", "launches",
           "masked_launches"]

launches = 0
masked_launches = 0  # the launches of those that carried a window_mask
_count_lock = threading.Lock()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BIAS_DTYPES = {torch.float32: 1, torch.bfloat16: 2}  # 0: no bias
_HEAD_DIMS = (32,)  # every TinyViT stage and every SWIN-T/-L stage
MAX_T = 256  # the kernel keeps a window's keys whole in shared memory

# the card, as the bf16 kernel's launch plan sees it (csrc/window_attention.cu)
SMS = 132  # SMs of an H100 SXM
SMEM_MAX = 232_448  # dynamic shared memory a block may use
SMEM_PER_SM = 233_472  # shared memory of an SM; each block also takes 1 KB
MAX_REGS = 128  # registers a thread of the bf16 kernel may use
_ROW = 64  # bytes of one head's q, k or v row (hd 32, bf16)


class WindowPlan(NamedTuple):
    """How the bf16 kernel covers (NW, H) problems: ``blocks`` blocks of
    ``threads`` threads and ``smem`` bytes of shared memory, each taking
    ``heads`` heads of up to ``run`` windows of one mask class; ``staged``:
    the mask and the biases sit in shared memory (else they are read from
    L2). ``classes`` is nW, or 1 without a mask; ``blocks_per_sm`` what
    shared memory, threads and registers let one SM hold."""

    blocks: int
    threads: int
    smem: int
    heads: int
    run: int
    staged: bool
    classes: int
    blocks_per_sm: int

    @property
    def waves(self) -> float:
        return self.blocks / (SMS * self.blocks_per_sm)

    def problems(self, nw: int, n_heads: int):
        """Each block's (window, head) problems, in block order, as the
        kernel walks them."""
        per_class = nw // self.classes
        groups = n_heads // self.heads
        runs = -(-per_class // self.run)
        for b in range(self.blocks):
            h0, i0, m = b % groups * self.heads, b // groups % runs * self.run, b // groups // runs
            yield [(m + self.classes * i, h0 + hl) for i in range(i0, min(i0 + self.run, per_class))
                   for hl in range(self.heads)]


def _padded(t: int) -> int:
    """The smallest row length >= t that is 8 mod 16 (conflict-free 8-byte
    reads of the staged mask and bias)."""
    return t + (24 - t % 16) % 16


def window_plan(nw: int, t: int, n_heads: int, n_masks: int = 0, bias_bytes: int = 2) -> WindowPlan:
    """The bf16 kernel's launch plan for q of (NW, T, H * 32), ``n_masks``
    per-window masks (0: none) and a bias of ``bias_bytes`` per element (0:
    none). The kernel library computes the same (plan() in
    csrc/window_attention.cu; chip_smoke.py compares the two): the largest
    head group whose biases fit beside the mask and the q/k/v double buffer,
    then smaller head groups, then halved window runs, until the grid fills
    two waves of the card's SMs."""
    n = -(-t // 16)
    tiles = n if n <= 4 else 7 if n <= 7 else 9 if n <= 9 else 13 if n <= 13 else 16
    qkv = 2 * 3 * 16 * tiles * _ROW
    mask = -(-t * _padded(t) * 4 // 16) * 16 if n_masks else 0
    bias = -(-t * _padded(t) * bias_bytes // 16) * 16

    def smem(heads: int, staged: bool) -> int:
        return mask + heads * bias + qkv if staged else qkv

    classes, threads = n_masks or 1, 32 * tiles
    staged = smem(1, True) <= SMEM_MAX
    heads = n_heads
    while smem(heads, staged) > SMEM_MAX or n_heads % heads:
        heads -= 1
    per_class, run = nw // classes, nw // classes
    while True:
        size = smem(heads, staged)
        blocks = classes * -(-per_class // run) * (n_heads // heads)
        per_sm = min(SMEM_PER_SM // (size + 1024), 2048 // threads, 65536 // (threads * MAX_REGS))
        if blocks >= 2 * SMS * per_sm:
            break
        if heads > 1:
            heads -= 1
            while n_heads % heads:
                heads -= 1
        elif run > 1:
            run = (run + 1) // 2
        else:
            break
    return WindowPlan(blocks, threads, size, heads, run, staged, classes, per_sm)


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
    (NW, T, C) in q's type, through the operator ``vtt::window_attention``
    (ops/cuda/library.py)."""
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in (q, k, v, bias)):
        return WindowAttentionFn.apply(q, k, v, bias, window_mask, n_heads, scale)
    return torch.ops.vtt.window_attention(q, k, v, bias, int(n_heads), float(scale), window_mask)


def launch(q, k, v, bias, n_heads: int, scale: float, window_mask=None) -> torch.Tensor:
    """The kernel on CUDA tensors (the operator's CUDA implementation):
    check, launch on the current stream, count."""
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
    count_launch(__name__, launches=1, masked_launches=int(window_mask is not None))
    return out


class WindowAttentionFn(torch.autograd.Function):
    """:func:`window_attention` with gradients for q, k, v and the bias.

    Forward: the wrapper's route (the kernel on CUDA tensors, one counted
    launch; :func:`window_attention_plain` on CPU ones). Backward, in f32
    PyTorch ops: the probabilities are recomputed at the forward's rounding
    (q scaled in f32 and rounded to its type, f32 logits plus the bias and
    the mask, f32 softmax), ``dV = P^T dO`` with P rounded to v's type as
    the forward multiplied it, and the softmax's ``dL = P * (dP - rowsum(dP
    * P))``, whose -inf entries have P = 0 and so give 0, not NaN (no row is
    all -inf). The bias's gradient is dL summed to the bias's shape; the
    window mask gets none."""

    @staticmethod
    def forward(ctx, q, k, v, bias, window_mask, n_heads, scale):
        out = window_attention(*_detached(q, k, v, bias), n_heads, scale, window_mask)
        ctx.save_for_backward(q, k, v, bias, window_mask)
        ctx.n_heads, ctx.scale = n_heads, scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, bias, window_mask = ctx.saved_tensors
        n_heads, scale = ctx.n_heads, ctx.scale
        nw, t, c = q.shape
        hd = c // n_heads
        heads = lambda z: z.reshape(nw, t, n_heads, hd).transpose(1, 2).float()  # noqa: E731
        merge = lambda z, like: z.transpose(1, 2).reshape(nw, t, c).to(like.dtype)  # noqa: E731
        qs, kh = heads((q.float() * scale).to(q.dtype)), heads(k)
        logits = torch.matmul(qs, kh.transpose(-1, -2))
        if bias is not None:
            logits = logits + bias.float()
        if window_mask is not None:
            n_masks = window_mask.shape[0]
            logits = (logits.reshape(nw // n_masks, n_masks, n_heads, t, t)
                      + window_mask.float()[None, :, None]).reshape(nw, n_heads, t, t)
        p = torch.softmax(logits, dim=-1)
        del logits
        g = heads(grad)
        g_v = merge(torch.matmul(p.to(v.dtype).float().transpose(-1, -2), g), v)
        g_p = torch.matmul(g, heads(v).transpose(-1, -2))
        g_l = p * (g_p - (g_p * p).sum(-1, keepdim=True))
        del g_p, p
        g_bias = g_l.sum_to_size(bias.shape).to(bias.dtype) if bias is not None and ctx.needs_input_grad[3] else None
        g_q = merge(torch.matmul(g_l, kh) * scale, q)
        g_k = merge(torch.matmul(g_l.transpose(-1, -2), qs), k)
        return g_q, g_k, g_v, g_bias, None, None, None
