"""NN building blocks — a port of vision_tpu/ops/nn.py (reference nn layer,
src/visp/nn.{h,cpp}).

Design contract, as in the JAX package:
  * activations are NHWC (N, H, W, C) or sequence-major (N, T, C) at every
    public function; convolutions permute to NCHW views internally (a
    permuted contiguous NHWC tensor is a channels_last NCHW tensor, which
    cuDNN takes as it is).
  * weights keep **torch-canonical shapes** straight from the GGUF loader:
    linear (O, I), conv (O, I, kH, kW), conv-transpose (I, O, kH, kW).
  * matmuls/convs accumulate in f32 (PyTorch's bf16 GEMMs and convs do), and
    the result is cast back to the activation dtype.
  * ops take a ``Params`` view positioned at the module, so call sites mirror
    the C++ (``linear(p["qkv"], x)``).

Mixed types follow the JAX package's promotion, not PyTorch's habit of
raising: a product runs in the promoted type of its operands and its result
takes the activation's (or q's) type, so f32 prompts through bf16 weights
stay f32, as they do in the JAX package's SAM decoder.

LoRA adapters (``{module}.lora_a`` (r, I) / ``{module}.lora_b`` (O, r),
attached by lora.py) apply in :func:`linear` and in :func:`conv_2d` for 1x1
kernels, as in the JAX package (vision_tpu/ops/nn.py:91-110, :157-180); a
module without them runs exactly as before (one dict lookup, no extra op).
:func:`attention_windows` reads the fused qkv weight directly, so an adapter
on a window block's qkv takes no part in it there, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.errors import raise_error
from ..core.params import Params
from ..parallel import tp as _tp

__all__ = [
    "linear",
    "layer_norm",
    "layer_norm_direct",
    "batch_norm_2d",
    "conv_2d",
    "conv_3x3",
    "conv_3x3_fused",
    "conv_2d_depthwise",
    "conv_transpose_2d",
    "patch_embed",
    "split_qkv",
    "attention_route",
    "attention_core",
    "attention_windows",
    "attention",
    "gelu",
    "gelu_erf",
    "gelu_tanh",
    "leaky_relu",
    "silu",
    "max_pool_2d",
    "avg_pool_2d",
    "pad_nhwc",
    "relu",
    "sigmoid",
]


def gelu(x: torch.Tensor) -> torch.Tensor:
    # tanh form — the reference's ggml_gelu IS the tanh approximation, and
    # the JAX package's gelu is jax.nn.gelu(approximate=True)
    return F.gelu(x, approximate="tanh")


gelu_tanh = gelu  # explicit-name alias, as in the JAX package


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """The exact erf form (torch's nn.GELU default), as the JAX package's
    ``jax.nn.gelu(approximate=False)``."""
    return F.gelu(x)


relu = torch.relu
sigmoid = torch.sigmoid
silu = F.silu  # x * sigmoid(x), as jax.nn.silu


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """As the JAX package's: ``where(x >= 0, x, x * slope)`` in x's type."""
    return torch.where(x >= 0, x, x * negative_slope)


def _promoted(*ts: torch.Tensor) -> torch.dtype:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T + b (reference nn.cpp:6-12). W is (O, I).

    As in the JAX package: the product runs in the promoted type of x and W
    (f32 accumulation), its result is cast to x's type, and the bias is
    added with promotion. A LoRA pair next to the weight adds ``(x @ A^T) @
    B^T``, each product in x's type, the sum with the base's in f32 before
    the cast (the JAX package keeps the base's f32 sum; at f32 the two are
    the same)."""
    w = p.weight("weight")
    if type(w) is not torch.Tensor and _tp.is_dtensor(w):
        return _tp.linear(p, x)
    dt = _promoted(x, w)
    y = F.linear(x.to(dt), w.to(dt))
    a = p.find("lora_a")
    if a is not None:
        h = F.linear(x, a.to(x.dtype))
        y = y.float() + F.linear(h, p.weight("lora_b").to(x.dtype)).float()
    y = y.to(x.dtype)
    b = p.find("bias")
    if b is not None:
        y = y + b
    return y


def layer_norm_direct(x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """Normalize over the last axis with f32 statistics."""
    y = F.layer_norm(
        x.float(),
        (x.shape[-1],),
        weight.float(),
        bias.float() if bias is not None else None,
        eps,
    )
    return y.to(x.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Reference nn.cpp:14-19 (ggml_norm + scale + shift)."""
    return layer_norm_direct(x, p.weight("weight"), p.weight("bias"), eps)


def batch_norm_2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """BN must be fused to mul+add at conversion (reference nn.cpp:150-164)."""
    if p.find("running_mean") is not None or p.find("running_var") is not None:
        raise_error("batch norm was not fused at conversion (running stats present)")
    return x * p.weight("weight") + p.weight("bias")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv_2d(p: Params, x: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """2D conv, torch-canonical (O,I,kH,kW) weight (reference nn.cpp:72-100).

    A LoRA pair next to a 1x1 weight (lora.py attaches them only there)
    adds two rank-r 1x1 convs, the first with the base conv's stride and
    padding, each rounded to x's type and added in it, as in the JAX
    package."""
    xc = _nchw(x)
    y = F.conv2d(xc, p.weight("weight"), None, stride, pad)
    a = p.find("lora_a")
    if a is not None:
        h = F.conv2d(xc, a.to(x.dtype)[:, :, None, None], None, stride, pad)
        y = y + F.conv2d(h, p.weight("lora_b").to(x.dtype)[:, :, None, None])
    y = _nhwc(y)
    b = p.find("bias")
    if b is not None:
        y = y + b
    return y


def conv_3x3(p: Params, x: torch.Tensor) -> torch.Tensor:
    """3x3, stride-1, pad-1 conv with a torch-canonical (O, I, 3, 3) weight
    and its bias, through the hand-written kernel's wrapper
    (:func:`~vision_tpu_torch.ops.cuda.conv3x3.conv3x3`: the kernel on a CUDA
    tensor, its plain version on a CPU one). As the JAX package's
    ``conv_2d(p, x, 1, 1)``, except that the bias joins the f32 sum before
    the one rounding to x's type (the JAX package rounds the conv, then adds
    the bias in x's type). Real-ESRGAN's and YOLOv9t's stride-1 3x3 convs
    take this kernel (through :func:`conv_3x3_fused`); the other families
    keep :func:`conv_2d`."""
    return conv_3x3_fused(p, x.contiguous())


def conv_3x3_fused(p: Params, x: torch.Tensor, *, bn: Params | None = None, silu: bool = False, slope=None,
                   r1=None, s1: float = 1.0, r2=None, s2: float = 1.0, out=None) -> torch.Tensor:
    """:func:`conv_3x3` with the kernel's epilogue: ``r2 + s2 * act(r1 + s1
    * (scale * (conv + bias) + shift))`` in f32, rounded once to x's type.
    ``bn`` is a BatchNorm fused at conversion (its ``weight`` is the scale,
    its ``bias`` the shift, as :func:`batch_norm_2d`); ``act`` is SiLU with
    ``silu``, leaky ReLU with ``slope``, else the identity; r1 and r2 are
    optional. x, r1, r2 and ``out`` may be channel views of wider NHWC
    buffers; with ``out`` the result is written there. Real-ESRGAN's convs
    (bias, leaky ReLU, residuals) and YOLOv9t's stride-1 3x3 convs (BN,
    SiLU, a RepConv's 1x1 branch as r1, a bottleneck's shortcut as r2) take
    this path. Under autograd the wrapper goes through its
    ``Conv3x3Fn`` (ops/cuda/conv3x3.py), where ``out`` raises."""
    from .cuda.conv3x3 import conv3x3

    w = p.weight("weight")
    if w.ndim != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"conv_3x3: the weight must be (O, I, 3, 3) (got {tuple(w.shape)})")
    vec = lambda t: None if t is None else t.to(x.dtype).contiguous()  # noqa: E731
    scale = shift = None
    if bn is not None:
        if bn.find("running_mean") is not None or bn.find("running_var") is not None:
            raise_error("batch norm was not fused at conversion (running stats present)")
        scale, shift = vec(bn.weight("weight")), vec(bn.weight("bias"))
    return conv3x3(x, w.to(x.dtype).contiguous(), vec(p.find("bias")), scale=scale, shift=shift, silu=silu,
                   slope=slope, r1=r1, s1=s1, r2=r2, s2=s2, out=out)


def conv_2d_depthwise(p: Params, x: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Depthwise conv, torch (C,1,kH,kW) weight (reference nn.cpp:102-115)."""
    w = p.weight("weight")
    y = _nhwc(F.conv2d(_nchw(x), w, None, stride, pad, groups=w.shape[0]))
    b = p.find("bias")
    if b is not None:
        y = y + b
    return y


def conv_transpose_2d(p: Params, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Transposed conv, pad 0, torch (I,O,kH,kW) weight (nn.cpp:117-129;
    ggml_conv_transpose_2d_p0)."""
    y = F.conv_transpose2d(_nchw(x), p.weight("weight"), None, stride)
    y = _nhwc(y)
    b = p.find("bias")
    if b is not None:
        y = y + b
    return y


def patch_embed(p: Params, x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Patch-size conv + optional LN (reference nn.cpp:166-180).
    x: (N, H, W, C) with H, W divisible by patch_size -> (N, H/p, W/p, C')."""
    if x.shape[1] % patch_size or x.shape[2] % patch_size:
        raise ValueError(f"patch_embed: extent {tuple(x.shape[1:3])} not divisible by {patch_size}")
    proj = "proj" if p.has("proj.weight") else "projection"
    x = conv_2d(p[proj], x, stride=patch_size)
    if p.has("norm.weight"):
        x = layer_norm(p["norm"], x)
    return x


def split_qkv(p: Params, x: torch.Tensor, n_heads: int, split_dim: int):
    """Fused qkv linear -> (q, k, v) each (B, heads, T, head_dim)
    (reference nn.cpp:182-208). split_dim selects the fused layout:
      1 -> per-head [q|k|v] interleaving (TinyViT style)
      2 -> global [q..|k..|v..] ordering (torch nn.Linear(3*dim) style)
    """
    b, t = x.shape[0], x.shape[1]
    qkv = linear(p, x)  # (B, T, 3C)
    hd = qkv.shape[-1] // 3 // n_heads
    if split_dim == 1:
        qkv = qkv.reshape(b, t, n_heads, 3, hd)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]  # (B,T,H,hd)
    elif split_dim == 2:
        qkv = qkv.reshape(b, t, 3, n_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B,T,H,hd)
    else:
        raise ValueError("Unsupported split_dim")
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


# -- attention routing policy: the JAX package's table (ops/nn.py:260-294),
# with its "pallas" route served by the hand-written CUDA kernel --
#
# | flash | mask | T_q          | route          |
# |-------|------|--------------|----------------|
# | no    | any  | any          | naive          |
# | yes   | none | >= 1024      | cuda           |
# | yes   | yes  | <= 512       | fused_logits   |
# | yes   | else | else         | xla_fused      |
#
# The "cuda" route needs tensors the kernel's wrapper serves: CUDA tensors
# go to the kernel, which has instances for head dims 32, 64, 80 and 128
# only (any other takes xla_fused on the card, where the JAX package's
# Pallas kernel takes any D), and CPU tensors to its plain version at any
# head dim (the CPU tests reach the route that way).

CUDA_MIN_T = 1024
FUSED_LOGIT_MAX_T = 512


def attention_route(t_q: int, has_mask: bool, flash: bool, cuda_ok: bool | None = None,
                    head_dim: int | None = None) -> str:
    """Resolve which attention implementation attention_core will use.
    ``cuda_ok`` says whether the flash kernel's wrapper serves the tensors;
    None asks whether this process has a CUDA device. ``head_dim``, given
    for CUDA tensors, keeps the flash kernel to the head dims it has (None:
    no such limit, as for the plain version that CPU tensors take)."""
    from .cuda.flash_attention import HEAD_DIMS

    if not flash:
        return "naive"
    if not has_mask and t_q >= CUDA_MIN_T and (head_dim is None or head_dim in HEAD_DIMS):
        if cuda_ok is None:
            cuda_ok = torch.cuda.is_available()
        if cuda_ok:
            return "cuda"
    if has_mask and t_q <= FUSED_LOGIT_MAX_T:
        return "fused_logits"
    return "xla_fused"


def attention_core(q, k, v, mask=None, scale: float | None = None, flash: bool = False):
    """softmax(q k^T * scale + mask) v with f32 accumulation
    (reference nn.cpp:210-237). q,k,v: (B, H, T, hd); mask broadcastable to
    (B, H, Tq, Tk). The ``flash`` flag routes per attention_route.

    q, k and v may differ in type (the SAM decoder's image-to-token
    attention takes bf16 q and f32 k/v): every product runs in the promoted
    type with f32 accumulation, the probabilities are cast to q's type and
    the output is in q's type, as in the JAX package (ops/nn.py:297-334)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # the flash kernel's wrapper serves CPU tensors (its plain version, at
    # any head dim) and CUDA tensors at the head dims the kernel has
    on_cuda = q.device.type == "cuda"
    cuda_ok = on_cuda or q.device.type == "cpu"
    route = attention_route(int(q.shape[2]), mask is not None, flash, cuda_ok, int(q.shape[-1]) if on_cuda else None)
    dt = _promoted(q, k, v)
    if route == "cuda":
        from .cuda.flash_attention import flash_attention

        # the kernel takes one type; mixed inputs run in the promoted one
        out = flash_attention(
            q.to(dt).contiguous(), k.to(dt).contiguous(), v.to(dt).contiguous(), scale=float(scale)
        )
        return out.to(q.dtype)
    if route == "fused_logits":
        # logits in the input dtype, f32 softmax (JAX ops/nn.py:309-313)
        attn = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) * scale
        attn = attn + mask.to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        return torch.matmul(attn.to(dt), v.to(dt)).to(q.dtype)
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        # the xla_fused route (jax.nn.dot_product_attention's XLA form) rounds
        # its bias to q's type first; the naive route adds it in f32
        attn = attn + (mask.to(q.dtype) if route == "xla_fused" else mask).float()
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn.to(dt), v.to(dt)).to(q.dtype)


def attention_windows(
    p: Params, x: torch.Tensor, n_heads: int, split_dim: int, mask, scale: float, window_mask=None
):
    """Windowed attention from the fused qkv weight, without head transposes
    (a port of the JAX package's ops/nn.py:337).

    The fused qkv weight is split into three (C, C) projections so q, k and
    v come out as (B, T, C) with head h in channels [h*hd, (h+1)*hd); the
    attention itself is :func:`~vision_tpu_torch.ops.cuda.window_attention.window_attention`
    (the hand-written kernel on a CUDA tensor, its plain version on a CPU
    one), then the ``proj`` linear. The route does not depend on the flash
    flag.

    p: params with ``qkv`` and ``proj`` children; x: (B, T, C); mask: None or
    an additive bias shared by all windows, (1, heads, T, T) or (heads, T, T)
    (the CPU's plain version takes any form broadcastable to
    (B, heads, T, T)); window_mask: None or an additive mask (nW, T, T) that
    window b takes as ``window_mask[b % nW]`` (SWIN's shifted-window zones,
    windows ordered image-major), added in f32 after ``mask``; returns
    (B, T, C). The JAX package takes one combined mask instead; the sum is
    the same."""
    from .cuda.window_attention import window_attention

    c = x.shape[-1]
    hd = c // n_heads
    # with a tp-sharded qkv this rank holds the rows of its own heads, in
    # the same layout (regrouped at placement), and attends over them alone
    heads = _tp.head_slice(p["qkv"], n_heads)
    nh = heads.stop - heads.start
    cl = nh * hd
    wq = p["qkv"].weight("weight")  # the one lookup of the weight (a dequant when it is resident)
    w = _tp.local(wq)
    bb = _tp.local(p["qkv"].weight("bias"))
    if split_dim == 1:  # per-head [q|k|v] interleaving (TinyViT style)
        w3 = w.reshape(nh, 3, hd, c)
        b3 = bb.reshape(nh, 3, hd)
        wi = lambda i: w3[:, i].reshape(cl, c)
        bi = lambda i: b3[:, i].reshape(cl)
    elif split_dim == 2:  # global [q..|k..|v..] ordering (torch style)
        wi = lambda i: w.reshape(3, cl, c)[i]
        bi = lambda i: bb.reshape(3, cl)[i]
    else:
        raise ValueError("Unsupported split_dim")
    if mask is not None and nh != n_heads:
        mask = _tp.scatter_to(mask, -3, wq).contiguous()
    # the bias joins the f32 accumulation before the one rounding to x's
    # type, as in the JAX package's split projections
    q, k, v = (F.linear(x, wi(i).to(x.dtype), bi(i).to(x.dtype)) for i in range(3))
    if window_mask is not None:
        window_mask = window_mask.float().contiguous()
    o = window_attention(q, k, v, mask, nh, scale, window_mask)
    return linear(p["proj"], _tp.gather_for(o, p["qkv"], p["proj"]))


def attention(p_out: Params, q, k, v, mask=None, scale: float | None = None, flash: bool = False):
    """Full shared attention incl. fused output projection (nn.cpp:210-244).
    Returns (B, T, C)."""
    x = attention_core(q, k, v, mask, scale, flash)
    b, h, t, hd = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, h * hd)
    return linear(p_out, x)


# -- pooling (ggml_pool_2d; SAM3's FPN, YOLOv9t's SPPELAN) --


def max_pool_2d(x: torch.Tensor, kernel: int, stride: int | None = None, pad: int = 0) -> torch.Tensor:
    """NHWC max pool (a port of the JAX package's ops/nn.py:397-407). The
    padding takes the dtype's lowest finite value, as the JAX op's
    ``reduce_window`` init does; windows run only where they fit whole in
    the padded input (floor mode)."""
    stride = stride or kernel
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad), value=torch.finfo(x.dtype).min)
    y = x.unfold(1, kernel, stride).unfold(2, kernel, stride)  # (N, Ho, Wo, C, k, k)
    return y.amax(dim=(-2, -1))


def avg_pool_2d(x: torch.Tensor, kernel: int, stride: int | None = None, pad: int = 0,
                count_include_pad: bool = True) -> torch.Tensor:
    """NHWC average pool (a port of the JAX package's ops/nn.py:410-431): the
    window sums in f32, over kernel^2 (with ``count_include_pad``, or no
    padding) or over the window's cells inside the input; windows only where
    they fit whole in the padded input; one cast back to x's type. YOLOv9t's
    AConv calls it with kernel 2, stride 1."""
    stride = stride or kernel
    xf = F.pad(x.float(), (0, 0, pad, pad, pad, pad)) if pad else x.float()
    summed = xf.unfold(1, kernel, stride).unfold(2, kernel, stride).sum(dim=(-2, -1))
    if count_include_pad or pad == 0:
        out = summed / (kernel * kernel)
    else:
        ones = F.pad(x.new_ones((1, *x.shape[1:3], 1), dtype=torch.float32), (0, 0, pad, pad, pad, pad))
        out = summed / ones.unfold(1, kernel, stride).unfold(2, kernel, stride).sum(dim=(-2, -1))
    return out.to(x.dtype)


def pad_nhwc(x: torch.Tensor, pad_h: tuple[int, int], pad_w: tuple[int, int], value: float = 0.0) -> torch.Tensor:
    """Constant padding of H and W (the JAX package's ops/nn.py:434)."""
    return F.pad(x, (0, 0, pad_w[0], pad_w[1], pad_h[0], pad_h[1]), value=value)
