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

LoRA adapters, depthwise/batch-norm/pooling ops and windowed attention wait
for the slices that use them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.params import Params

__all__ = [
    "linear",
    "layer_norm",
    "layer_norm_direct",
    "conv_2d",
    "conv_transpose_2d",
    "patch_embed",
    "attention_route",
    "attention_core",
    "attention",
    "gelu",
    "relu",
]


def gelu(x: torch.Tensor) -> torch.Tensor:
    # tanh form — the reference's ggml_gelu IS the tanh approximation, and
    # the JAX package's gelu is jax.nn.gelu(approximate=True)
    return F.gelu(x, approximate="tanh")


relu = torch.relu


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T + b (reference nn.cpp:6-12). W is (O, I)."""
    y = F.linear(x, p.weight("weight"))
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


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv_2d(p: Params, x: torch.Tensor, stride: int = 1, pad: int = 0) -> torch.Tensor:
    """2D conv, torch-canonical (O,I,kH,kW) weight (reference nn.cpp:72-100)."""
    y = F.conv2d(_nchw(x), p.weight("weight"), None, stride, pad)
    y = _nhwc(y)
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
# go to the kernel, CPU tensors to its plain version (the CPU tests reach
# the route that way).

CUDA_MIN_T = 1024
FUSED_LOGIT_MAX_T = 512


def attention_route(t_q: int, has_mask: bool, flash: bool, cuda_ok: bool | None = None) -> str:
    """Resolve which attention implementation attention_core will use.
    ``cuda_ok`` says whether the flash kernel's wrapper serves the tensors;
    None asks whether this process has a CUDA device."""
    if not flash:
        return "naive"
    if not has_mask and t_q >= CUDA_MIN_T:
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
    (B, H, Tq, Tk). The ``flash`` flag routes per attention_route."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    cuda_ok = q.device.type in ("cuda", "cpu")
    route = attention_route(int(q.shape[2]), mask is not None, flash, cuda_ok)
    if route == "cuda":
        from .cuda.flash_attention import flash_attention

        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale=float(scale))
    if route == "fused_logits":
        # logits in the input dtype, f32 softmax (JAX ops/nn.py:309-313)
        attn = torch.matmul(q, k.transpose(-1, -2)) * scale
        attn = attn + mask.to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        return torch.matmul(attn, v)
    if route == "xla_fused":
        # jax.nn.dot_product_attention's XLA form: f32 logits, probabilities
        # cast to the input dtype, PV in the input dtype
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if mask is not None:
            attn = attn + mask.to(q.dtype).float()
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        return torch.matmul(attn, v)
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        attn = attn + mask.float()
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.matmul(attn, v)


def attention(p_out: Params, q, k, v, mask=None, scale: float | None = None, flash: bool = False):
    """Full shared attention incl. fused output projection (nn.cpp:210-244).
    Returns (B, T, C)."""
    x = attention_core(q, k, v, mask, scale, flash)
    b, h, t, hd = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, h * hd)
    return linear(p_out, x)
