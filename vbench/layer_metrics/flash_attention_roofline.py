"""flash_attention_roofline (%, device trace; kernels:
ops/cuda/flash_attention.py, csrc/flash_attention.cu): SAM 3's global
attention layers over the traced window against their least time.

Kernels read from the trace: names holding ``flash_attention``. The work of
a forward at input (B, S, S, 3), whatever kernel implements it: one launch
a global layer (``global_attn_indexes``), each of (B x heads, T, head dim)
with T = (S / patch)^2 tokens (5184 at 1008 px) and head dim = hidden /
heads (64). Tensor FLOPs 4 B heads T^2 hd (the two products); bytes in bf16
for q, k, v and the output, 2 x 4 x B x T x hidden."""

from vbench.roofline import share

PATTERNS = ("flash_attention",)


def launches(cfg, shape):
    b, h, w, _ = shape
    t = (h // cfg["patch_size"]) * (w // cfg["patch_size"])
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    work = (4.0 * b * heads * t * t * (d // heads), 0.0, float(2 * 4 * b * t * d))
    return [work] * len(cfg["global_attn_indexes"])


def read(ctx):
    return share(ctx, PATTERNS, launches)
