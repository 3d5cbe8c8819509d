"""window_attention_roofline (%, device trace; kernels:
ops/cuda/window_attention.py, csrc/window_attention.cu): SWIN's window
attention over the traced window against its least time.

Kernels read from the trace: names holding ``window_attention``. The work
of a forward at input (B, H, W, 3): SWIN on the image and on its half-scale
copy; at each stage s the token grid (H/4 at the image's scale, halved,
rounded up, after each stage) padded to the window, B x nW windows of N =
window^2 tokens, C = embed x 2^s channels; one launch a block. Tensor FLOPs
4 B nW N^2 C (the two products); bytes in bf16 for q, k, v and the output,
the relative position bias (heads x N x N, bf16) and, in every second
(shifted) block, the shift mask (nW x N x N, float32)."""

from vbench.roofline import share

PATTERNS = ("window_attention",)


def launches(cfg, shape):
    b, h, w, _ = shape
    sw = cfg["swin"]
    win = sw["window_size"]
    n = win * win
    out = []
    for scale in (1, 2):
        th, tw = h // scale // 4, w // scale // 4
        for s, (depth, heads) in enumerate(zip(sw["depths"], sw["num_heads"])):
            c = sw["embed_dim"] * 2**s
            nw = -(-th // win) * -(-tw // win)
            for i in range(depth):
                nbytes = 2 * 4 * b * nw * n * c + 2 * heads * n * n + (4 * nw * n * n if i % 2 else 0)
                out.append((4.0 * b * nw * n * n * c, 0.0, float(nbytes)))
            th, tw = (th + 1) // 2, (tw + 1) // 2
    return out


def read(ctx):
    return share(ctx, PATTERNS, launches)
