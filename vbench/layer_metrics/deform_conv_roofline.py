"""deform_conv_roofline (%, device trace; kernels: ops/cuda/deform_conv.py,
csrc/deform_conv.cu): the decoder's deformable convs over the traced window
against their least time.

Kernels read from the trace: names holding ``deform_conv`` (not the column
sampler ``deform_sample``, which no served path runs). The work of a forward
at input (B, H, W, 3): five decoder blocks (the squeeze block and block4 at
the deepest level, block3 to block1 at the finer ones, the SWIN stage grids
at the image's scale), each with four deformable convs of kernel 1, 1, 3, 7
from C = decoder channels to C / 4, stride 1, the output the size of the
input. Tensor FLOPs 2 x columns x Cout (columns = B P k^2 Cin); the bilinear
blend at 7 float32 FLOPs a column element, of min(Cin, Cout) channels (the
order that blends after the product needs only Cout of them); bytes in bf16
for x, the offsets and modulators (3 k^2 a pixel), the weight and the
output."""

from vbench.roofline import share

PATTERNS = ("deform_conv",)
BLEND_FLOPS = 7.0


def launches(cfg, shape):
    b, h, w, _ = shape
    cin = cfg["decoder"]["channels"]
    cout = cin // 4
    th, tw = h // 4, w // 4
    grids = []
    for _ in cfg["swin"]["depths"]:
        grids.append(th * tw)
        th, tw = (th + 1) // 2, (tw + 1) // 2
    out = []
    for p in (grids[3], grids[3], grids[2], grids[1], grids[0]):
        for k in (1, 1, 3, 7):
            kk = k * k
            cols = b * p * kk * cin
            nbytes = 2 * (b * p * (cin + 3 * kk + cout) + kk * cin * cout)
            out.append((2.0 * cols * cout, BLEND_FLOPS * b * p * kk * min(cin, cout), float(nbytes)))
    return out


def read(ctx):
    return share(ctx, PATTERNS, launches)
