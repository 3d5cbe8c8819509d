"""conv3x3_roofline (%, device trace; kernels: ops/cuda/conv3x3.py,
csrc/conv3x3.cu): RRDBNet's 3x3 convs over the traced window against their
least time.

Kernels read from the trace: names holding ``conv3x3``. The work of a
forward at input (B, H, W, 3): the first conv (3 -> nf), 3 x 5 convs in each
of the RRDBs (conv j from nf + (j - 1) gc to gc, conv5 from nf + 4 gc to nf
with its residual, and the RRDB's in the third), the trunk conv with the
skip, one conv after each nearest 2x upsampling, the HR conv and the last
conv (nf -> 3) at the output's size. Tensor FLOPs 2 B H W Cout Cin 9; bytes
in bf16 for the input's Cin channels, the weight, the bias, each residual
and the output."""

import math

from vbench.roofline import share

PATTERNS = ("conv3x3",)


def launches(cfg, shape):
    b, h, w, _ = shape
    nf, gc, nb = cfg["num_feat"], cfg["num_grow_ch"], cfg["num_block"]

    def conv(hh, ww, cin, cout, residuals=0):
        px = b * hh * ww
        nbytes = 2 * (px * (cin + cout + residuals * cout) + 9 * cin * cout + cout)
        return (2.0 * px * cout * cin * 9, 0.0, float(nbytes))

    out = [conv(h, w, cfg["num_in_ch"], nf)]
    for _ in range(nb):
        for r in (1, 2, 3):
            out += [conv(h, w, nf + j * gc, gc) for j in range(4)]
            out.append(conv(h, w, nf + 4 * gc, nf, residuals=2 if r == 3 else 1))
    out.append(conv(h, w, nf, nf, residuals=1))
    for _ in range(int(math.log2(cfg["scale"]))):
        h, w = 2 * h, 2 * w
        out.append(conv(h, w, nf, nf))
    out += [conv(h, w, nf, nf), conv(h, w, nf, cfg["num_out_ch"])]
    return out


def read(ctx):
    return share(ctx, PATTERNS, launches)
