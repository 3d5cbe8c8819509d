"""Plain reference of BiRefNet "general" with the ``swin_v1_l`` backbone
(github.com/ZhengPeng7/BiRefNet, ``config.py``), in float32 PyTorch, written
from the published architecture as the vision.cpp converter names its
weights. It imports nothing of the program.

- Input: u8 pixels / 255, ImageNet mean and standard deviation.
- Encoder: SWIN v1 (patch 4 conv and layer norm; shifted-window blocks with
  the relative position bias and, in every second block, the shift mask;
  patch merging) on the image and on its half-scale copy (bilinear,
  align_corners=True); each level concatenates the upscaled half-scale
  level, and the deepest level also the first three levels resized to it.
- Decoder: a squeeze block on the deepest level, then four blocks from deep
  to fine, each ``conv_in`` 3x3 + ReLU, deformable ASPP (four branches of
  deformable conv v2, kernel 1 / 1 / 3 / 7, each with its BatchNorm, fused
  to scale and shift, and ReLU; a global-pool branch; a 1x1 conv + ReLU) and
  ``conv_out`` 3x3; lateral 1x1 convs, image patches injected at every
  level (``b (hg h) (wg w) c -> b h w (c hg wg)``), gdt gating on the
  three deepest outputs, a last 1x1 conv and a sigmoid.
- The deformable conv samples bilinearly at p * stride - pad + k + offset,
  zero outside the image, times the modulator 2 * sigmoid(conv).

One departure from the published model, as the vision.cpp models that the
program serves run it: GELU in its tanh form (the published ``nn.GELU`` is
the erf form; the two differ by less than 3e-4). Padded tokens of an
extent that the window does not divide take part in attention unmasked, as
in the published SWIN.

The served answer is the matte at the request's extent: the sigmoid
clamped to [0, 1], times 255, truncated to u8.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import Precision, exact_matmul, resize_bilinear_ac

__all__ = ["forward", "expected_u8"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
DEFORM_CHUNK_BYTES = 256 << 20  # columns of one deformable conv computed at once


class _Net:
    def __init__(self, w: dict, cfg: dict, precision: str):
        self.w = w
        self.p = Precision(precision)
        sw = cfg["swin"]
        self.window = sw["window_size"]
        self.depths = sw["depths"]
        self.heads = sw["num_heads"]

    # -- plain layers, NHWC ---------------------------------------------------

    def ln(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"], 1e-5)

    def linear(self, name, x):
        return self.p.linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))

    def conv(self, name, x, stride=1, pad=0):
        y = self.p.conv2d(x.permute(0, 3, 1, 2), self.w[f"{name}.weight"], self.w.get(f"{name}.bias"), stride, pad)
        return y.permute(0, 2, 3, 1)

    # -- SWIN -----------------------------------------------------------------

    def shift_mask(self, w, h, device):
        """(nW, N, N) 0 / -inf: tokens of different shift zones in a window
        (the last row and column of windows) do not attend to each other."""
        n, s = self.window, self.window // 2
        nwx, nwy = -(-w // n), -(-h // n)
        zy = (np.arange(nwy * n) < nwy * n - s).astype(np.int64)
        zx = (np.arange(nwx * n) < nwx * n - s).astype(np.int64)
        zone = zy[:, None] * 2 + zx[None, :]  # (Hp, Wp)
        zone = zone.reshape(nwy, n, nwx, n).transpose(0, 2, 1, 3).reshape(nwy * nwx, n * n)
        mask = np.where(zone[:, :, None] != zone[:, None, :], -np.inf, 0.0).astype(np.float32)
        return torch.from_numpy(mask).to(device)

    def rel_bias(self, name, heads, device):
        """(heads, N, N): table[(yi - yj + n - 1) (2n - 1) + xi - xj + n - 1]."""
        n = self.window
        yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        ys, xs = yy.reshape(-1), xx.reshape(-1)
        idx = (ys[:, None] - ys[None, :] + n - 1) * (2 * n - 1) + (xs[:, None] - xs[None, :] + n - 1)
        table = self.w[f"{name}.relative_position_bias_table"]  # ((2n-1)^2, heads)
        index = torch.from_numpy(idx.reshape(-1)).to(device)
        return table[index].reshape(n * n, n * n, heads).permute(2, 0, 1)

    def attention(self, name, xw, heads, mask):
        """Window attention, xw (B nW, N, C); mask (nW, N, N) or None."""
        bw, t, c = xw.shape
        hd = c // heads
        qkv = self.linear(f"{name}.qkv", xw).reshape(bw, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (Bw, heads, N, hd)
        logits = self.p.matmul(q * (1.0 / math.sqrt(hd)), k.transpose(-1, -2))
        logits = logits + self.rel_bias(name, heads, xw.device)[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(bw // nw, nw, heads, t, t) + mask[None, :, None]).reshape(bw, heads, t, t)
        out = self.p.matmul(torch.softmax(logits, dim=-1), v)
        return self.linear(f"{name}.proj", out.transpose(1, 2).reshape(bw, t, c))

    def block(self, name, x, w, h, heads, shift, mask):
        b, t, c = x.shape
        n = self.window
        y = self.ln(f"{name}.norm1", x).reshape(b, h, w, c)
        pr, pb = (n - w % n) % n, (n - h % n) % n
        y = F.pad(y, (0, 0, 0, pr, 0, pb))
        hp, wp = h + pb, w + pr
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = y.reshape(b, hp // n, n, wp // n, n, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, n * n, c)
        y = self.attention(f"{name}.attn", y, heads, mask if shift else None)
        y = y.reshape(b, hp // n, wp // n, n, n, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w].reshape(b, t, c)
        mlp = self.linear(f"{name}.mlp.fc2", F.gelu(self.linear(f"{name}.mlp.fc1", self.ln(f"{name}.norm2", x)),
                                                     approximate="tanh"))
        return x + mlp

    def merge(self, name, x, w, h):
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.linear(f"{name}.reduction", self.ln(f"{name}.norm", x.reshape(b, -1, 4 * c)))

    def swin(self, x):
        x = self.ln("bb.patch_embed.norm", self.conv("bb.patch_embed.proj", x, stride=4))
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        outs = []
        for s, depth in enumerate(self.depths):
            mask = self.shift_mask(w, h, x.device)
            for i in range(depth):
                shift = 0 if i % 2 == 0 else self.window // 2
                x = self.block(f"bb.layers.{s}.blocks.{i}", x, w, h, self.heads[s], shift, mask)
            outs.append(self.ln(f"bb.norm{s}", x).reshape(b, h, w, -1))
            if s < len(self.depths) - 1:
                x = self.merge(f"bb.layers.{s}.downsample", x, w, h)
                w, h = (w + 1) // 2, (h + 1) // 2
        return outs

    def encode(self, x):
        xs = self.swin(x)
        _, h, w, _ = x.shape
        lows = self.swin(resize_bilinear_ac(x, (h // 2, w // 2)))
        xs = [torch.cat([a, resize_bilinear_ac(lo, a.shape[1:3])], dim=-1) for a, lo in zip(xs, lows)]
        h3w3 = xs[3].shape[1:3]
        xs[3] = torch.cat([resize_bilinear_ac(xs[i], h3w3) for i in range(3)] + [xs[3]], dim=-1)
        return xs

    # -- decoder --------------------------------------------------------------

    def deform_conv(self, x, weight, offset, modulator, pad):
        """Deformable conv v2, stride 1: (B, H, W, Cin) -> (B, Ho, Wo, Cout)."""
        b, h, w, cin = x.shape
        cout, _, kh, kw = weight.shape
        kk = kh * kw
        _, ho, wo, _ = offset.shape
        dev = x.device
        ky = torch.arange(kh, device=dev).repeat_interleave(kw)
        kx = torch.arange(kw, device=dev).repeat(kh)
        wmat = weight.permute(2, 3, 1, 0).reshape(kk * cin, cout)
        x_flat = x.reshape(b, h * w, cin)
        rows = max(1, min(ho, DEFORM_CHUNK_BYTES // (4 * b * wo * kk * cin)))
        out = []
        for r0 in range(0, ho, rows):
            r1 = min(ho, r0 + rows)
            off = offset[:, r0:r1].reshape(b, r1 - r0, wo, kk, 2)
            py = (torch.arange(r0, r1, device=dev) - pad)[:, None, None] + ky + off[..., 0]
            px = (torch.arange(wo, device=dev) - pad)[None, :, None] + kx + off[..., 1]
            y0, x0 = torch.floor(py), torch.floor(px)
            fy, fx = py - y0, px - x0
            cols = 0.0
            for dy, dx, cw in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx), (1, 0, fy * (1 - fx)),
                               (1, 1, fy * fx)):
                yy, xx = (y0 + dy).long(), (x0 + dx).long()
                inside = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).float()
                idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(b, -1)
                taps = torch.gather(x_flat, 1, idx[..., None].expand(-1, -1, cin))
                cols = cols + taps * (cw * inside).reshape(b, -1, 1)
            cols = cols * modulator[:, r0:r1].reshape(b, -1, 1)
            prod = self.p.matmul(cols.reshape(-1, kk * cin), wmat)
            out.append(prod.reshape(b, r1 - r0, wo, cout))
        return torch.cat(out, dim=1)

    def aspp_branch(self, name, x, pad):
        conv = f"{name}.conv"
        offset = self.conv(f"{conv}.offset", x, 1, pad)
        modulator = 2.0 * torch.sigmoid(self.conv(f"{conv}.modulator", x, 1, pad))
        y = self.deform_conv(x, self.w[f"{conv}.conv.weight"], offset, modulator, pad)
        if f"{conv}.conv.bias" in self.w:
            y = y + self.w[f"{conv}.conv.bias"]
        return torch.relu(y * self.w[f"{name}.bn.weight"] + self.w[f"{name}.bn.bias"])

    def aspp(self, name, x):
        _, h, w, _ = x.shape
        branches = [self.aspp_branch(f"{name}.aspp1", x, 0)]
        branches += [self.aspp_branch(f"{name}.aspp_deforms.{i}", x, k // 2) for i, k in enumerate((1, 3, 7))]
        pooled = torch.relu(self.conv(f"{name}.global_avg_pool.1", x.mean(dim=(1, 2), keepdim=True)))
        branches.append(resize_bilinear_ac(pooled, (h, w)))
        return torch.relu(self.conv(f"{name}.conv1", torch.cat(branches, dim=-1)))

    def dec_block(self, name, x):
        x = torch.relu(self.conv(f"{name}.conv_in", x, 1, 1))
        return self.conv(f"{name}.conv_out", self.aspp(f"{name}.dec_att", x), 1, 1)

    def simple(self, name, x):
        return self.conv(f"{name}.conv_out", self.conv(f"{name}.conv1", x, 1, 1), 1, 1)

    @staticmethod
    def patches(x, oh, ow):
        b, h, w, c = x.shape
        gh, gw = h // oh, w // ow
        return x.reshape(b, gh, oh, gw, ow, c).permute(0, 2, 4, 5, 1, 3).reshape(b, oh, ow, c * gh * gw)

    def decode(self, image, feats):
        x1, x2, x3, x4 = feats
        d = "decoder"

        def inject(feat, blk):
            return torch.cat([feat, self.simple(f"{d}.{blk}", self.patches(image, *feat.shape[1:3]))], dim=-1)

        def gate(x, i):
            g = torch.relu(self.conv(f"{d}.gdt_convs_{i}.0", x, 1, 1))
            return x * torch.sigmoid(self.conv(f"{d}.gdt_convs_attn_{i}.0", g))

        p4 = gate(self.dec_block(f"{d}.block4", inject(x4, "ipt_blk5")), 4)
        x3l = self.conv(f"{d}.lateral_block4.conv", x3)
        p3 = gate(self.dec_block(f"{d}.block3", inject(resize_bilinear_ac(p4, x3l.shape[1:3]) + x3l, "ipt_blk4")), 3)
        x2l = self.conv(f"{d}.lateral_block3.conv", x2)
        p2 = gate(self.dec_block(f"{d}.block2", inject(resize_bilinear_ac(p3, x2l.shape[1:3]) + x2l, "ipt_blk3")), 2)
        x1l = self.conv(f"{d}.lateral_block2.conv", x1)
        p1 = self.dec_block(f"{d}.block1", inject(resize_bilinear_ac(p2, x1l.shape[1:3]) + x1l, "ipt_blk2"))
        p1 = torch.cat([resize_bilinear_ac(p1, image.shape[1:3]), self.simple(f"{d}.ipt_blk1", image)], dim=-1)
        return torch.sigmoid(self.conv(f"{d}.conv_out1.0", p1))

    def __call__(self, x_u8):
        mean = torch.tensor(IMAGENET_MEAN, device=x_u8.device)
        std = torch.tensor(IMAGENET_STD, device=x_u8.device)
        x = (x_u8.float() / 255.0 - mean) / std
        feats = self.encode(x)
        feats[3] = self.dec_block("squeeze_module.0", feats[3])
        return self.decode(x, feats)


def forward(w: dict, x_u8: torch.Tensor, cfg: dict, precision: str = "f32") -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, H, W) float32 matte in [0, 1]."""
    return _Net(w, cfg, precision)(x_u8)[..., 0]


@torch.no_grad()
def expected_u8(w: dict, x_u8: torch.Tensor, cfg: dict, precision: str = "f32") -> torch.Tensor:
    """The served answer's pixels, (N, H, W, 1) uint8: the matte clamped to
    [0, 1], times 255, truncated."""
    with exact_matmul():
        y = forward(w, x_u8, cfg, precision)
    return (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)[..., None]
