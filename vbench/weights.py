"""Seeded weights and inputs, made on the run's device in a few large calls.

A configuration lists its weights as ``(name, shape, std, mean)``: each is
drawn as ``mean + std * N(0, 1)`` (``std`` 0 gives the constant ``mean``).
:func:`draw` draws all of them from one generator on the device in one
normal draw, scales the whole buffer by per-element standard deviations and
means in two passes, and hands out views of it under the names. The same
seed gives the same weights on the same device, so the reference can draw
them again after the program's state is freed.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

__all__ = ["derive_seed", "draw", "image_pool"]


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``, which may
    be any whole number."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def draw(specs, seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` on ``device`` for ``specs``, a list of
    ``(name, shape, std, mean)``."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    counts = torch.tensor(sizes, device=device)
    std = torch.tensor([float(s) for _, _, s, _ in specs], device=device)
    mean = torch.tensor([float(m) for _, _, _, m in specs], device=device)
    flat.mul_(torch.repeat_interleave(std, counts, output_size=total))
    flat.add_(torch.repeat_interleave(mean, counts, output_size=total))
    out, offset = {}, 0
    for (name, shape, _, _), n in zip(specs, sizes):
        out[name] = flat[offset : offset + n].view(shape)
        offset += n
    return out


def image_pool(seed: int, tag: str, count: int, width: int, height: int, device, chunk: int = 8):
    """``count`` distinct RGB u8 images (height, width, 3) as host numpy
    arrays: a smooth random field at 1/16 scale, upsampled, plus fine
    noise, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, f"images:{tag}"))
    out = []
    for start in range(0, count, chunk):
        n = min(chunk, count - start)
        low = torch.randn(n, 3, max(1, height // 16), max(1, width // 16), generator=gen, device=device)
        img = F.interpolate(low, size=(height, width), mode="bilinear", align_corners=False) * 0.22 + 0.5
        img = img + 0.04 * torch.randn(n, 3, height, width, generator=gen, device=device)
        u8 = (img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).contiguous().cpu().numpy()
        out.extend(u8[i] for i in range(n))
    return out
