"""Real-ESRGAN super-resolution (RRDBNet) — a port of vision_tpu/models/esrgan.py.

Reference: src/visp/arch/esrgan.{cpp,h}, tiled pipeline in
src/visp/vision.cpp:205-253. ``esrgan_generate`` mirrors esrgan.cpp:55-83: a
conv stem, n_blocks x RRDB (3 residual dense blocks of 5 convs with dense
channel concats and 0.2 residual scaling, esrgan.cpp:27-51), a trunk conv
and skip, log2(scale) x (nearest 2x upsample + conv + leaky relu,
esrgan.cpp:13-19) and two final convs. Weight names are the GGUF/torch
"old-arch" names (``model.0``, ``model.1.sub.N.RDBk.convj.0``, ...).

Every conv is a 3x3 stride-1 pad-1 conv through ops/nn.py
``conv_3x3_fused``, so on the card each one is a launch of the hand-written
kernel (csrc/conv3x3.cu): 351 per forward at scale 4 with 23 blocks. The
bias, the leaky ReLUs and the residual sums run in the kernel's epilogue,
and the dense blocks' concatenations are channel ranges of one buffer per
block (see :func:`_dense_block`), so no elementwise pass runs between the
convs. The epilogue rounds once where the JAX package rounds after the
conv, after the bias, after the leaky ReLU and after each residual sum: at
f32 the two agree to the summation order, in bf16 the port is the more
precise.

When autograd records (training: grad mode on and x or a parameter that
requires grad) every function here takes its autograd-safe form instead:
each conv returns a fresh tensor and a dense block grows by ``torch.cat``,
as the JAX package's esrgan.py:117 does (an in-place write into a buffer
that autograd saved views of would void the backward). The two forms make
the same calls on the same values, so they agree bit for bit at f32 and
launch the same 351 convs.

The port runs this plain form. The JAX package serves the same math
regrouped by source (``esrgan_generate_packed``), which fills the TPU's
128-lane products; the two agree to 2e-5 at f32. PyTorch runs eagerly, so
there is no per-extent program cache. With a ``mesh`` (parallel/) the
batch, and the tiled path's tile batch, split over dp.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import Device, backend_init
from ..core.errors import raise_error
from ..core.gguf import GGUFFile, model_load
from ..core.graph import ForwardGraphs
from ..core.params import Params
from ..core.weights import cast_float_params, load_weights
from ..parallel.runner import mesh_entries
from ..image import (
    Image,
    ImageFormat,
    TileLayout,
    image_alloc,
    image_f32_to_u8,
    tile_merge,
    tile_scale,
)
from ..ops import conv_3x3_fused, normalize_u8, resize_nhwc

__all__ = [
    "EsrganParams",
    "esrgan_detect_params",
    "residual_dense_block",
    "rrdb",
    "esrgan_generate",
    "EsrganModel",
    "esrgan_load_model",
    "esrgan_compute",
]

ESRGAN_DEFAULT_TILE_SIZE = 224
ESRGAN_TILE_OVERLAP = 16


@dataclass(frozen=True)
class EsrganParams:
    scale: int = 4
    n_blocks: int = 23


def esrgan_detect_params(file: GGUFFile) -> EsrganParams:
    """Reference esrgan_detect_params (esrgan.cpp:85-96)."""
    if file.arch != "esrgan":
        raise_error("Architecture expected to be 'esrgan', but was '{}' ({})", file.arch, file.path)
    scale = file.get_int("esrgan.scale")
    n_blocks = file.get_int("esrgan.block_count")
    if not (1 <= scale <= 8):
        raise_error("ESRGAN: unsupported scale: {}", scale)
    if not (1 <= n_blocks <= 23):
        raise_error("ESRGAN: invalid number of blocks: {}", n_blocks)
    return EsrganParams(scale, n_blocks)


def _dense_block(p: Params, buf: torch.Tensor, nf: int, out: torch.Tensor, r2=None) -> None:
    """One 5-conv dense block, 0.2 residual (reference esrgan.cpp:27-41), on
    ``buf`` (N, H, W, nf + 4 gc), whose first nf channels hold its input x:
    conv1-4 each read the channels so far and write their gc channels after
    them, bias and leaky ReLU 0.2 fused (the reference's concatenations are
    these channel ranges); conv5 reads all of them and writes x + 0.2 *
    (conv5 + bias) into ``out`` (nf channels of another buffer), or, with
    ``r2``, the RRDB's r2 + 0.2 * that."""
    c = nf
    for k in range(1, 5):
        q = p[f"conv{k}"][0]
        gc = q.weight("weight").shape[0]
        conv_3x3_fused(q, buf[..., :c], slope=0.2, out=buf[..., c : c + gc])
        c += gc
    conv_3x3_fused(p["conv5"][0], buf[..., :c], r1=buf[..., :nf], s1=0.2, r2=r2, s2=1.0 if r2 is None else 0.2,
                   out=out)


def _growth(p: Params) -> int:
    """gc, the channels each of a dense block's conv1-4 adds."""
    return p["conv1"][0].weight("weight").shape[0]


def _block_buffer(x: torch.Tensor, gc: int) -> torch.Tensor:
    """An (N, H, W, nf + 4 gc) dense-block buffer for x (N, H, W, nf)."""
    n, h, w, nf = x.shape
    return torch.empty((n, h, w, nf + 4 * gc), dtype=x.dtype, device=x.device)


def _rrdb(p: Params, src: torch.Tensor, mid1: torch.Tensor, mid2: torch.Tensor, out: torch.Tensor, nf: int) -> None:
    """Residual-in-residual dense block (reference esrgan.cpp:43-51) on
    dense-block buffers: RDB1 runs on ``src`` (the RRDB's input x in its
    first nf channels) into mid1, RDB2 on mid1 into mid2, RDB3 on mid2 into
    ``out`` with x + 0.2 * y fused. 15 convs, no other pass; ``out`` may be
    src[..., :nf] (each element is read before it is written)."""
    _dense_block(p["RDB1"], src, nf, mid1[..., :nf])
    _dense_block(p["RDB2"], mid1, nf, mid2[..., :nf])
    _dense_block(p["RDB3"], mid2, nf, out, r2=src[..., :nf])


def _dense_block_cat(p: Params, x: torch.Tensor, r2=None) -> torch.Tensor:
    """:func:`_dense_block`'s autograd-safe form: conv1-4 each return their gc
    channels, concatenated after the input (``torch.cat``); conv5 returns x
    + 0.2 * (conv5 + bias), or r2 + 0.2 * that."""
    feats = x
    for k in range(1, 5):
        feats = torch.cat([feats, conv_3x3_fused(p[f"conv{k}"][0], feats, slope=0.2)], dim=-1)
    return conv_3x3_fused(p["conv5"][0], feats, r1=x, s1=0.2, r2=r2, s2=1.0 if r2 is None else 0.2)


def _rrdb_cat(p: Params, x: torch.Tensor) -> torch.Tensor:
    """:func:`_rrdb`'s autograd-safe form."""
    h = _dense_block_cat(p["RDB2"], _dense_block_cat(p["RDB1"], x))
    return _dense_block_cat(p["RDB3"], h, r2=x)


def residual_dense_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """5-conv dense block, 0.2 residual (reference esrgan.cpp:27-41):
    :func:`_dense_block` on a buffer of its own (its autograd-safe form
    when autograd records)."""
    if p.records_grad(x):
        return _dense_block_cat(p, x)
    buf = _block_buffer(x, _growth(p))
    buf[..., : x.shape[-1]] = x
    out = torch.empty_like(x)
    _dense_block(p, buf, x.shape[-1], out)
    return out


def rrdb(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Residual-in-residual dense block (reference esrgan.cpp:43-51):
    :func:`_rrdb` on three buffers of its own (its autograd-safe form when
    autograd records)."""
    if p.records_grad(x):
        return _rrdb_cat(p, x)
    src, mid1, mid2 = (_block_buffer(x, _growth(p["RDB1"])) for _ in range(3))
    src[..., : x.shape[-1]] = x
    out = torch.empty_like(x)
    _rrdb(p, src, mid1, mid2, out, x.shape[-1])
    return out


def _upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """nearest 2x + conv + lrelu (reference esrgan.cpp:13-19), the leaky
    ReLU fused."""
    _, h, w, _ = x.shape
    x = resize_nhwc(x, (h * 2, w * 2), "nearest")
    return conv_3x3_fused(p, x, slope=0.2)


def esrgan_generate(params: Params, x: torch.Tensor, p: EsrganParams) -> torch.Tensor:
    """RRDBNet forward, NHWC (reference esrgan_generate, esrgan.cpp:55-83).
    x: (N, H, W, 3) in [0,1] -> (N, H*scale, W*scale, 3). It runs on four
    dense-block buffers, or in its autograd-safe form, with the same
    results, when autograd records (``Params.records_grad``: grad mode on
    and x or a parameter requiring grad)."""
    m = params["model"]
    block = m[1]["sub"]
    if params.records_grad(x):
        feat = conv_3x3_fused(m[0], x.contiguous())
        h = feat
        for i in range(p.n_blocks):
            h = _rrdb_cat(block[i], h)
        return _tail(m, conv_3x3_fused(block[p.n_blocks], h, r1=feat), p)
    nf = m[0].weight("weight").shape[0]
    c = nf + 4 * _growth(block[0]["RDB1"])
    # four dense-block buffers: the stem's output stays in s[..., :nf] for
    # the trunk's skip; RRDB i runs src -> a -> b -> d[..., :nf], and every
    # RRDB after the first takes d as its src (its output overwrites its
    # input in place)
    s, a, b, d = (torch.empty((*x.shape[:3], c), dtype=x.dtype, device=x.device) for _ in range(4))
    feat = conv_3x3_fused(m[0], x.contiguous(), out=s[..., :nf])
    src = s
    for i in range(p.n_blocks):
        _rrdb(block[i], src, a, b, d[..., :nf], nf)
        src = d
    del a, b  # the dense-block buffers go before the upsampled tail needs the memory
    x = conv_3x3_fused(block[p.n_blocks], src[..., :nf], r1=feat)  # trunk conv + skip
    del s, d, feat, src
    return _tail(m, x, p)


def _tail(m: Params, x: torch.Tensor, p: EsrganParams) -> torch.Tensor:
    """log2(scale) x (nearest 2x + conv + leaky ReLU), then the hr conv with
    its leaky ReLU and the last conv (reference esrgan.cpp:73-82)."""
    seq = 2
    for _ in range(int(np.log2(p.scale))):
        x = _upsample(m[seq + 1], x)
        seq += 3
    x = conv_3x3_fused(m[seq], x, slope=0.2)
    return conv_3x3_fused(m[seq + 2], x)


class EsrganModel:
    """High-level handle (reference esrgan_model, vision.h, and the
    esrgan_load_model/esrgan_compute pair in vision.cpp:209-253).

    ``params``: torch tensors under the GGUF names; floats are cast to the
    device's float policy here (they are moved nowhere: pass them on the
    device, as :func:`esrgan_load_model` does).

    ``mesh``: a dp mesh of parallel/ (every rank builds the model from its
    own copy of the weights; no weight matches a tp rule, so they are
    replicated, as in the JAX package): ``forward_u8`` splits its batch
    over dp (rank 0 calls, the other ranks follow, parallel/runner.py),
    each rank replaying its own CUDA graph per shard shape."""

    def __init__(self, params: dict[str, torch.Tensor], p: EsrganParams, device: Device, mesh=None):
        self.p = p
        self.device = device
        self.dtype = device.preferred_float_type
        self.mesh = mesh
        self.params = cast_float_params(params, self.dtype)
        self.graphs = ForwardGraphs(self._forward_u8, device.torch_device)
        self._calls = mesh_entries(self, mesh, forward_u8=self.graphs)

    def forward_u8(self, x_u8: torch.Tensor, to_u8: bool = True, rgba: bool = False) -> torch.Tensor:
        """(N, H, W, 3) uint8 -> (N, H*scale, W*scale, 3) on the model's
        device: uint8 (clamped to [0, 1], times 255, truncated) with ``to_u8``,
        else the forward's float output in the model's type. With ``rgba``
        (u8 only) the answer is (N, H*scale, W*scale, 4), the same RGB and an
        alpha of 255: the served image, so that no pixel work is left for the
        host. As the JAX package's ``_esrgan_run_fn``. Runs under
        ``torch.inference_mode``, entered here because the mode is
        thread-local and servers call this from their own worker thread. On
        the card each input shape and output form runs as one CUDA graph,
        captured at its first call and replayed after (core/graph.py); the
        result is a copy that the caller keeps."""
        if rgba and not to_u8:
            raise ValueError("forward_u8: rgba needs to_u8")
        return self._calls["forward_u8"](x_u8, to_u8=to_u8, rgba=rgba)

    def _forward_u8(self, x_u8: torch.Tensor, to_u8: bool = True, rgba: bool = False) -> torch.Tensor:
        """The eager forward that :meth:`forward_u8` captures (the reference of its tests)."""
        with torch.inference_mode():
            x = normalize_u8(x_u8.to(self.device.torch_device, non_blocking=True), dtype=self.dtype)
            y = esrgan_generate(Params(self.params), x, self.p)
            if to_u8:
                y = (torch.clamp(y.float(), 0.0, 1.0) * 255.0).to(torch.uint8)
                if rgba:
                    y = F.pad(y, (0, 1), value=255)
            return y

    def _compute_whole(self, image: Image) -> Image:
        """One forward: u8 in, the served RGBA u8 out, no host-side pixel math."""
        y = self.forward_u8(torch.from_numpy(image.to_rgb_u8()[None]), rgba=True)[0].cpu().numpy()
        return Image(y, ImageFormat.rgba_u8)

    def compute(self, image: Image, tile_size: int | None = None, batch: int = 4) -> Image:
        """Tiled super-resolution (reference esrgan_compute, vision.cpp:220-253).

        The tile policy is the JAX package's off the TPU: 224-pixel tiles
        by default. An image whose longer side fits in a tile runs whole;
        a larger one is cut into overlapping tiles (replicate padding at
        the border), run ``batch`` tiles at a time (the last chunk padded
        with zero tiles) and blended on the host. With a mesh, ``batch``
        must divide by its dp extent: each rank runs batch / dp tiles a
        call."""
        if self.mesh is not None:
            dp = self.mesh.size(0)
            if batch % dp:
                raise ValueError(f"tile batch {batch} not divisible by mesh dp={dp}")
        if tile_size is None:
            tile_size = ESRGAN_DEFAULT_TILE_SIZE
        if max(image.extent) <= tile_size:
            return self._compute_whole(image)
        tiles = TileLayout(image.extent, tile_size, ESRGAN_TILE_OVERLAP)
        tiles_out = tile_scale(tiles, self.p.scale)
        tw, th = tiles.tile_size
        n = tiles.total()

        # gather tiles with replicate padding (reference image_u8_to_f32
        # tiled reads, image.cpp:219-226), still u8; the /255 runs on the card
        src = image.to_rgb_u8()
        h, w = src.shape[:2]
        stack = np.empty((n, th, tw, 3), np.uint8)
        for t in range(n):
            sx, sy = tiles.start(tiles.coord(t))
            ys = np.minimum(np.arange(sy, sy + th), h - 1)
            xs = np.minimum(np.arange(sx, sx + tw), w - 1)
            stack[t] = src[np.ix_(ys, xs)]

        out_tiles = np.empty((n, th * self.p.scale, tw * self.p.scale, 3), np.float32)
        for i in range(0, n, batch):
            chunk = stack[i : i + batch]
            real = chunk.shape[0]
            if real < batch:
                chunk = np.concatenate([chunk, np.zeros((batch - real, th, tw, 3), np.uint8)], 0)
            y = self.forward_u8(torch.from_numpy(chunk), to_u8=False)
            out_tiles[i : i + real] = y[:real].float().cpu().numpy()

        # overlap blend (reference tile_merge, image.cpp:655-693)
        out = image_alloc(tiles_out.image_extent, ImageFormat.rgb_f32)
        for t in range(n):
            tile_merge(Image(out_tiles[t], ImageFormat.rgb_f32), out, tiles_out.coord(t), tiles_out)
        return image_f32_to_u8(out, ImageFormat.rgba_u8)


def esrgan_load_model(filepath: str, device: Device | None = None, mesh=None) -> EsrganModel:
    """Load a Real-ESRGAN GGUF onto ``device`` (default: the CUDA device;
    without one, backend_init raises). Block-quantized tensors expand at
    load: there is no ``keep_quantized`` path, as in the JAX package.
    ``mesh``: replicate the weights over a dp mesh of parallel/."""
    device = device or backend_init()
    file = model_load(filepath)
    p = esrgan_detect_params(file)
    return EsrganModel(load_weights(file, device), p, device, mesh=mesh)


def esrgan_compute(model: EsrganModel, image: Image) -> Image:
    return model.compute(image)
