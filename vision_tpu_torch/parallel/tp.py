"""Tensor parallelism on local shards (Megatron form) — the port's side of
what XLA's partitioner does for the JAX package's tp-sharded weights.

A weight that :func:`~vision_tpu_torch.parallel.sharding.shard_params`
placed ``Shard(0)`` over the mesh's tp axis is column-parallel: its
product leaves each rank the features of its own rows. One placed
``Shard(1)`` is row-parallel: its product on those features is a partial
sum, and one ``all_reduce(SUM)`` over the tp group completes it before the
bias. Attention splits by head: q, k and v of rank r are its own
``H / tp`` heads (a fused ``qkv`` is regrouped at placement so that this
holds), the attention and its kernel run on those heads alone, and the
output projection is row-parallel. A column-parallel output that reaches an
op that is not local to its features (a replicated projection, a layer
norm) is all-gathered first (:func:`gather_for`).

``ops.nn.linear`` sends any DTensor weight here. The collectives carry
gradients as Megatron's operators do: the input of a column-parallel
product all-reduces its gradient (f), the all-reduce after a row-parallel
one passes the gradient through (g), an all-gather of features hands each
rank its own chunk of the gradient, and a whole tensor cut to this rank's
features or heads (a replicated bias, a head-indexed attention bias)
all-gathers the chunks' gradients.

A weight that training placed ``Shard(0)`` over the mesh's dp axis (fsdp,
train.create_train_state) is gathered whole once a forward, by the
training step before it calls the loss (:func:`gather_fsdp`); its gradient
comes back reduce-scattered to this rank's rows.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.errors import raise_error

__all__ = [
    "is_dtensor",
    "tp_dim",
    "tp_size",
    "tp_rank",
    "regroup_qkv",
    "linear",
    "local_heads",
    "head_slice",
    "gather_for",
    "gather_fsdp",
    "is_fsdp",
    "local",
    "ungroup_qkv",
]


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing the DTensor module:
    none can exist before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def tp_dim(w) -> int | None:
    """The dimension of ``w`` sharded over the mesh's tp axis, or None."""
    if not is_dtensor(w):
        return None
    names = w.device_mesh.mesh_dim_names
    place = w.placements[names.index("tp")]
    return place.dim if place.is_shard() else None


def _group(w):
    return w.device_mesh.get_group("tp")


def tp_size(w) -> int:
    return int(w.device_mesh.size(w.device_mesh.mesh_dim_names.index("tp"))) if is_dtensor(w) else 1


def tp_rank(w) -> int:
    return w.device_mesh.get_local_rank("tp") if is_dtensor(w) else 0


def local(w):
    """The tensor a rank computes with: a DTensor's local shard, else ``w``."""
    return w.to_local() if is_dtensor(w) else w


def regroup_qkv(t: torch.Tensor, tp: int) -> torch.Tensor:
    """Fused [q..|k..|v..] rows (3C, ...) -> rows in tp groups, so that
    contiguous chunk r holds [q_r|k_r|v_r]: the q, k and v rows of rank r's
    heads (heads are contiguous hd-row blocks of each of q, k and v)."""
    s = t.shape
    return t.reshape(3, tp, s[0] // (3 * tp), *s[1:]).transpose(0, 1).reshape(s)


def ungroup_qkv(t: torch.Tensor, tp: int) -> torch.Tensor:
    """The inverse of :func:`regroup_qkv`: rows in tp groups back in
    [q..|k..|v..] order."""
    s = t.shape
    return t.reshape(tp, 3, s[0] // (3 * tp), *s[1:]).transpose(0, 1).reshape(s)


class _CopyToTP(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _own_chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)]


class _GatherFromTP(torch.autograd.Function):
    """All-gather over tp along ``dim`` forward; this rank's chunk of the
    gradient backward (the gathered tensor is replicated, its gradient too)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.dim, ctx.group).contiguous(), None, None


class _ScatterToTP(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a whole (replicated) tensor
    forward; the all-gather of the chunks' gradients backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_cat(g, ctx.dim, ctx.group), None, None


def _records(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def scatter_to(x: torch.Tensor, dim: int, w) -> torch.Tensor:
    """Rank r's chunk along ``dim`` of a whole ``x``, over the tp group of
    the sharded weight ``w`` (its gradient all-gathered under autograd)."""
    if _records(x):
        return _ScatterToTP.apply(x, dim, _group(w))
    return x.chunk(tp_size(w), dim)[tp_rank(w)]


def _copy_to(x, group):
    return _CopyToTP.apply(x, group) if x.requires_grad else x


def _reduce_from(x, group):
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, group)
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def _features(x: torch.Tensor, w, full: int) -> torch.Tensor:
    """x's features as rank r's chunk of ``full`` (x may be whole)."""
    if x.shape[-1] == full:
        return scatter_to(x, -1, w)
    return x


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``ops.nn.linear`` with a tp-sharded weight: the same promotion and
    rounding on the local shard. Column-parallel: y is this rank's output
    features (its bias chunk added). Row-parallel: x is this rank's input
    features (a whole x is cut to them), the partial product is summed over
    the tp group, then the bias is added."""
    from ..ops.nn import _promoted

    w = p.weight("weight")
    if p.find("lora_a") is not None:
        raise_error("linear: a LoRA adapter on a tensor-parallel weight is not supported")
    dim, wl, group = tp_dim(w), w.to_local(), _group(w)
    b = p.find("bias")
    dt = _promoted(x, wl)
    if dim == 0:
        y = F.linear(_copy_to(x, group).to(dt), wl.to(dt)).to(x.dtype)
        if b is not None:
            y = y + (b.to_local() if tp_dim(b) == 0 else _features(local(b), w, w.shape[0]))
        return y
    if dim != 1:
        raise_error("linear: weight sharded on dim {} over tp", dim)
    y = F.linear(_features(x, w, w.shape[1]).to(dt), wl.to(dt))
    y = _reduce_from(y, group).to(x.dtype)
    if b is not None:
        y = y + local(b)
    return y


def local_heads(p, n_heads: int) -> int:
    """The heads this rank runs of an attention of ``n_heads`` whose q (or
    fused qkv) projection is ``p``: n_heads / tp when it is column-sharded.
    Reads the stored entry: a quantized resident is never dequantized here."""
    w = p.stored("weight")
    return n_heads // tp_size(w) if tp_dim(w) == 0 else n_heads


def head_slice(p, n_heads: int) -> slice:
    """This rank's heads of an attention of ``n_heads`` (see :func:`local_heads`)."""
    h = local_heads(p, n_heads)
    r = tp_rank(p.stored("weight")) if h != n_heads else 0
    return slice(r * h, (r + 1) * h)


def gather_for(x: torch.Tensor, src, dst) -> torch.Tensor:
    """x, the output features of ``src``'s column-parallel weight, made
    whole (all-gathered over the tp group) when the consumer ``dst`` is not
    row-parallel; otherwise x as it is."""
    w = src.stored("weight")
    if tp_dim(w) != 0 or tp_dim(dst.stored("weight")) == 1:
        return x
    if _records(x):
        return _GatherFromTP.apply(x, -1, _group(w))
    return _gather_cat(x, -1, _group(w))


def is_fsdp(w) -> bool:
    """Whether ``w`` is a DTensor sharded over the mesh's dp axis (fsdp)."""
    if not is_dtensor(w) or "dp" not in w.device_mesh.mesh_dim_names:
        return False
    return w.placements[w.device_mesh.mesh_dim_names.index("dp")].is_shard()


def _gather_rows(shard: torch.Tensor, group) -> torch.Tensor:
    out = shard.new_empty((shard.shape[0] * dist.get_world_size(group), *shard.shape[1:]))
    dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
    return out


class _GatherFSDP(torch.autograd.Function):
    """All-gather of dp row shards forward; reduce-scatter (sum) of the
    gradient backward, so each rank's shard gets its rows' sum over dp."""

    @staticmethod
    def forward(ctx, shard, group):
        ctx.group = group
        return _gather_rows(shard, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def gather_fsdp(w) -> torch.Tensor:
    """An fsdp weight whole, as a plain tensor (fsdp shards only what the
    tp rules left replicated): one all-gather over dp, its gradient
    reduce-scattered back under autograd."""
    dim = w.device_mesh.mesh_dim_names.index("dp")
    if w.placements[dim].dim != 0 or any(p.is_shard() for i, p in enumerate(w.placements) if i != dim):
        raise_error("gather_fsdp: expected rows sharded over dp alone, got {}", w.placements)
    shard = w.to_local()
    group = w.device_mesh.get_group("dp")
    if _records(shard):
        return _GatherFSDP.apply(shard, group)
    return _gather_rows(shard, group)
