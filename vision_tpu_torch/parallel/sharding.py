"""Multi-card scaling over a torch.distributed device mesh — a port of
vision_tpu/parallel/sharding.py.

The JAX package shards the batch (images / tiles) over a ``dp`` mesh axis
and wide weights over a ``tp`` axis, and lets XLA insert the collectives.
Here every rank is one process driving one card (NCCL; gloo for CPU ranks),
the weights are DTensors placed from each rank's own copy, and the model
code runs Megatron-style on the local shards (parallel/tp.py): one
all-reduce over the tp group after each row-parallel product. Serving
splits the batch over dp with one scatter and one gather
(parallel/runner.py).

Design:
  * ``init_distributed`` — the process group: ``env://`` under torchrun,
    the given address otherwise; NCCL for CUDA tensors, gloo for CPU ones.
  * ``make_mesh(n, tp, sp, pp)`` — (dp, pp, sp, tp) ``DeviceMesh`` over the
    ranks (a process without a group gets a world of one).
  * ``shard_params`` — name-pattern rules map dotted GGUF names to
    placements; everything else is replicated. Fused q/k/v rows are
    regrouped so that each tp rank holds whole heads (parallel/tp.py).
  * ``fsdp_params`` — training's ZeRO-3 placement: float weights the tp
    rules left replicated, rows sharded over dp (gathered once a forward
    by the training step, parallel/tp.py ``gather_fsdp``).
  * ``sharded_forward`` / ``training_step`` — dp over the batch, tp as the
    weights are placed; the training step averages gradients over dp and
    keeps the tp shards (the JAX package's SGD check; train.py's
    ``make_train_step(mesh=)`` is the full step).
"""

from __future__ import annotations

import os
import re
from datetime import timedelta
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.errors import raise_error

__all__ = [
    "DEFAULT_TP_RULES",
    "SAM3_TP_RULES",
    "init_distributed",
    "make_mesh",
    "mesh_shape",
    "replicate",
    "batch_sharding",
    "shard_params",
    "fsdp_params",
    "local_params",
    "mesh_params",
    "mesh_tp",
    "sharded_forward",
    "training_step",
]

MESH_AXES = ("dp", "pp", "sp", "tp")


def _timeout() -> timedelta:
    """The process group's timeout: a collective that waits on a rank that
    died or hangs fails after it (``VISP_DIST_TIMEOUT`` seconds, default
    600)."""
    return timedelta(seconds=float(os.environ.get("VISP_DIST_TIMEOUT", "600")))


def _backend(device: str) -> str:
    # CUDA worlds carry gloo too: the runner's headers are small host objects
    return "cpu:gloo,cuda:nccl" if device == "cuda" else "gloo"


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    *,
    device: str = "cuda",
) -> None:
    """Join the process group: call once per rank before any mesh is made.

    Under torchrun (``WORLD_SIZE`` set) every argument comes from the
    environment (``env://``); elsewhere pass ``coordinator_address``
    (``host:port`` of rank 0, or a ``file://`` path), ``num_processes``
    and ``process_id``. ``local_device_ids``: the card of this rank (one
    card per rank; default ``LOCAL_RANK``, else the rank modulo the
    visible cards). ``device``: ``"cuda"`` (NCCL, the card is made the
    current device) or ``"cpu"`` (gloo). Lay out the mesh so the fast
    collectives stay inside a host: tp/sp innermost, dp outermost.
    Single-process use never needs this (``make_mesh`` makes a world of
    one). Idempotent: once the group exists, any further call returns
    without touching it — INCLUDING calls with different settings
    (re-configuring a live process is not supported; restart the process
    to change clusters)."""
    if dist.is_initialized():
        return
    backend = _backend(device)
    if "WORLD_SIZE" in os.environ and coordinator_address is None:
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        _set_card(device, local, local_device_ids)
        dist.init_process_group(backend, init_method="env://", timeout=_timeout())
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise_error("init_distributed: outside torchrun pass coordinator_address, num_processes and process_id")
    addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    _set_card(device, process_id, local_device_ids)
    dist.init_process_group(backend, init_method=addr, world_size=num_processes, rank=process_id,
                            timeout=_timeout())


def _set_card(device: str, rank: int, local_device_ids) -> None:
    if device != "cuda":
        return
    if local_device_ids is not None:
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        card = ids[0]
    else:
        n = torch.cuda.device_count()
        if n < 1:
            raise_error("init_distributed: no CUDA card for rank {}", rank)
        card = rank % n
    torch.cuda.set_device(card)


def _ensure_world(device: str) -> None:
    """A process that joined no group gets a world of one (in-process store)."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1,
                                timeout=_timeout())


def cards_available(device: str) -> int:
    """The ranks a ``device`` mesh may use: CUDA needs one card a rank (the
    cards of this host times the hosts torchrun names); CPU ranks are
    unlimited."""
    if device != "cuda":
        return 1 << 30
    world = int(os.environ.get("WORLD_SIZE", "1"))
    hosts = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    return torch.cuda.device_count() * hosts


# Default tensor-parallel rules: dotted-name regex -> the dimension sharded
# over tp. Linear weights are torch-canonical (out, in): column-parallel
# shards dim 0, row-parallel shards dim 1 (the JAX package's P("tp", None)
# and P(None, "tp")).
DEFAULT_TP_RULES: tuple[tuple[str, int], ...] = (
    (r".*\bqkv\.weight$", 0),
    (r".*\bqkv\.bias$", 0),
    (r".*\b(fc1|lin1)\.weight$", 0),
    (r".*\b(fc1|lin1)\.bias$", 0),
    (r".*\b(fc2|lin2)\.weight$", 1),
    (r".*\bproj\.weight$", 1),
    # HF split-projection naming (DINOv2 / depth-anything backbones):
    # column-parallel q/k/v, row-parallel output.dense
    (r".*\battention\.(query|key|value)\.weight$", 0),
    (r".*\battention\.(query|key|value)\.bias$", 0),
    (r".*\battention\.output\.dense\.weight$", 1),
)

# SAM3 uses split q/k/v projections (sam3.h attention naming) instead of a
# fused qkv; column-parallel q/k/v + fc1, row-parallel o_proj (fc2 is
# covered by the default rule).
SAM3_TP_RULES: tuple[tuple[str, int], ...] = DEFAULT_TP_RULES + (
    (r".*\b(q_proj|k_proj|v_proj)\.weight$", 0),
    (r".*\b(q_proj|k_proj|v_proj)\.bias$", 0),
    (r".*\bo_proj\.weight$", 1),
)


def make_mesh(n_devices: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1, device: str = "cuda"):
    """Create a (dp, pp, sp, tp) ``DeviceMesh``. dp = n_devices // (pp * sp * tp).

    One rank is one card (``device="cuda"``) or one CPU process
    (``"cpu"``). The mesh takes ranks 0..n_devices-1 of the process group
    (a process without one gets a world of one, so ``make_mesh(1)`` works
    alone); ranks past it are not in the mesh. ``sp`` and ``pp`` are the
    sequence- and pipeline-parallel axes (parallel/pipeline.py). Axis order
    puts tp innermost so tensor-parallel collectives stay nearest, then sp,
    then pp, dp outermost; the extra axes default to size 1. A mesh larger
    than the ranks there are, or than the cards of a CUDA host, raises: two
    ranks never share a card."""
    from torch.distributed.device_mesh import DeviceMesh

    if (n_devices is not None and n_devices < 1) or tp < 1 or sp < 1 or pp < 1:
        raise_error(
            "make_mesh: need n_devices >= 1 and tp/sp/pp >= 1, got {} / {} / {} / {}",
            n_devices, tp, sp, pp,
        )
    cards = cards_available(device)
    if cards < 1 or (n_devices is not None and n_devices > cards):
        raise_error("make_mesh: need {} devices, have {}", n_devices or 1, cards)
    _ensure_world(device)
    world = min(dist.get_world_size(), cards)
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise_error("make_mesh: need {} devices, have {}", n_devices, world)
    if n_devices % (pp * sp * tp):
        raise_error(
            "make_mesh: n_devices {} not divisible by pp {} * sp {} * tp {}",
            n_devices, pp, sp, tp,
        )
    ranks = torch.arange(n_devices).reshape(n_devices // (pp * sp * tp), pp, sp, tp)
    return DeviceMesh(device, ranks, mesh_dim_names=MESH_AXES)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis: size}, the JAX ``dict(mesh.shape)``."""
    return {name: int(n) for name, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def replicate(mesh) -> list:
    """Placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def batch_sharding(mesh) -> list:
    """Placements of a tensor whose leading (batch) axis is split over dp."""
    from torch.distributed.tensor import Shard

    out = replicate(mesh)
    out[mesh.mesh_dim_names.index("dp")] = Shard(0)
    return out


def shard_params(
    params: Mapping[str, Any],
    mesh,
    rules: Sequence[tuple[str, int]] = DEFAULT_TP_RULES,
    heads: Callable[[str], int | None] | None = None,
    qkv_layout: str = "global",
):
    """Place parameters on the mesh as DTensors: rule-matched tensors are
    tp-sharded (``Shard(d)`` over the tp axis, when the dimension divides),
    the rest replicated. Every rank passes its own full copy (each loads the
    same GGUF) and keeps only its shard: nothing is sent at load.

    ``heads(name)``: the head count of the attention a weight belongs to
    (None: not an attention weight). Such a weight shards only when its
    heads divide over tp, so each rank holds whole heads; otherwise it
    stays replicated, and the model runs that attention whole on every
    rank. A fused ``qkv`` weight and bias are regrouped first, so that
    rank r holds q, k and v of its own heads (``qkv_layout``: ``"global"``
    for [q..|k..|v..] rows, ``"per_head"`` for the interleaved rows of
    TinyViT, which are head-grouped as they stand; parallel/tp.py)."""
    from torch.distributed.tensor import DTensor, Shard

    from .tp import regroup_qkv

    compiled = [(re.compile(pat), dim) for pat, dim in rules]
    tp_axis = mesh.mesh_dim_names.index("tp")
    tp_size = int(mesh.mesh.shape[tp_axis])
    tp_rank = mesh.get_local_rank("tp") if mesh.get_coordinate() is not None else 0
    out = {}
    for name, value in params.items():
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        placements = replicate(mesh)
        local = t
        dim = shard_dim(name, tuple(t.shape), tp_size, compiled, heads)
        if dim is not None:
            if dim == 0 and qkv_layout == "global" and re.search(r"\bqkv\.(weight|bias)$", name):
                t = regroup_qkv(t, tp_size)
            local = t.chunk(tp_size, dim)[tp_rank].contiguous()
            placements[tp_axis] = Shard(dim)
        out[name] = DTensor.from_local(local, mesh, placements, run_check=False)
    return out


def fsdp_params(params: Mapping[str, Any], mesh, min_size: int = 2**16) -> dict:
    """:func:`shard_params`' output with every float DTensor that the tp
    rules left replicated, of at least ``min_size`` elements and with a
    leading dim that divides over dp, re-placed ``Shard(0)`` over dp: each
    rank keeps its rows (ZeRO-3: the weight and its optimizer slots live
    partitioned). A mesh of dp 1 leaves everything as it is, as the JAX
    package does (vision_tpu/train.py:125-146)."""
    from torch.distributed.tensor import DTensor, Shard

    from .tp import is_dtensor

    dp = mesh_shape(mesh)["dp"]
    if dp == 1:
        return dict(params)
    axis = mesh.mesh_dim_names.index("dp")
    rank = mesh.get_local_rank("dp") if mesh.get_coordinate() is not None else 0
    out = {}
    for name, v in params.items():
        if (is_dtensor(v) and all(p.is_replicate() for p in v.placements) and v.is_floating_point()
                and v.numel() >= min_size and v.ndim >= 1 and v.shape[0] % dp == 0):
            placements = list(v.placements)
            placements[axis] = Shard(0)
            v = DTensor.from_local(v.to_local().chunk(dp, 0)[rank].contiguous(), mesh, placements, run_check=False)
        out[name] = v
    return out


def shard_dim(name: str, shape: tuple, tp_size: int, rules, heads=None) -> int | None:
    """The dimension ``name`` shards over a tp axis of ``tp_size``, or None
    (replicated). ``rules``: compiled (regex, dim) pairs."""
    if tp_size <= 1:
        return None
    for pat, dim in rules:
        if pat.match(name):
            if dim >= len(shape) or shape[dim] % tp_size:
                return None
            n_heads = heads(name) if heads is not None else None
            if n_heads is not None and n_heads % tp_size:
                return None
            return dim
    return None


def local_params(params: Mapping[str, Any]) -> dict:
    """A model's view of :func:`shard_params`' output: replicated DTensors
    become their local tensors, tp-sharded ones stay DTensors, so that
    ``ops.nn.linear`` sees their placement (parallel/tp.py)."""
    from .tp import is_dtensor, tp_dim

    return {k: v if is_dtensor(v) and tp_dim(v) is not None else (v.to_local() if is_dtensor(v) else v)
            for k, v in params.items()}


def mesh_params(params: Mapping[str, Any], mesh, device, rules=DEFAULT_TP_RULES, heads=None,
                qkv_layout: str = "global") -> dict:
    """A meshed model's params: :func:`shard_params` then
    :func:`local_params`; on a mesh of tp 1, where every weight is
    replicated, the loader's own tensors (the same as a round trip through
    DTensors would give back). ``device`` (the model's ``Device``) must be
    of the mesh's type: a CUDA mesh never runs a rank on the CPU."""
    if device.torch_device.type != mesh.device_type:
        raise_error("a {} mesh needs a {} model, got {}", mesh.device_type, mesh.device_type,
                    device.torch_device.type)
    if mesh_tp(mesh) == 1:
        return dict(params)
    return local_params(shard_params(params, mesh, rules, heads, qkv_layout))


def mesh_tp(mesh) -> int:
    """The tp extent of ``mesh`` (1 without one)."""
    return 1 if mesh is None else mesh_shape(mesh)["tp"]


def _dp_slice(x: torch.Tensor, mesh) -> torch.Tensor:
    dp = mesh_shape(mesh)["dp"]
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by mesh dp={dp}")
    return x.chunk(dp, 0)[mesh.get_local_rank("dp")]


def _dp_gather(y: torch.Tensor, mesh) -> torch.Tensor:
    group = mesh.get_group("dp")
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, 0)


def sharded_forward(fn: Callable, mesh) -> Callable:
    """``fn(params, x)`` with the batch split over dp: every rank of the
    mesh calls the result with the same global ``x``; each runs ``fn`` on
    its dp slice (``params`` from :func:`shard_params` keep their
    placement: ``fn`` computes Megatron-style on the local shards, as the
    models do), and the outputs are all-gathered over dp, so every rank
    returns the global output."""

    def run(params, x):
        with torch.inference_mode():
            y = fn(local_params(params), _dp_slice(x, mesh))
            return _dp_gather(y, mesh)

    return run


def training_step(loss_fn: Callable, mesh, lr: float = 1e-3) -> Callable:
    """An SGD step: gradients of ``loss_fn(params, batch)`` with respect to
    the float params, computed on this rank's dp slice of the global
    ``batch``, averaged over dp (one all-reduce a tensor), then applied.
    tp-sharded weights keep their shards (their gradients are local to
    them; parallel/tp.py's collectives carry the gradients of the
    replicated activations). Returns ``(loss, new_params)``: the loss
    averaged over dp, and the params placed as they came."""
    from torch.distributed.tensor import DTensor

    from .tp import is_dtensor

    dp_group = mesh.get_group("dp")
    dp = mesh_shape(mesh)["dp"]

    def step(params, batch):
        local, leaves = {}, {}
        for k, v in local_params(params).items():
            t = v.to_local() if is_dtensor(v) else v
            leaves[k] = t = t.detach().requires_grad_(t.is_floating_point())
            local[k] = DTensor.from_local(t, v.device_mesh, v.placements, run_check=False) if is_dtensor(v) else t
        loss = loss_fn(local, _dp_slice(batch, mesh))
        floats = [k for k, v in leaves.items() if v.requires_grad]
        grads = torch.autograd.grad(loss, [leaves[k] for k in floats], allow_unused=True)
        new = {}
        with torch.no_grad():
            for k, g in zip(floats, grads):
                g = torch.zeros_like(leaves[k]) if g is None else g.clone()
                dist.all_reduce(g, group=dp_group)
                new[k] = leaves[k] - lr * (g / dp).to(leaves[k].dtype)
            total = loss.detach().clone()
            dist.all_reduce(total, group=dp_group)
        out = {}
        for k, v in params.items():
            t = new.get(k)
            if t is None:
                out[k] = v
            else:
                out[k] = DTensor.from_local(t, v.device_mesh, v.placements, run_check=False) if is_dtensor(v) else t
        return total / dp, out

    return step
