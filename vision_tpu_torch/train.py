"""Training / fine-tuning with checkpoint/resume — a port of
vision_tpu/train.py, on one device or over a mesh of parallel/.

The JAX package jits one state-donating step (``value_and_grad`` + an optax
update); here the step runs eagerly: ``torch.autograd.grad`` over the
trainable leaves, then ``torch.optim.Adam`` updates them in place (the
counterpart of the donation: the state owns its tensors). The hand-written
kernels take part through their autograd functions (ops/cuda: the forward
is the kernel, the backward PyTorch ops).

  * ``trainable`` partitions the flat parameter dict by a name predicate, as
    in the JAX package: frozen leaves (and every non-float leaf or
    quantized resident) get no gradient.
  * Gradient accumulation runs the microbatches one after another, summing
    their gradients in f32: with equal microbatches the mean is the
    full-batch gradient.
  * ``adam(lr)`` makes ``torch.optim.Adam`` with optax ``adam``'s defaults
    (b1 0.9, b2 0.999, eps 1e-8; bias correction on m and v, eps added to
    sqrt(v̂)), so one step moves a leaf as the JAX step does, to rounding.
  * On a mesh (``create_train_state(mesh=)``) the parameters are DTensors
    placed by the rules inference uses (parallel/sharding.py
    ``shard_params``: tp shards), and with ``fsdp`` the float weights the
    rules left replicated are sharded over dp on their rows. The optimizer
    steps each rank's local shards, so its slots hold only those. Every
    rank calls the step with the same global batch (or the dp-sharded one
    ``prefetch_to_device(mesh=)`` makes) and runs the loss on its dp rows;
    the gradients of the other leaves are averaged over dp (one coalesced
    all-reduce), an fsdp leaf's come back reduce-scattered by the one
    all-gather a forward that hands the loss its whole weight
    (parallel/tp.py ``gather_fsdp``), tp shards keep theirs.
  * Checkpoints are ``torch.save`` files (the step, the trainable and float
    parameters, ``optimizer.state_dict()`` and the EMA) in ``step_{n}/``,
    written to a temporary name, fsynced and renamed; orbax files are not
    read. A restore is bit-exact. A meshed state saves its tensors whole
    (every rank gathers, one rank writes) and a restore re-places them, so
    a checkpoint does not depend on the mesh that wrote it.
"""

from __future__ import annotations

import collections
import functools
import os
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from .core.errors import raise_error
from .core.quant import QuantResident
from .core.quant import _is_float as _is_float_leaf
from .parallel.sharding import DEFAULT_TP_RULES
from .parallel.tp import gather_fsdp, is_dtensor, is_fsdp

__all__ = [
    "TrainState",
    "adam",
    "create_train_state",
    "data_loader",
    "ema_update",
    "export_gguf",
    "full_params",
    "make_train_step",
    "prefetch_to_device",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_checkpoint",
]


@dataclass
class TrainState:
    """The mutable state of a training run: ``params`` is the flat
    dotted-name dict every model of the port reads (core/params.py), its
    trainable leaves float tensors that require grad; ``optimizer`` holds
    those leaves, in the order of ``names``; ``step`` counts updates. On a
    ``mesh`` every tensor of ``params`` is a DTensor (its placement: tp
    shard, fsdp shard or replicated) whose local tensor is the leaf the
    optimizer updates."""

    step: int
    params: dict
    optimizer: torch.optim.Optimizer
    names: tuple[str, ...]
    mesh: Any = None


def adam(lr: float) -> Callable:
    """An optimizer factory for :func:`create_train_state`: ``torch.optim.Adam``
    over the trainable leaves with optax ``adam``'s defaults (b1 0.9, b2
    0.999, eps 1e-8)."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _is_float(v) -> bool:
    # a quantized resident base is frozen by definition (QLoRA): the
    # optimizer cannot step int8 levels
    return not isinstance(v, QuantResident) and _is_float_leaf(v)


def _trainable_pred(trainable) -> Callable[[str, Any], bool]:
    """None -> every float leaf; a string -> regex on the dotted name; a
    callable -> (name, value) predicate. Non-float leaves never train."""
    if trainable is None:
        return lambda name, v: _is_float(v)
    if isinstance(trainable, str):
        pat = re.compile(trainable)
        return lambda name, v: _is_float(v) and bool(pat.search(name))
    return lambda name, v: _is_float(v) and bool(trainable(name, v))


def _tensor(v):
    if isinstance(v, (torch.Tensor, QuantResident)):
        return v
    return torch.from_numpy(np.array(v))


def create_train_state(params: Mapping[str, Any], optimizer: Callable, mesh=None, rules: Sequence = DEFAULT_TP_RULES,
                       trainable=None, fsdp: bool = False, fsdp_min_size: int = 2**16) -> TrainState:
    """Take ``params`` (tensors, numpy arrays or residents) over and build
    ``optimizer`` (a factory such as :func:`adam`) over the trainable
    subset. The trainable leaves become tensors that require grad and share
    their storage with the ones given: the optimizer updates them in place,
    as the JAX step donates its state, so copy first to keep the originals.

    ``mesh``: place the params with ``shard_params`` and ``rules`` (the
    ones inference uses) on the mesh's device type; ``fsdp`` also shards
    every float weight the rules left replicated, of at least
    ``fsdp_min_size`` elements, over dp on its rows (nothing at dp 1).
    Every rank passes its own full copy. A quantized resident stays whole
    on every rank, as the JAX package places it under ``shard_params``;
    one that a tp rule would shard is refused."""
    pred = _trainable_pred(trainable)
    out = {k: _tensor(v) for k, v in params.items()}
    names = tuple(k for k, v in out.items() if pred(k, v))
    if not names:
        raise_error("create_train_state: no trainable parameters selected")
    if mesh is None:
        for k, v in out.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.detach().requires_grad_(k in names)
        return TrainState(0, out, optimizer([out[k] for k in names]), names)
    placed = _place(out, mesh, rules, fsdp, fsdp_min_size)
    from torch.distributed.tensor import DTensor

    leaves = {}
    for k, v in placed.items():
        if is_dtensor(v):
            leaves[k] = t = v.to_local().detach().requires_grad_(k in names)
            # the state's DTensor shares its local storage with the leaf the optimizer updates
            placed[k] = DTensor.from_local(t.detach(), v.device_mesh, v.placements, run_check=False)
    return TrainState(0, placed, optimizer([leaves[k] for k in names]), names, mesh)


def _place(params: dict, mesh, rules, fsdp: bool, fsdp_min_size: int) -> dict:
    """``params`` placed on ``mesh`` (see :func:`create_train_state`)."""
    from .parallel.sharding import fsdp_params, mesh_shape, shard_dim, shard_params

    device = torch.device(mesh.device_type, torch.cuda.current_device()) if mesh.device_type == "cuda" else None
    tensors, residents = {}, {}
    tp = mesh_shape(mesh)["tp"]
    compiled = [(re.compile(pat), dim) for pat, dim in rules]
    for k, v in params.items():
        if isinstance(v, QuantResident):
            if shard_dim(k, tuple(v.shape), tp, compiled) is not None:
                raise_error("create_train_state: quantized resident '{}' would be tp-sharded; a resident stays whole "
                            "(train it on a mesh of tp 1, or expand it)", k)
            residents[k] = v
        else:
            if v.device.type != mesh.device_type:
                if v.device.type != "cpu":
                    raise_error("create_train_state: a {} mesh needs {} tensors, got '{}' on {}", mesh.device_type,
                                mesh.device_type, k, v.device.type)
                v = v.to(device)
            tensors[k] = v
    placed = shard_params(tensors, mesh, rules)
    if fsdp:
        placed = fsdp_params(placed, mesh, fsdp_min_size)
    return {k: placed[k] if k in placed else residents[k] for k in params}


class _MeshPlan:
    """What a meshed state's step reuses (placements never change): the
    optimizer's leaves by name, the loss's view of every leaf that needs no
    DTensor (replicated ones as their plain leaves), the leaves that do
    (tp and fsdp shards: rebuilt from their leaves each step, so that
    autograd reaches them), and which trainable leaves are fsdp shards."""

    def __init__(self, state: TrainState):
        self.leaves = dict(zip(state.names, (p for g in state.optimizer.param_groups for p in g["params"])))
        self.base, self.placed = {}, []
        for k, v in state.params.items():
            t = self.leaves.get(k, v.to_local() if is_dtensor(v) else v)
            if is_dtensor(v) and not all(p.is_replicate() for p in v.placements):
                self.placed.append((k, t, v.device_mesh, v.placements, is_fsdp(v)))
            self.base[k] = t
        self.fsdp = [is_fsdp(state.params[k]) for k in state.names]

    def view(self) -> dict:
        """The params one forward of the loss reads: tp shards as DTensors,
        each fsdp shard gathered whole here, once (its gradient comes back
        reduce-scattered), everything else as its plain leaf."""
        from torch.distributed.tensor import DTensor

        view = dict(self.base)
        for k, t, mesh, placements, fsdp in self.placed:
            view[k] = DTensor.from_local(t, mesh, placements, run_check=False)
            if fsdp:
                view[k] = gather_fsdp(view[k])
        return view


def _micro(batch, i: int):
    """Microbatch ``i`` of a batch pytree (tuples, lists, dicts of tensors)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_micro(b, i) for b in batch)
    if isinstance(batch, dict):
        return {k: _micro(v, i) for k, v in batch.items()}
    return batch[i]


def _leaves(batch) -> list:
    if isinstance(batch, (tuple, list)):
        return [x for b in batch for x in _leaves(b)]
    if isinstance(batch, dict):
        return [x for v in batch.values() for x in _leaves(v)]
    return [batch]


def _dp_coords(mesh) -> tuple[int, int]:
    """(dp, this rank's dp index) of ``mesh``, read once a step function
    (DeviceMesh's accessors rebuild their answer at each call)."""
    from .parallel.sharding import mesh_shape

    return mesh_shape(mesh)["dp"], mesh.get_local_rank("dp") if mesh.get_coordinate() is not None else 0


def _dp_rows(batch, dp: int, rank: int, axis: int):
    """Rank ``rank``'s rows of a batch pytree split over ``dp``: a DTensor
    leaf (from :func:`prefetch_to_device`) gives its local rows, a plain
    tensor is chunked along ``axis``; anything else (a seed) passes as it
    is."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_dp_rows(b, dp, rank, axis) for b in batch)
    if isinstance(batch, dict):
        return {k: _dp_rows(v, dp, rank, axis) for k, v in batch.items()}
    if is_dtensor(batch):
        place = batch.placements[batch.device_mesh.mesh_dim_names.index("dp")]
        if dp > 1 and not (place.is_shard() and place.dim == axis):
            raise_error("make_train_step: a DTensor batch leaf must be sharded over dp on axis {}, got {}", axis,
                        batch.placements)
        return batch.to_local()
    if not isinstance(batch, torch.Tensor):
        return batch
    if batch.shape[axis] % dp:
        raise_error("make_train_step: batch axis {} of {} does not divide over dp {}", axis, tuple(batch.shape), dp)
    return batch.chunk(dp, axis)[rank].contiguous()


def _all_reduce_mean(tensors: list, group, n: int) -> list:
    """Each tensor summed over ``group`` (one all-reduce a dtype, over the
    flattened tensors), then divided by ``n``."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    out = list(tensors)
    by_type: dict = {}
    for i, t in enumerate(tensors):
        by_type.setdefault(t.dtype, []).append(i)
    for idx in by_type.values():
        flat = _flatten_dense_tensors([tensors[i] for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        for i, t in zip(idx, _unflatten_dense_tensors(flat, [tensors[i] for i in idx])):
            out[i] = t
    return out


def make_train_step(loss_fn: Callable, mesh=None, accum: int = 1, trainable=None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` sees the full param dict, frozen
    leaves included; gradients go to the state's trainable leaves only
    (``trainable``, when given, must select exactly those). With ``accum >
    1`` every batch leaf carries a leading microbatch axis of that size: the
    step runs the microbatches in turn, sums their gradients in f32 and
    applies one update of the mean. A leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it. Metrics: ``{"loss": the mean
    loss over the batch}`` (a 0-d f32 tensor on the loss's device).

    ``mesh`` (the state's, from :func:`create_train_state`): every rank of
    it calls the step with the same global batch, or with the dp-sharded
    leaves of :func:`prefetch_to_device` (``mesh``, the same ``accum``),
    and runs ``loss_fn`` on its dp rows (axis 1 of the leaves with ``accum
    > 1``, as the JAX step's ``P(None, "dp")``). The loss must be a mean
    over the batch's samples: the step averages it, and the gradients of
    every leaf that is not an fsdp shard, over dp; tp shards keep their
    local gradients. The reported loss is the global batch's mean."""
    if accum < 1:
        raise_error("make_train_step: accum must be >= 1, got {}", accum)
    pred = _trainable_pred(trainable) if trainable is not None else None
    axis = 1 if accum > 1 else 0
    if mesh is not None:
        dp, dp_rank = _dp_coords(mesh)
        dp_group = mesh.get_group("dp")

    def grads_of(params, train, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        return loss.detach().float(), [torch.zeros_like(p) if g is None else g for p, g in zip(train, grads)]

    def step(state: TrainState, batch):
        if pred is not None and tuple(k for k, v in state.params.items() if pred(k, v)) != state.names:
            raise_error("make_train_step: trainable selects other leaves than the state's optimizer holds")
        if (mesh is None) != (state.mesh is None):
            raise_error("make_train_step: the step's mesh and the state's differ (pass create_train_state's mesh)")
        if mesh is None:
            train = [state.params[k] for k in state.names]
            params = lambda: state.params  # noqa: E731
        else:
            plan = state.__dict__.get("_plan")
            if plan is None:  # built at the state's first meshed step, kept on it
                plan = state.__dict__["_plan"] = _MeshPlan(state)
            train = [plan.leaves[k] for k in state.names]
            params = plan.view
            batch = _dp_rows(batch, dp, dp_rank, axis)
        if accum == 1:
            loss, grads = grads_of(params(), train, batch)
        else:
            for leaf in _leaves(batch):
                if isinstance(leaf, torch.Tensor) and leaf.shape[0] != accum:
                    raise_error(
                        "make_train_step(accum={}): every batch leaf needs leading axis {} (microbatch count), "
                        "got shape {}", accum, accum, tuple(leaf.shape),
                    )
            loss = 0.0
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in train]
            for i in range(accum):
                loss_i, g = grads_of(params(), train, _micro(batch, i))
                loss = loss + loss_i
                for a, b in zip(gsum, g):
                    a += b.float()
            loss = loss / accum
            grads = [g / accum for g in gsum]
        if mesh is not None:
            # an fsdp leaf's gradient is already its rows' sum over dp (the gather's reduce-scatter)
            reduced = iter(_all_reduce_mean([g for g, s in zip(grads, plan.fsdp) if not s] + [loss], dp_group, dp))
            grads = [g / dp if s else next(reduced) for g, s in zip(grads, plan.fsdp)]
            loss = next(reduced)
        for p, g in zip(train, grads):
            p.grad = g.to(p.dtype)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, {"loss": loss}

    return step


def export_gguf(params: Mapping[str, Any], dst: str | os.PathLike, source=None, arch: str | None = None,
                float_type: str = "f32") -> str:
    """Write (fine-tuned) params back to a deployable GGUF file.

    ``params`` is the flat dotted-name dict in the loader contract's
    torch-canonical layouts (what ``load_weights`` returns and
    ``TrainState.params`` holds). ``source`` (a GGUFFile or path) gives the
    family KVs, except the storage-layout ones (``{arch}.tensor_data_layout``,
    ``{arch}.conv2d_weights``, ``general.file_type``): the file carries
    ``tensor_data_layout = "torch"``, every tensor torch-canonical.
    ``float_type``: "f32" or "f16" storage; a resident leaf densifies.
    Byte for byte the JAX package's ``export_gguf`` of the same values."""
    from .core.gguf import REQUANTIZE_TYPES, GGUFFile, GGUFWriter

    if float_type not in ("f32", "f16"):
        raise_error(
            "export_gguf: float_type must be 'f32' or 'f16' (quantize the result with requantize_gguf), "
            "got '{}'", float_type,
        )
    if source is not None and not isinstance(source, GGUFFile):
        source = GGUFFile(source)
    if arch is None:
        arch = source.arch if source is not None else None
    if not arch:
        raise_error("export_gguf: pass arch= or a source file with an architecture")
    w = GGUFWriter(os.fspath(dst), arch)
    if source is not None:
        drop = {"general.file_type", "general.architecture", f"{arch}.tensor_data_layout", f"{arch}.conv2d_weights"}
        for k, v in source.metadata.items():
            if k not in drop:
                w.add(k, v, vtype=source.kv_types.get(k))
    w.add("general.file_type", REQUANTIZE_TYPES[float_type][0])
    w.add(f"{arch}.tensor_data_layout", "torch")
    target = np.float16 if float_type == "f16" else np.float32
    for name, v in params.items():
        if isinstance(v, QuantResident):
            v = v.dequant()
        if isinstance(v, torch.Tensor):
            v = v.detach()
            v = (v.float() if v.is_floating_point() else v).cpu().numpy()
        v = np.asarray(v)
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(target, copy=False)
        w.add_tensor(name, v)
    w.write()
    return os.fspath(dst)


def _stack(results: list):
    """Stack a list of equally structured items (arrays, tuples, lists,
    dicts of arrays) along a new leading axis."""
    first = results[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([r[i] for r in results]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack([r[k] for r in results]) for k in first}
    return np.stack(results)


def data_loader(items: Sequence, batch_size: int, load: Callable | None = None, workers: int = 4,
                shuffle: bool = False, seed: int = 0, drop_last: bool = True):
    """Threaded host-side batch producer: maps ``load`` over ``items`` with
    a pool of ``workers`` threads (at most two batches of loads in flight)
    and stacks each group of ``batch_size`` results (leaves gain a leading
    batch axis). ``shuffle`` orders the items with numpy's generator of
    ``seed``, as the JAX package does, so one seed gives both packages the
    same order; ``drop_last`` drops a trailing partial batch. Chain into
    :func:`prefetch_to_device`."""
    if batch_size < 1:
        raise_error("data_loader: batch_size must be >= 1, got {}", batch_size)
    order = list(range(len(items)))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = (len(order) // batch_size) * batch_size if drop_last else len(order)
    order = order[:n]
    if not order:
        return
    if load is None:
        load = lambda x: x  # noqa: E731
    groups = [order[i : i + batch_size] for i in range(0, len(order), batch_size)]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: collections.deque = collections.deque()
        gi = 0
        while gi < len(groups) or pending:
            while gi < len(groups) and len(pending) < 2:
                pending.append([pool.submit(load, items[j]) for j in groups[gi]])
                gi += 1
            yield _stack([f.result() for f in pending.popleft()])


def _put(b, device: torch.device | None):
    if isinstance(b, (tuple, list)):
        return type(b)(_put(x, device) for x in b)
    if isinstance(b, dict):
        return {k: _put(v, device) for k, v in b.items()}
    t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(b))
    if device is None or device.type == "cpu":
        return t
    # a pinned host copy lets the H2D copy run on the stream while the host
    # goes on; the caching host allocator holds the pinned block until it ends
    return t.pin_memory().to(device, non_blocking=True)


def _put_rows(b, device: torch.device, mesh, placements: list, dp: int, rank: int, axis: int):
    """A host batch pytree as rank ``rank``'s dp rows (along ``axis``) on
    ``device``, each leaf a DTensor of ``placements`` (sharded over dp on
    that axis)."""
    if isinstance(b, (tuple, list)):
        return type(b)(_put_rows(x, device, mesh, placements, dp, rank, axis) for x in b)
    if isinstance(b, dict):
        return {k: _put_rows(v, device, mesh, placements, dp, rank, axis) for k, v in b.items()}
    from torch.distributed.tensor import DTensor

    t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(b))
    if t.ndim <= axis or t.shape[axis] % dp:
        raise_error("prefetch_to_device: leaf of shape {} does not divide over dp {} on axis {}", tuple(t.shape), dp,
                    axis)
    rows = t.chunk(dp, axis)[rank].contiguous()
    return DTensor.from_local(_put(rows, device), mesh, placements, run_check=False)


def prefetch_to_device(batches, size: int = 2, device: torch.device | str | None = None, mesh=None, accum: int = 1):
    """Wrap a host batch iterator so ``size`` batches are on ``device``
    ahead of the consumer: numpy leaves become tensors, copied to a CUDA
    device from pinned memory without blocking, so the copy of batch N+1
    overlaps the step on batch N. ``device`` None keeps them on the host.

    With a ``mesh`` every leaf arrives as this rank's dp rows on its card
    (``device`` defaults to the mesh's: the current card, or the host), a
    DTensor sharded over dp, the layout ``make_train_step(mesh=)`` takes.
    Pass the ``accum`` given to the step: leaves then carry the (accum,
    micro, ...) microbatch axis first and dp shards axis 1, the samples."""
    if size < 1 or accum < 1:
        raise_error("prefetch_to_device: size and accum must be >= 1, got {} / {}", size, accum)
    if mesh is not None and device is None and mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device) if device is not None else None
    if mesh is None:
        put = functools.partial(_put, device=device)
    else:
        from torch.distributed.tensor import Shard

        from .parallel.sharding import replicate

        axis = 1 if accum > 1 else 0
        placements = replicate(mesh)
        placements[mesh.mesh_dim_names.index("dp")] = Shard(axis)
        dp, rank = _dp_coords(mesh)
        put = functools.partial(_put_rows, device=device, mesh=mesh, placements=placements, dp=dp, rank=rank,
                                axis=axis)
    it = iter(batches)
    queue: collections.deque = collections.deque()
    done = False
    while True:
        while not done and len(queue) < size:
            try:
                queue.append(put(next(it)))
            except StopIteration:
                done = True
        if not queue:
            return
        yield queue.popleft()


@torch.no_grad()
def ema_update(ema: Mapping[str, Any], params: Mapping[str, Any], decay: float = 0.999) -> dict:
    """One exponential-moving-average step over a param dict: ``ema <- decay
    * ema + (1 - decay) * params`` for float leaves, in the EMA leaf's type
    (non-float leaves track ``params`` as they are). Returns a new dict. A
    meshed state's DTensors are averaged shard by shard and keep their
    placement."""

    def one(e, p):
        if not _is_float(p):
            return p
        if is_dtensor(e):
            from torch.distributed.tensor import DTensor

            return DTensor.from_local(one(e.to_local(), p.to_local()), e.device_mesh, e.placements, run_check=False)
        d = torch.tensor(decay, dtype=e.dtype, device=e.device)
        return e * d + p.detach() * (1 - d)

    return {k: one(ema[k], p) for k, p in params.items()}


def _regrouped(name: str, v) -> bool:
    """Whether ``shard_params`` regrouped this tp-sharded fused qkv."""
    from .parallel.tp import tp_dim

    return tp_dim(v) == 0 and re.search(r"\bqkv\.(weight|bias)$", name) is not None


def _whole(name: str, v) -> torch.Tensor:
    """A param (or a slot laid out as it) whole and in the file's row order:
    a DTensor gathered over the mesh (every rank of it calls this), a fused
    qkv that placement regrouped put back."""
    if not is_dtensor(v):
        return v.detach()
    from .parallel.tp import tp_size, ungroup_qkv

    t = v.detach().full_tensor()
    return ungroup_qkv(t, tp_size(v)) if _regrouped(name, v) else t


def _local_of(name: str, whole: torch.Tensor, like) -> torch.Tensor:
    """The inverse of :func:`_whole`: this rank's shard of ``whole`` in the
    placement of the DTensor ``like``."""
    from .parallel.tp import regroup_qkv, tp_size

    if _regrouped(name, like):
        whole = regroup_qkv(whole, tp_size(like))
    mesh, t = like.device_mesh, whole
    coord = mesh.get_coordinate()
    for i, place in enumerate(like.placements):
        if place.is_shard():
            t = t.chunk(int(mesh.size(i)), place.dim)[coord[i]]
    return t


def full_params(params: Mapping[str, Any]) -> dict:
    """A meshed state's params (or EMA) whole on every rank, as
    ``export_gguf`` and ``lora.merge_lora`` take them: each DTensor
    gathered (a collective: every rank of the mesh calls this), fused qkv
    rows back in file order. Other leaves pass as they are."""
    return {k: _whole(k, v) if is_dtensor(v) else v for k, v in params.items()}


# ---------------------------------------------------------------------------
# Checkpoint / resume

_STATE_FILE = "state.pt"


def _split_tree(tree) -> tuple[TrainState, dict | None]:
    if isinstance(tree, TrainState):
        return tree, None
    state, ema = tree
    if not isinstance(state, TrainState):
        raise_error("checkpoint: expected a TrainState or a (TrainState, ema) pair, got {}", type(tree).__name__)
    return state, ema


def _tensors(params: Mapping[str, Any]) -> dict:
    return {k: _whole(k, v) for k, v in params.items() if isinstance(v, torch.Tensor)}


def _optimizer_whole(st: TrainState) -> dict:
    """``st.optimizer.state_dict()`` with every slot laid out as its meshed
    param gathered whole (the optimizer's own state is not touched)."""
    sd = st.optimizer.state_dict()
    if st.mesh is None:
        return sd
    from torch.distributed.tensor import DTensor

    state = {}
    for idx, slots in sd["state"].items():
        like = st.params[st.names[idx]]
        state[idx] = {key: _whole(st.names[idx], DTensor.from_local(val, like.device_mesh, like.placements,
                                                                       run_check=False))
                      if is_dtensor(like) and isinstance(val, torch.Tensor) and val.ndim else val
                      for key, val in slots.items()}
    return {**sd, "state": state}


def _mesh_barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` is here (a small all-reduce along
    each of its axes, over the groups' host backend)."""
    import torch.distributed as dist

    for i, name in enumerate(mesh.mesh_dim_names):
        if int(mesh.size(i)) > 1:
            dist.all_reduce(torch.zeros(1), group=mesh.get_group(name))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(directory: str | os.PathLike, state, *, force: bool = True) -> str:
    """Write ``state`` (a TrainState, or the ``(state, ema)`` pair the
    recipes keep) to ``directory`` as one ``torch.save`` file: the step,
    every tensor leaf of the params (quantized residents are frozen and come
    from the model file, so they are named, not saved), the optimizer's
    ``state_dict()`` and the EMA's tensors. The file is written under a
    temporary name, fsynced, and the directory renamed into place, so a
    preempted process leaves its previous checkpoint whole. ``force``
    replaces an existing checkpoint at the same path. A meshed state is
    saved whole: every rank of its mesh calls this, the first rank writes,
    and all return once the file is in place."""
    st, ema = _split_tree(state)
    path = os.path.abspath(os.fspath(directory))
    if os.path.exists(path) and not force:
        raise_error("save_checkpoint: '{}' exists (pass force=True to replace it)", path)
    payload = {
        "step": int(st.step),
        "names": list(st.names),
        "params": _tensors(st.params),
        "residents": sorted(k for k, v in st.params.items() if isinstance(v, QuantResident)),
        "optimizer": _optimizer_whole(st),
        "ema": None if ema is None else _tensors(ema),
    }
    if st.mesh is None or all(c == 0 for c in st.mesh.get_coordinate()):
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
    if st.mesh is not None:
        _mesh_barrier(st.mesh)
    return path


def _copy_into(params: Mapping[str, Any], saved: dict) -> None:
    for k, v in saved.items():
        like = params[k]
        if is_dtensor(like):
            like.to_local().copy_(_local_of(k, v, like))
        else:
            like.copy_(v)


@torch.no_grad()
def restore_checkpoint(directory: str | os.PathLike, like):
    """Restore a :func:`save_checkpoint` directory into ``like``, a freshly
    built state (or ``(state, ema)`` pair) of the same model and trainable
    set: every saved tensor is copied into ``like``'s (the optimizer keeps
    holding the same leaves; on a mesh each rank takes its shards, in the
    placements of ``like``), the optimizer loads its state dict, the step
    is set. Bit-exact. Returns ``like``."""
    st, ema = _split_tree(like)
    path = os.path.abspath(os.fspath(directory))
    payload = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=True)
    if tuple(payload["names"]) != st.names:
        raise_error("restore_checkpoint: '{}' trains other leaves than the state given", path)
    saved = payload["params"]
    if set(saved) != {k for k, v in st.params.items() if isinstance(v, torch.Tensor)} or payload["residents"] != sorted(
            k for k, v in st.params.items() if isinstance(v, QuantResident)):
        raise_error("restore_checkpoint: '{}' holds other parameters than the state given", path)
    _copy_into(st.params, saved)
    sd = payload["optimizer"]
    if st.mesh is not None:
        sd = {**sd, "state": {idx: {key: _local_of(st.names[idx], val, st.params[st.names[idx]])
                                    if is_dtensor(st.params[st.names[idx]]) and isinstance(val, torch.Tensor)
                                    and val.ndim else val for key, val in slots.items()}
                              for idx, slots in sd["state"].items()}}
    st.optimizer.load_state_dict(sd)
    st.step = int(payload["step"])
    if ema is not None:
        if payload["ema"] is None or set(payload["ema"]) != {k for k, v in ema.items() if isinstance(v, torch.Tensor)}:
            raise_error("restore_checkpoint: '{}' holds no EMA of the parameters given", path)
        _copy_into(ema, payload["ema"])
    return like


def latest_checkpoint(root: str | os.PathLike) -> str | None:
    """The newest ``step_{n}`` subdirectory of ``root`` (the layout
    ``save_checkpoint(root / f"step_{n}")`` makes), or None."""
    root = os.path.abspath(os.fspath(root))
    if not os.path.isdir(root):
        return None
    best, best_n = None, -1
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and int(m.group(1)) > best_n:
            best, best_n = os.path.join(root, name), int(m.group(1))
    return best
