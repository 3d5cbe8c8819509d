"""Data parallelism behind the models' entry points: rank 0 serves, the
other ranks follow — the port's counterpart of the JAX package's sharded
programs (``in_shardings=P("dp")``, vision_tpu/serve.py ``_run_sharded``).

Every rank loads the same models in the same order; a meshed model
registers its entry points (:class:`MeshEntry`) under a model id. Only
rank 0 calls them (its servers, directory and video loops). A call:

  1. rank 0 broadcasts a small header over the world (model id, entry,
     input shapes and types, static flags, scatter or replicate);
  2. each input is scattered over the model's dp axis (a batch that does
     not divide by dp — a single image — is broadcast whole instead) and
     broadcast over tp, so the ranks of a tp group hold the same shard;
  3. every rank of the mesh runs the entry on its shard (its own CUDA
     graph per shard shape, or eagerly where tp > 1);
  4. every rank says over gloo whether its entry raised;
  5. if none did, the tp-rank-0 outputs are gathered over dp to rank 0,
     which waits for the gather at most the process group's timeout.

Ranks 1..N-1 block in :func:`follow` until rank 0 calls
:func:`stop_workers`. An entry that raises (a bad input, a CUDA
out-of-memory on one rank) fails that call alone: every rank skips the
gather, rank 0 raises the error (its own, or one naming how many ranks
failed; they log theirs), and the world serves on. Only when the ranks
may be out of step does the world break: a collective that fails (a rank
died: gloo raises at once, a gather after the timeout), or a tp > 1 entry
that raised on some ranks of the mesh and not on others (its all-reduces
no longer pair up). The runner then refuses every later call with that
error, so a server fails its futures and never hangs them.
"""

from __future__ import annotations

import pickle
import sys
import threading
from typing import Callable

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.errors import VispError, raise_error

__all__ = ["MeshEntry", "mesh_entries", "register_model", "follow", "stop_workers", "is_worker", "world_rank"]

_MODELS: list[dict[str, "MeshEntry"]] = []
_LOCK = threading.Lock()
_BROKEN: list[BaseException] = []
_STOP = ("stop",)


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_worker() -> bool:
    """Whether this process is a following rank (not rank 0)."""
    return world_rank() != 0


def register_model() -> int:
    """A new meshed model's id (models register in the same order on every rank)."""
    _MODELS.append({})
    return len(_MODELS) - 1


def _send_header(obj) -> None:
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    size = torch.tensor([data.numel()], dtype=torch.int64)
    dist.broadcast(size, src=0)
    dist.broadcast(data, src=0)


def _recv_header():
    size = torch.zeros(1, dtype=torch.int64)
    dist.broadcast(size, src=0)
    data = torch.empty(int(size), dtype=torch.uint8)
    dist.broadcast(data, src=0)
    return pickle.loads(data.numpy().tobytes())


class MeshEntry:
    """One entry point of a meshed model: ``fn(*tensors, **static)`` run on
    every rank of ``mesh`` over its shard of the tensors (their leading
    axis), the outputs (a tensor or a pytree of tensors) gathered to rank 0.
    Called on rank 0 only; the other ranks run ``fn`` from :func:`follow`."""

    def __init__(self, model_id: int, name: str, fn: Callable, mesh, device: torch.device):
        from .sharding import mesh_shape

        shape = mesh_shape(mesh)
        if shape["pp"] > 1 or shape["sp"] > 1:
            raise_error("serving meshes take dp and tp axes only, got {}", shape)
        self.model_id, self.name, self.fn, self.mesh, self.device = model_id, name, fn, mesh, device
        self.dp, self.tp = shape["dp"], shape["tp"]
        self.in_mesh = mesh.get_coordinate() is not None
        if self.in_mesh:
            self.dp_group, self.tp_group = mesh.get_group("dp"), mesh.get_group("tp")
            self.dp_root = dist.get_global_rank(self.dp_group, 0)
            self.tp_root = dist.get_global_rank(self.tp_group, 0)
            self.tp_index = mesh.get_local_rank("tp")
        _MODELS[model_id][name] = self

    def __call__(self, *tensors: torch.Tensor, **static):
        if is_worker():
            raise_error("{}: only rank 0 calls a meshed model; the other ranks follow()", self.name)
        with _LOCK:
            if _BROKEN:
                raise_error("mesh: a rank failed earlier ({}); restart the world", _BROKEN[0])
            xs = [t.to(self.device) for t in tensors]
            scatter = self.dp > 1 and all(t.shape[0] % self.dp == 0 for t in xs)
            header = (self.model_id, self.name, [(tuple(t.shape), t.dtype) for t in xs], static, scatter)
            try:
                _send_header(header)
                out, err = self._run(xs, static, scatter)
            except BaseException as e:
                _BROKEN.append(e)
                raise
            if err is not None:
                raise err
            return out

    def _run(self, xs: list, static: dict, scatter: bool):
        """Distribute ``xs`` (full tensors on rank 0, receive buffers of
        the full shape elsewhere), run, collect: ``(output, None)`` on rank
        0, ``(None, None)`` elsewhere, or ``(None, error)`` where the entry
        raised on some rank and the ranks are still in step. Raises where
        they are not (the caller then breaks the world)."""
        out = err = None
        if self.in_mesh:
            local = [self._distribute(t, scatter) for t in xs]
            try:
                out = self.fn(*local, **static)
            except Exception as e:  # noqa: BLE001 — counted over the world below
                err = e
                if is_worker():
                    print(f"mesh rank {world_rank()}: {self.name} raised {type(e).__name__}: {e}", file=sys.stderr,
                          flush=True)
        failed = torch.tensor([err is not None], dtype=torch.int64)
        dist.all_reduce(failed)  # a CPU tensor: over gloo, at once if a rank is gone
        failed = int(failed)
        if not failed:
            return (self._collect(out, scatter) if self.in_mesh else None), None
        if self.tp > 1 and failed < self.dp * self.tp:
            raise VispError(f"mesh: {self.name} raised on {failed} of {self.dp * self.tp} ranks of a tensor-parallel "
                            f"mesh; their all-reduces no longer pair up")
        if err is None and not is_worker():
            err = VispError(f"mesh: {self.name} raised on {failed} rank(s); their logs say why")
        return None, err

    def _distribute(self, t: torch.Tensor, scatter: bool) -> torch.Tensor:
        if scatter:
            shard = torch.empty((t.shape[0] // self.dp, *t.shape[1:]), dtype=t.dtype, device=self.device)
            if self.tp_index == 0:
                parts = list(t.contiguous().chunk(self.dp)) if world_rank() == self.dp_root else None
                dist.scatter(shard, parts, src=self.dp_root, group=self.dp_group)
        else:
            shard = t
            if self.tp_index == 0:
                dist.broadcast(shard, src=self.dp_root, group=self.dp_group)
        if self.tp > 1:
            dist.broadcast(shard, src=self.tp_root, group=self.tp_group)
        return shard

    def _collect(self, out, scatter: bool):
        if not scatter or self.tp_index != 0:
            return out
        from .sharding import _timeout

        leaves, spec = tree_flatten(out)
        root = world_rank() == self.dp_root
        gathered, works = [], []
        for leaf in leaves:
            leaf = leaf.contiguous()
            parts = [torch.empty_like(leaf) for _ in range(self.dp)] if root else None
            works.append(dist.gather(leaf, parts, dst=self.dp_root, group=self.dp_group, async_op=True))
            gathered.append(parts)
        if not root:
            return None
        for work in works:  # a rank lost after the tally: raise after the timeout, never hang
            work.wait(timeout=_timeout())
        return tree_unflatten([torch.cat(parts, 0) for parts in gathered], spec)


def mesh_entries(model, mesh, **fns: Callable) -> dict[str, Callable]:
    """A model's entry points: ``fns`` (name -> local function) as they are
    without a mesh, else each as a :class:`MeshEntry` of one new model id on
    the model's device."""
    if mesh is None:
        return fns
    model_id = register_model()
    return {name: MeshEntry(model_id, name, fn, mesh, model.device.torch_device) for name, fn in fns.items()}


def follow() -> None:
    """A following rank's loop: run rank 0's calls on this rank's shard
    until rank 0 calls :func:`stop_workers`."""
    while True:
        header = _recv_header()
        if header == _STOP:
            return
        model_id, name, specs, static, scatter = header
        entry = _MODELS[model_id][name]
        # a scatter needs only the shapes here; a broadcast fills whole buffers
        dev = "meta" if scatter else entry.device
        # an entry that raised here fails rank 0's call; a collective that fails ends the loop
        entry._run([torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in specs], static, scatter)


def stop_workers() -> None:
    """Rank 0: release the following ranks from :func:`follow` (no-op alone
    or after a rank failed)."""
    if not dist.is_initialized() or dist.get_world_size() == 1 or is_worker():
        return
    with _LOCK:
        if not _BROKEN:
            _send_header(_STOP)
