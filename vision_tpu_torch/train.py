"""Training / fine-tuning with checkpoint/resume — a port of
vision_tpu/train.py for one device. The training meshes
(``create_train_state(mesh, fsdp)``, ``make_train_step(mesh)``,
``prefetch_to_device(mesh)``) wait for their queue item; parallel/ serves
over meshes, and its ``training_step`` is the JAX package's SGD check.

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
  * Checkpoints are ``torch.save`` files (the step, the trainable and float
    parameters, ``optimizer.state_dict()`` and the EMA) in ``step_{n}/``,
    written to a temporary name, fsynced and renamed; orbax files are not
    read. A restore is bit-exact.
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

__all__ = [
    "TrainState",
    "adam",
    "create_train_state",
    "data_loader",
    "ema_update",
    "export_gguf",
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
    those leaves, in the order of ``names``; ``step`` counts updates."""

    step: int
    params: dict
    optimizer: torch.optim.Optimizer
    names: tuple[str, ...]


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


def create_train_state(params: Mapping[str, Any], optimizer: Callable, trainable=None) -> TrainState:
    """Take ``params`` (tensors, numpy arrays or residents) over and build
    ``optimizer`` (a factory such as :func:`adam`) over the trainable
    subset. The trainable leaves become tensors that require grad and share
    their storage with the ones given: the optimizer updates them in place,
    as the JAX step donates its state, so copy first to keep the originals.
    """
    pred = _trainable_pred(trainable)
    out = {k: _tensor(v) for k, v in params.items()}
    names = tuple(k for k, v in out.items() if pred(k, v))
    if not names:
        raise_error("create_train_state: no trainable parameters selected")
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().requires_grad_(k in names)
    return TrainState(0, out, optimizer([out[k] for k in names]), names)


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


def make_train_step(loss_fn: Callable, accum: int = 1, trainable=None) -> Callable:
    """Build ``step(state, batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> scalar`` sees the full param dict, frozen
    leaves included; gradients go to the state's trainable leaves only
    (``trainable``, when given, must select exactly those). With ``accum >
    1`` every batch leaf carries a leading microbatch axis of that size: the
    step runs the microbatches in turn, sums their gradients in f32 and
    applies one update of the mean. A leaf the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it. Metrics: ``{"loss": the mean
    loss over the batch}`` (a 0-d f32 tensor on the loss's device)."""
    if accum < 1:
        raise_error("make_train_step: accum must be >= 1, got {}", accum)
    pred = _trainable_pred(trainable) if trainable is not None else None

    def grads_of(params, train, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, train, allow_unused=True)
        return loss.detach().float(), [torch.zeros_like(p) if g is None else g for p, g in zip(train, grads)]

    def step(state: TrainState, batch):
        if pred is not None and tuple(k for k, v in state.params.items() if pred(k, v)) != state.names:
            raise_error("make_train_step: trainable selects other leaves than the state's optimizer holds")
        train = [state.params[k] for k in state.names]
        if accum == 1:
            loss, grads = grads_of(state.params, train, batch)
        else:
            for leaf in _leaves(batch):
                if leaf.shape[0] != accum:
                    raise_error(
                        "make_train_step(accum={}): every batch leaf needs leading axis {} (microbatch count), "
                        "got shape {}", accum, accum, tuple(leaf.shape),
                    )
            loss = 0.0
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in train]
            for i in range(accum):
                loss_i, g = grads_of(state.params, train, _micro(batch, i))
                loss = loss + loss_i
                for a, b in zip(gsum, g):
                    a += b.float()
            loss = loss / accum
            grads = [g / accum for g in gsum]
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


def prefetch_to_device(batches, size: int = 2, device: torch.device | str | None = None):
    """Wrap a host batch iterator so ``size`` batches are on ``device``
    ahead of the consumer: numpy leaves become tensors, copied to a CUDA
    device from pinned memory without blocking, so the copy of batch N+1
    overlaps the step on batch N. ``device`` None keeps them on the host."""
    if size < 1:
        raise_error("prefetch_to_device: size must be >= 1, got {}", size)
    device = torch.device(device) if device is not None else None
    it = iter(batches)
    queue: collections.deque = collections.deque()
    done = False
    while True:
        while not done and len(queue) < size:
            try:
                queue.append(_put(next(it), device))
            except StopIteration:
                done = True
        if not queue:
            return
        yield queue.popleft()


@torch.no_grad()
def ema_update(ema: Mapping[str, Any], params: Mapping[str, Any], decay: float = 0.999) -> dict:
    """One exponential-moving-average step over a param dict: ``ema <- decay
    * ema + (1 - decay) * params`` for float leaves, in the EMA leaf's type
    (non-float leaves track ``params`` as they are). Returns a new dict."""

    def one(e, p):
        if not _is_float(p):
            return p
        d = torch.tensor(decay, dtype=e.dtype, device=e.device)
        return e * d + p.detach() * (1 - d)

    return {k: one(ema[k], p) for k, p in params.items()}


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
    return {k: v.detach() for k, v in params.items() if isinstance(v, torch.Tensor)}


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
    replaces an existing checkpoint at the same path."""
    st, ema = _split_tree(state)
    path = os.path.abspath(os.fspath(directory))
    if os.path.exists(path) and not force:
        raise_error("save_checkpoint: '{}' exists (pass force=True to replace it)", path)
    payload = {
        "step": int(st.step),
        "names": list(st.names),
        "params": _tensors(st.params),
        "residents": sorted(k for k, v in st.params.items() if isinstance(v, QuantResident)),
        "optimizer": st.optimizer.state_dict(),
        "ema": None if ema is None else _tensors(ema),
    }
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
    return path


@torch.no_grad()
def restore_checkpoint(directory: str | os.PathLike, like):
    """Restore a :func:`save_checkpoint` directory into ``like``, a freshly
    built state (or ``(state, ema)`` pair) of the same model and trainable
    set: every saved tensor is copied into ``like``'s (the optimizer keeps
    holding the same leaves), the optimizer loads its state dict, the step
    is set. Bit-exact. Returns ``like``."""
    st, ema = _split_tree(like)
    path = os.path.abspath(os.fspath(directory))
    payload = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu", weights_only=True)
    if tuple(payload["names"]) != st.names:
        raise_error("restore_checkpoint: '{}' trains other leaves than the state given", path)
    saved = payload["params"]
    if set(saved) != set(_tensors(st.params)) or payload["residents"] != sorted(
            k for k, v in st.params.items() if isinstance(v, QuantResident)):
        raise_error("restore_checkpoint: '{}' holds other parameters than the state given", path)
    for k, v in saved.items():
        st.params[k].copy_(v)
    st.optimizer.load_state_dict(payload["optimizer"])
    st.step = int(payload["step"])
    if ema is not None:
        if payload["ema"] is None or set(payload["ema"]) != set(_tensors(ema)):
            raise_error("restore_checkpoint: '{}' holds no EMA of the parameters given", path)
        for k, v in payload["ema"].items():
            ema[k].copy_(v)
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
