"""LoRA fine-tuning — low-rank adapters over the port's linear layers (a
port of vision_tpu/lora.py).

For a linear weight ``W (O, I)`` learn ``ΔW = B @ A`` (``A (r, I)``, ``B (O,
r)``) with ``W`` frozen. The adapters live in the flat dotted-name parameter
dict as ``{module}.lora_a`` / ``{module}.lora_b`` next to
``{module}.weight``, and ``ops.nn.linear`` (and ``ops.nn.conv_2d`` for 1x1
kernels) applies them when present, so no model changes:

  * ``create_train_state(params, adam(lr), trainable=LORA_TRAINABLE)``
    trains exactly the adapters;
  * ``merge_lora`` folds ``W + B @ A`` back in for serving;
    ``train.export_gguf`` then writes a deployable file;
  * ``save_lora`` / ``load_lora`` carry the adapters alone as a small GGUF.

The ``alpha / rank`` scale is folded into ``lora_a`` at initialization
(``B`` starts at zero, so the fold is exact): apply and merge are plainly
``B @ A``. ``A`` is drawn from numpy's generator as in the JAX package, so
one seed gives both packages the same adapters.

QLoRA: a block-quantized resident base (core/quant.QuantResident) takes
adapters without densifying: its shape comes from its metadata (the JAX
package's ``load_lora`` dequantizes the base to read it, a fault not
copied here), it stays int8-resident and frozen (``train._is_float`` never
selects it), and only the f32 adapters train. ``merge_lora`` densifies on
merge.

Adapters are f32 torch tensors on the base weight's device (the CPU for a
numpy or numpy-backed base).
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch

from .core.errors import raise_error
from .core.quant import QuantResident, _is_float

__all__ = [
    "LORA_TRAINABLE",
    "add_lora",
    "lora_modules",
    "merge_lora",
    "strip_lora",
    "save_lora",
    "load_lora",
]

# ``trainable=`` predicate for create_train_state: exactly the adapter leaves
LORA_TRAINABLE = r"\.lora_[ab]$"

_A, _B = ".lora_a", ".lora_b"


def _store(params) -> Mapping[str, Any]:
    # accept either the flat dict or a core.params.Params view over it
    from .core.params import Params

    if isinstance(params, Params):
        if params.prefix:
            raise_error("lora: pass the root param dict, not a sub-tree view")
        return params.store
    return params


def _device(v) -> torch.device:
    """Where an adapter of base weight ``v`` lives."""
    if isinstance(v, QuantResident):
        v = v.q
    return v.device if isinstance(v, torch.Tensor) else torch.device("cpu")


def _dense(v) -> torch.Tensor:
    if isinstance(v, QuantResident):
        return v.dequant()
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))


def lora_modules(params: Mapping[str, Any]) -> list[str]:
    """Module names (dotted prefixes) that carry a LoRA adapter pair."""
    params = _store(params)
    return sorted(k[: -len(_A)] for k in params if k.endswith(_A))


def add_lora(params: Mapping[str, Any], rank: int = 8, alpha: float | None = None, targets: str | None = None,
             seed: int = 0) -> dict:
    """Return a new param dict with LoRA adapters attached.

    Every 2-D float ``{module}.weight`` (linear) and every ``(O, I, 1, 1)``
    float weight with I > 1 (1x1 conv) whose dotted module name matches the
    ``targets`` regex (None: all) gains ``{module}.lora_a`` (``(rank, I)``,
    Gaussian ``N(0, 1/rank)`` times ``alpha / rank``) and ``{module}.lora_b``
    (``(O, rank)``, zeros), so the forward is unchanged until training moves
    ``lora_b``. ``alpha`` defaults to ``rank``. Raises if an explicit target
    cannot take an adapter, or if nothing matched."""
    params = _store(params)
    if rank < 1:
        raise_error("add_lora: rank must be >= 1, got {}", rank)
    scale = (alpha if alpha is not None else float(rank)) / float(rank)
    pat = re.compile(targets) if targets is not None else None
    rng = np.random.default_rng(seed)
    out = dict(params)
    n = 0
    for key, v in params.items():
        if not key.endswith(".weight"):
            continue
        mod = key[: -len(".weight")]
        if pat is not None and not pat.search(mod):
            continue
        if mod + _A in params:  # already adapted
            continue
        # a resident base's shape is its metadata: nothing is dequantized
        shape = tuple(v.shape)
        floaty = isinstance(v, QuantResident) or _is_float(v)
        is_linear = len(shape) == 2
        is_conv1x1 = len(shape) == 4 and shape[2] == 1 and shape[3] == 1 and shape[1] > 1
        if not (is_linear or is_conv1x1) or not floaty:
            if pat is not None:
                raise_error(
                    "add_lora: target '{}' has shape {} — LoRA applies to 2-D linear weights (O, I) and 1x1 "
                    "conv weights (O, I, 1, 1) only", key, shape,
                )
            continue
        o, i = int(shape[0]), int(shape[1])
        a = (rng.normal(size=(rank, i)) * (scale / np.sqrt(rank))).astype(np.float32)
        dev = _device(v)
        out[mod + _A] = torch.from_numpy(a).to(dev)
        out[mod + _B] = torch.zeros((o, rank), dtype=torch.float32, device=dev)
        n += 1
    if n == 0:
        raise_error("add_lora: no 2-D float '.weight' tensors matched targets={!r}", targets)
    return out


@torch.no_grad()
def merge_lora(params: Mapping[str, Any]) -> dict:
    """Fold every adapter into its base weight and drop the adapter leaves:
    ``W <- W + B @ A`` in f32, cast back to the base's type (a resident base
    densifies to its dequant type). The result is adapter-free."""
    params = _store(params)
    out = dict(params)
    for mod in lora_modules(params):
        wkey = mod + ".weight"
        if wkey not in params:
            raise_error("merge_lora: adapter '{}' has no base weight '{}'", mod, wkey)
        w = _dense(params[wkey])
        delta = torch.matmul(params[mod + _B].float().to(w.device), params[mod + _A].float().to(w.device))
        if w.ndim == 4:  # 1x1 conv base (O, I, 1, 1)
            delta = delta[:, :, None, None]
        out[wkey] = (w.float() + delta).to(w.dtype)
        del out[mod + _A], out[mod + _B]
    return out


def strip_lora(params: Mapping[str, Any]) -> dict:
    """Remove adapter leaves without merging (back to the pristine base)."""
    params = _store(params)
    return {k: v for k, v in params.items() if not (k.endswith(_A) or k.endswith(_B))}


def save_lora(params: Mapping[str, Any], dst, arch: str = "lora") -> str:
    """Write only the adapter tensors to ``dst`` as a GGUF adapter file
    (``adapter.type = "lora"`` and the architecture name), in f32; it loads
    back with ``load_lora``."""
    params = _store(params)
    from .core.gguf import GGUFWriter

    mods = lora_modules(params)
    if not mods:
        raise_error("save_lora: no LoRA adapters in params")
    w = GGUFWriter(os.fspath(dst), arch)
    w.add("adapter.type", "lora")
    for mod in mods:
        for suffix in (_A, _B):
            v = params[mod + suffix]
            if isinstance(v, torch.Tensor):
                v = v.detach().float().cpu().numpy()
            w.add_tensor(mod + suffix, np.asarray(v, np.float32))
    w.write()
    return os.fspath(dst)


def load_lora(params: Mapping[str, Any], src) -> dict:
    """Attach adapters from a ``save_lora`` file to a base param dict.

    Checks that every adapter's base weight exists and that the shapes
    agree, reading a resident base's shape from its metadata. Returns a new
    dict (the adapters on their base weights' devices); ``merge_lora`` it
    for serving, or keep it unmerged to fine-tune further."""
    params = _store(params)
    from .core.gguf import GGUFFile

    f = src if isinstance(src, GGUFFile) else GGUFFile(src)
    if f.metadata.get("adapter.type") != "lora":
        raise_error("load_lora: '{}' is not a LoRA adapter file", getattr(f, "path", src))
    out = dict(params)
    seen = set()
    for name in f.tensors:
        if not (name.endswith(_A) or name.endswith(_B)):
            raise_error("load_lora: unexpected tensor '{}' in adapter file", name)
        mod = name[: -len(_A)]
        wkey = mod + ".weight"
        if wkey not in params:
            raise_error("load_lora: adapter '{}' has no base weight '{}'", mod, wkey)
        t = np.asarray(f.tensor(name, np.float32))
        base = tuple(params[wkey].shape)
        want = t.shape[1] if name.endswith(_A) else t.shape[0]
        got = base[1] if name.endswith(_A) else base[0]
        if want != got:
            raise_error("load_lora: '{}' shape {} does not match base weight {} of '{}'", name, t.shape, base, wkey)
        out[name] = torch.from_numpy(np.array(t, np.float32)).to(_device(params[wkey]))
        seen.add(mod)
    for mod in seen:
        if mod + _A not in out or mod + _B not in out:
            raise_error("load_lora: adapter pair for '{}' is incomplete", mod)
    return out
