"""Parameter tree addressing — the port's model_ref (a port of
vision_tpu/core/params.py over torch tensors).

The reference's ``model_ref`` (src/visp/ml.cpp:564-625, include/visp/ml.h:
208-256) is a graph-building handle with a hierarchical name prefix:
``m["sub"]`` chains prefixes so C++ code mirrors PyTorch module trees, and
``weights(name)`` looks up tensors by full dotted name.

Here params live in a flat ``dict[str, torch.Tensor]`` keyed by the *same
dotted GGUF tensor names* as the JAX package (so parity tests feed both
packages one store), and ``Params`` provides the prefix-chaining view.
Quantized-resident tensors (core/quant.QuantResident) dequantize on lookup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Mapping

from .errors import raise_error
from .quant import QuantResident

__all__ = ["Params"]


@dataclass(frozen=True)
class Params:
    """Prefix-chained view over a flat dotted-name parameter dict."""

    store: Mapping[str, Any]
    prefix: str = ""

    def __getitem__(self, sub: str | int) -> "Params":
        sub = str(sub)
        new = f"{self.prefix}.{sub}" if self.prefix else sub
        return Params(self.store, new)

    def find(self, name: str):
        """Lookup; returns None if absent (reference model_ref::find).

        Quantized-resident tensors (core/quant.QuantResident) dequantize
        transparently here — on the card one dequant kernel a lookup, which a
        captured forward records into its graph — so model code sees ordinary
        tensors either way."""
        full = f"{self.prefix}.{name}" if self.prefix else name
        t = self.store.get(full)
        if t is not None and isinstance(t, QuantResident):
            return t.dequant()
        return t

    def weight(self, name: str):
        """Lookup; raises if absent (reference model_ref::weights)."""
        t = self.find(name)
        if t is None:
            raise_error("model weight not found: '{}'", f"{self.prefix}.{name}" if self.prefix else name)
        return t

    def has(self, name: str) -> bool:
        full = f"{self.prefix}.{name}" if self.prefix else name
        return full in self.store

    def keys(self) -> Iterator[str]:
        """Keys under the current prefix (relative names)."""
        p = self.prefix + "." if self.prefix else ""
        for k in self.store:
            if k.startswith(p):
                yield k[len(p):]

    def child_count(self, name: str) -> int:
        """Number of integer-indexed children under prefix.name
        (e.g. counting transformer blocks 'blocks.0', 'blocks.1', ...)."""
        p = f"{self.prefix}.{name}." if self.prefix else f"{name}."
        seen: set[int] = set()
        for k in self.store:
            if k.startswith(p):
                head = k[len(p):].split(".", 1)[0]
                if head.isdigit():
                    seen.add(int(head))
        return (max(seen) + 1) if seen else 0
