"""GGUF -> torch weights with on-the-fly conversion (a port of
vision_tpu/core/weights.py).

Reference: model_weights + model_transfer (src/visp/ml.cpp:283-526). As in the
JAX package:

  * all tensors are returned in **torch-canonical shapes** — conv (O,I,H,W),
    depthwise (C,1,H,W), conv-transpose (I,O,H,W), linear (O,I) — keyed by
    their dotted GGUF names. Files written with ``tensor_data_layout=cwhn``
    are un-permuted back at load so model code sees one layout; the
    ``{arch}.conv2d_weights`` index list, when present, is authoritative.
  * float tensors are cast to the device float policy (bf16 on CUDA);
    integer tensors (index tables) stay as they are.
  * block-quantized tensors expand to floats, or with ``keep_quantized``
    stay int8 levels and per-block scales (core/quant.QuantResident),
    dequantized at each use.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import Device, backend_init
from .errors import raise_error
from .gguf import GGUFFile
from .quant import _CONV_KERNEL_SIZES, QuantResident, is_quant

__all__ = [
    "load_weights",
    "cast_float_params",
    "is_conv_2d_name",
    "unpermute_cwhn",
    "params_from_numpy",
]


def _is_float(a: np.ndarray) -> bool:
    # ml_dtypes' bfloat16 (what numpy makes of a jnp bf16 array) is not a
    # numpy floating subtype
    return np.issubdtype(a.dtype, np.floating) or a.dtype.name == "bfloat16"


def cast_float_params(params: dict, dtype: torch.dtype) -> dict:
    """Cast floating-point tensors to the device float policy.

    ``load_weights`` already returns policy-cast tensors, so on the loader path
    this is a no-op; model constructors call it so DIRECT construction
    (random/test weights, always f32) also matches the model's dtype. Integer
    tensors and quantized-resident leaves (core/quant.QuantResident) pass
    through untouched."""
    return {
        k: v.to(dtype) if not is_quant(v) and v.is_floating_point() and v.dtype != dtype else v
        for k, v in params.items()
    }


def params_from_numpy(
    store: Mapping[str, np.ndarray], device: torch.device | str, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """Turn a numpy parameter store (the JAX package's parameters, torch-
    canonical shapes under the same names) into the port's: floats become
    ``dtype`` on ``device`` (a bf16 array goes through f32), integers keep
    their type, and a numpy-backed :class:`QuantResident` moves its integer
    payload there, its dequant retargeted to ``dtype``. Always copies into C order, so
    the result never aliases a read-only mmap and is contiguous whatever the
    source's strides (a kernel takes only contiguous tensors)."""
    out = {}
    for k, v in store.items():
        if is_quant(v):
            out[k] = v.astype(dtype).to(device)
            continue
        a = np.asarray(v)
        if _is_float(a):
            out[k] = torch.from_numpy(np.array(a, np.float32, order="C")).to(device=device, dtype=dtype)
        else:
            out[k] = torch.from_numpy(np.array(a, order="C")).to(device=device)
    return out


def is_conv_2d_name(name: str, shape: tuple[int, ...]) -> bool:
    """Heuristic matching the reference converter's is_conv_2d
    (scripts/convert.py:110-117): 4D, square small kernel, '.weight' name."""
    return (
        len(shape) == 4
        and shape[2] == shape[3]
        and shape[2] in _CONV_KERNEL_SIZES
        and name.endswith("weight")
    )


def unpermute_cwhn(name: str, a: np.ndarray, trusted: bool = False) -> np.ndarray:
    """Invert the converter's conv_2d_to_nhwc permute for 'cwhn' files.

    Stored normal conv: (O,H,W,I) -> torch (O,I,H,W).
    Stored depthwise:   (H,W,1,C) -> torch (C,1,H,W).
    Non-conv 4D tensors pass through unchanged.

    ``trusted``: the file's {arch}.conv2d_weights list names this tensor,
    so it WAS permuted by the converter — the kernel-size heuristic must
    not veto the un-permute; only the depthwise-vs-normal shape
    disambiguation still applies.
    """
    if trusted:
        if a.ndim != 4:
            raise_error("conv2d_weights names non-4D tensor '{}' ({}D)", name, a.ndim)
        s = a.shape
        if s[2] == 1 and s[0] == s[1]:  # depthwise (H,W,1,C)
            return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return np.ascontiguousarray(a.transpose(0, 3, 1, 2))
    if a.ndim != 4 or not name.endswith("weight"):
        return a
    s = a.shape
    # depthwise candidate: (H,W,1,C) with square small H==W
    if s[2] == 1 and s[0] == s[1] and s[0] in _CONV_KERNEL_SIZES:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    # normal candidate: (O,H,W,I) with square small H==W
    if s[1] == s[2] and s[1] in _CONV_KERNEL_SIZES:
        return np.ascontiguousarray(a.transpose(0, 3, 1, 2))
    return a


def load_weights(
    file: GGUFFile,
    device: Device | None = None,
    float_dtype: torch.dtype | None = None,
    as_numpy: bool = False,
    keep_quantized: bool = False,
) -> dict:
    """Read all tensors, normalize layout, cast floats, move to the device.

    Mirrors reference model_transfer (ml.cpp:449-516) in one pass. Without
    ``device`` the tensors go to ``backend_init()``'s device, as the model
    loaders do: the CUDA card, or a ``VispError`` naming
    ``backend_init("cpu")`` when there is none. With ``as_numpy`` the host
    arrays (floats as f32) come back before the transfer, for loaders that
    fix up layouts first; that needs no device. With ``keep_quantized``
    block-quantized tensors of the seven resident formats stay int8 levels +
    per-block scales (core/quant.QuantResident, numpy-backed under
    ``as_numpy``) and dequantize at each use; K-quants still expand."""
    if not as_numpy:
        device = device or backend_init()
        if float_dtype is None:
            float_dtype = device.preferred_float_type
    layout = file.tensor_layout
    # {arch}.conv2d_weights is authoritative WHEN PRESENT (reference
    # ml.cpp:435-445): those tensor indices are the permuted convs
    conv_names = None
    idx_list = file.conv2d_weight_indices()
    if idx_list:
        names_in_order = list(file.tensor_names())
        bad = [i for i in idx_list if not 0 <= i < len(names_in_order)]
        if bad:
            raise_error(
                "conv2d_weights index {} out of range (file has {} tensors)",
                bad[0], len(names_in_order),
            )
        conv_names = {names_in_order[i] for i in idx_list}
    out: dict = {}
    for name in file.tensor_names():
        if keep_quantized and file.is_quantized(name):
            # K-quants have no int8-residency decomposition (gguf.py
            # _RESIDENT_TYPES) -> blocks is None and the tensor expands below
            blocks = file.tensor_quant_blocks(name)
            if blocks is not None:
                q, scale, minv = blocks
                r = QuantResident(q, scale, minv, tuple(file.tensors[name].shape), None,
                                  torch.float32 if float_dtype is None else float_dtype)
                # same authority rule as the dense path below: a present
                # conv2d_weights list overrides the shape heuristic
                if layout == "cwhn" and (conv_names is None or name in conv_names):
                    r = r.unpermute_cwhn(name, trusted=conv_names is not None)
                out[name] = r
                continue
        a = file.tensor(name)
        if layout == "cwhn" and (conv_names is None or name in conv_names):
            a = unpermute_cwhn(name, a, trusted=conv_names is not None)
        if _is_float(a):
            a = a.astype(np.float32, copy=False)
        out[name] = a
    if as_numpy:
        return out
    return params_from_numpy(out, device.torch_device, float_dtype)
