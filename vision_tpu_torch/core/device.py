"""Backend device policy — the port's counterpart of vision_tpu/core/device.py.

Reference (src/visp/ml.cpp:16-201, include/visp/ml.h:30-80) enumerates ggml
backends, picks the "best", and exposes per-backend policy: preferred float
type, max allocation size, and build flags that alter graph construction.

Here:
  * devices are ``torch.device``s; "best" = CUDA > CPU.
  * preferred float type is **bfloat16** on CUDA (tensor-core native), float32
    on CPU.
  * ``max_alloc`` is a quarter of the card's memory as
    ``torch.cuda.mem_get_info`` reports it (the JAX package takes a quarter of
    the TPU's ``bytes_limit``).
  * ``BuildFlag.flash_attention`` is on by default for CUDA, where it routes
    the large mask-free attentions to the hand-written kernel
    (ops/cuda/flash_attention.py); ``VISP_FLASH_ATTENTION`` overrides it as in
    the reference (ml.cpp:167-175).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from enum import Flag, auto

import torch

from .errors import raise_error

__all__ = [
    "BackendType",
    "BuildFlag",
    "Device",
    "backend_init",
]


class BackendType(Flag):
    cpu = auto()
    gpu = auto()


class BuildFlag(Flag):
    """Graph-construction options (reference model_build_flag, ml.h:69-76)."""

    none = 0
    flash_attention = auto()  # route big mask-free attentions to the flash kernel


_FLAG_ENVS = (("VISP_FLASH_ATTENTION", BuildFlag.flash_attention),)

_FALSY_ENV = ("", "0", "off", "false", "no")


def _env_truthy(v: str) -> bool:
    # case-insensitive: 'OFF'/'False'/'no' must disable, not force-enable
    return v.strip().lower() not in _FALSY_ENV


def _flag_env(flags: BuildFlag) -> BuildFlag:
    """Apply env overrides, mirroring VISP_FLASH_ATTENTION (ml.cpp:167-175)."""
    for env, flag in _FLAG_ENVS:
        v = os.environ.get(env)
        if v is None:
            continue
        if _env_truthy(v):
            flags |= flag
        else:
            flags &= ~flag
    return flags


def backend_default_flags(btype: BackendType) -> BuildFlag:
    if btype & BackendType.gpu:
        return _flag_env(BuildFlag.flash_attention)
    return _flag_env(BuildFlag.none)


@dataclass(frozen=True)
class Device:
    """Compute device + dtype policy (reference backend_device, ml.h:44-55)."""

    torch_device: torch.device
    type: BackendType
    flags: BuildFlag = BuildFlag.none

    @property
    def preferred_float_type(self) -> torch.dtype:
        # bf16 on the card, f32 on CPU — mirrors the reference's
        # F16-on-GPU / F32-on-CPU policy (ml.cpp:97-109)
        if self.type & BackendType.gpu:
            return torch.bfloat16
        return torch.float32

    @property
    def total_memory(self) -> int:
        if self.torch_device.type == "cuda":
            return int(torch.cuda.mem_get_info(self.torch_device)[1])
        # CPU host: treat as effectively unbounded (64 GiB placeholder)
        return 64 << 30

    @property
    def max_alloc(self) -> int:
        """Largest single allocation we plan for — used by dynamic-resolution
        clamping (reference birefnet.cpp:288-305 uses Vulkan max_alloc)."""
        return self.total_memory // 4


_NAMES = {"cpu": BackendType.cpu, "gpu": BackendType.gpu, "cuda": BackendType.gpu}


def backend_init(btype: BackendType | str | None = None) -> Device:
    """Pick the best available device (reference backend_init, ml.cpp:59-95).

    Order of preference: CUDA > CPU, or the device of ``btype`` when given
    (a :class:`BackendType` or one of ``"gpu"``, ``"cuda"``, ``"cpu"``).
    """
    if isinstance(btype, str):
        if btype.lower() not in _NAMES:
            raise_error(
                "backend_init: unknown backend '{}' (expected one of {})",
                btype,
                "/".join(_NAMES),
            )
        btype = _NAMES[btype.lower()]
    if btype is None:
        btype = BackendType.gpu if torch.cuda.is_available() else BackendType.cpu
    if btype == BackendType.gpu:
        if not torch.cuda.is_available():
            raise_error("no backend device available for type {}", btype)
        dev = torch.device("cuda", torch.cuda.current_device())
        return Device(dev, BackendType.gpu, backend_default_flags(BackendType.gpu))
    if btype == BackendType.cpu:
        return Device(torch.device("cpu"), BackendType.cpu, backend_default_flags(BackendType.cpu))
    raise_error("no backend device available for type {}", btype)
