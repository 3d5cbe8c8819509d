"""Backend device policy — the port's counterpart of vision_tpu/core/device.py.

Reference (src/visp/ml.cpp:16-201, include/visp/ml.h:30-80) enumerates ggml
backends, picks the "best", and exposes per-backend policy: preferred float
type, max allocation size, and build flags that alter graph construction.

Here:
  * devices are ``torch.device``s; the default is the CUDA device, and
    the CPU is taken only when asked for by name (see backend_init).
  * preferred float type is **bfloat16** on CUDA (tensor-core native), float32
    on CPU.
  * ``max_alloc`` is a quarter of the card's memory as
    ``torch.cuda.mem_get_info`` reports it (the JAX package takes a quarter of
    the TPU's ``bytes_limit``).
  * ``BuildFlag.flash_attention`` is on by default for CUDA, where it routes
    the large mask-free attentions to the hand-written kernel
    (ops/cuda/flash_attention.py); ``VISP_FLASH_ATTENTION`` overrides it as in
    the reference (ml.cpp:167-175).
  * ``BuildFlag.deform_shift`` (``VISP_DEFORM_SHIFT``) selects BiRefNet's
    bounded-offset deformable conv. It is off by default everywhere: the JAX
    package turns it on for the TPU only, to dodge slow row gathers, while the
    card's sampler evaluates four bilinear corners either way, so the exact
    form costs the same there (and the goldens were made with it).
  * ``BuildFlag.keep_quantized`` (``VISP_KEEP_QUANT``) keeps a GGUF's
    block-quantized tensors as int8 levels and scales on the device, each
    dequantized at its use (core/quant.py); the loaders of Depth-Anything,
    MobileSAM, BiRefNet, MI-GAN and YOLOv9t read it. Off by default on every
    backend, as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from enum import Flag, auto

import torch

from .errors import raise_error

__all__ = [
    "BackendType",
    "BuildFlag",
    "Device",
    "backend_init",
    "backend_is_available",
]


class BackendType(Flag):
    cpu = auto()
    gpu = auto()


class BuildFlag(Flag):
    """Graph-construction options (reference model_build_flag, ml.h:69-76)."""

    none = 0
    flash_attention = auto()  # route big mask-free attentions to the flash kernel
    deform_shift = auto()  # BiRefNet's deformable convs with offsets clamped to +-2
    keep_quantized = auto()  # quantized weights stay int8-resident (core/quant.py)


_FLAG_ENVS = (
    ("VISP_FLASH_ATTENTION", BuildFlag.flash_attention),
    ("VISP_DEFORM_SHIFT", BuildFlag.deform_shift),
    ("VISP_KEEP_QUANT", BuildFlag.keep_quantized),
)

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

    def with_flags(self, flags: BuildFlag) -> "Device":
        """This device with ``flags`` in place of its own."""
        return replace(self, flags=flags)


def backend_is_available(btype: BackendType) -> bool:
    """Whether a device of ``btype`` exists (reference
    backend_is_available): the CPU always does; the card when
    ``torch.cuda`` finds one. A type of both asks for either."""
    if btype & BackendType.cpu:
        return True
    if btype & BackendType.gpu:
        return torch.cuda.is_available()
    return False


_NAMES = {"cpu": BackendType.cpu, "gpu": BackendType.gpu, "cuda": BackendType.gpu}


def backend_init(btype: BackendType | str | None = None) -> Device:
    """The device of ``btype`` (reference backend_init, ml.cpp:59-95): a
    :class:`BackendType` or one of ``"gpu"``, ``"cuda"``, ``"cpu"``.

    Without ``btype`` it returns the CUDA device, and raises a
    :class:`VispError` when there is none. This differs on purpose from the
    JAX package's "best available" policy, which falls back to the CPU: a
    program written for the card must not run on the CPU unnoticed, so the
    CPU is only ever chosen by name, ``backend_init("cpu")``.
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
        if not torch.cuda.is_available():
            raise_error(
                "backend_init: no CUDA device is available; pass backend_init(\"cpu\") "
                "to run on the CPU"
            )
        btype = BackendType.gpu
    if btype == BackendType.gpu:
        if not torch.cuda.is_available():
            raise_error("no backend device available for type {}", btype)
        dev = torch.device("cuda", torch.cuda.current_device())
        return Device(dev, BackendType.gpu, backend_default_flags(BackendType.gpu))
    if btype == BackendType.cpu:
        return Device(torch.device("cpu"), BackendType.cpu, backend_default_flags(BackendType.cpu))
    raise_error("no backend device available for type {}", btype)
