"""The port's device layer against the JAX package's: backend_is_available
and Device.with_flags (vision_tpu/core/device.py:125-145), exported from the
package as the JAX package exports them."""

import torch

import vision_tpu_torch
from vision_tpu.core.device import BackendType as JaxBackendType
from vision_tpu.core.device import backend_is_available as jax_backend_is_available
from vision_tpu_torch.core.device import BackendType, BuildFlag, backend_init, backend_is_available
from torch_threads import torch_threads  # noqa: F401


def test_backend_is_available_cpu_always():
    assert backend_is_available(BackendType.cpu) is True
    assert backend_is_available(BackendType.cpu | BackendType.gpu) is True
    assert jax_backend_is_available(JaxBackendType.cpu) is True


def test_backend_is_available_gpu_asks_torch_cuda():
    assert backend_is_available(BackendType.gpu) == torch.cuda.is_available()


def test_device_with_flags_replaces_only_the_flags():
    dev = backend_init("cpu")
    own = dev.flags
    flagged = dev.with_flags(BuildFlag.flash_attention | BuildFlag.deform_shift)
    assert flagged.flags == BuildFlag.flash_attention | BuildFlag.deform_shift
    assert (flagged.torch_device, flagged.type) == (dev.torch_device, dev.type)
    assert flagged.preferred_float_type == torch.float32
    assert dev.flags == own  # a new Device; the original is untouched
    assert flagged.with_flags(BuildFlag.none).flags == BuildFlag.none


def test_package_exports_the_device_names():
    assert vision_tpu_torch.backend_is_available is backend_is_available
    assert "backend_is_available" in vision_tpu_torch.__all__
    assert hasattr(vision_tpu_torch.Device, "with_flags")
