"""vision_tpu_torch — the PyTorch/CUDA port of vision_tpu.

A second package beside the JAX one, for one NVIDIA H100: the same GGUF
files, the same NHWC activations and torch-canonical weights, the same
public functions; plain tensor code in PyTorch, and each Pallas kernel of
the JAX package as a kernel written by hand for Hopper (``csrc/``).

It imports ``torch`` and numpy, never ``jax`` or ``vision_tpu``. The port
goes slice by slice; all seven model families are ported. Six are served:
Depth-Anything V2, BiRefNet and MI-GAN (``(image, mask)`` requests) through
:class:`~vision_tpu_torch.serve.ImageServer`, MobileSAM through
:class:`~vision_tpu_torch.serve.SamServer`, Real-ESRGAN through
:class:`~vision_tpu_torch.serve.EsrganServer` and YOLOv9t through
:class:`~vision_tpu_torch.serve.YoloServer`. SAM3's text and vision
encoders run through :func:`~vision_tpu_torch.models.sam3.sam3_load_model`
and ``Sam3Model.encode_text`` / ``encode_vision``.
"""

__version__ = "0.1.0"

from .core import (
    BackendType,
    BuildFlag,
    Device,
    GGUFFile,
    GGUFWriter,
    Params,
    VispError,
    backend_init,
    backend_is_available,
    load_weights,
    model_load,
)

__all__ = [
    "BackendType",
    "BuildFlag",
    "Device",
    "GGUFFile",
    "GGUFWriter",
    "Params",
    "VispError",
    "backend_init",
    "backend_is_available",
    "load_weights",
    "model_load",
]
