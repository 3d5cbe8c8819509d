"""vision_tpu_torch — the PyTorch/CUDA port of vision_tpu.

A second package beside the JAX one, for one NVIDIA H100: the same GGUF
files, the same NHWC activations and torch-canonical weights, the same
public functions; plain tensor code in PyTorch, and each Pallas kernel of
the JAX package as a kernel written by hand for Hopper (``csrc/``).

It imports ``torch`` and numpy, never ``jax`` or ``vision_tpu``. The port
goes slice by slice; all seven model families are ported and served:
Depth-Anything V2, BiRefNet and MI-GAN (``(image, mask)`` requests) through
:class:`~vision_tpu_torch.serve.ImageServer`, MobileSAM through
:class:`~vision_tpu_torch.serve.SamServer`, Real-ESRGAN through
:class:`~vision_tpu_torch.serve.EsrganServer`, SAM3's image encoder through
:class:`~vision_tpu_torch.serve.Sam3Server` and YOLOv9t through
:class:`~vision_tpu_torch.serve.YoloServer`. SAM3's text and vision
encoders also run through :func:`~vision_tpu_torch.models.sam3.sam3_load_model`
and ``Sam3Model.encode_text`` / ``encode_vision``. :func:`load_model` loads
any family's GGUF, and ``python -m vision_tpu_torch.cli`` runs the model
verbs on an image, a directory (``bulk``) or a video (``video``), serves
the families over HTTP (``serve_http``) and scores predictions
(``evaluate``). On the card each model's ``forward_u8`` replays one CUDA graph per
input shape (:class:`~vision_tpu_torch.core.graph.ForwardGraphs`). Training
(``train``, ``lora``, ``finetune``, ``ops.augment``; the ``finetune`` and
``distill`` verbs) runs the hand-written kernels through their autograd
functions. The kernels are ``torch.library`` operators (``vtt::*``,
``ops.cuda.library``): :func:`export_model` writes a model's tensor forwards
as ``torch.export`` bundles that :func:`load_bundle` runs without the model
code, and ``capi`` with ``native/c_api.cpp`` is the model-level C ABI.
"""

__version__ = "0.1.0"

from .core import (
    BackendType,
    BuildFlag,
    Device,
    GGUFFile,
    GGUFWriter,
    GraphCache,
    Params,
    VispError,
    backend_init,
    backend_is_available,
    load_weights,
    model_load,
)
from .api import load_model, model_detect_family
from .core.graph import shape_bucket, snap_to_multiple

__all__ = [
    "BackendType",
    "BuildFlag",
    "Device",
    "GGUFFile",
    "GGUFWriter",
    "GraphCache",
    "Params",
    "VispError",
    "backend_init",
    "backend_is_available",
    "load_model",
    "load_weights",
    "model_detect_family",
    "model_load",
    "shape_bucket",
    "snap_to_multiple",
    "export_model",
    "load_bundle",
]


def export_model(model, dst, **kwargs):
    """Export a model's tensor forwards as a ``torch.export`` bundle
    (weights embedded by default; see vision_tpu_torch.export)."""
    from .export import export_model as _export

    return _export(model, dst, **kwargs)


def load_bundle(src, device=None):
    """Open a bundle written by export_model / export_bundle."""
    from .export import load_bundle as _load

    return _load(src, device)
