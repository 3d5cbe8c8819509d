"""High-level model API — the port of vision_tpu/api.py:19-141:
``model_detect_family`` maps a GGUF's ``general.architecture`` string to its
family (reference src/visp/vision.cpp:7-21) and ``load_model`` dispatches
to the family's ``*_load_model`` (``family_loader``). LoRA adapters (``merge_adapter``) wait
for the training slice."""

from __future__ import annotations

from enum import Enum

from .core.device import Device, backend_init
from .core.errors import raise_error
from .core.gguf import GGUFFile, model_load

__all__ = ["ModelFamily", "model_detect_family", "load_model"]


class ModelFamily(Enum):
    sam = "sam"
    birefnet = "birefnet"
    depth_anything = "depth_anything"
    migan = "migan"
    esrgan = "esrgan"
    yolov9t = "yolov9t"
    sam3 = "sam3"


_ARCH_TO_FAMILY = {
    "mobile-sam": ModelFamily.sam,
    "sam": ModelFamily.sam,
    "birefnet": ModelFamily.birefnet,
    "depthanything": ModelFamily.depth_anything,
    "depth-anything": ModelFamily.depth_anything,
    "migan": ModelFamily.migan,
    "esrgan": ModelFamily.esrgan,
    "yolov9t": ModelFamily.yolov9t,
    "sam3": ModelFamily.sam3,
}


def model_detect_family(file: GGUFFile | str) -> ModelFamily:
    """(reference model_detect_family, vision.cpp:7-21)."""
    if not isinstance(file, GGUFFile):
        file = model_load(file)
    fam = _ARCH_TO_FAMILY.get(file.arch)
    if fam is None:
        raise_error("Unknown model architecture: '{}' ({})", file.arch, file.path)
    return fam


def family_loader(family: ModelFamily):
    """The family's ``*_load_model(file, device)``: load_model's dispatch,
    which a caller that already knows the family (a CLI model verb) calls
    directly."""
    if family == ModelFamily.sam:
        from .models.mobile_sam import sam_load_model as load
    elif family == ModelFamily.birefnet:
        from .models.birefnet import birefnet_load_model as load
    elif family == ModelFamily.depth_anything:
        from .models.depth_anything import depthany_load_model as load
    elif family == ModelFamily.migan:
        from .models.migan import migan_load_model as load
    elif family == ModelFamily.esrgan:
        from .models.esrgan import esrgan_load_model as load
    elif family == ModelFamily.yolov9t:
        from .models.yolov9t import yolov9t_load_model as load
    else:
        from .models.sam3 import sam3_load_model as load
    return load


def load_model(filepath: str | GGUFFile, device: Device | None = None):
    """Generic loader: detect the family and dispatch to the arch loader,
    on ``device`` (default: the CUDA device; without one, backend_init
    raises). The GGUF header is parsed once: the open file flows through to
    the family loader (model_load passes a GGUFFile straight through)."""
    device = device or backend_init()
    file = model_load(filepath)
    return family_loader(model_detect_family(file))(file, device)
