"""High-level model API — the port of vision_tpu/api.py:19-141:
``model_detect_family`` maps a GGUF's ``general.architecture`` string to its
family (reference src/visp/vision.cpp:7-21) and ``load_model`` dispatches
to the family's ``*_load_model`` (``family_loader``), after merging a LoRA
adapter file into the model when asked (``merge_adapter``)."""

from __future__ import annotations

import os
from enum import Enum

from .core.device import Device, backend_init
from .core.errors import raise_error
from .core.gguf import GGUFFile, model_load

__all__ = ["ModelFamily", "merge_adapter", "model_detect_family", "load_model"]


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


def _family_fixup(family: ModelFamily):
    """The family's converter-layout fixup pass (identity where none)."""
    if family == ModelFamily.sam:
        from .models.mobile_sam import fixup_weights
    elif family == ModelFamily.birefnet:
        from .models.birefnet import fixup_weights
    elif family == ModelFamily.depth_anything:
        from .models.depth_anything import fixup_weights
    else:
        return lambda file, params: params
    return fixup_weights


def merge_adapter(filepath, adapter, dst: str | None = None) -> str:
    """Merge a ``save_lora`` adapter file into a base GGUF: the base loads on
    the host in its semantic (post-fixup) form, the low-rank deltas fold in
    (``lora.merge_lora``) and the result is exported as a plain GGUF at
    ``dst`` (a temporary file, removed at exit, when None) that every path
    serves. Returns the merged file's path. CLI: ``--adapter`` on every
    model verb."""
    from .core.weights import load_weights
    from .lora import load_lora, merge_lora
    from .train import export_gguf

    file = model_load(filepath)
    base = _family_fixup(model_detect_family(file))(file, load_weights(file, as_numpy=True))
    merged = merge_lora(load_lora(base, adapter))
    if dst is None:
        import atexit
        import tempfile

        fd, dst = tempfile.mkstemp(suffix="-merged.gguf", prefix="vision_tpu_torch-")
        os.close(fd)
        # the loaders read every tensor at load, so the file only has to
        # outlive the process, not the model
        atexit.register(lambda p=dst: os.path.exists(p) and os.unlink(p))
    return export_gguf(merged, dst, source=file)


def load_model(filepath: str | GGUFFile, device: Device | None = None, adapter: str | None = None):
    """Generic loader: detect the family and dispatch to the arch loader,
    on ``device`` (default: the CUDA device; without one, backend_init
    raises). The GGUF header is parsed once: the open file flows through to
    the family loader (model_load passes a GGUFFile straight through).
    ``adapter`` merges a LoRA adapter file in first (``merge_adapter``)."""
    device = device or backend_init()
    if adapter is not None:
        filepath = merge_adapter(filepath, adapter)
    file = model_load(filepath)
    return family_loader(model_detect_family(file))(file, device)
