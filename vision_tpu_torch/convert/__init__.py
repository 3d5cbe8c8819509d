"""Torch checkpoints to GGUF (the port of vision_tpu/convert)."""

from .convert import convert_model

__all__ = ["convert_model"]
