from . import depth_anything, dino

__all__ = ["depth_anything", "dino"]
