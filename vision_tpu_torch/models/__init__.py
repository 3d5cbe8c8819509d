from . import depth_anything, dino, mobile_sam

__all__ = ["depth_anything", "dino", "mobile_sam"]
