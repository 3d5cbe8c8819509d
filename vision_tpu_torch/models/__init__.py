from . import depth_anything, dino, esrgan, mobile_sam

__all__ = ["depth_anything", "dino", "esrgan", "mobile_sam"]
