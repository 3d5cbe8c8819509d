from . import birefnet, depth_anything, dino, esrgan, mobile_sam, swin

__all__ = ["birefnet", "depth_anything", "dino", "esrgan", "mobile_sam", "swin"]
