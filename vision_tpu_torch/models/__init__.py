from . import birefnet, depth_anything, dino, esrgan, mobile_sam, sam3, swin

__all__ = ["birefnet", "depth_anything", "dino", "esrgan", "mobile_sam", "sam3", "swin"]
