from . import birefnet, depth_anything, dino, esrgan, migan, mobile_sam, sam3, swin, yolov9t

__all__ = ["birefnet", "depth_anything", "dino", "esrgan", "migan", "mobile_sam", "sam3", "swin", "yolov9t"]
