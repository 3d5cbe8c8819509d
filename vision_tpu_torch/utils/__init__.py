"""Utilities of the port: the evaluation metrics (metrics.py)."""

from .metrics import (
    average_precision,
    box_iou_matrix,
    depth_metrics,
    detection_map,
    mask_iou,
    mean_iou,
    psnr,
    ssim,
)

__all__ = [
    "average_precision",
    "box_iou_matrix",
    "depth_metrics",
    "detection_map",
    "mask_iou",
    "mean_iou",
    "psnr",
    "ssim",
]
