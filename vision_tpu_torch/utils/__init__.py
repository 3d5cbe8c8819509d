"""Utilities of the port: timing and tracing (profiling.py), golden-tensor
dumps (dump.py), FLOP counting (flops.py) and the evaluation metrics
(metrics.py)."""

from .dump import compare_dumps, dump_captures
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
from .profiling import Timer, trace

__all__ = [
    "Timer",
    "trace",
    "dump_captures",
    "compare_dumps",
    "average_precision",
    "box_iou_matrix",
    "depth_metrics",
    "detection_map",
    "mask_iou",
    "mean_iou",
    "psnr",
    "ssim",
]
