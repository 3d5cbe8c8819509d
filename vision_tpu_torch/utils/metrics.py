"""Evaluation metrics, the port of vision_tpu/utils/metrics.py: host scoring
for the CLI's ``compare`` and ``eval`` (evaluate.py).

  * restoration (ESRGAN / MI-GAN): ``psnr``, ``ssim`` (f32 with PyTorch on
    the CPU)
  * segmentation masks (MobileSAM / BiRefNet): ``mask_iou``, ``mean_iou``
  * depth (Depth-Anything): ``depth_metrics`` (AbsRel / RMSE / delta<1.25)
  * detection (YOLOv9t): ``box_iou_matrix``, ``average_precision``,
    ``detection_map`` (COCO-style 101-point AP, greedy matching)

The JAX package computes the mask and depth metrics with ``jnp``; here they
are numpy, elementwise in f32 as there, with the sums in f64. The detection
evaluator is the JAX package's numpy, as it is.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "psnr",
    "ssim",
    "mask_iou",
    "mean_iou",
    "depth_metrics",
    "box_iou_matrix",
    "average_precision",
    "detection_map",
]


def psnr(a, b, max_val: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over all elements (inf for equal)."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    mse = torch.mean((a - b) ** 2)
    return float(10.0 * torch.log10(max_val**2 / mse))


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(r**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def ssim(a, b, max_val: float = 1.0, window: int = 11, sigma: float = 1.5) -> float:
    """Mean structural similarity (Wang et al. 2004 standard settings:
    11x11 gaussian window sigma=1.5, K1=0.01, K2=0.03, 'valid' windows).

    Inputs are NHWC (or HWC) float images; channels are treated
    independently and averaged. The separable gaussian runs as two
    depthwise convs, as in the JAX package."""
    a = torch.as_tensor(np.asarray(a, np.float32))
    b = torch.as_tensor(np.asarray(b, np.float32))
    if a.ndim == 3:
        a, b = a[None], b[None]
    if a.ndim != 4:
        raise ValueError(f"ssim expects HWC or NHWC images, got {tuple(a.shape)}")
    c = a.shape[-1]
    k = torch.from_numpy(_gaussian_kernel(window, sigma))
    kh = k.reshape(1, 1, window, 1).repeat(c, 1, 1, 1)
    kw = k.reshape(1, 1, 1, window).repeat(c, 1, 1, 1)

    def blur(x):
        x = x.permute(0, 3, 1, 2)
        x = F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)
        return x.permute(0, 2, 3, 1)

    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a**2
    var_b = blur(b * b) - mu_b**2
    cov = blur(a * b) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(torch.mean(s))


def mask_iou(pred, true, axis=None):
    """IoU of boolean (or thresholdable) masks; ``axis=(-2, -1)`` gives a
    per-item vector over a batch, None one scalar over everything.
    Empty-union pairs count as IoU 1 (both empty = perfect match)."""
    p = np.asarray(pred) > 0.5
    t = np.asarray(true) > 0.5
    inter = np.sum(p & t, axis=axis)
    union = np.sum(p | t, axis=axis)
    return np.where(union == 0, 1.0, inter / np.maximum(union, 1))


def mean_iou(pred_labels, true_labels, n_classes: int) -> float:
    """Mean per-class IoU for integer label maps (semantic segmentation
    convention); classes absent from both prediction and truth are
    excluded from the mean."""
    p = np.asarray(pred_labels).reshape(-1)
    t = np.asarray(true_labels).reshape(-1)
    ious, present = [], []
    for cls in range(n_classes):
        pc, tc = p == cls, t == cls
        union = np.sum(pc | tc)
        ious.append(np.sum(pc & tc) / max(union, 1) if union else 0.0)
        present.append(union > 0)
    return float(np.sum(np.where(present, ious, 0.0)) / max(np.sum(present), 1))


def depth_metrics(pred, true, mask=None) -> Mapping[str, float]:
    """Standard monocular-depth eval set: AbsRel, RMSE, delta1 (< 1.25).
    ``mask`` selects valid ground-truth pixels (true > 0 by default)."""
    p = np.asarray(pred, np.float32).reshape(-1)
    t = np.asarray(true, np.float32).reshape(-1)
    m = (t > 0) if mask is None else np.asarray(mask).reshape(-1).astype(bool)
    n = max(int(np.sum(m)), 1)
    tm = np.where(m, t, np.float32(1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        absrel = np.sum(np.where(m, np.abs(p - t) / tm, 0.0), dtype=np.float64) / n
        rmse = np.sqrt(np.sum(np.where(m, (p - t) ** 2, 0.0), dtype=np.float64) / n)
        ratio = np.where(m, np.maximum(p / tm, t / np.where(p == 0, np.float32(1.0), p)), np.inf)
    delta1 = np.sum(m & (ratio < 1.25)) / n
    return {"absrel": float(absrel), "rmse": float(rmse), "delta1": float(delta1)}


# ---------------------------------------------------------------------------
# Detection (host-side numpy: ragged per-image lists)


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes: (N, 4) x (M, 4) -> (N, M)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def average_precision(tp: np.ndarray, scores: np.ndarray, n_true: int) -> float:
    """COCO 101-point interpolated AP from per-detection true-positive
    flags + confidences (all images of one class pooled)."""
    if n_true == 0 or len(tp) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    tp = np.asarray(tp, np.float64)[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(1.0 - tp)
    recall = cum_tp / n_true
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, grid, side="left")
    interp = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(np.mean(interp))


def _as_pred(p) -> tuple:
    if hasattr(p, "x1"):  # models.yolov9t.Detection
        return (float(p.x1), float(p.y1), float(p.x2), float(p.y2), float(p.confidence), int(p.class_id))
    return tuple(map(float, p[:5])) + (int(p[5]),)


def detection_map(
    predictions: Sequence[Sequence],
    ground_truths: Sequence[Sequence],
    iou_thresholds: Sequence[float] = (0.5,),
) -> Mapping[str, float]:
    """Mean average precision over classes and IoU thresholds.

    ``predictions[i]`` / ``ground_truths[i]``: per-image lists for image i.
    A prediction is ``(x1, y1, x2, y2, confidence, class_id)`` (a
    models.yolov9t.Detection unpacks to exactly this); a ground truth is
    ``(x1, y1, x2, y2, class_id)``. Matching is greedy per image in
    confidence order, one match per ground-truth box (the standard
    VOC/COCO protocol). Returns ``{"map": ..., "ap_per_iou": {thr: ap}}``.
    """
    if len(predictions) != len(ground_truths):
        raise ValueError(f"predictions for {len(predictions)} images vs ground truths for {len(ground_truths)}")
    preds = [[_as_pred(p) for p in img] for img in predictions]
    gts = [[tuple(map(float, g[:4])) + (int(g[4]),) for g in img] for img in ground_truths]
    classes = sorted({p[5] for img in preds for p in img} | {g[4] for img in gts for g in img})
    ap_per_iou = {}
    for thr in iou_thresholds:
        aps = []
        for cls in classes:
            tps, scores = [], []
            n_true = 0
            for img_preds, img_gts in zip(preds, gts):
                g = np.array([g[:4] for g in img_gts if g[4] == cls], np.float64).reshape(-1, 4)
                n_true += len(g)
                p = [q for q in img_preds if q[5] == cls]
                p.sort(key=lambda q: -q[4])
                if not p:
                    continue
                iou = box_iou_matrix(np.array([q[:4] for q in p]), g) if len(g) else np.zeros((len(p), 0))
                taken = np.zeros(len(g), bool)
                for i, q in enumerate(p):
                    scores.append(q[4])
                    # greedy: best remaining (untaken) gt above the threshold
                    j, best = -1, 0.0
                    if iou.shape[1]:
                        cand = np.where(~taken, iou[i], -1.0)
                        j = int(np.argmax(cand))
                        best = cand[j]
                    if j >= 0 and best >= thr:
                        taken[j] = True
                        tps.append(1.0)
                    else:
                        tps.append(0.0)
            aps.append(average_precision(np.array(tps), np.array(scores), n_true))
        ap_per_iou[float(thr)] = float(np.mean(aps)) if aps else 0.0
    return {"map": float(np.mean(list(ap_per_iou.values()))), "ap_per_iou": ap_per_iou}
