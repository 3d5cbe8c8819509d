"""Dataset evaluation, the port of vision_tpu/evaluate.py: score a
directory of predictions against ground truth with the standard per-task
metrics.

The reference stops at a single-pair RMS compare (image_difference_rms,
``include/visp/image.h`` + tests/test-image.cpp); a production framework
also needs dataset-level quality numbers — the thing a user actually
checks after a conversion, a quantization, or a fine-tune. This module
closes the loop between bulk inference (``bulk.py``) and the
metrics library (``utils/metrics.py``):

  task        families              per-image metrics        aggregate
  ----------  --------------------  -----------------------  ---------
  mask        birefnet, sam         iou, mae, f1             means
  depth       depthany              absrel, rmse, delta1     means
  image       esrgan, migan         rms, psnr, ssim          means
  detection   yolov9t               —                        mAP@0.5,
                                                             mAP@0.5:0.95

Pairing is by filename stem (the ``bulk.pair_masks`` convention): every
prediction ``<stem>.png`` must have a ground-truth file named
``<stem>.*`` in the GT directory. Ground-truth formats:

  * mask / image: any loadable image (PNG/JPEG/...) or a ``.npy`` float
    array in [0, 1].
  * depth: ``.npy`` float array, a 16-bit PNG (loaded at full depth), or
    a u8 image — anything monotone in true depth works when alignment is
    on: relative predictions are scale/shift-aligned to the ground truth
    by least squares before scoring (the affine-invariant protocol the
    Depth-Anything / MiDaS papers evaluate with), because the model
    predicts relative inverse depth, not metric units.
  * detection: the prediction side is a ``detections.json`` written by
    bulk mode (stem -> [{class, confidence, box}]); ground truth is
    either a same-shaped JSON file (confidence ignored) or a directory
    of per-image ``<stem>.txt`` with one ``class x1 y1 x2 y2`` line per
    object (absolute pixels, class id or COCO class name).

All scoring is host work in numpy (utils/metrics.py); nothing here touches
the card. PNG files, 8-bit and 16-bit gray, are read by the port's own codec
(image/png.py); other formats need PIL.
"""

from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from .core.errors import raise_error
from .utils import metrics as M

__all__ = [
    "TASKS",
    "task_for_family",
    "pair_files",
    "evaluate",
    "evaluate_masks",
    "evaluate_depth",
    "evaluate_images",
    "evaluate_detections",
    "format_report",
]

TASKS = ("mask", "depth", "image", "detection")

# model family (api.ModelFamily.value) -> eval task
_FAMILY_TASKS = {
    "birefnet": "mask",
    "sam": "mask",
    "depth_anything": "depth",
    "esrgan": "image",
    "migan": "image",
    "yolov9t": "detection",
}

_ARRAY_EXTS = (".npy",)
_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".gif")


def task_for_family(family: str) -> str:
    if family not in _FAMILY_TASKS:
        raise_error("eval: no evaluation task for model family '{}'", family)
    return _FAMILY_TASKS[family]


# ---------------------------------------------------------------------------
# loading + pairing


def _load_map(path: str | os.PathLike) -> np.ndarray:
    """Load a prediction/GT file as an (H, W, C) float32 array.

    ``.npy`` is taken verbatim (cast to f32); 16-bit gray PNGs keep their
    full depth (scaled to [0, 1]); everything else goes through image_load
    (u8 -> [0, 1]) with only the real channels kept (no lane padding).
    """
    p = Path(path)
    if p.suffix.lower() in _ARRAY_EXTS:
        a = np.load(p).astype(np.float32)
        return a[:, :, None] if a.ndim == 2 else a
    if p.suffix.lower() == ".png":
        from .image.png import PNG_SIGNATURE, PngUnsupported, read_png16

        data = p.read_bytes()
        if data.startswith(PNG_SIGNATURE):
            try:
                # 16-bit depth convention (e.g. NYU/KITTI exports)
                return read_png16(data).astype(np.float32) / 65535.0
            except PngUnsupported:
                pass
    from .image import image_load
    from .image.image import is_float

    img = image_load(path)
    a = img.data.astype(np.float32)
    if not is_float(img.format):
        a = a / 255.0
    return a


def _gray(a: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W): first channel for 1ch, luma mean for color."""
    return a[:, :, 0] if a.shape[2] == 1 else a[:, :, :3].mean(axis=2)


def _resize_to(a: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Bilinear-resize an (H, W) float map to the GT geometry (the
    standard eval protocol: predictions are brought to GT resolution)."""
    if a.shape == hw:
        return a
    from .image.image import _bilinear_resize_f32

    return _bilinear_resize_f32(a[:, :, None], (hw[1], hw[0]))[:, :, 0]


def pair_files(pred_dir: str | os.PathLike, gt_dir: str | os.PathLike,
               exts: Sequence[str] = _IMG_EXTS + _ARRAY_EXTS,
               ) -> list[tuple[str, str, str]]:
    """Match every prediction in ``pred_dir`` to the same-stem file in
    ``gt_dir``. Returns [(stem, pred_path, gt_path)] sorted by stem."""
    pd, gd = Path(pred_dir), Path(gt_dir)
    for d, what in ((pd, "prediction"), (gd, "ground-truth")):
        if not d.is_dir():
            raise_error("eval: {} path '{}' is not a directory", what, d)
    preds = sorted(
        f for f in pd.iterdir()
        if f.is_file() and f.suffix.lower() in exts and f.name != "detections.json"
    )
    if not preds:
        raise_error("eval: no predictions ({}) in '{}'", "/".join(exts), pd)
    gts = {}
    for f in sorted(gd.iterdir()):
        if f.is_file() and f.suffix.lower() in exts:
            gts.setdefault(f.stem, f)  # first (sorted) wins on duplicates
    out = []
    for f in preds:
        if f.stem not in gts:
            raise_error("eval: no ground truth named '{}.*' in '{}'", f.stem, gd)
        out.append((f.stem, str(f), str(gts[f.stem])))
    return out


def _aggregate(per_image: Mapping[str, Mapping[str, float]]) -> dict:
    """Mean of each finite per-image metric (psnr of identical images is
    inf — averaged over the finite ones, with the count reported)."""
    keys = next(iter(per_image.values())).keys()
    mean = {}
    for k in keys:
        vals = [v[k] for v in per_image.values()]
        finite = [v for v in vals if math.isfinite(v)]
        mean[k] = float(np.mean(finite)) if finite else float("inf")
        n_inf = len(vals) - len(finite)
        if n_inf:
            mean[f"{k}_n_inf"] = float(n_inf)
    return mean


# ---------------------------------------------------------------------------
# per-task evaluators


def evaluate_masks(pairs: Sequence[tuple[str, str, str]]) -> dict:
    """Binary-mask quality: IoU + soft-mask MAE + F1 at threshold 0.5."""
    per = {}
    for stem, pred_p, gt_p in pairs:
        g = _gray(_load_map(gt_p))
        p = _resize_to(_gray(_load_map(pred_p)), g.shape)
        pb, gb = p > 0.5, g > 0.5
        inter = float(np.sum(pb & gb))
        iou = float(M.mask_iou(p, g))
        tp_fp, tp_fn = float(pb.sum()), float(gb.sum())
        f1 = 1.0 if tp_fp + tp_fn == 0 else 2.0 * inter / max(tp_fp + tp_fn, 1.0)
        per[stem] = {
            "iou": iou,
            "mae": float(np.mean(np.abs(p - g))),
            "f1": f1,
        }
    return {"task": "mask", "n_images": len(per), "mean": _aggregate(per), "per_image": per}


def _align_scale_shift(p: np.ndarray, g: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Least-squares s*p + t fit to g over valid pixels (MiDaS eq. 1)."""
    pv, gv = p[m], g[m]
    if pv.size == 0:
        return p
    var = float(np.var(pv))
    s = (float(np.mean(pv * gv)) - pv.mean() * gv.mean()) / var if var > 1e-12 else 1.0
    t = float(gv.mean() - s * pv.mean())
    return s * p + t


def evaluate_depth(pairs: Sequence[tuple[str, str, str]], align: bool = True) -> dict:
    """Monocular-depth eval (AbsRel / RMSE / delta1) with optional
    scale/shift alignment of the relative prediction to the GT."""
    per = {}
    for stem, pred_p, gt_p in pairs:
        g = _gray(_load_map(gt_p))
        p = _resize_to(_gray(_load_map(pred_p)), g.shape)
        valid = g > 0
        if align:
            p = _align_scale_shift(p, g, valid)
        d = M.depth_metrics(p, g, mask=valid)
        per[stem] = {k: float(v) for k, v in d.items()}
    return {"task": "depth", "n_images": len(per), "mean": _aggregate(per),
            "aligned": bool(align), "per_image": per}


def evaluate_images(pairs: Sequence[tuple[str, str, str]]) -> dict:
    """Restoration quality: RMS (reference image_difference_rms
    semantics: mean over H*W*4 lanes), PSNR, SSIM on the RGB channels."""
    from .image import image_difference_rms, image_load

    per = {}
    for stem, pred_p, gt_p in pairs:
        g = _load_map(gt_p)
        p = _load_map(pred_p)
        if p.shape[:2] != g.shape[:2]:
            raise_error(
                "eval: image-task prediction '{}' is {}x{} but ground truth is "
                "{}x{} (restoration outputs must match exactly)",
                pred_p, p.shape[1], p.shape[0], g.shape[1], g.shape[0],
            )
        c = min(p.shape[2], g.shape[2], 3)
        pa, ga = p[:, :, :c], g[:, :, :c]
        win = min(11, pa.shape[0], pa.shape[1])
        per[stem] = {
            "rms": image_difference_rms(image_load(pred_p), image_load(gt_p))
            if Path(pred_p).suffix.lower() in _IMG_EXTS
            and Path(gt_p).suffix.lower() in _IMG_EXTS
            else float(np.sqrt(np.mean((pa - ga) ** 2))),
            "psnr": float(M.psnr(pa, ga)),
            "ssim": float(M.ssim(pa, ga, window=win)),
        }
    return {"task": "image", "n_images": len(per), "mean": _aggregate(per), "per_image": per}


def _class_id(name) -> int:
    """COCO class name -> id; numeric strings/ints pass through."""
    if isinstance(name, int):
        return name
    s = str(name)
    if s.lstrip("-").isdigit():
        return int(s)
    from .models.yolov9t import COCO_CLASS_NAMES

    try:
        return COCO_CLASS_NAMES.index(s)
    except ValueError:
        raise_error("eval: unknown detection class '{}'", s)


def _load_detections_json(path: Path, with_conf: bool) -> dict[str, list]:
    """bulk detections.json: stem -> [(x1,y1,x2,y2[,conf],cls)]."""
    try:
        doc = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        raise_error("eval: cannot read detections file '{}': {}", path, e)
    out = {}
    for stem, dets in doc.items():
        rows = []
        for d in dets:
            box = [float(v) for v in d["box"]]
            cls = _class_id(d.get("class", d.get("class_id", 0)))
            if with_conf:
                rows.append(tuple(box) + (float(d.get("confidence", 1.0)), cls))
            else:
                rows.append(tuple(box) + (cls,))
        out[stem] = rows
    return out


def _load_gt_txt_dir(gt_dir: Path) -> dict[str, list]:
    """Per-image ``<stem>.txt``: one ``class x1 y1 x2 y2`` row per object
    (absolute pixels; class id or COCO name). Empty files = no objects."""
    out = {}
    for f in sorted(gt_dir.glob("*.txt")):
        rows = []
        for ln, line in enumerate(f.read_text().splitlines(), 1):
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 5:
                raise_error(
                    "eval: '{}' line {}: expected 'class x1 y1 x2 y2', got {!r}",
                    f, ln, line,
                )
            rows.append(tuple(float(v) for v in parts[1:5]) + (_class_id(parts[0]),))
        out[f.stem] = rows
    if not out:
        raise_error("eval: no ground-truth .txt files in '{}'", gt_dir)
    return out


def evaluate_detections(pred: str | os.PathLike, gt: str | os.PathLike) -> dict:
    """Detection mAP: ``pred`` is a bulk ``detections.json`` (or the
    directory holding one); ``gt`` is a per-image .txt directory or a
    detections-shaped JSON. Scores mAP@0.5 and COCO mAP@[0.5:0.95]."""
    pp = Path(pred)
    if pp.is_dir():
        pp = pp / "detections.json"
    if not pp.is_file():
        raise_error("eval: no detections.json at '{}'", pp)
    preds = _load_detections_json(pp, with_conf=True)

    gp = Path(gt)
    if gp.is_dir():
        gts = _load_gt_txt_dir(gp)
    else:
        gts = _load_detections_json(gp, with_conf=False)

    missing = sorted(set(preds) - set(gts))
    if missing:
        raise_error("eval: no ground truth for image(s): {}", ", ".join(missing[:5]))
    stems = sorted(preds)
    # GT-only stems count as images the model produced zero detections for
    extra = sorted(set(gts) - set(preds))
    stems += extra
    pred_rows = [preds.get(s, []) for s in stems]
    gt_rows = [gts[s] for s in stems]

    coco_thresholds = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))
    r50 = M.detection_map(pred_rows, gt_rows, iou_thresholds=(0.5,))
    rall = M.detection_map(pred_rows, gt_rows, iou_thresholds=coco_thresholds)
    return {
        "task": "detection",
        "n_images": len(stems),
        "n_predictions": sum(len(r) for r in pred_rows),
        "n_ground_truths": sum(len(r) for r in gt_rows),
        "mean": {
            "map50": float(r50["map"]),
            "map50_95": float(rall["map"]),
        },
        "ap_per_iou": {f"{k:.2f}": v for k, v in rall["ap_per_iou"].items()},
    }


# ---------------------------------------------------------------------------
# dispatch + report


def evaluate(task: str, pred: str | os.PathLike, gt: str | os.PathLike,
             align_depth: bool = True) -> dict:
    """Score predictions against ground truth for one task. ``pred``/
    ``gt`` are directories (detection also accepts JSON file paths)."""
    if task not in TASKS:
        raise_error("eval: unknown task '{}' (expected one of {})", task, "/".join(TASKS))
    if task == "detection":
        return evaluate_detections(pred, gt)
    pairs = pair_files(pred, gt)
    if task == "mask":
        return evaluate_masks(pairs)
    if task == "depth":
        return evaluate_depth(pairs, align=align_depth)
    return evaluate_images(pairs)


def format_report(result: Mapping) -> str:
    """Human-readable summary table of an ``evaluate`` result."""
    lines = [f"task {result['task']}  images {result['n_images']}"]
    if result["task"] == "detection":
        lines[0] += (f"  predictions {result['n_predictions']}"
                     f"  ground truths {result['n_ground_truths']}")
    for k, v in result["mean"].items():
        if k.endswith("_n_inf"):
            lines.append(f"  {k:<8} {int(v)} image(s) identical (psnr inf)")
        else:
            lines.append(f"  {k:<8} {v:.4f}")
    return "\n".join(lines)
