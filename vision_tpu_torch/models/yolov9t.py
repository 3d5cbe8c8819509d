"""YOLOv9t object detection — a port of vision_tpu/models/yolov9t.py.

Reference: src/visp/arch/yolov9t.cpp and src/cli/inference_yolov9t.cpp: the
22-layer backbone and neck DAG (Conv/SiLU, ELAN1, AConv, RepNCSPELAN4 with
RepConv duality, SPPELAN, Upsample, Concat), the detect head with 2
branches x 3 scales, DFL decode (softmax over reg_max = 16 bins times the
projection), dist2bbox and the sigmoid class scores; letterbox
preprocessing, host NMS with the per-class-offset trick, and scale_boxes to
undo the letterbox. Weight names are the GGUF's (``model.0`` .. ``model.21``,
``detect.cv2`` / ``detect.cv3``), BatchNorms fused to scale and shift.

Every conv that is 3x3 with stride 1 goes through ops/nn.py
``conv_3x3_fused``, so on the card each is a launch of the hand-written conv
kernel (csrc/conv3x3.cu), with its BatchNorm and SiLU in the kernel's
epilogue: a RepConv's 1x1 branch enters as ``r1`` (SiLU of the branches'
sum), a RepBottleneck's shortcut as ``r2``, and the ELAN blocks' (and
RepCSP's) convs write into channel views of the buffer their concatenation
would build. With ``n_csp`` 3 a forward makes 112 such launches: 7
RepNCSPELAN4 x (2 RepCSP x 3 bottlenecks x 2 + 2), ELAN1's 2 and the detect
head's 12. The stride-2 convs (``model.0``, ``model.1``, the five AConvs)
and the 1x1 convs stay ``F.conv2d`` with BatchNorm and SiLU after it, in
x's type, as the JAX package computes them. The kernel's epilogue rounds
once where the JAX package rounds after the conv, the BatchNorm's product
and sum, the branch sum, the SiLU and the shortcut: at f32 the two agree to
the summation order, in bf16 the port is the more precise.

NMS runs on the host, as in the JAX package, but through a vectorised numpy
greedy loop of this module (:func:`non_max_suppression`) with the native
library's arithmetic (``visp_nms``, vision_tpu/native/host_ops.cpp), not a
ctypes library. Int8-resident weights (``keep_quantized``, core/quant.py)
dequantize at each use. With a ``mesh`` (parallel/) the batch splits over
dp.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from ..core.device import BuildFlag, Device, backend_init
from ..core.gguf import GGUFFile, model_load
from ..core.graph import ForwardGraphs, device_cache
from ..core.params import Params
from ..core.weights import cast_float_params, load_weights
from ..parallel.runner import mesh_entries
from ..image import Image, ImageFormat, image_scale, preprocess_scale_method
from ..ops import avg_pool_2d, batch_norm_2d, conv_2d, conv_3x3_fused, max_pool_2d, normalize_u8, resize_nhwc, silu
from ..ops.debug import capture

__all__ = [
    "Yolov9tParams",
    "yolov9t_detect_params",
    "conv_block",
    "rep_conv",
    "rep_bottleneck",
    "rep_csp",
    "rep_ncspelan4",
    "elan1",
    "aconv",
    "sppelan",
    "upsample2",
    "yolov9t_backbone",
    "make_anchors",
    "dfl_decode",
    "dist2bbox",
    "DetectOutput",
    "detect_forward",
    "yolov9t_forward",
    "letterbox",
    "Detection",
    "non_max_suppression",
    "scale_boxes",
    "Yolov9tModel",
    "yolov9t_load_model",
    "get_class_color",
    "draw_detections",
    "COCO_CLASS_NAMES",
]


@dataclass(frozen=True)
class Yolov9tParams:
    num_classes: int = 80
    input_size: int = 640
    reg_max: int = 16
    n_csp: int = 3  # RepCSP bottleneck depth (3 in YOLOv9t)


def yolov9t_detect_params(file: GGUFFile) -> Yolov9tParams:
    """The reference hardcodes 80 classes / 640 px (yolov9t.cpp:43-53); as in
    the JAX package, num_classes and the RepCSP depth are read from the
    tensor shapes, so width-reduced files load through the same path."""
    p = Yolov9tParams()
    cls_w = "detect.cv3.0.2.weight"
    if cls_w in file:
        # shape[0] is the class count in both layouts (torch-canonical and cwhn)
        p = replace(p, num_classes=int(file.tensors[cls_w].shape[0]))
    n = 0
    while f"model.4.cv2.0.m.{n}.cv1.conv1.conv.weight" in file:
        n += 1
    if n:
        p = replace(p, n_csp=n)
    return p


def _autopad(k: int, p: int = -1) -> int:
    return k // 2 if p == -1 else p


def _bn(p: Params) -> Params | None:
    return p["bn"] if p.has("bn.weight") else None


def _width(p: Params) -> int:
    """A Conv's output channels."""
    return p["conv"].weight("weight").shape[0]


def conv_block(p: Params, x: torch.Tensor, k: int, s: int = 1, pad: int = -1, act: bool = True, r2=None, out=None):
    """Conv + (fused) BN + SiLU (reference yolov9t.cpp Conv, :78-146). A 3x3
    stride-1 pad-1 conv runs on the conv kernel with all of it in the
    epilogue, plus ``r2`` after the activation and written into ``out`` (a
    channel view) when given; any other conv is ``F.conv2d``, then the
    BatchNorm and SiLU in x's type."""
    pad = _autopad(k, pad)
    if k == 3 and s == 1 and pad == 1:
        return conv_3x3_fused(p["conv"], x, bn=_bn(p), silu=act, r2=r2, out=out)
    if r2 is not None or out is not None:
        raise ValueError("conv_block: r2 and out are for the 3x3 stride-1 convs only")
    y = conv_2d(p["conv"], x, s, pad)
    if _bn(p) is not None:
        y = batch_norm_2d(p["bn"], y)
    return silu(y) if act else y


def rep_conv(p: Params, x: torch.Tensor, act: bool = True):
    """Two-branch re-parameterizable conv (yolov9t.cpp RepConv, :256-301):
    ``silu(bn(conv3x3(x)) + bn(conv1x1(x)))``. The 1x1 branch runs as the
    JAX package runs it (``F.conv2d``, then BN, in x's type) and enters the
    3x3 conv's epilogue as r1."""
    branch = conv_block(p["conv2"], x, 1, 1, 0, act=False)
    return conv_3x3_fused(p["conv1"]["conv"], x, bn=_bn(p["conv1"]), silu=act, r1=branch)


def rep_bottleneck(p: Params, x: torch.Tensor, shortcut: bool = True, out=None):
    """RepConv, then a 3x3 Conv, plus the input when the widths agree: the
    shortcut is the second conv's r2."""
    y = rep_conv(p["cv1"], x)
    return conv_block(p["cv2"], y, 3, r2=x if shortcut and _width(p["cv2"]) == x.shape[-1] else None, out=out)


def rep_csp(p: Params, x: torch.Tensor, n: int = 1, shortcut: bool = True):
    """(reference yolov9t.cpp RepCSP): the last bottleneck writes into the
    first channels of the buffer that ``cv3`` reads, cv2's output goes after
    them."""
    y1 = conv_block(p["cv1"], x, 1)
    y2 = conv_block(p["cv2"], x, 1)
    c = y1.shape[-1]
    cat = y1.new_empty((*y1.shape[:3], c + y2.shape[-1]))
    m = y1
    for i in range(n):
        m = rep_bottleneck(p["m"][i], m, shortcut, out=cat[..., :c] if i == n - 1 else None)
    cat[..., c:] = y2
    return conv_block(p["cv3"], cat, 1)


def _elan(p: Params, x: torch.Tensor, c4: int, body2, body3) -> torch.Tensor:
    """The ELAN pattern of ELAN1 and RepNCSPELAN4: cv1, its two halves y0 and
    y1, cv2 = body2(y1), cv3 = body3(cv2) (each c4 wide), cv4 over [y0, y1,
    cv2, cv3]. The four parts are channel ranges of one buffer: cv1's output
    is copied in, cv2 and cv3 (3x3 convs) are written there by the conv
    kernel."""
    y = conv_block(p["cv1"], x, 1)
    c3 = y.shape[-1]
    cat = y.new_empty((*y.shape[:3], c3 + 2 * c4))
    cat[..., :c3] = y
    cv2 = body2(y[..., c3 // 2 :], cat[..., c3 : c3 + c4])
    body3(cv2, cat[..., c3 + c4 :])
    return conv_block(p["cv4"], cat, 1)


def rep_ncspelan4(p: Params, x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """(reference yolov9t.cpp RepNCSPELAN4, :406-447)."""
    return _elan(
        p, x, _width(p["cv2"][1]),
        lambda y1, out: conv_block(p["cv2"][1], rep_csp(p["cv2"][0], y1, n), 3, out=out),
        lambda cv2, out: conv_block(p["cv3"][1], rep_csp(p["cv3"][0], cv2, n), 3, out=out),
    )


def elan1(p: Params, x: torch.Tensor) -> torch.Tensor:
    """(reference yolov9t.cpp ELAN1, :187-235)."""
    return _elan(
        p, x, _width(p["cv2"]),
        lambda y1, out: conv_block(p["cv2"], y1, 3, out=out),
        lambda cv2, out: conv_block(p["cv3"], cv2, 3, out=out),
    )


def aconv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """avg-pool 2x2 s1 + conv s2 (reference yolov9t.cpp AConv, :165-185)."""
    return conv_block(p["cv1"], avg_pool_2d(x, 2, stride=1), 3, 2, 1)


def sppelan(p: Params, x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """(reference yolov9t.cpp SPPELAN, :449-483)."""
    cv1 = conv_block(p["cv1"], x, 1)
    m1 = max_pool_2d(cv1, k, 1, k // 2)
    m2 = max_pool_2d(m1, k, 1, k // 2)
    m3 = max_pool_2d(m2, k, 1, k // 2)
    return conv_block(p["cv5"], torch.cat([cv1, m1, m2, m3], -1), 1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    _, h, w, _ = x.shape
    return resize_nhwc(x, (h * 2, w * 2), "nearest")


def yolov9t_backbone(p: Params, x: torch.Tensor, n_csp: int = 3) -> dict[int, torch.Tensor]:
    """22-layer DAG (reference yolov9t_backbone, yolov9t.cpp:507-628).
    Returns every layer's output by index; the detect inputs are 15, 18 and
    21."""
    m = p["model"]
    f = {}
    f[0] = conv_block(m[0], x, 3, 2)
    f[1] = conv_block(m[1], f[0], 3, 2)
    f[2] = elan1(m[2], f[1])
    f[3] = aconv(m[3], f[2])
    f[4] = rep_ncspelan4(m[4], f[3], n_csp)
    f[5] = aconv(m[5], f[4])
    f[6] = rep_ncspelan4(m[6], f[5], n_csp)
    f[7] = aconv(m[7], f[6])
    f[8] = rep_ncspelan4(m[8], f[7], n_csp)
    f[9] = sppelan(m[9], f[8])
    f[10] = upsample2(f[9])
    f[11] = torch.cat([f[10], f[6]], -1)
    f[12] = rep_ncspelan4(m[12], f[11], n_csp)
    f[13] = upsample2(f[12])
    f[14] = torch.cat([f[13], f[4]], -1)
    f[15] = rep_ncspelan4(m[15], f[14], n_csp)
    f[16] = aconv(m[16], f[15])
    f[17] = torch.cat([f[16], f[12]], -1)
    f[18] = rep_ncspelan4(m[18], f[17], n_csp)
    f[19] = aconv(m[19], f[18])
    f[20] = torch.cat([f[19], f[9]], -1)
    f[21] = rep_ncspelan4(m[21], f[20], n_csp)
    for i, v in f.items():
        capture(f"model.{i}", v)
    return f


def make_anchors(shapes, strides=(8.0, 16.0, 32.0), offset: float = 0.5):
    """Anchor grid as numpy constants (reference make_anchors,
    yolov9t.cpp:875-925). shapes: [(h, w), ...] per scale. Returns anchors
    (A, 2) and strides (A, 1), f32."""
    anchors, stride_list = [], []
    for (h, w), s in zip(shapes, strides):
        xs, ys = np.meshgrid(np.arange(w) + offset, np.arange(h) + offset)
        anchors.append(np.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        stride_list.append(np.full(h * w, s, np.float32))
    return (
        np.concatenate(anchors).astype(np.float32),
        np.concatenate(stride_list)[:, None],
    )


@device_cache(maxsize=16)
def _anchor_tensors(shapes: tuple, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """make_anchors as tensors on ``device``, made once per input size."""
    anchors, strides = make_anchors(shapes)
    return torch.from_numpy(anchors).to(device), torch.from_numpy(strides).to(device)


def dfl_decode(box_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """softmax over bins x projection, in f32 (reference dfl_forward,
    yolov9t.cpp:657-691). box_logits: (B, A, 4 * reg_max) -> (B, A, 4)."""
    b, a, _ = box_logits.shape
    x = box_logits.reshape(b, a, 4, reg_max).float()
    proj = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return torch.matmul(torch.softmax(x, dim=-1), proj)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor) -> torch.Tensor:
    """lt/rb distances -> xyxy (reference dist2bbox, yolov9t.cpp:631-655)."""
    lt, rb = distance[..., :2], distance[..., 2:]
    return torch.cat([anchor_points - lt, anchor_points + rb], -1)


class DetectOutput(NamedTuple):
    boxes: torch.Tensor  # (B, A, 4) xyxy in input pixels, f32
    scores: torch.Tensor  # (B, A, nc) sigmoid class probabilities, f32


def detect_forward(p: Params, features, yp: Yolov9tParams) -> DetectOutput:
    """Detect head across 3 scales (reference detect_forward + inference,
    yolov9t.cpp:693-824): each scale's two 3x3 Convs per branch on the conv
    kernel, its last 1x1 conv ``F.conv2d``."""
    det = p["detect"]
    outs, shapes = [], []
    for i, feat in enumerate(features):
        r = conv_block(det["cv2"][i][1], conv_block(det["cv2"][i][0], feat, 3), 3)
        r = conv_2d(det["cv2"][i][2], r, 1, 0)
        c = conv_block(det["cv3"][i][1], conv_block(det["cv3"][i][0], feat, 3), 3)
        c = conv_2d(det["cv3"][i][2], c, 1, 0)
        comb = torch.cat([r, c], -1)  # (B, h, w, 4 * reg_max + nc)
        b, h, w, ch = comb.shape
        outs.append(comb.reshape(b, h * w, ch))
        shapes.append((h, w))
    x_cat = torch.cat(outs, 1)  # (B, A, 4 * reg_max + nc)
    box_logits = x_cat[..., : 4 * yp.reg_max]
    cls_logits = x_cat[..., 4 * yp.reg_max :]
    anchors, strides = _anchor_tensors(tuple(shapes), str(x_cat.device))
    boxes = dist2bbox(dfl_decode(box_logits, yp.reg_max), anchors) * strides
    return DetectOutput(boxes, torch.sigmoid(cls_logits.float()))


def yolov9t_forward(params: Params, x: torch.Tensor, yp: Yolov9tParams = Yolov9tParams(),
                    n_csp: int | None = None) -> DetectOutput:
    """(reference yolov9t_forward, yolov9t.cpp:827-840). x: (B, H, W, 3)."""
    f = yolov9t_backbone(params, x, yp.n_csp if n_csp is None else n_csp)
    return detect_forward(params, [f[15], f[18], f[21]], yp)


# ---------------------------------------------------------------------------
# pre/post processing (reference yolov9t.cpp:1028-1281)
# ---------------------------------------------------------------------------


def letterbox(image: Image, new_shape: int = 640, color=(114, 114, 114), scaleup: bool = True):
    """Ratio-preserving resize + gray border (reference letterbox,
    yolov9t.cpp:1028-1083, auto=False). Returns (array, gain, pad_w, pad_h)."""
    w, h = image.extent
    r = min(new_shape / h, new_shape / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = round(w * r), round(h * r)
    dw = (new_shape - new_w) / 2.0
    dh = (new_shape - new_h) / 2.0
    resized = image_scale(image, (new_w, new_h), preprocess_scale_method())
    left, right = round(dw - 0.1), round(dw + 0.1)
    top, bottom = round(dh - 0.1), round(dh + 0.1)
    a = resized.to_rgb_u8()
    out = np.full((new_h + top + bottom, new_w + left + right, 3), color, a.dtype)
    out[top : top + new_h, left : left + new_w] = a
    return out, r, dw, dh


@dataclass
class Detection:
    x1: float
    y1: float
    x2: float
    y2: float
    confidence: float
    class_id: int


def _nms(boxes: np.ndarray, scores: np.ndarray, class_ids: np.ndarray, iou_thres: float, max_wh: int,
         max_det: int) -> list[int]:
    """Greedy NMS with per-class offsets, the arithmetic of the native
    library's ``visp_nms`` (vision_tpu/native/host_ops.cpp:148-182) in
    numpy: candidates in a stable order of falling score, boxes shifted by
    ``class_id * max_wh`` in f32, IoU in f32 with ``+ 1e-9``, a candidate
    suppressed when its IoU with a kept one is ``> iou_thres``; at most
    ``max_det`` kept. The offsets put boxes of two classes ``max_wh`` apart,
    so their IoU is 0: each kept box is compared, in one vectorised pass,
    with the later candidates of its own class only, and the loop runs at
    most ``max_det`` times. Returns the kept indices into the inputs, best
    first."""
    n = len(scores)
    order = np.argsort(-np.asarray(scores, np.float32), kind="stable")
    cls = np.asarray(class_ids)[order]
    b = np.asarray(boxes, np.float32)[order]
    off = cls.astype(np.float32) * np.float32(max_wh)
    x1, y1, x2, y2 = b[:, 0] + off, b[:, 1], b[:, 2] + off, b[:, 3]
    area = (x2 - x1) * (y2 - y1)
    thres, eps, zero = np.float32(iou_thres), np.float32(1e-9), np.float32(0)
    # each class's positions in the sorted order, ascending
    by_cls = np.argsort(cls, kind="stable")
    starts = np.searchsorted(cls[by_cls], cls)
    ends = np.searchsorted(cls[by_cls], cls, side="right")
    alive = np.ones(n, bool)
    keep: list[int] = []
    i = 0
    while len(keep) < max_det:
        live = np.flatnonzero(alive[i:])
        if live.size == 0:
            break
        i += int(live[0])
        keep.append(int(order[i]))
        same = by_cls[starts[i] : ends[i]]
        r = same[np.searchsorted(same, i, side="right") :]
        inter = np.maximum(zero, np.minimum(x2[i], x2[r]) - np.maximum(x1[i], x1[r])) * np.maximum(
            zero, np.minimum(y2[i], y2[r]) - np.maximum(y1[i], y1[r]))
        alive[r[inter / (area[i] + area[r] - inter + eps) > thres]] = False
        i += 1
    return keep


def non_max_suppression(
    boxes: np.ndarray,
    scores: np.ndarray,
    conf_thres: float = 0.25,
    iou_thres: float = 0.45,
    max_det: int = 300,
    max_nms: int = 30000,
    max_wh: int = 7680,
) -> list[Detection]:
    """Host NMS with per-class offsets (reference non_max_suppression + nms,
    yolov9t.cpp:1117-1253). boxes: (A, 4) xyxy; scores: (A, nc). Every
    (anchor, class) at or above ``conf_thres`` is a candidate; past
    ``max_nms`` candidates only the best ``max_nms`` go on; then greedy NMS
    (:func:`_nms`), as the JAX package's with its native library."""
    a_idx, c_idx = np.nonzero(scores >= conf_thres)
    if a_idx.size == 0:
        return []
    cand_boxes = boxes[a_idx]
    cand_scores = scores[a_idx, c_idx]
    cand_cls = c_idx
    if cand_boxes.shape[0] > max_nms:
        order = np.argsort(-cand_scores)[:max_nms]
        cand_boxes, cand_scores, cand_cls = cand_boxes[order], cand_scores[order], cand_cls[order]
    kept = _nms(cand_boxes, cand_scores, cand_cls, iou_thres, max_wh, max_det)
    return [
        Detection(*cand_boxes[i].tolist(), confidence=float(cand_scores[i]), class_id=int(cand_cls[i]))
        for i in kept
    ]


def scale_boxes(detections: list[Detection], img_extent, gain: float, pad_w: float, pad_h: float):
    """Undo letterbox (reference scale_boxes, yolov9t.cpp:1255-1281)."""
    w, h = img_extent
    for d in detections:
        d.x1 = float(np.clip((d.x1 - pad_w) / gain, 0, w))
        d.x2 = float(np.clip((d.x2 - pad_w) / gain, 0, w))
        d.y1 = float(np.clip((d.y1 - pad_h) / gain, 0, h))
        d.y2 = float(np.clip((d.y2 - pad_h) / gain, 0, h))
    return detections


class Yolov9tModel:
    """High-level handle: the weights on the card in the device's float type,
    the whole detection DAG behind :meth:`forward_u8`, letterbox and NMS on
    the host in :meth:`compute`.

    ``params``: torch tensors under the GGUF names; floats are cast to the
    device's float policy here (they are moved nowhere: pass them on the
    device, as :func:`yolov9t_load_model` does).

    ``mesh``: a dp mesh of parallel/ (every rank builds the model from its
    own copy of the weights; no weight matches a tp rule, so they are
    replicated, as in the JAX package): ``forward_u8`` splits its batch
    over dp (rank 0 calls, the other ranks follow, parallel/runner.py),
    each rank replaying its own CUDA graph per shard shape."""

    def __init__(self, params: dict[str, torch.Tensor], p: Yolov9tParams, device: Device, mesh=None):
        self.p = p
        self.device = device
        self.dtype = device.preferred_float_type
        self.mesh = mesh
        self.params = cast_float_params(params, self.dtype)
        self.graphs = ForwardGraphs(self._forward_u8, device.torch_device)
        self._calls = mesh_entries(self, mesh, forward_u8=self.graphs)

    def forward_u8(self, x_u8: torch.Tensor) -> DetectOutput:
        """(B, H, W, 3) uint8 -> the forward's boxes and scores (f32) on the
        model's device: the /255 and the cast run there, as the JAX package's
        ``_yolo_program``. Runs under ``torch.inference_mode``, entered here
        because the mode is thread-local and servers call this from their own
        worker thread. On the card each input shape runs as one CUDA graph,
        captured at its first call and replayed after (core/graph.py); the
        result is a copy that the caller keeps."""
        return self._calls["forward_u8"](x_u8)

    def _forward_u8(self, x_u8: torch.Tensor) -> DetectOutput:
        """The eager forward that :meth:`forward_u8` captures (the reference of its tests)."""
        with torch.inference_mode():
            x = normalize_u8(x_u8.to(self.device.torch_device, non_blocking=True), dtype=self.dtype)
            return yolov9t_forward(Params(self.params), x, self.p)

    def compute(self, image: Image, conf_thres=0.25, iou_thres=0.45) -> list[Detection]:
        arr, gain, dw, dh = letterbox(image, self.p.input_size)
        out = self.forward_u8(torch.from_numpy(arr[None]))
        boxes = out.boxes[0].cpu().numpy()
        scores = out.scores[0].cpu().numpy()
        dets = non_max_suppression(boxes, scores, conf_thres, iou_thres)
        return scale_boxes(dets, image.extent, gain, dw, dh)


def yolov9t_load_model(filepath: str, device: Device | None = None, mesh=None) -> Yolov9tModel:
    """Load a YOLOv9t GGUF onto ``device`` (default: the CUDA device; without
    one, backend_init raises). With the device's ``keep_quantized`` flag
    (``VISP_KEEP_QUANT``) block-quantized tensors stay int8-resident and
    dequantize at each use (core/quant.py); without it they expand at load.
    ``mesh``: replicate the weights over a dp mesh of parallel/ (quantized
    residency is single-card only; a mesh forces dequant)."""
    device = device or backend_init()
    file = model_load(filepath)
    keep_q = bool(device.flags & BuildFlag.keep_quantized) and mesh is None
    params = load_weights(file, device, keep_quantized=keep_q)
    return Yolov9tModel(params, yolov9t_detect_params(file), device, mesh=mesh)


def get_class_color(class_id: int) -> tuple[int, int, int]:
    """HSV-derived per-class color (reference get_class_color,
    yolov9t.cpp:1420-1442)."""
    h = (class_id * 137) % 360
    s, v = 0.8, 0.95
    c = v * s
    x = c * (1 - abs((h / 60.0) % 2 - 1))
    m = v - c
    r1, g1, b1 = [
        (c, x, 0), (x, c, 0), (0, c, x), (0, x, c), (x, 0, c), (c, 0, x),
    ][int(h // 60) % 6]
    return (int((r1 + m) * 255), int((g1 + m) * 255), int((b1 + m) * 255))


def _hline(a: np.ndarray, x0: int, y: int, x1: int, color) -> None:
    """Pixels x0..x1 of row y, clipped (PIL's hline)."""
    h, w = a.shape[:2]
    if 0 <= y < h:
        x0, x1 = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
        if x0 <= x1:
            a[y, x0 : x1 + 1] = color


def _rectangle(a: np.ndarray, xy, color, fill: bool = False, width: int = 1) -> None:
    """PIL's ``ImageDraw.rectangle`` in numpy: the corners truncated to
    ints; filled, every row y0..y1; else a ``width``-pixel outline of two
    row bands and two column bands, the columns drawn from y0 + width toward
    y1 - width + 1 as PIL draws them."""
    x0, y0, x1, y1 = (int(v) for v in xy)
    if fill:
        for y in range(max(y0, 0), min(y1, a.shape[0] - 1) + 1):
            _hline(a, x0, y, x1, color)
        return
    # PIL's vertical line from ya toward yb stops one pixel short of yb
    ya, yb = y0 + width, y1 - width + 1
    lo, hi = (ya, yb) if ya <= yb else (yb + 1, ya + 1)
    for i in range(width):
        _hline(a, x0, y0 + i, x1, color)
        _hline(a, x0, y1 - i, x1, color)
        for x in (x1 - i, x0 + i):
            if 0 <= x < a.shape[1]:
                a[max(lo, 0) : max(min(hi, a.shape[0]), 0), x] = color


def draw_detections(image: Image, detections: list[Detection], thickness: int = 2) -> Image:
    """Draw boxes + labels (reference draw_detections, yolov9t.cpp:1444-1546):
    each box's outline, a label bar above it and the label in it. Where PIL
    imports it draws them, as the JAX package does. Where it does not, the
    outlines and bars are drawn in numpy on the pixels PIL would colour, the
    bar as wide as PIL's bitmap default font makes a label (6 pixels a
    character), and the text is left out (the CLI prints every label)."""
    a = image.data
    if a.shape[2] == 1:
        a = np.repeat(a, 3, axis=2)
    a = np.ascontiguousarray(a[:, :, :3])
    labelled = [(d, get_class_color(d.class_id), f"{_class_name(d.class_id)} {d.confidence:.2f}") for d in detections]
    try:
        from PIL import Image as PILImage, ImageDraw
    except ImportError:
        for d, color, label in labelled:
            _rectangle(a, (d.x1, d.y1, d.x2, d.y2), color, width=thickness)
            _rectangle(a, (d.x1, max(0, d.y1 - 12), d.x1 + 6 * len(label) + 4, d.y1), color, fill=True)
        return Image(a, ImageFormat.rgb_u8)
    pil = PILImage.fromarray(a)
    draw = ImageDraw.Draw(pil)
    for d, color, label in labelled:
        draw.rectangle([d.x1, d.y1, d.x2, d.y2], outline=color, width=thickness)
        draw.rectangle([d.x1, max(0, d.y1 - 12), d.x1 + draw.textlength(label) + 4, d.y1], fill=color)
        draw.text((d.x1 + 2, max(0, d.y1 - 12)), label, fill=(0, 0, 0))
    return Image(np.array(pil), ImageFormat.rgb_u8)


def _class_name(class_id: int) -> str:
    return COCO_CLASS_NAMES[class_id] if class_id < len(COCO_CLASS_NAMES) else str(class_id)


COCO_CLASS_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train", "truck", "boat",
    "traffic light", "fire hydrant", "stop sign", "parking meter", "bench", "bird", "cat",
    "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball",
    "kite", "baseball bat", "baseball glove", "skateboard", "surfboard", "tennis racket",
    "bottle", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
    "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush",
]
