"""The port's utils/metrics.py against the JAX package's: every mask, depth
and detection metric on the same seeded inputs, within 1e-6 (the JAX forms
run in f32 through jnp, the port's in numpy with f64 sums), and hand-worked
values, absent classes, an empty ground truth and YOLO ``Detection`` inputs."""

import numpy as np
import pytest

from vision_tpu.models.yolov9t import Detection as JaxDetection
from vision_tpu.utils import metrics as jm
from vision_tpu_torch.models.yolov9t import Detection
from vision_tpu_torch.utils import metrics as tm
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-6


def _masks(seed, shape=(3, 24, 20), p=0.4):
    rng = np.random.default_rng(seed)
    return rng.random(shape).astype(np.float32) * (rng.random(shape) < p + 0.2), rng.random(shape) < p


@pytest.mark.parametrize("axis", [None, (-2, -1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mask_iou_matches_jax(seed, axis):
    pred, true = _masks(seed)
    got, want = tm.mask_iou(pred, true, axis=axis), np.asarray(jm.mask_iou(pred, true, axis=axis))
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", ["offset_squares", "both_empty", "one_empty"])
def test_mask_iou_hand_worked(case):
    pred, true = np.zeros((16, 16)), np.zeros((16, 16))
    want = {"offset_squares": 36 / 92, "both_empty": 1.0, "one_empty": 0.0}[case]
    if case == "offset_squares":
        true[2:10, 2:10] = 1
        pred[4:12, 4:12] = 1
    elif case == "one_empty":
        true[2:10, 2:10] = 1
    assert float(tm.mask_iou(pred, true)) == pytest.approx(want, abs=TOL)
    assert float(jm.mask_iou(pred, true)) == pytest.approx(want, abs=TOL)


@pytest.mark.parametrize("n_classes", [3, 6])  # 6: classes 4 and 5 absent from both maps
def test_mean_iou_matches_jax(n_classes):
    rng = np.random.default_rng(n_classes)
    pred = rng.integers(0, 4, (30, 40))
    true = np.where(rng.random((30, 40)) < 0.7, pred, rng.integers(0, 4, (30, 40)))
    got, want = tm.mean_iou(pred, true, n_classes), float(jm.mean_iou(pred, true, n_classes))
    assert got == pytest.approx(want, abs=TOL) and 0 < got < 1


def test_mean_iou_hand_worked():
    """Class 0: IoU 1/2, class 1: 2/3, class 2 absent: excluded from the mean."""
    pred, true = np.array([0, 0, 1, 1, 1]), np.array([0, 1, 1, 1, 0])
    want = (1 / 3 + 2 / 4) / 2
    assert tm.mean_iou(pred, true, 3) == pytest.approx(want, abs=TOL)
    assert float(jm.mean_iou(pred, true, 3)) == pytest.approx(want, abs=TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_depth_metrics_match_jax(seed, masked):
    rng = np.random.default_rng(seed)
    true = rng.uniform(0.0, 2.0, (40, 30)).astype(np.float32)
    true[rng.random(true.shape) < 0.1] = 0.0  # invalid pixels
    pred = (true * rng.uniform(0.8, 1.3, true.shape)).astype(np.float32)
    pred[:3, :3] = 0.0  # a zero prediction: its ratio takes the t / 1 branch
    mask = (rng.random(true.shape) < 0.8) & (true > 0) if masked else None
    got, want = tm.depth_metrics(pred, true, mask=mask), jm.depth_metrics(pred, true, mask=mask)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=TOL), k


def test_depth_metrics_hand_worked():
    """pred = 1.1 * true: AbsRel 0.1, delta1 1; 2 * true: delta1 0."""
    true = np.linspace(0.5, 2.0, 64, dtype=np.float32)
    for scale, absrel, delta1 in ((1.1, 0.1, 1.0), (2.0, 1.0, 0.0)):
        for m in (tm, jm):
            d = m.depth_metrics(scale * true, true)
            assert d["absrel"] == pytest.approx(absrel, abs=1e-5) and d["delta1"] == delta1


@pytest.mark.parametrize("shape", [(7, 5), (0, 4), (3, 0)])
def test_box_iou_matrix_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))

    def boxes(n):
        xy = rng.uniform(0, 50, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(1, 30, (n, 2))], axis=1)

    a, b = boxes(shape[0]), boxes(shape[1])
    got, want = tm.box_iou_matrix(a, b), jm.box_iou_matrix(a, b)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n_true", [0, 5, 12])
def test_average_precision_matches_jax(n_true):
    rng = np.random.default_rng(n_true)
    tp = (rng.random(10) < 0.5).astype(np.float64)
    scores = rng.random(10)
    assert tm.average_precision(tp, scores, n_true) == pytest.approx(jm.average_precision(tp, scores, n_true),
                                                                     abs=TOL)
    assert tm.average_precision(np.zeros(0), np.zeros(0), 3) == jm.average_precision(np.zeros(0), np.zeros(0), 3) == 0


def _detections(rng, n_images, n_classes, jitter):
    """Seeded ground truths and predictions near them, with strays."""
    gts, preds = [], []
    for _ in range(n_images):
        xy = rng.uniform(0, 200, (rng.integers(0, 5), 2))
        g = [(x, y, x + 40, y + 30, int(rng.integers(0, n_classes))) for x, y in xy]
        p = [(x1 + rng.normal(0, jitter), y1 + rng.normal(0, jitter), x2, y2, float(rng.random()), c)
             for x1, y1, x2, y2, c in g if rng.random() < 0.8]
        p += [(*(lambda x, y: (x, y, x + 20, y + 20))(*rng.uniform(0, 200, 2)), float(rng.random()),
               int(rng.integers(0, n_classes))) for _ in range(rng.integers(0, 3))]
        gts.append(g)
        preds.append(p)
    return preds, gts


@pytest.mark.parametrize("thresholds", [(0.5,), tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_map_matches_jax(seed, thresholds):
    preds, gts = _detections(np.random.default_rng(seed), 6, 3, 4.0)
    got, want = tm.detection_map(preds, gts, thresholds), jm.detection_map(preds, gts, thresholds)
    assert got["map"] == pytest.approx(want["map"], abs=TOL)
    assert got["ap_per_iou"].keys() == want["ap_per_iou"].keys()
    for k in got["ap_per_iou"]:
        assert got["ap_per_iou"][k] == pytest.approx(want["ap_per_iou"][k], abs=TOL)


@pytest.mark.parametrize("case", ["empty_gt", "empty_predictions", "nothing"])
def test_detection_map_empty_sides(case):
    preds, gts = _detections(np.random.default_rng(5), 3, 2, 2.0)
    if case in ("empty_gt", "nothing"):
        gts = [[] for _ in gts]
    if case in ("empty_predictions", "nothing"):
        preds = [[] for _ in preds]
    got, want = tm.detection_map(preds, gts), jm.detection_map(preds, gts)
    assert got == want and got["map"] == 0.0


def test_detection_map_takes_yolo_detections():
    """The port's Detection unpacks as the JAX package's does: the same mAP
    from Detection lists as from tuples."""
    preds, gts = _detections(np.random.default_rng(7), 4, 3, 3.0)
    ours = [[Detection(*p) for p in img] for img in preds]
    theirs = [[JaxDetection(*p) for p in img] for img in preds]
    got = tm.detection_map(ours, gts, (0.5, 0.75))
    assert got == tm.detection_map(preds, gts, (0.5, 0.75))
    want = jm.detection_map(theirs, gts, (0.5, 0.75))
    assert got["map"] == pytest.approx(want["map"], abs=TOL) and got["map"] > 0


def test_detection_map_rejects_unequal_lengths():
    for m in (tm, jm):
        with pytest.raises(ValueError, match="predictions for 1 images vs ground truths for 2"):
            m.detection_map([[]], [[], []])


def test_package_exports_the_metrics():
    import vision_tpu.utils as ju
    import vision_tpu_torch.utils as tu

    metric_names = [n for n in ju.__all__ if n not in ("Timer", "trace", "dump_captures", "compare_dumps")]
    assert sorted(metric_names) == sorted(tm.__all__)
    assert sorted(tu.__all__) == sorted(ju.__all__)  # the tools too, since the port has them
