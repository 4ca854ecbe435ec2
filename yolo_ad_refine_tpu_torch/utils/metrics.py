"""Detection metrics: AP, precision / recall, confusion matrix, fitness.

Counterpart of ``yolo_ad_refine_tpu/utils/metrics.py`` (reference
ultralytics/utils/metrics.py: compute_ap:1112 with 101-point interpolation,
ap_per_class:1144, Metric / DetMetrics:1234-1500, ConfusionMatrix:900) and
the fork's fitness 0.9 * mAP50 + 0.1 * mAP50-95 (metrics.py:1356-1359),
which picks the best checkpoint; ``box_iou_np`` and ``probiou_np`` from
``yolo_ad_refine_tpu/utils/metrics_np.py`` for the validator's matching.
Host-side numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU of (N, 4) x (M, 4) xyxy boxes -> (N, M)."""
    a1, a2 = box1[:, None, :2], box1[:, None, 2:4]
    b1, b2 = box2[None, :, :2], box2[None, :, 2:4]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(-1)
    area1 = np.prod(box1[:, 2:4] - box1[:, :2], -1)[:, None]
    area2 = np.prod(box2[:, 2:4] - box2[:, :2], -1)[None, :]
    return inter / (area1 + area2 - inter + eps)


def _obb_cov_np(rb: np.ndarray):
    """Gaussian covariance terms (a, b, c) of xywhr boxes (ops/iou.py)."""
    a = rb[..., 2] ** 2 / 12.0
    b = rb[..., 3] ** 2 / 12.0
    c, s = np.cos(rb[..., 4]), np.sin(rb[..., 4])
    return a * c**2 + b * s**2, a * s**2 + b * c**2, (a - b) * c * s


def probiou_np(rb1: np.ndarray, rb2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise probabilistic IoU of (N, 5) x (M, 5) xywhr boxes -> (N, M),
    for the validator's OBB matching (ops/iou.py:probiou in numpy)."""
    r1, r2 = rb1[:, None, :], rb2[None, :, :]
    x1, y1, x2, y2 = r1[..., 0], r1[..., 1], r2[..., 0], r2[..., 1]
    a1, b1, c1 = _obb_cov_np(r1)
    a2, b2, c2 = _obb_cov_np(r2)
    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    t3 = 0.5 * np.log(
        ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
        / (4 * np.sqrt(np.clip(a1 * b1 - c1**2, 0, None) * np.clip(a2 * b2 - c2**2, 0, None))
           + eps)
        + eps)
    bd = np.clip(t1 + t2 + t3, eps, 100.0)
    return 1.0 - np.sqrt(1.0 - np.exp(-bd) + eps)


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box filter of fraction f (reference metrics.py smooth)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP (reference metrics.py:1112-1141, 'interp')."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x)
    return ap, mpre, mrec


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray, eps: float = 1e-16):
    """Per-class AP over the 10 IoU thresholds (reference metrics.py:1144-1232).

    Args:
        tp: (N, 10) bool TP matrix at IoU 0.50:0.95
        conf, pred_cls: (N,)
        target_cls: (M,) all GT classes
    Returns dict with p, r, ap (nc, 10), f1, unique_classes — values at the
    max-F1 confidence threshold, like the reference.
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    prec_values = np.zeros((nc, 1000))  # precision over the RECALL grid at IoU .5
    for ci, c in enumerate(unique_classes):
        m = pred_cls == c
        n_l = nt[ci]
        n_p = m.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[m]).cumsum(0)
        tpc = tp[m].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-x, -conf[m], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-x, -conf[m], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                # the reference's PR-curve envelope (metrics.py prec_values)
                prec_values[ci] = np.interp(x, mrec, mpre)

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i_max = smooth(f1_curve.mean(0), 0.1).argmax()
    p, r, f1 = p_curve[:, i_max], r_curve[:, i_max], f1_curve[:, i_max]
    return {
        "p": p, "r": r, "f1": f1, "ap": ap,
        "unique_classes": unique_classes.astype(int), "nt": nt,
        "p_curve": p_curve, "r_curve": r_curve, "x": x,
        "prec_values": prec_values,
    }


def match_predictions(pred_cls: np.ndarray, true_cls: np.ndarray, iou: np.ndarray,
                      thresholds: np.ndarray = IOU_THRESHOLDS) -> np.ndarray:
    """Greedy TP matching at each IoU threshold (reference validator.py:221-262).

    iou: (n_gt, n_pred) IoU matrix. Returns (n_pred, n_thr) bool TP.
    """
    correct = np.zeros((pred_cls.shape[0], len(thresholds)), bool)
    correct_class = true_cls[:, None] == pred_cls[None, :]
    iou = iou * correct_class
    for ti, t in enumerate(thresholds):
        matches = np.nonzero(iou >= t)
        matches = np.array(matches).T  # (k, 2): [gt, pred]
        if matches.shape[0]:
            if matches.shape[0] > 1:
                order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
                matches = matches[order]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), ti] = True
    return correct


class Metric:
    """Aggregated detection metrics (reference metrics.py:1234-1404)."""

    def __init__(self):
        self.p = []
        self.r = []
        self.f1 = []
        self.all_ap = np.zeros((0, 10))
        self.ap_class_index = []
        self.nt_per_class = None

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return float(np.mean(self.p)) if len(self.p) else 0.0

    @property
    def mr(self):
        return float(np.mean(self.r)) if len(self.r) else 0.0

    @property
    def map50(self):
        return float(self.all_ap[:, 0].mean()) if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return float(self.all_ap[:, 5].mean()) if len(self.all_ap) else 0.0

    @property
    def map(self):
        return float(self.all_ap.mean()) if len(self.all_ap) else 0.0

    def update(self, results: dict):
        self.p = results["p"]
        self.r = results["r"]
        self.f1 = results["f1"]
        self.all_ap = results["ap"]
        self.ap_class_index = results["unique_classes"]
        self.nt_per_class = results["nt"]
        self.p_curve = results.get("p_curve")
        self.r_curve = results.get("r_curve")
        self.px = results.get("x")
        self.prec_values = results.get("prec_values")

    @property
    def fitness(self) -> float:
        """FORK-FLIPPED fitness: 0.9*mAP50 + 0.1*mAP50-95 (metrics.py:1356)."""
        return 0.9 * self.map50 + 0.1 * self.map


class DetMetrics:
    """Accumulates (tp, conf, pred_cls, target_cls) stats; .process computes AP."""

    def __init__(self, names: dict | None = None):
        self.names = names or {}
        self.box = Metric()
        self.stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        self.nt_per_class = None
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}

    def update_stats(self, tp, conf, pred_cls, target_cls):
        self.stats["tp"].append(tp)
        self.stats["conf"].append(conf)
        self.stats["pred_cls"].append(pred_cls)
        self.stats["target_cls"].append(target_cls)

    def process(self):
        stats = {k: np.concatenate(v, 0) if v else np.zeros(0) for k, v in self.stats.items()}
        if stats["tp"].size and stats["target_cls"].size:
            results = ap_per_class(
                stats["tp"].reshape(len(stats["conf"]), -1) if stats["tp"].ndim == 1 else stats["tp"],
                stats["conf"], stats["pred_cls"], stats["target_cls"],
            )
            self.box.update(results)
        return self.results_dict

    @property
    def results_dict(self) -> dict:
        return {
            "metrics/precision(B)": self.box.mp,
            "metrics/recall(B)": self.box.mr,
            "metrics/mAP50(B)": self.box.map50,
            "metrics/mAP50-95(B)": self.box.map,
            "fitness": self.box.fitness,
        }

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]


class ConfusionMatrix:
    """Detection confusion matrix at conf 0.25 / IoU 0.45 (reference metrics.py:900)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1))

    def process_batch(self, detections: np.ndarray, gt_bboxes: np.ndarray, gt_cls: np.ndarray):
        """detections: (n, 6) [x1,y1,x2,y2,conf,cls]; gt in xyxy."""
        if gt_cls.size == 0:
            if detections is not None and len(detections):
                d = detections[detections[:, 4] > self.conf]
                for dc in d[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None or len(detections) == 0:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # false negative
            return
        d = detections[detections[:, 4] > self.conf]
        iou = box_iou_np(gt_bboxes, d[:, :4])
        matches = np.array(np.nonzero(iou > self.iou_thres)).T
        if matches.shape[0]:
            order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
            matches = matches[order]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        matched_gt = set(matches[:, 0].astype(int)) if matches.shape[0] else set()
        matched_det = {int(m[1]): int(m[0]) for m in matches} if matches.shape[0] else {}
        for di in range(len(d)):
            dc = int(d[di, 5])
            if di in matched_det:
                gc = int(gt_cls[matched_det[di]])
                self.matrix[dc, gc] += 1
            else:
                self.matrix[dc, self.nc] += 1
        for gi in range(len(gt_cls)):
            if gi not in matched_gt:
                self.matrix[self.nc, int(gt_cls[gi])] += 1
