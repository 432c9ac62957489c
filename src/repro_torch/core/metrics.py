"""Detection metrics: AP@0.5 mAP (greedy matching, all-point interpolation).

The paper evaluates with FiftyOne's COCO-style mAP; AP@0.5 with greedy
score-ordered matching is the same family of metric and is computed here
from scratch (no external deps).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

Box = np.ndarray  # [x0, y0, x1, y1]


def iou(a: Box, b: Box) -> float:
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def match_image(pred_boxes, pred_scores, gt_boxes, thr: float = 0.5):
    """Greedy match by descending score.  Returns (tp flags, n_gt)."""
    order = np.argsort(-np.asarray(pred_scores))
    used = set()
    tp = np.zeros(len(order), bool)
    for rank, i in enumerate(order):
        best, best_j = thr, -1
        for j, g in enumerate(gt_boxes):
            if j in used:
                continue
            v = iou(np.asarray(pred_boxes[i]), np.asarray(g))
            if v >= best:
                best, best_j = v, j
        if best_j >= 0:
            used.add(best_j)
            tp[rank] = True
    return tp, len(gt_boxes)


def average_precision(scores, tp_flags, n_gt: int) -> float:
    """All-point interpolated AP from pooled detections."""
    if n_gt == 0:
        return 1.0 if len(scores) == 0 else 0.0
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(tp_flags)[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # all-point interpolation
    mrec = np.concatenate([[0.0], recall, [recall[-1] if len(recall) else 0.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class MAPAccumulator:
    """Pools detections across images, per class; .map() -> [0, 100]."""

    def __init__(self, num_classes: int, iou_thr: float = 0.5):
        self.num_classes = num_classes
        self.thr = iou_thr
        self._scores: Dict[int, List[float]] = {c: [] for c in range(num_classes)}
        self._tp: Dict[int, List[bool]] = {c: [] for c in range(num_classes)}
        self._n_gt: Dict[int, int] = {c: 0 for c in range(num_classes)}
        self._n_empty = 0        # images with no ground-truth objects
        self._n_empty_clean = 0  # ... on which the model emitted no FPs

    def add_image(self, pred_boxes, pred_scores, pred_classes,
                  gt_boxes, gt_classes) -> None:
        pred_boxes = np.asarray(pred_boxes).reshape(-1, 4)
        gt_boxes = np.asarray(gt_boxes).reshape(-1, 4)
        pred_classes = np.asarray(pred_classes, int).reshape(-1)
        gt_classes = np.asarray(gt_classes, int).reshape(-1)
        if len(gt_classes) == 0:
            self._n_empty += 1
            if len(pred_classes) == 0:
                self._n_empty_clean += 1
        for c in range(self.num_classes):
            pi = pred_classes == c
            gi = gt_classes == c
            tp, n_gt = match_image(pred_boxes[pi], np.asarray(pred_scores)[pi],
                                   gt_boxes[gi], self.thr)
            # match_image returns flags ordered by score; keep that order
            order = np.argsort(-np.asarray(pred_scores)[pi])
            self._scores[c].extend(np.asarray(pred_scores)[pi][order].tolist())
            self._tp[c].extend(tp.tolist())
            self._n_gt[c] += n_gt

    def map(self) -> float:
        aps = []
        for c in range(self.num_classes):
            if self._n_gt[c] == 0:
                continue  # COCO convention: classes absent from GT ignored
            aps.append(average_precision(self._scores[c], self._tp[c],
                                         self._n_gt[c]))
        if aps:
            return 100.0 * float(np.mean(aps))
        # group with NO ground truth anywhere (the '0 objects' group):
        # score = fraction of images kept free of false positives
        if self._n_empty:
            return 100.0 * self._n_empty_clean / self._n_empty
        return 0.0
