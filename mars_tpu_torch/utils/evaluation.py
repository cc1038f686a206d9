"""Evaluation: per-episode intersection/union + class-wise meters (the
port's own copy of ``mars_tpu/utils/evaluation.py``).

Functional parity with the reference evaluator/meter
(reference: mars/utils/evaluation.py:5-39, mars/utils/logger.py:14-152):
  - PASCAL-5i ignore regions (boundary 255) excluded from both masks
  - per-episode 2-bin (bg/fg) intersection & union
  - class-indexed accumulation; mIoU = mean over fold classes of fg IoU;
    FB-IoU = mean over {bg, fg} of pooled inter/union
  - a "known bad predictions" secondary buffer (the reference's curated
    hard-case regression subset, logger.py:80-127)

Pure numpy on host (episode-level reductions are tiny); the device path
returns masks already binarized.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

NCLASS = {
    "pascal": 20,
    "pascal5i": 20,
    "coco": 80,
    "fss": 1000,
    "paco_part": 448,
    "pascal_part": 100,
    "lvis": 1203,
    "synthetic": 16,
}


def classify_prediction(
    pred_mask: np.ndarray,  # (H, W) {0,1}
    gt_mask: np.ndarray,  # (H, W) {0,1}
    ignore_mask: Optional[np.ndarray] = None,  # (H, W) {0,1}
) -> Tuple[np.ndarray, np.ndarray]:
    """→ (area_inter (2,), area_union (2,)) over {bg, fg}."""
    pred = pred_mask.astype(np.int64).reshape(-1)
    gt = gt_mask.astype(np.int64).reshape(-1)
    if ignore_mask is not None:
        keep = ignore_mask.reshape(-1) == 0
        pred = pred[keep]
        gt = gt[keep]
    inter = np.bincount(pred[pred == gt], minlength=2)[:2]
    area_pred = np.bincount(pred, minlength=2)[:2]
    area_gt = np.bincount(gt, minlength=2)[:2]
    union = area_pred + area_gt - inter
    return inter.astype(np.float64), union.astype(np.float64)


class AverageMeter:
    def __init__(self, benchmark: str, class_ids, zero_indexed: bool = True):
        """class_ids: the fold's class ids (already 0-indexed unless
        ``zero_indexed`` is False, mirroring the reference's pascal5i
        1→0 shift, logger.py:21-23)."""
        self.benchmark = benchmark
        ids = np.asarray(class_ids, np.int64)
        if not zero_indexed:
            ids = ids - 1
        self.class_ids = ids
        n = NCLASS.get(benchmark, int(ids.max()) + 1 if len(ids) else 1)
        self.nclass = max(n, int(ids.max()) + 1 if len(ids) else 1)
        self.inter = np.zeros((2, self.nclass))
        self.union = np.zeros((2, self.nclass))
        self.inter_bad = np.zeros((2, self.nclass))
        self.union_bad = np.zeros((2, self.nclass))
        self.bad_class_ids = []

    def update(self, inter: np.ndarray, union: np.ndarray, class_id: int):
        self.inter[:, class_id] += inter
        self.union[:, class_id] += union

    def update_bad_preds(self, inter, union, class_id: int):
        if class_id not in self.bad_class_ids:
            self.bad_class_ids.append(class_id)
        self.inter_bad[:, class_id] += inter
        self.union_bad[:, class_id] += union

    def _compute(self, inter, union, ids):
        iou = inter / np.maximum(union, 1.0)
        iou_sel = iou[:, ids]
        miou = float(iou_sel[1].mean() * 100)
        fb = float(
            (inter[:, ids].sum(1) / np.maximum(union[:, ids].sum(1), 1e-9)).mean() * 100
        )
        return miou, fb, iou_sel[1]

    def compute_iou(self):
        """→ (mIoU %, FB-IoU %, per-class fg IoU)."""
        return self._compute(self.inter, self.union, self.class_ids)

    def compute_iou_bad_preds(self):
        return self._compute(self.inter_bad, self.union_bad,
                             np.asarray(self.bad_class_ids, np.int64))
