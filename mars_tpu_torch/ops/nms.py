"""Greedy box NMS with torchvision semantics (port of
``mars_tpu/ops/nms.py``: ``nms_keep``).

Boxes are sorted by score (stable, invalid rows last), the pairwise IoU of
the ``n_valid`` live rows is computed on the device, and the greedy walk
over them runs on the host on that (n_valid, n_valid) block: one copy off
the device instead of a few small launches per row.
Suppression is IoU > threshold (strict); ties are kept.
"""
from __future__ import annotations

import numpy as np
import torch

from mars_tpu_torch.core.masks import box_iou


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """(N, 4) XYXY boxes, (N,) scores, (N,) bool → (N,) bool keep mask.
    Invalid rows are never kept and never suppress."""
    n = boxes.shape[0]
    key = torch.where(valid, -scores.float(), torch.full_like(scores, float("inf"),
                                                              dtype=torch.float32))
    order = torch.argsort(key, stable=True)
    n_valid = int(valid.sum())
    live = order[:n_valid]
    over = (box_iou(boxes[live], boxes[live]) > iou_threshold).cpu().numpy()
    keep_ord = np.zeros((n_valid,), bool)
    for i in range(n_valid):
        keep_ord[i] = not (keep_ord[:i] & over[i, :i]).any()
    keep = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    keep[live] = torch.from_numpy(keep_ord).to(boxes.device)
    return keep
