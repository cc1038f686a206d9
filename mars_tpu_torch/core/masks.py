"""Mask geometry: boxes, box IoU, stability (port of
``mars_tpu/core/masks.py``: ``mask_to_box``, ``box_area``, ``box_iou``,
``stability_score``).  The crop helpers are not ported yet.
"""
from __future__ import annotations

import torch


def mask_to_box(mask: torch.Tensor) -> torch.Tensor:
    """XYXY box (int32) around the nonzero region of (..., H, W) masks.

    Edges are INCLUSIVE pixel indices and empty masks give [0, 0, 0, 0], as
    the reference's batched_mask_to_box (segment_anything/utils/amg.py)."""
    h, w = mask.shape[-2:]
    m = mask > 0
    rows, cols = m.any(dim=-1), m.any(dim=-2)
    ri = torch.arange(h, device=mask.device)
    ci = torch.arange(w, device=mask.device)
    big = 1 << 30
    y0 = torch.where(rows, ri, big).amin(dim=-1)
    y1 = torch.where(rows, ri, -1).amax(dim=-1)
    x0 = torch.where(cols, ci, big).amin(dim=-1)
    x1 = torch.where(cols, ci, -1).amax(dim=-1)
    box = torch.stack([x0, y0, x1, y1], dim=-1).to(torch.int32)
    return torch.where(rows.any(dim=-1, keepdim=True), box, torch.zeros_like(box))


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) XYXY boxes."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) and (M, 4) XYXY boxes → (N, M) float32."""
    a, b = a.float(), b.float()
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def stability_score(mask_logits: torch.Tensor, mask_threshold: float,
                    offset: float) -> torch.Tensor:
    """IoU of the masks binarised at threshold ± offset (reference
    segment_anything/utils/amg.py:156-177)."""
    hi = (mask_logits > (mask_threshold + offset)).sum(dim=(-1, -2)).float()
    lo = (mask_logits > (mask_threshold - offset)).sum(dim=(-1, -2)).float()
    return hi / torch.clamp(lo, min=1e-9)
