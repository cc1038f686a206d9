"""Mask geometry: boxes, box and mask IoU, stability, crops (port of
``mars_tpu/core/masks.py``).
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


def mask_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, H, W) and (M, H, W) binary masks → (N, M)
    float32, one matmul of the flattened masks."""
    af = a.reshape(a.shape[0], -1).float()
    bf = b.reshape(b.shape[0], -1).float()
    inter = af @ bf.T
    union = af.sum(-1)[:, None] + bf.sum(-1)[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def is_box_near_crop_edge(boxes: torch.Tensor, crop_box, orig_box,
                          atol: float = 20.0) -> torch.Tensor:
    """True for (N, 4) XYXY boxes within ``atol`` of a crop edge that is not
    an edge of the original image (reference
    segment_anything/utils/amg.py:84-100)."""
    crop = torch.tensor(crop_box, dtype=torch.float32, device=boxes.device)
    orig = torch.tensor(orig_box, dtype=torch.float32, device=boxes.device)
    b = boxes.float()
    near_crop = (b - crop[None]).abs() <= atol
    near_orig = (b - orig[None]).abs() <= atol
    return (near_crop & ~near_orig).any(dim=-1)


def uncrop_boxes_xyxy(boxes: torch.Tensor, crop_box) -> torch.Tensor:
    """XYXY boxes from crop coordinates back to image coordinates."""
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + torch.tensor([x0, y0, x0, y0], dtype=boxes.dtype, device=boxes.device)


def uncrop_points(points: torch.Tensor, crop_box) -> torch.Tensor:
    """(..., 2) XY points from crop coordinates to image coordinates."""
    return points + torch.tensor(crop_box[:2], dtype=points.dtype, device=points.device)


def uncrop_masks(masks: torch.Tensor, crop_box, orig_h: int, orig_w: int) -> torch.Tensor:
    """(..., h, w) crop-frame masks zero-padded back into the (..., H, W)
    image frame (reference segment_anything/utils/amg.py:262-271); the crop
    box is host ints (x0, y0, x1, y1)."""
    x0, y0, x1, y1 = crop_box
    if (x0, y0, x1, y1) == (0, 0, orig_w, orig_h):
        return masks
    return torch.nn.functional.pad(masks, (x0, orig_w - x1, y0, orig_h - y1))


def masked_mean(values: torch.Tensor, mask: torch.Tensor, axis=None,
                eps: float = 1e-9) -> torch.Tensor:
    """Mean of ``values`` where ``mask`` is nonzero."""
    m = mask.to(values.dtype)
    if axis is None:
        return (values * m).sum() / (m.sum() + eps)
    return (values * m).sum(dim=axis) / (m.sum(dim=axis) + eps)


def coverage_and_prior_scores(prior_grid: torch.Tensor, proposal_grids: torch.Tensor,
                              support_grid: torch.Tensor, alpha: float) -> torch.Tensor:
    """Prior-alignment score of every proposal at once: alpha × the mean
    prior (G, G) under the proposal (P, G, G) + (1 - alpha) × its coverage
    of the footprint ``support_grid > 0`` (the reference's per-proposal
    loop, FilteringMergingModule.py:104-123) → (P,)."""
    p = proposal_grids.float()
    mean_under = (prior_grid[None] * p).sum(dim=(-1, -2)) / (p.sum(dim=(-1, -2)) + 1e-9)
    fg = (support_grid > 0).float()
    cov = (fg[None] * p).sum(dim=(-1, -2)) / (fg.sum() + 1e-9)
    return alpha * mean_under + (1.0 - alpha) * cov
