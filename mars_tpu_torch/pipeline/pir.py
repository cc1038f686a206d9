"""Prior Information Refinement (port of ``mars_tpu/pipeline/pir.py``).

  prior (G, G) in [0,1], A = mean attention (L, L), L = G² →
    B  = union of bounding boxes of the thresholded prior's 8-connected
         components (ops.components)
    D  = A / colsum(A);  D = D / rowsum(D)
    R  = max(D, D Dᵀ);  R = R R
    out = (R ⊙ B_row) @ prior_flat, reshaped to (G, G)
All float32 (reference PriorInformationRefinementModule.py:20-122).
"""
from __future__ import annotations

import torch

from mars_tpu_torch.ops.components import component_boxes_union, threshold_prior


def refine(prior: torch.Tensor, attn_mean: torch.Tensor, box_threshold: float) -> torch.Tensor:
    """prior: (G, G); attn_mean: (L, L) with L = G*G. Returns (G, G)."""
    g1, g2 = prior.shape
    b = component_boxes_union(threshold_prior(prior, box_threshold)).reshape(-1)
    a = attn_mean.float()
    d = a / a.sum(dim=0, keepdim=True)
    d = d / d.sum(dim=1, keepdim=True)
    r = torch.maximum(d, d @ d.T)
    r = r @ r
    return ((r * b[None, :]) @ prior.reshape(-1, 1).float()).reshape(g1, g2)
