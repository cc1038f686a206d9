"""Visual-Visual Alignment: the DINOv2 patch-matching prior (port of
``mars_tpu/pipeline/vva.py``).

L2-normalized prenorm patch features of support shots and query,
similarity S = sup @ qryᵀ and cost C = (1 - S) / 2 (kept on the device for
the EMD), the colmax·colmean prior of masked-support → query similarities
minus the same for background patches, min-max scaled, PIR-refined over
the query's tapped attention mean, min-max scaled
(reference VisualVisualAlignmentModule.py:42-131).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from mars_tpu_torch.core import imaging
from mars_tpu_torch.models import dinov2
from mars_tpu_torch.pipeline import pir

NEG = -1e9


@dataclass(frozen=True)
class VVAConfig:
    refinement_box_threshold: float = 0.8  # scripts/coco_1shot.sh
    attn_tap_last_n: int = 24
    grid: int = 37  # 518 / 14


def compute(params, support_images: torch.Tensor, support_masks: torch.Tensor,
            support_valid: torch.Tensor, query_image: torch.Tensor,
            model_cfg: dinov2.DinoV2Config, cfg: VVAConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (vva (g, g) in [0,1], cost_matrix (S·L, L), support_fg (S·L,))."""
    g = cfg.grid

    def norm(im):
        return imaging.normalize(im, imaging.IMAGENET_MEAN, imaging.IMAGENET_STD)

    out_s = dinov2.forward_features(params, norm(support_images), model_cfg)
    out_q = dinov2.forward_features(params, norm(query_image)[None], model_cfg,
                                    attn_tap_last_n=cfg.attn_tap_last_n)
    sup = dinov2.patch_features(out_s, model_cfg.num_register_tokens).float()
    qry = dinov2.patch_features(out_q, model_cfg.num_register_tokens).float()
    s_mat = sup @ qry.T  # (S*L, L)
    cost = (1.0 - s_mat) / 2.0

    pooled = (imaging.pool_mask_to_grid(support_masks, g) > 0) & support_valid[:, None, None]
    fg = pooled.reshape(-1)
    bg = ~fg & torch.repeat_interleave(support_valid, g * g)

    def max_mean(row_mask):
        mx = torch.where(row_mask[:, None], s_mat, torch.full_like(s_mat, NEG)).amax(dim=0)
        cnt = row_mask.sum()
        mean = torch.where(row_mask[:, None], s_mat, torch.zeros_like(s_mat)).sum(dim=0)
        mean = mean / torch.clamp(cnt, min=1)
        return (mean * mx).reshape(g, g), cnt

    vva_fg, _ = max_mean(fg)
    vva_bg, bg_cnt = max_mean(bg)
    vva = torch.where(bg_cnt > 0, vva_fg - vva_bg, vva_fg)
    vva = (vva - vva.min()) / (1e-7 + vva.max() - vva.min())
    refined = pir.refine(vva, out_q["attn_mean"][0], cfg.refinement_box_threshold)
    refined = (refined - refined.min()) / (1e-7 + refined.max() - refined.min())
    return refined, cost, fg
