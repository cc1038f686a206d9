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


def _norm(im):
    return imaging.normalize(im, imaging.IMAGENET_MEAN, imaging.IMAGENET_STD)


def compute(params, support_images: torch.Tensor, support_masks: torch.Tensor,
            support_valid: torch.Tensor, query_image: torch.Tensor,
            model_cfg: dinov2.DinoV2Config, cfg: VVAConfig
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (vva (g, g) in [0,1], cost_matrix (S·L, L), support_fg (S·L,)):
    ``compute_batch`` over one episode."""
    return compute_batch(params, support_images[None], support_masks[None],
                         support_valid[None], query_image[None], model_cfg, cfg)[0]


def compute_batch(params, support_images: torch.Tensor, support_masks: torch.Tensor,
                  support_valid: torch.Tensor, query_images: torch.Tensor,
                  model_cfg: dinov2.DinoV2Config, cfg: VVAConfig):
    """``compute`` over B episodes, DINOv2 once over the stack of the B·S
    supports and the B queries (only the queries tapped, so a support runs
    the untapped route as in a forward of its own): support_images
    (B, S, H, W, 3), support_masks (B, S, H, W), support_valid (B, S),
    query_images (B, H, W, 3) → lists of B (vva, cost_matrix, support_fg)."""
    b, s = support_images.shape[:2]
    images = torch.cat([support_images.reshape((b * s,) + support_images.shape[2:]),
                        query_images])
    out = dinov2.forward_features(params, _norm(images), model_cfg,
                                  attn_tap_last_n=cfg.attn_tap_last_n, tap_from=b * s)
    feats = dinov2.patch_features(out, model_cfg.num_register_tokens).float()
    feats = feats.reshape(b * s + b, -1, feats.shape[-1])
    sup = feats[:b * s].reshape(b, -1, feats.shape[-1])  # (B, S*L, D)
    s_mat = sup @ feats[b * s:].transpose(1, 2)  # (B, S*L, L)
    return [_prior(s_mat[i], support_masks[i], support_valid[i], out["attn_mean"][i], cfg)
            for i in range(b)]


def _prior(s_mat, support_masks, support_valid, attn_mean, cfg: VVAConfig):
    """The prior, the cost and the footprint from the similarity matrix."""
    g = cfg.grid
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
    refined = pir.refine(vva, attn_mean, cfg.refinement_box_threshold)
    refined = (refined - refined.min()) / (1e-7 + refined.max() - refined.min())
    return refined, cost, fg
