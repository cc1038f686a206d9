"""Proposal scoring, filtering and merging (port of
``mars_tpu/pipeline/filtering.py``: ``alphaclip_scores``,
``score_and_merge_core``).

  - pvv/pvt = α·mean(prior under footprint) + (1-α)·coverage
  - EMD against the support footprint (ops.emd)
  - AlphaCLIP region ↔ text cosine over the live proposals
  - min-max scale EMD and AlphaCLIP over valid rows; final = mean of 4
  - merge = union of proposals above the static threshold, or above
    dynamic·top when the top score is below it
(reference FilteringMergingModule.py:104-132,183-221).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from mars_tpu_torch.core import imaging
from mars_tpu_torch.models import clip as clip_m
from mars_tpu_torch.ops import emd as emd_ops


@dataclass(frozen=True)
class FilterMergeConfig:
    alpha: float = 0.85  # --alpha_coverage
    static_threshold: float = 0.55
    dynamic_threshold: float = 0.95
    grid: int = 37
    alpha_clip_size: int = 336
    alpha_clip_batch: int = 16
    emd_row_bucket: int = 1024
    emd_col_bucket: int = 512


def alphaclip_scores(params, query_image: torch.Tensor, proposal_masks: torch.Tensor,
                     text_feats: torch.Tensor, model_cfg: clip_m.ClipVisualConfig,
                     cfg: FilterMergeConfig, proposal_valid: Optional[torch.Tensor] = None,
                     n_valid: Optional[int] = None) -> torch.Tensor:
    """Masked-region ↔ text cosine for every proposal (P,).

    Image resized bicubic (antialiased, jax.image) + CLIP norm; masks
    resized bilinear WITHOUT antialias (torchvision's tensor Resize) and
    normalized with mean 0.5 / std 0.26 (utils/backbone_loader.py:183-188).
    With ``proposal_valid``, valid rows are compacted to the front and only
    chunks of ``alpha_clip_batch`` that hold a valid row run the tower; the
    others score 0.  ``n_valid`` is the live count if the host knows it
    (else read from ``proposal_valid``, one sync).
    """
    s = cfg.alpha_clip_size
    img = imaging.resize(query_image, (s, s), "bicubic")
    img = imaging.normalize(img, imaging.CLIP_MEAN, imaging.CLIP_STD)
    p = proposal_masks.shape[0]
    nb = cfg.alpha_clip_batch
    order = None
    if proposal_valid is not None:
        order = torch.argsort((~proposal_valid).to(torch.int32), stable=True)
        masks_in = proposal_masks[order]
        if n_valid is None:
            n_valid = int(proposal_valid.sum())
    else:
        masks_in, n_valid = proposal_masks, p
    # chunks that start below n_valid run the tower; one chunk if p % nb
    step = nb if p % nb == 0 else p
    n_live = min(p, -(-n_valid // step) * step)
    feats = img.new_zeros((p, text_feats.shape[-1]), dtype=torch.float32)
    for start in range(0, n_live, step):
        stop = start + step
        alpha = imaging.resize(masks_in[start:stop, :, :, None], (s, s), "bilinear",
                               antialias=False)[..., 0]
        alpha = (alpha - 0.5) / 0.26
        imgs = img[None].expand((step,) + img.shape)
        emb = clip_m.visual_cls(params, imgs, model_cfg, alpha=alpha)
        feats[start:stop] = (emb / emb.norm(dim=-1, keepdim=True)).float()
    scores = feats @ text_feats[0].float()
    if order is None:
        return scores
    out = torch.empty_like(scores)
    out[order] = scores
    return out


def score_and_merge_core(proposal_masks, proposal_valid, support_fg, cost_matrix,
                         vva, vta, aclip_scores, cfg: FilterMergeConfig,
                         n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (merged mask (H, W) float {0,1}, final scores (P,))."""
    g = cfg.grid
    p = proposal_masks.shape[0]
    pooled = (imaging.pool_mask_to_grid(proposal_masks, g) > 0) & proposal_valid[:, None, None]
    union = pooled.any(dim=0)
    fp = pooled.reshape(p, -1).float()
    sizes = fp.sum(dim=1)
    coverage = sizes / (1e-7 + union.sum())
    pvv = cfg.alpha * (fp @ vva.reshape(-1) / (1e-7 + sizes)) + (1 - cfg.alpha) * coverage
    pvt = cfg.alpha * (fp @ vta.reshape(-1) / (1e-7 + sizes)) + (1 - cfg.alpha) * coverage

    emd = emd_ops.batched_emd(cost_matrix, support_fg, pooled.reshape(p, -1),
                              cfg.emd_row_bucket, cfg.emd_col_bucket,
                              col_valid=proposal_valid, n_valid=n_valid)
    emd_n = imaging.masked_min_max_scale(1.0 - emd, proposal_valid)
    ac_n = imaging.masked_min_max_scale(aclip_scores, proposal_valid)

    final = (emd_n + ac_n + pvv + pvt) / 4.0
    final = torch.where(proposal_valid, final, float("-inf"))
    top = final.max()
    thr = torch.where(top < cfg.static_threshold, cfg.dynamic_threshold * top,
                      torch.full_like(top, cfg.static_threshold))
    keep = proposal_valid & (final >= thr)
    merged = (proposal_masks.bool() & keep[:, None, None]).any(dim=0)
    return merged.float(), final
