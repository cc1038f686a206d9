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
from typing import Optional, Sequence, Tuple

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
    img = _clip_input(query_image, s)
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
        imgs = img[None].expand((step,) + img.shape)
        feats[start:stop] = _region_features(params, imgs, masks_in[start:stop], model_cfg, s)
    scores = feats @ text_feats[0].float()
    if order is None:
        return scores
    out = torch.empty_like(scores)
    out[order] = scores
    return out


def _clip_input(query_image: torch.Tensor, s: int) -> torch.Tensor:
    img = imaging.resize(query_image, (s, s), "bicubic")
    return imaging.normalize(img, imaging.CLIP_MEAN, imaging.CLIP_STD)


def _region_features(params, imgs, masks, model_cfg, s: int) -> torch.Tensor:
    """The unit-norm AlphaCLIP embeddings (N, D) of N (image, mask) rows."""
    alpha = imaging.resize(masks[:, :, :, None], (s, s), "bilinear", antialias=False)[..., 0]
    alpha = (alpha - 0.5) / 0.26
    emb = clip_m.visual_cls(params, imgs, model_cfg, alpha=alpha)
    return (emb / emb.norm(dim=-1, keepdim=True)).float()


def alphaclip_scores_batch(params, query_images: torch.Tensor, proposal_masks: torch.Tensor,
                           text_feats: torch.Tensor, model_cfg: clip_m.ClipVisualConfig,
                           cfg: FilterMergeConfig, proposal_valid: torch.Tensor,
                           n_valid: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``alphaclip_scores`` over B episodes: query_images (B, H, W, 3),
    proposal_masks (B, P, H, W), text_feats (B, 1, D), proposal_valid
    (B, P) → (B, P).  The live rows of every episode, packed in episode
    order, go through the tower in chunks of ``alpha_clip_batch``; dead
    rows score 0 (they reach no output of ``score_and_merge_core``).
    ``alphaclip_scores`` stays the one-episode path: it scores the dead
    rows of a live chunk as the JAX package does, which ``Mars``'s debug
    state is held to.  ``n_valid``: the episodes' live counts where the
    host knows them (else one sync)."""
    s = cfg.alpha_clip_size
    b, p = proposal_masks.shape[:2]
    dev = proposal_masks.device
    imgs = torch.stack([_clip_input(q, s) for q in query_images])
    if n_valid is None:
        n_valid = proposal_valid.sum(dim=1).tolist()
    order = torch.argsort((~proposal_valid).to(torch.int32), dim=1, stable=True)
    ep = torch.cat([torch.full((n,), i, dtype=torch.long) for i, n in enumerate(n_valid)]).to(dev)
    idx = torch.cat([order[i, :n] for i, n in enumerate(n_valid)])
    out = torch.zeros((b, p), dtype=torch.float32, device=dev)
    if ep.numel() == 0:
        return out
    masks = proposal_masks[ep, idx]
    nb = cfg.alpha_clip_batch
    feats = torch.cat([_region_features(params, imgs[ep[i:i + nb]], masks[i:i + nb], model_cfg, s)
                       for i in range(0, ep.numel(), nb)])
    out[ep, idx] = (feats * text_feats[ep, 0].float()).sum(dim=-1)
    return out


def score_and_merge_core(proposal_masks, proposal_valid, support_fg, cost_matrix,
                         vva, vta, aclip_scores, cfg: FilterMergeConfig,
                         n_valid: Optional[int] = None, n_rows: Optional[int] = None,
                         any_reduce=None, minmax=None, max_reduce=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (merged mask (H, W) float {0,1}, final scores (P,)).
    ``n_valid``, ``n_rows``: the live proposal and support-footprint counts
    where the host knows them (``ops.emd.batched_emd``).  The cross-proposal
    reductions can be swapped, as in the JAX package, so that the
    proposal-sharded ranker (``parallel.runner``) runs the same formulas
    over collectives: ``any_reduce`` for the footprint and merged-mask
    unions, ``minmax`` for the masked min-max scaling, ``max_reduce`` for
    the top score.  Without them, the single-device reductions."""
    g = cfg.grid
    p = proposal_masks.shape[0]
    if minmax is None:
        minmax = imaging.masked_min_max_scale
    pooled = (imaging.pool_mask_to_grid(proposal_masks, g) > 0) & proposal_valid[:, None, None]
    union = pooled.any(dim=0)
    if any_reduce is not None:
        union = any_reduce(union)
    fp = pooled.reshape(p, -1).float()
    sizes = fp.sum(dim=1)
    coverage = sizes / (1e-7 + union.sum())
    pvv = cfg.alpha * (fp @ vva.reshape(-1) / (1e-7 + sizes)) + (1 - cfg.alpha) * coverage
    pvt = cfg.alpha * (fp @ vta.reshape(-1) / (1e-7 + sizes)) + (1 - cfg.alpha) * coverage

    emd = emd_ops.batched_emd(cost_matrix, support_fg, pooled.reshape(p, -1),
                              cfg.emd_row_bucket, cfg.emd_col_bucket,
                              col_valid=proposal_valid, n_valid=n_valid, n_rows=n_rows)
    emd_n = minmax(1.0 - emd, proposal_valid)
    ac_n = minmax(aclip_scores, proposal_valid)

    final = (emd_n + ac_n + pvv + pvt) / 4.0
    final = torch.where(proposal_valid, final, float("-inf"))
    top = final.max()
    if max_reduce is not None:
        top = max_reduce(top)
    thr = torch.where(top < cfg.static_threshold, cfg.dynamic_threshold * top,
                      torch.full_like(top, cfg.static_threshold))
    keep = proposal_valid & (final >= thr)
    merged = (proposal_masks.bool() & keep[:, None, None]).any(dim=0)
    if any_reduce is not None:
        merged = any_reduce(merged)
    return merged.float(), final
