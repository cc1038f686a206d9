"""The Matcher with a pluggable point predictor, Semantic-SAM style (port of
``mars_tpu/pipeline/matcher_oss.py``; reference
matcher/Matcher_SemanticSAM.py:28-385).

  - the main Matcher's DINOv2 bidirectional matching and top-half
    similarity filter (reference :188-243), optionally k-means++ centres
    (:245-258);
  - no negative priors, no AMG filters: each sampled prompt set goes to a
    point predictor that returns several masks a set (Semantic-SAM's 6
    granularities; SAM's 3 multimask layers through ``SamPointBackend``),
    reference :260-283;
  - the main Matcher's purity, coverage and EMD scores, metric filters and
    merge (:284-372), and the ranking bucket, best EMD score first.

Stages carry ``torch.profiler`` spans: ``matcher.features``,
``matcher.match``, then the backend's ``matcher.encode`` (once a query
image), ``matcher.decode`` and ``matcher.upsample``, then
``matcher.score``.
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple

import torch
from torch.profiler import record_function

from mars_tpu_torch.core import imaging
from mars_tpu_torch.models import dinov2, sam, semantic_sam as ss
from mars_tpu_torch.pipeline import amg
from mars_tpu_torch.pipeline import matcher as matcher_lib

UPSAMPLE_CHUNK = 64  # logit maps upsampled to the query frame at once


class PointPredictorBackend(Protocol):
    """A point-prompted mask predictor with several masks a prompt set:
    0-1 normalized click coordinates of the query frame, every prompt set
    in one call (reference Matcher_SemanticSAM.py:120-139, 266-276)."""

    masks_per_prompt: int

    def predict_batch(self, query_image01: torch.Tensor, coords01: torch.Tensor,
                      labels: torch.Tensor, set_valid: torch.Tensor,
                      original_size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """query_image01 (H, W, 3) in [0, 1], coords01 (B, K, 2) xy in
        [0, 1], labels (B, K) (-1 pads), set_valid (B,) → (masks (B·M, H, W)
        bool at ``original_size``, valid (B·M,))."""
        ...


class SamPointBackend:
    """SAM in Semantic-SAM's place: its 3 multimask layers are the
    granularities, with no IoU or stability gate (the variant scores with
    the Matcher's metrics only, reference :284-310)."""

    def __init__(self, params, model_cfg: sam.SamConfig, decode_batch: int = 32):
        self.params = params
        self.model_cfg = model_cfg
        self.amg_cfg = amg.AmgConfig(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0,
                                     sel_multimask_output=True, sel_output_layer=3,
                                     decode_batch=decode_batch)
        self.masks_per_prompt = 3
        self._embed_cache = None

    def predict_batch(self, query_image01, coords01, labels, set_valid, original_size):
        if self._embed_cache is None or self._embed_cache[0] is not query_image01:
            with record_function("matcher.encode"):
                self._embed_cache = (query_image01,
                                     amg.encode_target(self.params, query_image01,
                                                       self.model_cfg))
        scale = torch.tensor([original_size[1], original_size[0]], dtype=torch.float32)
        with record_function("matcher.decode"):
            out = amg.decode_prompt_sets(self.params, self._embed_cache[1],
                                         coords01 * scale.to(coords01.device), labels,
                                         set_valid, self.model_cfg, self.amg_cfg,
                                         original_size=original_size)
        return out["masks"], out["valid"]


class SemanticSamBackend:
    """The native Semantic-SAM network (``models/semantic_sam.py``) behind
    the protocol, as the reference reaches it through the external package
    (Matcher_SemanticSAM.py:118-139): the query bicubic-resized to
    ``cfg.input_size`` (``jax.image`` semantics, Keys A = -0.5), encoded
    once a query tensor; every click of every set decoded in one call; a
    set's masks are its live clicks' embeddings averaged, then one product
    with the mask features (``num_granularities`` masks a set), upsampled
    bilinearly to the query frame in chunks of ``UPSAMPLE_CHUNK`` and
    thresholded at 0."""

    def __init__(self, params, cfg: ss.SemanticSamConfig):
        self.params = params
        self.cfg = cfg
        self.masks_per_prompt = cfg.num_granularities
        self._embed_cache = None

    def encode(self, query_image01: torch.Tensor):
        """(memory, mask_feats) of the query, cached on the tensor's
        identity."""
        if self._embed_cache is None or self._embed_cache[0] is not query_image01:
            s = self.cfg.input_size
            with record_function("matcher.encode"):
                img = imaging.resize(query_image01, (s, s), "bicubic")
                img = imaging.normalize(img, imaging.IMAGENET_MEAN, imaging.IMAGENET_STD)
                self._embed_cache = (query_image01, ss.encode_image(self.params, img, self.cfg))
        return self._embed_cache[1]

    def set_logits(self, query_image01, coords01, labels, set_valid) -> torch.Tensor:
        """(B·G, H/4, W/4) mask logits at the network's resolution: each
        set's live clicks' embeddings averaged (the mask head is linear in
        the embedding), then one product with the mask features."""
        memory, mask_feats = self.encode(query_image01)
        cfg = self.cfg
        b, k, _ = coords01.shape
        g = cfg.num_granularities
        with record_function("matcher.decode"):
            emb, _ = ss.predict_points(self.params, memory, mask_feats,
                                       coords01.reshape(b * k, 2), cfg,
                                       ss.feature_shapes(cfg, cfg.input_size, cfg.input_size),
                                       return_embeddings=True)
            emb = emb.reshape(b, k, g, -1)
            live = ((labels == 1) & set_valid[:, None]).to(emb.dtype)
            denom = torch.clamp(live.sum(dim=1), min=1.0)  # (B,)
            emb = torch.einsum("bkgc,bk->bgc", emb, live) / denom[:, None, None]
            logits = torch.einsum("bgc,zhwc->bghw", emb, mask_feats)
        return logits.reshape(b * g, *logits.shape[-2:])

    def predict_batch(self, query_image01, coords01, labels, set_valid, original_size):
        logits = self.set_logits(query_image01, coords01, labels, set_valid)
        with record_function("matcher.upsample"):
            # the reference's F.interpolate(..., input_size, bilinear) > 0
            # (:269-276), jax.image semantics, a chunk at a time
            full = torch.empty((logits.shape[0], *original_size), dtype=torch.bool,
                               device=logits.device)
            for i in range(0, logits.shape[0], UPSAMPLE_CHUNK):
                chunk = logits[i:i + UPSAMPLE_CHUNK]
                full[i:i + UPSAMPLE_CHUNK] = imaging.interpolate_2d(
                    chunk, original_size, "bilinear") > 0.0
        return full, set_valid.repeat_interleave(self.cfg.num_granularities)


def generate_proposals_oss(dino_params, dino_cfg: dinov2.DinoV2Config,
                           backend: PointPredictorBackend, cfg: matcher_lib.MatcherConfig,
                           support_images, support_masks, support_valid, query_image,
                           generator: Optional[torch.Generator] = None,
                           bucket: Optional[int] = None,
                           gumbel: Optional[torch.Tensor] = None,
                           kmeans_gumbel: Optional[torch.Tensor] = None) -> dict:
    """Matcher_SemanticSAM.predict (reference :151-161) on ``backend``.

    ``generator`` draws the k-means seeding's noise when
    ``use_points_or_centers`` is False (or pass ``kmeans_gumbel`` (K, L)),
    then the prompt sampler's (or ``gumbel``).  ``bucket``: also return the
    ranking bucket ("bucket_masks", "bucket_valid": live rows first, best
    EMD score first).  Returns the proposal masks (B·M, H, W) and validity,
    their scores, the merged mask, the cost matrix, the support footprint
    and the prompt sets (``coords01``, ``labels``, ``set_valid``)."""
    with record_function("matcher.features"):
        s_mat, cost, support_fg = matcher_lib._features_and_matrices(
            dino_params, support_images, support_masks, support_valid, query_image,
            dino_cfg, cfg.grid)
    with record_function("matcher.match"):
        points, point_valid = matcher_lib.matched_points(s_mat, support_fg, cfg)
        prompt_pts, prompt_valid = matcher_lib.prompt_points(points, point_valid, cfg,
                                                             generator, kmeans_gumbel)
        coords, labels, set_valid = matcher_lib.sample_prompt_sets(
            prompt_pts, prompt_valid, cfg, generator=generator, gumbel=gumbel)
        # the reference divides the clicks by the input size (:265-268)
        hq, wq = query_image.shape[:2]
        coords01 = coords / torch.tensor([wq, hq], dtype=torch.float32).to(coords.device)
    masks, mask_valid = backend.predict_batch(query_image, coords01, labels, set_valid,
                                              (hq, wq))
    with record_function("matcher.score"):
        emd_score, purity, coverage = matcher_lib.score_masks(
            masks, mask_valid, points, point_valid, support_fg, cost, cfg)
        merged, final_score, chosen = matcher_lib.filter_and_merge(
            masks, mask_valid, emd_score, purity, coverage, cfg)
        out = {}
        if bucket is not None:
            props = matcher_lib.compact_bucket(masks, mask_valid, emd_score, bucket)
            out["bucket_masks"], out["bucket_valid"] = props.masks, props.valid
    return out | {
        "proposal_masks": masks, "proposal_valid": mask_valid, "emd_score": emd_score,
        "purity": purity, "coverage": coverage, "merged": merged,
        "final_score": final_score, "chosen": chosen, "cost": cost, "support_fg": support_fg,
        "coords01": coords01, "labels": labels, "set_valid": set_valid,
        "telemetry": {"n_matched_points": point_valid.sum(), "n_prompt_sets": set_valid.sum(),
                      "n_proposals": mask_valid.sum(), "n_merged": chosen.sum()},
    }
