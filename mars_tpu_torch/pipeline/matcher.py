"""Matcher: bidirectional patch matching → prompt sampling → SAM proposals
(port of ``mars_tpu/pipeline/matcher.py``).

  - forward and reverse auction matching of support-mask patches against
    query patches (reference patch_level_matching :419-577), the top-half
    similarity filter, patch index → pixel-centre points;
  - RobustPromptSampler as fixed tables: every C(n, i) combination for
    n ≤ 8, Gumbel-top-k draws per size for n > 8 (reference :1226-1295);
  - negative priors (reference :304-417, :643-660): forward pairs whose
    reverse match left the support mask (``use_negative_priors_from_
    discarded``) and the most dissimilar pairs of a maximising auction on
    the cost matrix (``use_negative_priors_from_cost``), co-sampled as
    label-0 points beside each prompt set; ``merge_prompt_types`` also
    decodes the plain sets;
  - one SAM encode, one batched decode per prompt group (optionally with
    the matched points' box, ``use_box``, and a previous low-res mask as
    the cascade's ``target_mask_low_res``), NMS over all groups, per-mask
    purity, coverage and EMD scores, metric filters and the merge
    (reference :619-834), and the ranking bucket, best mask score first.

The decode always runs over the union of both prompt families' rows (the
inactive family is invalid in place, no host decision): the JAX package's
``fuse_programs=True``.  Its two-program flow (``False``: a host read of
the prompt count, then the active family's rows only) gives the same
bucket and merged mask and is not kept: the decode already skips dead
chunks, so it would save no work here.

Stages carry ``torch.profiler`` spans ``matcher.{features, match, encode,
decode, nms, score}``.  The prompts are the raw matched points
(``use_points_or_centers=True``, the default) or, with it False
(``cli_proposals --use-centers``), ``num_centers`` k-means++ centres of
them (``ops.kmeans``; reference :579-591), rounded to pixels.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from mars_tpu_torch.core import imaging
from mars_tpu_torch.core.episode import pad_proposals
from mars_tpu_torch.models import dinov2, sam
from mars_tpu_torch.ops import assignment, emd as emd_ops, kmeans
from mars_tpu_torch.pipeline import amg

NEG = -1e9


@dataclass(frozen=True)
class MatcherConfig:
    input_size: int = 518
    grid: int = 37
    patch_size: int = 14
    sample_range: Tuple[int, int] = (4, 6)
    max_sample_iterations: int = 30
    use_box: bool = False
    # negative priors (reference :304-417,643-660)
    use_negative_priors_from_discarded: bool = False
    use_negative_priors_from_cost: bool = False
    merge_prompt_types: bool = False
    # mask scoring (reference :719-720): score = α·emd + β·purity·coverage^exp
    alpha: float = 1.0
    beta: float = 0.0
    exp: float = 0.0
    # score_filter_cfg (reference build_matcher_oss :1341-1349)
    emd_filter: float = 0.0
    purity_filter: float = 0.02
    coverage_filter: float = 0.0
    use_score_filter: bool = True
    deep_score_filter: float = 0.33
    deep_score_norm_filter: float = 0.1
    topk_scores_threshold: float = 0.0
    num_merging_mask: int = 10
    emd_row_bucket: int = 1024
    emd_col_bucket: int = 512
    num_centers: int = 8
    use_points_or_centers: bool = True  # True → the raw matched points are the prompts


# ---------------------------------------------------------------------------
# bidirectional matching
# ---------------------------------------------------------------------------

def bidirectional_match(s_mat: torch.Tensor, support_fg: torch.Tensor):
    """Forward + reverse auction matching of an (R, L) support × query
    similarity matrix with an (R,) support footprint.

    Returns per-query-column (L,) tensors: matched_row (forward-matched
    support row or -1), pair_valid, retained (reverse match inside the
    support mask; everything matched when none is, reference :486-498),
    sim (similarity of the forward pair), retained_raw (before that
    fallback)."""
    r, l = s_mat.shape
    dev = s_mat.device
    if int(support_fg.sum()) <= l:
        # sparse bidders over the whole matrix: compact the valid rows
        cols = assignment.auction_assignment(s_mat, support_fg, row_chunk=128)  # (R,)
        matched_row = torch.full((l + 1,), -1, dtype=torch.int32, device=dev)
        matched_row[torch.where(cols >= 0, cols, l).long()] = torch.arange(
            r, dtype=torch.int32, device=dev)
        matched_row[l] = -1
        matched_row = matched_row[:l]
    else:
        # more masked rows than columns: solve the transposed problem
        st = torch.where(support_fg[None, :], s_mat.T, NEG)
        matched_row = assignment.auction_assignment(
            st, torch.ones((l,), dtype=torch.bool, device=dev))
    pair_valid = matched_row >= 0
    cols = torch.arange(l, device=dev)
    sim = torch.where(pair_valid, s_mat[matched_row.clamp(0, r - 1).long(), cols], NEG)
    # reverse: matched query columns compete for support patches
    rev = assignment.auction_assignment(s_mat.T, pair_valid, row_chunk=128)  # (L,)
    retained_raw = pair_valid & support_fg[rev.clamp(0, r - 1).long()] & (rev >= 0)
    retained = torch.where(retained_raw.any(), retained_raw, pair_valid)
    return matched_row, pair_valid, retained, sim, retained_raw


def _patch_centres(l: int, cfg: MatcherConfig, device) -> torch.Tensor:
    j = torch.arange(l, device=device)
    x = (j % cfg.grid) * cfg.patch_size + cfg.patch_size // 2
    y = (j // cfg.grid) * cfg.patch_size + cfg.patch_size // 2
    return torch.stack([x, y], dim=-1).float()


def prompt_points(points, point_valid, cfg: MatcherConfig,
                  generator: Optional[torch.Generator] = None,
                  kmeans_gumbel: Optional[torch.Tensor] = None):
    """The sampler's points: the matched points themselves, or (with
    ``use_points_or_centers`` False) their ``num_centers`` k-means++
    centres, rounded, the first min(n, K) valid, padded to the points'
    (L,) layout (JAX ``_match_stage``).  ``kmeans_gumbel`` (K, L): the
    seeding noise, else drawn from ``generator``."""
    if cfg.use_points_or_centers:
        return points, point_valid
    k, l = cfg.num_centers, points.shape[0]
    centers, _ = kmeans.kmeans_pp(points, point_valid, k, gumbel=kmeans_gumbel,
                                  generator=generator)
    c_valid = torch.arange(k, device=points.device) < torch.clamp(point_valid.sum(), max=k)
    return (torch.nn.functional.pad(torch.round(centers), (0, 0, 0, l - k)),
            torch.nn.functional.pad(c_valid, (0, l - k)))


def _better_half(selected, key):
    """``selected`` (L,) kept where its rank by ``key`` ascending (stable,
    the unselected last) is inside the better half when more than 40 are
    selected, else all of them (reference :505-508)."""
    l = selected.shape[0]
    n = selected.sum()
    reduced = torch.where(n > 40, n // 2, n)
    order = torch.argsort(torch.where(selected, key, float("inf")), stable=True)
    rank = torch.empty((l,), dtype=torch.int64, device=selected.device)
    rank[order] = torch.arange(l, device=selected.device)
    return selected & (rank < reduced)


def matched_points(s_mat, support_fg, cfg: MatcherConfig, match=None):
    """Matching → pixel-centre points (L, 2) and validity (L,), after the
    top-half similarity filter (reference :505-508).  ``match``: the
    ``bidirectional_match`` of these inputs, when already made."""
    l = s_mat.shape[1]
    _, _, retained, sim, _ = match if match is not None else bidirectional_match(s_mat,
                                                                                  support_fg)
    return _patch_centres(l, cfg, s_mat.device), _better_half(retained, -sim)


def negative_points_from_discarded(s_mat, support_fg, cfg: MatcherConfig, match=None):
    """Negative priors: forward pairs whose reverse match fell outside the
    support mask (before the all-discarded fallback), the least similar
    half of them when more than 40 (reference
    sample_negative_points_from_discarded :304-348) → (points (L, 2),
    valid (L,)).  ``match``: the positives' ``bidirectional_match`` of the
    same inputs, reused instead of solved again."""
    l = s_mat.shape[1]
    _, pair_valid, _, sim, retained_raw = (match if match is not None
                                           else bidirectional_match(s_mat, support_fg))
    return _patch_centres(l, cfg, s_mat.device), _better_half(pair_valid & ~retained_raw, sim)


def negative_points_from_cost(cost, support_fg, cfg: MatcherConfig):
    """Negative priors from maximising the cost matrix (reference
    sample_negative_points_from_cost :350-417) → (points (L, 2), valid
    (L,)): the forward auction over every row in 5 ε-phases (on ``cost.T``
    when R > L, the side that can assign fully), then the most dissimilar
    half of the matched set.  The JAX package's source also solves a
    reverse auction over the matched columns (mars_tpu/pipeline/
    matcher.py:207-209) whose result reaches no output, so its compiled
    program drops it (the top half is taken over the full matched set,
    :210-217); it is not run here."""
    r, l = cost.shape
    dev = cost.device
    if r <= l:
        cols = assignment.auction_assignment(cost, torch.ones((r,), dtype=torch.bool,
                                                              device=dev), n_phases=5)
        matched_row = torch.full((l + 1,), -1, dtype=torch.int32, device=dev)
        matched_row[torch.where(cols >= 0, cols, l).long()] = torch.arange(
            r, dtype=torch.int32, device=dev)
        matched_row = matched_row[:l]
    else:
        matched_row = assignment.auction_assignment(
            cost.T, torch.ones((l,), dtype=torch.bool, device=dev), n_phases=5)
    pair_valid = matched_row >= 0
    cost_f = torch.where(pair_valid, cost[matched_row.clamp(0, r - 1).long(),
                                          torch.arange(l, device=dev)], float("-inf"))
    return _patch_centres(l, cfg, dev), _better_half(pair_valid, -cost_f)


def co_sample_negatives(neg_points, neg_valid, cfg: MatcherConfig,
                        neg_gumbel: Optional[torch.Tensor] = None,
                        neg_cat_gumbel: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """As many label-0 points beside each prompt set as its size (reference
    :1243-1267): drawn without replacement when more than 8 negatives are
    valid, with replacement otherwise → (coords (B, K, 2), labels (B, K)),
    padded with label -1, rows of ``prompt_set_sizes``.

    ``neg_gumbel`` (B, L) is the noise of the draw without replacement
    (Gumbel-top-k), ``neg_cat_gumbel`` (B, K, L) that of the K categorical
    draws with replacement (argmax of noise + log-weights, as
    ``jax.random.categorical`` with ``shape=(K,)``); else both are standard
    Gumbel noise from ``generator``."""
    sizes = torch.from_numpy(prompt_set_sizes(cfg)).to(neg_points.device)
    b, k, l = sizes.shape[0], cfg.sample_range[1], neg_points.shape[0]
    dev = neg_points.device
    n_neg = neg_valid.sum()
    pts_c = neg_points[torch.argsort((~neg_valid).to(torch.int32), stable=True)]
    if neg_gumbel is None:
        neg_gumbel = -torch.empty((b, l), device=dev).exponential_(generator=generator).log()
    if neg_cat_gumbel is None:
        neg_cat_gumbel = -torch.empty((b, k, l), device=dev).exponential_(
            generator=generator).log()
    live = torch.arange(l, device=dev) < n_neg
    without = torch.argsort(-torch.where(live[None, :], neg_gumbel.to(dev).float(),
                                         float("-inf")), dim=1, stable=True)[:, :k]
    with_repl = torch.argmax(neg_cat_gumbel.to(dev).float()
                             + torch.where(live, 0.0, float("-inf")), dim=-1)
    idx = torch.where(n_neg > 8, without, with_repl)
    in_set = torch.arange(k, device=dev)[None, :] < sizes[:, None]
    coords = torch.where(in_set[..., None], pts_c[idx], 0.0)
    labels = torch.where(in_set & (n_neg > 0), 0, -1).to(torch.int32)
    return coords, labels


# ---------------------------------------------------------------------------
# prompt sampling
# ---------------------------------------------------------------------------

def _combination_tables(max_n: int, sizes) -> Tuple[np.ndarray, np.ndarray]:
    """(n_sets, max_size) index table of all C(max_n, i), i in sizes,
    padded with -1, and the per-set sizes."""
    max_size = max(sizes)
    rows, szs = [], []
    for i in sizes:
        for combo in itertools.combinations(range(max_n), i):
            rows.append(list(combo) + [-1] * (max_size - i))
            szs.append(i)
    return np.asarray(rows, np.int32), np.asarray(szs, np.int32)


def prompt_set_sizes(cfg: MatcherConfig) -> np.ndarray:
    """Per-row prompt-set sizes of sample_prompt_sets' layout: the
    combinations family (sizes 1..hi over 8 slots), then the draw family
    (max_iterations rows per size lo..hi)."""
    lo, hi = cfg.sample_range
    _, tsizes = _combination_tables(8, tuple(range(1, hi + 1)))
    draw_sizes = np.repeat(np.arange(lo, hi + 1), cfg.max_sample_iterations)
    return np.concatenate([tsizes, draw_sizes]).astype(np.int32)


def prompt_family_rows(cfg: MatcherConfig):
    """(combo_rows, draw_rows): row ranges of the two prompt families."""
    lo, hi = cfg.sample_range
    _, tsizes = _combination_tables(8, tuple(range(1, hi + 1)))
    nc = len(tsizes)
    return np.arange(nc), nc + np.arange((hi - lo + 1) * cfg.max_sample_iterations)


def union_family_rows(cfg: MatcherConfig):
    """Both families' rows as one tuple: sample_prompt_sets gates each
    family's validity by n, so decoding the union is exact with no host
    decision."""
    combo, draw = prompt_family_rows(cfg)
    return tuple(np.concatenate([combo, draw]).tolist())


def sample_prompt_sets(points, point_valid, cfg: MatcherConfig,
                       generator: Optional[torch.Generator] = None,
                       gumbel: Optional[torch.Tensor] = None):
    """RobustPromptSampler as fixed tables → (coords (B, K, 2), labels
    (B, K), set_valid (B,)), K = sample_range[1], row sizes
    ``prompt_set_sizes``.  The combinations of the first min(8, n)
    compacted points are live when n ≤ 8; the Gumbel-top-k draws when
    n > 8.  ``gumbel`` (D, L): the draws' noise (tests pass the JAX
    package's); otherwise standard Gumbel noise from ``generator``."""
    lo, hi = cfg.sample_range
    k = hi
    dev = points.device
    n = point_valid.sum()
    l = points.shape[0]
    # valid points first, in column order
    pts_c = points[torch.argsort((~point_valid).to(torch.int32), stable=True)]

    table, tsizes = (torch.from_numpy(a).to(dev) for a in
                     _combination_tables(8, tuple(range(1, hi + 1))))
    combo_ok = ((tsizes >= torch.clamp(n, max=lo)) & (tsizes <= torch.clamp(n, max=hi))
                & ((table < n) | (table < 0)).all(dim=1) & (n <= 8) & (n > 0))
    combo_coords = torch.where((table >= 0)[..., None], pts_c[table.clamp(0, l - 1).long()], 0.0)
    combo_labels = torch.where(table >= 0, 1, -1)
    pad = k - table.shape[1]
    if pad > 0:
        combo_coords = torch.nn.functional.pad(combo_coords, (0, 0, 0, pad))
        combo_labels = torch.nn.functional.pad(combo_labels, (0, pad), value=-1)

    draw_sizes = torch.arange(lo, hi + 1, device=dev).repeat_interleave(
        cfg.max_sample_iterations)
    d = draw_sizes.shape[0]
    if gumbel is None:  # Gumbel(0, 1) = -log(Exp(1))
        gumbel = -torch.empty((d, l), device=dev).exponential_(generator=generator).log()
    gumbel = torch.where(torch.arange(l, device=dev)[None, :] < n, gumbel.to(dev).float(),
                         float("-inf"))
    topk_idx = torch.argsort(-gumbel, dim=1, stable=True)[:, :k]
    in_set = torch.arange(k, device=dev)[None, :] < draw_sizes[:, None]
    draw_coords = torch.where(in_set[..., None], pts_c[topk_idx], 0.0)
    draw_labels = torch.where(in_set, 1, -1)
    draw_ok = torch.ones((d,), dtype=torch.bool, device=dev) & (n > 8)

    coords = torch.cat([combo_coords, draw_coords])
    labels = torch.cat([combo_labels, draw_labels]).to(torch.int32)
    return coords, labels, torch.cat([combo_ok, draw_ok])


# ---------------------------------------------------------------------------
# mask scoring + merge
# ---------------------------------------------------------------------------

def score_masks(masks, mask_valid, points, point_valid, support_fg, cost, cfg: MatcherConfig):
    """purity, coverage and EMD of every mask at once (reference
    get_mask_scores :1152-1210) → (emd_score, purity, coverage), each (N,)."""
    pooled = imaging.pool_mask_to_grid(masks, cfg.grid) > 0  # (N, g, g)
    # an empty pooled footprint becomes the FULL grid (the reference's
    # threshold trick, :1181-1185), so its EMD is the whole-image cost
    mask_empty = ~pooled.any(dim=(1, 2))
    pooled_for_emd = pooled | mask_empty[:, None, None]
    emd = emd_ops.batched_emd(cost, support_fg, pooled_for_emd.reshape(masks.shape[0], -1),
                              cfg.emd_row_bucket, cfg.emd_col_bucket, col_valid=mask_valid)
    xi = points[:, 0].long().clamp(0, masks.shape[2] - 1)
    yi = points[:, 1].long().clamp(0, masks.shape[1] - 1)
    pts_in = (masks[:, yi, xi] & point_valid[None, :]).sum(dim=1).float()
    n_pts = torch.clamp(point_valid.sum(), min=1).float()
    area = torch.clamp(pooled.sum(dim=(1, 2)).float(), min=1.0)
    return 1.0 - emd, pts_in / area + 1e-6, pts_in / n_pts + 1e-6


def filter_and_merge(masks, valid, emd_score, purity, coverage, cfg: MatcherConfig):
    """Metric filters + score-based merge (reference :731-833) →
    (merged (H, W) float, final_score (), chosen (N,))."""
    score = cfg.alpha * emd_score + cfg.beta * purity * coverage ** cfg.exp
    keep = valid
    for metric, thr in ((coverage, cfg.coverage_filter), (emd_score, cfg.emd_filter),
                        (purity, cfg.purity_filter)):
        if thr > 0:
            mmax = torch.where(keep, metric, float("-inf")).max()
            keep = keep & (metric >= torch.clamp(mmax, max=thr))
    n = masks.shape[0]
    idx = torch.arange(n, device=masks.device)
    if cfg.use_score_filter:
        # distances = 1 - score ascending; keep those under the absolute and
        # the normalised threshold, always the best, at most num_merging_mask
        dist = torch.where(keep, 1.0 - score, float("inf"))
        order = torch.argsort(dist, stable=True)
        dist_sorted = dist[order]
        dmax = torch.where(keep, 1.0 - score, float("-inf")).max()
        dnorm = (dist_sorted - dist_sorted[0]) / (dmax + 1e-6)
        sel = dist_sorted < cfg.deep_score_filter
        sel[0] = keep[order[0]]
        sel = (sel & (dnorm < cfg.deep_score_norm_filter) & (idx < cfg.num_merging_mask)
               & (dist_sorted < float("inf")))
        chosen = torch.zeros((n,), dtype=torch.bool, device=masks.device)
        chosen[order] = sel
        eff = score
    else:  # top-k path (reference :788-832)
        order = torch.argsort(-torch.where(keep, score, float("-inf")), stable=True)
        in_topk = torch.zeros((n,), dtype=torch.bool, device=masks.device)
        in_topk[order[:cfg.num_merging_mask]] = True
        in_topk = in_topk & keep
        eff = score
        if cfg.topk_scores_threshold > 0:
            # the reference reassigns the scores to score / max (:797-799)
            eff = score / torch.where(in_topk, score, float("-inf")).max()
        chosen = in_topk & (eff > cfg.topk_scores_threshold)
    merged = (masks & chosen[:, None, None]).any(dim=0)
    final = torch.where(chosen, eff, 0.0).sum() / torch.clamp(chosen.sum(), min=1)
    return merged.float(), final, chosen


# ---------------------------------------------------------------------------
# end-to-end proposal generation
# ---------------------------------------------------------------------------

def _features_and_matrices(dino_params, support_images, support_masks, support_valid,
                           query_image, dino_cfg, grid: int):
    """DINOv2 features → similarity (S·L, L), cost (1 - S) / 2 and the
    pooled support footprint (reference extract_img_feats :251-302, the
    empty-support fallback :141-154, avg-pool > 0 :173-180)."""
    h, w = support_masks.shape[-2:]
    square = torch.zeros_like(support_masks)
    square[..., h // 2 - 7:h // 2 + 7, w // 2 - 7:w // 2 + 7] = 1.0
    support_masks = torch.where(support_masks.sum() == 0, square, support_masks)

    def norm(im):
        return imaging.normalize(im, imaging.IMAGENET_MEAN, imaging.IMAGENET_STD)

    out_s = dinov2.forward_features(dino_params, norm(support_images), dino_cfg)
    out_q = dinov2.forward_features(dino_params, norm(query_image)[None], dino_cfg)
    sup = dinov2.patch_features(out_s, dino_cfg.num_register_tokens).float()
    qry = dinov2.patch_features(out_q, dino_cfg.num_register_tokens).float()
    s_mat = sup @ qry.T
    pooled = (imaging.pool_mask_to_grid(support_masks, grid) > 0) & support_valid[:, None, None]
    return s_mat, (1.0 - s_mat) / 2.0, pooled.reshape(-1)


def _prompt_groups(coords, labels, s_mat, cost, support_fg, match, cfg: MatcherConfig,
                   generator, neg_noise):
    """The decode's prompt groups (JAX ``_propose_stage``): the positive
    sets alone, or one group per negative source (positive and co-sampled
    negative points along K) plus, with ``merge_prompt_types``, the
    positive sets → [(coords, labels)]."""
    sources = []
    if cfg.use_negative_priors_from_discarded:
        sources.append(negative_points_from_discarded(s_mat, support_fg, cfg, match))
    if cfg.use_negative_priors_from_cost:
        sources.append(negative_points_from_cost(cost, support_fg, cfg))
    if not sources:
        return [(coords, labels)]
    groups = []
    for si, (neg_pts, neg_valid) in enumerate(sources):
        noise = neg_noise[si] if neg_noise is not None else (None, None)
        ncoords, nlabels = co_sample_negatives(neg_pts, neg_valid, cfg, *noise,
                                               generator=generator)
        groups.append((torch.cat([coords, ncoords], dim=1), torch.cat([labels, nlabels], dim=1)))
    if cfg.merge_prompt_types:
        groups.append((coords, labels))
    return groups


def _points_box(points, point_valid, cfg: MatcherConfig):
    """The matched points' XYXY box clipped to the image (JAX
    ``_propose_stage``; infinite when no point is valid)."""
    inf = float("inf")
    x, y = points[:, 0], points[:, 1]
    return torch.stack([
        torch.clamp(torch.where(point_valid, x, inf).min(), min=0),
        torch.clamp(torch.where(point_valid, y, inf).min(), min=0),
        torch.clamp(torch.where(point_valid, x, -inf).max(), max=cfg.input_size - 1),
        torch.clamp(torch.where(point_valid, y, -inf).max(), max=cfg.input_size - 1)])


def generate_proposals(dino_params, dino_cfg: dinov2.DinoV2Config, sam_params,
                       sam_cfg: sam.SamConfig, amg_cfg: amg.AmgConfig, cfg: MatcherConfig,
                       support_images, support_masks, support_valid, query_image,
                       generator: Optional[torch.Generator] = None,
                       bucket: Optional[int] = None,
                       gumbel: Optional[torch.Tensor] = None,
                       kmeans_gumbel: Optional[torch.Tensor] = None,
                       target_mask_low_res: Optional[torch.Tensor] = None,
                       neg_noise: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None
                       ) -> dict:
    """The Matcher flow (reference Matcher.predict :216-249).

    support_images (S, H, W, 3) in [0, 1], support_masks (S, H, W),
    support_valid (S,), query_image (H, W, 3).  ``generator`` draws the
    noise, in this order: the k-means seeding's with centres (or pass
    ``kmeans_gumbel``), the prompt sampler's (or ``gumbel``), then each
    negative source's co-sampling (or ``neg_noise``: one (neg_gumbel,
    neg_cat_gumbel) pair per active source, discarded first, see
    ``co_sample_negatives``).  ``target_mask_low_res`` (4G, 4G): a previous
    low-res mask, the cascade's mask input to every decode.  The decode
    runs over the union of both families' rows.  ``bucket``: also return the
    ranking bucket ("bucket_masks", "bucket_valid": live rows first, best
    mask score first).  Returns proposal masks (N, H, W) bool and
    validity, their scores, the merged mask, the cost matrix and the
    support footprint."""
    with record_function("matcher.features"):
        s_mat, cost, support_fg = _features_and_matrices(
            dino_params, support_images, support_masks, support_valid, query_image,
            dino_cfg, cfg.grid)
    with record_function("matcher.match"):
        match = bidirectional_match(s_mat, support_fg)
        points, point_valid = matched_points(s_mat, support_fg, cfg, match)
        prompt_pts, prompt_valid = prompt_points(points, point_valid, cfg, generator,
                                                 kmeans_gumbel)
        rows = torch.tensor(union_family_rows(cfg), device=s_mat.device)
        coords, labels, set_valid = sample_prompt_sets(prompt_pts, prompt_valid, cfg,
                                                       generator=generator, gumbel=gumbel)
        groups = _prompt_groups(coords, labels, s_mat, cost, support_fg, match, cfg, generator,
                                neg_noise)
        box = _points_box(points, point_valid, cfg) if cfg.use_box else None
    with record_function("matcher.encode"):
        embedding = amg.encode_target(sam_params, query_image, sam_cfg)
    with record_function("matcher.decode"):
        dec = amg.concat_decodes([amg.decode_prompt_sets(
            sam_params, embedding, gcoords[rows], glabels[rows], set_valid[rows], sam_cfg,
            amg_cfg, original_size=(cfg.input_size, cfg.input_size), box=box,
            mask_input=target_mask_low_res) for gcoords, glabels in groups])
    n_decoded = dec["valid"].sum()  # live masks before NMS
    with record_function("matcher.nms"):
        dec = amg.nms_filter(dec, amg_cfg.box_nms_thresh)
    with record_function("matcher.score"):
        emd_score, purity, coverage = score_masks(dec["masks"], dec["valid"], points,
                                                  point_valid, support_fg, cost, cfg)
        merged, final_score, chosen = filter_and_merge(dec["masks"], dec["valid"], emd_score,
                                                       purity, coverage, cfg)
        mask_score = cfg.alpha * emd_score + cfg.beta * purity * coverage ** cfg.exp
        out = {}
        if bucket is not None:
            # live rows first, best mask score first: the decode layout
            # carries dead rows in place
            order = torch.argsort(torch.where(dec["valid"], -mask_score, float("inf")),
                                  stable=True)
            valid_o = dec["valid"][order]
            props = pad_proposals((dec["masks"][order] & valid_o[:, None, None]).float(),
                                  bucket, valid=valid_o)
            out["bucket_masks"], out["bucket_valid"] = props.masks, props.valid
        xi = points[:, 0].long().clamp(0, merged.shape[1] - 1)
        yi = points[:, 1].long().clamp(0, merged.shape[0] - 1)
        inside = (point_valid & (merged[yi, xi] > 0)).sum()
    return out | {
        "proposal_masks": dec["masks"], "proposal_valid": dec["valid"],
        "low_res_logits": dec["low_res_logits"], "iou": dec["iou"],
        "stability": dec["stability"], "emd_score": emd_score, "purity": purity,
        "coverage": coverage, "mask_score": mask_score, "merged": merged,
        "final_score": final_score, "chosen": chosen, "embedding": embedding,
        "cost_matrix": cost, "support_fg": support_fg, "points": points,
        "point_valid": point_valid, "prompt_pts": prompt_pts, "prompt_valid": prompt_valid,
        "telemetry": {"n_support_patches": support_fg.sum(),
                      "n_matched_points": point_valid.sum(),
                      "n_prompt_sets": set_valid.sum() * len(groups), "n_decoded": n_decoded,
                      "n_proposals": dec["valid"].sum(), "n_merged": chosen.sum(),
                      "positive_points_inside_mask": inside},
    }
