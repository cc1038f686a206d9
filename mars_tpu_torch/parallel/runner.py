"""Episode-batched and proposal-sharded ranking, and batched proposal
generation, over a ``parallel.mesh.Mesh`` (port of
``mars_tpu/parallel/runner.py``).

The JAX package vmaps the ranking over an episode batch and shards it over
the mesh's data axis with ``shard_map``.  Here each data rank holds its own
slice of the batch (``shard_batch``) and stacks it through the towers: one
DINOv2 pass over the B·S supports and B queries, one CLIP Grad-CAM pass
(one backward) over the B queries, AlphaCLIP over the B episodes' live
proposals packed in chunks; PIR, EMD and the score/merge tail run per
episode.  A real
model axis runs the towers tensor-parallel (``Mesh.tensor_parallel``); the
tap kernel then runs on the rank's local heads.  The JAX package's rule
that a model axis forces XLA attention (GSPMD cannot partition a Pallas
call) has no counterpart: a process runs its kernel on its own heads.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mars_tpu_torch.pipeline import filtering, vta as vta_m, vva as vva_m


def make_batched_ranker(dino_cfg, clip_vcfg, ac_vcfg, vva_cfg, vta_cfg, fm_cfg, mesh=None):
    """→ ranker(params_bundle, sup_i, sup_m, sup_v, qry, prop_m, prop_v,
    vta_text, ac_text, n_valid=None, n_rows=None) over a leading episode
    axis: the rank's local episodes (``shard_batch``).

    params_bundle: {"dino", "clip_v", "ac_v", "logit_scale"} (sliced by
    ``mesh.shard_params`` for a model axis); sup_i (B, S, H, W, 3), sup_m
    (B, S, H, W), sup_v (B, S), qry (B, H, W, 3), prop_m (B, P, H, W),
    prop_v (B, P), vta_text (B, T, Dc), ac_text (B, 1, Da).  ``n_valid``,
    ``n_rows``: per-episode live proposal and support-footprint counts
    where the host knows them.  Returns (merged (B, H, W), scores (B, P)).
    """
    g = vva_cfg.grid

    @torch.no_grad()
    def rank(params, sup_i, sup_m, sup_v, qry, prop_m, prop_v, vta_text, ac_text,
             n_valid: Optional[Sequence[int]] = None, n_rows: Optional[Sequence[int]] = None):
        b = qry.shape[0]
        if n_valid is None:
            n_valid = prop_v.sum(dim=1).tolist()
        with mesh.tensor_parallel() if mesh is not None else contextlib.nullcontext():
            vvas = vva_m.compute_batch(params["dino"], sup_i, sup_m, sup_v, qry, dino_cfg,
                                       vva_cfg)
            vtas = vta_m.compute_batch(params["clip_v"], qry, vta_text, params["logit_scale"],
                                       clip_vcfg, vta_cfg)
            ac = filtering.alphaclip_scores_batch(params["ac_v"], qry, prop_m, ac_text, ac_vcfg,
                                                  fm_cfg, prop_v, n_valid)
        merged, scores = [], []
        for i in range(b):
            vva_prior, cost, support_fg = vvas[i]
            m, s = filtering.score_and_merge_core(
                prop_m[i], prop_v[i], support_fg, cost, vva_prior,
                vta_m.scaled_to_grid(vtas[i], g), ac[i], fm_cfg, n_valid=n_valid[i],
                n_rows=None if n_rows is None else n_rows[i])
            merged.append(m)
            scores.append(s)
        return torch.stack(merged), torch.stack(scores)

    return rank


def shard_batch(batch_args, mesh):
    """The rank's slice of each per-episode-batched array (its data
    index's share of the leading axis), on its device."""
    out = []
    for x in batch_args:
        if x.shape[0] % mesh.n_data:
            raise ValueError(f"episode batch {x.shape[0]} not divisible by mesh axis 'data' "
                             f"of size {mesh.n_data}")
        k = x.shape[0] // mesh.n_data
        out.append(x[mesh.data_index * k:(mesh.data_index + 1) * k].to(mesh.device))
    return tuple(out)


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _masked_min_max_sharded(x, valid, group):
    """``imaging.masked_min_max_scale`` with the vector sharded over
    ``group``: the min and max reduce across ranks, the scaling stays
    local."""
    big = torch.finfo(x.dtype).max
    mn = _all_reduce(torch.where(valid, x, torch.full_like(x, big)).min(), dist.ReduceOp.MIN,
                     group)
    mx = _all_reduce(torch.where(valid, x, torch.full_like(x, -big)).max(), dist.ReduceOp.MAX,
                     group)
    return torch.where(valid, (x - mn) / (mx - mn + 1e-8), torch.zeros_like(x))


def make_proposal_parallel_ranker(dino_cfg, clip_vcfg, ac_vcfg, vva_cfg, vta_cfg, fm_cfg,
                                  mesh):
    """Single-episode ranking with the proposal bucket split over the data
    group: every rank runs the episode's towers (VVA, VTA), AlphaCLIP and
    EMD on its share of the rows, and the cross-proposal reductions of
    ``score_and_merge_core`` (the footprint union, the min-max bounds, the
    top score, the merged mask) become all-reduces (MAX, MIN).

    → rank(params_bundle, sup_i (S, H, W, 3), sup_m, sup_v, qry (H, W, 3),
    prop_m (P, H, W), prop_v (P,), vta_text (T, Dc), ac_text (1, Da)) with
    the whole bucket on every rank (P divisible by the data axis) →
    (merged (H, W), final scores (P,)), the same on every rank."""
    n, group = mesh.n_data, mesh.data_group
    g = vva_cfg.grid

    def any_reduce(m):
        return _all_reduce(m.to(torch.uint8), dist.ReduceOp.MAX, group) > 0

    @torch.no_grad()
    def rank(params, sup_i, sup_m, sup_v, qry, prop_m, prop_v, vta_text, ac_text):
        p = prop_m.shape[0]
        if p % n:
            raise ValueError(f"proposal bucket {p} not divisible by mesh axis 'data' of size {n}")
        k = p // n
        rows = slice(mesh.data_index * k, (mesh.data_index + 1) * k)
        local_m, local_v = prop_m[rows], prop_v[rows]
        with mesh.tensor_parallel():
            vva_prior, cost, support_fg = vva_m.compute(params["dino"], sup_i, sup_m, sup_v,
                                                        qry, dino_cfg, vva_cfg)
            vta_prior = vta_m.compute(params["clip_v"], qry, vta_text, params["logit_scale"],
                                      clip_vcfg, vta_cfg)
            ac = filtering.alphaclip_scores(params["ac_v"], qry, local_m, ac_text, ac_vcfg,
                                            fm_cfg, proposal_valid=local_v)
        merged, final = filtering.score_and_merge_core(
            local_m, local_v, support_fg, cost, vva_prior, vta_m.scaled_to_grid(vta_prior, g), ac, fm_cfg,
            any_reduce=any_reduce, minmax=lambda s, v: _masked_min_max_sharded(s, v, group),
            max_reduce=lambda x: _all_reduce(x, dist.ReduceOp.MAX, group))
        parts = [torch.empty_like(final) for _ in range(n)]
        dist.all_gather(parts, final.contiguous(), group=group)
        return merged, torch.cat(parts)

    return rank


def make_batched_proposal_generator(generate):
    """Episode-parallel proposal generation: each data rank runs the serial
    Matcher flow ``generate(episode, generator) -> Proposals``
    (``cli.make_inline_generator``) over its local episodes, each on its
    ``cli.episode_generator(seed, idx)`` stream.  The JAX package decodes
    both prompt families' rows for every episode because one SPMD program
    cannot branch per episode; a process can, so the buckets are the serial
    flow's own.

    → gen(episodes, generators) → (bucket_masks (B, P, H, W), bucket_valid
    (B, P))."""

    @torch.no_grad()
    def gen(episodes, generators):
        props = [generate(ep, generator) for ep, generator in zip(episodes, generators)]
        return torch.stack([p.masks for p in props]), torch.stack([p.valid for p in props])

    return gen
