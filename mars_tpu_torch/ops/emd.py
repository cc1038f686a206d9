"""Batched earth-mover's distance with uniform marginals (port of
``mars_tpu/ops/emd.py``: ``compact_indices``, ``batched_emd``).

Every proposal is solved at once with an ε-annealed log-domain Sinkhorn
(eps 0.15 → 0.0025 over 10 + 20 + 40 + 90 iterations) over fixed-shape
compacted submatrices: support rows compacted once into a row bucket, each
proposal's columns into a column bucket.

In eager PyTorch the JAX package's two device conditionals become host
``if``s on counts:
  - the row ladder ({256, 512, row_bucket}) reads the live support-row
    count: one host sync per call (``int(rcount)``), unless the caller
    passes ``n_rows``, which the ranking path counts on the host from the
    episode's support masks;
  - the dead-chunk skip reads the live-proposal count: a second sync,
    unless the caller passes ``n_valid``, which the ranking path knows on
    the host from its padded bucket.
The live chunks of 16 are then solved together in one batch; proposals in
dead chunks get EMD 0, as the JAX package's skipped branch returns.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

NEG = -1e9


def compact_indices(mask: torch.Tensor, bucket: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Indices of up to ``bucket`` True entries of mask (..., n), stable,
    True first → (indices (..., bucket), valid (..., bucket), count (...))."""
    n = mask.shape[-1]
    bucket = min(bucket, n)
    order = torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)
    count = torch.clamp(mask.sum(dim=-1), max=bucket)
    valid = torch.arange(bucket, device=mask.device) < count[..., None]
    return order[..., :bucket], valid, count


def _sinkhorn_uniform(cost, row_valid, col_valid, eps_schedule, iters_schedule):
    """Log-domain Sinkhorn with uniform marginals on masked costs.
    cost (B, T, C), row_valid (T,), col_valid (B, C) → <P, C> (B,)."""
    nr = torch.clamp(row_valid.sum(), min=1).float()
    nc = torch.clamp(col_valid.sum(dim=-1), min=1).float()
    log_a = torch.where(row_valid, -torch.log(nr), torch.full_like(nr, NEG))  # (T,)
    log_b = torch.where(col_valid, -torch.log(nc)[:, None], torch.full_like(col_valid, NEG,
                                                                           dtype=torch.float32))
    both = row_valid[None, :, None] & col_valid[:, None, :]
    cmask = torch.where(both, 0.0, NEG)
    f = cost.new_zeros(cost.shape[:2])
    g = cost.new_zeros((cost.shape[0], cost.shape[2]))
    for eps, n_it in zip(eps_schedule, iters_schedule):
        mlogk = (-cost) / eps + cmask
        for _ in range(n_it):
            f = eps * (log_a - torch.logsumexp(mlogk + (g / eps)[:, None, :], dim=2))
            f = torch.where(row_valid, f, 0.0)
            g = eps * (log_b - torch.logsumexp(mlogk + (f / eps)[:, :, None], dim=1))
            g = torch.where(col_valid, g, 0.0)
    logp = (f[:, :, None] + g[:, None, :] - cost) / eps_schedule[-1] + cmask
    plan = torch.exp(torch.clamp(logp, -80.0, 80.0))
    return (plan * cost).sum(dim=(1, 2))


def batched_emd(cost_matrix: torch.Tensor, row_mask: torch.Tensor, col_masks: torch.Tensor,
                row_bucket: int = 1024, col_bucket: int = 512,
                eps_schedule: Sequence[float] = (0.15, 0.03, 0.008, 0.0025),
                iters_schedule: Sequence[int] = (10, 20, 40, 90),
                col_valid: Optional[torch.Tensor] = None, chunk: int = 16,
                n_valid: Optional[int] = None, n_rows: Optional[int] = None) -> torch.Tensor:
    """EMD of every proposal against the support footprint → (P,) float32.

    cost_matrix (R, L), rows = support patches; row_mask (R,) bool support
    footprint; col_masks (P, L) bool proposal footprints.  Empty footprints
    get EMD 0.  With ``col_valid`` (P,), valid proposals are compacted to
    the front and only chunks holding one are solved.  ``n_valid`` and
    ``n_rows``: the live proposal and support-row counts where the host
    knows them.
    """
    ridx, rvalid_full, rcount = compact_indices(row_mask, row_bucket)
    levels = [b for b in (256, 512) if b < row_bucket] + [row_bucket]
    # the row ladder: a host sync unless the caller knows the count
    live_rows = int(rcount) if n_rows is None else min(n_rows, ridx.shape[-1])
    t_rows = next(b for b in levels if live_rows <= b or b == levels[-1])
    sub_rows = cost_matrix[ridx[:t_rows]]  # (T, L)
    rvalid = rvalid_full[:t_rows]

    def solve(masks):
        cidx, cvalid, ccount = compact_indices(masks, col_bucket)
        sub = sub_rows[:, cidx].permute(1, 0, 2)  # (B, T, C)
        emd = _sinkhorn_uniform(sub, rvalid, cvalid, eps_schedule, iters_schedule)
        return torch.where(ccount > 0, emd, 0.0)

    p = col_masks.shape[0]
    if col_valid is None or p % chunk != 0:
        return solve(col_masks)
    order = torch.argsort((~col_valid).to(torch.int32), stable=True)
    if n_valid is None:
        n_valid = int(col_valid.sum())  # host sync: the dead-chunk skip
    n_live = -(-n_valid // chunk) * chunk
    emd_sorted = col_masks.new_zeros((p,), dtype=torch.float32)
    if n_live:
        emd_sorted[:n_live] = solve(col_masks[order[:n_live]])
    out = torch.empty_like(emd_sorted)
    out[order] = emd_sorted
    return out
