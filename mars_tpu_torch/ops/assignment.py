"""Linear assignment by the Jacobi auction with ε-scaling (port of
``mars_tpu/ops/assignment.py``: ``auction_assignment``, ``_auction_phase``,
``_auction_phase_pallas``).

Every unassigned valid row bids for its best column at once, each column
goes to its highest bidder (ties to the largest row index), prices rise by
at least ε.  One ε-phase runs the bidding loop to the end; phases carry
their prices (Bertsekas ε-scaling).

On a CUDA tensor each phase is ONE launch of the hand-written Hopper kernel
``csrc/auction.cu`` (the whole loop on one cluster of 8 CTAs, each a slice
of a small round's columns; its source note says what bounds it) or
raises; on a CPU tensor it is ``_auction_phase_plain``, a host loop of
vector rounds that mirrors the JAX package's XLA path (a dense
round, or a gather of the bidder rows when at most ``small_k`` rows bid).
The two are bit-exact, and the plain version is bit-exact with the JAX
package's ``auction_assignment(use_kernel=False)``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from mars_tpu_torch.ops import build

NEG = -1e9
SMALL_K = 16
_MAX_SHARED = 227 * 1024  # csrc/auction.cu MAX_SMEM; the kernel holds 16 (T + N) bytes
# and EXTRA_BYTES: the cluster's slice partials (2 rounds x 16 bidders x 8 CTAs
# x 16 bytes) and their two mbarriers, the warps' append counts, the list
# lengths
_EXTRA_SHARED = 2 * 16 * 8 * 16 + 16 + 4 * (16 + 2)
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 4)


def _auction_phase_plain(scores, row_valid, prices, eps, max_rounds: int,
                         small_k: Optional[int] = SMALL_K
                         ) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, int, int, int]]:
    """One ε-phase in plain PyTorch → (col_of_row (T,) int32, prices (N,),
    (dense rounds, small rounds, bidder rows in dense rounds, in small ones)).
    One host sync per round (the bidder count)."""
    t, n = scores.shape
    dev = scores.device
    rows = torch.arange(t, dtype=torch.int32, device=dev)
    col_of_row = torch.full((t,), -1, dtype=torch.int32, device=dev)
    prices = prices.clone()
    eps = torch.tensor(eps, dtype=torch.float32, device=dev)
    use_small = small_k is not None and t > small_k
    counts = [0, 0, 0, 0]

    def bids(idx):
        # the bidder rows' top-2: argmax takes the first column at the max
        values = scores[idx] - prices[None, :]
        j = torch.argmax(values, dim=1)
        v1 = values.gather(1, j[:, None])[:, 0]
        v2 = values.scatter(1, j[:, None], NEG).amax(dim=1)
        return j, prices[j] + (v1 - v2) + eps

    for rounds in range(max_rounds):
        bidding = (col_of_row < 0) & row_valid
        nb = int(bidding.sum())
        if nb == 0:
            break
        small = small_k is not None and nb <= small_k
        counts[int(small)] += 1
        counts[2 + int(small)] += nb
        if use_small and small:
            idx = torch.nonzero(bidding)[:, 0]
            j_full = torch.zeros((t,), dtype=torch.int64, device=dev)
            bid = torch.full((t,), NEG, dtype=torch.float32, device=dev)
            j_full[idx], bid[idx] = bids(idx)
        else:
            j_full, bid = bids(rows.long())
            bid = torch.where(bidding, bid, torch.full_like(bid, NEG))
        col_best = torch.full((n,), NEG, dtype=torch.float32, device=dev).scatter_reduce(
            0, j_full, bid, "amax")
        cb = col_best[j_full]
        is_cand = bidding & (bid >= cb) & (cb > NEG / 2)
        winner = torch.full((n + 1,), -1, dtype=torch.int32, device=dev).scatter_reduce(
            0, torch.where(is_cand, j_full, n), torch.where(is_cand, rows, -1), "amax")[:n]
        got_col = winner >= 0
        lost = (col_of_row >= 0) & got_col[col_of_row.clamp(0, n - 1).long()]
        col_of_row = torch.where(lost, -1, col_of_row)
        won = bidding & (winner[j_full] == rows)
        col_of_row = torch.where(won, j_full.to(torch.int32), col_of_row)
        prices = torch.where(got_col, col_best, prices)
    return col_of_row, prices, tuple(counts)


def _auction_phase_kernel(scores, row_valid, prices, eps, max_rounds: int,
                          small_k: Optional[int] = SMALL_K):
    """One ε-phase as one launch of ``csrc/auction.cu``; same returns as
    ``_auction_phase_plain`` (the counts come back through a host copy)."""
    t, n = scores.shape
    if scores.dtype != torch.float32 or prices.dtype != torch.float32:
        raise TypeError(f"scores and prices must be float32: {scores.dtype} {prices.dtype}")
    if row_valid.shape != (t,) or prices.shape != (n,):
        raise ValueError(f"row_valid {tuple(row_valid.shape)} / prices {tuple(prices.shape)} "
                         f"do not fit scores {tuple(scores.shape)}")
    if 16 * (t + n) + _EXTRA_SHARED > _MAX_SHARED:
        raise ValueError(f"auction of {t} x {n} exceeds the kernel's shared memory "
                         f"(T + N <= {(_MAX_SHARED - _EXTRA_SHARED) // 16})")
    scores = scores.contiguous()
    valid_u8 = row_valid.to(torch.uint8).contiguous()
    prices = prices.contiguous()
    fn = build.load("auction", {"mars_auction_phase": _ARGTYPES}).mars_auction_phase
    col = torch.empty((t,), dtype=torch.int32, device=scores.device)
    prices_out = torch.empty_like(prices)
    stats = torch.zeros((4,), dtype=torch.int32, device=scores.device)
    err = fn(scores.data_ptr(), valid_u8.data_ptr(), prices.data_ptr(), float(eps), t, n,
             int(max_rounds), -1 if small_k is None else int(small_k), col.data_ptr(),
             prices_out.data_ptr(), stats.data_ptr(),
             torch.cuda.current_stream(scores.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"auction kernel launch failed with CUDA error {err} ({t} x {n})")
    auction_assignment.launches += 1
    return col, prices_out, tuple(int(x) for x in stats.tolist())


def phase_inputs(scores: torch.Tensor, row_valid: torch.Tensor, n_phases: int = 1,
                 row_chunk: Optional[int] = None):
    """What ``auction_assignment`` hands its phases → (scores with invalid
    rows zeroed, row_valid, order or None, [ε of each phase]).

    ε = spread / max(2N, 5000) in float32 on the host (one IEEE division, as
    in JAX), times 5^(n_phases-1-i) in phase i.  With ``row_chunk``
    (sparse-valid instances, t > row_chunk) valid rows are compacted to the
    front, as the JAX package's XLA path does; ``order`` undoes it."""
    t, n = scores.shape
    scores = torch.where(row_valid[:, None], scores.float(), 0.0)
    spread = np.float32(torch.clamp(scores.max() - scores.min(), min=1e-6).item())
    eps_final = spread / np.float32(max(2.0 * n, 5000.0))
    eps = [float(eps_final * np.float32(5.0 ** (n_phases - 1 - i))) for i in range(n_phases)]
    order = None
    if row_chunk is not None and t > row_chunk:
        order = torch.argsort((~row_valid).to(torch.int32), stable=True)  # valid rows first
        scores, row_valid = scores[order], row_valid[order]
    return scores, row_valid, order, eps


def auction_assignment(scores: torch.Tensor, row_valid: torch.Tensor,
                       max_rounds: int = 20000, n_phases: int = 1,
                       row_chunk: Optional[int] = None, small_k: Optional[int] = SMALL_K,
                       stats: Optional[list] = None) -> torch.Tensor:
    """(T, N) similarity (maximise, T <= N), (T,) bool → col_of_row (T,)
    int32, -1 for invalid rows.

    Phases run on ``phase_inputs`` and carry their prices; rows still
    unassigned at the round cap are fixed up greedily.  ``row_chunk``:
    compact sparse valid rows first (bit-exact either way).  ``stats``: a
    list that receives each phase's round counts.
    ``auction_assignment.launches`` counts kernel launches.
    """
    t, n = scores.shape
    dev = scores.device
    scores, row_valid, order, eps = phase_inputs(scores, row_valid, n_phases, row_chunk)
    prices = torch.zeros((n,), dtype=torch.float32, device=dev)
    col_of_row = torch.full((t,), -1, dtype=torch.int32, device=dev)
    phase = _auction_phase_kernel if scores.is_cuda else _auction_phase_plain
    for eps_i in eps:
        col_of_row, prices, counts = phase(scores, row_valid, prices, eps_i, max_rounds, small_k)
        if stats is not None:
            stats.append(counts)

    if bool(((col_of_row < 0) & row_valid).any()):  # greedy fixup, rarely taken
        taken = torch.zeros((n,), dtype=torch.bool, device=dev)
        taken[col_of_row[col_of_row >= 0].long()] = True
        for i in range(t):
            if bool(row_valid[i]) and int(col_of_row[i]) < 0:
                j = torch.argmax(torch.where(taken, NEG, scores[i]))
                col_of_row[i] = j.to(torch.int32)
                taken[j] = True
    col_of_row = torch.where(row_valid, col_of_row, -1)
    if order is not None:
        out = torch.empty_like(col_of_row)
        out[order] = col_of_row
        col_of_row = out
    return col_of_row


auction_assignment.launches = 0
