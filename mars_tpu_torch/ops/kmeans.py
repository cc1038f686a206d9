"""k-means++ on the device (port of ``mars_tpu/ops/kmeans.py``).

The reference's torch k-means++ (matcher/k_means.py:17-57) seeds by
D²-weighted multinomial draws, runs Lloyd iterations that keep an empty
cluster's old centre, and its caller reruns the whole thing while a cluster
ends up empty (matcher/Matcher.py:579-591).  As in the JAX package, the
rerun becomes reseed-on-empty inside the iteration: an empty cluster's
centre moves to the point farthest from every centre.

Each seeding draw is one categorical draw taken as Gumbel-max over
``log(w + 1e-30)``, the way ``jax.random.categorical`` takes it; the noise
is an argument (``gumbel``, (K, N): row 0 for the first centre, row i for
centre i), as the prompt sampler's is, so a test can feed the JAX key's
own noise.  Everything stays on the device: no host synchronisation.
"""
from __future__ import annotations

from typing import Optional

import torch

BIG = 1e30


def _sq_dists(pts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(dim=-1)  # (N, K)


def kmeans_pp(points: torch.Tensor, valid: torch.Tensor, num_centers: int,
              max_iters: int = 100, gumbel: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
    """points (N, D) float, valid (N,) bool → (centers (K, D) float32,
    assignment (N,) int32).

    With fewer valid points than K, surplus centres duplicate existing
    points (callers mask by ``min(K, n_points)``, as the reference does,
    matcher/Matcher.py:581).  ``gumbel`` (K, N): the seeding noise;
    otherwise drawn from ``generator``."""
    n, d = points.shape
    k = num_centers
    dev = points.device
    if gumbel is None:  # Gumbel(0, 1) = -log(Exp(1))
        gumbel = -torch.empty((k, n), device=dev).exponential_(generator=generator).log()
    gumbel = gumbel.to(device=dev, dtype=torch.float32)
    pts = torch.where(valid[:, None], points.float(), 0.0)
    ks = torch.arange(k, device=dev)

    # D² seeding (reference k_means.py:21-29); index_select with a
    # one-element index: a 0-d tensor index would read it on the host
    first = torch.argmax(gumbel[0] + torch.log(valid.float() + 1e-30))
    centers = torch.zeros((k, d), dtype=torch.float32, device=dev)
    centers[0] = pts.index_select(0, first.view(1))[0]
    for i in range(1, k):
        d2 = (_sq_dists(pts, centers) + torch.where(ks[None, :] < i, 0.0, BIG)).amin(dim=1)
        dist = torch.sqrt(d2) + 1e-6
        w = torch.where(valid, dist ** 2, 0.0)
        pick = torch.argmax(gumbel[i] + torch.log(w + 1e-30))
        centers[i] = pts.index_select(0, pick.view(1))[0]

    # Lloyd iterations with reseed-on-empty
    validf = valid[:, None].float()
    for _ in range(max_iters):
        d2 = torch.where(valid[:, None], _sq_dists(pts, centers), BIG)
        assign = torch.argmin(d2, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).float() * validf
        counts = onehot.sum(dim=0)
        sums = onehot.T @ pts
        new = torch.where(counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0),
                          centers)
        far = torch.argmax(torch.where(valid, d2.amin(dim=1), -BIG))
        centers = torch.where(counts[:, None] > 0, new, pts.index_select(0, far.view(1)))
    d2 = torch.where(valid[:, None], _sq_dists(pts, centers), BIG)
    return centers, torch.argmin(d2, dim=1).to(torch.int32)
