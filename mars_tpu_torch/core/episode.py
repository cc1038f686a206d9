"""Fixed-shape episode containers (port of ``mars_tpu/core/episode.py``).

Images are NHWC float tensors at one episode resolution, the shot
dimension is padded with a validity mask, and proposals are padded to a
bucket with a validity mask, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Episode(NamedTuple):
    """One few-shot segmentation episode.

    Shapes:
      support_images: (S, H, W, 3) float32 in [0, 1].
      support_masks:  (S, H, W)    float32 in {0, 1}.
      support_valid:  (S,)         bool, True for real shots.
      query_image:    (H, W, 3)
      class_id:       int (dataset class id; -1 if unknown).
    """

    support_images: torch.Tensor
    support_masks: torch.Tensor
    support_valid: torch.Tensor
    query_image: torch.Tensor
    class_id: int
    # the support masks (S, H, W) and shot validity (S,) as host numpy, when
    # the episode was built from the host (``data.base.episode_from_host``):
    # counts the ranking needs are then read without a device round trip
    support_host: Optional[Tuple[np.ndarray, np.ndarray]] = None


class Proposals(NamedTuple):
    """A fixed-size bucket of candidate masks for one query image.

    ``n_live``: the live count where the host knows it without reading
    ``valid`` back from the device (a stack built on the host, every row
    live); None otherwise."""

    masks: torch.Tensor  # (P, H, W) float32 in {0, 1}
    valid: torch.Tensor  # (P,) bool
    n_live: Optional[int] = None


def live_count(proposals: Proposals) -> int:
    """The live count: ``n_live`` if known, else read from the device (a
    synchronisation)."""
    if proposals.n_live is not None:
        return proposals.n_live
    return int(proposals.valid.sum())


def pad_proposals(masks: torch.Tensor, bucket: int,
                  valid: Optional[torch.Tensor] = None) -> Proposals:
    """Pad or truncate an (N, H, W) mask stack to a static bucket size.

    ``valid``: optional (N,) bool marking live rows; defaults to all-live,
    and then the live count is known on the host (``n_live``).
    """
    n, h, w = masks.shape
    n_live = None
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=masks.device)
        n_live = min(n, bucket)
    if n >= bucket:
        out, valid = masks[:bucket], valid[:bucket]
    else:
        out = torch.cat([masks, masks.new_zeros((bucket - n, h, w))])
        valid = torch.cat([valid, valid.new_zeros((bucket - n,))])
    return Proposals(masks=out.float(), valid=valid, n_live=n_live)
