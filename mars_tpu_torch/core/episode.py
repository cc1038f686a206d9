"""Fixed-shape episode containers (port of ``mars_tpu/core/episode.py``).

Images are NHWC float tensors at one episode resolution, the shot
dimension is padded with a validity mask, and proposals are padded to a
bucket with a validity mask, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


class Proposals(NamedTuple):
    """A fixed-size bucket of candidate masks for one query image."""

    masks: torch.Tensor  # (P, H, W) float32 in {0, 1}
    valid: torch.Tensor  # (P,) bool


def pad_proposals(masks: torch.Tensor, bucket: int,
                  valid: Optional[torch.Tensor] = None) -> Proposals:
    """Pad or truncate an (N, H, W) mask stack to a static bucket size.

    ``valid``: optional (N,) bool marking live rows; defaults to all-live.
    """
    n, h, w = masks.shape
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=masks.device)
    if n >= bucket:
        out, valid = masks[:bucket], valid[:bucket]
    else:
        out = torch.cat([masks, masks.new_zeros((bucket - n, h, w))])
        valid = torch.cat([valid, valid.new_zeros((bucket - n,))])
    return Proposals(masks=out.float(), valid=valid)
