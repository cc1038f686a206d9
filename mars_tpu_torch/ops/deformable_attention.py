"""Multi-scale deformable attention, MSDA (port of
``mars_tpu/ops/deformable_attention.py``).

The Semantic-SAM pixel decoder is a MaskDINO encoder built on
MSDeformAttn, and its point decoder cross-attends the same way.  The JAX
package writes the op as a bilinear gather and a weighted sum (no Pallas
kernel: the op is gather-bound); here the gather is ``F.grid_sample``
(bilinear, zero padding, ``align_corners=False``: the JAX package's
``_bilinear_sample`` written out), in float32 whatever the tower's type.

``msda_layer`` keeps the JAX package's shared-value fold: with a batch-1
memory and a batched query (every click of a Matcher call against one
encoded image) the memory is projected once and the queries fold into its
query axis, so no per-click copy of the memory is made.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from mars_tpu_torch.models import layers as L


def msda_core(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
              sampling_locations: torch.Tensor, attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, L, H, D), L the sum of the level sizes in
    ``spatial_shapes`` order; sampling_locations (B, Q, H, levels, P, 2) xy
    in [0, 1]; attention_weights (B, Q, H, levels, P) → (B, Q, H·D) float32
    (the Deformable-DETR reference math)."""
    b, _, nh, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    grids = 2.0 * sampling_locations.float() - 1.0
    out, start = None, 0
    for lev, (hh, ww) in enumerate(spatial_shapes):
        v = value[:, start:start + hh * ww].float()
        start += hh * ww
        v = v.permute(0, 2, 3, 1).reshape(b * nh, d, hh, ww)
        g = grids[:, :, :, lev].permute(0, 2, 1, 3, 4).reshape(b * nh, q, p, 2)
        sampled = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # (BH, D, Q, P)
        wts = attention_weights[:, :, :, lev].float().permute(0, 2, 1, 3).reshape(
            b * nh, 1, q, p)
        term = (sampled * wts).sum(dim=-1)  # (BH, D, Q)
        out = term if out is None else out + term
    return out.reshape(b, nh, d, q).permute(0, 3, 1, 2).reshape(b, q, nh * d)


@functools.lru_cache(maxsize=None)
def _level_norm(spatial_shapes: Tuple[Tuple[int, int], ...], device) -> torch.Tensor:
    """(levels, 2) as (w, h), made once a device: a fresh copy to the card
    would synchronise its stream on every call."""
    return torch.tensor([[ww, hh] for hh, ww in spatial_shapes], dtype=torch.float32,
                        device=device)


def msda_layer(p, query: torch.Tensor, reference_points: torch.Tensor, value: torch.Tensor,
               spatial_shapes: Sequence[Tuple[int, int]], num_heads: int,
               num_points: int) -> torch.Tensor:
    """The MSDeformAttn layer (Deformable-DETR ``MSDeformAttn.forward``).

    query (B, Q, C); reference_points (B, Q, levels, 2) xy in [0, 1], or
    (..., 4) boxes (cx, cy, w, h) whose offsets scale with the box; value
    (B, L, C), or (1, L, C) shared by every query batch.  The softmax over
    levels × points runs in float32."""
    b, q, c = query.shape
    shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    nl = len(shapes)
    d = c // num_heads
    shared = value.shape[0] == 1 and b > 1
    v = L.dense(p["value_proj"], value).reshape(value.shape[0], -1, num_heads, d)
    off = L.dense(p["sampling_offsets"], query).reshape(b, q, num_heads, nl, num_points, 2)
    w = L.dense(p["attention_weights"], query).reshape(b, q, num_heads, nl * num_points)
    w = torch.softmax(w.float(), dim=-1).to(query.dtype)
    w = w.reshape(b, q, num_heads, nl, num_points)
    ref = reference_points.float()
    if ref.shape[-1] == 2:
        norm = _level_norm(shapes, query.device)
        loc = ref[:, :, None, :, None, :] + off.float() / norm[None, None, None, :, None, :]
    else:  # box reference: offsets scaled by box size / num_points
        loc = (ref[:, :, None, :, None, :2]
               + off.float() / num_points * ref[:, :, None, :, None, 2:] * 0.5)
    if shared:
        loc = loc.reshape(1, b * q, num_heads, nl, num_points, 2)
        w = w.reshape(1, b * q, num_heads, nl, num_points)
        out = msda_core(v, shapes, loc, w).reshape(b, q, c)
    else:
        out = msda_core(v, shapes, loc, w)
    return L.dense(p["output_proj"], out.to(query.dtype))


def msda_param_shapes(d_model: int, num_heads: int, num_levels: int, num_points: int) -> dict:
    """Keyed as ``mars_tpu.ops.deformable_attention.init_msda_params``."""
    def dense(do):
        return {"kernel": (d_model, do), "bias": (do,)}

    return {"value_proj": dense(d_model),
            "sampling_offsets": dense(num_heads * num_levels * num_points * 2),
            "attention_weights": dense(num_heads * num_levels * num_points),
            "output_proj": dense(d_model)}
