"""Connected components, box union and small-region cleanup on tensors
(port of ``mars_tpu/ops/components.py``).

Replaces the reference's cv2 round trip (threshold → findContours →
boundingRect → paint boxes, PriorInformationRefinementModule.py:91-122):
  1. min-label propagation with pointer jumping, exactly 20 rounds as in
     the JAX package (the contract on the 33² and 37² grids);
  2. per-component bounding boxes by scatter-min/max (``scatter_reduce``);
  3. the union of the boxes, with cv2's edge clamp.
"""
from __future__ import annotations

import torch


def _neighbor_min(lab: torch.Tensor, big: int) -> torch.Tensor:
    """Min over the 3x3 neighbourhood (8-connectivity) of (..., H, W) grids."""
    h, w = lab.shape[-2:]
    padded = torch.full(lab.shape[:-2] + (h + 2, w + 2), big, dtype=lab.dtype,
                        device=lab.device)
    padded[..., 1:-1, 1:-1] = lab
    best = lab
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                best = torch.minimum(best, padded[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return best


def label_components(fg: torch.Tensor, num_iters: int = 20) -> torch.Tensor:
    """8-connected component labels of (..., H, W) bool grids, each grid on
    its own: for foreground pixels the flat index of the component's
    minimum-index pixel, H*W for background.  int64."""
    h, w = fg.shape[-2:]
    n = h * w
    lead = fg.shape[:-2]
    big = torch.full_like(fg, n, dtype=torch.long)
    idx = torch.arange(n, device=fg.device).reshape(h, w)
    lab = torch.where(fg, idx, big)
    for _ in range(num_iters):
        lab = torch.minimum(lab, torch.where(fg, _neighbor_min(lab, n), big))
        flat = lab.reshape(lead + (n,))
        ext = torch.cat([flat, flat.new_full(lead + (1,), n)], dim=-1)
        jumped = torch.gather(ext, -1, flat.clamp(0, n))
        lab = torch.where(fg, torch.minimum(flat, jumped).reshape(fg.shape), big)
    return lab


def component_boxes_union(fg: torch.Tensor) -> torch.Tensor:
    """Union-of-component-bounding-boxes indicator, float32 (H, W) in {0,1}.

    A component with inclusive bbox rows [r0, r1], cols [c0, c1] paints rows
    [r0, min(r1+1, H-1)) x cols [c0, min(c1+1, W-1)), the reference's
    ``x1 = min(x+w, W-1)`` clamp and exclusive-end paint
    (PriorInformationRefinementModule.py:61-63,114-120)."""
    h, w = fg.shape
    n = h * w
    flat_lab = label_components(fg).reshape(-1)
    pix = torch.arange(n, device=fg.device)
    rows, cols = pix // w, pix % w
    big = 1 << 30
    live = flat_lab < n

    def seg(vals, fill, reduce):
        init = torch.full((n + 1,), fill, dtype=torch.long, device=fg.device)
        src = torch.where(live, vals, torch.full_like(vals, fill))
        return init.scatter_reduce(0, flat_lab, src, reduce=reduce, include_self=True)[:n]

    r0, r1 = seg(rows, big, "amin"), seg(rows, -1, "amax")
    c0, c1 = seg(cols, big, "amin"), seg(cols, -1, "amax")
    r_end = torch.clamp(r1 + 1, max=h - 1)
    c_end = torch.clamp(c1 + 1, max=w - 1)
    rr = torch.arange(h, device=fg.device)
    cc = torch.arange(w, device=fg.device)
    row_ind = (rr[None, :] >= r0[:, None]) & (rr[None, :] < r_end[:, None])  # (n, H)
    col_ind = (cc[None, :] >= c0[:, None]) & (cc[None, :] < c_end[:, None])  # (n, W)
    union = row_ind.float().T @ col_ind.float()
    return (union > 0).float()


def threshold_prior(prior: torch.Tensor, threshold: float) -> torch.Tensor:
    """cv2-parity binarization of a [0,1] map: uint8 floor quantization of
    prior*255, then strictly greater than int(threshold * max)
    (reference _scoremap2bbox:96-102)."""
    q = torch.clamp(torch.floor(prior * 255.0), 0, 255).long()
    t = torch.floor(threshold * q.max().float()).long()
    return q > t


def remove_small_regions(mask: torch.Tensor, area_thresh: float, mode_holes: bool):
    """Fill small holes (``mode_holes``) or drop small islands of (..., H, W)
    bool masks, each on its own, as segment_anything/utils/amg.py:274-299
    does with cv2.connectedComponentsWithStats → (mask, changed (...,)).

    In islands mode, when every region is below the threshold the largest
    is kept instead of emptying the mask; component ids are min-pixel
    row-major indices, the order of cv2's labels, so ``argmax`` (the first
    maximum) breaks ties as the reference's ``np.argmax`` over cv2's stats."""
    working = ~mask if mode_holes else mask
    lab = label_components(working)
    h, w = mask.shape[-2:]
    n = h * w
    lead = mask.shape[:-2]
    flat = lab.reshape(lead + (n,))
    sizes = torch.zeros(lead + (n + 1,), dtype=torch.int32, device=mask.device)
    sizes.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.int32))
    ids = torch.arange(n + 1, device=mask.device)
    # the background of ``working`` is bucket n, never a region
    small = (sizes < area_thresh) & (ids < n)
    is_small = torch.gather(small, -1, flat.clamp(0, n)).reshape(mask.shape)
    changed = (is_small & working).flatten(-2).any(dim=-1)
    new_working = working & ~is_small
    if not mode_holes:
        largest = torch.where(ids < n, sizes, 0).argmax(dim=-1)
        all_small = ~new_working.flatten(-2).any(dim=-1)
        keep_largest = working & (lab == largest[..., None, None])
        new_working = torch.where(all_small[..., None, None], keep_largest, new_working)
    return (~new_working if mode_holes else new_working), changed
