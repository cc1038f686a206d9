"""Automatic mask generation (port of ``mars_tpu/pipeline/amg.py``): the
Matcher's selected prompt sets, the dense grid sweep, the crop pyramid and
the small-region cleanup (reference
segment_anything/automatic_mask_generator.py).

The image is encoded once a crop; every prompt set is a fixed-(K, 2) row of
one (B, K) batch padded with label -1, and the pad tokens are masked out of
the decoder's attention, so mixed-size rows decode as their unpadded
selves.  Filters are validity-mask updates; masks stay dense on the device.

The JAX package's dead-chunk skip (a device conditional per chunk of
``decode_batch`` rows) becomes a host loop over the live chunks only: one
``int(set_valid.sum())`` sync per decode.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import product
from typing import Optional, Tuple

import torch

from mars_tpu_torch.core import imaging, masks as mask_ops
from mars_tpu_torch.models import sam
from mars_tpu_torch.ops import components, nms as nms_ops


@dataclass(frozen=True)
class AmgConfig:
    # thresholds for selected-prompt batches (reference :147-155)
    sel_pred_iou_thresh: float = 0.88
    sel_stability_score_thresh: float = 0.95
    sel_stability_score_offset: float = 1.0
    # thresholds for the dense grid sweep
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    points_per_side: int = 32
    # multimask selection: single-mask output unless sel_multimask_output;
    # 0..2 → that multimask layer; 3..5 → layers (k-3).. (reference :405-415)
    sel_multimask_output: bool = False
    sel_output_layer: int = 3
    multimask_output: bool = True
    output_layer: int = 3
    decode_batch: int = 32
    # the crop pyramid (reference automatic_mask_generator.py:51-54)
    crop_n_layers: int = 0
    crop_nms_thresh: float = 0.7
    crop_overlap_ratio: float = 512 / 1500
    crop_n_points_downscale_factor: int = 1


def encode_target(params, image01: torch.Tensor, cfg: sam.SamConfig) -> torch.Tensor:
    """image01: (H, W, 3) in [0, 1] → (G, G, C) embedding.  Longest side to
    ``img_size`` (bilinear, jax.image semantics), normalise in 0-255 space,
    zero-pad to square after normalising (reference sam.py:133-150)."""
    s = cfg.img_size
    h, w = image01.shape[:2]
    scale = s / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    img = imaging.resize(image01 * 255.0, (nh, nw), "bilinear")
    img = imaging.normalize(img, sam.SAM_PIXEL_MEAN, sam.SAM_PIXEL_STD)
    if (nh, nw) != (s, s):
        img = torch.nn.functional.pad(img, (0, 0, 0, s - nw, 0, s - nh))
    return sam.encode_image(params["encoder"], img[None], cfg)[0]


def _select_layers(masks, ious, multimask: bool, output_layer: int):
    """(B, 4, ...) decoder outputs → (B, M, ...) (reference :405-415)."""
    if not multimask:
        return masks[:, 0:1], ious[:, 0:1]
    if output_layer in (0, 1, 2):
        i = 1 + output_layer
        return masks[:, i:i + 1], ious[:, i:i + 1]
    layer = output_layer - 3
    return masks[:, 1 + layer:], ious[:, 1 + layer:]


def decode_prompt_sets(params, embedding, point_coords, point_labels, set_valid,
                       model_cfg: sam.SamConfig, cfg: AmgConfig,
                       original_size: Tuple[int, int] = (518, 518),
                       box: Optional[torch.Tensor] = None,
                       mask_input: Optional[torch.Tensor] = None,
                       dense_grid: bool = False) -> dict:
    """Decode every prompt set and apply the AMG filters.

    embedding (G, G, C); point_coords (B, K, 2) xy in original pixels;
    point_labels (B, K) in {-1, 0, 1}; set_valid (B,); ``box`` (4,) xyxy and
    ``mask_input`` (4G, 4G) low-res logits are optional prompts.  The
    ``sel_*`` thresholds and multimask choice apply, or with ``dense_grid``
    the grid sweep's.  Returns a dict over N = B·M mask slots: masks
    (N, H, W) bool, low_res_logits, iou, stability, boxes (N, 4) float,
    valid (after iou/stability), and set_index.  NMS is the caller's
    (across all prompt batches)."""
    g = embedding.shape[0]
    b0 = point_coords.shape[0]
    dev = embedding.device
    if dense_grid:
        iou_thr, st_thr, st_off = (cfg.pred_iou_thresh, cfg.stability_score_thresh,
                                   cfg.stability_score_offset)
        multimask, out_layer = cfg.multimask_output, cfg.output_layer
    else:
        iou_thr, st_thr, st_off = (cfg.sel_pred_iou_thresh, cfg.sel_stability_score_thresh,
                                   cfg.sel_stability_score_offset)
        multimask, out_layer = cfg.sel_multimask_output, cfg.sel_output_layer
    in_hw = (model_cfg.img_size,) * 2

    coords = sam.transform_coords(point_coords, original_size, model_cfg.img_size)
    use_box = box is not None
    pe = params["prompt_encoder"]
    sparse = sam.embed_points(pe, coords, point_labels, in_hw, pad=not use_box)
    # label -1 slots are padding, masked out of attention; the appended pad
    # point / box tokens stay live
    sparse_valid = torch.cat([point_labels != -1,
                              torch.ones((b0, 2 if use_box else 1), dtype=torch.bool,
                                         device=dev)], dim=1)
    if use_box:
        bcoords = sam.transform_coords(box.reshape(2, 2), original_size, model_cfg.img_size)
        bemb = sam.embed_boxes(pe, bcoords.reshape(1, 4), in_hw)
        sparse = torch.cat([sparse, bemb.expand(b0, 2, sparse.shape[-1])], dim=1)
    if mask_input is not None:
        dense = sam.embed_mask_input(pe, mask_input[None])[0]
    else:
        dense = sam.no_mask_dense(pe, (g, g))
    image_pe = sam.dense_pe(pe, (g, g))

    # live prompt sets first (stable); only chunks holding one are decoded
    order = torch.argsort((~set_valid).to(torch.int32), stable=True)
    n_live = int(set_valid.sum())
    nb = cfg.decode_batch
    outs = []
    for start in range(0, n_live, nb):
        rows = order[start:start + nb]
        lr, iou = sam.decode_masks(params["decoder"], embedding, image_pe, sparse[rows],
                                   dense.expand(len(rows), *dense.shape), model_cfg,
                                   sparse_valid=sparse_valid[rows])
        lr, iou = _select_layers(lr, iou, multimask, out_layer)
        # full-resolution logits for stability and boxes (reference
        # predict_torch upscales before filtering)
        up = sam.postprocess_masks(lr, model_cfg.img_size, original_size)
        th = up > model_cfg.mask_threshold
        outs.append((rows, th, lr, iou,
                     mask_ops.stability_score(up, model_cfg.mask_threshold, st_off),
                     mask_ops.mask_to_box(th).float()))

    m = 6 - out_layer if multimask and out_layer >= 3 else 1  # slots _select_layers keeps
    lr_hw = 4 * g
    th_all = torch.zeros((b0, m) + tuple(original_size), dtype=torch.bool, device=dev)
    lr_all = torch.zeros((b0, m, lr_hw, lr_hw), dtype=embedding.dtype, device=dev)
    iou_all = torch.zeros((b0, m), dtype=embedding.dtype, device=dev)
    stab_all = torch.zeros((b0, m), dtype=torch.float32, device=dev)
    box_all = torch.zeros((b0, m, 4), dtype=torch.float32, device=dev)
    for rows, th, lr, iou, stab, boxes in outs:  # back to the caller's set order
        th_all[rows], lr_all[rows], iou_all[rows] = th, lr, iou
        stab_all[rows], box_all[rows] = stab, boxes

    iou_all = iou_all.reshape(-1)
    stab_all = stab_all.reshape(-1)
    valid = set_valid.repeat_interleave(m)
    if iou_thr > 0:
        valid = valid & (iou_all > iou_thr)
    if st_thr > 0:
        valid = valid & (stab_all >= st_thr)
    # EMPTY decoded masks stay valid, as in the reference (their [0,0,0,0]
    # boxes are never suppressed and scoring sinks them)
    return {
        "masks": th_all.reshape((-1,) + tuple(original_size)),
        "low_res_logits": lr_all.reshape(-1, lr_hw, lr_hw),
        "iou": iou_all,
        "stability": stab_all,
        "boxes": box_all.reshape(-1, 4),
        "valid": valid,
        "set_index": torch.arange(b0, device=dev).repeat_interleave(m),
    }


def nms_filter(data: dict, box_nms_thresh: float) -> dict:
    """Cross-batch NMS over concatenated decode results."""
    keep = nms_ops.nms_keep(data["boxes"], data["iou"], data["valid"], box_nms_thresh)
    return {**data, "valid": keep}


def concat_decodes(results) -> dict:
    return {k: torch.cat([r[k] for r in results], dim=0) for k in results[0]}


def _linspace_f32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace`` in float32 as XLA computes it: with r = 1 / (num - 1)
    rounded, start·(1 - i·r) + i·(stop·r), and stop itself as the last
    entry.  (XLA:CPU's LLVM contracts the last multiply-add into an FMA,
    which can move an entry by one float32 ulp; here nothing is fused.)"""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start_t[None]
    r = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    return torch.cat([start_t * (1 - i * r.to(device)) + i * (stop_t * r.to(device)),
                      stop_t[None]])


def grid_points(points_per_side: int, original_size: Tuple[int, int], device=None) -> torch.Tensor:
    """The dense AMG grid (reference utils/amg.py:179-198): n² cell centres
    in normalised coordinates, x fastest, scaled to (W, H) → (n², 2)
    float32."""
    offset = 1.0 / (2 * points_per_side)
    ax = _linspace_f32(offset, 1.0 - offset, points_per_side, device)
    gy, gx = torch.meshgrid(ax, ax, indexing="ij")
    pts = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    return pts * torch.tensor([original_size[1], original_size[0]], dtype=torch.float32,
                              device=device)


def generate_dense(params, embedding, model_cfg: sam.SamConfig, cfg: AmgConfig,
                   original_size: Tuple[int, int] = (518, 518)) -> dict:
    """The grid sweep (reference _process_crop :326-330, _process_batch
    :385-453): ``points_per_side``² one-point prompts decoded with the
    dense thresholds, then NMS.  The dict of ``decode_prompt_sets``."""
    pts = grid_points(cfg.points_per_side, original_size, embedding.device)[:, None, :]
    n = pts.shape[0]
    labels = torch.ones((n, 1), dtype=torch.int32, device=embedding.device)
    data = decode_prompt_sets(params, embedding, pts, labels,
                              torch.ones((n,), dtype=torch.bool, device=embedding.device),
                              model_cfg, cfg, original_size=original_size, dense_grid=True)
    return nms_filter(data, cfg.box_nms_thresh)


def generate_crop_boxes(im_size: Tuple[int, int], n_layers: int, overlap_ratio: float):
    """The crop pyramid on the host: layer i has (2^i)² crops (reference
    utils/amg.py:200-239) → ([(x0, y0, x1, y1), ...], [layer, ...])."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes, layer_idxs = [(0, 0, im_w, im_h)], [0]

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_side))
        cw, ch = crop_len(im_w, n_side, overlap), crop_len(im_h, n_side, overlap)
        xs = [int((cw - overlap) * i) for i in range(n_side)]
        ys = [int((ch - overlap) * i) for i in range(n_side)]
        for x0, y0 in product(xs, ys):
            crop_boxes.append((x0, y0, min(x0 + cw, im_w), min(y0 + ch, im_h)))
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def generate_multicrop(params, image01, model_cfg: sam.SamConfig, cfg: AmgConfig,
                       original_size: Tuple[int, int] = (518, 518)) -> dict:
    """Dense AMG over the crop pyramid (reference _generate_masks :245-292,
    _process_crop :293-384): per crop one encode at ``img_size`` (crops are
    never cached: each is its own image), the layer's point grid, the dense
    filters, the crop-edge filter and NMS inside the crop; masks, boxes and
    points back in the image frame; then NMS across crops scored by 1 /
    crop area (smaller crops first).  image01 (H, W, 3) in [0, 1].  Every
    crop's slots are kept (N = Σ crops' B·M), dead ones invalid; no
    ``low_res_logits`` (crop-frame logits do not compare)."""
    h, w = original_size
    crop_boxes, layer_idxs = generate_crop_boxes((h, w), cfg.crop_n_layers,
                                                 cfg.crop_overlap_ratio)
    dev = image01.device
    results = []
    for cb, layer in zip(crop_boxes, layer_idxs):
        x0, y0, x1, y1 = cb
        emb = encode_target(params, image01[y0:y1, x0:x1], model_cfg)
        n_side = max(1, cfg.points_per_side // (cfg.crop_n_points_downscale_factor ** layer))
        pts = grid_points(n_side, (y1 - y0, x1 - x0), dev)[:, None, :]
        n = pts.shape[0]
        data = decode_prompt_sets(params, emb, pts,
                                  torch.ones((n, 1), dtype=torch.int32, device=dev),
                                  torch.ones((n,), dtype=torch.bool, device=dev), model_cfg,
                                  cfg, original_size=(y1 - y0, x1 - x0), dense_grid=True)
        del data["low_res_logits"]
        boxes = mask_ops.uncrop_boxes_xyxy(data["boxes"], cb)
        data["valid"] = data["valid"] & ~mask_ops.is_box_near_crop_edge(boxes, cb, (0, 0, w, h))
        data = nms_filter(data, cfg.box_nms_thresh)
        data["masks"] = mask_ops.uncrop_masks(data["masks"], cb, h, w)
        data["boxes"] = boxes
        data["points"] = mask_ops.uncrop_points(pts[data["set_index"], 0], cb)
        data["crop_area"] = torch.full((data["masks"].shape[0],), float((x1 - x0) * (y1 - y0)),
                                       dtype=torch.float32, device=dev)
        results.append(data)
    out = concat_decodes(results)
    if len(crop_boxes) > 1:
        out["valid"] = nms_ops.nms_keep(out["boxes"], 1.0 / out["crop_area"], out["valid"],
                                        cfg.crop_nms_thresh)
    return out


CLEANUP_CHUNK = 32  # live masks a batched component labelling takes


def postprocess_small_regions(data: dict, min_area: int, nms_thresh: float) -> dict:
    """Fill holes and drop islands smaller than ``min_area`` in every live
    mask, then NMS again with changed masks scored 0 and the rest 1 (the
    reference's "prefer unchanged masks", automatic_mask_generator.py:558-607,
    utils/amg.py:274-299); boxes come from the cleaned masks.  Live masks
    are cleaned ``CLEANUP_CHUNK`` at a time; dead slots (never kept by NMS)
    keep their masks and boxes as they came."""
    masks, boxes = data["masks"].clone(), data["boxes"].clone()
    changed = torch.zeros((masks.shape[0],), dtype=torch.bool, device=masks.device)
    live = torch.nonzero(data["valid"])[:, 0]
    for start in range(0, live.shape[0], CLEANUP_CHUNK):
        rows = live[start:start + CLEANUP_CHUNK]
        m1, ch_holes = components.remove_small_regions(masks[rows], float(min_area), True)
        m2, ch_islands = components.remove_small_regions(m1, float(min_area), False)
        masks[rows], changed[rows] = m2, ch_holes | ch_islands
        boxes[rows] = mask_ops.mask_to_box(m2).to(boxes.dtype)
    scores = torch.where(changed, 0.0, 1.0)
    keep = nms_ops.nms_keep(boxes, scores, data["valid"], nms_thresh)
    return {**data, "masks": masks, "boxes": boxes, "valid": keep}
