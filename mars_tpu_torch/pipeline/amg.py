"""Automatic mask generation over selected prompt sets (port of
``mars_tpu/pipeline/amg.py``: ``AmgConfig``, ``encode_target``,
``_select_layers``, ``decode_prompt_sets``, ``nms_filter``,
``concat_decodes``).

The image is encoded once; every prompt set is a fixed-(K, 2) row of one
(B, K) batch padded with label -1, and the pad tokens are masked out of the
decoder's attention, so mixed-size rows decode as their unpadded selves.
Filters are validity-mask updates; masks stay dense on the device.

The JAX package's dead-chunk skip (a device conditional per chunk of
``decode_batch`` rows) becomes a host loop over the live chunks only: one
``int(set_valid.sum())`` sync per decode.  The dense grid sweep (and its
thresholds), the crop pyramid and the small-region cleanup are not ported
yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from mars_tpu_torch.core import imaging, masks as mask_ops
from mars_tpu_torch.models import sam
from mars_tpu_torch.ops import nms as nms_ops


@dataclass(frozen=True)
class AmgConfig:
    # thresholds for selected-prompt batches (reference :147-155)
    sel_pred_iou_thresh: float = 0.88
    sel_stability_score_thresh: float = 0.95
    sel_stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    # multimask selection: single-mask output unless sel_multimask_output;
    # 0..2 → that multimask layer; 3..5 → layers (k-3).. (reference :405-415)
    sel_multimask_output: bool = False
    sel_output_layer: int = 3
    decode_batch: int = 32


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
                       mask_input: Optional[torch.Tensor] = None) -> dict:
    """Decode every prompt set and apply the AMG filters.

    embedding (G, G, C); point_coords (B, K, 2) xy in original pixels;
    point_labels (B, K) in {-1, 0, 1}; set_valid (B,); ``box`` (4,) xyxy and
    ``mask_input`` (4G, 4G) low-res logits are optional prompts.  Returns a
    dict over N = B·M mask slots: masks (N, H, W) bool, low_res_logits,
    iou, stability, boxes (N, 4) float, valid (after iou/stability), and
    set_index.  NMS is the caller's (across all prompt batches)."""
    g = embedding.shape[0]
    b0 = point_coords.shape[0]
    dev = embedding.device
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
                     mask_ops.stability_score(up, model_cfg.mask_threshold,
                                              cfg.sel_stability_score_offset),
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
    if cfg.sel_pred_iou_thresh > 0:
        valid = valid & (iou_all > cfg.sel_pred_iou_thresh)
    if cfg.sel_stability_score_thresh > 0:
        valid = valid & (stab_all >= cfg.sel_stability_score_thresh)
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
