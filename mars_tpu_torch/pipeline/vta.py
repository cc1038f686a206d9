"""Visual-Text Alignment: the CLIP Softmax-Grad-CAM prior (port of
``mars_tpu/pipeline/vta.py``).

The query is resized to 528 (bicubic, jax.image semantics) and
CLIP-normalized; 11 CLIP blocks run without gradients, Grad-CAM goes
through the held-out block; the CAM is min-max scaled twice (the
reference's per-layer then aggregate scaling, base_cam.py:126-164) and
PIR-refined over the mean of the last-8 attention maps (7 tapped prefinal
maps + the final block's).  Returned unscaled: the orchestrator scales after
the nearest resize to the VVA grid.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mars_tpu_torch.core import imaging
from mars_tpu_torch.models import clip as clip_m
from mars_tpu_torch.pipeline import pir


@dataclass(frozen=True)
class VTAConfig:
    refinement_box_threshold: float = 0.4  # scripts/coco_1shot.sh
    attn_tap_last_n: int = 8
    input_size: int = 528  # ceil(518/16)*16
    grid: int = 33  # 528 / 16


def _scale_cam(cam):
    """Reference scale_cam_image: subtract min, divide by (1e-7 + max)."""
    cam = cam - cam.amin(dim=-1, keepdim=True)
    return cam / (1e-7 + cam.amax(dim=-1, keepdim=True))


def _input(query_image: torch.Tensor, cfg: VTAConfig) -> torch.Tensor:
    img = imaging.resize(query_image, (cfg.input_size, cfg.input_size), "bicubic")
    return imaging.normalize(img, imaging.CLIP_MEAN, imaging.CLIP_STD)


def _cams(params, img, text_feats, logit_scale, model_cfg, cfg: VTAConfig):
    """(B, s, s, 3) CLIP inputs → (scaled CAMs (B, grid, grid), attention
    means (B, P, P)); one Grad-CAM backward for the batch."""
    x = clip_m.visual_embed(params, img, model_cfg)
    tokens, attn_sum = clip_m.prefinal(params, x, model_cfg, cfg.attn_tap_last_n)
    cam, _, attn_last = clip_m.gradcam_last_block(params, tokens, text_feats, logit_scale,
                                                  model_cfg)
    attn_mean = (attn_sum + attn_last) / cfg.attn_tap_last_n
    return _scale_cam(_scale_cam(cam)).reshape(-1, cfg.grid, cfg.grid), attn_mean


def compute(params, query_image: torch.Tensor, fg_bg_text_feats: torch.Tensor,
            logit_scale: torch.Tensor, model_cfg: clip_m.ClipVisualConfig,
            cfg: VTAConfig) -> torch.Tensor:
    """Returns the PIR-refined CAM (grid, grid), unscaled."""
    cam, attn_mean = _cams(params, _input(query_image, cfg)[None], fg_bg_text_feats,
                           logit_scale, model_cfg, cfg)
    return pir.refine(cam[0], attn_mean[0], cfg.refinement_box_threshold)


def compute_batch(params, query_images: torch.Tensor, text_feats: torch.Tensor,
                  logit_scale: torch.Tensor, model_cfg: clip_m.ClipVisualConfig,
                  cfg: VTAConfig) -> list:
    """``compute`` over B queries (B, H, W, 3) with their text pairs
    (B, 2, D): the tower and the Grad-CAM backward once over the batch,
    PIR per episode → B refined CAMs (grid, grid)."""
    img = torch.stack([_input(q, cfg) for q in query_images])
    cams, attn_mean = _cams(params, img, text_feats, logit_scale, model_cfg, cfg)
    return [pir.refine(cams[i], attn_mean[i], cfg.refinement_box_threshold)
            for i in range(cams.shape[0])]


def scaled_to_grid(vta_prior: torch.Tensor, g: int) -> torch.Tensor:
    """The refined CAM as the score tail reads it: nearest-resized to the
    VVA grid (g, g), then min-max scaled."""
    vta_prior = imaging.interpolate_2d(vta_prior, (g, g), "nearest")
    return (vta_prior - vta_prior.min()) / (1e-7 + vta_prior.max() - vta_prior.min())


def compute_text_feats(text_params, text_cfg, fg_tokens, bg_tokens) -> torch.Tensor:
    """Template-averaged fg/bg prompt features, each normalized → (2, out_dim)
    (reference SoftmaxGradCAM.compute_text_feats:63-109)."""
    def avg(tokens):
        e = clip_m.encode_text(text_params, tokens, text_cfg)
        m = (e / e.norm(dim=-1, keepdim=True)).mean(dim=0)
        return m / m.norm()

    return torch.stack([avg(fg_tokens), avg(bg_tokens)])
