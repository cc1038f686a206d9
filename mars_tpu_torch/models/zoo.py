"""Full-width towers with seeded random weights (port of the no-checkpoint
branch of ``mars_tpu/models/zoo.py``).

As the JAX package does without checkpoints, norm scales and layerscale
gammas are ones, biases zeros, and every other leaf is uniform in
[-0.035, 0.035]; here the draws come from a ``torch.Generator`` on the
target device, so the numbers differ from JAX's threefry draws.
"""
from __future__ import annotations

import math

import torch

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.models import clip as clip_m
from mars_tpu_torch.models import dinov2


def random_params(shapes: dict, gen: torch.Generator, device: torch.device) -> dict:
    out = {}
    for name, leaf in shapes.items():
        if isinstance(leaf, dict):
            out[name] = random_params(leaf, gen, device)
        elif name in ("scale", "gamma"):
            out[name] = torch.ones(leaf, device=device)
        elif name == "bias":
            out[name] = torch.zeros(leaf, device=device)
        else:
            out[name] = (torch.rand(leaf, generator=gen, device=device) * 0.07 - 0.035)
    return out


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def build_dinov2(seed: int = 0, device=None):
    """→ (params, DinoV2Config): DINOv2-L/14 reg4."""
    dev = device_lib.resolve(device)
    cfg = dinov2.DinoV2Config()
    return random_params(dinov2.param_shapes(cfg), _generator(seed, dev), dev), cfg


def _build_clip_pair(vcfg, tcfg, seed: int, device):
    dev = device_lib.resolve(device)
    gen = _generator(seed, dev)
    vp = random_params(clip_m.visual_param_shapes(vcfg), gen, dev)
    tp = random_params(clip_m.text_param_shapes(tcfg), gen, dev)
    scale = torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=dev)
    return vp, tp, scale, vcfg, tcfg


def build_clip(seed: int = 1, device=None):
    """→ (visual, text, logit_scale, vcfg, tcfg): CLIP ViT-B/16."""
    return _build_clip_pair(clip_m.CLIP_B16_VISUAL, clip_m.CLIP_B16_TEXT, seed, device)


def build_alpha_clip(seed: int = 2, device=None):
    """→ (visual, text, logit_scale, vcfg, tcfg): AlphaCLIP ViT-L/14@336."""
    return _build_clip_pair(clip_m.ALPHA_CLIP_L14_336_VISUAL, clip_m.ALPHA_CLIP_L14_TEXT,
                            seed, device)
