"""Full-width towers with seeded random weights (port of the no-checkpoint
branch of ``mars_tpu/models/zoo.py``).

As the JAX package does without checkpoints, norm scales and layerscale
gammas are ones, biases zeros, and every other leaf is uniform in
[-0.035, 0.035]; here the draws come from a ``torch.Generator`` on the
target device, so the numbers differ from JAX's threefry draws.  SAM's
relative-position tables are drawn like any other leaf (JAX's init zeroes
them), so the bias path of the grid attention is exercised.  ViP-LLaVA
draws as the JAX package's ``vip_llava.init_random_params`` does (normal
leaves, quantized kernels drawn quantized).
"""
from __future__ import annotations

import math

import torch

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.models import clip as clip_m
from mars_tpu_torch.models import dinov2
from mars_tpu_torch.models import sam
from mars_tpu_torch.models import vip_llava


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


def build_sam(variant: str = "vit_h", seed: int = 3, device=None):
    """→ (params {"encoder", "prompt_encoder", "decoder"}, SamConfig):
    full width.  The random-Fourier matrix ``pe_gaussian`` is standard
    normal, as the JAX init and the reference draw it: at ±0.035 every
    prompt point would get nearly the same encoding."""
    dev = device_lib.resolve(device)
    cfg = sam.SAM_VARIANTS[variant]
    gen = _generator(seed, dev)
    params = random_params(sam.param_shapes(cfg), gen, dev)
    pe = params["prompt_encoder"]
    pe["pe_gaussian"] = torch.randn(pe["pe_gaussian"].shape, generator=gen, device=dev)
    return params, cfg


def build_vip_llava(seed: int = 0, quantize_bits=4, int4_format: str = "affine",
                    dtype=torch.bfloat16, device=None):
    """→ (params, VipLlavaConfig): ViP-LLaVA-7B at full width (CLIP-L/14@336
    tower, LLaMA-7B), weights ``dtype`` and the dense kernels weight-only
    quantized (``quantize_bits`` 8 or 4; 4 with ``int4_format`` "affine" or
    "nf4"; None keeps them floating)."""
    cfg = vip_llava.VipLlavaConfig()
    return vip_llava.init_random_params(seed, cfg, quantize_bits, dtype, int4_format,
                                        device), cfg
