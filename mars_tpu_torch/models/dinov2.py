"""DINOv2 vision transformer (port of ``mars_tpu/models/dinov2.py``).

Patch embed + CLS + register tokens + interpolated pos embed, pre-LN blocks
with LayerScale, and the attention tap: the forward keeps a running sum of
the head-averaged patch-token attention over the last ``attn_tap_last_n``
blocks (reference: dinov2/models/vision_transformer.py:223-286).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mars_tpu_torch.models import layers as L


@dataclass(frozen=True)
class DinoV2Config:
    """Defaults: ViT-L/14 with 4 register tokens."""
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    layer_scale_init: float = 1e-5
    ln_eps: float = 1e-6
    pos_embed_grid: int = 37  # grid the checkpoint's pos embed covers
    # scale-factor offset for non-native input sizes (reference
    # vision_transformer.py:204-209); 0.1 is the DINOv2 default
    interpolate_offset: float = 0.1


# reference: dinov2/models/vision_transformer.py:381-437 (the JAX package's
# table: vit_giant2 with the plain MLP of the others, mars_tpu/models/dinov2.py:42-47)
DINOV2_VARIANTS = {
    "vit_small": DinoV2Config(embed_dim=384, depth=12, num_heads=6),
    "vit_base": DinoV2Config(embed_dim=768, depth=12, num_heads=12),
    "vit_large": DinoV2Config(embed_dim=1024, depth=24, num_heads=16),
    "vit_giant2": DinoV2Config(embed_dim=1536, depth=40, num_heads=24),
}


def forward_features(params, images, cfg: DinoV2Config, attn_tap_last_n: int = 0,
                     tap_from: int = 0):
    """images: (B, H, W, 3) normalized, NHWC.

    Returns dict with x_prenorm (B, 1+R+P, D), x_norm_clstoken (B, D),
    x_norm_patchtokens (B, P, D) and attn_mean (B, P, P), the mean over the
    last N blocks and all heads of patch-token attention (None if N == 0).
    ``tap_from``: only images from this index on are tapped (attn_mean
    (B - tap_from, P, P)); the others run the untapped route, as their own
    untapped forward would.
    """
    b, h, w, _ = images.shape
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    x = L.conv_patch_embed(params["patch_embed"], images, cfg.patch_size)
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = x + L.interpolate_pos_embed(params["pos_embed"], (gh, gw), 1, "bicubic",
                                    interpolate_offset=cfg.interpolate_offset)
    if cfg.num_register_tokens:
        regs = params["register_tokens"].expand(b, cfg.num_register_tokens, cfg.embed_dim)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)

    num_prefix = 1 + cfg.num_register_tokens
    attn_total = None
    tap_start = cfg.depth - attn_tap_last_n
    for i in range(cfg.depth):
        tap = attn_tap_last_n > 0 and i >= tap_start
        x, attn = L.block(params[f"block{i}"], x, cfg.num_heads, act=L.exact_gelu,
                          ln_eps=cfg.ln_eps, return_attn=tap, tap_from=tap_from)
        if tap:
            pa = attn[:, num_prefix:, num_prefix:]
            attn_total = pa if attn_total is None else attn_total + pa

    x_norm = L.layer_norm(params["norm"], x, cfg.ln_eps)
    return {
        "x_prenorm": x,
        "x_norm_clstoken": x_norm[:, 0],
        "x_norm_patchtokens": x_norm[:, num_prefix:],
        "attn_mean": None if attn_total is None else attn_total / attn_tap_last_n,
    }


def patch_features(out: dict, num_register_tokens: int, l2_normalize: bool = True) -> torch.Tensor:
    """Prenorm patch features, flattened over the batch, L2-normalized
    (reference: VisualVisualAlignmentModule.py:113-127)."""
    feats = out["x_prenorm"][:, 1 + num_register_tokens:]
    feats = feats.reshape(-1, feats.shape[-1])
    if l2_normalize:
        feats = feats / feats.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return feats


def param_shapes(cfg: DinoV2Config) -> dict:
    """Parameter shapes, keyed as ``mars_tpu.models.dinov2.init_params``."""
    d = cfg.embed_dim
    p = {
        "patch_embed": {"kernel": (cfg.patch_size, cfg.patch_size, 3, d), "bias": (d,)},
        "cls_token": (1, 1, d),
        "pos_embed": (1, cfg.pos_embed_grid ** 2 + 1, d),
        "norm": {"scale": (d,), "bias": (d,)},
    }
    if cfg.num_register_tokens:
        p["register_tokens"] = (1, cfg.num_register_tokens, d)
    for i in range(cfg.depth):
        p[f"block{i}"] = L.block_shapes(d, int(d * cfg.mlp_ratio), layer_scale=True)
    return p
