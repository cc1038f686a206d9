"""CLIP (CLIP-ES forked dialect) and AlphaCLIP towers (port of
``mars_tpu/models/clip.py``).

  - ``visual_embed``/``prefinal``: conv patch embed (+ AlphaCLIP's additive
    alpha conv) + CLS + bilinearly upsampled pos embed, ln_pre, then
    ``depth-1`` blocks with a running sum of head-averaged patch attention
    over the tapped blocks (reference clip/model.py:102-117,326-327).
  - ``gradcam_last_block``: Softmax-Grad-CAM through the held-out final
    block, the gradient taken on its ln_1 activation with
    ``torch.autograd.grad`` (reference clip/model.py:501-524).
  - ``visual_cls``: the full tower → projected CLS embedding (AlphaCLIP
    ranking head, reference alpha_clip/model.py:359-386).
  - ``encode_text``: causal transformer, EOT pooling, projection
    (reference clip/model.py:486-499).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mars_tpu_torch.models import layers as L


@dataclass(frozen=True)
class ClipVisualConfig:
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    output_dim: int = 512
    pos_embed_grid: int = 14  # 224/16
    alpha_channel: bool = False


@dataclass(frozen=True)
class ClipTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    depth: int = 12
    num_heads: int = 8
    output_dim: int = 512


CLIP_B16_VISUAL = ClipVisualConfig()
CLIP_B16_TEXT = ClipTextConfig()
# reference: alpha_clip ViT-L/14@336px (FilteringMergingModule.py:226-231)
ALPHA_CLIP_L14_336_VISUAL = ClipVisualConfig(
    patch_size=14, width=1024, depth=24, num_heads=16, output_dim=768,
    pos_embed_grid=24, alpha_channel=True,
)
ALPHA_CLIP_L14_TEXT = ClipTextConfig(width=768, num_heads=12, output_dim=768)
# plain CLIP ViT-L/14@224, the reference's other --vta_backbone
# (main_MARS.py:144, VisualTextAlignmentModule.py:81-86)
CLIP_L14_VISUAL = ClipVisualConfig(
    patch_size=14, width=1024, depth=24, num_heads=16, output_dim=768,
    pos_embed_grid=16,
)
CLIP_L14_TEXT = ALPHA_CLIP_L14_TEXT


def visual_embed(params, images, cfg: ClipVisualConfig, alpha=None):
    """(B, H, W, 3) → post-ln_pre tokens (B, 1+P, D)."""
    b, h, w, _ = images.shape
    gh, gw = h // cfg.patch_size, w // cfg.patch_size
    x = L.conv_patch_embed(params["patch_embed"], images, cfg.patch_size)
    if cfg.alpha_channel:
        x = x + L.conv_patch_embed(params["patch_embed_alpha"], alpha[..., None], cfg.patch_size)
    cls = params["class_embedding"].expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + L.interpolate_pos_embed(params["pos_embed"], (gh, gw), 1, "bilinear")
    return L.layer_norm(params["ln_pre"], x)


def prefinal(params, x, cfg: ClipVisualConfig, attn_tap_last_n: int = 0):
    """Blocks 0..depth-2; blocks with index >= depth - attn_tap_last_n are
    tapped (the count includes the held-out final block).
    Returns (tokens, attn_patch_sum or None)."""
    attn_total = None
    tap_start = cfg.depth - attn_tap_last_n
    for i in range(cfg.depth - 1):
        tap = attn_tap_last_n > 1 and i >= tap_start
        x, attn = L.block(params[f"block{i}"], x, cfg.num_heads, act=L.quick_gelu,
                          return_attn=tap)
        if tap:
            pa = attn[:, 1:, 1:]
            attn_total = pa if attn_total is None else attn_total + pa
    return x, attn_total


def gradcam_last_block(params, x_prefinal, text_feats, logit_scale, cfg: ClipVisualConfig):
    """Softmax-Grad-CAM through the held-out final block.

    text_feats: (T, output_dim), foreground label at row 0.
    Returns (cam (B, P) unscaled, probs (B, T), attn_patch_last (B, P, P)).
    """
    p = params[f"block{cfg.depth - 1}"]
    txt = text_feats / text_feats.norm(dim=-1, keepdim=True)
    with torch.enable_grad():
        # the Grad-CAM target activation (VisualTextAlignmentModule.py:56)
        a = L.layer_norm(p["ln1"], x_prefinal).detach().requires_grad_(True)
        attn_out, attn_w = L.mha(p["attn"], a, cfg.num_heads, return_attn=True,
                                 force_plain=True)
        h = x_prefinal + attn_out
        h = h + L.mlp(p["mlp"], L.layer_norm(p["ln2"], h), L.quick_gelu)
        h = L.layer_norm(params["ln_post"], h)
        img = h[:, 1:, :].mean(dim=1) @ params["proj"]
        img = img / img.norm(dim=-1, keepdim=True)
        # a bf16 tower's img meets the f32 scale and text features: JAX
        # promotes the product to f32 (a 0-dim f32 array promotes too)
        dt = torch.promote_types(torch.promote_types(logit_scale.dtype, img.dtype), txt.dtype)
        logits = (torch.exp(logit_scale).to(dt) * img.to(dt)) @ txt.T.to(dt)
        probs = torch.softmax(logits, dim=-1)
        # target: softmaxed logit of the foreground label (ClipOutputTarget(0))
        (grads,) = torch.autograd.grad(probs[:, 0].sum(), a)
    w = grads[:, 1:, :].mean(dim=1)  # (B, D)
    cam = torch.clamp(torch.einsum("bpd,bd->bp", a.detach()[:, 1:, :], w), min=0.0)
    return cam, probs.detach(), attn_w.detach()[:, 1:, 1:]


def visual_cls(params, images, cfg: ClipVisualConfig, alpha=None):
    """Full visual tower → projected CLS embedding."""
    x = visual_embed(params, images, cfg, alpha=alpha)
    for i in range(cfg.depth):
        x, _ = L.block(params[f"block{i}"], x, cfg.num_heads, act=L.quick_gelu)
    return L.layer_norm(params["ln_post"], x[:, 0:1])[:, 0] @ params["proj"]


def encode_text(params, tokens, cfg: ClipTextConfig):
    """tokens: (B, 77) integer → (B, output_dim) EOT-pooled features."""
    tokens = tokens.long()
    x = params["token_embedding"]["embedding"][tokens] + params["pos_embed"]
    l = x.shape[1]
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()[None, None]
    for i in range(cfg.depth):
        x, _ = L.block(params[f"block{i}"], x, cfg.num_heads, act=L.quick_gelu, mask=mask)
    x = L.layer_norm(params["ln_final"], x)
    pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    return pooled @ params["text_projection"]


def visual_param_shapes(cfg: ClipVisualConfig) -> dict:
    """Parameter shapes, keyed as ``mars_tpu.models.clip.init_visual_params``."""
    w = cfg.width
    p = {
        "patch_embed": {"kernel": (cfg.patch_size, cfg.patch_size, 3, w)},
        "class_embedding": (w,),
        "pos_embed": (1, cfg.pos_embed_grid ** 2 + 1, w),
        "ln_pre": {"scale": (w,), "bias": (w,)},
        "ln_post": {"scale": (w,), "bias": (w,)},
        "proj": (w, cfg.output_dim),
    }
    if cfg.alpha_channel:
        p["patch_embed_alpha"] = {"kernel": (cfg.patch_size, cfg.patch_size, 1, w)}
    for i in range(cfg.depth):
        p[f"block{i}"] = L.block_shapes(w, w * 4)
    return p


def text_param_shapes(cfg: ClipTextConfig) -> dict:
    """Parameter shapes, keyed as ``mars_tpu.models.clip.init_text_params``."""
    w = cfg.width
    p = {
        "token_embedding": {"embedding": (cfg.vocab_size, w)},
        "pos_embed": (cfg.context_length, w),
        "ln_final": {"scale": (w,), "bias": (w,)},
        "text_projection": (w, cfg.output_dim),
    }
    for i in range(cfg.depth):
        p[f"block{i}"] = L.block_shapes(w, w * 4)
    return p
