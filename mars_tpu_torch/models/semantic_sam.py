"""Native Semantic-SAM network (port of ``mars_tpu/models/semantic_sam.py``):
SwinL, the MaskDINO pixel decoder and the interactive point decoder with
multi-granularity queries.  The reference drives the network through the
external ``semantic_sam`` package (matcher/Matcher_SemanticSAM.py:23,
120-139: 0-1 normalized clicks on a 640 px bicubic-resized image, several
masks a click).

  backbone   SwinL pyramid (``models/swin.py``)
  pixel dec  1x1 projection + GroupNorm per level in MaskDINO's reversed
             order (res5, res4, res3), ``enc_layers`` layers of
             multi-scale deformable self-attention with sine position and
             level embeddings (``ops/deformable_attention.py``), then the
             FPN tail at 1/4: 1x1 (no bias) + GroupNorm on res2 plus the
             bilinear-upsampled encoder res3, 3x3 (no bias) + GroupNorm +
             ReLU, a biased 1x1 mask projection
  decoder    per click ``num_granularities`` learnt content queries with
             the click's sine position on the attention inputs; each layer
             self-attention among the click's queries, deformable
             cross-attention anchored at the click, FFN; a 3-layer mask MLP
             (its dot with the mask features: the masks) and an IoU head

Types follow the JAX package's promotion: with bf16-cast parameters the
backbone runs in bf16, while the float32 sine positions (and click
coordinates) promote both decoders' activations to float32, their
kernels widened per product (``layers.dense``); the encoding comes out in
float32.  GroupNorm and LayerNorm keep their statistics in float32.  The
bilinear upsample of the FPN tail goes through
``core/imaging.resize`` (``jax.image.resize`` semantics).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mars_tpu_torch.core import imaging
from mars_tpu_torch.models import layers as L
from mars_tpu_torch.models import swin as swin_m
from mars_tpu_torch.ops import deformable_attention as da


@dataclass(frozen=True)
class SemanticSamConfig:
    swin: swin_m.SwinConfig = field(default_factory=lambda: swin_m.SWIN_L)
    hidden: int = 256
    num_heads: int = 8
    enc_layers: int = 6
    dec_layers: int = 9
    num_points: int = 4
    ffn_dim: int = 2048
    num_granularities: int = 6
    input_size: int = 640  # Matcher_SemanticSAM.py:130 Resize(640)

    @property
    def feature_levels(self) -> int:
        return 3  # res3 (1/8), res4 (1/16), res5 (1/32)


SEMANTIC_SAM_L = SemanticSamConfig()
SEMANTIC_SAM_TINY = SemanticSamConfig(
    swin=swin_m.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4), window=4),
    hidden=32, num_heads=4, enc_layers=2, dec_layers=2, ffn_dim=64, num_points=2,
    input_size=64,
)


def _group_norm(p, x, groups: int = 32, eps: float = 1e-5):
    """torch GroupNorm over (B, ..., C): statistics per (sample, group)
    across the group's channels and every spatial position, in float32."""
    c = x.shape[-1]
    g = min(groups, c)
    xs = x.reshape(x.shape[0], -1, g, c // g).float()
    mean = xs.mean(dim=(1, 3), keepdim=True)
    var = (xs - mean).square().mean(dim=(1, 3), keepdim=True)
    xs = (xs - mean) * torch.rsqrt(var + eps)
    return (xs.reshape(x.shape) * p["scale"] + p["bias"]).to(x.dtype)


def _sine_embed_2d(coords: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """(..., 2) xy in [0, 1] → (..., dim) DETR sine embedding, [y, x]."""
    half = dim // 2
    i = torch.arange(half, device=coords.device)
    dim_t = temperature ** (2 * (i // 2) / half)
    x = coords[..., 0:1].float() * (2.0 * math.pi) / dim_t
    y = coords[..., 1:2].float() * (2.0 * math.pi) / dim_t
    even = i % 2 == 0
    x = torch.where(even, torch.sin(x), torch.cos(x))
    y = torch.where(even, torch.sin(y), torch.cos(y))
    return torch.cat([y, x], dim=-1)


def _level_grid(h: int, w: int) -> np.ndarray:
    """(h·w, 2) cell-centre xy: the deformable reference points
    (Deformable-DETR get_reference_points, linspace(0.5, H - 0.5) / H)."""
    gx, gy = np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1).astype(np.float32)


def _pos_grid(h: int, w: int) -> np.ndarray:
    """(h·w, 2) xy of the sine position embedding: detectron2's
    cumsum-normalized (i + 1) / (n + 1e-6), which MaskDINO and Mask2Former
    pixel decoders are trained with (a half-cell off ``_level_grid``)."""
    gx, gy = np.meshgrid((np.arange(w) + 1.0) / (w + 1e-6), (np.arange(h) + 1.0) / (h + 1e-6))
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _level_tables(shapes: Tuple[Tuple[int, int], ...], dim: int, device):
    """The sine position of every level's cells (L, dim) and the reference
    points (L, 2), made once a device."""
    pos = torch.cat([_sine_embed_2d(torch.from_numpy(_pos_grid(h, w)), dim)
                     for h, w in shapes]).to(device)
    refs = torch.from_numpy(np.concatenate([_level_grid(h, w) for h, w in shapes])).to(device)
    return pos, refs


def _ffn(p, x):
    return x + L.dense(p["fc2"], torch.relu(L.dense(p["fc1"], x)))


def _detr_self_attn(p, x, pos, num_heads: int):
    """DETR self-attention: the position on the queries and keys only (the
    packed-qkv layout split per component)."""
    b, l, d = x.shape
    hd = d // num_heads
    wq, wk, wv = p["qkv"]["kernel"].chunk(3, dim=1)
    bq, bk, bv = p["qkv"]["bias"].chunk(3)
    xp = x + pos
    q = L.dense({"kernel": wq, "bias": bq}, xp).reshape(b, l, num_heads, hd)
    k = L.dense({"kernel": wk, "bias": bk}, xp).reshape(b, l, num_heads, hd)
    v = L.dense({"kernel": wv, "bias": bv}, x).reshape(b, l, num_heads, hd)
    logits = torch.einsum("blhd,bmhd->bhlm", q * hd ** -0.5, k)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(b, l, d)
    return L.dense(p["proj"], out)


def _mlp3(p, x):
    x = torch.relu(L.dense(p["l0"], x))
    x = torch.relu(L.dense(p["l1"], x))
    return L.dense(p["l2"], x)


def feature_shapes(cfg: SemanticSamConfig, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
    """Per-level (h, w) in the flattened order res5, res4, res3."""
    p = cfg.swin.patch_size
    g = (h // p, w // p)
    return tuple((-(-g[0] // (2 ** s)), -(-g[1] // (2 ** s))) for s in (3, 2, 1))


def _conv3x3(kernel, x):
    """(B, H, W, Cin) · HWIO (3, 3, Cin, Cout), same padding, stride 1."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


def pixel_decoder(params, feats, cfg: SemanticSamConfig):
    """MaskDINO's MSDeformAttn pixel decoder over the pyramid ``feats``
    (stage0..stage3 = res2..res5, NHWC) → (memory (1, L, C), mask_feats
    (1, H/4, W/4, C)).  The flattened order is res5, res4, res3:
    ``input_proj0`` and ``level_embed[0]`` belong to res5."""
    srcs, shapes, level = [], [], []
    for lev, stage in enumerate(("stage3", "stage2", "stage1")):
        proj = params[f"input_proj{lev}"]
        f = _group_norm(proj["norm"], L.dense(proj["proj"], feats[stage]))
        b, h, w, c = f.shape
        shapes.append((h, w))
        srcs.append(f.reshape(b, h * w, c))
        level.append(params["level_embed"][lev][None].expand(h * w, c))
    shapes = tuple(shapes)
    memory = torch.cat(srcs, dim=1)
    pos, refs = _level_tables(shapes, cfg.hidden, memory.device)
    pos_all = (pos + torch.cat(level))[None]
    refs = refs[None, :, None, :].expand(1, refs.shape[0], len(shapes), 2)

    for i in range(cfg.enc_layers):
        lp = params[f"enc{i}"]
        attn = da.msda_layer(lp["msda"], memory + pos_all, refs, memory, shapes,
                             cfg.num_heads, cfg.num_points)
        memory = L.layer_norm(lp["ln1"], memory + attn)
        memory = L.layer_norm(lp["ln2"], _ffn(lp["ffn"], memory))

    # the FPN tail at 1/4: res3 is the last flattened segment
    lat = _group_norm(params["adapter"]["norm"],
                      L.dense(params["adapter"]["conv"], feats["stage0"]))
    h3, w3 = shapes[-1]
    enc3 = memory[:, -(h3 * w3):].reshape(1, h3, w3, cfg.hidden)
    up = imaging.resize(enc3, (lat.shape[1], lat.shape[2]), "bilinear")
    out = _conv3x3(params["layer"]["conv"]["kernel"], lat + up)
    out = torch.relu(_group_norm(params["layer"]["norm"], out))
    return memory, L.dense(params["mask_projection"], out)


def encode_image(params, image: torch.Tensor, cfg: SemanticSamConfig):
    """image (H, W, 3) normalized → (memory (1, L, C), mask_feats (1, H/4,
    W/4, C)): the backbone and the pixel decoder, once a target.  The
    level shapes are ``feature_shapes(cfg, H, W)``."""
    feats = swin_m.forward_features(params["backbone"], image[None], cfg.swin)
    return pixel_decoder(params, feats, cfg)


def predict_points(params, memory, mask_feats, points: torch.Tensor, cfg: SemanticSamConfig,
                   shapes, return_embeddings: bool = False):
    """points (K, 2) xy in [0, 1] → (masks (K, G, H/4, W/4) logits, iou
    (K, G)); with ``return_embeddings`` (emb (K, G, C), iou), the masks
    being emb · mask_feats (the head is linear, so averaging embeddings
    over clicks averages their logits).

    Each click's ``num_granularities`` queries self-attend among
    themselves and cross-attend at the click (the interactive branch);
    ``shapes``: the memory's level shapes (``feature_shapes``)."""
    k = points.shape[0]
    g = cfg.num_granularities
    shapes = tuple(shapes)
    pos = _sine_embed_2d(points, cfg.hidden)[:, None]  # (K, 1, C)
    q = params["granularity_embed"][None].expand(k, g, cfg.hidden)
    refs = points[:, None, None, :].expand(k, g, len(shapes), 2)
    for i in range(cfg.dec_layers):
        lp = params[f"dec{i}"]
        q = L.layer_norm(lp["ln1"], q + _detr_self_attn(lp["self_attn"], q, pos, cfg.num_heads))
        # the batch-1 memory is shared: msda_layer folds the clicks into it
        ca = da.msda_layer(lp["msda"], q + pos, refs, memory, shapes, cfg.num_heads,
                           cfg.num_points)
        q = L.layer_norm(lp["ln2"], q + ca)
        q = L.layer_norm(lp["ln3"], _ffn(lp["ffn"], q))
    emb = _mlp3(params["mask_embed"], q)  # (K, G, C)
    iou = _mlp3(params["iou_head"], q)[..., 0]
    if return_embeddings:
        return emb, iou
    return torch.einsum("kgc,bhwc->kghw", emb, mask_feats), iou


def param_shapes(cfg: SemanticSamConfig) -> dict:
    """Keyed as ``mars_tpu.models.semantic_sam.init_params``."""
    c = cfg.hidden

    def dense(di, do, bias=True):
        return {"kernel": (di, do), **({"bias": (do,)} if bias else {})}

    def norm():
        return {"scale": (c,), "bias": (c,)}

    def msda():
        return da.msda_param_shapes(c, cfg.num_heads, cfg.feature_levels, cfg.num_points)

    def ffn():
        return {"fc1": dense(c, cfg.ffn_dim), "fc2": dense(cfg.ffn_dim, c)}

    p = {"backbone": swin_m.param_shapes(cfg.swin),
         "level_embed": (cfg.feature_levels, c),
         "granularity_embed": (cfg.num_granularities, c),
         "adapter": {"conv": {"kernel": (cfg.swin.stage_dim(0), c)}, "norm": norm()},
         "layer": {"conv": {"kernel": (3, 3, c, c)}, "norm": norm()},
         "mask_projection": dense(c, c),
         "mask_embed": {"l0": dense(c, c), "l1": dense(c, c), "l2": dense(c, c)},
         "iou_head": {"l0": dense(c, c), "l1": dense(c, c), "l2": dense(c, 1)}}
    # input_proj0 belongs to res5 (pixel_decoder's reversed order)
    for lev, s in enumerate((3, 2, 1)):
        p[f"input_proj{lev}"] = {"proj": dense(cfg.swin.stage_dim(s), c), "norm": norm()}
    for i in range(cfg.enc_layers):
        p[f"enc{i}"] = {"msda": msda(), "ln1": norm(), "ln2": norm(), "ffn": ffn()}
    for i in range(cfg.dec_layers):
        p[f"dec{i}"] = {"self_attn": {"qkv": dense(c, 3 * c), "proj": dense(c, c)},
                        "msda": msda(), "ln1": norm(), "ln2": norm(), "ln3": norm(),
                        "ffn": ffn()}
    return p


# the parameter tree's sections, by the checkpoint section that fills them
PIXEL_DECODER_KEYS = ("level_embed", "input_proj0", "input_proj1", "input_proj2", "adapter",
                      "layer", "mask_projection")
POINT_DECODER_KEYS = ("granularity_embed", "mask_embed", "iou_head")


def section_shapes(cfg: SemanticSamConfig) -> dict:
    """``param_shapes`` split by checkpoint section: {"backbone",
    "pixel_decoder", "point_decoder"}."""
    p = param_shapes(cfg)
    return {"backbone": p["backbone"],
            "pixel_decoder": {k: p[k] for k in PIXEL_DECODER_KEYS
                              + tuple(f"enc{i}" for i in range(cfg.enc_layers))},
            "point_decoder": {k: p[k] for k in POINT_DECODER_KEYS
                              + tuple(f"dec{i}" for i in range(cfg.dec_layers))}}
