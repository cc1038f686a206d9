"""Swin Transformer backbone (port of ``mars_tpu/models/swin.py``):
Semantic-SAM's SwinL, inference only.  NHWC, plain functions over the JAX
package's parameter tree.

Window and shifted-window attention with the relative-position bias,
patch merging between stages, each stage's feature map out.  As in torch's
Swin, every block zero-pads its input to window multiples and crops after;
a stage whose map is smaller than the window clamps the window to the map
(the bias index keeps the table's stride, ``_rel_index``) and drops the
shift when one window covers it.  The JAX package writes the attention as
an einsum (no Pallas kernel), so it is plain PyTorch here: float32
logits and softmax, probabilities in the tower's type.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mars_tpu_torch.models import layers as L


@dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 192  # Swin-L
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)


SWIN_L = SwinConfig()


def _rel_index(window: int, table_window: int = None) -> np.ndarray:
    """(ws², ws²) index into the relative-position-bias table, whose rows
    are laid out for ``table_window`` (stride ``2 * table_window - 1``):
    a window clamped below it reads the central offsets."""
    tw = table_window if table_window is not None else window
    assert window <= tw
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += tw - 1
    rel[:, :, 1] += tw - 1
    rel[:, :, 0] *= 2 * tw - 1
    return (rel[:, :, 0] + rel[:, :, 1]).astype(np.int32)


def _shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) additive mask of the shifted windows (-100 across
    regions)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws_ in slices:
            img[hs, ws_] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    return np.where(win[:, :, None] != win[:, None, :], -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rel_index_on(window: int, table_window: int, device) -> torch.Tensor:
    """``_rel_index`` on ``device``, made once: a fresh copy to the card
    would synchronise its stream on every block."""
    return torch.from_numpy(_rel_index(window, table_window)).long().to(device)


@functools.lru_cache(maxsize=None)
def _shift_mask_on(h: int, w: int, window: int, shift: int, device) -> torch.Tensor:
    return torch.from_numpy(_shift_mask(h, w, window, shift)).to(device)


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws², C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, c)


def _window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


def _window_attention(p, x, num_heads: int, rel_idx, mask=None):
    """x (nW·B, ws², C); mask (nW, ws², ws²) additive or None."""
    nwb, l, c = x.shape
    hd = c // num_heads
    q, k, v = L.dense(p["qkv"], x).reshape(nwb, l, 3, num_heads, hd).unbind(dim=2)
    logits = torch.einsum("blhd,bmhd->bhlm", q * hd ** -0.5, k).float()
    bias = p["rel_bias_table"][rel_idx]  # (ws², ws², heads)
    logits = logits + bias.permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(nwb // nw, nw, num_heads, l, l)
                  + mask[None, :, None]).reshape(nwb, num_heads, l, l)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(nwb, l, c)
    return L.dense(p["proj"], out)


def _swin_block(p, x, num_heads: int, window: int, shift: int, rel_idx, mask, ln_eps: float):
    b, h, w, c = x.shape
    y = L.layer_norm(p["ln1"], x, eps=ln_eps)
    # torch Swin zero-pads to window multiples inside every block and crops
    # after, so pad tokens enter each block as zeros
    ph, pw = -h % window, -w % window
    if ph or pw:
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
    if shift:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    y = _window_partition(y, window)
    y = _window_attention(p["attn"], y, num_heads, rel_idx, mask)
    y = _window_reverse(y, window, h + ph, w + pw)
    if shift:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    if ph or pw:
        y = y[:, :h, :w]
    x = x + y
    return x + L.mlp(p["mlp"], L.layer_norm(p["ln2"], x, eps=ln_eps), L.exact_gelu)


def _patch_merge(p, x, ln_eps: float):
    """(B, H, W, C) → (B, H/2, W/2, 2C): the 2×2 neighbours in torch's
    order (x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]),
    LayerNorm, then the 4C → 2C reduction."""
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                  dim=-1)
    return L.dense(p["reduction"], L.layer_norm(p["norm"], x, eps=ln_eps))


def forward_features(params, images: torch.Tensor, cfg: SwinConfig) -> dict:
    """images (B, H, W, 3) normalized → {"stage{i}": (B, Hi, Wi, Ci)}, each
    stage's map before its downsampling (the pyramid the pixel decoder
    reads)."""
    b, h, w, _ = images.shape
    x = L.conv_patch_embed(params["patch_embed"], images, cfg.patch_size)
    x = L.layer_norm(params["patch_norm"], x, eps=cfg.ln_eps)
    x = x.reshape(b, h // cfg.patch_size, w // cfg.patch_size, cfg.embed_dim)
    out = {}
    for s in range(cfg.num_stages):
        sh, sw = x.shape[1], x.shape[2]
        window = min(cfg.window, sh, sw)
        shift = 0 if min(sh, sw) <= window else window // 2
        rel_idx = _rel_index_on(window, cfg.window, x.device)
        mask = (_shift_mask_on(sh + (-sh % window), sw + (-sw % window), window, shift,
                               x.device) if shift else None)
        sp = params[f"stage{s}"]
        for i in range(cfg.depths[s]):
            blk_shift = shift if i % 2 else 0
            x = _swin_block(sp[f"block{i}"], x, cfg.num_heads[s], window, blk_shift, rel_idx,
                            mask if blk_shift else None, cfg.ln_eps)
        out[f"stage{s}"] = x
        if s + 1 < cfg.num_stages:
            if sh % 2 or sw % 2:  # torch's maybe_pad before the merge
                x = F.pad(x, (0, 0, 0, sw % 2, 0, sh % 2))
            x = _patch_merge(sp["downsample"], x, cfg.ln_eps)
    return out


def param_shapes(cfg: SwinConfig) -> dict:
    """Keyed as ``mars_tpu.models.swin.init_params``."""
    def ln(c):
        return {"scale": (c,), "bias": (c,)}

    p = {"patch_embed": {"kernel": (cfg.patch_size, cfg.patch_size, 3, cfg.embed_dim),
                         "bias": (cfg.embed_dim,)},
         "patch_norm": ln(cfg.embed_dim)}
    for s in range(cfg.num_stages):
        dim = cfg.stage_dim(s)
        hidden = int(dim * cfg.mlp_ratio)
        stage = {}
        for i in range(cfg.depths[s]):
            blk = L.block_shapes(dim, hidden)
            blk["attn"]["rel_bias_table"] = ((2 * cfg.window - 1) ** 2, cfg.num_heads[s])
            stage[f"block{i}"] = blk
        if s + 1 < cfg.num_stages:
            stage["downsample"] = {"norm": ln(4 * dim), "reduction": {"kernel": (4 * dim,
                                                                                 2 * dim)}}
        p[f"stage{s}"] = stage
    return p
