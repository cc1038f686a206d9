"""ResNet (torchvision v1.5 bottlenecks), the Matcher's alternative encoder
(port of ``mars_tpu/models/resnet.py``; reference
utils/backbone_loader.py:100-151, matcher/Matcher.py:286-288).

Inference only: BatchNorm is folded into a per-channel scale and bias at
conversion, and the 3x3 convolution carries the stride.  Images and feature
maps are NHWC, as in the JAX package; the convolutions run NCHW on
cuDNN.  Padding is XLA's "SAME" (for a stride-2 3x3 on an even size: none
before, one after), as the JAX package computes it: torchvision pads one
on each side, so a stride-2 block's output departs from torchvision's
(ROADMAP Queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from mars_tpu_torch.models import convert

BOTTLENECK_LAYERS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


@dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 23, 3)  # resnet101
    width: int = 64
    patch_size: int = 32  # downsampling factor ("patch size" per the loader)
    embed_dim: int = 2048


def param_shapes(cfg: ResNetConfig) -> dict:
    """The trunk's leaf shapes (HWIO kernels, folded BN)."""
    def conv(kh, kw, ci, co):
        return {"kernel": (kh, kw, ci, co)}

    def bn(c):
        return {"scale": (c,), "bias": (c,)}

    out = {"stem": conv(7, 7, 3, cfg.width), "stem_bn": bn(cfg.width)}
    cin = cfg.width
    for s, n in enumerate(cfg.layers):
        planes = cfg.width * 2 ** s
        stage = {}
        for b in range(n):
            blk = {"conv1": conv(1, 1, cin, planes), "bn1": bn(planes),
                   "conv2": conv(3, 3, planes, planes), "bn2": bn(planes),
                   "conv3": conv(1, 1, planes, planes * 4), "bn3": bn(planes * 4)}
            if b == 0:
                blk["downsample"] = {"conv": conv(1, 1, cin, planes * 4), "bn": bn(planes * 4)}
            stage[f"block{b}"] = blk
            cin = planes * 4
        out[f"layer{s + 1}"] = stage
    return out


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride=1):
    """NCHW x, HWIO kernel, XLA "SAME" padding."""
    w = p["kernel"].permute(3, 2, 0, 1)
    kh, kw = w.shape[-2:]
    top, bottom = _same_pad(x.shape[-2], kh, stride)
    left, right = _same_pad(x.shape[-1], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.to(x.dtype), stride=stride)


def _bn(p, x):
    return x * p["scale"][:, None, None] + p["bias"][:, None, None]


def _bottleneck(p, x, stride):
    h = torch.relu(_bn(p["bn1"], _conv(p["conv1"], x)))
    h = torch.relu(_bn(p["bn2"], _conv(p["conv2"], h, stride)))
    h = _bn(p["bn3"], _conv(p["conv3"], h))
    identity = x
    if "downsample" in p:
        identity = _bn(p["downsample"]["bn"], _conv(p["downsample"]["conv"], x, stride))
    return torch.relu(h + identity)


def forward_features(params, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """(B, H, W, 3) normalised → (B, H/32, W/32, embed_dim)."""
    x = images.permute(0, 3, 1, 2)
    x = F.conv2d(x, params["stem"]["kernel"].permute(3, 2, 0, 1).to(x.dtype), stride=2,
                 padding=3)
    x = torch.relu(_bn(params["stem_bn"], x))
    x = F.max_pool2d(x, 3, stride=2, padding=1)  # -inf padding, as reduce_window's
    for s, n in enumerate(cfg.layers):
        for b in range(n):
            x = _bottleneck(params[f"layer{s + 1}"][f"block{b}"], x,
                            2 if (b == 0 and s > 0) else 1)
    return x.permute(0, 2, 3, 1)


def patch_features(feat_map: torch.Tensor, l2_normalize: bool = True) -> torch.Tensor:
    """(B, h, w, C) → (B·h·w, C), the Matcher's convnets feature layout
    (reference Matcher.py:286-292), unit rows with ``l2_normalize``."""
    f = feat_map.reshape(-1, feat_map.shape[-1])
    if l2_normalize:
        f = f / torch.clamp(torch.linalg.vector_norm(f, dim=-1, keepdim=True), min=1e-12)
    return f


def convert_torchvision(sd: dict, cfg: ResNetConfig, device="cpu") -> dict:
    """torchvision state dict (numpy) → the trunk's tree of tensors."""
    return convert.from_jax_params(convert.resnet_tree(sd, cfg.layers), device)
