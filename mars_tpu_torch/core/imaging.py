"""Image transforms on tensors (port of ``mars_tpu/core/imaging.py``).

``resize`` reproduces ``jax.image.resize``, which the JAX package calls
with its default ``antialias=True``: per spatial axis an (in, out) weight
matrix built as ``jax._src.image.scale.compute_weight_mat`` builds it
(Keys cubic with A = -0.5 or the triangle kernel, scaled by
``max(in/out, 1)`` when antialiasing, columns normalised to sum 1, zero
where the sample falls outside ``[-0.5, in - 0.5]``), applied as one matmul
per axis.  ``F.interpolate`` computes something else (A = -0.75, border
clamp, no antialias).  Layout: images NHWC, maps (..., H, W).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_F32_EPS = float(torch.finfo(torch.float32).eps)


_CONSTANTS = {}


def _constant(values: Sequence[float], dtype, device) -> torch.Tensor:
    """``torch.tensor(values)`` on ``device``, made once: a fresh copy to the
    card would synchronise its stream on every call."""
    key = (tuple(values), dtype, str(device))
    if key not in _CONSTANTS:
        _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _CONSTANTS[key]


def normalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Channel-normalize an (..., H, W, 3) image in [0, 1]."""
    return ((img - _constant(mean, img.dtype, img.device))
            / _constant(std, img.dtype, img.device))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool,
                  device=None) -> torch.Tensor:
    """(in_size, out_size) float32 resampling weights, as jax.image builds
    them for a scale of out/in and no translation."""
    kernel = _KERNELS[method]
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample_f[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_axis(x: torch.Tensor, axis: int, size: int, method: str,
                 antialias: bool) -> torch.Tensor:
    n_in = x.shape[axis]
    if n_in == size:  # identity warp, skipped as jax.image skips it
        return x
    w = weight_matrix(n_in, size, method, antialias, x.device).to(x.dtype)
    return torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)


def resize(img: torch.Tensor, size: Tuple[int, int], method: str = "bilinear",
           antialias: bool = True) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., size[0], size[1], C) with
    ``jax.image.resize`` semantics ("bicubic" or "bilinear")."""
    img = _resize_axis(img, img.ndim - 3, size[0], method, antialias)
    return _resize_axis(img, img.ndim - 2, size[1], method, antialias)


def resize_2d(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear",
              antialias: bool = True) -> torch.Tensor:
    """Resize the last two axes of a (..., H, W) map with ``jax.image.resize``
    semantics.  Without a trailing channel axis each pass is one plain
    matrix product over all rows (a size-1 channel axis makes it a batch
    of matrix-vector products)."""
    x = _resize_axis(x, x.ndim - 2, size[0], method, antialias)
    return _resize_axis(x, x.ndim - 1, size[1], method, antialias)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image's nearest source index floor((i + 0.5) * in / out), f32."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def resize_mask(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of (..., H, W) masks (jax.image semantics)."""
    h, w = mask.shape[-2:]
    if h != size[0]:
        mask = mask[..., _nearest_index(h, size[0], mask.device), :]
    if w != size[1]:
        mask = mask[..., _nearest_index(w, size[1], mask.device)]
    return mask


def interpolate_2d(x: torch.Tensor, size: Tuple[int, int], method: str = "nearest") -> torch.Tensor:
    """Resize a (..., H, W) map.  "nearest" uses torch's F.interpolate
    indexing, floor(i * in / out), written out in integers."""
    if method != "nearest":
        return resize_2d(x, size, method)
    h, w = x.shape[-2:]
    ri = (torch.arange(size[0], device=x.device) * h) // size[0]
    ci = (torch.arange(size[1], device=x.device) * w) // size[1]
    return x[..., ri[:, None], ci[None, :]]


def masked_min_max_scale(x: torch.Tensor, valid: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Min-max scale a vector over its valid entries only."""
    big = torch.finfo(x.dtype).max
    mn = torch.where(valid, x, torch.full_like(x, big)).min()
    mx = torch.where(valid, x, torch.full_like(x, -big)).max()
    return torch.where(valid, (x - mn) / (mx - mn + eps), torch.zeros_like(x))


def _window_matrix(out_n: int, in_n: int, device) -> torch.Tensor:
    """(out, in) membership of torch's adaptive-pool windows
    [floor(i*in/out), ceil((i+1)*in/out))."""
    i = torch.arange(out_n, device=device)[:, None]
    j = torch.arange(in_n, device=device)[None, :]
    start = (i * in_n) // out_n
    end = -((-(i + 1) * in_n) // out_n)
    return (j >= start) & (j < end)


def adaptive_max_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Adaptive max pooling over the last two axes, torch-compatible windows."""
    h, w = x.shape[-2:]
    if h % out_h == 0 and w % out_w == 0:
        shp = x.shape[:-2] + (out_h, h // out_h, out_w, w // out_w)
        return x.reshape(shp).amax(dim=(-3, -1))
    wh = _window_matrix(out_h, h, x.device)
    ww = _window_matrix(out_w, w, x.device)
    neg = torch.finfo(x.dtype).min
    xh = torch.where(wh[:, :, None], x[..., None, :, :], neg).amax(dim=-2)
    return torch.where(ww[None, :, :], xh[..., :, None, :], neg).amax(dim=-1)


def adaptive_avg_pool(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Adaptive average pooling over the last two axes."""
    h, w = x.shape[-2:]
    if h % out_h == 0 and w % out_w == 0:
        shp = x.shape[:-2] + (out_h, h // out_h, out_w, w // out_w)
        return x.reshape(shp).mean(dim=(-3, -1))
    wh = _window_matrix(out_h, h, x.device).to(x.dtype)
    ww = _window_matrix(out_w, w, x.device).to(x.dtype)
    wh = wh / wh.sum(dim=1, keepdim=True)
    ww = ww / ww.sum(dim=1, keepdim=True)
    return torch.einsum("...hw,oh,pw->...op", x, wh, ww)


def pool_mask_to_grid(mask: torch.Tensor, grid: int) -> torch.Tensor:
    """Max-pool a (..., H, W) binary mask to (..., grid, grid)."""
    return adaptive_max_pool(mask.float(), grid, grid)


def pooled_footprint_host(mask: np.ndarray, grid: int) -> np.ndarray:
    """``pool_mask_to_grid(mask, grid) > 0`` of a host (..., H, W) mask, in
    numpy: a cell is set where any pixel of its window (torch's adaptive
    windows) is positive."""
    pos = np.asarray(mask) > 0
    h, w = pos.shape[-2:]

    def windows(n):
        i = np.arange(grid)
        return (i * n) // grid, -((-(i + 1) * n) // grid)

    (r0, r1), (c0, c1) = windows(h), windows(w)
    rows = np.stack([pos[..., a:b, :].any(axis=-2) for a, b in zip(r0, r1)], axis=-2)
    return np.stack([rows[..., a:b].any(axis=-1) for a, b in zip(c0, c1)], axis=-1)
