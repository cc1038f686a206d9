"""CLIP's image processor (transformers' ``CLIPImageProcessor``) from a
``preprocessor_config.json``, without transformers or PIL.

An (H, W, 3) uint8 image → (3, crop, crop) float32 in its steps and types:
convert to RGB (gray replicated, alpha dropped, as PIL's ``convert("RGB")``),
resize the shortest edge to ``size["shortest_edge"]`` (the long edge
``int(edge * long / short)``), centre-crop to ``crop_size`` (zero padding
where the image is smaller), rescale (float64 product, rounded to float32),
normalise by ``image_mean`` / ``image_std`` in float32.

transformers resizes through PIL, so ``resize_bicubic`` rebuilds PIL's
``BICUBIC`` (Pillow's ``Resample.c``) bit for bit in uint8: a separable
convolution with the cubic kernel (a = -0.5) stretched by the scale when
shrinking (antialiased), the taps normalised in float64 and rounded to
22 fractional bits, the horizontal pass first, each pass rounded and
clipped to 8 bits.  It is neither ``F.interpolate`` nor
``core.imaging``'s rebuild of ``jax.image.resize``.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

PREPROCESSOR_FILE = "preprocessor_config.json"
BICUBIC = 3  # PIL.Image.Resampling.BICUBIC, the ``resample`` the processor takes
_PRECISION_BITS = 32 - 8 - 2  # Resample.c: 8 bits of result, 2 of headroom
# the flags this processor implements, each with the one value it takes
_FIXED = {"do_convert_rgb": True, "do_resize": True, "do_center_crop": True,
          "do_rescale": True, "do_normalize": True, "resample": BICUBIC}


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's ``bicubic_filter`` (a = -0.5), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(in_size: int, out_size: int):
    """Resample.c's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` →
    (first tap (out,), fixed-point coefficients (out, ksize), zero past
    each output's last tap)."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((xmin[:, None] + taps[None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    live = taps[None] < xmax[:, None]
    w = np.where(live, w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # summed tap by tap, as the C loop sums
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(scaled < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, np.where(live, k, 0)


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit pass of Resample.c along ``axis`` (1: horizontal, 0: vertical)."""
    xmin, k = _coefficients(img.shape[axis], out_size)
    src = img.astype(np.int64)
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, img.shape[axis] - 1)  # taps past xmax weigh 0
        tap = np.take(src, idx, axis=axis)
        kj = k[:, j].reshape((-1,) + (1,) * (img.ndim - axis - 1))
        acc += tap * kj
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) uint8 → (height, width, C) uint8, bit-equal to
    ``PIL.Image.fromarray(img).resize((width, height), Image.BICUBIC)``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bicubic takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    out = img
    if width != w:
        out = _pass(out, 1, width)
    if height != h:
        out = _pass(out, 0, height)
    return out


def to_rgb(image) -> np.ndarray:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 → (H, W, 3)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"the image processor takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"the image processor takes (H, W[, 1|3|4]) images, got {img.shape}")
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


class ClipImageProcessor:
    """``preprocessor_config.json`` parsed → ``__call__(image)`` giving the
    (3, crop_h, crop_w) float32 pixel values.  A flag with another value
    than ``_FIXED``'s, or a ``size`` without ``shortest_edge``, raises."""

    def __init__(self, config: dict):
        for key, want in _FIXED.items():
            if config.get(key, want) != want:
                raise ValueError(f"{PREPROCESSOR_FILE}: {key} = {config[key]!r} is not "
                                 f"implemented (only {want!r})")
        size = config.get("size", {"shortest_edge": 224})
        if not isinstance(size, dict) or set(size) != {"shortest_edge"}:
            raise ValueError(f"{PREPROCESSOR_FILE}: size {size!r} is not implemented "
                             f"(only {{'shortest_edge': N}})")
        crop = config.get("crop_size", {"height": 224, "width": 224})
        if isinstance(crop, int):
            crop = {"height": crop, "width": crop}
        self.shortest_edge = int(size["shortest_edge"])
        self.crop = (int(crop["height"]), int(crop["width"]))
        self.rescale_factor = config.get("rescale_factor", 1 / 255)
        self.mean = np.asarray(config.get("image_mean", [0.48145466, 0.4578275, 0.40821073]),
                               np.float32)
        self.std = np.asarray(config.get("image_std", [0.26862954, 0.26130258, 0.27577711]),
                              np.float32)

    def resize(self, img: np.ndarray) -> np.ndarray:
        """The shortest edge to ``shortest_edge``: transformers'
        ``get_resize_output_image_size(default_to_square=False)``."""
        h, w = img.shape[:2]
        short, long = (w, h) if w <= h else (h, w)
        new_short, new_long = self.shortest_edge, int(self.shortest_edge * long / short)
        oh, ow = (new_long, new_short) if w <= h else (new_short, new_long)
        return resize_bicubic(img, ow, oh)

    def center_crop(self, img: np.ndarray) -> np.ndarray:
        """transformers' ``center_crop``: the centre window, zero-padded
        where the image is smaller than the crop."""
        h, w = img.shape[:2]
        ch, cw = self.crop
        top, left = (h - ch) // 2, (w - cw) // 2
        if top >= 0 and left >= 0:
            return img[top:top + ch, left:left + cw]
        nh, nw = max(ch, h), max(cw, w)
        pad = np.zeros((nh, nw) + img.shape[2:], img.dtype)
        tp, lp = math.ceil((nh - h) / 2), math.ceil((nw - w) / 2)
        pad[tp:tp + h, lp:lp + w] = img
        top, left = top + tp, left + lp
        return pad[max(0, top):min(nh, top + ch), max(0, left):min(nw, left + cw)]

    def __call__(self, image) -> np.ndarray:
        img = self.center_crop(self.resize(to_rgb(image)))
        x = (img.astype(np.float64) * self.rescale_factor).astype(np.float32)
        x = (x - self.mean) / self.std
        return np.ascontiguousarray(x.transpose(2, 0, 1))


def load(path: str) -> ClipImageProcessor:
    """The image processor of a transformers directory."""
    with open(os.path.join(path, PREPROCESSOR_FILE)) as f:
        config = json.load(f)
    kind = config.get("image_processor_type", "CLIPImageProcessor")
    if kind != "CLIPImageProcessor":
        raise ValueError(f"{PREPROCESSOR_FILE}: image_processor_type {kind!r} is not "
                         f"implemented (only 'CLIPImageProcessor')")
    return ClipImageProcessor(config)
