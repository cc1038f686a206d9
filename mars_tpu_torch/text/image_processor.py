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
clipped to 8 bits (``data.image_io.resize``, which also gives PIL's
bilinear and nearest).  It is neither ``F.interpolate`` nor
``core.imaging``'s rebuild of ``jax.image.resize``.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from mars_tpu_torch.data import image_io

PREPROCESSOR_FILE = "preprocessor_config.json"
BICUBIC = image_io.BICUBIC  # the ``resample`` the processor takes
# the flags this processor implements, each with the one value it takes
_FIXED = {"do_convert_rgb": True, "do_resize": True, "do_center_crop": True,
          "do_rescale": True, "do_normalize": True, "resample": BICUBIC}


def resize_bicubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) uint8 → (height, width, C) uint8, bit-equal to
    ``PIL.Image.fromarray(img).resize((width, height), Image.BICUBIC)``."""
    return image_io.resize(img, width, height, BICUBIC)


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
