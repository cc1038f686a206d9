"""Image files, resizing and polygon masks as Pillow 12.1.0 makes them,
without Pillow.

The benchmarks' loaders read every JPEG and PNG through ``read_image``,
``data.base.episode_host_u8`` resizes through ``resize``, and LVIS-92i's
and the part benchmarks' polygon annotations are drawn by
``polygon_mask``.  Each gives the bytes that Pillow 12.1.0 (on
libjpeg-turbo 3.1.3 and zlib) gives:

- ``read_image(path)`` is ``np.array(Image.open(path))`` and
  ``read_image(path, mode)`` is ``np.array(Image.open(path).convert(mode))``
  for ``mode`` in ``RGB``, ``L``.  JPEG is decoded by
  ``native/image_codecs.cpp`` (baseline, extended and progressive Huffman
  frames); a PNG is inflated by ``zlib`` and unfiltered there.  The file's
  format comes from its first bytes; any other format raises.
- ``resize`` is ``Image.resize((w, h), NEAREST | BILINEAR | BICUBIC)`` on
  uint8 ``L`` and ``RGB`` images: Pillow's ``Resample.c`` (a separable
  convolution in 22-bit fixed point, horizontal pass first, each pass
  rounded and clipped to 8 bits; the coefficients in numpy, the sums in
  the codecs' library) and, for NEAREST, its affine scaling
  (``Geometry.c``: source positions accumulated in double).
- ``polygon_mask`` is ``ImageDraw.Draw(L image).polygon(points, fill=1,
  outline=1)`` per polygon (``Draw.c``'s edge-list fill, in the codecs'
  library).

What Pillow reads and this module does not (Adam7-interlaced and 16-bit
PNGs; lossless, hierarchical and arithmetic-coded JPEGs) raises
``ValueError`` naming it.
"""
from __future__ import annotations

import ctypes
import math
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

from mars_tpu_torch import native

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PIL.Image.Resampling's values
NEAREST, BILINEAR, BICUBIC = 0, 2, 3
_PRECISION_BITS = 32 - 8 - 2  # Resample.c: 8 bits of result, 2 of headroom
_ERR_LEN = 512


def _call(fn, *args) -> None:
    err = ctypes.create_string_buffer(_ERR_LEN)
    if fn(*args, err, _ERR_LEN) != 0:
        raise ValueError(err.value.decode())


# ---------------------------------------------------------------- decoding
def decode_jpeg(data: bytes) -> Tuple[np.ndarray, str]:
    """A JPEG file's bytes → (pixels, Pillow's mode): ``L`` (H, W),
    ``RGB`` (H, W, 3) or ``CMYK`` (H, W, 4), uint8."""
    lib = native.codecs_lib()
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(3, np.int32)
    _call(lib.jpeg_header, buf.ctypes.data, buf.size, info.ctypes.data)
    w, h, c = (int(v) for v in info)
    out = np.empty((h, w, c), np.uint8)
    _call(lib.jpeg_decode, buf.ctypes.data, buf.size, out.ctypes.data, out.size)
    mode = {1: "L", 3: "RGB", 4: "CMYK"}[c]
    return (out[:, :, 0] if c == 1 else out), mode


# (colour type, bit depth) → (Pillow's mode, samples a pixel)
_PNG_MODES = {(0, 1): ("1", 1), (0, 2): ("L", 1), (0, 4): ("L", 1), (0, 8): ("L", 1),
              (2, 8): ("RGB", 3), (3, 1): ("P", 1), (3, 2): ("P", 1), (3, 4): ("P", 1),
              (3, 8): ("P", 1), (4, 8): ("LA", 2), (6, 8): ("RGBA", 4)}


def decode_png(data: bytes) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """A PNG file's bytes → (pixels, Pillow's mode, palette): mode ``1``
    gives bool (H, W) with Pillow's bytes (0 and 255); ``L`` and ``P`` (palette indices) uint8 (H, W);
    ``LA``, ``RGB``, ``RGBA`` uint8 (H, W, C).  The palette, for ``P``, is
    (256, 3) uint8, black past the file's entries."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("PNG: bad signature")
    pos, idat, hdr, palette = 8, [], None, None
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: image file is truncated (no IEND chunk)")
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if pos + 12 + n > len(data):
            raise ValueError(f"PNG: image file is truncated (in a {tag!r} chunk)")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG: broken file: CRC mismatch in a {tag!r} chunk")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.zeros((256, 3), np.uint8)
            entries = np.frombuffer(body, np.uint8)[: 3 * (len(body) // 3)].reshape(-1, 3)
            palette[: min(256, len(entries))] = entries[:256]
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError("PNG: Adam7 interlace is not supported")
    if depth == 16:
        raise ValueError(f"PNG: 16-bit samples (colour type {ctype}) are not supported")
    if (ctype, depth) not in _PNG_MODES:
        raise ValueError(f"PNG: colour type {ctype} at bit depth {depth} is not supported")
    mode, samples = _PNG_MODES[(ctype, depth)]
    if mode == "P" and palette is None:
        raise ValueError("PNG: a palette image without a PLTE chunk")
    rowbytes = (w * samples * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: image file is truncated or broken ({e})") from None
    if len(raw) < h * (rowbytes + 1):
        raise ValueError("PNG: image file is truncated (short image data)")
    raw = np.frombuffer(raw, np.uint8)
    rows = np.empty((h, rowbytes), np.uint8)
    _call(native.codecs_lib().png_unfilter, raw.ctypes.data, h, rowbytes,
          max(1, samples * depth // 8), rows.ctypes.data)
    if depth == 8:
        px = rows.reshape(h, w, samples)
        return (px[:, :, 0] if samples == 1 else px), mode, palette
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # the high bits first
    vals = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    if mode == "1":  # Pillow's bool array holds 0 and 255 bytes
        return (vals * np.uint8(255)).astype(np.uint8).view(bool), mode, None
    if mode == "L":  # Pillow's L;2 and L;4 unpackers scale to 8 bits
        return (vals * (255 // ((1 << depth) - 1))).astype(np.uint8), mode, None
    return vals.astype(np.uint8), mode, palette


# ---------------------------------------------------------------- conversion
def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's ITU-R 601-2 luma in 16-bit fixed point (Convert.c's L24)."""
    x = rgb.astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Convert.c's cmyk2rgb: nk - c * nk / 255, with MULDIV255's rounding."""
    x = cmyk.astype(np.int32)
    nk = 255 - x[..., 3:4]
    t = x[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def convert(img: np.ndarray, mode: str, target: str,
            palette: Optional[np.ndarray] = None) -> np.ndarray:
    """Pillow's ``convert(target)`` for ``target`` in ``RGB``, ``L`` from
    ``1``, ``L``, ``P``, ``LA``, ``RGB``, ``RGBA`` or ``CMYK`` (the arrays
    ``decode_png`` / ``decode_jpeg`` give)."""
    if target not in ("RGB", "L"):
        raise ValueError(f"conversion to {target!r} is not supported (only 'RGB', 'L')")
    if mode == "1":
        gray = img.astype(np.uint8) * np.uint8(255)
    elif mode == "L":
        gray = img
    elif mode == "LA":
        gray = img[:, :, 0]
    elif mode == "P":
        rgb = palette[img]
        return rgb if target == "RGB" else _luma(rgb)
    elif mode in ("RGB", "RGBA", "CMYK"):
        rgb = _cmyk_to_rgb(img) if mode == "CMYK" else img[:, :, :3]
        return np.ascontiguousarray(rgb) if target == "RGB" else _luma(rgb)
    else:
        raise ValueError(f"conversion from {mode!r} is not supported")
    return np.repeat(gray[:, :, None], 3, axis=2) if target == "RGB" else gray.copy()


def read_image(path: str, mode: Optional[str] = None) -> np.ndarray:
    """``np.array(Image.open(path))``, or ``np.array(Image.open(path)
    .convert(mode))`` for ``mode`` in ``RGB``, ``L``, by the file's first
    bytes: JPEG or PNG, anything else raises."""
    with open(path, "rb") as f:
        data = f.read()
    palette = None
    if data[:3] == JPEG_MAGIC:
        img, src = decode_jpeg(data)
    elif data[:8] == PNG_MAGIC:
        img, src, palette = decode_png(data)
    else:
        raise ValueError(f"{path}: not a JPEG or PNG file (first bytes {data[:8]!r})")
    return img if mode is None else convert(img, src, mode, palette)


# ---------------------------------------------------------------- resizing
def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Resample.c's ``bicubic_filter`` (a = -0.5), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def _coefficients(in_size: int, out_size: int, resample: int):
    """Resample.c's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` →
    (first tap (out,), fixed-point coefficients (out, ksize), zero past
    each output's last tap)."""
    kernel, base_support = _FILTERS[resample]
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = kernel(((xmin[:, None] + taps[None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    live = taps[None] < xmax[:, None]
    w = np.where(live, w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # summed tap by tap, as the C loop sums
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << _PRECISION_BITS)
    k = np.trunc(np.where(scaled < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, np.where(live, k, 0)


def _pass(img: np.ndarray, axis: int, out_size: int, resample: int) -> np.ndarray:
    """One 8-bit pass of Resample.c along ``axis`` (1: horizontal, 0:
    vertical): the coefficients here, the sums in the codecs' library."""
    xmin, k = _coefficients(img.shape[axis], out_size, resample)
    src = np.ascontiguousarray(img)
    outer = int(np.prod(src.shape[:axis], dtype=np.int64))
    inner = int(np.prod(src.shape[axis + 1:], dtype=np.int64))
    out = np.empty(src.shape[:axis] + (out_size,) + src.shape[axis + 1:], np.uint8)
    xmin = np.ascontiguousarray(xmin, np.int64)
    k = np.ascontiguousarray(k, np.int32)
    _call(native.codecs_lib().resample_8bpc, src.ctypes.data, outer, src.shape[axis], inner,
          xmin.ctypes.data, k.ctypes.data, k.shape[1], out_size, out.ctypes.data)
    return out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Geometry.c's ``ImagingScaleAffine``: the source index of each output
    position, accumulated in double from the scale; -1 where it falls
    outside (Pillow leaves that pixel 0)."""
    a = float(in_size) / out_size
    pos, out = a * 0.5, np.empty(out_size, np.int64)
    for i in range(out_size):
        j = -1 if pos < 0.0 else int(pos)
        out[i] = j if j < in_size else -1
        pos += a
    return out


def resize(img: np.ndarray, width: int, height: int, resample: int) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 → (height, width[, C]) uint8, bit-equal to
    ``Image.fromarray(img).resize((width, height), resample)`` for
    ``resample`` in NEAREST, BILINEAR, BICUBIC."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8, got {img.dtype}")
    if width < 1 or height < 1:
        raise ValueError(f"resize to {width}x{height}")
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    if resample == NEAREST:
        ys, xs = _nearest_index(h, height), _nearest_index(w, width)
        out = img[np.maximum(ys, 0)][:, np.maximum(xs, 0)]
        if (ys < 0).any() or (xs < 0).any():
            out[ys < 0] = 0
            out[:, xs < 0] = 0
        return out
    if resample not in _FILTERS:
        raise ValueError(f"resample {resample} is not supported")
    out = img
    if width != w:
        out = _pass(out, 1, width, resample)
    if height != h:
        out = _pass(out, 0, height, resample)
    return out


# ---------------------------------------------------------------- polygons
def polygon_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO-style polygon lists (x0, y0, x1, y1, ...) drawn one after the
    other into an (h, w) zero image → {0, 1} uint8: Pillow 12.1.0's
    ``ImageDraw.Draw(img).polygon(points, outline=1, fill=1)`` for each
    list of 3 points or more (an odd trailing number is dropped).  Float
    points are truncated toward zero as Pillow 12's ``_draw_polygon`` does;
    points outside the image, self-intersecting and degenerate polygons
    fill as Pillow's do.  Pillow's polygon rules changed across its versions: this is
    12.1.0's."""
    img = np.zeros((h, w), np.uint8)
    lib = native.codecs_lib()
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            xy = np.ascontiguousarray(pts, np.float64)
            _call(lib.polygon_fill, xy.ctypes.data, len(pts), img.ctypes.data, w, h, 1)
    return img
