"""COCO run-length encoding in numpy (the port's own counterpart of
``mars_tpu/native/__init__.py:112-175`` and its C++ loops).

Uncompressed RLE is ``{"size": [h, w], "counts": [...]}``: column-major
runs that start with a run of zeros (segment_anything/utils/amg.py:107-136).
The compressed form is pycocotools' interchange string (``mask.encode``):
each count from the fourth on is taken as its difference with the count
two places before it, then written as a little-endian base-32 signed
varint, 5 payload bits a character, 0x20 the continuation bit, the sign
in bit 0x10 of the last chunk, every character offset by 48.
"""
from __future__ import annotations

import numpy as np


def rle_encode(mask: np.ndarray) -> dict:
    """(h, w) mask → uncompressed RLE; a pixel is 1 where its uint8 cast
    is nonzero (JAX's ``mask.astype(np.uint8)``)."""
    m = np.asarray(mask).astype(np.uint8)
    h, w = m.shape
    flat = (m.T.reshape(-1) != 0).astype(np.int8)
    if flat.size == 0:
        return {"size": [h, w], "counts": [0]}
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [h, w], "counts": [int(c) for c in counts]}


def rle_decode(rle: dict) -> np.ndarray:
    """Uncompressed or compressed RLE → (h, w) uint8 mask.  Runs past h·w
    are dropped; a short count list leaves the rest 0."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = string_to_counts(counts)
    counts = np.minimum(np.asarray(counts, np.int64), h * w)
    vals = (np.arange(len(counts)) % 2).astype(np.uint8)
    flat = np.repeat(vals, counts)[:h * w]
    flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return np.ascontiguousarray(flat.reshape(w, h).T)


def counts_to_string(counts) -> bytes:
    """Counts → pycocotools' compressed string."""
    counts = [int(c) for c in counts]
    out = bytearray()
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5  # Python's shift is arithmetic: a negative delta keeps its sign
            more = (x != -1) if ch & 0x10 else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def string_to_counts(s) -> list:
    """pycocotools' compressed string → counts."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts, p = [], 0
    while p < len(s):
        x, k, more, ch = 0, 0, True, 0
        while more and p < len(s):
            ch = s[p] - 48
            x |= (ch & 0x1F) << (5 * k)
            more = bool(ch & 0x20)
            p += 1
            k += 1
        if not more and ch & 0x10:
            x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x & 0xFFFFFFFF)
    return counts


def rle_compress(rle: dict) -> dict:
    """Uncompressed RLE → {"size": [h, w], "counts": bytes}."""
    return {"size": list(rle["size"]), "counts": counts_to_string(rle["counts"])}


def rle_encode_compressed(mask: np.ndarray) -> dict:
    """(h, w) mask → compressed RLE, byte for byte
    ``pycocotools.mask.encode(np.asfortranarray(mask))``."""
    return rle_compress(rle_encode(mask))


def rle_decode_compressed(rle: dict) -> np.ndarray:
    """Inverse of ``rle_encode_compressed`` (takes uncompressed lists too)."""
    return rle_decode(rle)
