"""Matcher and MARS internal-state figures, drawn in numpy and written as
PNG with zlib (port of ``mars_tpu/utils/visualize.py``: ``plot_episode``,
``plot_matcher_state``; reference matcher/Matcher.py:872-1037
``visualize_internal_state``).

The JAX package draws with matplotlib; the port renders the same panels
itself, each on a ``TILE``-pixel square (nearest resize) in a grid of at
most ``COLS`` columns: the support shot with its mask blended in red, the
query (matched points as red crosses), the VVA and VTA priors through a
fixed 256-entry colour table (viridis, each prior min-max scaled as
matplotlib's autoscale does), the top four proposals by score, the merged
mask and the ground truth.  There is no font to draw text with, so the
title and the panel names (with each proposal's score) go into the PNG's
``tEXt`` chunks: ``Title``, ``Panels`` (JSON, in grid order) and ``Layout``
(JSON: tile, gap, cols, rows).  ``read_png`` decodes what ``write_png``
writes.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

import numpy as np

TILE = 160
GAP = 4
COLS = 5
TOP_PROPOSALS = 4
BACKGROUND = (255, 255, 255)
POINT_COLOR = (255, 0, 0)
# viridis at 0, 1/8, ..., 1, linearly interpolated to 256 entries
_VIRIDIS_ANCHORS = np.array([(68, 1, 84), (71, 44, 122), (59, 81, 139), (44, 113, 142),
                             (33, 144, 141), (39, 173, 129), (92, 200, 99), (170, 220, 50),
                             (253, 231, 37)], np.float64)
COLOR_TABLE = np.stack([np.interp(np.linspace(0, 1, 256), np.linspace(0, 1, 9),
                                  _VIRIDIS_ANCHORS[:, c]) for c in range(3)],
                       axis=1).round().astype(np.uint8)
# matplotlib's "Reds" at 0 and 1, blended over the support at alpha 0.4
# (2/5, in integers)
_REDS = np.array([(255, 245, 240), (103, 0, 13)], np.int64)


def _nearest(img: np.ndarray, tile: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(tile) * h) // tile
    xs = (np.arange(tile) * w) // tile
    return img[ys][:, xs]


def colorize(x: np.ndarray) -> np.ndarray:
    """(h, w) values → (h, w, 3) uint8 through ``COLOR_TABLE``, min-max
    scaled (a constant panel takes entry 0)."""
    x = np.asarray(x, np.float64)
    lo, hi = (float(x.min()), float(x.max())) if x.size else (0.0, 0.0)
    v = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    return COLOR_TABLE[np.clip((v * 256).astype(np.int64), 0, 255)]


def _rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img.astype(np.float64), 0, 1) * 255).astype(np.uint8)


def panel_image(img: np.ndarray, overlay: Optional[np.ndarray] = None,
                points: Optional[np.ndarray] = None, tile: int = TILE) -> np.ndarray:
    """One panel as it is drawn: (tile, tile, 3) uint8.  A 2-D ``img``
    goes through the colour table, an RGB one is taken as it is (float
    clipped to [0, 1]); ``overlay`` (a mask at ``img``'s size) is blended
    in red; ``points`` ((L, 2) x, y in ``img``'s pixels) become crosses."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    out = colorize(img) if img.ndim == 2 else _rgb(img)[..., :3]
    out = _nearest(out, tile).astype(np.int64)
    if overlay is not None:
        m = _nearest((np.asarray(overlay) > 0).astype(np.int64), tile)
        out = (out * 3 + _REDS[m] * 2 + 2) // 5
    out = out.astype(np.uint8)
    if points is not None:
        for x, y in np.asarray(points).reshape(-1, 2):
            cx, cy = int(x) * tile // w, int(y) * tile // h
            for d in range(-2, 3):
                for px, py in ((cx + d, cy + d), (cx + d, cy - d)):
                    if 0 <= px < tile and 0 <= py < tile:
                        out[py, px] = POINT_COLOR
    return out


def episode_panels(query_img, support_img=None, support_mask=None, points=None,
                   point_valid=None, vva=None, vta=None, proposals=None, proposal_valid=None,
                   scores=None, merged=None, gt=None) -> list:
    """The panels of ``plot_episode`` in grid order: [(name, image,
    overlay, points)], the JAX figure's selection (the top proposals are
    the first ``TOP_PROPOSALS`` by score, invalid ones left out)."""
    pts = None
    if points is not None:
        pv = point_valid if point_valid is not None else np.ones(len(points), bool)
        pts = np.asarray(points)[np.asarray(pv, bool)]
    panels = []
    if support_img is not None:
        panels.append(("support", support_img, support_mask, None))
    panels.append(("query + points", query_img, None, pts))
    if vva is not None:
        panels.append(("VVA prior", vva, None, None))
    if vta is not None:
        panels.append(("VTA prior", vta, None, None))
    if proposals is not None and proposal_valid is not None:
        proposal_valid = np.asarray(proposal_valid, bool)
        order = (np.argsort(-np.asarray(scores), kind="stable")[:TOP_PROPOSALS]
                 if scores is not None else np.flatnonzero(proposal_valid)[:TOP_PROPOSALS])
        for idx in order:
            if proposal_valid[idx]:
                label = f"prop#{idx}"
                if scores is not None:
                    label += f" s={float(scores[idx]):.2f}"
                panels.append((label, np.asarray(proposals[idx]), None, None))
    if merged is not None:
        panels.append(("merged", merged, None, None))
    if gt is not None:
        panels.append(("gt", gt, None, None))
    return panels


def layout(n: int, tile: int = TILE) -> dict:
    cols = min(n, COLS)
    return {"tile": tile, "gap": GAP, "cols": cols, "rows": -(-n // cols)}


def panel_box(i: int, lay: dict):
    """(y0, x0) of panel ``i``'s top-left pixel in the figure."""
    r, c = divmod(i, lay["cols"])
    step = lay["tile"] + lay["gap"]
    return lay["gap"] + r * step, lay["gap"] + c * step


def render(panels: list, tile: int = TILE):
    """Panels → (figure (H, W, 3) uint8, layout)."""
    lay = layout(len(panels), tile)
    step = tile + GAP
    fig = np.empty((GAP + lay["rows"] * step, GAP + lay["cols"] * step, 3), np.uint8)
    fig[:] = BACKGROUND
    for i, (_, img, overlay, pts) in enumerate(panels):
        y0, x0 = panel_box(i, lay)
        fig[y0:y0 + tile, x0:x0 + tile] = panel_image(img, overlay, pts, tile)
    return fig, lay


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray, text: Optional[dict] = None) -> str:
    """(H, W, 3) uint8 → an 8-bit RGB PNG (filter 0 on every row), with
    one ``tEXt`` chunk per entry of ``text`` (Latin-1; other characters
    become '?')."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    for k, v in (text or {}).items():
        chunks.append(_chunk(b"tEXt", k.encode("latin-1") + b"\0"
                             + str(v).encode("latin-1", errors="replace")))
    chunks.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    chunks.append(_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(chunks))
    return path


def read_png(path: str):
    """A PNG that ``write_png`` wrote → ((H, W, 3) uint8, {keyword: text}).
    Checks the signature and every chunk's CRC; takes 8-bit RGB, no
    interlace, filter 0 rows only (raises ValueError otherwise)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, text, hdr = 8, [], {}, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: CRC mismatch in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"tEXt":
            k, v = body.split(b"\0", 1)
            text[k.decode("latin-1")] = v.decode("latin-1")
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace: {hdr}")
    w, h = hdr[0], hdr[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy(), text


def plot_episode(out_path: str, query_img: np.ndarray, support_img=None, support_mask=None,
                 points=None, point_valid=None, vva=None, vta=None, proposals=None,
                 proposal_valid=None, scores=None, merged=None, gt=None,
                 title: str = "") -> str:
    """The episode's figure at ``out_path`` (JAX ``plot_episode``'s
    arguments and panels)."""
    panels = episode_panels(query_img, support_img, support_mask, points, point_valid, vva,
                            vta, proposals, proposal_valid, scores, merged, gt)
    fig, lay = render(panels)
    return write_png(out_path, fig, {"Title": title,
                                     "Panels": json.dumps([p[0] for p in panels]),
                                     "Layout": json.dumps(lay)})


def plot_matcher_state(out_path: str, query_img, generate_out: dict, title: str = "") -> str:
    """The figure straight from ``matcher.generate_proposals``' output."""
    g = {k: (v.detach().float().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
         for k, v in generate_out.items()
         if k in ("points", "point_valid", "proposal_masks", "proposal_valid", "emd_score",
                  "merged")}
    return plot_episode(out_path, query_img=np.asarray(query_img), points=g["points"],
                        point_valid=g["point_valid"].astype(bool),
                        proposals=g["proposal_masks"],
                        proposal_valid=g["proposal_valid"].astype(bool),
                        scores=g["emd_score"], merged=g["merged"], title=title)
