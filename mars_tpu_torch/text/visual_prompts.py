"""Visual-prompt drawing for the VLM's queries, on the host, without cv2
(port of ``mars_tpu/text/visual_prompts.py``).

Mask fill, bounding boxes, mask contours and ellipses, alpha-blended onto
the support image, with an optional zoom-crop around the masked object
(reference mars/components/VisualPromptGenerator.py:6-301).  The JAX module
calls cv2; every call it makes has an integer rasteriser here that gives the
same bytes:

  - ``find_external_contours``: ``cv2.findContours(RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)``, the Suzuki-Abe border following on a zero-padded
    copy, with cv2's marks (2 for a border pixel, -126 for one whose right
    neighbour is background) deciding which outer borders lie in a hole;
  - ``bounding_rect``, ``min_area_rect`` (Sklansky's hull and the rotating
    calipers, in float32 as cv2 computes them);
  - ``polylines`` / ``rectangle`` / ``ellipse``: cv2's ``drawing.cpp`` at
    ``LINE_8``: a thick segment is a ``FillConvexPoly`` quad in 16-bit
    fixed point plus a filled circle at each joint, a thin one a Bresenham
    line; ellipses go through ``ellipse2Poly``'s one-degree sine table;
  - ``add_weighted``: ``cv2.addWeighted`` on uint8 (float32, rounded half
    to even);
  - ``resize_linear``: ``cv2.resize(INTER_LINEAR)`` on uint8, 11-bit fixed
    point coefficients in two passes, the vertical pass in cv2's SIMD
    rounding (high halves of 16-bit products, then a rounding shift).
"""
from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_F32 = np.float32

# ellipse2Poly's table: sin of each whole degree 0..450, as float32 of the
# value rounded to 7 decimals
SIN_TABLE = np.array([float(f"{math.sin(math.radians(d)):.7f}") for d in range(451)],
                     np.float32)

# chain directions: 0 = right, then counter-clockwise on screen (y down)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)


# --------------------------------------------------------------------------
# contours
# --------------------------------------------------------------------------

def _trace(img, y, x):
    """Follow the outer border that starts at (y, x) (padded coordinates),
    mark its pixels as cv2 does and return its CHAIN_APPROX_SIMPLE points
    (unpadded x, y)."""
    s = 4
    for s in (3, 2, 1, 0, 7, 6, 5):  # clockwise from the left neighbour
        if img[y + _DY[s], x + _DX[s]] != 0:
            break
    else:  # a single pixel
        img[y, x] = -126
        return [(x - 1, y - 1)]
    y1, x1 = y + _DY[s], x + _DX[s]
    pts = []
    y3, x3 = y, x
    prev_s = s ^ 4
    while True:
        s_end = s
        while True:  # the next border pixel, counter-clockwise from s_end
            s += 1
            y4, x4 = y3 + _DY[s & 7], x3 + _DX[s & 7]
            if img[y4, x4] != 0 or s >= 15:
                break
        s &= 7
        if 0 < s <= s_end:  # the right neighbour was examined: background
            img[y3, x3] = -126
        elif img[y3, x3] == 1:
            img[y3, x3] = 2
        if s != prev_s:
            pts.append((x3 - 1, y3 - 1))
            prev_s = s
        if (y4, x4) == (y, x) and (y3, x3) == (y1, x1):
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return pts


def find_external_contours(mask) -> list:
    """The outer borders of the mask's 8-connected components that lie in
    no hole of another, as (N, 2) int32 (x, y) corner points, in cv2's
    order (the last found first)."""
    m = np.asarray(mask).reshape(np.asarray(mask).shape[:2])
    h, w = m.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = m != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        x, prev, lnbd = 1, 0, 0
        while x <= w:
            change = np.flatnonzero(row[x:w + 1] != prev)
            if change.size == 0:
                break
            x += int(change[0])
            p = int(row[x])
            if prev == 0 and p == 1 and row[lnbd] <= 0:
                found.append(np.asarray(_trace(img, y, x), np.int32))
                lnbd = x
                prev = int(row[x])
                x += 1
                continue
            prev = p
            if prev & -2:  # a marked border pixel
                lnbd = x
            x += 1
    return found[::-1]


def bounding_rect(points) -> tuple:
    """cv2.boundingRect of integer points → (x, y, w, h)."""
    pts = np.asarray(points).reshape(-1, 2)
    x0, y0 = pts.min(axis=0)
    x1, y1 = pts.max(axis=0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


# --------------------------------------------------------------------------
# convex hull and minimum-area rectangle
# --------------------------------------------------------------------------

def _sign(v):
    return (v > 0) - (v < 0)


def _sklansky(pts, start, end, nsign, sign2):
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or pts[start] == pts[end]:
        return [start]
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur][1], pts[pnext][1]
        by = nexty - cury
        if _sign(by) != nsign:
            ax = pts[pcur][0] - pts[pprev][0]
            bx = pts[pnext][0] - pts[pcur][0]
            ay = cury - pts[pprev][1]
            convexity = ay * bx - ax * by
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points) -> np.ndarray:
    """cv2.convexHull(points, clockwise=False, returnPoints=True) of integer
    points: Sklansky's scan over the points sorted by (x, y)."""
    data = [tuple(int(v) for v in p) for p in np.asarray(points).reshape(-1, 2)]
    total = len(data)
    order = sorted(range(total), key=lambda i: (data[i][0], data[i][1], i))
    pts = [data[i] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if pts[miny][1] > pts[i][1]:
            miny = i
        if pts[maxy][1] < pts[i][1]:
            maxy = i
    if pts[0] == pts[-1]:
        hull = [order[0]]
    else:
        tl = _sklansky(pts, 0, maxy, -1, 1)
        tr = _sklansky(pts, total - 1, maxy, -1, -1)
        tl, tr = tr, tl  # counter-clockwise
        hull = [order[i] for i in tl[:-1]] + [order[tr[i]] for i in range(len(tr) - 1, 0, -1)]
        stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
        bl = _sklansky(pts, 0, miny, 1, -1)
        br = _sklansky(pts, total - 1, miny, 1, 1)
        if stop >= 0:
            check = (bl[1] if len(bl) > 2 else br[2 - len(bl)] if len(bl) + len(br) > 2
                     else -1)
            if check == stop or (check >= 0 and pts[check] == pts[stop]):
                # every point on one line: the bottom half mirrors the top
                bl, br = bl[:2], br[:2]
        hull += [order[i] for i in bl[:-1]] + [order[br[i]] for i in range(len(br) - 1, 0, -1)]
        hull = _cyclic_ascending(hull)
    return np.asarray([data[i] for i in hull], np.int32)


def _cyclic_ascending(hull):
    """cv2's cyclic shift that makes the hull's indices one ascending or
    descending run, where one exists."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_idx = max_idx = lt = 0
    for i in range(1, nout):
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
    mmdist = abs(max_idx - min_idx)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_idx + 1) % nout == min_idx
        i0 = min_idx if ascending else max_idx
        if i0 > 0:
            out, j = [], i0
            for i in range(nout):
                cur = hull[j]
                out.append(cur)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (cur < hull[nj]):
                    return hull
                j = nj
            return out
    return hull


def _rotating_calipers(p):
    """cv2's rotatingCalipers(CALIPERS_MINAREARECT) over hull points ``p``
    (float32), every operation in float32 → (corner, side1, side2)."""
    n = len(p)
    vect = []
    inv_len = []
    left = bottom = right = top = 0
    pt0 = p[0]
    left_x = right_x = pt0[0]
    top_y = bottom_y = pt0[1]
    for i in range(n):
        if pt0[0] < left_x:
            left_x, left = pt0[0], i
        if pt0[0] > right_x:
            right_x, right = pt0[0], i
        if pt0[1] > top_y:
            top_y, top = pt0[1], i
        if pt0[1] < bottom_y:
            bottom_y, bottom = pt0[1], i
        pt = p[i + 1 if i + 1 < n else 0]
        dx, dy = float(pt[0]) - float(pt0[0]), float(pt[1]) - float(pt0[1])
        vect.append((_F32(dx), _F32(dy)))
        inv_len.append(_F32(1.0 / math.sqrt(dx * dx + dy * dy)))
        pt0 = pt
    orientation = _F32(0)
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for i in range(n):
        bx, by = float(vect[i][0]), float(vect[i][1])
        conv = ax * by - ay * bx
        if conv != 0:
            orientation = _F32(1) if conv > 0 else _F32(-1)
            break
        ax, ay = bx, by
    base_a, base_b = orientation, _F32(0)
    seq = [bottom, right, top, left]
    minarea = _F32(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        # the caliper side of least angle to its edge: each edge turned by
        # its caliper's quarter turns, then compared by the sign of a dot
        # product (exact: the edges are integer vectors)
        v0, v1, v2, v3 = (vect[seq[j]] for j in range(4))
        rot = (v0, (v1[1], -v1[0]), (-v2[0], -v2[1]), (-v3[1], v3[0]))
        main = 0
        for j in range(1, 4):
            if rot[j][1] * rot[main][0] - rot[j][0] * rot[main][1] < 0:
                main = j
        pi = seq[main]
        lead_x, lead_y = vect[pi][0] * inv_len[pi], vect[pi][1] * inv_len[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y),
                          (-lead_y, lead_x))[main]
        seq[main] = 0 if seq[main] + 1 == n else seq[main] + 1
        dx, dy = p[seq[1]][0] - p[seq[3]][0], p[seq[1]][1] - p[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx, dy = p[seq[2]][0] - p[seq[0]][0], p[seq[2]][1] - p[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i3, a1, width, b1, height, i0 = best
    a2, b2 = -b1, a1
    c1 = a1 * p[i3][0] + p[i3][1] * b1
    c2 = a2 * p[i0][0] + p[i0][1] * b2
    idet = _F32(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (px, py), (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points) -> tuple:
    """cv2.minAreaRect of integer points → ((cx, cy), (w, h), angle), the
    numbers float32 values as cv2 returns them: the rotating calipers over
    the counter-clockwise hull, the angle in [-90, 0) with ``w`` along it."""
    hull = convex_hull(points).astype(np.float32)
    p = [(_F32(x), _F32(y)) for x, y in hull]
    n = len(p)
    if n > 2:
        o0, o1, o2 = _rotating_calipers(p)
        cx = o0[0] + (o1[0] + o2[0]) * _F32(0.5)
        cy = o0[1] + (o1[1] + o2[1]) * _F32(0.5)
        w = _F32(math.sqrt(float(o1[0]) * float(o1[0]) + float(o1[1]) * float(o1[1])))
        h = _F32(math.sqrt(float(o2[0]) * float(o2[0]) + float(o2[1]) * float(o2[1])))
        rad = math.atan2(float(o1[1]), float(o1[0]))
    elif n == 2:
        cx = (p[0][0] + p[1][0]) * _F32(0.5)
        cy = (p[0][1] + p[1][1]) * _F32(0.5)
        dx, dy = float(p[1][0]) - float(p[0][0]), float(p[1][1]) - float(p[0][1])
        w, h = _F32(math.sqrt(dx * dx + dy * dy)), _F32(0)
        rad = math.atan2(dy, dx)
    else:
        cx, cy = (p[0] if n == 1 else (_F32(0), _F32(0)))
        w = h = _F32(0)
        rad = 0.0
    # the side's angle brought into [-90, 0) by quarter turns, the sides
    # swapped at each, in double precision from the radians
    ang = float(_F32(float(_F32(rad) * _F32(180)) / math.pi))
    turns = math.floor(ang / 90) + 1
    if turns:
        ang = float(_F32(math.degrees(rad - turns * math.pi / 2)))
        if turns % 2:
            w, h = h, w
    return (float(cx), float(cy)), (float(w), float(h)), float(ang)


# --------------------------------------------------------------------------
# drawing (cv2 drawing.cpp, LINE_8, 3-channel uint8)
# --------------------------------------------------------------------------

def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(img, x, y, color):
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img, y, x1, x2, color):
    if x1 <= x2:
        img[y, x1:x2 + 1] = color


def _clip_line(w, h, x1, y1, x2, y2):
    """cv2.clipLine on an image of w x h → (visible, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, x1, y1, x2, y2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img, x1, y1, x2, y2, color):
    """cv2's Line: an 8-connected LineIterator, left to right."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= y1 < h and 0 <= x2 < w and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    # step along the major axis; the minor one when err goes negative
    major_x = dx >= dy
    if not major_x:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = color
        if err < 0:
            err += dx + dx - (dy + dy)
            x += sx
            y += sy
        else:
            err -= dy + dy
            if major_x:
                x += sx
            else:
                y += sy


def _line2(img, x1, y1, x2, y2, color):
    """cv2's Line2: an 8-connected line between XY_SHIFT fixed-point
    points."""
    h, w = img.shape[:2]
    ok, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _tdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, (x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            _put(img, x1, y1 >> XY_SHIFT, color)
            x1 += 1
            y1 += y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            _put(img, x1 >> XY_SHIFT, y1, color)
            x1 += x_step
            y1 += 1


def _fill_convex_poly(img, v, color, shift):
    """cv2's FillConvexPoly at LINE_8: the outline by Line2, then one span a
    scanline between the two edges walked from the top vertex."""
    h, w = img.shape[:2]
    n = len(v)
    delta = 1 << shift >> 1
    p0x, p0y = v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        px, py = px << (XY_SHIFT - shift), py << (XY_SHIFT - shift)
        if shift == 0:
            _line(img, p0x >> XY_SHIFT, p0y >> XY_SHIFT, px >> XY_SHIFT, py >> XY_SHIFT, color)
        else:
            _line2(img, p0x, p0y, px, py, color)
        p0x, p0y = px, py
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": ymin},
            {"idx": imin, "di": n - 1, "x": -XY_ONE, "dx": 0, "ye": ymin}]
    edges = n
    y = ymin
    half = XY_ONE >> 1
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = idx0 + e["di"]
                if idx >= n:
                    idx -= n
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e["ye"] = ty
                        e["dx"] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += e["di"]
                    if idx >= n:
                        idx -= n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + half) >> XY_SHIFT
            xx2 = (edge[right]["x"] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def _circle_filled(img, cx, cy, radius, color):
    """cv2's Circle(fill=1): midpoint circle, spans between its points."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(img, p0, p1, color, thickness, flags, shift):
    """cv2's ThickLine: a Line for thickness 1, else a filled quad
    of half-width thickness / 2 and, per ``flags``, a round cap."""
    x0, y0 = p0[0] << (XY_SHIFT - shift), p0[1] << (XY_SHIFT - shift)
    x1, y1 = p1[0] << (XY_SHIFT - shift), p1[1] << (XY_SHIFT - shift)
    if thickness <= 1:  # cv2 rounds the ends of a thin line, fixed point or not
        half = XY_ONE >> 1
        _line(img, (x0 + half) >> XY_SHIFT, (y0 + half) >> XY_SHIFT,
              (x1 + half) >> XY_SHIFT, (y1 + half) >> XY_SHIFT, color)
        return
    dx = (x0 - x1) * (1.0 / XY_ONE)
    dy = (y1 - y0) * (1.0 / XY_ONE)
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        quad = [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy), (x1 - dpx, y1 - dpy),
                (x1 + dpx, y1 + dpy)]
        _fill_convex_poly(img, quad, color, XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            half = XY_ONE >> 1
            _circle_filled(img, (x0 + half) >> XY_SHIFT, (y0 + half) >> XY_SHIFT,
                           (thick + half) >> XY_SHIFT, color)
        x0, y0 = x1, y1


def _poly_line(img, pts, closed, color, thickness, shift=0):
    if not len(pts):
        return
    i = len(pts) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = pts[i]
    for i in range(0 if closed else 1, len(pts)):
        _thick_line(img, p0, pts[i], color, thickness, flags, shift)
        p0 = pts[i]
        flags = 2


def draw_contours(img, contours, color, thickness):
    """cv2.drawContours(img, contours, -1, color, thickness), thickness >= 1:
    each contour a closed polyline."""
    for c in contours:
        _poly_line(img, [(int(x), int(y)) for x, y in np.asarray(c).reshape(-1, 2)], True,
                   color, thickness)


def rectangle(img, pt1, pt2, color, thickness):
    """cv2.rectangle with an outline of ``thickness`` >= 1."""
    (x1, y1), (x2, y2) = pt1, pt2
    _poly_line(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], True, color, thickness)


def ellipse2poly(center, axes, angle: int, delta: int):
    """cv2's double ellipse2Poly over the whole ellipse (arc 0..360): its
    points from the sine table, ``center`` and ``axes`` in any unit."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    alpha, beta = float(SIN_TABLE[450 - angle]), float(SIN_TABLE[angle])
    pts = []
    for i in range(0, 360 + delta, delta):
        a = min(i, 360)
        x = axes[0] * float(SIN_TABLE[450 - a])
        y = axes[1] * float(SIN_TABLE[a])
        pts.append((center[0] + x * alpha - y * beta, center[1] + x * beta + y * alpha))
    return pts


def ellipse(img, center, axes, angle: float, color, thickness):
    """cv2.ellipse(img, center, axes, angle, 0, 360, color, thickness >= 1)."""
    cx, cy = center[0] << XY_SHIFT, center[1] << XY_SHIFT
    aw, ah = abs(axes[0]) << XY_SHIFT, abs(axes[1]) << XY_SHIFT
    delta = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v, prev = [], None
    for px, py in ellipse2poly((float(cx), float(cy)), (float(aw), float(ah)),
                               int(np.rint(angle)), delta):
        qx, qy = int(np.rint(px / XY_ONE)) << XY_SHIFT, int(np.rint(py / XY_ONE)) << XY_SHIFT
        pt = (qx + int(np.rint(px - qx)), qy + int(np.rint(py - qy)))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    _poly_line(img, v, False, color, thickness, XY_SHIFT)


# --------------------------------------------------------------------------
# blending and resizing
# --------------------------------------------------------------------------

def add_weighted(src1, alpha: float, src2, beta: float, gamma: float = 0.0) -> np.ndarray:
    """cv2.addWeighted on uint8: src1 * alpha + (src2 * beta + gamma) in
    float32 (fused), rounded half to even, saturated."""
    a = np.float64(np.float32(alpha))
    b = np.float64(np.float32(beta))
    g = np.float64(np.float32(gamma))
    inner = (src2.astype(np.float64) * b + g).astype(np.float32).astype(np.float64)
    out = (src1.astype(np.float64) * a + inner).astype(np.float32)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


RESIZE_COEF_SCALE = 1 << 11


def _linear_coeffs(dst: int, src: int, clamp: bool):
    """Per destination index: the source index and the two 11-bit weights
    in cv2's float32 arithmetic, and the first index whose right neighbour
    lies past the source (xmax).  ``clamp``: the horizontal pass's edge
    clamps (the vertical pass clips its source rows instead)."""
    scale = 1.0 / (dst / src)
    ofs = np.empty(dst, np.int64)
    coef = np.empty((dst, 2), np.int64)
    xmax = dst
    for d in range(dst):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(math.floor(f))
        f = np.float32(f - np.float32(s))
        if clamp and s < 0:
            f, s = np.float32(0), 0
        if clamp and s + 1 >= src:
            xmax = min(xmax, d)
            if s >= src - 1:
                f, s = np.float32(0), src - 1
        ofs[d] = s
        for k, c in enumerate((np.float32(np.float32(1) - f), f)):
            coef[d, k] = int(np.clip(np.rint(np.float32(c * np.float32(RESIZE_COEF_SCALE))),
                                     -32768, 32767))
    return ofs, coef, xmax


def resize_linear(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(src, (width, height), interpolation=INTER_LINEAR) for an
    (H, W, C) uint8 image."""
    sh, sw = src.shape[:2]
    if (sh, sw) == (height, width):
        return src.copy()
    cn = src.shape[2]
    xofs, alpha, xmax = _linear_coeffs(width, sw, True)
    yofs, beta, _ = _linear_coeffs(height, sh, False)
    s = src.astype(np.int64)
    # horizontal pass: int sums of 11-bit weights; past xmax the last pixel
    right = np.minimum(xofs + 1, sw - 1)
    rows = s[:, xofs] * alpha[None, :, 0, None] + s[:, right] * alpha[None, :, 1, None]
    rows[:, xmax:] = s[:, xofs[xmax:]] * RESIZE_COEF_SCALE
    rows = rows.reshape(sh, width * cn)
    y0 = np.clip(yofs, 0, sh - 1)
    y1 = np.clip(yofs + 1, 0, sh - 1)
    s0, s1 = rows[y0], rows[y1]
    b0, b1 = beta[:, 0, None], beta[:, 1, None]
    # vertical pass in cv2's SIMD rounding: each row's product on its high
    # 16 bits (the sums shifted right by 4 first), then a rounding shift by 2
    out = ((np.clip(s0 >> 4, -32768, 32767) * b0) >> 16) \
        + ((np.clip(s1 >> 4, -32768, 32767) * b1) >> 16)
    out = (out + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(height, width, cn)


# --------------------------------------------------------------------------
# the generators (same signatures as the JAX module's)
# --------------------------------------------------------------------------

def zoom_on_masked_object(image: np.ndarray, mask: np.ndarray, zoom_percent: int) -> np.ndarray:
    """Crop around the mask's bounding box scaled by 100 / zoom_percent and
    resize back (reference :45-104)."""
    if zoom_percent <= 0:
        return image
    m = (mask.reshape(mask.shape[:2]) > 0).astype(np.uint8)
    contours = find_external_contours(m)
    if not contours:
        return image
    x, y, w, h = bounding_rect(np.concatenate(contours))
    cx, cy = x + w // 2, y + h // 2
    nw = min(int(w * (100 / zoom_percent)), image.shape[1])
    nh = min(int(h * (100 / zoom_percent)), image.shape[0])
    nx = max(0, cx - nw // 2)
    ny = max(0, cy - nh // 2)
    nx = min(nx, image.shape[1] - nw)
    ny = min(ny, image.shape[0] - nh)
    cropped = image[ny:ny + nh, nx:nx + nw]
    return resize_linear(cropped, image.shape[1], image.shape[0])


def draw_mask(image, mask, color=(255, 0, 0), alpha=0.5, thickness=2, zoom_percent=0):
    """Alpha-blended mask fill (reference MaskGenerator :106-152)."""
    m = (mask > 0).astype(float)[..., None]
    composite = alpha * (m * np.array(color)) + (1 - alpha) * image
    out = np.where(m, composite, image).astype(np.uint8)
    return zoom_on_masked_object(out, m, zoom_percent)


def _blend_overlay(image, overlay, alpha):
    return add_weighted(overlay, alpha, image, 1 - alpha, 0)


def draw_bbox(image, mask, color=(255, 0, 0), alpha=0.5, thickness=2, zoom_percent=0):
    """Per-contour bounding boxes (reference BoundingBoxGenerator :154-199)."""
    m = (mask > 0).astype(np.uint8)
    overlay = image.copy()
    for c in find_external_contours(m):
        x, y, w, h = bounding_rect(c)
        rectangle(overlay, (x, y), (x + w, y + h), color, thickness)
    return zoom_on_masked_object(_blend_overlay(image, overlay, alpha), m, zoom_percent)


def draw_contour(image, mask, color=(255, 0, 0), alpha=0.5, thickness=2, zoom_percent=0):
    """Mask contours (reference MaskContourGenerator :201-244; MARS's
    default prompt type, scripts/coco_1shot.sh --prompt_type contour)."""
    m = (mask > 0).astype(np.uint8)
    overlay = image.copy()
    draw_contours(overlay, find_external_contours(m), color, thickness)
    return zoom_on_masked_object(_blend_overlay(image, overlay, alpha), m, zoom_percent)


def draw_ellipse(image, mask, color=(255, 0, 0), alpha=0.5, thickness=2, zoom_percent=0):
    """Rotated ellipses 1.2x the min-area rectangle (reference
    EllipseGenerator :247-301)."""
    m = (mask > 0).astype(np.uint8)
    overlay = image.copy()
    for c in find_external_contours(m):
        (cx, cy), axes, angle = min_area_rect(c)
        ax = (axes[0] * 1.2, axes[1] * 1.2)
        ellipse(overlay, (int(cx), int(cy)), (int(ax[0] // 2), int(ax[1] // 2)), angle, color,
                thickness)
    return zoom_on_masked_object(_blend_overlay(image, overlay, alpha), m, zoom_percent)


GENERATORS = {
    "mask": draw_mask,
    "bb": draw_bbox,
    "contour": draw_contour,
    "ellipse": draw_ellipse,
}
