"""The port's visual prompts (``mars_tpu_torch.text.visual_prompts``, no
cv2) against the JAX module's, which call cv2: every generator, zoom 0 and
50, thickness 1 and 2, on seeded masks with several components, holes,
one-pixel parts, shapes touching the image edge and an empty mask; and the
rasterisers one by one against cv2 (contours, bounding boxes, hulls,
thick and thin polylines, rectangles, ellipses, addWeighted, the bilinear
resize, the minimum-area rectangle).  Equality is bitwise."""
import cv2
import numpy as np
import pytest

from mars_tpu.text import visual_prompts as J
from mars_tpu_torch.text import visual_prompts as T


def _masks(seed=0):
    """(name, (H, W) uint8 mask) cases."""
    rng = np.random.RandomState(seed)
    h, w = 72, 88
    yy, xx = np.mgrid[:h, :w]
    out = [("empty", np.zeros((h, w), np.uint8))]
    m = np.zeros((h, w), np.uint8)
    m[10:40, 12:50] = 1
    m[20:30, 25:35] = 0  # a hole
    m[24:27, 28:31] = 1  # an island in the hole (not an external contour)
    m[50:60, 60:80] = 1
    m[5, 80] = 1  # one pixel
    m[66, 3] = 1
    out.append(("components_holes_pixels", m))
    edge = np.zeros((h, w), np.uint8)
    edge[:20, :30] = 1  # the top-left corner
    edge[40:, 70:] = 1  # the bottom-right corner
    edge[30:45, :3] = 1
    out.append(("edge_touching", edge))
    ring = (((yy - 36) ** 2 + (xx - 44) ** 2 < 30 ** 2)
            & ((yy - 36) ** 2 + (xx - 44) ** 2 >= 20 ** 2)).astype(np.uint8)
    out.append(("ring", ring))
    a = 0.7
    ell = ((((yy - 30) * np.cos(a) + (xx - 40) * np.sin(a)) / 25) ** 2
           + (((xx - 40) * np.cos(a) - (yy - 30) * np.sin(a)) / 9) ** 2 < 1).astype(np.uint8)
    out.append(("rotated_ellipse", ell))
    out.append(("noise", (rng.rand(h, w) > 0.8).astype(np.uint8)))
    blobs = np.zeros((h, w), np.uint8)
    for _ in range(6):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        blobs[y0:y0 + rng.randint(1, 25), x0:x0 + rng.randint(1, 25)] = 1
    out.append(("blobs", blobs))
    out.append(("full", np.ones((h, w), np.uint8)))
    return out


MASKS = _masks()


@pytest.mark.parametrize("gen", ["mask", "bb", "contour", "ellipse"])
@pytest.mark.parametrize("zoom", [0, 50])
@pytest.mark.parametrize("thickness", [1, 2])
def test_generators_bitwise_equal_jax(gen, zoom, thickness):
    rng = np.random.RandomState(thickness * 100 + zoom)
    compared = 0
    for name, mask in MASKS:
        img = rng.randint(0, 256, mask.shape + (3,)).astype(np.uint8)
        for color, alpha in (((255, 0, 0), 0.5), ((0, 255, 0), 0.3)):
            want = J.GENERATORS[gen](img, mask.astype(np.float32), color=color, alpha=alpha,
                                     thickness=thickness, zoom_percent=zoom)
            got = T.GENERATORS[gen](img, mask.astype(np.float32), color=color, alpha=alpha,
                                    thickness=thickness, zoom_percent=zoom)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {color} {alpha}")
            compared += 1
    assert compared >= 14


def _random_masks(n, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = rng.randint(3, 50, 2)
        if i % 3 == 0:
            m = (rng.rand(h, w) > 0.65).astype(np.uint8)
        elif i % 3 == 1:
            m = np.zeros((h, w), np.uint8)
            for _ in range(rng.randint(1, 5)):
                y0, x0 = rng.randint(0, h), rng.randint(0, w)
                m[y0:y0 + rng.randint(1, h), x0:x0 + rng.randint(1, w)] = 1
            for _ in range(rng.randint(0, 3)):
                y0, x0 = rng.randint(0, h), rng.randint(0, w)
                m[y0:y0 + rng.randint(1, 6), x0:x0 + rng.randint(1, 6)] = 0
        else:
            m = (rng.rand(h, w) > 0.25).astype(np.uint8)
        yield m


def test_contours_bounding_rects_and_hulls_equal_cv2():
    for m in _random_masks(150, 1):
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        got = T.find_external_contours(m)
        assert [c.reshape(-1, 2).tolist() for c in want] == [c.tolist() for c in got]
        for c in want:
            assert T.bounding_rect(c) == cv2.boundingRect(c)
            np.testing.assert_array_equal(T.convex_hull(c),
                                          cv2.convexHull(c, clockwise=False).reshape(-1, 2))


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_drawing_equals_cv2(thickness):
    rng = np.random.RandomState(thickness)
    for m in _random_masks(40, 2 + thickness):
        h, w = m.shape
        a = np.zeros((h, w, 3), np.uint8)
        b = a.copy()
        cs, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(a, cs, -1, (255, 0, 0), thickness)
        T.draw_contours(b, cs, (255, 0, 0), thickness)
        x0, y0 = (int(v) for v in rng.randint(-3, 20, 2))
        x1, y1 = (int(v) for v in rng.randint(10, 60, 2))
        cv2.rectangle(a, (x0, y0), (x1, y1), (0, 255, 0), thickness)
        T.rectangle(b, (x0, y0), (x1, y1), (0, 255, 0), thickness)
        center = (int(rng.randint(-5, w + 5)), int(rng.randint(-5, h + 5)))
        axes = (int(rng.randint(0, 30)), int(rng.randint(0, 30)))
        angle = float(rng.choice([0.0, 90.0, -45.0, 44.5, 45.5, rng.rand() * 180 - 90]))
        cv2.ellipse(a, center, axes, angle, 0, 360, (0, 0, 255), thickness)
        T.ellipse(b, center, axes, angle, (0, 0, 255), thickness)
        np.testing.assert_array_equal(b, a)


def test_blend_and_resize_equal_cv2():
    rng = np.random.RandomState(4)
    for alpha in (0.5, 0.3, 0.25):
        x = rng.randint(0, 256, (31, 45, 3)).astype(np.uint8)
        y = rng.randint(0, 256, (31, 45, 3)).astype(np.uint8)
        np.testing.assert_array_equal(T.add_weighted(x, alpha, y, 1 - alpha),
                                      cv2.addWeighted(x, alpha, y, 1 - alpha, 0))
    for _ in range(60):
        sh, sw = (int(v) for v in rng.randint(1, 60, 2))
        dh, dw = (int(v) for v in rng.randint(1, 120, 2))
        src = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        np.testing.assert_array_equal(T.resize_linear(src, dw, dh),
                                      cv2.resize(src, (dw, dh), interpolation=cv2.INTER_LINEAR))


def test_sine_table_equals_cv2():
    big = 1 << 30
    for d in range(360):
        (x, y), _ = cv2.ellipse2Poly((0, 0), (big, big), 0, d, d + 1, 1)
        assert np.float32(x / big) == T.SIN_TABLE[450 - d] and np.float32(y / big) == \
            T.SIN_TABLE[d], d


# hulls on which choosing the caliper by the largest float32 cosine (an
# older rotatingCalipers) rounds the centre and a side otherwise than cv2
CALIPER_HULLS = ([[39, 29], [4, 34], [1, 20], [0, 13], [6, 4], [37, 7]],
                 [[36, 6], [34, 28], [23, 34], [12, 38], [5, 38], [1, 34], [4, 1]],
                 [[39, 25], [33, 39], [3, 33], [7, 13], [11, 1], [19, 2], [37, 20]],
                 [[38, 30], [12, 32], [1, 19], [0, 10], [5, 7], [28, 1], [35, 3]])


def test_min_area_rect_agreement_rate():
    """cv2's rectangle, float32 for float32, on every seeded point set
    (coordinates up to 5, 40 and 600) and on ``CALIPER_HULLS``."""
    rng = np.random.RandomState(5)
    sets = [np.asarray(h, np.int32) for h in CALIPER_HULLS]
    for i in range(1500):
        hi = (5, 40, 600)[i % 3]
        sets.append(rng.randint(0, hi, (rng.randint(1, 30), 2)).astype(np.int32))
    for pts in sets:
        want, got = cv2.minAreaRect(pts.reshape(-1, 1, 2)), T.min_area_rect(pts)
        assert want == got, (pts.tolist(), want, got)
