"""Write the committed image fixtures and what PIL and the JAX loaders make
of them: ``tests/fixtures/images/``.

Seeded scenes (gradients, filled shapes, mild texture) saved by Pillow as
the benchmarks store their files: COCO's 4:2:0 q75 JPEGs at 640x480 and
480x640 (and a 4:2:2 optimised one), VOC's at 500x375 (progressive) and
500x333 (4:4:4 q95, restart markers), FSS-1000's 224x224, one grayscale
and one Adobe CMYK JPEG; label maps as PNG: COCO-20i's ``L`` maps, VOC's
palette maps with their 255 borders, FSS-1000's RGB and 1-bit masks.

``expected.json`` holds, for each file, the shape, type and SHA-256 of
``np.array(Image.open(f))`` and of its ``convert("RGB")`` and
``convert("L")``, and of their 518x518 BILINEAR and NEAREST resizes; of a
few ``ImageDraw.polygon`` rasters; and, for each of ``tests/real_layouts``'
five benchmarks, the digests of the JAX loaders' first records and of
JAX's ``episode_host_u8`` arrays for them.  The port's tests and
``chip_smoke.py`` hold the port's decoders to these.

Run once, where Pillow and the JAX package are installed (never on the
card's machine):  python tools/make_image_fixtures.py
"""
import json
import os
import sys
import tempfile

import numpy as np
import PIL
from PIL import Image, ImageDraw, features

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import real_layouts as rl  # noqa: E402

OUT = rl.FIXTURES
# a few rasters of ImageDraw.polygon: float points, points outside the image,
# self-intersecting and degenerate polygons
POLYGONS = [
    ([[10.4, 5.6, 60.25, 12.75, 45.5, 70.1, 3.3, 40.9]], 64, 80),
    ([[-12.5, -3.2, 90.7, 20.1, 30.3, 110.6]], 96, 72),
    ([[5, 5, 60, 60, 60, 5, 5, 60]], 70, 70),  # a bow tie
    ([[10, 10, 40, 10, 40, 10.9, 10, 10.2], [20, 30, 20, 30, 20, 30]], 50, 50),  # slivers
    ([[0.5, 0.5, 30.49, 0.51, 30.5, 20.5, 15.5, 35.5, 0.49, 20.5], [12, 2, 14, 2, 13, 40]], 40, 40),
]


def voc_palette() -> np.ndarray:
    """PASCAL VOC's colour map (bit interleaving of the label)."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = (r, g, b)
    return pal


def labels(rng, w, h, ids, border=None):
    """An L label map: shapes of the given labels on background 0, each
    with a 5-pixel ``border`` outline when given (VOC's 255)."""
    im = Image.new("L", (w, h), 0)
    d = ImageDraw.Draw(im)
    for lab in ids:
        cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
        r = rng.uniform(0.08, 0.25) * min(w, h)
        kind = rng.randint(3)
        if kind == 0:
            box = [cx - r, cy - r * rng.uniform(0.5, 1.5), cx + r, cy + r]
            d.ellipse(box, fill=int(lab), outline=border, width=5 if border else 1)
        elif kind == 1:
            box = [cx - r, cy - r, cx + r * rng.uniform(0.5, 1.5), cy + r * 0.8]
            d.rectangle(box, fill=int(lab), outline=border, width=5 if border else 1)
        else:
            ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
            pts = [(cx + r * np.cos(a) * rng.uniform(0.5, 1), cy + r * np.sin(a) * rng.uniform(0.5, 1))
                   for a in ang]
            d.polygon(pts, fill=int(lab), outline=border, width=5 if border else 1)
    return np.array(im)


def scene(rng, lab):
    """RGB pixels for a label map: a gradient background, a colour per
    label with its own gradient, mild texture."""
    h, w = lab.shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = rng.uniform(40, 200, 3)
    img = base + (x / w)[..., None] * rng.uniform(-60, 60, 3) + (y / h)[..., None] * rng.uniform(
        -60, 60, 3)
    for v in np.unique(lab):
        if v == 0:
            continue
        m = lab == v
        col = rng.uniform(20, 235, 3)
        img[m] = col + (np.sin(x[m] / rng.uniform(6, 30)) * 20)[:, None]
    # texture: two stripe patterns and grain
    img += (np.sin(x / rng.uniform(2, 5) + y / rng.uniform(3, 9)) * 12)[..., None]
    img += (np.cos(y / rng.uniform(2, 4)) * 6)[..., None]
    img += rng.normal(0, 7, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_fixtures(rng):
    os.makedirs(OUT, exist_ok=True)
    for stem, (w, h) in (("coco_640x480", (640, 480)), ("coco_480x640", (480, 640)),
                         ("coco_427x640", (427, 640))):
        lab = labels(rng, w, h, [c + 1 for c in rng.choice(rl.COCO_FOLD0, 12, replace=False)])
        Image.fromarray(lab, "L").save(os.path.join(OUT, stem + ".png"))
        img = Image.fromarray(scene(rng, lab))
        jpg = rl._coco_jpeg(stem)
        if "422" in jpg:
            img.save(os.path.join(OUT, jpg), quality=80, subsampling=1, optimize=True)
        else:
            img.save(os.path.join(OUT, jpg), quality=75)
    pal = voc_palette()
    for jpg, png in rl.VOC_SCENES:
        w, h = rl.JPEGS[jpg]
        lab = labels(rng, w, h, [1, 2, 3, 4, 5, 15, 9], border=255)
        im = Image.fromarray(lab, "P")
        im.putpalette(pal.reshape(-1).tolist())
        im.save(os.path.join(OUT, png))
        img = Image.fromarray(scene(rng, np.where(lab == 255, 0, lab)))
        if "progressive" in jpg:
            img.save(os.path.join(OUT, jpg), quality=75, progressive=True)
        else:
            img.save(os.path.join(OUT, jpg), quality=95, subsampling=0, restart_marker_blocks=4)
    lab = labels(rng, 224, 224, [1])
    Image.fromarray(scene(rng, lab)).save(os.path.join(OUT, "fss_224.jpg"), quality=90)
    Image.fromarray(np.repeat((lab > 0)[..., None] * np.uint8(255), 3, 2)).save(
        os.path.join(OUT, "fss_224.png"))
    Image.fromarray(lab > 0).convert("1").save(os.path.join(OUT, "fss_224_1bit.png"))
    lab = labels(rng, 320, 240, [1, 2, 3])
    Image.fromarray(scene(rng, lab)).convert("L").save(os.path.join(OUT, "gray_320x240.jpg"),
                                                       quality=85)
    lab = labels(rng, 200, 150, [1, 2])
    rgb = scene(rng, lab).astype(np.int32)
    k = 255 - rgb.max(axis=2, keepdims=True)
    cmyk = np.concatenate([255 - rgb - k, k], axis=2).clip(0, 255).astype(np.uint8)
    Image.fromarray(cmyk, "CMYK").save(os.path.join(OUT, "cmyk_200x150.jpg"), quality=90)


def pil_entry(path):
    im = Image.open(path)
    entry = {"bytes": os.path.getsize(path), "pil_mode": im.mode,
             "decode": {"none": rl.array_sha(np.array(im))}, "resize518": {}}
    for mode in ("RGB", "L"):
        conv = Image.open(path).convert(mode)
        entry["decode"][mode] = rl.array_sha(np.array(conv))
    entry["resize518"]["bilinear_RGB"] = rl.array_sha(np.array(
        Image.open(path).convert("RGB").resize((rl.SIZE, rl.SIZE), Image.BILINEAR)))
    entry["resize518"]["nearest_L"] = rl.array_sha(np.array(
        Image.open(path).convert("L").resize((rl.SIZE, rl.SIZE), Image.NEAREST)))
    return entry


def pil_polygons(polys, h, w):
    im = Image.new("L", (w, h), 0)
    d = ImageDraw.Draw(im)
    for poly in polys:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            d.polygon(pts, outline=1, fill=1)
    return np.array(im)


def jax_layouts():
    from mars_tpu.data import build_dataset
    from mars_tpu.data.base import episode_host_u8

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rl.lay_out_all(tmp)
        for bench in rl.BENCHMARKS:
            ds = build_dataset(bench, tmp, 0, "test", 1, rl.SEED)
            eps = []
            for idx in range(rl.EPISODES):
                rec = ds[idx]
                eps.append({"record": rl.record_digest(rec),
                            "host_u8": rl.arrays_digest(episode_host_u8(rec, rl.SIZE, 1)),
                            "class_id": int(rec.class_id)})
            out[bench] = {"episodes": eps}
    return out


def main():
    write_fixtures(np.random.RandomState(2026))
    files = {}
    for name in sorted(rl.JPEGS) + sorted(rl.PNGS):
        files[name] = pil_entry(os.path.join(OUT, name))
    polys = [{"polygons": p, "h": h, "w": w, **rl.array_sha(pil_polygons(p, h, w))}
             for p, h, w in POLYGONS]
    expected = {"pillow": PIL.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"),
                "zlib": features.version("zlib"), "size": rl.SIZE, "files": files,
                "polygons": polys, "layouts": jax_layouts()}
    with open(rl.EXPECTED, "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"{len(files)} files, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
