"""The committed image fixtures laid out as five benchmarks' folders.

``tests/fixtures/images/`` holds JPEGs and PNG masks at the datasets' sizes
(written once by ``tools/make_image_fixtures.py``).  ``lay_out(name,
root)`` copies them into ``root`` in the layout of COCO-20i, PASCAL-5i,
FSS-1000, LVIS-92i or PACO-Part and writes the split lists and annotation
pickles those loaders read (LVIS and PACO with float polygon annotations
drawn from a seed).  ``record_digest`` and ``arrays_digest`` hash a
loader's record and ``episode_host_u8``'s arrays, as
``tests/fixtures/images/expected.json`` stores them.

Imports neither PIL nor JAX: the CPU tests, the fixture tool and
``chip_smoke.py`` on the card's machine all use it.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "images")
EXPECTED = os.path.join(FIXTURES, "expected.json")
BENCHMARKS = ("coco", "pascal5i", "fss", "lvis", "paco_part")
EPISODES = 3  # the first episodes of each layout that expected.json hashes
SEED = 0
SIZE = 518  # episode_host_u8's side (the CLI's --input-size)

# (width, height) of each JPEG fixture; the label map of a scene shares its stem
JPEGS = {"coco_640x480.jpg": (640, 480), "coco_480x640.jpg": (480, 640),
         "coco_427x640_422_optimized.jpg": (427, 640),
         "voc_500x375_progressive.jpg": (500, 375), "voc_500x333_444_restart.jpg": (500, 333),
         "fss_224.jpg": (224, 224), "gray_320x240.jpg": (320, 240),
         "cmyk_200x150.jpg": (200, 150)}
PNGS = ("coco_640x480.png", "coco_480x640.png", "coco_427x640.png", "voc_500x375.png",
        "voc_500x333.png", "fss_224.png", "fss_224_1bit.png")
COCO_SCENES = ("coco_640x480", "coco_480x640", "coco_427x640")
COCO_FOLD0 = tuple(range(0, 80, 4))  # fold 0's validation classes (0-indexed)
VOC_SCENES = (("voc_500x375_progressive.jpg", "voc_500x375.png"),
              ("voc_500x333_444_restart.jpg", "voc_500x333.png"))
PACO_CLASSES = 448  # DatasetPacoPart.nclass: the fold striding needs them all


def _copy(name: str, dst: str) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copyfile(os.path.join(FIXTURES, name), dst)


def _coco_jpeg(stem: str) -> str:
    return next(n for n in JPEGS if n.startswith(stem))


def make_coco(root: str) -> None:
    base = os.path.join(root, "COCO2014")
    names = []
    for i in range(6):
        stem = COCO_SCENES[i % len(COCO_SCENES)]
        name = f"val2014/COCO_val2014_{i:012d}.jpg"
        _copy(_coco_jpeg(stem), os.path.join(base, name))
        _copy(stem + ".png", os.path.join(base, "annotations", name[:-4] + ".png"))
        names.append(name)
    classwise = {c: list(names) for c in range(80)}
    os.makedirs(os.path.join(base, "splits", "val"), exist_ok=True)
    with open(os.path.join(base, "splits", "val", "fold0.pkl"), "wb") as f:
        pickle.dump(classwise, f)


def make_pascal5i(root: str) -> None:
    voc = os.path.join(root, "PASCAL5i", "VOCdevkit", "VOC2012")
    names = []
    for i in range(4):
        jpg, png = VOC_SCENES[i % len(VOC_SCENES)]
        name = f"2008_{i:06d}"
        _copy(jpg, os.path.join(voc, "JPEGImages", name + ".jpg"))
        _copy(png, os.path.join(voc, "SegmentationClass", name + ".png"))
        names.append(name)
    os.makedirs(os.path.join(voc, "ImageSets", "Segmentation"), exist_ok=True)
    for split, part in (("train", names[:1]), ("val", names)):
        with open(os.path.join(voc, "ImageSets", "Segmentation", split + ".txt"), "w") as f:
            f.write("\n".join(part) + "\n")


def make_fss(root: str) -> None:
    cats = ("bee", "ant")
    for c, cat in enumerate(cats):
        for i in range(1, 11):
            folder = os.path.join(root, "FSS-1000", "data", cat)
            _copy("fss_224.jpg", os.path.join(folder, f"{i}.jpg"))
            _copy("fss_224_1bit.png" if (i + c) % 2 else "fss_224.png",
                  os.path.join(folder, f"{i}.png"))
    os.makedirs(os.path.join(root, "FSS-1000", "splits"), exist_ok=True)
    with open(os.path.join(root, "FSS-1000", "splits", "test.txt"), "w") as f:
        f.write("\n".join(cats) + "\n")


def polygon(rng: np.random.RandomState, w: int, h: int, outside: bool = False) -> list:
    """A star-shaped polygon of 5-14 float points (two decimals, as COCO
    stores them) around a random centre; ``outside`` lets it cross the
    image's border."""
    k = rng.randint(5, 15)
    cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
    r = rng.uniform(0.1, 0.6 if outside else 0.3) * min(w, h)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    rad = r * rng.uniform(0.4, 1.0, k)
    pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], 1)
    if not outside:
        pts = np.clip(pts, 0, [w - 1, h - 1])
    return [round(float(v), 2) for v in pts.reshape(-1)]


def _uncompressed_rle(w: int, h: int, rng: np.random.RandomState) -> dict:
    """COCO's uncompressed RLE (column-major runs, a zero run first) of a box."""
    m = np.zeros((h, w), np.uint8)
    y, x = rng.randint(0, h // 2), rng.randint(0, w // 2)
    m[y: y + rng.randint(5, h // 2), x: x + rng.randint(5, w // 2)] = 1
    flat = m.T.reshape(-1)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
    counts = ([0] if flat[0] else []) + [int(v) for v in runs]
    return {"size": [h, w], "counts": counts}


def _segm(rng: np.random.RandomState, w: int, h: int, kind: int):
    if kind == 2:
        return _uncompressed_rle(w, h, rng)
    return [polygon(rng, w, h, outside=kind == 1) for _ in range(1 + rng.randint(2))]


def make_lvis(root: str) -> None:
    base = os.path.join(root, "LVIS")
    rng = np.random.RandomState(SEED)
    pool = []
    for i, name in enumerate(("coco_640x480.jpg", "coco_480x640.jpg", "gray_320x240.jpg",
                              "cmyk_200x150.jpg", "coco_427x640_422_optimized.jpg")):
        rel = f"val2017/{i:012d}.jpg"
        _copy(name, os.path.join(base, "coco", rel))
        pool.append((rel, JPEGS[name]))
    anno = {}
    for c in range(12):  # 12 classes of 3-5 images: > 1 shot, ten folds
        picks = rng.choice(len(pool), 3 + c % 3, replace=False)
        anno[1000 + c] = {pool[j][0]: [_segm(rng, *pool[j][1], (c + j + k) % 3)
                                       for k in range(1 + (c + j) % 2)] for j in picks}
    for name in ("lvis_train.pkl", "lvis_val.pkl"):
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(anno, f)


def make_paco_part(root: str) -> None:
    base = os.path.join(root, "PACO-Part")
    rng = np.random.RandomState(SEED + 1)
    images = []
    for i, name in enumerate(("coco_640x480.jpg", "coco_480x640.jpg",
                              "coco_427x640_422_optimized.jpg")):
        rel = f"val2017/{i:012d}.jpg"
        _copy(name, os.path.join(base, "coco", rel))
        images.append((100 + i, rel, JPEGS[name]))
    cid2img = {cid: [{iid: f"paco/images/{rel}"} for iid, rel, _ in images]
               for cid in range(PACO_CLASSES)}
    img2anno = {iid: [] for iid, _, _ in images}
    for iid, _, (w, h) in images:
        for cid in range(PACO_CLASSES):
            for obj in range(2):
                x, y = rng.randint(0, w // 2), rng.randint(0, h // 2)
                box = [x, y, rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)]
                img2anno[iid].append({"category_id": cid, "obj_ann_id": obj, "obj_bbox": box,
                                      "segmentation": [polygon(rng, w, h, outside=obj == 1)]})
    anno = {"cid2img": cid2img, "img2anno": img2anno}
    os.makedirs(os.path.join(base, "paco"), exist_ok=True)
    for name in ("paco_part_train.pkl", "paco_part_val.pkl"):
        with open(os.path.join(base, "paco", name), "wb") as f:
            pickle.dump(anno, f)


LAYOUTS = {"coco": make_coco, "pascal5i": make_pascal5i, "fss": make_fss, "lvis": make_lvis,
           "paco_part": make_paco_part}


def lay_out(benchmark: str, root: str) -> str:
    """The benchmark's folders under ``root`` (the loaders' ``datapath``)."""
    LAYOUTS[benchmark](root)
    return root


def lay_out_all(root: str) -> str:
    for name in BENCHMARKS:
        lay_out(name, root)
    return root


def _update(h, name: str, a) -> None:
    if a is None:
        h.update(f"{name}:none;".encode())
        return
    a = np.ascontiguousarray(a)
    h.update(f"{name}:{a.dtype.str}:{a.shape};".encode())
    h.update(a.tobytes())


def record_digest(rec) -> str:
    """SHA-256 of an episode record's arrays (images, masks, ignore mask,
    with their types and shapes) and its class."""
    h = hashlib.sha256()
    for name in ("query_img", "query_mask", "query_ignore"):
        _update(h, name, getattr(rec, name))
    for name in ("support_imgs", "support_masks"):
        for a in getattr(rec, name):
            _update(h, name, a)
    h.update(f"class:{int(rec.class_id)}:{rec.class_name}".encode())
    return h.hexdigest()


def arrays_digest(arrays) -> str:
    """SHA-256 of a tuple of arrays (``episode_host_u8``'s)."""
    h = hashlib.sha256()
    for i, a in enumerate(arrays):
        _update(h, str(i), a)
    return h.hexdigest()


def array_sha(a) -> dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": a.dtype.str,
            "sha256": hashlib.sha256(a.tobytes()).hexdigest()}


def expected() -> dict:
    with open(EXPECTED) as f:
        return json.load(f)
