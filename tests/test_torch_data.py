"""The port's benchmark loaders against mars_tpu's on tiny on-disk layouts.

Every benchmark's folder layout is written by the test from arrays it
draws itself (JPEG images, PNG masks, split lists and pickles, LVIS
polygons and COCO RLE, PACO/PASCAL-Part annotation bundles), in the
layouts of ``mars_tpu/data/*.py``.  The port's ``build_dataset`` and the
JAX package's, given the same seed, must yield bitwise-equal records at 1
and 5 shots over several indices: the port reads the files with its own
decoders (``data/image_io.py``), the JAX package with PIL.
"""
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from mars_tpu.data import build_dataset as jbuild
from mars_tpu.data import lvis as jlvis
from mars_tpu.data import parts as jparts
from mars_tpu_torch.data import lvis as tlvis
from mars_tpu_torch.data import parts as tparts
from mars_tpu_torch.data.registry import build_dataset as tbuild

H, W = 20, 24
FIELDS = ("query_img", "query_mask", "support_imgs", "support_masks", "class_id", "class_name",
          "query_name", "support_names", "query_ignore", "org_query_imsize")


def _img(rng, path, h=H, w=W):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(path)


def _png(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.asarray(arr, np.uint8)).save(path)


def _labels(rng, ids, h=H, w=W):
    """A label map: background 0, a block per id, a 255 boundary row."""
    lab = np.zeros((h, w), np.uint8)
    for i in ids:
        y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
        lab[y: y + rng.randint(3, 7), x: x + rng.randint(3, 7)] = i
    lab[rng.randint(0, h)] = 255
    return lab


def rle_encode(mask: np.ndarray) -> dict:
    """COCO compressed RLE (pycocotools' rleToString) of an (H, W) {0, 1}
    mask, column-major counts starting with a zero run."""
    flat = mask.T.reshape(-1).astype(np.uint8)
    counts, cur, run = [], 0, 0
    for v in flat:
        if v != cur:
            counts.append(run)
            cur, run = v, 0
        run += 1
    counts.append(run)
    out = bytearray()
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not ch & 0x10) or (x == -1 and ch & 0x10))
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return {"size": [mask.shape[0], mask.shape[1]], "counts": bytes(out).decode()}


def make_coco(root, rng, annotations="annotations"):
    base = os.path.join(root, "COCO2014")
    pool = [f"val2014/COCO_val_{i:03d}.jpg" for i in range(8)]
    for name in pool:
        _img(rng, os.path.join(base, name))
        _png(os.path.join(base, annotations, name[:-4] + ".png"),
             _labels(rng, rng.choice(np.arange(1, 81), 6, replace=False)))
    classwise = {c: [pool[j] for j in rng.choice(8, 4, replace=False)] for c in range(80)}
    os.makedirs(os.path.join(base, "splits", "val"))
    with open(os.path.join(base, "splits", "val", "fold0.pkl"), "wb") as f:
        pickle.dump(classwise, f)


def make_fss(root, rng):
    cats = ["ant", "bee", "cat"]
    for cat in cats:
        for i in range(1, 11):
            _img(rng, os.path.join(root, "FSS-1000", "data", cat, f"{i}.jpg"))
            _png(os.path.join(root, "FSS-1000", "data", cat, f"{i}.png"),
                 rng.randint(0, 256, (H, W)))
    os.makedirs(os.path.join(root, "FSS-1000", "splits"))
    with open(os.path.join(root, "FSS-1000", "splits", "test.txt"), "w") as f:
        f.write("\n".join(reversed(cats)) + "\n")


def make_pascal5i(root, rng):
    voc = os.path.join(root, "PASCAL5i", "VOCdevkit", "VOC2012")
    names = [f"2008_{i:06d}" for i in range(7)]
    for i, name in enumerate(names):
        _img(rng, os.path.join(voc, "JPEGImages", name + ".jpg"))
        ids = [1 + i % 5, 1 + (i + 2) % 5] if i < 6 else [12]  # the last: no fold-0 class
        _png(os.path.join(voc, "SegmentationClass", name + ".png"), _labels(rng, ids))
    os.makedirs(os.path.join(voc, "ImageSets", "Segmentation"))
    for split, part in (("train", names[:2]), ("val", names)):
        with open(os.path.join(voc, "ImageSets", "Segmentation", split + ".txt"), "w") as f:
            f.write("\n".join(part) + "\n")


def make_pascal(root, rng):
    voc = os.path.join(root, "VOC2012")
    names = [f"2009_{i:06d}" for i in range(6)]
    lines = []
    for i, name in enumerate(names):
        cls = 1 + i % 3  # classes 0..2 of fold 0, 1-indexed in the lists
        _img(rng, os.path.join(voc, "JPEGImages", name + ".jpg"))
        _png(os.path.join(voc, "SegmentationClassAug", name + ".png"), _labels(rng, [cls, 9]))
        lines.append(f"{name}__{cls}")
    os.makedirs(os.path.join(voc, "splits", "val"))
    with open(os.path.join(voc, "splits", "val", "fold0.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _segm(rng, kind):
    """A polygon list, a compressed RLE or an uncompressed RLE."""
    if kind == 0:
        x, y = rng.randint(2, W - 8), rng.randint(2, H - 8)
        return [[x, y, x + 6, y + 1, x + 3, y + 6], [1, 1, 5, 1, 5, 4, 1, 4]]
    m = np.zeros((H, W), np.uint8)
    y, x = rng.randint(0, H - 5), rng.randint(0, W - 5)
    m[y: y + 5, x: x + rng.randint(2, 6)] = 1
    rle = rle_encode(m)
    if kind == 2:
        flat = m.T.reshape(-1)
        runs, cur, n = [], 0, 0
        for v in flat:
            if v != cur:
                runs.append(n)
                cur, n = v, 0
            n += 1
        rle = {"size": [H, W], "counts": runs + [n]}
    return rle


def make_lvis(root, rng):
    base = os.path.join(root, "LVIS")
    pool = [f"val2017/{i:012d}.jpg" for i in range(9)]
    for name in pool:
        _img(rng, os.path.join(base, "coco", name))
    anno = {}
    for c in range(12):  # 12 classes of 7 images each: > 5 shots, ten folds
        anno[100 + c] = {pool[j]: [_segm(rng, k % 3) for k in range(1 + j % 2)]
                         for j in rng.choice(9, 7, replace=False)}
    for name in ("lvis_train.pkl", "lvis_val.pkl"):
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(anno, f)


def _part_annotations(rng, img_dir, prefix, n):
    img2anno, cid2img = {}, {5: [], 7: []}
    for i in range(n):
        name = f"{prefix}/im{i}.jpg"
        _img(rng, os.path.join(img_dir, name), 40, 40)
        for cid in (5, 7):
            cid2img[cid].append({100 + i: f"root/{name}"})
        img2anno[100 + i] = [
            {"category_id": cid, "obj_ann_id": obj, "obj_bbox": [5, 5, 25 + obj, 25],
             "segmentation": _segm(rng, (i + obj) % 2) if obj else [[6, 6, 20, 6, 20, 20]]}
            for cid in (5, 7) for obj in (0, 1)]
    cid2img[5].append(dict(cid2img[5][0]))  # a duplicate the loader drops
    return {"cid2img": cid2img, "img2anno": img2anno}


def make_paco_part(root, rng):
    base = os.path.join(root, "PACO-Part")
    anno = _part_annotations(rng, os.path.join(base, "coco"), "val", 7)
    os.makedirs(os.path.join(base, "paco"))
    for name in ("paco_part_train.pkl", "paco_part_val.pkl"):
        with open(os.path.join(base, "paco", name), "wb") as f:
            pickle.dump(anno, f)


def make_pascal_part(root, rng):
    base = os.path.join(root, "Pascal-Part")
    anno = _part_annotations(rng, os.path.join(base, "VOCdevkit", "VOC2010", "JPEGImages"),
                             "JPEGImages", 7)
    for name in ("pascal_part_train.pkl", "pascal_part_val.pkl"):
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(anno, f)


LAYOUTS = {"coco": make_coco, "fss": make_fss, "pascal5i": make_pascal5i,
           "pascal": make_pascal, "lvis": make_lvis, "paco_part": make_paco_part,
           "pascal_part": make_pascal_part}


@pytest.fixture
def small_part_tables(monkeypatch):
    """The part benchmarks' class counts cut to the layout's (four folds of
    one class), in both packages."""
    for mod in (jparts, tparts):
        for cls in (mod.DatasetPacoPart, mod.DatasetPascalPart):
            monkeypatch.setattr(cls, "nclass", 4)


def assert_same_record(got, want, roots=("", "")):
    """Every field equal, dtypes included; paths compared below their
    layout's root."""
    def rel(v, root):
        if isinstance(v, str):
            return v.replace(root, "ROOT") if root else v
        if isinstance(v, list):
            return [rel(x, root) for x in v]
        return v

    for name in FIELDS:
        g, w = rel(getattr(got, name), roots[1]), rel(getattr(want, name), roots[0])
        if isinstance(w, list):
            assert len(g) == len(w), name
            for a, b in zip(g, w):
                assert np.asarray(a).dtype == np.asarray(b).dtype, name
                np.testing.assert_array_equal(a, b, err_msg=name)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert g == w and type(g) is type(w), name


@pytest.mark.parametrize("shot", [1, 5])
@pytest.mark.parametrize("benchmark", sorted(LAYOUTS))
def test_loader_records_equal_jax(benchmark, shot, small_part_tables, tmp_path):
    """Two copies of one layout (the PASCAL-5i loader writes a cache into
    its folder), one per package; four episodes each, then the second
    construction of each from its cache."""
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for root in roots:
        LAYOUTS[benchmark](root, np.random.RandomState(0))
    for _ in range(2):  # the first pass builds PASCAL-5i's cache, the second reads it
        jds = jbuild(benchmark, roots[0], 0, "test", shot, 3)
        tds = tbuild(benchmark, roots[1], 0, "test", shot, 3)
        assert len(tds) == len(jds) and tds.benchmark == jds.benchmark
        assert list(tds.class_ids) == list(jds.class_ids)
        for idx in (0, 1, 3, 2):
            got, want = tds[idx], jds[idx]
            assert len(got.support_imgs) == shot
            assert_same_record(got, want, roots)


def test_pascal5i_caches_equal(tmp_path):
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    for root in roots:
        make_pascal5i(root, np.random.RandomState(0))
    jbuild("pascal5i", roots[0], 0, "test", 1, 0)
    tbuild("pascal5i", roots[1], 0, "test", 1, 0)
    read = []
    for root in roots:
        with open(os.path.join(root, "PASCAL5i", "VOCdevkit", "VOC2012",
                               "dataset_0_False.json")) as f:
            read.append(f.read().replace(roots[0], "ROOT").replace(roots[1], "ROOT"))
    assert read[0] == read[1]


def test_coco_annotations_path_override(tmp_path):
    """``--annotations-datapath``: the masks come from another folder."""
    make_coco(str(tmp_path), np.random.RandomState(1), annotations="masks")
    other = str(tmp_path / "COCO2014" / "masks")
    jds = jbuild("coco", str(tmp_path), 0, "test", 1, 0, annotations_path=other)
    tds = tbuild("coco", str(tmp_path), 0, "test", 1, 0, annotations_path=other)
    assert tds.annotations_path == other
    assert_same_record(tds[0], jds[0])
    with pytest.raises(FileNotFoundError):
        tbuild("coco", str(tmp_path), 0, "test", 1, 0)[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_and_polygon_decoders_equal_jax(seed):
    rng = np.random.RandomState(seed)
    m = (rng.rand(17, 13) > 0.6).astype(np.uint8)
    for segm in (rle_encode(m), {"size": [17, 13], "counts": rle_encode(m)["counts"].encode()}):
        got = tlvis.ann_to_mask(segm, 17, 13)
        np.testing.assert_array_equal(got, jlvis.ann_to_mask(segm, 17, 13))
        np.testing.assert_array_equal(got, m.astype(np.float32))
    poly = [list(rng.randint(0, 13, 8).astype(float))]
    np.testing.assert_array_equal(tlvis.polygons_to_mask(poly, 17, 13),
                                  jlvis.polygons_to_mask(poly, 17, 13))


def test_unknown_benchmark_raises():
    with pytest.raises(ValueError, match="unknown benchmark"):
        tbuild("imagenet")


def test_coco_fold_classes():
    from mars_tpu_torch.data.coco import DatasetCOCO20i

    ids = DatasetCOCO20i.__new__(DatasetCOCO20i)
    ids.split, ids.fold = "val", 2
    assert ids.build_class_ids() == [2 + 4 * v for v in range(20)]
    ids.split = "trn"
    trn = ids.build_class_ids()
    assert len(trn) == 60 and 2 not in trn


def test_pascal_plain_fold_classes(tmp_path):
    from mars_tpu_torch.data.pascal import DatasetPascal

    base = tmp_path / "VOC2012" / "splits" / "val"
    os.makedirs(base)
    (base / "fold1.txt").write_text("img_a__6\nimg_b__7\n")
    ds = DatasetPascal(str(tmp_path), fold=1, split="val", shot=1)
    assert ds.class_ids == [5, 6, 7, 8, 9]
    assert ds.img_metadata == [("img_a", 5), ("img_b", 6)]


def test_pascal5i_meter_scores_the_recorded_classes(tmp_path):
    """Each PASCAL-5i record's 0-indexed class id is one the fold's meter
    averages over (its listed ids are 1-indexed); the other loaders' ids
    are already the records'."""
    from mars_tpu_torch import cli as tcli

    make_pascal5i(str(tmp_path), np.random.RandomState(0))
    ds = tbuild("pascal5i", str(tmp_path), 0, "test", 1, 0)
    meter = tcli.fold_meter(ds)
    assert list(meter.class_ids) == [0, 1, 2, 3, 4]
    assert {ds[i].class_id for i in range(len(ds))} <= set(meter.class_ids)
    make_pascal(str(tmp_path), np.random.RandomState(0))
    ds = tbuild("pascal", str(tmp_path), 0, "test", 1, 0)
    assert list(tcli.fold_meter(ds).class_ids) == ds.class_ids == [0, 1, 2, 3, 4]

