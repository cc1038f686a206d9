"""LVIS-92i episode dataset (the port's own copy of ``mars_tpu/data/lvis.py``:
the same seed gives the same records).

Functional parity with the reference (reference: matcher/data/lvis.py):
10 folds over the val categories with > shot samples, 2300 val episodes,
class round-robin via ``idx % len(class_ids)``, per-annotation masks decoded
from polygons or COCO RLE.  RLE is decoded in numpy and polygons are drawn
as PIL 12.1.0 draws them (``image_io.polygon_mask``); the reference leans
on pycocotools + detectron2.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from mars_tpu_torch.data import image_io
from mars_tpu_torch.data.base import EpisodeRecord, read_image


def polygons_to_mask(polygons, h: int, w: int) -> np.ndarray:
    """Rasterize COCO-style polygon lists → (H, W) {0,1} float32."""
    return image_io.polygon_mask(polygons, h, w).astype(np.float32)


def rle_to_mask(rle: dict) -> np.ndarray:
    """Decode COCO RLE (uncompressed counts list, or compressed LEB128
    string) → (H, W) {0,1}, column-major as per the COCO spec."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode()
        # LEB128-style decompression (COCO compressed RLE)
        out: List[int] = []
        i = 0
        while i < len(counts):
            x, k, more = 0, 0, True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
            if x & (1 << (5 * k - 1)):
                x |= -1 << (5 * k)
            if len(out) > 2:
                x += out[-2]
            out.append(x)
        counts = out
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(w, h).T.astype(np.float32)


def ann_to_mask(segm, h: int, w: int) -> np.ndarray:
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    return rle_to_mask(segm)


class DatasetLVIS:
    benchmark = "lvis"
    nfolds = 10

    def __init__(self, datapath: str, fold: int, split: str, shot: int, seed: int = 0):
        self.split = "val" if split in ("val", "test") else "trn"
        self.fold = fold
        self.shot = shot
        self.anno_path = os.path.join(datapath, "LVIS")
        self.base_path = os.path.join(datapath, "LVIS", "coco")
        self.rng = np.random.RandomState(seed)

        with open(os.path.join(self.anno_path, "lvis_train.pkl"), "rb") as f:
            train_anno = pickle.load(f)
        with open(os.path.join(self.anno_path, "lvis_val.pkl"), "rb") as f:
            val_anno = pickle.load(f)

        train_ids = list(train_anno.keys())
        val_ids = [i for i in val_anno if len(val_anno[i]) > shot]
        nval = len(val_ids) // self.nfolds
        class_ids_val = [val_ids[fold + self.nfolds * v] for v in range(nval)]
        if self.split == "trn":
            self.class_ids_ori = [x for x in train_ids if x not in class_ids_val]
            self.anno = train_anno
        else:
            self.class_ids_ori = class_ids_val
            self.anno = val_anno
        self.class_ids_c = {cid: i for i, cid in enumerate(self.class_ids_ori)}
        self.class_ids = sorted(self.class_ids_c.values())

    def __len__(self):
        return 2300 if self.split == "val" else sum(len(v) for v in self.anno.values())

    def _load(self, name, cls):
        img = read_image(os.path.join(self.base_path, name), "RGB")
        h, w = img.shape[:2]
        segms = self.anno[cls][name]
        mask = np.zeros((h, w), np.float32)
        for segm in segms:
            mask = np.maximum(mask, ann_to_mask(segm, h, w))
        return img, mask

    def __getitem__(self, idx) -> EpisodeRecord:
        cls = self.class_ids_ori[idx % len(self.class_ids_ori)]
        names = list(self.anno[cls].keys())
        query_name = self.rng.choice(names)
        qimg, qmask = self._load(query_name, cls)
        support_names = []
        while len(support_names) < self.shot:
            s = self.rng.choice(names)
            if s != query_name and s not in support_names:
                support_names.append(s)
        sups = [self._load(n, cls) for n in support_names]
        return EpisodeRecord(
            query_img=qimg, query_mask=qmask,
            support_imgs=[s[0] for s in sups], support_masks=[s[1] for s in sups],
            class_id=self.class_ids_c[cls],
            query_name=query_name, support_names=support_names,
            org_query_imsize=qimg.shape[:2],
        )
