"""PASCAL-5i (plain VOC layout) episode dataset (the port's own copy of
``mars_tpu/data/pascal.py``: the same seed gives the same records).

Functional parity with the reference's alternative PASCAL loader
(reference: matcher/data/pascal.py): ``VOC2012/SegmentationClassAug``
masks, fold split lists ``VOC2012/splits/{split}/fold{f}.txt`` of
``name__classid`` lines, fold classes = contiguous blocks of 5
(``fold*5 + i``), 1000 val episodes (idx wraps), boundary-255 regions
exposed as ignore masks.
"""
from __future__ import annotations

import os

import numpy as np

from mars_tpu_torch.data.base import EpisodeRecord, read_image
from mars_tpu_torch.data.pascal5i import PASCAL_CLASS_NAMES


class DatasetPascal:
    benchmark = "pascal"
    nfolds = 4
    nclass = 20

    def __init__(self, datapath: str, fold: int, split: str, shot: int, seed: int = 0):
        self.split = "val" if split in ("val", "test") else "trn"
        self.fold = fold
        self.shot = shot
        self.img_path = os.path.join(datapath, "VOC2012", "JPEGImages")
        self.ann_path = os.path.join(datapath, "VOC2012", "SegmentationClassAug")
        self.base_path = os.path.join(datapath, "VOC2012")
        self.rng = np.random.RandomState(seed)

        nper = self.nclass // self.nfolds
        val_ids = [fold * nper + i for i in range(nper)]
        self.class_ids = (
            val_ids if self.split == "val"
            else [x for x in range(self.nclass) if x not in val_ids]
        )
        self.idx_to_classname = {i: PASCAL_CLASS_NAMES[i] for i in self.class_ids}

        def read_meta(fold_id):
            p = os.path.join(self.base_path, "splits", self.split, f"fold{fold_id}.txt")
            with open(p) as f:
                lines = [l for l in f.read().split("\n") if l]
            return [(l.split("__")[0], int(l.split("__")[1]) - 1) for l in lines]

        if self.split == "trn":
            self.img_metadata = []
            for f_id in range(self.nfolds):
                if f_id != fold:
                    self.img_metadata += read_meta(f_id)
        else:
            self.img_metadata = read_meta(fold)
        self.img_metadata_classwise = {c: [] for c in range(self.nclass)}
        for name, cls in self.img_metadata:
            self.img_metadata_classwise[cls].append(name)

    def __len__(self):
        return len(self.img_metadata) if self.split == "trn" else 1000

    def _mask_and_ignore(self, name: str, cls: int):
        raw = read_image(os.path.join(self.ann_path, name + ".png"))
        ignore = (raw == 255).astype(np.float32)
        mask = (raw == cls + 1).astype(np.float32)
        return mask, ignore

    def __getitem__(self, idx) -> EpisodeRecord:
        idx %= len(self.img_metadata)
        query_name, cls = self.img_metadata[idx]
        support_names = []
        while len(support_names) < self.shot:
            s = self.rng.choice(self.img_metadata_classwise[cls])
            if s != query_name:
                support_names.append(s)
        qimg = read_image(os.path.join(self.img_path, query_name + ".jpg"), "RGB")
        qmask, ignore = self._mask_and_ignore(query_name, cls)
        sup_imgs = [
            read_image(os.path.join(self.img_path, n + ".jpg"), "RGB") for n in support_names
        ]
        sup_masks = [self._mask_and_ignore(n, cls)[0] for n in support_names]
        return EpisodeRecord(
            query_img=qimg, query_mask=qmask,
            support_imgs=sup_imgs, support_masks=sup_masks,
            class_id=cls, class_name=PASCAL_CLASS_NAMES[cls],
            query_name=query_name, support_names=support_names,
            query_ignore=ignore, org_query_imsize=qimg.shape[:2],
        )
