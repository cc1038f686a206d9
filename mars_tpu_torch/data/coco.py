"""COCO-20i episode dataset (the port's own copy of ``mars_tpu/data/coco.py``:
the same seed gives the same records).

Functional parity with the reference (reference: matcher/data/coco.py):
4 folds x 20 classes (``fold + 4*v``), classwise image lists from
``COCO2014/splits/{trn,val}/fold{f}.pkl``, per-image PNG annotation masks
where pixel == class_id+1, episodes sampled uniformly over classes per
__getitem__ (idx ignored), 1000 val / 3000 trn episodes.
"""
from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from mars_tpu_torch.data.base import EpisodeRecord, read_image

# COCO class names (reference coco.py:12-13)
COCO_CLASS_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


class DatasetCOCO20i:
    benchmark = "coco"
    nfolds = 4
    nclass = 80

    def __init__(self, datapath: str, fold: int, split: str, shot: int, seed: int = 0,
                 annotations_path: str = None):
        self.split = "val" if split in ("val", "test") else "trn"
        self.fold = fold
        self.shot = shot
        self.base_path = os.path.join(datapath, "COCO2014")
        # --annotations-datapath override (reference main_MARS.py:114 passes
        # it from scripts/coco_*.sh; its coco.py hardcodes base/annotations)
        self.annotations_path = annotations_path or os.path.join(
            self.base_path, "annotations")
        self.rng = np.random.RandomState(seed)

        self.class_ids = self.build_class_ids()
        self.idx_to_classname = {i: COCO_CLASS_NAMES[i] for i in self.class_ids}
        with open(f"{self.base_path}/splits/{self.split}/fold{fold}.pkl", "rb") as f:
            self.img_metadata_classwise = pickle.load(f)

    def build_class_ids(self) -> List[int]:
        nper = self.nclass // self.nfolds
        val = [self.fold + self.nfolds * v for v in range(nper)]
        if self.split == "trn":
            return [x for x in range(self.nclass) if x not in val]
        return val

    def __len__(self):
        return 1000 if self.split == "val" else 3000

    def read_mask(self, name: str) -> np.ndarray:
        path = os.path.join(self.annotations_path, name)
        path = path[: path.index(".jpg")] + ".png"
        return read_image(path)

    def __getitem__(self, idx) -> EpisodeRecord:
        cls = self.rng.choice(self.class_ids)
        names = self.img_metadata_classwise[cls]
        query_name = self.rng.choice(names)
        qimg = read_image(os.path.join(self.base_path, query_name), "RGB")
        qmask = (self.read_mask(query_name) == cls + 1).astype(np.float32)

        support_names = []
        while len(support_names) < self.shot:
            s = self.rng.choice(names)
            if s != query_name:
                support_names.append(s)
        sup_imgs = [
            read_image(os.path.join(self.base_path, n), "RGB") for n in support_names
        ]
        sup_masks = [(self.read_mask(n) == cls + 1).astype(np.float32) for n in support_names]
        return EpisodeRecord(
            query_img=qimg, query_mask=qmask,
            support_imgs=sup_imgs, support_masks=sup_masks,
            class_id=int(cls), class_name=COCO_CLASS_NAMES[cls],
            query_name=query_name, support_names=support_names,
            org_query_imsize=qimg.shape[:2],
        )
