"""PASCAL-5i episode dataset (the port's own copy of
``mars_tpu/data/pascal5i.py``: the same seed gives the same records).

Functional parity with the reference (reference: matcher/data/pascal5i.py):
  - val images = VOC2012 segmentation-val list (PANet protocol); train =
    SBD train+val minus VOC val overlap, VOC annotations preferred (:40-96)
  - fold f test classes = {5f+1 .. 5f+5} (:99-108)
  - image↔class maps built by scanning masks, cached to
    ``dataset_{fold}_{train}.json`` (the reference caches with torch.save;
    json keeps this torch-free) (:124-160)
  - per-episode: class chosen round-robin over the classes in the query
    image; random supports containing the class (:240-273)
  - boundary-255 pixels exposed as ``query_ignore`` (evaluator excludes
    them, reference mars/utils/evaluation.py:15-21)
"""
from __future__ import annotations

import json
import os

import numpy as np

from mars_tpu_torch.data.base import EpisodeRecord, read_image

PASCAL_CLASS_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "dining table", "dog", "horse", "motorbike", "person",
    "potted plant", "sheep", "sofa", "train", "tv/monitor",
]


def _load_seg_mask(path: str) -> np.ndarray:
    if path.endswith(".mat"):
        from scipy.io import loadmat

        mat = loadmat(path)
        return np.array(mat["GTcls"][0]["Segmentation"][0], dtype=np.int64)
    return np.array(read_image(path), dtype=np.int64)


class DatasetPascal5i:
    benchmark = "pascal5i"
    nclass = 20

    def __init__(self, datapath: str, fold: int, split: str, shot: int, seed: int = 0):
        self.train = split == "trn"
        self.fold = fold
        self.shot = shot
        self.rng = np.random.RandomState(seed)

        sbd_base = os.path.join(datapath, "PASCAL5i", "sbd")
        voc_base = os.path.join(datapath, "PASCAL5i", "VOCdevkit", "VOC2012")

        def lines(p):
            with open(p) as f:
                return [l.strip() for l in f if l.strip()]

        voc_train = lines(os.path.join(voc_base, "ImageSets", "Segmentation", "train.txt"))
        voc_val = lines(os.path.join(voc_base, "ImageSets", "Segmentation", "val.txt"))

        if self.train:
            sbd_train = lines(os.path.join(sbd_base, "train.txt")) + lines(
                os.path.join(sbd_base, "val.txt")
            )
            sbd_train = [i for i in sbd_train if i not in voc_val]
            sbd_train = [i for i in sbd_train if i not in voc_train]
            self.images = [os.path.join(sbd_base, "img", i + ".jpg") for i in sbd_train] + [
                os.path.join(voc_base, "JPEGImages", i + ".jpg") for i in voc_train
            ]
            self.targets = [os.path.join(sbd_base, "cls", i + ".mat") for i in sbd_train] + [
                os.path.join(voc_base, "SegmentationClass", i + ".png") for i in voc_train
            ]
        else:
            self.images = [os.path.join(voc_base, "JPEGImages", i + ".jpg") for i in voc_val]
            self.targets = [
                os.path.join(voc_base, "SegmentationClass", i + ".png") for i in voc_val
            ]

        self.val_label_set = list(range(fold * 5 + 1, fold * 5 + 6))
        self.label_set = (
            [i for i in range(1, 21) if i not in self.val_label_set]
            if self.train
            else self.val_label_set
        )
        self.class_ids = self.label_set
        self.idx_to_classname = {i: PASCAL_CLASS_NAMES[i - 1] for i in self.label_set}

        cache = os.path.join(voc_base, f"dataset_{fold}_{self.train}.json")
        if os.path.exists(cache):
            with open(cache) as f:
                d = json.load(f)
            self.img_class_map = {int(k): v for k, v in d["icm"].items()}
            self.class_img_map = {int(k): v for k, v in d["cim"].items()}
            self.images = d["fi"]
            self.targets = d["ft"]
        else:
            folded_images, folded_targets = [], []
            self.class_img_map = {x: [] for x in self.label_set}
            self.img_class_map = {}
            for i in range(len(self.images)):
                mask = _load_seg_mask(self.targets[i])
                present = [x for x in self.label_set if (mask == x).any()]
                if present:
                    folded_images.append(self.images[i])
                    folded_targets.append(self.targets[i])
                    img_id = len(folded_images) - 1
                    self.img_class_map[img_id] = present
                    for x in present:
                        self.class_img_map[x].append(img_id)
            self.images, self.targets = folded_images, folded_targets
            with open(cache, "w") as f:
                json.dump({"icm": self.img_class_map, "cim": self.class_img_map,
                           "fi": self.images, "ft": self.targets}, f)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx, offset: int = 0) -> EpisodeRecord:
        classes = self.img_class_map[idx]
        cls = classes[offset % len(classes)]
        query_name = self.images[idx]
        qmask_full = _load_seg_mask(self.targets[idx])
        qimg = read_image(query_name, "RGB")
        qmask = (qmask_full == cls).astype(np.float32)
        ignore = (qmask_full == 255).astype(np.float32)

        support_names = []
        sup_idx = []
        while len(support_names) < self.shot:
            j = self.rng.choice(self.class_img_map[cls])
            if self.images[j] != query_name:
                support_names.append(self.images[j])
                sup_idx.append(j)
        sup_imgs = [read_image(n, "RGB") for n in support_names]
        sup_masks = [
            (_load_seg_mask(self.targets[j]) == cls).astype(np.float32) for j in sup_idx
        ]
        return EpisodeRecord(
            query_img=qimg, query_mask=qmask,
            support_imgs=sup_imgs, support_masks=sup_masks,
            class_id=cls - 1,  # meter uses 0-indexed (logger.py:21-23)
            class_name=PASCAL_CLASS_NAMES[cls - 1],
            query_name=query_name, support_names=support_names,
            query_ignore=ignore, org_query_imsize=qimg.shape[:2],
        )
