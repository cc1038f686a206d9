"""PACO-Part and PASCAL-Part episode datasets (part segmentation; the port's
own copy of ``mars_tpu/data/parts.py``: the same seed gives the same records).

Functional parity with the reference's Matcher part benchmarks
(reference: matcher/data/paco_part.py, matcher/data/pascal_part.py):
  - pkl annotation bundles with ``cid2img`` (class → [{img_id: path}]) and
    ``img2anno`` (img_id → annotation list); val classes chosen by
    ``fold + nfolds*v`` striding filtered to classes with > shot images
  - per-episode: one random object of the class; its PART masks are unioned
    into the episode mask; optional crop to the object's box
    (``box_crop``, paco_part.py:168-189)
  - segmentations decoded from polygons or COCO RLE (own decoder,
    data.lvis)
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from mars_tpu_torch.data.base import EpisodeRecord, read_image
from mars_tpu_torch.data.lvis import ann_to_mask


class _PartDataset:
    nfolds = 4
    benchmark = "paco_part"
    nclass = 448

    def __init__(self, datapath: str, fold: int, split: str, shot: int,
                 seed: int = 0, box_crop: bool = True):
        self.split = "val" if split in ("val", "test") else "trn"
        self.fold = fold
        self.shot = shot
        self.box_crop = box_crop
        self.rng = np.random.RandomState(seed)
        self.img_path, train_anno, test_anno = self._load_annotations(datapath)

        # de-duplicate test images per class (reference paco_part.py:69-79)
        for anno in (test_anno,):
            new = {}
            for cid, imgs in anno["cid2img"].items():
                seen, out = set(), []
                for img in imgs:
                    iid = list(img.keys())[0]
                    if iid not in seen:
                        seen.add(iid)
                        out.append(img)
                new[cid] = out
            anno["cid2img"] = new

        train_ids = list(train_anno["cid2img"].keys())
        test_ids = [i for i in test_anno["cid2img"]
                    if len(test_anno["cid2img"][i]) > shot]
        nper = self.nclass // self.nfolds
        val_ids = [train_ids[fold + self.nfolds * v] for v in range(nper)]
        val_ids = [x for x in val_ids if x in test_ids]
        if self.split == "trn":
            self.class_ids_ori = [x for x in train_ids if x not in val_ids]
            anno = train_anno
        else:
            self.class_ids_ori = val_ids
            anno = test_anno
        self.cid2img = anno["cid2img"]
        self.img2anno = anno["img2anno"]
        self.class_ids_c = {cid: i for i, cid in enumerate(self.class_ids_ori)}
        self.class_ids = sorted(self.class_ids_c.values())

    def _load_annotations(self, datapath):
        raise NotImplementedError

    def __len__(self):
        return 2500 if self.split == "val" else sum(
            len(v) for v in self.cid2img.values()
        )

    def _object_mask(self, img_id, cls, hw):
        """Union of one random object's part masks + its box
        (reference load_frame :126-152)."""
        objs = {}
        for anno in self.img2anno[img_id]:
            if anno["category_id"] == cls:
                oid = anno["obj_ann_id"]
                objs.setdefault(oid, {"bbox": anno["obj_bbox"], "segms": []})
                objs[oid]["segms"].append(ann_to_mask(anno["segmentation"], *hw))
        oid = self.rng.choice(list(objs.keys()))
        mask = np.maximum.reduce(objs[oid]["segms"])
        return mask.astype(np.float32), objs[oid]["bbox"]

    def _crop(self, img, mask, bbox):
        if not self.box_crop:
            return img, mask
        x, y, w, h = [int(v) for v in bbox]
        x1, y1 = max(x, 0), max(y, 0)
        x2, y2 = min(x + w, img.shape[1]), min(y + h, img.shape[0])
        if x2 <= x1 or y2 <= y1:
            return img, mask
        return img[y1:y2, x1:x2], mask[y1:y2, x1:x2]

    def __getitem__(self, idx) -> EpisodeRecord:
        cls = self.rng.choice(self.class_ids_ori)
        q = self.rng.choice(self.cid2img[cls])
        q_id, q_name = list(q.keys())[0], list(q.values())[0]
        q_name = "/".join(q_name.split("/")[-2:])
        qimg = read_image(os.path.join(self.img_path, q_name), "RGB")
        qmask, qbox = self._object_mask(q_id, cls, qimg.shape[:2])
        qimg, qmask = self._crop(qimg, qmask, qbox)

        sup_imgs, sup_masks, support_names = [], [], []
        while len(sup_imgs) < self.shot:
            s = self.rng.choice(self.cid2img[cls])
            s_id, s_name = list(s.keys())[0], list(s.values())[0]
            s_name = "/".join(s_name.split("/")[-2:])
            if s_name == q_name:
                continue
            simg = read_image(os.path.join(self.img_path, s_name), "RGB")
            smask, sbox = self._object_mask(s_id, cls, simg.shape[:2])
            simg, smask = self._crop(simg, smask, sbox)
            sup_imgs.append(simg)
            sup_masks.append(smask)
            support_names.append(s_name)
        return EpisodeRecord(
            query_img=qimg, query_mask=qmask,
            support_imgs=sup_imgs, support_masks=sup_masks,
            class_id=self.class_ids_c[cls],
            query_name=q_name, support_names=support_names,
            org_query_imsize=qimg.shape[:2],
        )


class DatasetPacoPart(_PartDataset):
    benchmark = "paco_part"
    nclass = 448

    def _load_annotations(self, datapath):
        base = os.path.join(datapath, "PACO-Part")
        with open(os.path.join(base, "paco", "paco_part_train.pkl"), "rb") as f:
            train_anno = pickle.load(f)
        with open(os.path.join(base, "paco", "paco_part_val.pkl"), "rb") as f:
            test_anno = pickle.load(f)
        return os.path.join(base, "coco"), train_anno, test_anno


class DatasetPascalPart(_PartDataset):
    benchmark = "pascal_part"
    nclass = 100

    def _load_annotations(self, datapath):
        base = os.path.join(datapath, "Pascal-Part")
        with open(os.path.join(base, "pascal_part_train.pkl"), "rb") as f:
            train_anno = pickle.load(f)
        with open(os.path.join(base, "pascal_part_val.pkl"), "rb") as f:
            test_anno = pickle.load(f)
        return os.path.join(base, "VOCdevkit", "VOC2010", "JPEGImages"), train_anno, test_anno
