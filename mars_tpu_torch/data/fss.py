"""FSS-1000 episode dataset (the port's own copy of ``mars_tpu/data/fss.py``:
the same seed gives the same records).

Functional parity with the reference (reference: matcher/data/fss.py):
category lists from ``FSS-1000/splits/{split}.txt`` (sorted), deterministic
per-image episode enumeration, class ids 0-519 trn / 520-759 val /
760-999 test, masks thresholded at 128, supports drawn from images 1..10 of
the same category folder.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from mars_tpu_torch.data.base import EpisodeRecord, read_image


class DatasetFSS:
    benchmark = "fss"

    def __init__(self, datapath: str, fold: int, split: str, shot: int, seed: int = 0):
        self.split = split
        self.shot = shot
        self.base_path = os.path.join(datapath, "FSS-1000/data")
        with open(os.path.join(datapath, f"FSS-1000/splits/{split}.txt")) as f:
            self.categories = sorted(f.read().split("\n")[:-1])
        self.class_offset = {"trn": 0, "val": 520, "test": 760}[split]
        self.class_ids = list(range(self.class_offset, self.class_offset + len(self.categories)))
        self.rng = np.random.RandomState(seed)

        self.img_metadata = []
        for cat in self.categories:
            for p in sorted(glob.glob(os.path.join(self.base_path, cat, "*"))):
                if os.path.basename(p).split(".")[-1] == "jpg":
                    self.img_metadata.append(p)

    def __len__(self):
        return len(self.img_metadata)

    @staticmethod
    def read_mask(path: str) -> np.ndarray:
        m = read_image(path, "L")
        return (m >= 128).astype(np.float32)

    def __getitem__(self, idx) -> EpisodeRecord:
        query_name = self.img_metadata[idx]
        cat = query_name.split(os.sep)[-2]
        cls = self.categories.index(cat) + self.class_offset

        support_names = []
        while len(support_names) < self.shot:
            i = self.rng.choice(range(1, 11))
            s = os.path.join(os.path.dirname(query_name), f"{i}.jpg")
            if s != query_name:
                support_names.append(s)

        def png(p):
            return os.path.splitext(p)[0] + ".png"

        qimg = read_image(query_name, "RGB")
        qmask = self.read_mask(png(query_name))
        sup_imgs = [read_image(n, "RGB") for n in support_names]
        sup_masks = [self.read_mask(png(n)) for n in support_names]
        return EpisodeRecord(
            query_img=qimg, query_mask=qmask,
            support_imgs=sup_imgs, support_masks=sup_masks,
            class_id=cls, class_name=cat,
            query_name=query_name, support_names=support_names,
        )
