"""Synthetic procedural episodes — test/benchmark substrate (the port's
own copy of ``mars_tpu/data/synthetic.py``: the same seed gives the same
episodes).

Generates deterministic episodes of colored geometric shapes on textured
backgrounds: the "class" is a (shape, color) pair, the support and query
show different instances of the same class among distractors.  Lets the
full pipeline (matching, proposals, ranking, evaluation) run end-to-end
with meaningful (non-trivial but learnable-free) structure when no
benchmark data is mounted.
"""
from __future__ import annotations

import numpy as np

from mars_tpu_torch.data.base import EpisodeRecord

SHAPES = ["square", "circle", "triangle", "stripe"]
COLORS = [(220, 60, 60), (60, 200, 80), (70, 90, 220), (230, 200, 60)]
CLASS_NAMES = [f"{c} {s}" for s in SHAPES for c in ("red", "green", "blue", "yellow")]


def _draw_shape(img, mask, shape, color, cx, cy, r):
    h, w = mask.shape
    yy, xx = np.mgrid[0:h, 0:w]
    if shape == "square":
        m = (np.abs(xx - cx) < r) & (np.abs(yy - cy) < r)
    elif shape == "circle":
        m = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
    elif shape == "triangle":
        m = (yy > cy - r) & (yy < cy + r) & (np.abs(xx - cx) < (yy - (cy - r)) / 2)
    else:  # stripe
        m = (np.abs((xx - cx) + (yy - cy)) < r // 2) & (np.abs(xx - cx) < 2 * r)
    img[m] = color
    mask[m] = 1.0
    return img, mask


class SyntheticFSS:
    benchmark = "synthetic"

    def __init__(self, fold: int = 0, split: str = "val", shot: int = 1,
                 size: int = 518, num_episodes: int = 50, seed: int = 0):
        self.shot = shot
        self.size = size
        self.num_episodes = num_episodes
        self.seed = seed
        self.class_ids = list(range(len(SHAPES) * len(COLORS)))
        self.idx_to_classname = dict(enumerate(CLASS_NAMES))

    def __len__(self):
        return self.num_episodes

    def _scene(self, rng, cls, with_target=True):
        s = self.size
        img = (rng.rand(s, s, 3) * 40 + 100).astype(np.uint8)
        mask = np.zeros((s, s), np.float32)
        shape = SHAPES[cls // len(COLORS)]
        color = COLORS[cls % len(COLORS)]
        # distractors: other classes
        for _ in range(3):
            dcls = rng.randint(len(self.class_ids))
            if dcls == cls:
                continue
            dm = np.zeros((s, s), np.float32)
            lo, hi = max(s // 8, 8), s - max(s // 8, 8)
            _draw_shape(img, dm, SHAPES[dcls // len(COLORS)], COLORS[dcls % len(COLORS)],
                        rng.randint(lo, hi), rng.randint(lo, hi), max(rng.randint(s // 20, s // 11), 4))
        if with_target:
            lo, hi = max(s // 6, 10), s - max(s // 6, 10)
            _draw_shape(img, mask, shape, color,
                        rng.randint(lo, hi), rng.randint(lo, hi),
                        max(rng.randint(s // 15, s // 7), 5))
        return img, mask

    def __getitem__(self, idx) -> EpisodeRecord:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        cls = int(rng.randint(len(self.class_ids)))
        qimg, qmask = self._scene(rng, cls)
        sup = [self._scene(rng, cls) for _ in range(self.shot)]
        return EpisodeRecord(
            query_img=qimg, query_mask=qmask,
            support_imgs=[x[0] for x in sup], support_masks=[x[1] for x in sup],
            class_id=cls, class_name=CLASS_NAMES[cls],
            query_name=f"synthetic/{idx}",
        )
