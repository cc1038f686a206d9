"""Episode records and host→device conversion (port of the host half of
``mars_tpu/data/base.py``).

Datasets yield numpy ``EpisodeRecord``s; ``to_device_episode`` resizes on
the host (``image_io.resize``: PIL's bilinear and nearest bit for bit, the
reference's torchvision path, without PIL), pads the shot dimension and
makes one transfer per field.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from mars_tpu_torch.core import imaging
from mars_tpu_torch.data import image_io
from mars_tpu_torch.device import to_device
from mars_tpu_torch.core.episode import Episode


@dataclass
class EpisodeRecord:
    query_img: np.ndarray  # (H, W, 3) uint8
    query_mask: np.ndarray  # (H, W) {0,1}
    support_imgs: List[np.ndarray]  # each (H, W, 3) uint8
    support_masks: List[np.ndarray]  # each (H, W) {0,1}
    class_id: int
    class_name: str = ""
    query_name: str = ""
    support_names: List[str] = field(default_factory=list)
    query_ignore: Optional[np.ndarray] = None  # (H, W) {0,1} PASCAL boundary
    org_query_imsize: Optional[Tuple[int, int]] = None


def read_image(path: str, mode: Optional[str] = None) -> np.ndarray:
    """An image file as a numpy array, as the reference reads it with PIL
    (``Image.open(path)``, converted to ``mode`` when given):
    ``image_io.read_image``."""
    return image_io.read_image(path, mode)


def _pil_resize(a: np.ndarray, size: int, nearest: bool) -> np.ndarray:
    """PIL's ``resize((size, size), NEAREST | BILINEAR)`` of a uint8 image."""
    a = np.ascontiguousarray(np.asarray(a, np.uint8))
    if a.shape[:2] == (size, size):
        return a  # PIL returns an unchanged copy at the same size
    return image_io.resize(a, size, size, image_io.NEAREST if nearest else image_io.BILINEAR)


def episode_host_u8(rec: EpisodeRecord, size: int, max_shots: int):
    """Resized uint8 numpy fields: (support images, support masks, query
    image, shot validity)."""
    s = len(rec.support_imgs)
    if s > max_shots:
        raise ValueError(f"{s} shots > max_shots {max_shots}")
    sup_i = [_pil_resize(i, size, nearest=False) for i in rec.support_imgs]
    sup_m = [_pil_resize(m, size, nearest=True) for m in rec.support_masks]
    for _ in range(max_shots - s):
        sup_i.append(np.zeros((size, size, 3), np.uint8))
        sup_m.append(np.zeros((size, size), np.uint8))
    return (np.stack(sup_i), np.stack(sup_m), _pil_resize(rec.query_img, size, nearest=False),
            np.arange(max_shots) < s)


def to_device_episode(rec: EpisodeRecord, size: int, max_shots: int,
                      device: torch.device) -> Episode:
    """uint8 over the wire, float conversion on the device."""
    return episode_from_host(episode_host_u8(rec, size, max_shots), int(rec.class_id), device)


def episode_from_host(host, class_id: int, device: torch.device) -> Episode:
    """``episode_host_u8``'s arrays on the device (the copies and the float
    conversion of ``to_device_episode``; to the card without blocking,
    ``device.to_device``), the support masks kept on the host too."""
    sup, msk, qry, valid = host
    return Episode(
        support_images=to_device(torch.from_numpy(sup), device).float() / 255.0,
        support_masks=to_device(torch.from_numpy(msk), device).float(),
        support_valid=to_device(torch.from_numpy(valid), device),
        query_image=to_device(torch.from_numpy(qry), device).float() / 255.0,
        class_id=class_id,
        support_host=(msk, valid),
    )


def resized_gt(rec: EpisodeRecord, size: int = 518):
    """Ground-truth mask (and ignore mask) at evaluation resolution, numpy."""
    def rs(m):
        t = torch.from_numpy(np.asarray(m, np.float32))
        return imaging.resize_mask(t, (size, size)).numpy()

    return rs(rec.query_mask), (None if rec.query_ignore is None else rs(rec.query_ignore))
