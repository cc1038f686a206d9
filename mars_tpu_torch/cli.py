"""Evaluation CLI, ranking subset (port of ``mars_tpu/cli.py``).

Per episode: synthetic proposals (the ground truth plus six random boxes,
as ``mars_tpu.cli.synthetic_proposals`` draws them from the same seed),
``Mars.predict`` with the dataset's class name, and the meter update.
Towers are full width with seeded random weights.  Prints each episode's
ranking time and the running mIoU.

    python -m mars_tpu_torch.cli --benchmark synthetic --episodes 3 --gt-class-names

The VLM retriever, precomputed proposal dumps, real datasets and the other
flags of the JAX CLI are not ported yet.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.core.episode import Proposals, pad_proposals
from mars_tpu_torch.data.base import resized_gt, to_device_episode
from mars_tpu_torch.data.synthetic import SyntheticFSS
from mars_tpu_torch.models import zoo
from mars_tpu_torch.pipeline import filtering, mars as mars_lib, vta, vva
from mars_tpu_torch.utils import evaluation


def build_mars_config(input_size: int) -> mars_lib.MarsConfig:
    """Stage configs for an input size (DINOv2 patch 14, CLIP-B patch 16)."""
    g = input_size // 14
    vta_in = int(math.ceil(input_size / 16) * 16)
    return mars_lib.MarsConfig(
        vva=vva.VVAConfig(grid=g),
        vta=vta.VTAConfig(input_size=vta_in, grid=vta_in // 16),
        filter_merge=filtering.FilterMergeConfig(grid=g),
    )


def build_model(input_size: int, device) -> mars_lib.Mars:
    """Full-width towers (DINOv2-L/14 reg4, CLIP-B/16, AlphaCLIP-L/14@336)
    with the JAX package's weight seeds (0, 1, 2)."""
    return mars_lib.Mars(dino=zoo.build_dinov2(0, device), clip=zoo.build_clip(1, device),
                         alpha_clip=zoo.build_alpha_clip(2, device),
                         cfg=build_mars_config(input_size), device=device)


def synthetic_proposals(rec, size: int, bucket: int, rng: np.random.RandomState,
                        device) -> Proposals:
    """Ground truth + six random boxes, padded to the bucket."""
    gt, _ = resized_gt(rec, size)
    props = [gt]
    for _ in range(6):
        y, x = rng.randint(0, size - 64, 2)
        m = np.zeros_like(gt)
        m[y: y + rng.randint(32, 128), x: x + rng.randint(32, 128)] = 1
        props.append(m)
    return pad_proposals(torch.from_numpy(np.stack(props)).to(device), bucket)


def parse_args(argv=None):
    p = argparse.ArgumentParser("mars_tpu_torch evaluation")
    p.add_argument("--benchmark", default="synthetic", choices=["synthetic"])
    p.add_argument("--episodes", type=int, default=0, help="0 = full split")
    p.add_argument("--gt-class-names", action="store_true",
                   help="use dataset class names (required: the VLM is not ported)")
    p.add_argument("--proposal-bucket", type=int, default=128)
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the episode loop; returns {miou, fb_iou, episode_ms, masks_binary}."""
    args = parse_args(argv)
    if not args.gt_class_names:
        raise SystemExit("--gt-class-names is required: the VLM retriever is not ported yet")
    dev = device_lib.resolve(args.device)
    np.random.seed(args.seed)
    ds = SyntheticFSS(fold=0, split="test", shot=1, seed=args.seed)
    model = build_model(args.input_size, dev)
    meter = evaluation.AverageMeter(ds.benchmark, list(ds.class_ids))
    rng = np.random.RandomState(args.seed)
    episode_ms, masks_binary = [], True
    for idx in range(args.episodes or len(ds)):
        rec = ds[idx]
        ep = to_device_episode(rec, args.input_size, 1, dev)
        props = synthetic_proposals(rec, args.input_size, args.proposal_bucket, rng, dev)
        t0 = time.perf_counter()
        pred = model.predict(ep, props, class_name=rec.class_name).cpu().numpy()
        episode_ms.append((time.perf_counter() - t0) * 1e3)
        masks_binary &= bool(np.isin(pred, (0.0, 1.0)).all())
        gt, ig = resized_gt(rec, args.input_size)
        meter.update(*evaluation.classify_prediction(pred, gt, ig), rec.class_id)
        miou, _, _ = meter.compute_iou()
        print(f"[{idx + 1}] {rec.class_name}: {episode_ms[-1]:.1f} ms  mIoU {miou:.2f}",
              flush=True)
    miou, fb, _ = meter.compute_iou()
    print(f"*** mIoU: {miou:.2f}  FB-IoU: {fb:.2f} ***", flush=True)
    return {"miou": miou, "fb_iou": fb, "episode_ms": episode_ms, "masks_binary": masks_binary}


if __name__ == "__main__":
    main()
