"""Offline proposal generation (port of ``mars_tpu/cli_proposals.py``): the
first program of the reference's two-program evaluation.

The Matcher (DINOv2 ``--dino-backbone`` matching, SAM ``--sam-size``
@1024, AMG) runs over the ``--nshot`` episodes of a benchmark fold (the
loaders ``cli`` uses) and writes one compressed ``{fold}_{idx}.npz`` per
episode with the JAX CLI's keys and types: ``masks`` (the live post-NMS
proposals, uint8), ``iou``, ``stability`` and ``emd`` (float32, per live
proposal), ``merged`` (the Matcher's own merge, uint8) and ``class_id``.
``cli --mask-proposals-path`` ranks them.  Towers are full width, from
the reference's checkpoints in ``--models-path`` or with seeded random
weights (``models.zoo``); ``--bf16`` casts DINOv2 and SAM to bfloat16.
The prompt sampler draws from ``cli.episode_generator``, the stream the
inline ``--generate-proposals`` path uses.

    python -m mars_tpu_torch.cli_proposals --benchmark synthetic --episodes 2 --out /tmp/props
    python -m mars_tpu_torch.cli_proposals --benchmark coco --nshot 5 --datapath /data \
        --models-path /models --bf16 --out /tmp/props

With random weights the AMG's default thresholds reject every mask, so a
dump holds 0 proposals.  The pycocotools RLE side file (``--coco-rle``) and
``--visualize`` are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mars_tpu_torch import cli
from mars_tpu_torch import device as device_lib
from mars_tpu_torch.data.base import to_device_episode
from mars_tpu_torch.models import zoo
from mars_tpu_torch.models.precision import cast_floating
from mars_tpu_torch.pipeline import amg, matcher


def parse_args(argv=None):
    p = argparse.ArgumentParser("mars_tpu_torch offline proposal generation")
    cli.add_model_args(p)
    p.add_argument("--nshot", type=int, default=1)
    p.add_argument("--bf16", action="store_true", help="bf16 DINOv2 and SAM weights")
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Writes the dumps; returns {proposal_ms (per episode, the Matcher
    with a device synchronise), live_proposals, launches (per kernel, this
    run), episode_launches (per kernel, each episode), episode_peak_gib
    (each episode's peak on the card), files}."""
    args = parse_args(argv)
    dev = device_lib.resolve(args.device)
    ds = cli.dataset(args)
    dino_params, dino_cfg = zoo.build_dinov2(args.models_path, args.dino_backbone, args.num_regs,
                                             device=dev)
    sam_params, sam_cfg = zoo.build_sam(args.models_path, args.sam_size, device=dev)
    if args.bf16:
        dino_params, sam_params = cast_floating(dino_params), cast_floating(sam_params)
    mcfg = matcher.MatcherConfig(input_size=args.input_size,
                                 grid=args.input_size // dino_cfg.patch_size,
                                 patch_size=dino_cfg.patch_size)
    acfg = amg.AmgConfig()
    os.makedirs(args.out, exist_ok=True)
    launches0 = cli.kernel_launches()
    proposal_ms, live, files, episode_launches, episode_peak = [], [], [], [], []
    n = args.episodes or len(ds)
    for idx in range(n):
        before = cli.kernel_launches()
        cli._reset_peak(dev)
        rec = ds[idx]
        ep = to_device_episode(rec, args.input_size, args.nshot, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            out = matcher.generate_proposals(
                dino_params, dino_cfg, sam_params, sam_cfg, acfg, mcfg, ep.support_images,
                ep.support_masks, ep.support_valid, ep.query_image,
                generator=cli.episode_generator(args.seed, idx, dev))
        cli._sync(dev)
        proposal_ms.append((time.perf_counter() - t0) * 1e3)
        episode_launches.append(cli.launches_since(before))
        episode_peak.append(cli._peak_gib(dev))
        valid = out["proposal_valid"].cpu().numpy()
        path = os.path.join(args.out, f"{args.fold}_{idx}.npz")
        # float32 on the host: a bfloat16 tower's iou would not convert to numpy
        np.savez_compressed(
            path,
            masks=out["proposal_masks"].cpu().numpy()[valid].astype(np.uint8),
            iou=out["iou"].float().cpu().numpy()[valid],
            stability=out["stability"].float().cpu().numpy()[valid],
            emd=out["emd_score"].float().cpu().numpy()[valid],
            merged=out["merged"].cpu().numpy().astype(np.uint8),
            class_id=rec.class_id)
        files.append(path)
        live.append(int(valid.sum()))
        print(f"[{idx + 1}/{n}] {live[-1]} proposals  {proposal_ms[-1] / 1e3:.2f}s", flush=True)
    return {"proposal_ms": proposal_ms, "live_proposals": live, "files": files,
            "launches": cli.launches_since(launches0), "episode_launches": episode_launches,
            "episode_peak_gib": episode_peak}


if __name__ == "__main__":
    main()
