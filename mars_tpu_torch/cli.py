"""Evaluation CLI (port of ``mars_tpu/cli.py``, a subset of its flags).

Per episode of a benchmark fold (``--benchmark``: the reference's COCO-20i,
PASCAL-5i, LVIS-92i and FSS-1000 loaders over ``--datapath``, or
synthetic episodes; ``--nshot`` 1 or 5 support shots): proposals,
``Mars.predict`` with the dataset's class name, and the meter update.
Proposals are synthetic (the ground truth plus six random boxes, as
``mars_tpu.cli.synthetic_proposals`` draws them from the same seed),
loaded from dumps (``--mask-proposals-path``: the reference's evaluation
mode, one ``{fold}_{idx}`` stack per episode as ``cli_proposals`` writes
them) or, with ``--generate-proposals``, the Matcher's (DINOv2 matching
shared with the VVA tower, SAM ``--sam-size`` @1024, AMG, bucketed best
mask score first).  Towers are full width: the reference's checkpoints
from ``--models-path`` by their file names (``models.zoo``), seeded random
weights for any file that is not there.  ``--dino-backbone``,
``--num-regs`` and ``--vta-backbone`` pick the towers, and the tuning
flags reach the stage configs as in the JAX CLI.  ``--bf16`` casts the
DINOv2, CLIP visual and AlphaCLIP visual towers (and SAM) to bfloat16, as
the JAX CLI does, the text towers staying float32.  Prints each episode's
proposal and ranking times, its live proposals and the running mIoU.

    python -m mars_tpu_torch.cli --benchmark synthetic --episodes 3 --gt-class-names
    python -m mars_tpu_torch.cli --episodes 2 --gt-class-names --generate-proposals
    python -m mars_tpu_torch.cli_proposals --benchmark coco --nshot 5 --datapath /data \
        --models-path /models --bf16 --out /tmp/props
    python -m mars_tpu_torch.cli --benchmark coco --nshot 5 --datapath /data \
        --models-path /models --gt-class-names --bf16 --mask-proposals-path /tmp/props

With random weights the AMG's default thresholds (predicted IoU > 0.88,
stability >= 0.95) usually reject every mask: an episode then ranks an
empty bucket.  The VLM retriever and the JAX CLI's bookkeeping, text and
quantization flags are not ported yet.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.core.episode import Proposals, pad_proposals
from mars_tpu_torch.data.base import resized_gt, to_device_episode
from mars_tpu_torch.data.registry import build_dataset
from mars_tpu_torch.models import zoo
from mars_tpu_torch.models.precision import cast_floating
from mars_tpu_torch.ops import assignment, flash_attention, sam_attention
from mars_tpu_torch.pipeline import amg, filtering, mars as mars_lib, matcher, vta, vva
from mars_tpu_torch.utils import evaluation

# the hand-written kernels of the main path, by the name their counters carry
# (attention_notap and windowed_attention launch only behind their switches,
# layers.NOTAP_IMPL_ENV and sam.WINDOWED_IMPL_ENV)
KERNELS = {"attention_with_tap": flash_attention.attention_with_tap,
           "attention_notap": flash_attention.attention_notap,
           "grid_attention": sam_attention.grid_attention,
           "windowed_attention": sam_attention.windowed_attention,
           "auction": assignment.auction_assignment}


def kernel_launches() -> dict:
    """Every kernel's launch count so far, by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def launches_since(before: dict) -> dict:
    return {name: n - before[name] for name, n in kernel_launches().items()}


def build_mars_config(args) -> mars_lib.MarsConfig:
    """The reference's tuning flags (main_MARS.py:106-163) on the stage
    configs, as ``mars_tpu.cli.build_mars_config`` maps them: DINOv2 patch
    14, the VTA input ``ceil(size / patch) * patch`` for the CLIP
    backbone's patch."""
    g = args.input_size // 14
    vta_patch = int(args.vta_backbone[-2:])
    vta_in = int(math.ceil(args.input_size / vta_patch) * vta_patch)
    return mars_lib.MarsConfig(
        vva=vva.VVAConfig(refinement_box_threshold=args.vva_refinement_box_threshold,
                          attn_tap_last_n=args.last_n_attn_for_vva_refinement, grid=g),
        vta=vta.VTAConfig(refinement_box_threshold=args.vta_refinement_box_threshold,
                          attn_tap_last_n=args.last_n_attn_for_vta_refinement,
                          input_size=vta_in, grid=vta_in // vta_patch),
        filter_merge=filtering.FilterMergeConfig(alpha=args.alpha_coverage,
                                                 static_threshold=args.static_threshold,
                                                 dynamic_threshold=args.dynamic_threshold,
                                                 grid=g),
    )


def build_model(args, device) -> mars_lib.Mars:
    """The towers of ``args`` (``--dino-backbone``, ``--num-regs``,
    ``--vta-backbone``, AlphaCLIP-L/14@336) from ``--models-path`` or the
    JAX package's weight seeds (0, 1, 2); ``--bf16`` casts DINOv2 and both
    visual towers, not the text towers (``mars_tpu.cli.build_model``)."""
    if args.vva_backbone != "dino":
        # the reference exposes the same choices but its live VVA path only
        # builds DINOv2 (VisualVisualAlignmentModule.py:148-152)
        raise SystemExit("--vva-backbone: only 'dino' is implemented "
                         "(matches the reference's live code path)")
    dino = zoo.build_dinov2(args.models_path, args.dino_backbone, args.num_regs, device=device)
    clip = zoo.build_clip(args.models_path, args.vta_backbone, device=device)
    ac = zoo.build_alpha_clip(args.models_path, device=device)
    if args.bf16:
        dino = (cast_floating(dino[0]), dino[1])
        clip = (cast_floating(clip[0]),) + clip[1:]
        ac = (cast_floating(ac[0]),) + ac[1:]
    return mars_lib.Mars(dino=dino, clip=clip, alpha_clip=ac, cfg=build_mars_config(args),
                         device=device)


def load_proposals(args, idx: int, device) -> Proposals:
    """The precomputed proposal stack ``{fold}_{idx}`` of
    ``--mask-proposals-path`` (the reference's ``torch.load`` of
    ``.pt``, main_MARS.py:62; ``.npy`` and ``.npz`` with key ``masks`` as
    ``cli_proposals`` writes them), every row live, padded to the bucket."""
    base = os.path.join(args.mask_proposals_path, f"{args.fold}_{idx}")
    if os.path.exists(base + ".npy"):
        masks = torch.from_numpy(np.load(base + ".npy").astype(np.float32))
    elif os.path.exists(base + ".npz"):
        with np.load(base + ".npz") as f:
            masks = torch.from_numpy(f["masks"].astype(np.float32))
    elif os.path.exists(base + ".pt"):
        masks = torch.load(base + ".pt", map_location="cpu").float()
    else:
        raise FileNotFoundError(base)
    return pad_proposals(masks.to(device), args.proposal_bucket)


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


def bucket_generated_proposals(out: dict) -> Proposals:
    """The ranking bucket the Matcher compacted in its flow
    (``generate_proposals(bucket=...)``: live rows first, best mask score
    first)."""
    return Proposals(masks=out["bucket_masks"], valid=out["bucket_valid"])


def make_inline_generator(args, dino_bundle, device):
    """Per-episode Matcher proposals inside the eval loop (the reference's
    mask_generator slot, mars/MARS.py:21,46-51), SAM backend, sharing the
    VVA stage's DINOv2 tower.  Returns generate(episode, generator) →
    Proposals."""
    dino_params, dino_cfg = dino_bundle
    mcfg = matcher.MatcherConfig(input_size=args.input_size,
                                 grid=args.input_size // dino_cfg.patch_size,
                                 patch_size=dino_cfg.patch_size)
    sam_params, sam_cfg = zoo.build_sam(args.models_path, args.sam_size, device=device)
    if args.bf16:
        sam_params = cast_floating(sam_params)
    acfg = amg.AmgConfig()

    def generate(ep, generator):
        out = matcher.generate_proposals(
            dino_params, dino_cfg, sam_params, sam_cfg, acfg, mcfg, ep.support_images,
            ep.support_masks, ep.support_valid, ep.query_image, generator=generator,
            bucket=args.proposal_bucket)
        return bucket_generated_proposals(out)

    return generate


def episode_generator(seed: int, idx: int, device) -> torch.Generator:
    """The prompt sampler's per-episode stream (JAX folds idx into its key;
    torch cannot reproduce those draws, only their role)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + idx)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The flags both CLIs share: dataset, checkpoints, DINOv2 backbone
    (``mars_tpu/cli.py:385-535`` and ``mars_tpu/cli_proposals.py``, the same
    spellings and defaults)."""
    p.add_argument("--benchmark", default="synthetic",
                   choices=["coco", "pascal", "pascal5i", "fss", "lvis", "synthetic"])
    p.add_argument("--datapath", default="", help="dataset root (reference --dataset_path)")
    p.add_argument("--models-path", default=None,
                   help="folder of the reference's checkpoints, by their file names "
                        "(models.zoo); a missing file gives seeded random weights")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--input-size", type=int, default=518)
    p.add_argument("--episodes", type=int, default=0, help="0 = full split")
    p.add_argument("--sam-size", default="vit_h", choices=["vit_b", "vit_l", "vit_h"])
    p.add_argument("--dino-backbone", default="vit_large",
                   choices=["vit_small", "vit_base", "vit_large", "vit_giant2"])
    p.add_argument("--num-regs", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda (raises without a card)")


def parse_args(argv=None):
    p = argparse.ArgumentParser("mars_tpu_torch evaluation")
    add_model_args(p)
    p.add_argument("--annotations-datapath", default=None,
                   help="the COCO mask-annotation folder (default "
                        "<datapath>/COCO2014/annotations); --benchmark coco only")
    p.add_argument("--nshot", type=int, default=1, choices=[1, 5])
    p.add_argument("--gt-class-names", action="store_true",
                   help="use dataset class names (required: the VLM is not ported)")
    p.add_argument("--proposal-bucket", type=int, default=128)
    p.add_argument("--generate-proposals", action="store_true",
                   help="run the Matcher per episode instead of synthetic proposals")
    p.add_argument("--mask-proposals-path", default=None,
                   help="rank the proposal dumps {fold}_{idx}.npy/.npz/.pt in this directory")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 tower weights (DINOv2, CLIP and AlphaCLIP visual, SAM)")
    # VTA (reference main_MARS.py:143-146)
    p.add_argument("--vta-backbone", default="ViT-B/16", choices=["ViT-B/16", "ViT-L/14"])
    p.add_argument("--vta-refinement-box-threshold", type=float, default=0.4)
    p.add_argument("--last-n-attn-for-vta-refinement", type=int, default=8)
    # VVA (:148-152)
    p.add_argument("--vva-backbone", default="dino", choices=["dino", "ViT-B/16", "ViT-L/14"])
    p.add_argument("--vva-refinement-box-threshold", type=float, default=0.8)
    p.add_argument("--last-n-attn-for-vva-refinement", type=int, default=24)
    # filtering and merging (:155-157)
    p.add_argument("--static-threshold", type=float, default=0.55)
    p.add_argument("--dynamic-threshold", type=float, default=0.95)
    p.add_argument("--alpha-coverage", type=float, default=0.85)
    return p.parse_args(argv)


def dataset(args):
    """The fold's episodes; ``--annotations-datapath`` only for COCO, as
    the JAX CLI rejects it elsewhere (``mars_tpu/cli.py:551-559``)."""
    kwargs = {}
    if getattr(args, "annotations_datapath", None):
        if args.benchmark != "coco":
            raise SystemExit("--annotations-datapath only applies to "
                             f"--benchmark coco (got {args.benchmark})")
        kwargs["annotations_path"] = args.annotations_datapath
    return build_dataset(args.benchmark, args.datapath, args.fold, "test", args.nshot, args.seed,
                         **kwargs)


def fold_meter(ds) -> evaluation.AverageMeter:
    """The fold's meter.  PASCAL-5i lists its classes 1-indexed and records
    them 0-indexed (reference logger.py:21-23), so its ids shift; the JAX
    CLI passes them unshifted (``mars_tpu/cli.py``, ROADMAP Queue 3)."""
    return evaluation.AverageMeter(ds.benchmark, list(ds.class_ids),
                                   zero_indexed=ds.benchmark != "pascal5i")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    """The most memory allocated on the card since ``_reset_peak``, GiB
    (None off the card)."""
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None


def main(argv=None, keep_masks: bool = False) -> dict:
    """Runs the episode loop; returns {miou, fb_iou, episode_ms (ranking),
    proposal_ms, live_proposals, masks_binary, launches (per kernel, this
    run), episode_launches (per kernel, each episode), episode_peak_gib
    (each episode's peak on the card)}, and with ``keep_masks`` masks (each
    episode's merged mask, bool)."""
    args = parse_args(argv)
    if not args.gt_class_names:
        raise SystemExit("--gt-class-names is required: the VLM retriever is not ported yet")
    if args.mask_proposals_path and not os.path.isdir(args.mask_proposals_path):
        raise SystemExit(f"--mask-proposals-path does not exist: {args.mask_proposals_path}")
    dev = device_lib.resolve(args.device)
    np.random.seed(args.seed)
    ds = dataset(args)
    model = build_model(args, dev)
    generate = (make_inline_generator(args, (model.dino_params, model.dino_cfg), dev)
                if args.generate_proposals else None)
    meter = fold_meter(ds)
    rng = np.random.RandomState(args.seed)
    launches0 = kernel_launches()
    episode_ms, proposal_ms, live, masks, masks_binary = [], [], [], [], True
    episode_launches, episode_peak = [], []
    for idx in range(args.episodes or len(ds)):
        before = kernel_launches()
        _reset_peak(dev)
        rec = ds[idx]
        ep = to_device_episode(rec, args.input_size, args.nshot, dev)
        if generate is not None:
            t0 = time.perf_counter()
            props = generate(ep, episode_generator(args.seed, idx, dev))
            _sync(dev)
            proposal_ms.append((time.perf_counter() - t0) * 1e3)
        elif args.mask_proposals_path:
            props = load_proposals(args, idx, dev)
        else:
            props = synthetic_proposals(rec, args.input_size, args.proposal_bucket, rng, dev)
        t0 = time.perf_counter()
        pred = model.predict(ep, props, class_name=rec.class_name).cpu().numpy()
        episode_ms.append((time.perf_counter() - t0) * 1e3)
        episode_launches.append(launches_since(before))
        episode_peak.append(_peak_gib(dev))
        live.append(int(props.valid.sum()))
        masks_binary &= bool(np.isin(pred, (0.0, 1.0)).all())
        if keep_masks:
            masks.append(pred > 0.5)
        gt, ig = resized_gt(rec, args.input_size)
        meter.update(*evaluation.classify_prediction(pred, gt, ig), rec.class_id)
        miou, _, _ = meter.compute_iou()
        prop = f"proposals {proposal_ms[-1]:.1f} ms, " if generate is not None else ""
        print(f"[{idx + 1}] {rec.class_name}: {prop}ranking {episode_ms[-1]:.1f} ms, "
              f"{live[-1]} live proposals  mIoU {miou:.2f}", flush=True)
    miou, fb, _ = meter.compute_iou()
    print(f"*** mIoU: {miou:.2f}  FB-IoU: {fb:.2f} ***", flush=True)
    res = {"miou": miou, "fb_iou": fb, "episode_ms": episode_ms, "proposal_ms": proposal_ms,
           "live_proposals": live, "masks_binary": masks_binary,
           "launches": launches_since(launches0), "episode_launches": episode_launches,
           "episode_peak_gib": episode_peak}
    if keep_masks:
        res["masks"] = masks
    return res


if __name__ == "__main__":
    main()
