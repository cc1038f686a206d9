"""Episode-parallel evaluation over a ``torch.distributed`` mesh (port of
``mars_tpu/cli_parallel.py``).

The serial driver (``cli``) runs one episode at a time.  This one takes
the fold in batches of ``n_data · local_batch`` episodes: each data rank
runs its ``local_batch`` of them through the batched ranker
(``parallel.runner``: one tower pass over the local stack), the merged
masks are gathered over the data group, and every rank updates the same
meter in episode order.  ``--mesh-model N`` runs the towers (and the VLM)
tensor-parallel over N ranks (``parallel.mesh``).  Proposals are the
synthetic stand-ins, the dumps of ``--mask-proposals-path``, or, with
``--generate-proposals``, each rank's serial Matcher flow
(``cli.make_inline_generator``) over its episodes on the
``cli.episode_generator(seed, idx)`` streams: the serial CLI's buckets.
The class names are the dataset's (``--gt-class-names``) or the VLM's, each
data rank answering its local episodes as one text block.

On one card::

    python -m mars_tpu_torch.cli_parallel --benchmark synthetic --episodes 8 \\
        --gt-class-names --local-batch 4

On N cards of one host (one rank a card, NCCL)::

    torchrun --nproc-per-node N -m mars_tpu_torch.cli_parallel --gt-class-names \\
        --mesh-data N --local-batch 4

The last batch is padded by repeating its last live episode; the pad rows
are not scored.  Only global rank 0 writes files: ``log.txt``,
``scalars.csv``, ``batch_time.csv`` (``batch,seconds``) and
``resume.pkl``, a snapshot at the first batch boundary after every
``--resume-every`` episodes that ``--resume`` continues from (the same
mesh and ``--local-batch``).
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mars_tpu_torch import cli
from mars_tpu_torch import device as device_lib
from mars_tpu_torch.core import imaging
from mars_tpu_torch.core.episode import Episode, live_count, pad_proposals
from mars_tpu_torch.data.base import episode_host_u8, resized_gt
from mars_tpu_torch.parallel import mesh as mesh_lib, runner
from mars_tpu_torch.text import prompts as prompt_data
from mars_tpu_torch.utils import evaluation


def _text_feats(model, class_name: str, cache: dict, class_description: str = ""):
    """The (class, definition)'s VTA pair (2, Dc) and AlphaCLIP text
    (1, Da) on the card, cached: a fold repeats its classes."""
    key = (class_name, class_description)
    if key not in cache:
        cache[key] = (model._vta_text_feats(class_name), model._alpha_clip_text_feats(
            prompt_data.alpha_clip_text(class_name, class_description)))
    return cache[key]


def _stack(arrays, dev) -> torch.Tensor:
    return device_lib.to_device(torch.from_numpy(np.stack(arrays)), dev)


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """The data group's local blocks, concatenated in data order."""
    if mesh.n_data == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def evaluate_parallel(model, ds, mesh, *, input_size: int, nshot: int = 1,
                      episodes: Optional[int] = None, proposal_bucket: int = 128,
                      seed: int = 0, generate=None, props_fn=None, local_batch: int = 1,
                      log=print, metrics_fn=None, meter=None, start_idx: int = 0,
                      snapshot=None, bad_idxs=frozenset(), text_stage=None, masks=None):
    """Runs the fold in batches of ``mesh.n_data · local_batch`` episodes.

    generate: the serial CLI's Matcher flow, ``generate(episode,
    generator) -> Proposals`` (``cli.make_inline_generator``), run on each
    local episode with its ``cli.episode_generator(seed, idx)`` stream;
    otherwise ``props_fn(idx, rec) -> Proposals`` gives a host bucket
    (dumps or synthetic stand-ins).  Every rank calls it for every live
    episode in order, so the host RNG streams stay those of the serial loop
    on every rank.

    text_stage: a ``BlockTextStage``-protocol object over this data rank's
    local episodes (``step`` per episode, then ``flush``), or None for the
    dataset's class names.

    Resume: a restored ``meter`` and a batch-aligned ``start_idx``;
    ``snapshot(next_idx, meter)`` runs after every batch (the host RNG
    streams advance only while a batch is prepared, so its boundary is a
    clean cut).  ``masks``: a list that receives each scored episode's
    merged mask (bool numpy), in order.

    Returns (miou, fb_iou, meter, batch_times).
    """
    dev = mesh.device
    B = mesh.n_data * local_batch
    n = episodes or len(ds)
    if start_idx < n and start_idx % B:
        raise ValueError(f"start_idx {start_idx} is not aligned to the batch size {B}: resume "
                         "with the mesh and local batch the snapshot was taken at")
    if meter is None:
        meter = cli.fold_meter(ds)
    metrics = metrics_fn(meter) if metrics_fn is not None else None

    params = {"dino": model.dino_params, "clip_v": model.clip_v, "ac_v": model.ac_v,
              "logit_scale": model.clip_scale}
    ranker = runner.make_batched_ranker(model.dino_cfg, model.clip_vcfg, model.ac_vcfg,
                                        model.cfg.vva, model.cfg.vta, model.cfg.filter_merge,
                                        mesh=mesh)
    generator = None if generate is None else runner.make_batched_proposal_generator(generate)
    with contextlib.closing(metrics) if metrics is not None else contextlib.nullcontext():
        grid = model.cfg.vva.grid
        lo = mesh.data_index * local_batch
        cache: dict = {}
        batch_times = []
        for b0 in range(start_idx, n, B):
            t0 = time.perf_counter()
            idxs = list(range(b0, min(b0 + B, n)))
            live = len(idxs)
            recs = [ds[idx] for idx in idxs]
            host_props = [props_fn(idx, rec) for idx, rec in zip(idxs, recs)] if generator is None \
                else None
            # this rank's rows of the batch; a pad row repeats the last live episode
            src = [min(k, live - 1) for k in range(lo, lo + local_batch)]
            uniq = sorted(set(src))
            hosts = [episode_host_u8(recs[j], input_size, nshot) for j in uniq]
            with mesh.tensor_parallel():
                if text_stage is not None:
                    pairs = []
                    for sup_i, sup_m, _, sup_v in hosts:
                        ns = int(sup_v.sum())
                        pairs += text_stage.step([sup_i[i] for i in range(ns)],
                                                 [sup_m[i].astype(np.float32) for i in range(ns)])
                    if len(pairs) < len(uniq):
                        pairs += text_stage.flush()
                else:
                    pairs = [(recs[j].class_name, "") for j in uniq]
                texts = [_text_feats(model, name, cache, desc) for name, desc in pairs]
                sup_i = _stack([h[0] for h in hosts], dev).float() / 255.0
                sup_m = _stack([h[1] for h in hosts], dev).float()
                qry = _stack([h[2] for h in hosts], dev).float() / 255.0
                sup_v = _stack([h[3] for h in hosts], dev)
                n_rows = [int((imaging.pooled_footprint_host(h[1], grid)
                               & np.asarray(h[3], bool)[:, None, None]).sum()) for h in hosts]
                if generator is not None:
                    eps = [Episode(sup_i[k], sup_m[k], sup_v[k], qry[k], recs[j].class_id,
                                   support_host=(hosts[k][1], hosts[k][3]))
                           for k, j in enumerate(uniq)]
                    prop_m, prop_v = generator(
                        eps, [cli.episode_generator(seed, idxs[j], dev) for j in uniq])
                    n_valid = None
                else:
                    prop_m = _stack([host_props[j].masks.numpy() for j in uniq], dev)
                    prop_v = _stack([host_props[j].valid.numpy() for j in uniq], dev)
                    n_valid = [live_count(host_props[j]) for j in uniq]
                merged, _ = ranker(params, sup_i, sup_m, sup_v, qry, prop_m, prop_v,
                                   torch.stack([t[0] for t in texts]),
                                   torch.stack([t[1] for t in texts]), n_valid=n_valid,
                                   n_rows=n_rows)
            local = merged[[uniq.index(j) for j in src]] > 0.5
            merged_np = _gather(local.to(torch.uint8), mesh).cpu().numpy()
            for j in range(live):
                idx, rec = idxs[j], recs[j]
                pred = merged_np[j].astype(np.float32)
                if masks is not None:
                    masks.append(pred > 0.5)
                gt, ig = resized_gt(rec, input_size)
                inter, union = evaluation.classify_prediction(pred, gt, ig)
                meter.update(inter, union, rec.class_id)
                if idx in bad_idxs:
                    meter.update_bad_preds(inter, union, rec.class_id)
                if metrics is not None:
                    metrics.log_metrics(idx)
            batch_times.append(time.perf_counter() - t0)
            if metrics is not None:
                metrics.log_time_batch(batch_times[-1], b0 // B)
            if snapshot is not None:
                snapshot(min(b0 + B, n), meter)
            if (b0 // B) % 5 == 0:
                miou, fb, _ = meter.compute_iou()
                log(f"[{min(b0 + B, n)}/{n}] mIoU {miou:.2f}  FB-IoU {fb:.2f}  "
                    f"({live}/{B} live, {batch_times[-1]:.2f}s/batch)")
    miou, fb, _ = meter.compute_iou()
    return miou, fb, meter, batch_times


def parse_args(argv=None):
    p = argparse.ArgumentParser("mars_tpu_torch episode-parallel evaluation")
    cli.add_eval_args(p)
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-axis size (default: all devices / mesh-model)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel axis size for the towers")
    p.add_argument("--local-batch", type=int, default=1,
                   help="episodes per chip per step")
    return p.parse_args(argv)


def _shard_model(model, mesh) -> None:
    """The towers' (and the VLM's) parameters cut to this rank's model index."""
    model.dino_params = mesh_lib.shard_params(model.dino_params, mesh)
    model.clip_v = mesh_lib.shard_params(model.clip_v, mesh)
    model.ac_v = mesh_lib.shard_params(model.ac_v, mesh)
    vlm = getattr(model.retriever, "vlm", None)
    if isinstance(getattr(vlm, "params", None), dict):
        vlm.params = mesh_lib.shard_params(vlm.params, mesh)


def main(argv=None, keep_masks: bool = False) -> dict:
    """Runs the fold on the mesh; returns {miou, fb_iou, batch_times,
    episodes, first_idx, launches (per kernel, this rank's), wall_s,
    log_path, mesh} and with ``keep_masks`` masks (each scored episode's
    merged mask, bool)."""
    from mars_tpu_torch.text import retriever as retriever_lib, wordnet
    from mars_tpu_torch.utils import logging as mlog

    args = parse_args(argv)
    if args.exp_name:
        args.log_path = os.path.join(args.log_path, args.exp_name)
    if args.generate_proposals and args.proposal_model == "semantic-sam":
        raise SystemExit("episode-parallel generation drives the SAM backend; "
                         "semantic-sam stays on the serial cli")
    if args.mask_proposals_path and not os.path.isdir(args.mask_proposals_path):
        raise SystemExit(f"--mask-proposals-path does not exist: {args.mask_proposals_path}")
    mesh = mesh_lib.make_mesh(args.mesh_data, args.mesh_model, device=args.device)
    try:
        dev = mesh.device
        lead = dist.get_rank() == 0
        np.random.seed(args.seed)
        if args.nltk_path:
            wordnet.add_path(args.nltk_path)
        ds = cli.dataset(args)
        model = cli.build_model(args, dev)
        if mesh.n_model > 1:
            _shard_model(model, mesh)
        generate = props_fn = None
        # the proposals' host RNG: only the synthetic path draws from it, but
        # it is snapshotted either way so that --resume restores one state
        rng = np.random.RandomState(args.seed)
        if args.generate_proposals:
            generate = cli.make_inline_generator(args, (model.dino_params, model.dino_cfg), dev)
        elif args.mask_proposals_path:
            def props_fn(idx, rec):
                return pad_proposals(cli.load_proposal_masks(args, idx), args.proposal_bucket)
        else:
            def props_fn(idx, rec):
                return pad_proposals(cli.synthetic_proposal_masks(rec, args.input_size, rng),
                                     args.proposal_bucket)

        logger = None
        if lead:
            os.makedirs(args.log_path, exist_ok=True)
            logger = mlog.initialize(args.log_path, "", args)
            logger.info(f"mesh: {mesh.shape} ({mesh.backend}, {dev})")
        meter = cli.fold_meter(ds)
        resume_path = os.path.join(args.log_path, "resume.pkl")
        start_idx = 0
        if args.resume and os.path.exists(resume_path):
            st = cli.load_resume_state(resume_path, meter, rng, ds)
            start_idx = int(st["next_idx"])
            if lead:
                logger.info(f"resuming from {resume_path} at episode {start_idx}")
        snapshot = None
        if args.resume_every and lead:
            # a snapshot at the first batch boundary at or after every
            # --resume-every episodes: every ceil(N / batch) batches
            batch = mesh.n_data * args.local_batch
            every = -(-args.resume_every // batch)

            def snapshot(next_idx, meter):
                if next_idx % batch == 0 and (next_idx // batch) % every == 0:
                    cli.save_resume_state(resume_path, next_idx, meter, [],
                                          cli.capture_rng_states(rng, ds))
        text_stage = None
        if not args.gt_class_names and model.retriever is not None:
            text_stage = retriever_lib.BlockTextStage(model.retriever, depth=args.local_batch)

        launches0, kept = cli.kernel_launches(), [] if keep_masks else None
        t0 = time.perf_counter()
        metrics_fn = (lambda m: mlog.MetricsLogger(args.log_path, m, append=args.resume)) \
            if lead else None
        miou, fb, meter, batch_times = evaluate_parallel(
            model, ds, mesh, input_size=args.input_size, nshot=args.nshot,
            episodes=args.episodes, proposal_bucket=args.proposal_bucket, seed=args.seed,
            generate=generate, props_fn=props_fn, local_batch=args.local_batch,
            log=logger.info if lead else (lambda *a: None), metrics_fn=metrics_fn, meter=meter,
            start_idx=start_idx, snapshot=snapshot,
            bad_idxs=cli.read_bad_preds(args.bad_preds_path), text_stage=text_stage,
            masks=kept)
        wall = time.perf_counter() - t0
        n = args.episodes or len(ds)
        if lead:
            if os.path.exists(resume_path):
                os.remove(resume_path)  # the run completed; a later --resume starts afresh
            with open(os.path.join(args.log_path, "batch_time.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["batch", "seconds"])
                w.writerows(enumerate(batch_times))
            logger.info(f"mIoU {miou:.2f}  FB-IoU {fb:.2f}  ({n - start_idx} episodes, "
                        f"{wall:.1f}s total, {wall / max(n - start_idx, 1):.3f}s/episode "
                        "amortized)")
            if meter.bad_class_ids:
                bmiou, bfb, _ = meter.compute_iou_bad_preds()
                logger.info(f"*** known-bad subset — mIoU: {bmiou:.2f}  FB-IoU: {bfb:.2f} ***")
            mlog.close(logger)
        out = {"miou": miou, "fb_iou": fb, "batch_times": batch_times, "episodes": n,
               "first_idx": start_idx, "launches": cli.launches_since(launches0),
               "wall_s": wall, "log_path": args.log_path, "mesh": mesh.shape}
        if keep_masks:
            out["masks"] = kept
        return out
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
