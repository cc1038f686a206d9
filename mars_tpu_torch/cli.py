"""Evaluation CLI (port of ``mars_tpu/cli.py``, a subset of its flags).

Per episode of a benchmark fold (``--benchmark``: the reference's COCO-20i,
PASCAL-5i, LVIS-92i and FSS-1000 loaders over ``--datapath``, or
synthetic episodes; ``--nshot`` 1 or 5 support shots): proposals, the class
name and definition, ``Mars.predict`` and the meter update.  The class name
is the dataset's with ``--gt-class-names``; otherwise the text path names
it, as the paper does: the support shots drawn as visual prompts
(``--prompt-type``, ``--color``, ``--zoom-percentage``, the ensemble
flags), ViP-LLaVA-7B on the card (``build_retriever``: ``--vlm-path``,
``--vlm4bit`` / ``--vlm4bit-nf4`` / ``--vlm8bit``, ``--vlm-kv8``, prompt-lookup
speculation of ``--vlm-draft-tokens``) answering the name and a
definition, a vote, and WordNet (``--nltk-path``).  The text stage batches
episodes as the JAX CLI does: ``--text-block D`` (default 4) answers D
episodes' names in one decode and their definitions in another,
``--pipelined-text`` pairs each definition with the next episode's names,
``--text-block 0`` runs each episode alone.
Proposals are synthetic (the ground truth plus six random boxes, as
``mars_tpu.cli.synthetic_proposals`` draws them from the same seed),
loaded from dumps (``--mask-proposals-path``: the reference's evaluation
mode, one ``{fold}_{idx}`` stack per episode as ``cli_proposals`` writes
them) or, with ``--generate-proposals``, the Matcher's (DINOv2 matching
shared with the VVA tower, then the ``--proposal-model`` backend: ``sam``,
SAM ``--sam-size`` @1024 and the AMG, bucketed best mask score first, or
``semantic-sam``, the reference's Matcher_SemanticSAM configuration on the
native network, SwinL @640 with six granularities a prompt set, bucketed
best EMD score first).  Towers are full width: the reference's checkpoints
from ``--models-path`` by their file names (``models.zoo``), seeded random
weights for any file that is not there.  ``--dino-backbone``,
``--num-regs`` and ``--vta-backbone`` pick the towers, and the tuning
flags reach the stage configs as in the JAX CLI.  ``--bf16`` casts the
DINOv2, CLIP visual and AlphaCLIP visual towers (and SAM or Semantic-SAM) to bfloat16, as
the JAX CLI does, the text towers staying float32.  Prints each episode's
proposal and ranking times, its live proposals and the running mIoU.

    python -m mars_tpu_torch.cli --benchmark synthetic --episodes 3 --gt-class-names
    python -m mars_tpu_torch.cli --episodes 2 --gt-class-names --generate-proposals
    python -m mars_tpu_torch.cli --episodes 2 --gt-class-names --generate-proposals \
        --proposal-model semantic-sam
    python -m mars_tpu_torch.cli --episodes 4 --vlm4bit --vlm-path /models/vip-llava-7b-hf \
        --nltk-path /data/nltk_data
    python -m mars_tpu_torch.cli_proposals --benchmark coco --nshot 5 --datapath /data \
        --models-path /models --bf16 --out /tmp/props
    python -m mars_tpu_torch.cli --benchmark coco --nshot 5 --datapath /data \
        --models-path /models --gt-class-names --bf16 --mask-proposals-path /tmp/props

A fold's files land in ``--log-path`` (joined with ``--exp-name`` when
given): ``log.txt`` (the console and the sorted arguments),
``scalars.csv`` and a TensorBoard event file under ``tbd/runs`` (running
mIoU and FB-IoU, each episode's seconds; with ``--bad-preds-path``, a
list of known-bad episode indices, that subset's mIoU), ``ranking_time.csv``
(``idx,total_s,after_text_s,n_proposals``), the ``--visualize N`` figures
``viz/ep{idx:05d}.png``, and ``resume.pkl``, a snapshot of the meter, the
timing rows and the host RNG streams every ``--resume-every`` episodes,
removed when the fold completes: ``--resume`` continues an interrupted
fold from it with the same episodes, draws and results.  One worker thread
prepares episode idx + 1 on the host (the dataset read and resize, the
synthetic draws or the dump read) while idx runs; the copies to the card
stay on the main thread.  ``--overlap-ranking N`` enqueues each episode's
ranking and reads its merged mask up to N episodes later (-1: the text
block's depth, else 2; 0: at once), the same masks in the same order.

``--int8-towers`` stores the DINOv2, CLIP visual and AlphaCLIP visual
kernels as weight-only int8 (after the ``--bf16`` cast), and
``--w8a8-alphaclip`` with it also quantizes AlphaCLIP's activations per row
(int8 × int8 products).  ``--generate-proposals`` runs the Matcher as one
flow over the union of both prompt families, the JAX CLI's default
``--fused-proposals``; ``--no-fused-proposals`` parses and changes nothing
(the JAX package's two-program flow gives the same bucket, and is not
ported: ``pipeline.matcher``).  With ``--proposal-model semantic-sam`` an
explicit ``--fused-proposals`` is refused, as in the JAX CLI.

With random weights the AMG's default thresholds (predicted IoU > 0.88,
stability >= 0.95) usually reject every mask: an episode then ranks an
empty bucket.  Without ``--gt-class-names``, ``--vlm-path`` names a
ViP-LLaVA directory in transformers' format (``build_retriever``).
"""
from __future__ import annotations

import argparse
import csv
import math
import os
import pickle
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.core.episode import Proposals, live_count, pad_proposals
from mars_tpu_torch.data.base import (episode_from_host, episode_host_u8, resized_gt,
                                      to_device_episode)
from mars_tpu_torch.data.registry import build_dataset
from mars_tpu_torch.models import zoo
from mars_tpu_torch.models.precision import cast_floating
from mars_tpu_torch.models.quantization import quantize_params
from mars_tpu_torch.models import vip_llava
from mars_tpu_torch.ops import assignment, flash_attention, int4_matmul, sam_attention
from mars_tpu_torch.pipeline import (amg, filtering, mars as mars_lib, matcher, matcher_oss,
                                     vta, vva)
from mars_tpu_torch.text import retriever as retriever_lib, wordnet
from mars_tpu_torch.utils import evaluation, logging as mlog, visualize

# the hand-written kernels of the main path, by the name their counters carry
# (attention_notap and windowed_attention launch only behind their switches,
# layers.NOTAP_IMPL_ENV and sam.WINDOWED_IMPL_ENV)
KERNELS = {"attention_with_tap": flash_attention.attention_with_tap,
           "attention_notap": flash_attention.attention_notap,
           "grid_attention": sam_attention.grid_attention,
           "windowed_attention": sam_attention.windowed_attention,
           "auction": assignment.auction_assignment}


# the text path's kernels (the VLM's dense layers)
TEXT_KERNELS = {"matmul_int4": int4_matmul.matmul_int4, "matmul_nf4": int4_matmul.matmul_nf4}


def kernel_launches() -> dict:
    """Every kernel's launch count so far, by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def text_counts() -> dict:
    """The text path's counts so far: the 4-bit kernels' launches, and the
    VLM's vision calls, LLaMA forwards and speculative rounds."""
    return {**{name: fn.launches for name, fn in TEXT_KERNELS.items()}, **vip_llava.STATS}


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


def retriever_configs(args):
    """The prompt flags as (PromptGenConfig, EnsembleConfig)."""
    gen_cfg = retriever_lib.PromptGenConfig(
        prompt_type=args.prompt_type, color=args.color, alpha=args.alpha_blending,
        thickness=args.thickness, zoom_percent=args.zoom_percentage)
    ensemble = retriever_lib.EnsembleConfig(
        colors=tuple(args.ensemble_colors_list) if args.ensemble_colors else (),
        zooms=tuple(args.ensemble_zoom_list) if args.ensemble_zoom else (),
        prompt_types=tuple(args.ensemble_prompts_list) if args.ensemble_prompts else ())
    return gen_cfg, ensemble


def build_retriever(args) -> retriever_lib.TextRetriever:
    """The text path of ``args`` (``mars_tpu.cli.build_retriever``):
    ViP-LLaVA-7B from ``--vlm-path`` in bfloat16, its dense kernels 4-bit
    (``--vlm4bit``, NF4 with ``--vlm4bit-nf4``) or else 8-bit, prompt-lookup
    speculation of ``--vlm-draft-tokens``, the int8 KV cache with
    ``--vlm-kv8``; the visual prompts and ensembles of the prompt flags
    (``main`` puts ``--nltk-path`` on WordNet's search path).
    ``--vlm-path`` is a ViP-LLaVA directory in transformers' format (the
    release ``llava-hf/vip-llava-7b-hf``): ``TorchVipLlava`` reads its
    weights onto ``--device`` one tensor at a time and its processor (the
    LLaMA tokenizer, CLIP's image processor), and raises FileNotFoundError
    naming the files missing there.  ``--jax-vlm`` picks JAX's own decoder
    there, whose counterpart this is: it changes nothing here."""
    bits = 4 if args.vlm4bit else (8 if args.vlm8bit else None)
    vlm = retriever_lib.TorchVipLlava(
        args.vlm_path, dtype=torch.bfloat16, quantize_bits=bits or 8,
        int4_format="nf4" if args.vlm4bit_nf4 else "affine",
        draft_tokens=args.vlm_draft_tokens, kv_bits=8 if args.vlm_kv8 else None,
        device=args.device)
    gen_cfg, ensemble = retriever_configs(args)
    return retriever_lib.TextRetriever(vlm, gen_cfg=gen_cfg, ensemble=ensemble)


def build_model(args, device) -> mars_lib.Mars:
    """The towers of ``args`` (``--dino-backbone``, ``--num-regs``,
    ``--vta-backbone``, AlphaCLIP-L/14@336) from ``--models-path`` or the
    JAX package's weight seeds (0, 1, 2); ``--bf16`` casts DINOv2 and both
    visual towers, not the text towers, then ``--int8-towers`` quantizes
    their kernels to int8, AlphaCLIP's W8A8 with ``--w8a8-alphaclip``
    (``mars_tpu.cli.build_model``); the retriever unless
    ``--gt-class-names``."""
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
    if args.int8_towers:
        dino = (quantize_params(dino[0]), dino[1])
        clip = (quantize_params(clip[0]),) + clip[1:]
        ac = (quantize_params(ac[0], act_bits=8 if args.w8a8_alphaclip else None),) + ac[1:]
    retriever = None if args.gt_class_names else build_retriever(args)
    return mars_lib.Mars(dino=dino, clip=clip, alpha_clip=ac, cfg=build_mars_config(args),
                         device=device, retriever=retriever)


def load_proposal_masks(args, idx: int) -> torch.Tensor:
    """The precomputed proposal stack ``{fold}_{idx}`` of
    ``--mask-proposals-path`` on the host, float32 (the reference's
    ``torch.load`` of ``.pt``, main_MARS.py:62; ``.npy`` and ``.npz`` with
    key ``masks`` as ``cli_proposals`` writes them)."""
    base = os.path.join(args.mask_proposals_path, f"{args.fold}_{idx}")
    if os.path.exists(base + ".npy"):
        return torch.from_numpy(np.load(base + ".npy").astype(np.float32))
    if os.path.exists(base + ".npz"):
        with np.load(base + ".npz") as f:
            return torch.from_numpy(f["masks"].astype(np.float32))
    if os.path.exists(base + ".pt"):
        return torch.load(base + ".pt", map_location="cpu").float()
    raise FileNotFoundError(base)


def load_proposals(args, idx: int, device) -> Proposals:
    """``load_proposal_masks`` on ``device``, every row live, padded to the
    bucket."""
    return pad_proposals(load_proposal_masks(args, idx).to(device), args.proposal_bucket)


def synthetic_proposal_masks(rec, size: int, rng: np.random.RandomState) -> torch.Tensor:
    """Ground truth + six random boxes on the host (the JAX CLI's draws
    from ``rng``)."""
    gt, _ = resized_gt(rec, size)
    props = [gt]
    for _ in range(6):
        y, x = rng.randint(0, size - 64, 2)
        m = np.zeros_like(gt)
        m[y: y + rng.randint(32, 128), x: x + rng.randint(32, 128)] = 1
        props.append(m)
    return torch.from_numpy(np.stack(props))


def synthetic_proposals(rec, size: int, bucket: int, rng: np.random.RandomState,
                        device) -> Proposals:
    """Ground truth + six random boxes, padded to the bucket."""
    return pad_proposals(synthetic_proposal_masks(rec, size, rng).to(device), bucket)


def bucket_generated_proposals(out: dict) -> Proposals:
    """The ranking bucket the Matcher compacted in its flow
    (``generate_proposals(bucket=...)``: live rows first, best mask score
    first)."""
    return Proposals(masks=out["bucket_masks"], valid=out["bucket_valid"])


def make_inline_generator(args, dino_bundle, device):
    """Per-episode Matcher proposals inside the eval loop (the reference's
    mask_generator slot, mars/MARS.py:21,46-51), sharing the VVA stage's
    DINOv2 tower.  ``--proposal-model``: ``sam`` (``matcher.generate_proposals``,
    SAM ``--sam-size`` and the AMG) or ``semantic-sam``
    (``matcher_oss.generate_proposals_oss`` on the native Semantic-SAM, the
    reference's Matcher_SemanticSAM.py:151-161; ``mars_tpu/cli.py:242-263``).
    Returns generate(episode, generator) → Proposals."""
    dino_params, dino_cfg = dino_bundle
    mcfg = matcher.MatcherConfig(input_size=args.input_size,
                                 grid=args.input_size // dino_cfg.patch_size,
                                 patch_size=dino_cfg.patch_size)
    if args.proposal_model == "semantic-sam":
        if getattr(args, "fused_proposals", None):  # None: the default; only an explicit ask
            raise SystemExit("--fused-proposals applies to the SAM backend only "
                             "(matcher_oss has its own program flow)")
        ss_params, ss_cfg = zoo.build_semantic_sam(args.models_path, device=device)
        if args.bf16:
            ss_params = cast_floating(ss_params)
        backend = matcher_oss.SemanticSamBackend(ss_params, ss_cfg)

        def generate_oss(ep, generator):
            out = matcher_oss.generate_proposals_oss(
                dino_params, dino_cfg, backend, mcfg, ep.support_images, ep.support_masks,
                ep.support_valid, ep.query_image, generator=generator,
                bucket=args.proposal_bucket)
            return bucket_generated_proposals(out)

        return generate_oss
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


def dump_visualization(model, args, idx, rec, host, ep, props, name, desc) -> str:
    """The reference's --visualize figure of one episode
    (``viz/ep{idx:05d}.png`` under ``--log-path``: the priors, the top
    proposals with their scores, the merged mask against the ground truth;
    reference Matcher.py:230-231,872-1037), from ``Mars.predict_debug``,
    one extra ranking run that leaves the meter as it is."""
    out = model.predict_debug(ep, props, class_name=name, class_description=desc)
    sup_i, sup_m, qry_u8, sup_v = host
    gt, _ = resized_gt(rec, args.input_size)
    return visualize.plot_episode(
        os.path.join(args.log_path, "viz", f"ep{idx:05d}.png"), query_img=qry_u8,
        support_img=sup_i[0] if sup_v[0] else None, support_mask=sup_m[0] if sup_v[0] else None,
        vva=out["vva_prior"], vta=out["vta_prior"], proposals=props.masks.cpu().numpy(),
        proposal_valid=props.valid.cpu().numpy(), scores=out["scores"], merged=out["merged"],
        gt=gt, title=f"episode {idx} - {name or rec.class_name}")


def capture_rng_states(rng, ds=None) -> dict:
    """The host RNG streams at an episode boundary.  Taken before the next
    episode's prefetch is submitted: the prefetch draws the synthetic
    proposals from ``rng`` and the dataset samples episodes from its own
    (COCO, FSS, LVIS draw per ``__getitem__``, as the reference does)."""
    return {"rng_state": rng.get_state(),
            "ds_rng_state": ds.rng.get_state() if ds is not None and hasattr(ds, "rng") else None}


def save_resume_state(path, next_idx, meter, timing_rows, rng_states) -> None:
    """Atomic snapshot (a temporary file, then ``os.replace``) of what the
    loop accumulates: the meter's histograms, the timing rows and the RNG
    states of ``capture_rng_states`` (the JAX CLI's keys).  The proposal
    sampler's per-episode generator (``episode_generator``) is stateless,
    so it needs none."""
    state = {"next_idx": next_idx, "inter": meter.inter, "union": meter.union,
             "inter_bad": meter.inter_bad, "union_bad": meter.union_bad,
             "bad_class_ids": list(meter.bad_class_ids), "timing_rows": timing_rows,
             **rng_states}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def load_resume_state(path, meter, rng, ds=None) -> dict:
    """Restores a ``save_resume_state`` snapshot; returns its dict."""
    with open(path, "rb") as f:
        st = pickle.load(f)
    meter.inter[:], meter.union[:] = st["inter"], st["union"]
    meter.inter_bad[:], meter.union_bad[:] = st["inter_bad"], st["union_bad"]
    meter.bad_class_ids = list(st["bad_class_ids"])
    rng.set_state(st["rng_state"])
    if st.get("ds_rng_state") is not None and ds is not None and hasattr(ds, "rng"):
        ds.rng.set_state(st["ds_rng_state"])
    return st


def read_bad_preds(path) -> set:
    """The known-bad episode indices of ``--bad-preds-path`` (whitespace
    separated; reference datasets/COCO2014/fold{f}_badPredsIdxs.txt); an
    empty set when the file is not there, as in the JAX CLI."""
    if not path or not os.path.exists(path):
        return set()
    with open(path) as f:
        return {int(x) for x in f.read().split() if x.strip()}


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
    add_eval_args(p)
    return p.parse_args(argv)


def add_eval_args(p: argparse.ArgumentParser) -> None:
    """The evaluation flags, which ``cli_parallel`` shares
    (``mars_tpu.cli.add_eval_args``)."""
    add_model_args(p)
    p.add_argument("--annotations-datapath", default=None,
                   help="the COCO mask-annotation folder (default "
                        "<datapath>/COCO2014/annotations); --benchmark coco only")
    p.add_argument("--nshot", type=int, default=1, choices=[1, 5])
    p.add_argument("--nltk-path", default=None,
                   help="extra NLTK data dir for WordNet (reference --nltk_path)")
    p.add_argument("--gt-class-names", action="store_true",
                   help="use dataset class names instead of the VLM")
    p.add_argument("--proposal-bucket", type=int, default=128)
    p.add_argument("--generate-proposals", action="store_true",
                   help="run the Matcher per episode instead of synthetic proposals")
    p.add_argument("--proposal-model", default="sam", choices=["sam", "semantic-sam"],
                   help="Matcher backend: SAM (reference Matcher.py) or the native "
                        "Semantic-SAM network (the reference's Matcher_SemanticSAM "
                        "configuration)")
    p.add_argument("--fused-proposals", action=argparse.BooleanOptionalAction, default=None,
                   help="single-flow proposal generation (union-family rows; the same "
                        "bucket, no host read of the prompt count).  The port always runs "
                        "it: --no-fused-proposals is accepted and has no effect")
    p.add_argument("--mask-proposals-path", default=None,
                   help="rank the proposal dumps {fold}_{idx}.npy/.npz/.pt in this directory")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 tower weights (DINOv2, CLIP and AlphaCLIP visual, SAM or "
                        "Semantic-SAM)")
    p.add_argument("--int8-towers", action="store_true",
                   help="weight-only int8 tower kernels (combine with --bf16)")
    p.add_argument("--w8a8-alphaclip", action="store_true",
                   help="with --int8-towers: dynamic int8 activations on the AlphaCLIP tower "
                        "too (int8 x int8 products: the compute-bound ranking stage)")
    # text retrieval and visual prompting (reference main_MARS.py:127-141)
    p.add_argument("--prompt-type", default="contour", choices=["mask", "bb", "contour", "ellipse"])
    p.add_argument("--zoom-percentage", type=int, default=50)
    p.add_argument("--color", default="red", choices=["red", "green", "blue"])
    p.add_argument("--alpha-blending", type=float, default=0.5)
    p.add_argument("--thickness", type=int, default=2)
    p.add_argument("--ensemble-prompts", action="store_true",
                   help="vote over several prompt types per shot")
    p.add_argument("--ensemble-prompts-list", nargs="+", default=["bb", "contour", "ellipse"])
    p.add_argument("--ensemble-zoom", action="store_true")
    p.add_argument("--ensemble-zoom-list", type=int, nargs="+", default=[0, 30, 50])
    p.add_argument("--ensemble-colors", action="store_true")
    p.add_argument("--ensemble-colors-list", nargs="+", default=["red", "green", "blue"])
    p.add_argument("--vlm4bit", action="store_true", help="4-bit weight-only VLM")
    p.add_argument("--vlm4bit-nf4", action="store_true",
                   help="with --vlm4bit: the NF4 codebook (the reference's load_in_4bit "
                        "numerics) instead of hybrid int4")
    p.add_argument("--vlm8bit", action="store_true", help="8-bit weight-only VLM")
    p.add_argument("--vlm-kv8", action="store_true",
                   help="int8 KV cache (per-token per-head scales)")
    p.add_argument("--vlm-draft-tokens", type=int, default=8,
                   help="prompt-lookup speculative decode width (exact greedy; 0 disables)")
    p.add_argument("--pipelined-text", action="store_true",
                   help="decode episode N's definition with episode N+1's name queries")
    p.add_argument("--text-block", type=int, default=-1, metavar="D",
                   help="answer D episodes' names in one decode and their definitions in "
                        "another (default 4 unless --pipelined-text; 0/1: one episode at a "
                        "time)")
    p.add_argument("--vlm-path", default="llava-hf/vip-llava-7b-hf")
    p.add_argument("--jax-vlm", action="store_true",
                   help="accepted for the JAX CLI's spelling: the VLM always runs on the card")
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
    p.add_argument("--overlap-ranking", type=int, default=-1, metavar="N",
                   help="read each episode's merged mask up to N episodes after its ranking "
                        "was enqueued (the same masks, in order); -1: the text block's "
                        "depth, else 2; 0: at once")
    # logging (reference :160-161)
    p.add_argument("--log-path", default="output", help="reference --log_root_path")
    p.add_argument("--exp-name", default=None)
    p.add_argument("--visualize", type=int, default=0, metavar="N",
                   help="internal-state figures (VVA/VTA priors, top proposals with their "
                        "scores, merged mask and ground truth) of the first N episodes in "
                        "<log-path>/viz")
    p.add_argument("--bad-preds-path", default=None,
                   help="per-fold known-bad episode index list (one idx per line, reference "
                        "datasets/COCO2014/fold{f}_badPredsIdxs.txt)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from <log-path>/resume.pkl (the meter, "
                        "the timing rows and every host RNG stream)")
    p.add_argument("--resume-every", type=int, default=20,
                   help="episodes between resume snapshots (0 disables)")


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
    CLI passes them unshifted (``mars_tpu/cli.py``; ROADMAP, the faults
    found against the reference: the PASCAL-5i meter)."""
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


def text_stage(args, model):
    """The JAX CLI's text stage (``mars_tpu/cli.py:617-640``):
    ``BlockTextStage`` at ``--text-block`` (default 4 unless
    ``--pipelined-text``), else ``PipelinedTextStage`` with
    ``--pipelined-text``, else None (each episode named alone)."""
    if args.gt_class_names or model.retriever is None:
        return None
    block = args.text_block
    if block < 0:
        block = 0 if args.pipelined_text else 4
    if block > 1:
        return retriever_lib.BlockTextStage(model.retriever, depth=block)
    if args.pipelined_text:
        return retriever_lib.PipelinedTextStage(model.retriever)
    return None


def overlap_depth(args, stage, model) -> int:
    """``--overlap-ranking``: -1 → the text block's depth, else 2; 0 when
    the model has no ``predict_launch``."""
    overlap = args.overlap_ranking
    if overlap < 0:
        overlap = getattr(stage, "depth", 2) if stage is not None else 2
    return overlap if hasattr(model, "predict_launch") else 0


def main(argv=None, keep_masks: bool = False) -> dict:
    """Runs the episode loop; returns {miou, fb_iou, episode_ms (ranking),
    text_ms (each episode's share of the text stage, 0 with
    ``--gt-class-names``), names, descriptions, proposal_ms, live_proposals,
    masks_binary, launches (per kernel, this run), episode_launches (per
    kernel, each episode's proposals and ranking), episode_peak_gib (each
    episode's peak on the card over its proposals and ranking), text_counts
    (the text path's counts over the run, ``text_counts()``), first_idx
    (the first episode this run ran: > 0 after ``--resume``), wall_s (the
    loop's wall time), log_path}, and with ``keep_masks`` masks (each
    episode's merged mask, bool).  The per-episode lists cover this run's
    episodes; ``ranking_time.csv`` covers the fold.

    With a text stage an episode's ranking runs when its class name is
    known, up to the stage's depth later; with ``--overlap-ranking`` its
    mask is read up to N episodes after that; episodes still finish in
    order.  The text span of a step is shared evenly by the episodes it
    completes, and a buffering step's span rides with its episode."""
    args = parse_args(argv)
    if args.exp_name:
        args.log_path = os.path.join(args.log_path, args.exp_name)
    if args.mask_proposals_path and not os.path.isdir(args.mask_proposals_path):
        raise SystemExit(f"--mask-proposals-path does not exist: {args.mask_proposals_path}")
    dev = device_lib.resolve(args.device)
    np.random.seed(args.seed)
    if args.nltk_path:
        wordnet.add_path(args.nltk_path)
    ds = dataset(args)
    model = build_model(args, dev)
    generate = (make_inline_generator(args, (model.dino_params, model.dino_cfg), dev)
                if args.generate_proposals else None)
    stage = text_stage(args, model)
    overlap = overlap_depth(args, stage, model)
    meter = fold_meter(ds)
    os.makedirs(args.log_path, exist_ok=True)
    # log.txt + console + the arguments (reference Logger.initialize:172-209)
    logger = mlog.initialize(args.log_path, "", args)
    metrics = mlog.MetricsLogger(args.log_path, meter, append=args.resume)
    rng = np.random.RandomState(args.seed)
    bad_idxs = read_bad_preds(args.bad_preds_path)
    n = args.episodes or len(ds)
    resume_path = os.path.join(args.log_path, "resume.pkl")
    start_idx, timing_rows = 0, []
    if args.resume and os.path.exists(resume_path):
        st = load_resume_state(resume_path, meter, rng, ds)
        start_idx, timing_rows = int(st["next_idx"]), list(st["timing_rows"])
        logger.info(f"resuming from {resume_path} at episode {start_idx}")
    launches0, text0 = kernel_launches(), text_counts()
    out = {"episode_ms": [], "text_ms": [], "names": [], "descriptions": [], "proposal_ms": [],
           "live_proposals": [], "episode_launches": [], "episode_peak_gib": []}
    masks, masks_binary = [], True
    pending = deque()  # episodes awaiting a class name: dicts, see below
    completions = deque()  # (episode, merged mask on the device) awaiting the read

    def host_prep(idx):
        # host work only, on the one worker: the FIFO keeps the dataset's and
        # the synthetic proposals' draw order of a serial loop
        rec = ds[idx]
        host = episode_host_u8(rec, args.input_size, args.nshot)
        if generate is not None:
            prop_masks = None  # the Matcher's, on the main thread (it shares the card)
        elif args.mask_proposals_path:
            prop_masks = load_proposal_masks(args, idx)
        else:
            prop_masks = synthetic_proposal_masks(rec, args.input_size, rng)
        return rec, host, prop_masks

    def score(e, pred, total_s, after_s):
        nonlocal masks_binary
        idx, rec = e["idx"], e["rec"]
        out["episode_ms"].append(after_s * 1e3)
        out["text_ms"].append(e["text_s"] * 1e3)
        out["names"].append(e["name"])
        out["descriptions"].append(e["desc"])
        out["episode_launches"].append(e["launches"])
        peaks = [g for g in (e["peak"], _peak_gib(dev)) if g is not None]
        out["episode_peak_gib"].append(max(peaks) if peaks else None)
        live = live_count(e["props"])
        out["live_proposals"].append(live)
        masks_binary &= bool(np.isin(pred, (0.0, 1.0)).all())
        if keep_masks:
            masks.append(pred > 0.5)
        gt, ig = resized_gt(rec, args.input_size)
        inter, union = evaluation.classify_prediction(pred, gt, ig)
        meter.update(inter, union, rec.class_id)
        if idx in bad_idxs:
            meter.update_bad_preds(inter, union, rec.class_id)
        timing_rows.append([idx, total_s, after_s, live])
        metrics.log_metrics(idx)
        metrics.log_time_batch(total_s, idx)
        miou, _, _ = meter.compute_iou()
        prop = f"proposals {e['proposal_ms']:.1f} ms, " if generate is not None else ""
        text = f"text {e['text_s'] * 1e3:.1f} ms, " if model.retriever is not None else ""
        logger.info(f"[{idx + 1}/{n}] {e['name']}: {prop}{text}ranking {after_s * 1e3:.1f} ms, "
                    f"{live} live proposals  mIoU {miou:.2f}")
        if e["snap"] is not None:
            # saved once the episode is scored, so --resume replays from an
            # exact boundary though the text stage and the window ran ahead
            save_resume_state(resume_path, idx + 1, meter, timing_rows, e["snap"])

    def complete_one():
        e, merged = completions.popleft()
        t0 = time.perf_counter()
        pred = merged.cpu().numpy()
        span = e["launch_s"] + time.perf_counter() - t0
        score(e, pred, span + e["text_s"], span)

    def finish(e, name, desc):
        e["name"], e["desc"] = name, desc
        ep, props = e["ep"], e["props"]
        if e["idx"] < args.visualize:
            dump_visualization(model, args, e["idx"], e["rec"], e["host"], ep, props, name, desc)
        before, t0 = kernel_launches(), time.perf_counter()
        if overlap:
            merged = model.predict_launch(ep, props, name, desc)
            e["launch_s"] = time.perf_counter() - t0
        else:
            merged = model.predict(ep, props, class_name=name, class_description=desc)
        e["launches"] = {k: c + e["launches"][k] for k, c in launches_since(before).items()}
        if not overlap:
            score(e, merged.cpu().numpy(), model.timings["total"] + e["text_s"],
                  model.timings["after_text_extraction"])
            return
        completions.append((e, merged))
        while len(completions) > overlap:
            complete_one()

    def drain(results, span):
        for name, desc in results:
            e = pending.popleft()
            e["text_s"] += span / len(results)
            finish(e, name, desc)

    pool = ThreadPoolExecutor(max_workers=1)
    t_start = time.perf_counter()
    try:
        fut = pool.submit(host_prep, start_idx) if n > start_idx else None
        for idx in range(start_idx, n):
            rec, host, prop_masks = fut.result()
            # the RNG states at the episode boundary, before the prefetch of
            # idx + 1 draws from them
            snap = (capture_rng_states(rng, ds)
                    if args.resume_every and (idx + 1) % args.resume_every == 0 else None)
            if idx + 1 < n:
                fut = pool.submit(host_prep, idx + 1)
            before = kernel_launches()
            _reset_peak(dev)
            ep = episode_from_host(host, int(rec.class_id), dev)
            e = {"idx": idx, "rec": rec, "host": host, "ep": ep, "text_s": 0.0,
                 "snap": snap, "proposal_ms": None}
            if generate is not None:
                t0 = time.perf_counter()
                e["props"] = generate(ep, episode_generator(args.seed, idx, dev))
                _sync(dev)
                e["proposal_ms"] = (time.perf_counter() - t0) * 1e3
                out["proposal_ms"].append(e["proposal_ms"])
            else:
                e["props"] = pad_proposals(device_lib.to_device(prop_masks, dev),
                                           args.proposal_bucket)
            e["launches"], e["peak"] = launches_since(before), _peak_gib(dev)
            t0 = time.perf_counter()
            if stage is None:
                if args.gt_class_names:
                    name, desc = rec.class_name, ""
                else:
                    name, desc = model.conceptual_information(ep)
                    e["text_s"] = time.perf_counter() - t0
                finish(e, name, desc)
                continue
            res = stage.step(*model.support_host_arrays(ep))
            results = res if isinstance(res, list) else ([] if res is None else [res])
            span = time.perf_counter() - t0
            pending.append(e)
            if results:
                drain(results, span)
            else:
                e["text_s"] += span  # a buffering step: its span rides with this episode
        while pending:
            t0 = time.perf_counter()
            res = stage.flush()
            results = res if isinstance(res, list) else ([] if res is None else [res])
            if not results:
                raise RuntimeError(f"text stage flush returned no results with {len(pending)} "
                                   "episodes pending")
            drain(results, time.perf_counter() - t0)
        while completions:
            complete_one()
        wall_s = time.perf_counter() - t_start

        if os.path.exists(resume_path):
            os.remove(resume_path)  # the run completed; a later --resume starts afresh
        with open(os.path.join(args.log_path, "ranking_time.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["idx", "total_s", "after_text_s", "n_proposals"])
            w.writerows(timing_rows)
        now = text_counts()
        out.update(launches=launches_since(launches0), masks_binary=masks_binary,
                   text_counts={k: c - text0[k] for k, c in now.items()}, first_idx=start_idx,
                   wall_s=wall_s, log_path=args.log_path)
        if keep_masks:
            out["masks"] = masks
        if n <= start_idx:
            # nothing ran (--episodes resolved to 0, or --resume of a completed
            # run): an empty meter would log NaN rows
            logger.info("no episodes to run")
            out.update(miou=0.0, fb_iou=0.0)
            return out
        miou, fb, _ = meter.compute_iou()
        avg_t = float(np.mean([r[1] for r in timing_rows]))
        logger.info(f"\n*** mIoU: {miou:.2f}  FB-IoU: {fb:.2f}  avg time/img: {avg_t:.3f}s ***")
        if meter.bad_class_ids:
            bmiou, bfb, _ = meter.compute_iou_bad_preds()
            logger.info(f"*** known-bad subset — mIoU: {bmiou:.2f}  FB-IoU: {bfb:.2f} ***")
            metrics.log_metrics_bad_preds(n - 1)
        metrics.end(time.perf_counter() - t_start, n - 1)
        out.update(miou=miou, fb_iou=fb)
        return out
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        metrics.close()
        mlog.close(logger)


if __name__ == "__main__":
    main()
