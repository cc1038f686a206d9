#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mars_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the kernel build (one
     nvcc per source, all started together): ptxas' registers and spill
     stores, and each library's tensor-core instructions in its SASS
     (``cuobjdump -sass``: HGMMA for wgmma, HMMA for mma.sync); fails if a
     bfloat16 attention or 4-bit GEMM kernel, or a float32 tap, grid, notap
     or windowed kernel (split TF32), has none, or if one of their libraries
     spills;
  2. ``attention_with_tap`` against its plain version at the ranking path's
     shapes, in float32 and bfloat16, rerun for bitwise equality, timed with
     CUDA events beside its bound (float32: split TF32's three passes, and
     the CUDA cores' bound) and a PyTorch yardstick;
  3. ``grid_attention`` the same way at SAM ViT-H's and ViT-B's
     global-layer shapes and a ragged grid (float32 beside its split-TF32
     bound and its CUDA-core one);
  4. ``auction`` against its plain version, bit-exact, and rerun for
     bitwise equality, on the five test instances, a dense contested one
     (1369², every row valid, five phases) and the full-width forward and
     reverse matching instances of synthetic episode 0, with the round
     counts and microseconds a round;
  5. the tiny golden ranking episode (tests/fixtures) on the card: merged
     mask equal to the fixture;
  6. the tiny golden Matcher episode on the card: the fixture's content
     checks;
  7. the ranking path at full width: ``mars_tpu_torch.cli.main`` over three
     synthetic episodes with synthetic proposals (DINOv2-L/14 reg4 @518,
     CLIP-B/16 @528, AlphaCLIP-L/14@336, seeded random weights, bucket
     128), the kernels' launch counts read around it; the same three
     episodes with ``attention_with_tap_plain`` in the tap kernel's place,
     each merged mask matched to the kernel's at IoU >= 0.99 (the bitwise
     equal ones counted); then the same three episodes with
     MARS_ATTENTION_NOTAP_IMPL=pallas alone (the float32
     towers' untapped blocks on ``notap_f32``): its launches exactly 28 + 24
     per live AlphaCLIP chunk an episode, each merged mask matched to the
     plain route's at IoU >= 0.99;
  8. the proposal path at full width: ``cli.main --generate-proposals`` over
     two episodes (the Matcher on DINOv2-L and SAM ViT-H @1024, then the
     ranking), launch counts read around it;
  9. one full-width ``matcher.generate_proposals`` with zero selection
     thresholds, so decode, NMS, EMD scoring and the bucket see live masks;
     then the same call with ``grid_attention_plain`` in the float32 grid
     kernel's place: the ViT-H embeddings' difference, the proposals equal
     in count and matched at IoU >= 0.99; then the same call with
     MARS_SAM_WINDOWED_IMPL=pallas alone (ViT-H's 28 windowed layers on the
     float32 windowed kernel, the grid kernel on in both runs): exactly 28
     windowed and 4 grid launches, the embedding's difference from the
     switch-off run, the proposals equal in count and matched at IoU >= 0.99;
 10. one ranking episode (switch off, then MARS_ATTENTION_NOTAP_IMPL=pallas:
     the float32 notap kernel's device time and launches beside the plain
     route's; the tap kernels' device time and launches in both), then one
     proposal-plus-ranking episode (switch off, then
     MARS_SAM_WINDOWED_IMPL=pallas: the float32 windowed kernel's), under
     torch.profiler: device time by stage and by kernel, idle share;
 11. ``matmul_int4`` and ``matmul_nf4`` against their plain versions at the
     7B's shapes (decode rows 1, 4 and 8, prefill rows ~2330, and on a
     LLaMA layer's three shapes a speculative verify's rows 9, 18, 36 and
     72) and a
     ragged one, in bfloat16, rerun for bitwise equality, beside their bound and
     cuBLAS on the dense weight; decode rows also timed with the device
     held while the calls are enqueued, warm and cold (the calls rotate
     through >= 100 MB of weight copies, twice the L2), kernel and cuBLAS;
 12. the text path at full width: ViP-LLaVA-7B (seeded random weights,
     hybrid int4, then NF4) answering one BlockTextStage-shaped block
     through ``TorchVipLlava.generate_batch`` (4 name rows, then 4
     definition rows on the same images), the 4-bit kernels' launches
     checked against the count the decode's token trace implies; the
     first forward's logits, kernel path against plain path;
 13. one int4 text block under torch.profiler;
 14. ``attention_notap`` against its plain version at the untapped blocks'
     shapes (AlphaCLIP-L chunk, DINOv2-L, CLIP-B, five DINOv2-L supports)
     and at head dim 128, float32 and bfloat16, rerun for bitwise equality,
     beside its bound (float32: split TF32's three passes, and the CUDA
     cores' bound) and F.scaled_dot_product_attention;
 15. ``windowed_attention`` the same way at SAM ViT-H's and ViT-B's windowed
     layers (400 and 300 window-heads of 196 tokens) and a ragged window;
 16. the production bf16 evaluation with both kernel switches on
     (MARS_ATTENTION_NOTAP_IMPL=pallas, MARS_SAM_WINDOWED_IMPL=pallas, for
     this phase only): ``cli_proposals.main --bf16`` over two episodes into
     a temporary directory, ``cli.main --bf16 --mask-proposals-path`` over
     its dumps, ``cli.main --bf16 --generate-proposals``; every kernel's
     launches checked exactly, each merged mask's IoU with the float32
     run's; then one zero-threshold Matcher call in bf16 and the ranking
     of its bucket;
 17. five-shot episodes: ``cli_proposals --nshot 5 --bf16`` and ``cli --nshot
     5 --bf16 --mask-proposals-path`` on its dumps with both switches on,
     then one float32 ``cli --nshot 5 --generate-proposals`` episode; every
     kernel's launches exact per episode;
 18. ``cli --models-path``: the ranking towers' seeded weights written as the
     reference's checkpoint files (DINOv2-L reg4, CLIP-B/16 as a TorchScript
     archive, AlphaCLIP's base and override), loaded through the zoo's
     audited conversion; the merged masks equal phase 7's bit for bit;
 19. the other backbones: the tap against its plain version at DINOv2-S/B/g2
     and CLIP-L/14 shapes, one ranking episode at ``--dino-backbone
     vit_giant2`` and one at ``--vta-backbone ViT-L/14``;
 20. one bf16 proposal-plus-ranking episode under torch.profiler, with
     both switches on, then with both off (the default route), then a
     five-shot one with both on;
 21. the text path through the CLI: ``cli.main`` without --gt-class-names
     at full width (the ranking towers as in phase 7; ViP-LLaVA-7B on
     seeded random weights in place of ``cli.build_retriever``'s checkpoint,
     the stand-in processor, prompt-lookup speculation at JAX's defaults;
     WordNet on tests/nltk_minicorpus.py's tree through --nltk-path): one
     block of four episodes in int4, then in NF4, then two episodes with
     --pipelined-text; the 4-bit launches (GEMV and GEMM) equal 146 per
     vision call + 224 per LLaMA forward as the decode loop counts them, the
     tap 31 per episode; each block's speculative streams against the same
     requests decoded plainly, a split allowed only where the plain step's
     top-two logit gap is under 2^-7 of the top logit;
 22. ViP-LLaVA-7B from its files (``phase_text_files``): a directory in the
     release's layout at full width (CLIP-L/14@336, 24 layers; LLaMA hidden
     4096, MLP 11008, 32 heads, vocabulary 32 064) with the LLaMA cut to 2
     of its 32 layers (``reduced``): seeded bf16 shards (~2 GB) under the
     release's names with their index, a seeded legacy tokenizer.json
     (32 000 pieces, <image> 32000, <pad> 32001), CLIP's preprocessor at
     336 and processor_config.json (tests/vip_llava_files.py);
     ``TorchVipLlava(dir)`` in int4, then NF4, answering one text block of
     518² images: the 4-bit launches exact (146 per vision call + 14 per
     forward), the loaded tree, greedy tokens and answers bitwise equal to
     the same arrays passed as ``params=`` through ``convert_hf``, the
     first forward's logits through the kernel and the plain version; one
     episode of ``cli.main --vlm-path dir --vlm4bit``; load seconds, peak
     memory, tokens a second;
 23. the fold run as scripts/_eval_common.sh drives it (``phase_fold_run``):
     ``cli_proposals --bf16 --use-centers --coco-rle --visualize 2`` over two
     episodes with both switches on (the Matcher's launches exact; the
     zero-threshold Matcher call's masks through the port's RLE and back,
     equal); ``cli.main`` with the script's ranking flags (--bf16, the
     thresholds, the backbones, --log-path, --exp-name) plus
     --gt-class-names and a two-index --bad-preds-path over six synthetic
     episodes, four times: --overlap-ranking 0, --overlap-ranking 2 (its
     launches made with CUDA's sync debug mode on: no synchronisation),
     a run interrupted inside its 4th ranking at --resume-every 2, and its
     --resume; merged masks bitwise equal across all four, scalars.csv's
     mIoU and FB-IoU by step, ranking_time.csv's idx and n_proposals, the
     event files' CRCs, the known-bad line, 31 tap launches an episode;
     ranking ms an episode at overlap 0 and 2 (wall over the fold); then
     ``--visualize 2``: two PNGs that decode;
 24. the benchmarks' own files (``phase_real_files``): tests/real_layouts.py
     lays the committed JPEG and PNG fixtures out as COCO-20i, PASCAL-5i,
     FSS-1000, LVIS-92i and PACO-Part; the port's decodes, resizes,
     polygon rasters, records and ``episode_host_u8`` arrays against the
     digests of PIL's and the JAX loaders' (expected.json); host ms to
     decode, resize, draw polygons and prepare an episode; ``cli.main
     --benchmark coco`` over three episodes in float32 (31 tap launches
     each), ``cli_proposals --bf16 --benchmark pascal5i`` then ``cli --bf16
     --mask-proposals-path`` with both switches on (launches exact), one
     ``MarsServer`` request with a 640x480 record (its mask equal to
     ``Mars.predict``'s);
 25. the Matcher's other configurations (``phase_matcher_configs``), float32
     at full width with the selection thresholds at 0: both negative
     sources with ``merge_prompt_types`` at one shot and at five (the
     auction's launches exact per ε-phase, every phase the kernel ran
     replayed on the plain phase, bitwise; each cost instance's rounds, ms
     and variant); ``use_box``, then the cascade on its best mask's low-res
     logits (binary masks, the logits changed); ``generate_multicrop`` at
     one crop layer and 32 points
     a side with MARS_SAM_WINDOWED_IMPL=pallas (grid 4 and windowed 28
     launches a crop), then ``postprocess_small_regions(min_area=100)``:
     live masks before and after, ms, peak memory;
 26. the tower flags (``phase_int8_towers``): ``cli.main --bf16`` over three
     synthetic episodes, then with ``--int8-towers``, then also
     ``--w8a8-alphaclip`` (merged masks' IoU with the ``--bf16`` run's,
     the towers' weight bytes, peak memory, ranking ms an episode, 31 tap
     launches an episode), then ``--generate-proposals`` over two;
     ``torch._int_mm`` at AlphaCLIP-L's MLP against the weight-only int8
     route and a bf16 product;
 27. the Semantic-SAM proposal path (``phase_semantic_sam``): ``cli.main
     --generate-proposals --proposal-model semantic-sam`` at full width
     (SwinL @640, the MaskDINO pixel and point decoders, 6 granularities;
     DINOv2-L matching) over three episodes in float32, again with the notap
     switch, then in bf16 with it: launches exact per episode (2 auction, 31
     tap, 48 + 28 + 24 per live AlphaCLIP chunk notap with the switch),
     every auction phase bitwise equal to the plain phase, the switched
     run's buckets and merged masks against the plain route's, bf16's
     merged masks' IoU with float32's; one call split by stage under
     torch.profiler (float32, bf16); one ``SamPointBackend`` call at ViT-H;
 28. the multi-device drivers and the serving runtime (``phase_parallel``):
     ``cli_parallel.main`` at one NCCL rank, local batch 4, over eight
     synthetic episodes in float32 and bf16 (merged masks against the
     serial ``cli.main``'s, 31 tap launches an episode, ranking ms an
     episode at local batch 1 and 4, one profiled batch of each, peak
     memory); ``--generate-proposals --local-batch 2`` with the AMG's
     selection thresholds at 0 (buckets bitwise equal to the serial CLI's);
     ``MarsServer`` (a warm-up, six queued requests, one malformed: its
     error delivered, the other masks equal to ``Mars.predict``'s, each
     request's latency); two ranks sharing the card over gloo
     (``evaluate_parallel`` at mesh 2 x 1 and 1 x 2, the proposal-sharded
     ranker on one 128-row bucket), masks against the float32 run's;
 29. the SAM decoder's train step and the exact host solvers
     (``phase_train``): ViT-H's frozen encode of eight synthetic 1024²
     images (32 grid launches), eight steps of ``parallel.train`` at batch 8
     (the loss falls), accumulation, remat and both against the full
     batch's step, the step at mesh 2 x 1 and 1 x 2 on two gloo ranks
     sharing the card against it; step ms, launches a step and peak memory
     of each variant; the auction kernel's assignment on the one-shot
     Matcher's forward instance against ``native.assignment_exact``, and the
     Sinkhorn EMD on the card against ``native.emd_exact`` (the seeded 60 x
     40 instance and a full-width ranking episode's cost matrix);
 30. the kernels line.
Phase 4 also runs the five-shot matching instances of synthetic episode 0
(1369 x 6845 and 6845 x 1369) and instances past the kernel's shared memory
(``ops/assignment.auction_variant``: its state partly or wholly in global
memory).
The last line is {"ok": true, "device": {...}}.  Without CUDA, or outside
the repository, it exits non-zero and prints no result.  Imports nothing
of JAX or of the JAX package.
"""
import contextlib
import json
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
EPISODES = 3
PROPOSAL_EPISODES = 2
TAPPED_BLOCKS = 24 + 7  # DINOv2-L query blocks + CLIP-B prefinal blocks 4..10
SAM_GLOBAL_LAYERS = 4  # ViT-H blocks 7, 15, 23, 31
AUCTIONS = 2  # forward + reverse matching per episode
# untapped blocks behind MARS_ATTENTION_NOTAP_IMPL=pallas: per ranking episode
# the DINOv2-L support pass (24) and CLIP-B prefinal blocks 0..3 (4), plus 24
# per live AlphaCLIP chunk of 16 proposals; per Matcher call its two DINOv2-L
# passes (support and query, 48)
RANKING_UNTAPPED = 24 + 4
ALPHACLIP_BLOCKS = 24
ALPHACLIP_CHUNK = 16
MATCHER_UNTAPPED = 2 * 24
SAM_WINDOWED_LAYERS = 28  # ViT-H's other 28 blocks, behind MARS_SAM_WINDOWED_IMPL=pallas
SWITCHES = {"MARS_ATTENTION_NOTAP_IMPL": "pallas", "MARS_SAM_WINDOWED_IMPL": "pallas"}
SWITCHES_OFF = {name: "xla" for name in SWITCHES}  # the default route
NOTAP_ONLY = {"MARS_ATTENTION_NOTAP_IMPL": "pallas"}  # the float32 ranking path's switch
BF16_EPISODES = 2
# H100 SXM peaks (NVIDIA data sheet, dense): float32 on CUDA cores, bf16 on
# tensor cores, HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
GEOMETRIES = (("dinov2_l_518", 16, 1374, 64), ("clip_b16_528", 12, 1090, 64))
# the tap at the other backbones' shapes (--dino-backbone vit_small, vit_base,
# vit_giant2 @518; --vta-backbone ViT-L/14 @518)
BACKBONE_GEOMETRIES = (("dinov2_s_518", 6, 1374, 64), ("dinov2_b_518", 12, 1374, 64),
                       ("dinov2_g2_518", 24, 1374, 64), ("clip_l14_518", 16, 1370, 64))
TAP_TOL = 1e-5  # the tap (float32 in both types) and the float32 output
TAP_PASSES = 3  # the float32 tap kernels' TF32 passes a product (split TF32)
# (name, heads, grid H, grid W, head dim): SAM ViT-H and ViT-B @1024 global
# layers, a ragged grid
GRID_GEOMETRIES = (("sam_vit_h_global", 16, 64, 64, 80), ("sam_vit_b_global", 12, 64, 64, 64),
                   ("ragged_5x7", 2, 5, 7, 24))
GRID_TOL = 2e-5
GRID_PASSES = 3  # the float32 grid kernel's TF32 passes a product (split TF32)
GRID_IOU = 0.99  # proposals of the float32 kernel's encode against the plain version's
# (name, B, H, L, D): an AlphaCLIP-L/14@336 chunk, DINOv2-L @518 and CLIP-B/16
# @528 at B = 1, and the widest head dim the kernel takes (two panels)
NOTAP_GEOMETRIES = (("alphaclip_l_336_chunk", 16, 16, 577, 64), ("dinov2_l_518", 1, 16, 1374, 64),
                    ("clip_b16_528", 1, 12, 1090, 64), ("head_dim_128", 2, 8, 577, 128),
                    ("dinov2_l_518_5shot", 5, 16, 1374, 64))
NOTAP_TOL = 2e-5
NOTAP_PASSES = 3  # the float32 notap kernel's TF32 passes a product (split TF32)
NOTAP_IOU = 0.99  # merged masks of the float32 notap route against the plain route's
SS_BF16_REL = 0.05  # the bf16 Semantic-SAM network against float32: max |diff| / max |x|
SS_BF16_IOU = 0.95  # ... and its live masks' mean IoU with float32's, on the same prompts
# (name, windows, heads, Hw, Ww, hd): SAM ViT-H @1024's and ViT-B @1024's
# windowed layers (64 x 64 grid padded to 70 x 70: 25 windows), a ragged
# window at ViT-B/L's head dim
WINDOW_GEOMETRIES = (("sam_vit_h_window", 25, 16, 14, 14, 80), ("ragged_5x6", 2, 2, 5, 6, 64),
                     ("sam_vit_b_window", 25, 12, 14, 14, 64))
WINDOW_TOL = 2e-5  # float32: the same sums in other orders
WINDOW_PASSES = 3  # the float32 windowed kernel's TF32 passes a product (split TF32)
WINDOW_IOU = 0.99  # proposals of the float32 windowed kernel's encode against the plain route's
WINDOWED_ONLY = {"MARS_SAM_WINDOWED_IMPL": "pallas"}  # the float32 proposal path's switch
# bfloat16 attention outputs, element by element.  Each side rounds P to
# bf16 (the flash kernels the unnormalised exp(s - running max), whose
# float32 row sum carries the same roundings: the weights end up at most
# 1.5 x 2^-8 apart, relative) and rounds its output (half an ulp, at most
# 2^-8 |out|), so |got - want| <= 2^-7 (|want| + P|v|), P|v| the plain
# version on |v|.  With randn inputs at d = 64, P|v| ~ 0.8 and |out| ~ 0.04
# (at most ~0.9), a limit of ~6.5e-3 at a typical element; a kernel that
# skips one key tile moves elements 20-40 times past it.
BF16_ATTN_REL = 2 ** -7
# tests/test_ops.py's Pallas-vs-XLA auction instances, then the dense contested
# geometry of negative_points_from_cost (mars_tpu/pipeline/matcher.py:193:
# square, every row valid, five ε-phases): (name, seed, T, N, phases)
AUCTION_CASES = tuple((f"test_ops_seed{seed}_{t}x{n}", seed, t, n, phases)
                      for seed, t, n, phases in ((0, 200, 300, 1), (2, 96, 96, 1),
                                                 (3, 150, 150, 1), (5, 120, 120, 5),
                                                 (6, 3, 700, 1))) + (
    ("dense_contested_1369x1369", 8, 1369, 1369, 5),)
# past the kernel's shared memory (ops/assignment.auction_variant): the last
# size that fits, the first that does not, grid 85 (T = N = 7 225), and a
# five-shot reverse match at grid 54 past 16 N bytes; matching-like (30 % of
# the rows valid, compacted), quantized scores for long wars:
# (name, seed, T, N, quantized)
AUCTION_LARGE = (("bound_7133x7133", 11, 7133, 7133, False),
                 ("bound_7133x7134", 12, 7133, 7134, False),
                 ("grid85_7225x7225", 13, 7225, 7225, False),
                 ("grid85_quantized_7225x7225", 14, 7225, 7225, True),
                 ("five_shot_g54_reverse_2916x14580", 15, 2916, 14580, False))
FIVE_SHOT_EPISODES = 2
MAIN_PATH_ARGS = ["--benchmark", "synthetic", "--episodes", str(EPISODES), "--gt-class-names",
                  "--proposal-bucket", "128", "--input-size", "518", "--seed", "0"]
# ViP-LLaVA-7B's dense shapes (IN, OUT) and a ragged one; rows: decode at
# batch 1, 4 and 8 (the GEMV's widest), prefill of 4 rows x ~582 positions
QUANT_SHAPES = (("llama_qkvo", 4096, 4096), ("llama_gate_up", 4096, 11008),
                ("llama_down", 11008, 4096), ("projector_1", 5120, 4096),
                ("clip_fc1", 1024, 4096), ("ragged", 1984, 999))
QUANT_ROWS = (1, 4, 8, 2330)
# a speculative verify forward's rows: B x (K + 1) at K = 8 draft tokens,
# B = 1, 2, 4 and 8, on every dense shape of a LLaMA layer
VERIFY_ROWS = (9, 18, 36, 72)
VERIFY_SHAPES = ("llama_qkvo", "llama_gate_up", "llama_down")
COLD_BYTES = 100e6  # weight copies a cold timing rotates through: twice the 50 MB L2
QUANT_REL_TOL = 2 ** -7  # bf16 output: one rounding of the largest output
# quantized denses per image prefill (CLIP-L: 24 layers x q, k, v, out,
# fc1, fc2, then the projector's two) and per LLaMA forward (32 x 7)
VISION_DENSES = 24 * 6 + 2
LLAMA_DENSES = 32 * 7
TEXT_ROWS = 4
TEXT_PREFIX = "Human: <image>\n"
LOGITS_PROMPT = ("Human: <image>\nWhat is the name of the object inside the red mask contour?"
                 "\nAssistant:")
# the text CLI phase: one block at the default depth, then the pipelined stage
TEXT_CLI_ARGS = ["--benchmark", "synthetic", "--proposal-bucket", "128", "--input-size", "518",
                 "--seed", "0"]
TEXT_CLI_EPISODES = 4
PIPELINED_EPISODES = 2
# the files phase: ViP-LLaVA-7B's directory at full width, the LLaMA cut to 2
# of its 32 layers (bf16 shards of ~2 GB), split into shards of 1 GB
TEXT_FILES_LAYERS = 2
TEXT_FILES_SHARD_BYTES = 1 << 30
TEXT_FILES_IMAGE = 518  # the support images' side at the CLI's --input-size
SPLIT_REL_GAP = 2 ** -7  # bf16: a stream may split only where the top-two gap is this small
# the fold run: scripts/_eval_common.sh's ranking flags (:21-50) on synthetic
# episodes; --gt-class-names as the VLM checkpoint is not in the repository
FOLD_EPISODES = 6
FOLD_ARGS = ["--benchmark", "synthetic", "--episodes", str(FOLD_EPISODES), "--seed", "0",
             "--input-size", "518", "--proposal-bucket", "128", "--gt-class-names",
             "--prompt-type", "contour", "--zoom-percentage", "50", "--color", "red",
             "--alpha-blending", "0.5", "--thickness", "2", "--vta-backbone", "ViT-B/16",
             "--vta-refinement-box-threshold", "0.4", "--last-n-attn-for-vta-refinement", "8",
             "--vva-backbone", "dino", "--dino-backbone", "vit_large", "--num-regs", "4",
             "--vva-refinement-box-threshold", "0.8", "--last-n-attn-for-vva-refinement", "24",
             "--static-threshold", "0.55", "--dynamic-threshold", "0.95",
             "--alpha-coverage", "0.85", "--bf16", "--exp-name", "1shot"]
FOLD_BAD = (1, 4)  # the --bad-preds-path indices
FOLD_INTERRUPT = 4  # the ranking that raises in the interrupted run
FOLD_PROPOSAL_EPISODES = 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def held_device_ms(calls):
    """Device milliseconds a call of the zero-argument ``calls``: CUDA events
    around them, enqueued while the device is held (``torch.cuda._sleep``)
    for the time the host took to enqueue them once, and more.  ``cuda_ms``
    times a kernel of a few microseconds behind a Python wrapper at the
    host's enqueue pace; this times the device alone."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # 3e6 cycles a host ms: 1.5 host ms at the H100's top clock (~2 GHz), more below it
    torch.cuda._sleep(int(3e6 * host_ms) + 400_000)
    start.record()
    for fn in calls:
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(calls)


def held_ms(fn, iters=20, warmup=3):
    """``cuda_ms``'s warm calls on one set of operands, timed device-held."""
    for _ in range(warmup):
        fn()
    return held_device_ms([fn] * iters)


def cold_ms(fn, operands, rounds=2):
    """Device-held milliseconds a call of ``fn(*operands[i])`` over ``rounds``
    passes through every operand set: with the sets' bytes past twice the
    L2, each call finds its weights in device memory."""
    return held_device_ms([lambda ops=ops: fn(*ops) for ops in operands] * rounds)


def cold_copies(tensors, nbytes=COLD_BYTES):
    """Enough distinct copies of ``tensors`` to total ``nbytes``."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    return [tuple(t.clone() for t in tensors) for _ in range(max(2, -(-int(nbytes) // size)))]


def _agreement(got, want, f32_tol, plain_on_abs_v):
    """max |got - want| and its ratio to the limit (at most 1 passes):
    ``f32_tol`` for float32 outputs, ``BF16_ATTN_REL`` (|want| + P|v|)
    element by element for bfloat16 ones, P|v| from ``plain_on_abs_v()``."""
    import torch

    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        limit, tol = f32_tol, f32_tol
    else:
        limit = BF16_ATTN_REL * (want.float().abs() + plain_on_abs_v().float())
        tol = "2^-7 (|want| + P|v|) element by element"
    return {"max_abs_err": diff.max().item(), "tol": tol,
            "err_over_tol": (diff / limit).max().item()}


def _spill_stores(log_lines):
    """{kernel: spill-store bytes} from one library's ptxas report."""
    import re

    out, fn = {}, None
    for ln in log_lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        fn = m.group(1) if m else fn
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn:
            out[fn] = int(m.group(1))
    return out


def _tensor_core_sass(path):
    """{kernel: {"HGMMA": n, "HMMA": n}} for the kernels of one library
    whose SASS (``cuobjdump -sass``) holds tensor-core instructions."""
    import re

    from mars_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        fn = m.group(1) if m else fn
        for op in ("HGMMA", "HMMA"):
            if fn and re.search(rf"\b{op}\.", ln):
                out.setdefault(fn, {"HGMMA": 0, "HMMA": 0})[op] += 1
    return out


# the tensor-core kernels (bfloat16, and float32 tap, grid, notap and
# windowed): each must hold HGMMA or HMMA in its SASS; the float32 tap
# kernels one instantiation per padded head dim (32, 64); notap, windowed
# and grid have one
# bf16 instantiation per width of the second head-dim panel (0, 16, 64; the
# resident windowed kernel takes 0 and 16), grid also one per way of taking
# the bias (0 general, 1 W = 64, 2 wide); the float32 notap kernel one per
# padded head dim (32, 64, 80, 128), the float32 grid kernel one per padded
# head dim and bias mode (0, 2), the float32 windowed kernel one per padded
# head dim through the key tables (0) and, up to head dim 80, one in tiles
# of 4 key rows of SAM's 14-wide window (2); the 4-bit library's bf16
# prefill GEMM and decode GEMV, int4 (0) and NF4 (1)
TENSOR_CORE_KERNELS = {
    "attention_tap": ("tap_out_bf16", "tap_mean_bf16")
    + tuple(f"tap_{part}_f32ILi{dp}E" for part in ("out", "mean") for dp in (32, 64)),
    "attention_notap": tuple(f"notap_bf16ILi{r}E" for r in (0, 16, 64))
    + tuple(f"notap_f32ILi{dp}E" for dp in (32, 64, 80, 128)),
    "sam_windowed_attention": tuple(f"windowed_bf16_residentILi{r}E" for r in (0, 16))
    + tuple(f"windowed_bf16_streamedILi{r}E" for r in (0, 16, 64))
    + tuple(f"windowed_f32ILi{dp}ELi0EE" for dp in (32, 64, 80, 128))
    + tuple(f"windowed_f32ILi{dp}ELi2EE" for dp in (32, 64, 80)),
    "sam_grid_attention": tuple(f"grid_bf16ILi{r}ELi{mode}EE" for r in (0, 16, 64)
                                for mode in (0, 1, 2))
    + tuple(f"grid_f32ILi{dp}ELi{mode}EE" for dp in (32, 64, 80, 128) for mode in (0, 2)),
    "int4_matmul": ("gemm_bf16_kernelILi0", "gemm_bf16_kernelILi1", "gemv_bf16ILi0",
                    "gemv_bf16ILi1")}


def phase_build(state):
    from mars_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build_all()
    ptxas, spills, sass = {}, {}, {}
    for name in build.SOURCES:
        with open(build.library_path(name)[:-3] + ".log") as f:
            log = f.readlines()
        ptxas[name] = [ln.strip() for ln in log if "registers" in ln or "spill" in ln]
        spills[name] = {fn: n for fn, n in _spill_stores(log).items() if n}
        sass[name] = _tensor_core_sass(build.library_path(name))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(built),
          "ptxas": ptxas, "spill_stores": spills, "tensor_core_sass": sass})
    missing = [k for lib, kernels in TENSOR_CORE_KERNELS.items() for k in kernels
               if not any(k in fn and sum(c.values()) for fn, c in sass[lib].items())]
    spilled = {lib: spills[lib] for lib in TENSOR_CORE_KERNELS if spills[lib]}
    if missing or spilled:
        raise AssertionError(f"tensor-core kernels without HGMMA/HMMA: {missing}; "
                             f"spill stores: {spilled}")


def _tap_row(name, h, l, d, dtype, gen):
    """``attention_with_tap`` against its plain version at (h, l, d) in
    ``dtype``: errors, a rerun's bitwise equality, times beside the bound
    and SDPA (out only); raises on a disagreement."""
    import torch
    import torch.nn.functional as F

    from mars_tpu_torch.ops import flash_attention as fa

    dt = str(dtype).split(".")[1]
    q, k, v = (torch.randn((h, l, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    out, tap = fa.attention_with_tap(q, k, v)
    out2, tap2 = fa.attention_with_tap(q, k, v)
    want_out, want_tap = fa.attention_with_tap_plain(q, k, v)
    torch.cuda.synchronize()
    rerun_equal = bool(torch.equal(out, out2) and torch.equal(tap, tap2))
    agree = _agreement(out, want_out, TAP_TOL,
                       lambda: fa.attention_with_tap_plain(q, k, v.abs())[0])
    err_tap = (tap - want_tap).abs().max().item()
    err_rows = (tap.sum(-1) - 1).abs().max().item()
    size = q.element_size()
    flops = 4.0 * h * l * l * d
    nbytes = 4.0 * h * l * d * size + l * l * 4.0
    # float32: split TF32, three passes a product on the tensor cores
    bound, bound_by = (_bound(TAP_PASSES * flops, nbytes, "tf32") if dt == "float32"
                       else _bound(flops, nbytes, dt))
    row = {"phase": "kernel", "kernel": "attention_with_tap", "geometry": name,
           "shape": [h, l, d], "dtype": dt, "max_abs_err_out": agree["max_abs_err"],
           "max_abs_err_tap": err_tap, "max_abs_err_tap_rowsum": err_rows,
           "tol": {"out": agree["tol"], "tap": TAP_TOL},
           "out_err_over_tol": agree["err_over_tol"], "rerun_equal": rerun_equal,
           "ms": cuda_ms(lambda: fa.attention_with_tap(q, k, v)),
           "plain_ms": cuda_ms(lambda: fa.attention_with_tap_plain(q, k, v)),
           "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
               q[None], k[None], v[None])),
           "library_call": "F.scaled_dot_product_attention (out only, no tap)",
           "bound_ms": bound, "bound_by": bound_by}
    if dt == "float32":
        row["bound_f32_cuda_core_ms"] = _bound(flops, nbytes, dt)[0]
    emit(row)
    if (agree["err_over_tol"] > 1 or err_tap > TAP_TOL or err_rows > TAP_TOL
            or not rerun_equal or not torch.isfinite(out.float()).all()):
        raise AssertionError(f"attention_with_tap disagrees with its plain version: {row}")
    return row


def phase_kernels(state):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    state["kernel_rows"] = [_tap_row(name, h, l, d, dtype, gen) for name, h, l, d in GEOMETRIES
                            for dtype in (torch.float32, torch.bfloat16)]


def phase_grid_attention(state):
    import torch
    import torch.nn.functional as F

    from mars_tpu_torch.ops import sam_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, nh, h, w, d in GRID_GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            l = h * w
            args = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for shape in
                    ((nh, l, d), (nh, l, d), (nh, l, d), (nh, l, h), (nh, l, w))]
            out = sa.grid_attention(*args, (h, w))
            rerun_equal = bool(torch.equal(out, sa.grid_attention(*args, (h, w))))
            want = sa.grid_attention_plain(*args, (h, w))
            torch.cuda.synchronize()
            agree = _agreement(out, want, GRID_TOL, lambda: sa.grid_attention_plain(
                *args[:2], args[2].abs(), *args[3:], (h, w)))
            # the yardstick's input: the decomposed bias expanded to (heads, L, L)
            cols = torch.arange(l, device="cuda")
            mask = (args[3][:, :, cols // w] + args[4][:, :, cols % w])[None]
            q, k, v = (a[None] for a in args[:3])
            size = args[0].element_size()
            flops = 4.0 * nh * l * l * d
            nbytes = (4 * nh * l * d + nh * l * (h + w)) * size
            # float32: split TF32, three passes a product on the tensor cores
            bound, bound_by = (_bound(GRID_PASSES * flops, nbytes, "tf32") if dt == "float32"
                               else _bound(flops, nbytes, dt))
            row = {"phase": "kernel", "kernel": "grid_attention", "geometry": name,
                   "shape": [nh, l, d], "grid": [h, w], "dtype": dt, **agree,
                   "rerun_equal": rerun_equal,
                   "ms": cuda_ms(lambda: sa.grid_attention(*args, (h, w))),
                   "plain_ms": cuda_ms(lambda: sa.grid_attention_plain(*args, (h, w)), iters=5),
                   "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask)),
                   "library_call": "F.scaled_dot_product_attention with the bias expanded "
                                   "to (heads, L, L) outside the timing",
                   "bound_ms": bound, "bound_by": bound_by}
            if dt == "float32":
                row["bound_f32_cuda_core_ms"] = _bound(flops, nbytes, dt)[0]
            emit(row)
            rows.append(row)
            if (agree["err_over_tol"] > 1 or not rerun_equal
                    or not torch.isfinite(out.float()).all()):
                raise AssertionError(f"grid_attention disagrees with its plain version: {row}")
    state["grid_rows"] = rows


def _bound(flops, nbytes, dt):
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def phase_notap(state):
    """``attention_notap`` against its plain version at the untapped blocks'
    shapes, float32 and bfloat16, beside its bound and SDPA."""
    import torch
    import torch.nn.functional as F

    from mars_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for name, b, h, l, d in NOTAP_GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out = fa.attention_notap(q, k, v)
            rerun_equal = bool(torch.equal(out, fa.attention_notap(q, k, v)))
            want = fa.attention_notap_plain(q, k, v)
            torch.cuda.synchronize()
            agree = _agreement(out, want, NOTAP_TOL,
                               lambda: fa.attention_notap_plain(q, k, v.abs()))
            flops, nbytes = 4.0 * b * h * l * l * d, 4.0 * b * h * l * d * q.element_size()
            # float32: split TF32, three passes a product on the tensor cores
            bound, by = (_bound(NOTAP_PASSES * flops, nbytes, "tf32") if dt == "float32"
                         else _bound(flops, nbytes, dt))
            row = {"phase": "kernel", "kernel": "attention_notap", "geometry": name,
                   "shape": [b, h, l, d], "dtype": dt, **agree, "rerun_equal": rerun_equal,
                   "ms": cuda_ms(lambda: fa.attention_notap(q, k, v)),
                   "plain_ms": cuda_ms(lambda: fa.attention_notap_plain(q, k, v), iters=5),
                   "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   "library_call": "F.scaled_dot_product_attention",
                   "bound_ms": bound, "bound_by": by}
            if dt == "float32":
                row["bound_f32_cuda_core_ms"] = _bound(flops, nbytes, dt)[0]
            emit(row)
            rows.append(row)
            if (agree["err_over_tol"] > 1 or not rerun_equal
                    or not torch.isfinite(out.float()).all()):
                raise AssertionError(f"attention_notap disagrees with its plain version: {row}")
    state["notap_rows"] = rows


def phase_windowed(state):
    """``windowed_attention`` against its plain version at SAM ViT-H's and
    ViT-B's windowed layers and a ragged window, float32 and bfloat16, beside
    its bound (float32: split TF32's three passes, and the CUDA cores'
    bound) and SDPA with the bias expanded."""
    import torch
    import torch.nn.functional as F

    from mars_tpu_torch.ops import sam_attention as sa

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for name, b, nh, h, w, d in WINDOW_GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            l = h * w
            args = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for shape in
                    ((b, nh, l, d), (b, nh, l, d), (b, nh, l, d), (b, nh, l, h), (b, nh, l, w))]
            out = sa.windowed_attention(*args, (h, w))
            rerun_equal = bool(torch.equal(out, sa.windowed_attention(*args, (h, w))))
            want = sa.windowed_attention_plain(*args, (h, w))
            torch.cuda.synchronize()
            agree = _agreement(out, want, WINDOW_TOL, lambda: sa.windowed_attention_plain(
                *args[:2], args[2].abs(), *args[3:], (h, w)))
            # the yardstick's input: the decomposed bias expanded to (B, nh, L, L)
            cols = torch.arange(l, device="cuda")
            mask = args[3][..., cols // w] + args[4][..., cols % w]
            flops = 4.0 * b * nh * l * l * d
            nbytes = (4 * b * nh * l * d + b * nh * l * (h + w)) * args[0].element_size()
            # float32: split TF32, three passes a product on the tensor cores
            bound, by = (_bound(WINDOW_PASSES * flops, nbytes, "tf32") if dt == "float32"
                         else _bound(flops, nbytes, dt))
            row = {"phase": "kernel", "kernel": "windowed_attention", "geometry": name,
                   "shape": [b, nh, l, d], "window": [h, w], "dtype": dt, **agree,
                   "rerun_equal": rerun_equal,
                   "ms": cuda_ms(lambda: sa.windowed_attention(*args, (h, w))),
                   "plain_ms": cuda_ms(lambda: sa.windowed_attention_plain(*args, (h, w)),
                                       iters=5),
                   "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                       *args[:3], attn_mask=mask)),
                   "library_call": "F.scaled_dot_product_attention with the bias expanded "
                                   "to (B, heads, L, L) outside the timing",
                   "bound_ms": bound, "bound_by": by}
            if dt == "float32":
                row["bound_f32_cuda_core_ms"] = _bound(flops, nbytes, dt)[0]
            emit(row)
            rows.append(row)
            if (agree["err_over_tol"] > 1 or not rerun_equal
                    or not torch.isfinite(out.float()).all()):
                raise AssertionError(f"windowed_attention disagrees with its plain version: {row}")
    state["window_rows"] = rows


def _matching_instances(shots=1):
    """The forward and reverse matching auctions of synthetic episode 0 at
    full width (DINOv2-L/14 reg4 @518, 37 × 37 patches), at ``shots``
    support shots.  At five shots (R = 5 × 1369 support rows) also the
    forward instance of a footprint past the query grid, which the Matcher
    solves transposed (pipeline/matcher.py): here every support patch in
    the masks, so that every query patch finds a column."""
    import torch

    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS
    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.ops import assignment as asg
    from mars_tpu_torch.pipeline import matcher

    dev = torch.device("cuda")
    params, cfg = zoo.build_dinov2(None, "vit_large", 4, 0, dev)
    ep = to_device_episode(SyntheticFSS(seed=0, shot=shots)[0], 518, shots, dev)
    with torch.no_grad():
        s_mat, _, fg = matcher._features_and_matrices(
            params, ep.support_images, ep.support_masks, ep.support_valid, ep.query_image,
            cfg, 37)
    l = s_mat.shape[1]
    cols = asg.auction_assignment(s_mat, fg, row_chunk=128)
    pair_valid = torch.zeros((l,), dtype=torch.bool, device=dev)
    pair_valid[cols[cols >= 0].long()] = True
    tag = "" if shots == 1 else f"{shots}shot_"
    out = [(f"matching_{tag}forward", s_mat, fg),
           (f"matching_{tag}reverse", s_mat.T.contiguous(), pair_valid)]
    if shots > 1:
        out.append((f"matching_{tag}forward_transposed", s_mat.T.contiguous(),
                    torch.ones((l,), dtype=torch.bool, device=dev)))
    return tuple(out)


def _large_auction_case(seed, t, n, quantized):
    """An ``AUCTION_LARGE`` instance on the card → (scores, valid)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    s = (rng.randint(0, 4, (t, n)).astype(np.float32) / 4.0 if quantized
         else rng.rand(t, n).astype(np.float32))
    valid = rng.rand(t) < 0.3
    return torch.from_numpy(s).cuda(), torch.from_numpy(valid).cuda()


def auction_case(seed, t, n):
    """An ``AUCTION_CASES`` instance → (scores (T, N) float32, valid (T,)
    bool), numpy, as tests/test_ops.py makes them (seed 3: quantized)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    s = (rng.randint(0, 4, (t, n)).astype(np.float32) / 4.0 if seed == 3
         else rng.rand(t, n).astype(np.float32))
    valid = rng.rand(t) < (0.3 if t != n else 1.1)
    valid[0] |= not valid.any()
    return s, valid


def auction_phases(phase, scores, valid, eps):
    """Every ε-phase of an instance in turn, from zero prices, through
    ``phase`` (the kernel's wrapper or the plain version) → (col_of_row,
    prices, [each phase's round counts])."""
    import torch

    prices = torch.zeros((scores.shape[1],), dtype=torch.float32, device=scores.device)
    col, counts = None, []
    for e in eps:
        col, prices, c = phase(scores, valid, prices, e, 20000)
        counts.append(c)
    return col, prices, counts


def phase_auction(state):
    """Each instance's phases on the wrapper's own inputs (``phase_inputs``):
    the kernel and the plain version on the card, compared bit for bit."""
    import torch

    from mars_tpu_torch.ops import assignment as asg

    cases = []
    for name, seed, t, n, phases in AUCTION_CASES:
        s, valid = auction_case(seed, t, n)
        cases.append((name, torch.from_numpy(s).cuda(), torch.from_numpy(valid).cuda(), phases,
                      None))
    cases += [(name, s, v, 1, 128) for name, s, v in _matching_instances()]
    cases += [(name, s, v, 1, 128) for name, s, v in _matching_instances(shots=5)]
    cases += [(name, *_large_auction_case(seed, t, n, q), 1, 128)
              for name, seed, t, n, q in AUCTION_LARGE]
    rows = []
    for name, s, v, phases, chunk in cases:
        scores, valid, _, eps = asg.phase_inputs(s, v, phases, chunk)
        n = scores.shape[1]

        def run(phase):
            return auction_phases(phase, scores, valid, eps)

        col_k, pr_k, st_k = run(asg._auction_phase_kernel)
        t0 = time.perf_counter()
        col_p, pr_p, st_p = run(asg._auction_phase_plain)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        col_r, pr_r, st_r = run(asg._auction_phase_kernel)
        bidder_rows = sum(c[2] + c[3] for c in st_k)
        rounds = sum(c[0] + c[1] for c in st_k)
        ms = cuda_ms(lambda: run(asg._auction_phase_kernel), iters=5, warmup=1)
        row = {"phase": "kernel", "kernel": "auction", "instance": name,
               "shape": list(scores.shape), "valid_rows": int(valid.sum()), "phases": phases,
               "variant": asg.VARIANTS[asg.auction_variant(*scores.shape)],
               "equal": bool(torch.equal(col_k, col_p) and torch.equal(pr_k, pr_p)
                             and st_k == st_p),
               "rerun_equal": bool(torch.equal(col_r, col_k) and st_r == st_k and torch.equal(
                   pr_r.view(torch.int32), pr_k.view(torch.int32))),
               "rounds": {"dense": sum(c[0] for c in st_k), "small": sum(c[1] for c in st_k)},
               "bidder_rows": bidder_rows, "assigned": int((col_k >= 0).sum()),
               "ms": ms, "us_per_round": ms * 1e3 / max(rounds, 1),
               "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": bidder_rows * n * 4.0 / PEAK_BYTES * 1e3, "bound_by": "bytes"}
        emit(row)
        rows.append(row)
        if not (row["equal"] and row["rerun_equal"]):
            raise AssertionError(f"auction kernel differs from its plain version: {row}")
    state["auction_rows"] = rows


def phase_golden(state):
    import numpy as np
    import torch

    from mars_tpu_torch.core.episode import Episode, pad_proposals
    from mars_tpu_torch.models import clip, convert, dinov2
    from mars_tpu_torch.pipeline import filtering, mars, vta, vva

    data = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_episode_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    dev = "cuda"
    tcfg = clip.ClipTextConfig(width=16, depth=2, num_heads=2, output_dim=16)
    model = mars.Mars(
        (convert.from_reference_state_dict(sub("dino."), "dinov2", 3, device=dev),
         dinov2.DinoV2Config(embed_dim=32, depth=3, num_heads=2, pos_embed_grid=8)),
        (convert.from_reference_state_dict(sub("clip."), "clip_visual", 3, device=dev),
         convert.from_reference_state_dict(sub("clip."), "clip_text", 2, device=dev),
         convert.logit_scale(sub("clip."), dev),
         clip.ClipVisualConfig(width=64, depth=3, num_heads=1, output_dim=16,
                               pos_embed_grid=7), tcfg),
        (convert.from_reference_state_dict(sub("aclip."), "alpha_clip_visual", 2, device=dev),
         convert.from_reference_state_dict(sub("aclip."), "clip_text", 2, device=dev),
         convert.logit_scale(sub("aclip."), dev),
         clip.ClipVisualConfig(width=64, depth=2, num_heads=1, output_dim=16, pos_embed_grid=7,
                               alpha_channel=True), tcfg),
        cfg=mars.MarsConfig(
            vva=vva.VVAConfig(refinement_box_threshold=0.8, attn_tap_last_n=2, grid=8),
            vta=vta.VTAConfig(refinement_box_threshold=0.4, attn_tap_last_n=3, input_size=112,
                              grid=7),
            filter_merge=filtering.FilterMergeConfig(
                grid=8, alpha_clip_size=112, alpha_clip_batch=4, emd_row_bucket=128,
                emd_col_bucket=64)),
        device=dev)
    ep = Episode(
        torch.from_numpy(np.ascontiguousarray(data["support_images"][0].transpose(0, 2, 3, 1))).to(dev),
        torch.from_numpy(data["support_masks"][0]).to(dev),
        torch.ones((2,), dtype=torch.bool, device=dev),
        torch.from_numpy(np.ascontiguousarray(data["query_image"][0].transpose(1, 2, 0))).to(dev),
        -1)
    props = pad_proposals(torch.from_numpy(data["proposals"]).to(dev), 8)
    merged = model.predict(ep, props, class_name=str(data["class_name"]),
                           class_description=str(data["class_description"])).cpu().numpy()
    diff = int((merged != data["merged"]).sum())
    emit({"phase": "golden_episode", "merged_pixels_differing": diff,
          "merged_fg_pixels": int(merged.sum())})
    if diff:
        raise AssertionError(f"golden merged mask differs from the fixture in {diff} pixels")


def _mask_iou(a, b):
    """(N, H, W) x (M, H, W) bool → (N, M) IoU; empty against empty = 1."""
    import numpy as np

    af = a.reshape(len(a), -1).astype(np.float64)
    bf = b.reshape(len(b), -1).astype(np.float64)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def _greedy_match(iou):
    iou = iou.copy()
    out = []
    for _ in range(min(iou.shape)):
        i, j = divmod(int(iou.argmax()), iou.shape[1])
        out.append((i, j, float(iou[i, j])))
        iou[i, :] = -1
        iou[:, j] = -1
    return out


def phase_golden_matcher(state):
    """tests/fixtures/golden_matcher_tiny.npz (made by the reference
    Matcher) through the port's generate_proposals on the card, with the
    content checks of tests/test_golden_matcher.py."""
    from dataclasses import replace

    import numpy as np
    import torch

    from mars_tpu_torch.models import convert, dinov2, sam
    from mars_tpu_torch.ops import assignment as asg
    from mars_tpu_torch.pipeline import amg, matcher

    data = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_matcher_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    dev = "cuda"
    sam_sd = sub("sam.")
    sam_params = {"encoder": convert.from_reference_state_dict(sam_sd, "sam_encoder", 3, device=dev),
                  "prompt_encoder": convert.from_reference_state_dict(sam_sd, "sam_prompt_encoder",
                                                                      device=dev),
                  "decoder": convert.from_reference_state_dict(sam_sd, "sam_decoder", device=dev)}
    mcfg = matcher.MatcherConfig(
        input_size=64, grid=8, patch_size=8, sample_range=(2, 3), max_sample_iterations=4,
        purity_filter=0.02, deep_score_filter=0.6, deep_score_norm_filter=0.4,
        num_merging_mask=10, emd_row_bucket=16, emd_col_bucket=64)
    launches = asg.auction_assignment.launches
    with torch.no_grad():
        out = matcher.generate_proposals(
            convert.from_reference_state_dict(sub("dino."), "dinov2", 3, device=dev),
            dinov2.DinoV2Config(patch_size=8, embed_dim=32, depth=3, num_heads=2,
                                pos_embed_grid=8),
            sam_params,
            sam.SamConfig(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
                          global_attn_indexes=(1,), window_size=2, out_chans=32,
                          decoder_mlp_dim=64, decoder_heads=2),
            amg.AmgConfig(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0,
                          box_nms_thresh=0.5, sel_multimask_output=True, sel_output_layer=3,
                          decode_batch=16),
            mcfg,
            torch.from_numpy(np.ascontiguousarray(d["support_images"][0].transpose(0, 2, 3, 1))).to(dev),
            torch.from_numpy(d["support_masks"][0]).to(dev), torch.ones((1,), dtype=torch.bool,
                                                                     device=dev),
            torch.from_numpy(np.ascontiguousarray(d["query_image"][0].transpose(1, 2, 0))).to(dev),
            generator=torch.Generator(device=dev).manual_seed(0))
    o = {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
    valid = o["proposal_valid"]
    ours, ref = o["proposal_masks"][valid], d["proposals"] > 0
    matches = _greedy_match(_mask_iou(ref, ours)) if len(ours) == len(ref) else []
    merged_tk, final_tk, _ = matcher.filter_and_merge(
        out["proposal_masks"], out["proposal_valid"], out["emd_score"], out["purity"],
        out["coverage"], replace(mcfg, use_score_filter=False, topk_scores_threshold=0.2))
    checks = {
        "cost_matrix": bool(np.allclose(o["cost_matrix"], d["cost_matrix"], atol=3e-5,
                                        rtol=1e-4)),
        "support_fg": bool((o["support_fg"] == (d["ref_masks_pool"] > 0)).all()),
        "matched_points": {tuple(map(int, p)) for p in o["points"][o["point_valid"]]}
        == {tuple(map(int, p)) for p in d["points"]},
        "proposal_count": len(ours) == len(ref),
        "proposal_iou": bool(matches) and min(m[2] for m in matches) >= 0.99,
        "scores": bool(matches) and all(
            abs(o["purity"][valid][j] - d["purity"][i]) <= 1e-5
            and abs(o["coverage"][valid][j] - d["coverage"][i]) <= 1e-5
            and abs(o["emd_score"][valid][j] - d["emd"][i]) <= 3e-3
            and abs(o["iou"][valid][j] - d["iou_preds"][i]) <= 1e-3
            and abs(o["stability"][valid][j] - d["stability"][i]) <= 1e-3
            for i, j, _ in matches),
        "merged": _mask_iou((d["merged"][0] > 0)[None], (o["merged"] > 0)[None])[0, 0] >= 0.99
        and abs(float(o["final_score"]) - float(d["final_score"])) <= 3e-3,
        "merged_topk": _mask_iou((d["merged_topk"][0] > 0)[None],
                                 (merged_tk.cpu().numpy() > 0)[None])[0, 0] >= 0.99
        and abs(float(final_tk) - float(d["final_topk"])) <= 3e-3,
    }
    row = {"phase": "golden_matcher", "proposals": int(valid.sum()),
           "fixture_proposals": len(ref), "min_iou": min((m[2] for m in matches), default=None),
           "auction_launches": asg.auction_assignment.launches - launches, "checks": checks}
    emit(row)
    if not all(checks.values()) or row["auction_launches"] != AUCTIONS:
        raise AssertionError(f"golden Matcher episode failed on the card: {row}")


def phase_main_path(state):
    import math

    from mars_tpu_torch import cli
    from mars_tpu_torch.ops import flash_attention as fa

    fa.attention_with_tap.launches = 0
    res = cli.main(MAIN_PATH_ARGS, keep_masks=True)
    launches = fa.attention_with_tap.launches
    state["launches"] = {"attention_with_tap": launches}
    state["main_path_masks"] = res["masks"]
    ms = res["episode_ms"]
    row = {"phase": "main_path", "episodes": EPISODES, "episode_ms": ms,
           "ms_per_episode_after_first": sum(ms[1:]) / len(ms[1:]),
           "episode_peak_memory_gib": res["episode_peak_gib"],
           "miou": res["miou"], "fb_iou": res["fb_iou"], "masks_binary": res["masks_binary"],
           "launches": state["launches"], "launches_expected": TAPPED_BLOCKS * EPISODES}
    emit(row)
    if launches != TAPPED_BLOCKS * EPISODES:
        raise AssertionError(f"attention_with_tap launched {launches} times, "
                             f"expected {TAPPED_BLOCKS * EPISODES}")
    if not res["masks_binary"] or not math.isfinite(res["miou"]):
        raise AssertionError("main path produced a non-binary mask or a non-finite mIoU")
    _plain_tap_episodes(res["masks"])


def _plain_tap_episodes(masks):
    """``phase_main_path``'s three float32 episodes again with
    ``attention_with_tap_plain`` in the kernel's place (here only, never in
    the package): each merged mask of the kernel's run must match the plain
    run's at IoU >= ``NOTAP_IOU``, and the kernel must not launch."""
    import numpy as np

    from mars_tpu_torch import cli
    from mars_tpu_torch.ops import flash_attention as fa

    kernel = fa.attention_with_tap
    kernel.launches = 0
    fa.attention_with_tap = fa.attention_with_tap_plain
    try:
        plain = cli.main(MAIN_PATH_ARGS, keep_masks=True)
    finally:
        fa.attention_with_tap = kernel
    ious = [float(_mask_iou(a[None], b[None])[0, 0]) for a, b in zip(masks, plain["masks"])]
    equal = sum(bool(np.array_equal(a, b)) for a, b in zip(masks, plain["masks"]))
    row = {"phase": "main_path_plain_tap", "episodes": EPISODES,
           "iou_with_plain_tap": ious, "iou_limit": NOTAP_IOU,
           "masks_bitwise_equal": f"{equal} of {len(ious)}",
           "miou_plain_tap": plain["miou"], "kernel_launches": kernel.launches}
    emit(row)
    if kernel.launches or len(ious) != EPISODES or min(ious) < NOTAP_IOU:
        raise AssertionError(f"the float32 tap kernel's masks depart from the plain tap's: {row}")


def phase_f32_notap_path(state):
    """``phase_main_path``'s three float32 episodes with
    MARS_ATTENTION_NOTAP_IMPL=pallas alone, set for this run and restored
    after: the towers' untapped blocks on the float32 notap kernel.  Every
    kernel's count is set to 0 just before and read just after and must be
    the switch's exact count; each merged mask must match the plain route's
    (``phase_main_path``) at IoU >= ``NOTAP_IOU``."""
    import math

    import numpy as np

    from mars_tpu_torch import cli

    for fn in cli.KERNELS.values():
        fn.launches = 0
    with kernel_switches(NOTAP_ONLY):
        res = cli.main(MAIN_PATH_ARGS, keep_masks=True)
    launches = {name: fn.launches for name, fn in cli.KERNELS.items()}
    want = _ranking_launches(res["live_proposals"])
    plain = state["main_path_masks"]
    ious = [float(_mask_iou(a[None], b[None])[0, 0]) for a, b in zip(res["masks"], plain)]
    state["f32_notap_launches"] = {"ranking_f32_notap": launches}
    ms = res["episode_ms"]
    row = {"phase": "f32_notap_path", "switches": NOTAP_ONLY, "episodes": EPISODES,
           "episode_ms": ms, "ms_per_episode_after_first": sum(ms[1:]) / len(ms[1:]),
           "live_proposals": res["live_proposals"], "miou": res["miou"],
           "masks_binary": res["masks_binary"], "iou_with_plain_route": ious,
           "iou_limit": NOTAP_IOU,
           "masks_equal_plain_route": [bool(np.array_equal(a, b))
                                       for a, b in zip(res["masks"], plain)],
           "launches": launches, "launches_expected": want}
    emit(row)
    if launches != want:
        raise AssertionError(f"float32 notap path launches {launches}, expected {want}")
    if len(ious) != EPISODES or min(ious) < NOTAP_IOU:
        raise AssertionError(f"float32 notap path's masks depart from the plain route's: {ious}")
    if not res["masks_binary"] or not math.isfinite(res["miou"]):
        raise AssertionError("float32 notap path produced a non-binary mask or a non-finite mIoU")


def phase_proposal_path(state):
    """``cli.main --generate-proposals`` at full width, every kernel's count
    set to 0 just before and read just after."""
    import math

    from mars_tpu_torch import cli

    for fn in cli.KERNELS.values():
        fn.launches = 0
    res = cli.main(["--benchmark", "synthetic", "--episodes", str(PROPOSAL_EPISODES),
                    "--gt-class-names", "--generate-proposals", "--proposal-bucket", "128",
                    "--input-size", "518", "--seed", "0"], keep_masks=True)
    launches = {name: fn.launches for name, fn in cli.KERNELS.items()}
    want = {"attention_with_tap": TAPPED_BLOCKS * PROPOSAL_EPISODES, "attention_notap": 0,
            "grid_attention": SAM_GLOBAL_LAYERS * PROPOSAL_EPISODES, "windowed_attention": 0,
            "auction": AUCTIONS * PROPOSAL_EPISODES}
    state["proposal_launches"] = launches
    state["f32_masks"] = res["masks"]
    row = {"phase": "proposal_path", "episodes": PROPOSAL_EPISODES,
           "proposal_ms": res["proposal_ms"], "ranking_ms": res["episode_ms"],
           "live_proposals": res["live_proposals"],
           "episode_peak_memory_gib": res["episode_peak_gib"],
           "miou": res["miou"], "masks_binary": res["masks_binary"], "launches": launches,
           "launches_expected": want}
    emit(row)
    if launches != want:
        raise AssertionError(f"proposal path launches {launches}, expected {want}")
    if not res["masks_binary"] or not math.isfinite(res["miou"]):
        raise AssertionError("proposal path produced a non-binary mask or a non-finite mIoU")


def _zero_thresholds(bf16):
    """One full-width generate_proposals with the selection thresholds at 0
    (the AMG config of tests/test_golden_matcher.py) → (row, output)."""
    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS
    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.models.precision import cast_floating
    from mars_tpu_torch.pipeline import amg, matcher

    dev = torch.device("cuda")
    dino, dino_cfg = zoo.build_dinov2(None, "vit_large", 4, 0, dev)
    sam_params, sam_cfg = zoo.build_sam(None, "vit_h", 3, dev)
    if bf16:
        dino, sam_params = cast_floating(dino), cast_floating(sam_params)
    ep = to_device_episode(SyntheticFSS(seed=0)[0], 518, 1, dev)
    acfg = amg.AmgConfig(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0,
                         box_nms_thresh=0.5, sel_multimask_output=True, sel_output_layer=3,
                         decode_batch=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = matcher.generate_proposals(
            dino, dino_cfg, sam_params, sam_cfg, acfg, matcher.MatcherConfig(),
            ep.support_images, ep.support_masks, ep.support_valid, ep.query_image,
            generator=cli.episode_generator(0, 0, dev), bucket=128)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    live = int(out["proposal_valid"].sum())
    bucket_valid = out["bucket_valid"].cpu()
    k = min(live, 128)
    masks = out["bucket_masks"]
    row = {"phase": "zero_thresholds", "bf16": bf16, "ms": ms, "live_proposals": live,
           "decoded_sets": int(out["telemetry"]["n_prompt_sets"]),
           "live_before_nms": int(out["telemetry"]["n_decoded"]),
           "matched_points": int(out["telemetry"]["n_matched_points"]),
           "chosen": int(out["chosen"].sum()), "final_score": float(out["final_score"]),
           "bucket_live": int(bucket_valid.sum()),
           "embedding_dtype": str(out["embedding"].dtype),
           "emd_score_range": [float(out["emd_score"][out["proposal_valid"]].min()),
                               float(out["emd_score"][out["proposal_valid"]].max())]
           if live else None}
    ok = (live > 0 and bool(bucket_valid[:k].all()) and not bool(bucket_valid[k:].any())
          and bool(((masks == 0) | (masks == 1)).all())
          and bool(torch.isfinite(out["emd_score"]).all()))
    if not ok:
        emit(row)
        raise AssertionError(f"zero-threshold proposals failed: {row}")
    return row, out, ep


def phase_zero_thresholds(state):
    """With random weights the default 0.88 / 0.95 reject every mask, so
    only with the thresholds at 0 do decode, NMS, EMD scoring and the
    bucket see live masks.  Then the same call with ``grid_attention_plain``
    swapped in for the float32 grid kernel: ViT-H's embedding (its four
    global layers the kernel's) against the plain version's, and the
    proposals equal in count, each matched at IoU >= ``GRID_IOU``."""
    from mars_tpu_torch.ops import sam_attention as sa

    kernel, before = sa.grid_attention, sa.grid_attention.launches
    row, out, _ = _zero_thresholds(bf16=False)
    emit(row)
    state["zero_thresholds"] = (row, out)
    launched = kernel.launches - before
    sa.grid_attention = sa.grid_attention_plain
    try:
        plain_row, plain, _ = _zero_thresholds(bf16=False)
    finally:
        sa.grid_attention = kernel
    agree, ok = _proposal_agreement(row, out, plain_row, plain, GRID_IOU)
    cmp = {"phase": "grid_f32_encode", **agree,
           "grid_launches": [launched, kernel.launches - before - launched]}
    emit(cmp)
    if not ok or cmp["grid_launches"] != [SAM_GLOBAL_LAYERS, 0]:
        raise AssertionError(f"the float32 grid kernel's encode departs from the plain one: {cmp}")


def _proposal_agreement(row, out, ref_row, ref, iou_limit):
    """One zero-threshold call (``_zero_thresholds``) against a reference
    call: ViT-H's embedding difference, the proposals' counts and their
    greedy matching by IoU → (fields, whether they agree: equal counts,
    every match at IoU >= ``iou_limit``, a finite difference)."""
    import numpy as np

    diff = (out["embedding"] - ref["embedding"]).abs().max().item()
    live, ref_live = row["bucket_live"], ref_row["bucket_live"]
    masks = out["bucket_masks"][:live].cpu().numpy().astype(bool)
    ref_masks = ref["bucket_masks"][:ref_live].cpu().numpy().astype(bool)
    matched = _greedy_match(_mask_iou(masks, ref_masks)) if live and ref_live else []
    worst = min((iou for _, _, iou in matched), default=None)
    fields = {"embedding_shape": list(out["embedding"].shape), "embedding_max_abs_diff": diff,
              "embedding_max_rel_diff": diff / ref["embedding"].abs().max().item(),
              "live_proposals": [row["live_proposals"], ref_row["live_proposals"]],
              "bucket_live": [live, ref_live], "min_matched_iou": worst,
              "iou_limit": iou_limit}
    ok = (live == ref_live and row["live_proposals"] == ref_row["live_proposals"]
          and worst is not None and worst >= iou_limit and bool(np.isfinite(diff)))
    return fields, ok


def phase_f32_windowed_path(state):
    """``phase_zero_thresholds``' float32 Matcher call with
    MARS_SAM_WINDOWED_IMPL=pallas alone, set for this run and restored after:
    ViT-H's 28 windowed layers on the float32 windowed kernel, its 4 global
    layers on the grid kernel as in the switch-off run.  Every kernel's count
    is set to 0 just before and read just after and must be one encode's
    exact count; ViT-H's embedding against the switch-off run's, and the
    proposals equal in count, each matched at IoU >= ``WINDOW_IOU``."""
    from mars_tpu_torch import cli

    off_row, off = state["zero_thresholds"]
    for fn in cli.KERNELS.values():
        fn.launches = 0
    with kernel_switches(WINDOWED_ONLY):
        row, out, _ = _zero_thresholds(bf16=False)
    launches = {name: fn.launches for name, fn in cli.KERNELS.items()}
    want = {**_matcher_launches(1), "attention_notap": 0}
    state["f32_windowed_launches"] = {"proposal_f32_windowed": launches}
    emit({**row, "switches": WINDOWED_ONLY})
    agree, ok = _proposal_agreement(row, out, off_row, off, WINDOW_IOU)
    cmp = {"phase": "f32_windowed_path", "switches": WINDOWED_ONLY, **agree,
           "proposal_ms": [row["ms"], off_row["ms"]], "launches": launches,
           "launches_expected": want}
    emit(cmp)
    if launches != want:
        raise AssertionError(f"float32 windowed path launches {launches}, expected {want}")
    if not ok:
        raise AssertionError(f"the float32 windowed kernel's encode departs from the plain "
                             f"route's: {cmp}")


@contextlib.contextmanager
def kernel_switches(values=SWITCHES):
    """Both kernel switches set to ``values`` (on: ``SWITCHES``), restored on
    the way out."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _alphaclip_chunks(live):
    return -(-min(live, 128) // ALPHACLIP_CHUNK)


def _ranking_launches(live):
    """Per-kernel launches of ranking episodes with ``live`` proposals each,
    both switches on."""
    return {"attention_with_tap": TAPPED_BLOCKS * len(live),
            "attention_notap": sum(RANKING_UNTAPPED + ALPHACLIP_BLOCKS * _alphaclip_chunks(n)
                                   for n in live),
            "grid_attention": 0, "windowed_attention": 0, "auction": 0}


def _matcher_launches(calls):
    return {"attention_with_tap": 0, "attention_notap": MATCHER_UNTAPPED * calls,
            "grid_attention": SAM_GLOBAL_LAYERS * calls,
            "windowed_attention": SAM_WINDOWED_LAYERS * calls, "auction": AUCTIONS * calls}


def _add(a, b):
    return {k: a[k] + b[k] for k in a}


def phase_bf16_path(state):
    """The production evaluation at production precision, both switches on
    for this phase only: the two programs (``cli_proposals --bf16`` into a
    temporary directory, then ``cli --bf16 --mask-proposals-path``), the
    inline ``cli --bf16 --generate-proposals``, and one zero-threshold
    Matcher call in bf16 with the ranking of its bucket.  Every kernel's
    count is set to 0 just before each run and read just after."""
    import math
    import tempfile

    import torch

    from mars_tpu_torch import cli, cli_proposals
    from mars_tpu_torch.core.episode import Proposals
    from mars_tpu_torch.data.synthetic import SyntheticFSS

    def start():
        torch.cuda.synchronize()
        for fn in cli.KERNELS.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in cli.KERNELS.items()}

    f32 = state.get("f32_masks") or []

    def iou_with_f32(preds):
        return [float(_mask_iou(p[None], f32[i][None])[0, 0]) if i < len(f32) else None
                for i, p in enumerate(preds)]

    rank_args = ["--bf16", "--gt-class-names", "--episodes", str(BF16_EPISODES),
                 "--proposal-bucket", "128", "--input-size", "518", "--seed", "0"]
    failures, by_path = [], {}

    def per_episode(run, res, want, **columns):
        """One row per episode: its launches against ``want(i)``, exactly."""
        for i, got in enumerate(res["episode_launches"]):
            row = {"phase": "bf16_path", "run": run, "episode": i,
                   **{k: v[i] for k, v in columns.items()}, "launches": got,
                   "launches_expected": want(i), "masks_binary": res.get("masks_binary"),
                   "peak_memory_gib": res["episode_peak_gib"][i]}
            emit(row)
            if got != row["launches_expected"]:
                failures.append((run, i, got, row["launches_expected"]))
        if not res.get("masks_binary", True) or not math.isfinite(res.get("miou", 0.0)):
            failures.append((run, "non-binary mask or non-finite mIoU"))

    with kernel_switches(), tempfile.TemporaryDirectory() as tmp:
        start()
        pres = cli_proposals.main(["--bf16", "--episodes", str(BF16_EPISODES), "--out", tmp,
                                   "--seed", "0"])
        per_episode("cli_proposals --bf16", pres, lambda i: _matcher_launches(1),
                    proposal_ms=pres["proposal_ms"], live_proposals=pres["live_proposals"],
                    file=sorted(os.listdir(tmp)))
        two_program = pres["launches"]

        start()
        res = cli.main(rank_args + ["--mask-proposals-path", tmp], keep_masks=True)
        live = res["live_proposals"]
        per_episode("cli --bf16 --mask-proposals-path", res,
                    lambda i: _ranking_launches([live[i]]), ranking_ms=res["episode_ms"],
                    live_proposals=live, iou_with_f32=iou_with_f32(res["masks"]))
        by_path["bf16_two_program"] = _add(two_program, res["launches"])

        start()
        res = cli.main(rank_args + ["--generate-proposals"], keep_masks=True)
        live = res["live_proposals"]
        per_episode("cli --bf16 --generate-proposals", res,
                    lambda i: _add(_matcher_launches(1), _ranking_launches([live[i]])),
                    proposal_ms=res["proposal_ms"], ranking_ms=res["episode_ms"],
                    live_proposals=live, iou_with_f32=iou_with_f32(res["masks"]))
        by_path["bf16_inline"] = res["launches"]

        start()
        row, out, ep = _zero_thresholds(bf16=True)
        got, want = launches(), _matcher_launches(1)
        failures += [] if got == want else [("zero_thresholds", got, want)]
        model = cli.build_model(cli.parse_args(["--input-size", "518", "--bf16",
                                                "--gt-class-names"]), torch.device("cuda"))
        rec = SyntheticFSS(seed=0)[0]
        start()
        t0 = time.perf_counter()
        merged = model.predict(ep, Proposals(out["bucket_masks"], out["bucket_valid"]),
                               class_name=rec.class_name).cpu()
        rank_ms = (time.perf_counter() - t0) * 1e3
        rank_got = launches()
        rank_want = _ranking_launches([row["bucket_live"]])
        row.update({"phase": "bf16_path", "run": "zero-threshold Matcher, then its ranking",
                    "launches": got, "launches_expected": want, "ranking_ms": rank_ms,
                    "ranking_launches": rank_got, "ranking_launches_expected": rank_want,
                    "merged_fg_pixels": int(merged.sum()),
                    "merged_binary": bool(((merged == 0) | (merged == 1)).all())})
        emit(row)
        failures += [] if rank_got == rank_want else [("zero_threshold_ranking", rank_got,
                                                       rank_want)]
        failures += [] if row["merged_binary"] else [("zero_threshold_ranking", "non-binary")]
        by_path["bf16_zero_thresholds"] = _add(got, rank_got)
    state["bf16_launches"] = by_path
    if failures:
        raise AssertionError(f"bf16 path failed: {failures}")


def phase_five_shot(state):
    """Five-shot episodes (``--nshot 5``: R = 5 x 1369 support rows in the
    Matcher, the supports as one batch of 5 in every tower): with both
    kernel switches on, ``cli_proposals --nshot 5 --bf16`` into a temporary
    directory and ``cli --nshot 5 --bf16 --mask-proposals-path`` on it;
    then one float32 ``cli --nshot 5 --generate-proposals`` episode on the
    default route.  Each run's launches are exact per kernel and episode
    (the supports batched: the one-shot counts)."""
    import math
    import tempfile

    import torch

    from mars_tpu_torch import cli, cli_proposals

    def start():
        torch.cuda.synchronize()
        for fn in cli.KERNELS.values():
            fn.launches = 0

    failures, by_path = [], {}

    def check(run, res, want, **columns):
        for i, got in enumerate(res["episode_launches"]):
            row = {"phase": "five_shot", "run": run, "episode": i,
                   **{k: v[i] for k, v in columns.items()}, "launches": got,
                   "launches_expected": want(i), "peak_memory_gib": res["episode_peak_gib"][i]}
            emit(row)
            if got != row["launches_expected"]:
                failures.append((run, i, got, row["launches_expected"]))
        if not res.get("masks_binary", True) or not math.isfinite(res.get("miou", 0.0)):
            failures.append((run, "non-binary mask or non-finite mIoU"))

    shots = ["--nshot", "5", "--episodes", str(FIVE_SHOT_EPISODES), "--input-size", "518",
             "--seed", "0"]
    with kernel_switches(), tempfile.TemporaryDirectory() as tmp:
        start()
        pres = cli_proposals.main(shots + ["--bf16", "--out", tmp])
        check("cli_proposals --nshot 5 --bf16", pres, lambda i: _matcher_launches(1),
              proposal_ms=pres["proposal_ms"], live_proposals=pres["live_proposals"])
        by_path["five_shot_proposals"] = pres["launches"]
        start()
        res = cli.main(shots + ["--bf16", "--gt-class-names", "--proposal-bucket", "128",
                                "--mask-proposals-path", tmp])
        live = res["live_proposals"]
        check("cli --nshot 5 --bf16 --mask-proposals-path", res,
              lambda i: _ranking_launches([live[i]]), ranking_ms=res["episode_ms"],
              live_proposals=live)
        by_path["five_shot_ranking"] = res["launches"]
    start()
    res = cli.main(["--nshot", "5", "--episodes", "1", "--input-size", "518", "--seed", "0",
                    "--gt-class-names", "--proposal-bucket", "128", "--generate-proposals"])
    check("cli --nshot 5 --generate-proposals (float32)", res,
          lambda i: {"attention_with_tap": TAPPED_BLOCKS, "attention_notap": 0,
                     "grid_attention": SAM_GLOBAL_LAYERS, "windowed_attention": 0,
                     "auction": AUCTIONS}, proposal_ms=res["proposal_ms"],
          ranking_ms=res["episode_ms"], live_proposals=res["live_proposals"])
    by_path["five_shot_inline_f32"] = res["launches"]
    state["five_shot_launches"] = by_path
    if failures:
        raise AssertionError(f"five-shot path failed: {failures}")


def _write_ranking_checkpoints(folder):
    """The ranking towers' seeded full-width weights (models.zoo without
    files) written as the reference's files: DINOv2-L reg4 as a state
    dict, CLIP-B/16 as a TorchScript archive (OpenAI's format), AlphaCLIP's
    base CLIP-L/14@336 bundle and its GRIT-20M visual override."""
    import numpy as np
    import torch

    from mars_tpu_torch.models import convert, zoo

    dev = torch.device("cuda")

    def save(sd, name):
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, os.path.join(folder, name))

    params, _ = zoo.build_dinov2(None, "vit_large", 4, 0, dev)
    save(convert.reference_state_dict(params, "dinov2"), "dinov2_vitl14_reg4_pretrain.pth")
    del params
    vp, tp, scale, _, _ = zoo.build_clip(None, "ViT-B/16", 1, dev)
    sd = {**convert.reference_state_dict(vp, "clip_visual"),
          **convert.reference_state_dict(tp, "clip_text"),
          "logit_scale": scale.cpu().numpy(), "input_resolution": np.asarray(224)}
    del vp, tp
    torch.jit.save(torch.jit.script(_module_tree(sd, buffers=("input_resolution",))),
                   os.path.join(folder, "ViT-B-16.pt"))
    vp, tp, scale, _, _ = zoo.build_alpha_clip(None, 2, dev)
    visual = convert.reference_state_dict(vp, "alpha_clip_visual")
    base = {k.replace("attn.in_proj.", "attn.in_proj_"): v for k, v in visual.items()
            if "conv1_alpha" not in k}
    save({**base, **convert.reference_state_dict(tp, "clip_text"),
          "logit_scale": scale.cpu().numpy()}, "ViT-L-14-336px.pt")
    save({k[len("visual."):]: v for k, v in visual.items()}, "clip_l14_336_grit_20m_4xe.pth")


def _module_tree(sd, buffers=()):
    """A scriptable module whose state dict is ``sd`` (nested submodules by
    the keys' dotted prefixes), as OpenAI's CLIP archives hold theirs."""
    import torch

    class Holder(torch.nn.Module):
        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return x

    root = Holder()
    for key, value in sd.items():
        *parts, leaf = key.split(".")
        mod = root
        for part in parts:
            if not hasattr(mod, part):
                mod.add_module(part, Holder())
            mod = getattr(mod, part)
        t = torch.from_numpy(value)
        if key in buffers:
            mod.register_buffer(leaf, t)
        else:
            mod.register_parameter(leaf, torch.nn.Parameter(t, requires_grad=False))
    return root


def phase_models_path(state):
    """``cli --models-path`` over the ranking towers' seeded weights written
    as the reference's files: every tower loads through the zoo's audited
    conversion, and the merged masks equal the in-memory main path's bit
    for bit."""
    import tempfile

    import numpy as np

    from mars_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _write_ranking_checkpoints(tmp)
        write_s = time.perf_counter() - t0
        files = {f: os.path.getsize(os.path.join(tmp, f)) for f in sorted(os.listdir(tmp))}
        for fn in cli.KERNELS.values():
            fn.launches = 0
        res = cli.main(MAIN_PATH_ARGS + ["--models-path", tmp], keep_masks=True)
    launches = {name: fn.launches for name, fn in cli.KERNELS.items()}
    want = state.get("main_path_masks") or []
    equal = len(want) == len(res["masks"]) == EPISODES and all(
        np.array_equal(a, b) for a, b in zip(res["masks"], want))
    state["models_path_launches"] = launches
    row = {"phase": "models_path", "files_bytes": files, "write_s": write_s,
           "episode_ms": res["episode_ms"], "masks_equal_in_memory": equal,
           "launches": launches, "launches_expected_tap": TAPPED_BLOCKS * EPISODES}
    emit(row)
    if not equal or launches["attention_with_tap"] != TAPPED_BLOCKS * EPISODES:
        raise AssertionError(f"--models-path run differs from the in-memory one: {row}")


def phase_backbones(state):
    """One float32 ranking episode at ``--dino-backbone vit_giant2`` (40
    blocks, the last 24 tapped, 24 heads) and one at ``--vta-backbone
    ViT-L/14`` (16 heads over 1370 tokens); the tap held against its plain
    version at every other backbone's shape."""
    import math

    import torch

    from mars_tpu_torch import cli

    gen = torch.Generator(device="cuda").manual_seed(1)
    state.setdefault("kernel_rows", []).extend(
        _tap_row(name, h, l, d, dtype, gen) for name, h, l, d in BACKBONE_GEOMETRIES
        for dtype in (torch.float32, torch.bfloat16))
    by_path, failures = {}, []
    for flags in (["--dino-backbone", "vit_giant2"], ["--vta-backbone", "ViT-L/14"]):
        for fn in cli.KERNELS.values():
            fn.launches = 0
        res = cli.main(["--episodes", "1", "--gt-class-names", "--proposal-bucket", "128",
                        "--input-size", "518", "--seed", "0"] + flags)
        launches = {name: fn.launches for name, fn in cli.KERNELS.items()}
        want = {name: TAPPED_BLOCKS if name == "attention_with_tap" else 0 for name in launches}
        row = {"phase": "backbones", "flags": flags, "ranking_ms": res["episode_ms"],
               "peak_memory_gib": res["episode_peak_gib"], "masks_binary": res["masks_binary"],
               "launches": launches, "launches_expected": want}
        emit(row)
        by_path[" ".join(flags)] = launches
        if launches != want or not res["masks_binary"] or not math.isfinite(res["miou"]):
            failures.append(row)
    state["backbone_launches"] = by_path
    if failures:
        raise AssertionError(f"backbone episodes failed: {failures}")


HAND_KERNEL = re.compile(r"\(anonymous namespace\)::(tap_out|tap_mean|notap|grid_f32|"
                         r"grid_bf16|windowed|auction_kernel|gemv_kernel|gemm_kernel|gemm_bf16)")


def _profile_summary(prof, span_prefixes):
    from torch.autograd import DeviceType

    def dev_us(e):
        return next((getattr(e, n) for n in ("self_device_time_total", "self_cuda_time_total")
                     if hasattr(e, n)), 0)

    # stage spans also appear as device-side annotations: they are spans
    # (first to last kernel of the stage), not kernels
    avg = prof.key_averages()
    device = [e for e in avg if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    kernels = sorted((e for e in device if not e.key.startswith(span_prefixes)),
                     key=lambda e: -dev_us(e))
    # the 15 busiest kernels, then the port's hand kernels below them
    top = kernels[:15] + [e for e in kernels[15:] if HAND_KERNEL.search(e.key)]
    return (sum(dev_us(e) for e in kernels) / 1e3, sum(e.count for e in kernels),
            {e.key: dev_us(e) / 1e3 for e in device if e.key.startswith(span_prefixes)},
            [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3, "count": e.count} for e in top])


def _profile_proposals(bf16, shots=1):
    """One proposal-plus-ranking episode of ``shots`` support shots (after
    a warm-up one) under torch.profiler: device time by ``matcher.*`` and
    ``mars.*`` span and by kernel, and the device's idle share of the
    episode's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars_tpu_torch import cli
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS

    dev = torch.device("cuda")
    args = cli.parse_args(["--input-size", "518", "--nshot", str(shots), "--gt-class-names"]
                          + (["--bf16"] if bf16 else []))
    model = cli.build_model(args, dev)
    generate = cli.make_inline_generator(args, (model.dino_params, model.dino_cfg), dev)
    rec = SyntheticFSS(seed=0, shot=shots)[0]
    ep = to_device_episode(rec, 518, shots, dev)

    def episode():
        props = generate(ep, cli.episode_generator(0, 0, dev))
        return model.predict(ep, props, class_name=rec.class_name).cpu()

    episode()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        episode()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, launches, spans, top = _profile_summary(prof, ("matcher.", "mars."))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": launches,
            "stage_device_span_ms": spans, "top_kernels": top}


def phase_profile_proposals(state):
    """The float32 proposal-plus-ranking episode with the switches off (the
    default route), then with MARS_SAM_WINDOWED_IMPL=pallas alone: the
    float32 windowed kernel's device time and launches."""
    for values in ({name: "xla" for name in WINDOWED_ONLY}, WINDOWED_ONLY):
        with kernel_switches(values):
            prof = _profile_proposals(bf16=False)
        windowed = [k for k in prof["top_kernels"] if "windowed" in k["name"]]
        emit({"phase": "profile_proposals", "switches": values, **prof,
              "windowed_device_ms": sum(k["device_ms"] for k in windowed),
              "windowed_launches": sum(k["count"] for k in windowed)})


def phase_profile_bf16(state):
    """The same in bf16, with both kernel switches on, then with both off."""
    for values in (SWITCHES, SWITCHES_OFF):
        with kernel_switches(values):
            emit({"phase": "profile_bf16", "switches": values, **_profile_proposals(bf16=True)})


def phase_profile_five_shot(state):
    """A five-shot bf16 proposal-plus-ranking episode, both switches on."""
    with kernel_switches():
        emit({"phase": "profile_five_shot", "switches": SWITCHES,
              **_profile_proposals(bf16=True, shots=5)})


def phase_profile(state):
    """One full-width episode (after a warm-up one) under torch.profiler:
    device time by stage span (``mars.*``) and by kernel, and the device's
    idle share of the episode's wall time (profiler on); with the notap
    switch off (the default route), then on (``NOTAP_ONLY``), each with the
    notap kernel's device time and launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars_tpu_torch import cli
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS

    dev = torch.device("cuda")
    model = cli.build_model(cli.parse_args(["--input-size", "518", "--gt-class-names"]), dev)
    rec = SyntheticFSS(seed=0)[0]
    ep = to_device_episode(rec, 518, 1, dev)
    props = cli.synthetic_proposals(rec, 518, 128, np.random.RandomState(0), dev)
    for values in ({name: "xla" for name in NOTAP_ONLY}, NOTAP_ONLY):
        with kernel_switches(values):
            model.predict(ep, props, class_name=rec.class_name)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.predict(ep, props, class_name=rec.class_name)
                wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, launches, spans, top = _profile_summary(prof, ("mars.",))
        notap = [k for k in top if "notap" in k["name"]]
        tap = [k for k in top if re.search(r"::tap_(out|mean)_", k["name"])]
        emit({"phase": "profile", "switches": values, "wall_ms": wall_ms,
              "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
              "kernel_launches": launches,
              "notap_device_ms": sum(k["device_ms"] for k in notap),
              "notap_launches": sum(k["count"] for k in notap),
              "tap_device_ms": {k["name"]: k["device_ms"] for k in tap},
              "tap_launches": sum(k["count"] for k in tap),
              "stage_device_span_ms": spans, "top_kernels": top})


def _bound_ms(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_4bit_kernels(state):
    """Both 4-bit kernels against their plain versions at the 7B's shapes,
    bfloat16 activations, timed with CUDA events beside the bound and the
    dense GEMM they replace (cuBLAS on the pre-dequantized bf16 weight):
    warm (``ms``: 20 calls on one weight, which the L2 may hold) and, for
    the decode rows, device-held (``held_ms``, ``library_held_ms``: the same
    calls, which the host no longer paces) and cold (``cold_ms``,
    ``library_cold_ms``: held, the calls rotating through copies of the
    weight totalling >= 100 MB, as a decode step finds its 32 layers'
    weights)."""
    import torch

    from mars_tpu_torch.models import quantization as Q
    from mars_tpu_torch.ops import int4_matmul as im

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for fmt in ("int4", "nf4"):
        fn, plain = ((im.matmul_int4, im.matmul_int4_plain) if fmt == "int4"
                     else (im.matmul_nf4, im.matmul_nf4_plain))
        for name, din, dout in QUANT_SHAPES:
            if fmt == "int4":
                q = torch.randint(-7, 8, (din, dout), generator=gen, device="cuda",
                                  dtype=torch.int8)
                leaf = {"q4": im.pack_int4(q), "scale": torch.rand(
                    (dout,), generator=gen, device="cuda") * 0.1 + 0.01}
                packed, scale = leaf["q4"], leaf["scale"]
            else:
                leaf = Q.quantize_kernel_nf4(torch.randn((din, dout), generator=gen,
                                                         device="cuda"))
                packed, scale = leaf["nf4"], leaf["bscale"]
            dense = Q.dequantize_kernel(leaf).to(torch.bfloat16)
            weights, denses = cold_copies((packed, scale)), cold_copies((dense,))
            for m in QUANT_ROWS + (VERIFY_ROWS if name in VERIFY_SHAPES else ()):
                x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                got, want = fn(x, packed, scale), plain(x, packed, scale)
                rerun_equal = bool(torch.equal(got, fn(x, packed, scale)))
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                tol = QUANT_REL_TOL * want.float().abs().max().item()
                nbytes = (x.numel() * 2 + packed.numel() + scale.numel() * 4 + m * dout * 2)
                bound, by = _bound_ms(nbytes, 2.0 * m * din * dout)
                row = {"phase": "kernel", "kernel": f"matmul_{fmt}", "geometry": name,
                       "shape": [m, din, dout], "dtype": "bfloat16", "max_abs_err": err,
                       "tol": tol, "finite": bool(torch.isfinite(got.float()).all()),
                       "rerun_equal": rerun_equal,
                       "ms": cuda_ms(lambda: fn(x, packed, scale)),
                       "plain_ms": cuda_ms(lambda: plain(x, packed, scale), iters=5),
                       "library_ms": cuda_ms(lambda: x @ dense),
                       "library_call": "cuBLAS x @ W, W the pre-dequantized bf16 weight (the "
                                       "dense GEMM the kernel replaces)",
                       "bound_ms": bound, "bound_by": by}
                if m <= 8:
                    row["held_ms"] = held_ms(lambda: fn(x, packed, scale))
                    row["cold_ms"] = cold_ms(lambda p, s: fn(x, p, s), weights)
                    row["library_held_ms"] = held_ms(lambda: x @ dense)
                    row["library_cold_ms"] = cold_ms(lambda w: x @ w, denses)
                    row["cold_copies_mb"] = len(weights) * (packed.numel()
                                                            + scale.numel() * 4) / 1e6
                emit(row)
                rows.append(row)
                if err > tol or not row["finite"] or not rerun_equal:
                    raise AssertionError(f"matmul_{fmt} disagrees with its plain version: {row}")
            del dense, weights, denses
    state["quant_rows"] = rows


class StandInTokenizer:
    """eos 2; ``decode`` records every row it is handed (the retriever cuts
    each row at its first EOS), from which the decode's steps follow."""
    eos_token_id = 2

    def __init__(self):
        self.rows = []

    def decode(self, toks, skip_special_tokens=True):
        self.rows.append([int(t) for t in toks])
        return " ".join(str(t) for t in self.rows[-1])


class StandInProcessor:
    """The processor's place in the script (the LLaMA tokenizer and the HF
    image processor are not in the repository): ``<image>`` becomes the
    tower's 576 image slots, text one id per 4 characters (a newline its own
    id, so "Human: <image>\\n" is a token prefix of every prompt), pixels
    the image brought to the tower's 336² (bilinear) over 255."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.tokenizer = StandInTokenizer()

    @staticmethod
    def _ids(text):
        import re

        out = []
        for piece in re.split(r"(\n)", text):
            for i in range(0, len(piece), 4):
                out.append(3 + int.from_bytes(piece[i:i + 4].encode(), "little") % 31990)
        return out

    def __call__(self, text, images, return_tensors="np"):
        import numpy as np

        import torch
        import torch.nn.functional as F

        g = (self.cfg.image_size // self.cfg.patch_size) ** 2
        left, _, right = text.partition("<image>")
        ids = [1] + self._ids(left) + [self.cfg.image_token_index] * g + self._ids(right)
        pix = np.asarray(images, np.float32)[None].transpose(0, 3, 1, 2) / 255.0
        if pix.shape[2:] != (self.cfg.image_size,) * 2:
            pix = F.interpolate(torch.from_numpy(pix), size=(self.cfg.image_size,) * 2,
                                mode="bilinear", align_corners=False).numpy()
        return {"input_ids": np.asarray([ids], np.int64), "pixel_values": pix}


def _decode_forwards(rows, budget):
    """LLaMA forwards of one EOS-path decode: the suffix forward, then one
    step per slot until every row has emitted EOS or the budget is spent
    (a row cut shorter than the budget ended at EOS)."""
    last = max((len(r) if len(r) < budget else budget - 1) for r in rows)
    return 1 + min(last, budget - 1)


def _text_block(vlm, images):
    """One BlockTextStage-shaped block: names (max 20), then definitions
    (max 50, min 20) of the named objects on the same images."""
    from mars_tpu_torch.text.prompts import (VISUAL_PROMPTS, VISUAL_PROMPTS_DESCRIPTIONS,
                                             VLM_SYSTEM_TEMPLATE)

    q = VLM_SYSTEM_TEMPLATE.format(VISUAL_PROMPTS["contour"].format("red"))
    names = vlm.generate_batch(images, [q] * len(images), max_new_tokens=20,
                               shared_prefix=TEXT_PREFIX)
    defs = vlm.generate_batch(
        images, [VLM_SYSTEM_TEMPLATE.format(VISUAL_PROMPTS_DESCRIPTIONS["contour"].format(n, "red"))
                 for n in names], max_new_tokens=50, min_new_tokens=20, shared_prefix=TEXT_PREFIX)
    return names, defs


def _first_logits(params, cfg, proc, image):
    """The last position's logits of LOGITS_PROMPT's first forward through
    the 4-bit kernels and through their plain versions (the wrappers
    swapped in this script only): the largest difference against a tenth
    of the largest logit, argmax, finiteness."""
    import numpy as np
    import torch

    from mars_tpu_torch.models import vip_llava as vl
    from mars_tpu_torch.ops import int4_matmul as im

    inputs = proc(LOGITS_PROMPT, image)
    ids_t = torch.from_numpy(inputs["input_ids"]).cuda()
    pix_t = torch.from_numpy(np.ascontiguousarray(
        inputs["pixel_values"].transpose(0, 2, 3, 1))).cuda()
    got = vl.forward_logits(params, ids_t, pix_t, cfg)[0, -1].float()
    swapped = im.matmul_int4, im.matmul_nf4
    im.matmul_int4, im.matmul_nf4 = im.matmul_int4_plain, im.matmul_nf4_plain
    try:
        plain = vl.forward_logits(params, ids_t, pix_t, cfg)[0, -1].float()
    finally:
        im.matmul_int4, im.matmul_nf4 = swapped
    err = (got - plain).abs().max().item()
    top = plain.abs().max().item()
    return {"first_logits_max_abs_err": err, "first_logits_max_abs": top,
            "first_logits_tol": 0.1 * top,
            "first_argmax_equal": int(got.argmax()) == int(plain.argmax()),
            "first_logits_ok": err <= 0.1 * top and bool(torch.isfinite(got).all())}


def phase_text_path(state):
    """ViP-LLaVA-7B at full width, int4 then NF4: one text block through
    ``TorchVipLlava.generate_batch`` with the kernels' counts set to 0 just
    before and read just after, checked against the count the decode's
    token trace implies; then the first forward's logits, kernel path
    against the plain path (the wrappers swapped for their plain versions
    in this script only)."""
    import numpy as np
    import torch

    from mars_tpu_torch.models import vip_llava as vl, zoo
    from mars_tpu_torch.ops import int4_matmul as im
    from mars_tpu_torch.text.retriever import TorchVipLlava

    torch.cuda.empty_cache()
    rs = np.random.RandomState(0)
    launches_by_fmt = {}
    for fmt in ("affine", "nf4"):
        params, cfg = zoo.build_vip_llava(0, 4, fmt)
        proc = StandInProcessor(cfg)
        vlm = TorchVipLlava(params=params, cfg=cfg, processor=proc, draft_tokens=0)
        images = [(rs.rand(cfg.image_size, cfg.image_size, 3) * 255).astype(np.uint8)
                  for _ in range(TEXT_ROWS)]
        real_prefill, prefill_ms = vl.prefill_prefix, []

        def timed_prefill(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_prefill(*a, **k)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        vl.prefill_prefix = timed_prefill
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        im.matmul_int4.launches = im.matmul_nf4.launches = 0
        try:
            t0 = time.perf_counter()
            names, defs = _text_block(vlm, images)
            torch.cuda.synchronize()
            block_ms = (time.perf_counter() - t0) * 1e3
        finally:
            vl.prefill_prefix = real_prefill
        launches = {"matmul_int4": im.matmul_int4.launches, "matmul_nf4": im.matmul_nf4.launches}
        name_rows, def_rows = proc.tokenizer.rows[:TEXT_ROWS], proc.tokenizer.rows[TEXT_ROWS:]
        forwards = 1 + _decode_forwards(name_rows, 20) + _decode_forwards(def_rows, 50)
        want = VISION_DENSES + LLAMA_DENSES * forwards
        kernel = "matmul_int4" if fmt == "affine" else "matmul_nf4"
        tokens = sum(len(r) for r in name_rows + def_rows)
        decode_ms = block_ms - sum(prefill_ms)
        row = {"phase": "text_path", "format": fmt, "rows": TEXT_ROWS,
               "prefill_calls": len(prefill_ms), "prefill_ms": prefill_ms,
               "block_ms": block_ms, "llama_forwards": forwards,
               "decode_ms_per_step": decode_ms / (forwards - 1),
               "tokens": tokens, "tokens_per_s": tokens / block_ms * 1e3,
               "decode_tokens_per_s": tokens / decode_ms * 1e3,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launches, "launches_expected": {kernel: want},
               "name_lengths": [len(r) for r in name_rows],
               "definition_lengths": [len(r) for r in def_rows],
               "first_name": names[0][:60]}
        launches_by_fmt[kernel] = launches[kernel]

        logits = _first_logits(params, cfg, proc, images[0])
        row.update(logits)
        emit(row)
        ok = (launches[kernel] == want and sum(launches.values()) == want
              and len(prefill_ms) == 1 and logits["first_logits_ok"]
              and len(names) == len(defs) == TEXT_ROWS)
        del vlm, params
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"text path ({fmt}) failed: {row}")
    state["text_launches"] = launches_by_fmt



def phase_profile_text(state):
    """One int4 text block (fresh images, so the prefix is prefilled) under
    torch.profiler: device time by kernel and the idle share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.text.retriever import TorchVipLlava

    params, cfg = zoo.build_vip_llava(0, 4, "affine")
    vlm = TorchVipLlava(params=params, cfg=cfg, processor=StandInProcessor(cfg), draft_tokens=0)
    rs = np.random.RandomState(1)
    images = [(rs.rand(cfg.image_size, cfg.image_size, 3) * 255).astype(np.uint8)
              for _ in range(TEXT_ROWS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _text_block(vlm, images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, launches, _, top = _profile_summary(prof, ())
    emit({"phase": "profile_text", "format": "affine", "wall_ms": wall_ms,
          "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
          "kernel_launches": launches, "top_kernels": top})
    del vlm, params
    torch.cuda.empty_cache()


def _seeded_retriever(args):
    """``cli.build_retriever``'s place in the script: ViP-LLaVA-7B on seeded
    random weights in the format of ``--vlm4bit`` / ``--vlm4bit-nf4`` on
    ``--device``, the stand-in processor, speculation and prompts as the
    flags say."""
    from mars_tpu_torch import cli
    from mars_tpu_torch import device as device_lib
    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.text import retriever as R

    params, cfg = zoo.build_vip_llava(0, 4, "nf4" if args.vlm4bit_nf4 else "affine",
                                      device=device_lib.resolve(args.device))
    vlm = R.TorchVipLlava(args.vlm_path, params=params, cfg=cfg, processor=StandInProcessor(cfg),
                          draft_tokens=args.vlm_draft_tokens,
                          kv_bits=8 if args.vlm_kv8 else None)
    gen_cfg, ensemble = cli.retriever_configs(args)
    return R.TextRetriever(vlm, gen_cfg=gen_cfg, ensemble=ensemble)


def _plain_splits(vlm, calls):
    """Rerun each recorded ``generate_batch`` call with speculation off and
    the plain steps' logits watched; → (rows compared, rows that split,
    largest top-two gap / |top-1| at a split)."""
    import torch

    from mars_tpu_torch.models import vip_llava as vl
    from mars_tpu_torch.text.retriever import TorchVipLlava

    rows = splits = 0
    worst = 0.0
    draft, vlm.draft_tokens = vlm.draft_tokens, 0
    argmax, generate = vl._argmax_first, vl.generate_greedy
    tops, starts = [], []

    def watched_argmax(x):  # every token choice of a plain decode
        tops.append(torch.topk(x.float(), 2, dim=-1).values.cpu())
        return argmax(x)

    def watched_generate(*a, **kw):  # one call a chunk of rows
        starts.append(len(tops))
        return generate(*a, **kw)

    vl._argmax_first, vl.generate_greedy = watched_argmax, watched_generate
    try:
        for images, prompts, kw, spec_out in list(calls):
            tops.clear()
            starts.clear()
            decoded = len(vlm.processor.tokenizer.rows)
            TorchVipLlava.generate_batch(vlm, images, prompts, **kw)  # not the recorder
            plain_rows = vlm.processor.tokenizer.rows[decoded:]
            spec_rows = [r for r in spec_out]
            # chunk c holds rows [c * chunk, (c + 1) * chunk); its token
            # choices start at starts[c]
            for r, (want, got) in enumerate(zip(plain_rows, spec_rows)):
                rows += 1
                if want == got:
                    continue
                splits += 1
                t = next(j for j in range(min(len(want), len(got)) + 1)
                         if j >= min(len(want), len(got)) or want[j] != got[j])
                chunk = vlm.MAX_PREFIX_BATCH if kw.get("shared_prefix") else vlm.MAX_DECODE_BATCH
                step = tops[starts[r // chunk] + t][r % chunk]
                worst = max(worst, float(step[0] - step[1]) / max(abs(float(step[0])), 1e-30))
    finally:
        vl._argmax_first, vl.generate_greedy = argmax, generate
        vlm.draft_tokens = draft
    return rows, splits, worst


def phase_text_cli(state):
    """``cli.main`` without --gt-class-names at full width: the ranking
    towers as in the main path, ViP-LLaVA-7B (seeded random weights, bf16,
    through ``cli.build_retriever``'s place) naming the class with
    prompt-lookup speculation at JAX's defaults, WordNet on the mini tree of
    tests/nltk_minicorpus.py through --nltk-path.  One block at the default
    depth in int4, then in NF4, then two episodes with --pipelined-text;
    every count set to 0 just before each run and read just after: the
    4-bit launches (GEMV and GEMM) equal 146 per vision call + 224 per LLaMA
    forward as the decode loop counts them; each block's speculative
    streams against the same requests decoded plainly."""
    import gc
    import math
    import tempfile

    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.models import vip_llava as vl
    from mars_tpu_torch.ops import int4_matmul as im

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from nltk_minicorpus import ensure_minicorpus

    nltk_root = ensure_minicorpus(tempfile.mkdtemp(prefix="nltk_mini_"))
    runs = (("int4", ["--vlm4bit"], TEXT_CLI_EPISODES),
            ("nf4", ["--vlm4bit", "--vlm4bit-nf4"], TEXT_CLI_EPISODES),
            ("int4_pipelined", ["--vlm4bit", "--pipelined-text"], PIPELINED_EPISODES))
    real_build, launches_by_fmt, failures = cli.build_retriever, {}, []
    for label, flags, episodes in runs:
        made, calls = {}, []

        def build(args):
            r = _seeded_retriever(args)
            made["vlm"] = vlm = r.vlm
            batch = vlm.generate_batch

            def recorded(images, prompts, **kw):
                out = batch(images, prompts, **kw)
                calls.append((images, prompts, kw, vlm.processor.tokenizer.rows[-len(images):]))
                return out

            vlm.generate_batch = recorded
            return r

        cli.build_retriever = build
        m_rows, launch = [], im._launch

        def logged(fmt, x, *a):  # the rows of each 4-bit launch: GEMV or GEMM
            m_rows.append(x.shape[0])
            return launch(fmt, x, *a)

        im._launch = logged
        for fn in list(cli.KERNELS.values()) + list(cli.TEXT_KERNELS.values()):
            fn.launches = 0
        for k in vl.STATS:
            vl.STATS[k] = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            res = cli.main(TEXT_CLI_ARGS + ["--episodes", str(episodes), "--nltk-path", nltk_root]
                           + flags)
        finally:
            cli.build_retriever, im._launch = real_build, launch
        counts = res["text_counts"]
        gemv = sum(m <= im.GEMV_MAX_ROWS for m in m_rows)
        kernel = "matmul_nf4" if label == "nf4" else "matmul_int4"
        want = VISION_DENSES * counts["vision"] + LLAMA_DENSES * counts["forwards"]
        tap_want = TAPPED_BLOCKS * episodes
        rows, splits, worst = (_plain_splits(made["vlm"], calls) if episodes > 2
                               else (None, None, None))
        row = {"phase": "text_cli", "run": label, "episodes": episodes,
               "text_ms": res["text_ms"], "ranking_ms": res["episode_ms"],
               "names": [n[:40] for n in res["names"]], "definitions": res["descriptions"],
               "vlm_calls": len(calls), "vision_calls": counts["vision"],
               "llama_forwards": counts["forwards"], "spec_rounds": counts["rounds"],
               "verify_rounds": counts["verify_rounds"], "accepted_drafts": counts["accepted"],
               "gemv_launches": gemv, "gemm_launches": len(m_rows) - gemv,
               "launches": {k: counts[k] for k in cli.TEXT_KERNELS},
               "launches_expected": {kernel: want},
               "tap_launches": res["launches"]["attention_with_tap"], "tap_expected": tap_want,
               "rows_compared": rows, "rows_split": splits, "max_split_rel_gap": worst,
               "split_limit": SPLIT_REL_GAP,
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "miou": res["miou"], "masks_binary": res["masks_binary"]}
        emit(row)
        launches_by_fmt[f"cli_{label}"] = counts[kernel]
        ok = (counts[kernel] == want and len(m_rows) == want
              and sum(counts[k] for k in cli.TEXT_KERNELS) == want
              and res["launches"]["attention_with_tap"] == tap_want
              and len(res["names"]) == episodes and res["masks_binary"]
              and math.isfinite(res["miou"]) and (worst is None or worst < SPLIT_REL_GAP))
        if not ok:
            failures.append(label)
        del made, calls
        gc.collect()  # the recorded wrapper and the model hold each other
    state["text_cli_launches"] = launches_by_fmt
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"text CLI runs failed: {failures}")


def _trees_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _trees_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a, b))


def _recording_decode(tokenizer):
    """Record every row ``decode`` is handed (the retriever cuts each row
    at its first EOS) → the list it appends to."""
    rows, decode = [], tokenizer.decode

    def recorded(ids, skip_special_tokens=False):
        rows.append([int(i) for i in ids])
        return decode(ids, skip_special_tokens=skip_special_tokens)

    tokenizer.decode = recorded
    return rows


def phase_text_files(state):
    """ViP-LLaVA-7B from its files: a directory in the release's layout
    written by tests/vip_llava_files.py at full width (CLIP-L/14@336 with
    its 24 layers, LLaMA at hidden 4096, MLP 11008, 32 heads, vocabulary
    32 064), the LLaMA cut to TEXT_FILES_LAYERS of its 32 layers: seeded
    bf16 weights under the release's names in 1 GB shards with their index,
    a seeded legacy tokenizer.json (the byte pieces, then pieces and merges
    up to id 31 999; <image> 32000, <pad> 32001), CLIP's preprocessor at 336
    and processor_config.json.  ``TorchVipLlava(dir)`` in int4, then NF4,
    answers one BlockTextStage-shaped block of TEXT_ROWS 518² images, the
    counts set to 0 just before and read just after: the 4-bit launches
    equal 146 per vision call + 7 per LLaMA layer per forward as the token
    trace implies; the loaded tree, the greedy tokens and the answers equal
    those of the same arrays passed as ``params=`` through ``convert_hf``
    with the same quantization and the loaded processor; the first
    forward's logits through the kernel and the plain version.  Then one
    episode of ``cli.main --vlm-path dir --vlm4bit`` without
    --gt-class-names.  Load seconds, peak device memory, tokens a second."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.data.coco import COCO_CLASS_NAMES
    from mars_tpu_torch.models import vip_llava as vl, zoo
    from mars_tpu_torch.ops import int4_matmul as im
    from mars_tpu_torch.text.prompts import VISUAL_PROMPTS, VISUAL_PROMPTS_DESCRIPTIONS
    from mars_tpu_torch.text.retriever import TorchVipLlava

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from nltk_minicorpus import ensure_minicorpus
    from vip_llava_files import random_state_dict, tokenizer_spec, write_vip_llava_dir

    cfg = dataclasses.replace(vl.VipLlavaConfig(), layers=TEXT_FILES_LAYERS)
    llama_denses = 7 * TEXT_FILES_LAYERS
    corpus = list(VISUAL_PROMPTS.values()) + list(VISUAL_PROMPTS_DESCRIPTIONS.values()) + list(
        COCO_CLASS_NAMES)
    tmp = tempfile.mkdtemp(prefix="vip_llava_files_")
    failures, launches_by_fmt = [], {}
    try:
        path = os.path.join(tmp, "vip-llava-7b-hf")
        t0 = time.perf_counter()
        tensors = random_state_dict(cfg, seed=11, dtype=torch.bfloat16, device="cuda")
        spec = tokenizer_spec(32000, seed=0, form="legacy", corpus=corpus)
        spec_s = time.perf_counter() - t0
        write_vip_llava_dir(path, cfg, tensors, spec, TEXT_FILES_SHARD_BYTES)
        write_s = time.perf_counter() - t0 - spec_s
        # the params= route: the same arrays through convert_hf, float32 on the card
        t0 = time.perf_counter()
        ref_tree = vl.convert_hf({zoo.vip_llava_key(k): v.float().cpu().numpy()
                                  for k, v in tensors.items()}, cfg, "cuda")
        convert_s = time.perf_counter() - t0
        file_bytes = sum(t.numel() * t.element_size() for t in tensors.values())
        del tensors
        rs = np.random.RandomState(2)
        images = [rs.randint(0, 256, (TEXT_FILES_IMAGE, TEXT_FILES_IMAGE, 3)).astype(np.uint8)
                  for _ in range(TEXT_ROWS)]
        for fmt in ("affine", "nf4"):
            kernel = "matmul_int4" if fmt == "affine" else "matmul_nf4"
            kw = dict(dtype=torch.bfloat16, quantize_bits=4, int4_format=fmt, draft_tokens=0)
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # the params= route's tree
            t0 = time.perf_counter()
            vlm = TorchVipLlava(path, **kw)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            load_peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
            model_gib = (torch.cuda.memory_allocated() - held) / 2 ** 30
            rows = _recording_decode(vlm.processor.tokenizer)
            im.matmul_int4.launches = im.matmul_nf4.launches = 0
            for k in vl.STATS:
                vl.STATS[k] = 0
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            names, defs = _text_block(vlm, images)
            torch.cuda.synchronize()
            block_ms = (time.perf_counter() - t0) * 1e3
            launches = {"matmul_int4": im.matmul_int4.launches,
                        "matmul_nf4": im.matmul_nf4.launches}
            stats = dict(vl.STATS)
            name_rows, def_rows = rows[:TEXT_ROWS], rows[TEXT_ROWS:]
            forwards = 1 + _decode_forwards(name_rows, 20) + _decode_forwards(def_rows, 50)
            want = VISION_DENSES + llama_denses * forwards
            tokens = sum(len(r) for r in rows)
            row = {"phase": "text_files", "format": fmt, "rows": TEXT_ROWS,
                   "llama_layers": TEXT_FILES_LAYERS, "checkpoint_gb": file_bytes / 1e9,
                   "spec_s": spec_s, "write_s": write_s, "convert_hf_s": convert_s,
                   "load_s": load_s, "load_peak_memory_gib": load_peak,
                   "model_memory_gib": model_gib, "block_ms": block_ms, "tokens": tokens,
                   "tokens_per_s": tokens / block_ms * 1e3,
                   "block_peak_memory_gib": (torch.cuda.max_memory_allocated() - held) / 2 ** 30,
                   "vision_calls": stats["vision"], "llama_forwards": stats["forwards"],
                   "forwards_from_tokens": forwards, "launches": launches,
                   "launches_expected": {kernel: want},
                   "name_lengths": [len(r) for r in name_rows],
                   "definition_lengths": [len(r) for r in def_rows],
                   "first_name": names[0][:60]}
            row.update(_first_logits(vlm.params, vlm.cfg, vlm.processor, images[0]))
            launches_by_fmt[kernel] = {"text_files": launches[kernel]}

            ref = TorchVipLlava(params=ref_tree, cfg=cfg, processor=vlm.processor, **kw)
            same_tree = _trees_equal(vlm.params, ref.params)
            decoded = len(rows)
            ref_names, ref_defs = _text_block(ref, images)
            row.update({"tree_equal_params_route": same_tree,
                        "tokens_equal_params_route": rows[decoded:] == rows[:decoded],
                        "answers_equal_params_route": (ref_names, ref_defs) == (names, defs)})
            emit(row)
            ok = (launches[kernel] == want and sum(launches.values()) == want
                  and stats["vision"] == 1 and stats["forwards"] == forwards
                  and row["first_logits_ok"] and same_tree and row["tokens_equal_params_route"]
                  and row["answers_equal_params_route"] and len(names) == len(defs) == TEXT_ROWS)
            if not ok:
                failures.append(fmt)
            del vlm, ref
            torch.cuda.empty_cache()
        del ref_tree

        nltk_root = ensure_minicorpus(os.path.join(tmp, "nltk"))
        for fn in list(cli.KERNELS.values()) + list(cli.TEXT_KERNELS.values()):
            fn.launches = 0
        for k in vl.STATS:
            vl.STATS[k] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = cli.main(TEXT_CLI_ARGS + ["--episodes", "1", "--nltk-path", nltk_root,
                                        "--vlm-path", path, "--vlm4bit"])
        cli_s = time.perf_counter() - t0
        counts = res["text_counts"]
        want = VISION_DENSES * counts["vision"] + llama_denses * counts["forwards"]
        row = {"phase": "text_files_cli", "episodes": 1, "wall_s": cli_s,
               "text_ms": res["text_ms"], "names": [n[:40] for n in res["names"]],
               "definitions": res["descriptions"], "vision_calls": counts["vision"],
               "llama_forwards": counts["forwards"],
               "launches": {k: counts[k] for k in cli.TEXT_KERNELS},
               "launches_expected": {"matmul_int4": want},
               "tap_launches": res["launches"]["attention_with_tap"],
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "miou": res["miou"], "masks_binary": res["masks_binary"]}
        emit(row)
        launches_by_fmt.setdefault("matmul_int4", {})["cli_files"] = counts["matmul_int4"]
        if not (counts["matmul_int4"] == want and counts["matmul_nf4"] == 0 and want > 0
                and res["launches"]["attention_with_tap"] == TAPPED_BLOCKS
                and len(res["names"]) == 1 and res["masks_binary"]
                and math.isfinite(res["miou"])):
            failures.append("cli")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    state["text_files_launches"] = launches_by_fmt
    if failures:
        raise AssertionError(f"text files phase failed: {failures}")


class _Interrupted(RuntimeError):
    """The fold run's deliberate crash inside a ranking."""


def _fold_files(log):
    """A fold's on-disk results: scalars.csv by (tag, step) (a resumed
    run's repeated steps take the later value), ranking_time.csv's
    (idx, n_proposals) rows, each event file's record count (every record
    passes its CRCs: ``tboard.read_records`` raises otherwise) and
    log.txt's known-bad line."""
    import csv

    from mars_tpu_torch.utils import tboard

    with open(os.path.join(log, "scalars.csv")) as f:
        scalars = {(r[1], int(r[0])): float(r[2]) for r in csv.reader(f)
                   if r[1] in ("test_mIoU", "test_FB-IoU")}
    with open(os.path.join(log, "ranking_time.csv")) as f:
        rows = [(int(r[0]), int(r[3])) for r in list(csv.reader(f))[1:]]
    runs = os.path.join(log, "tbd", "runs")
    events = {name: len(tboard.read_records(os.path.join(runs, name)))
              for name in sorted(os.listdir(runs))}
    with open(os.path.join(log, "log.txt")) as f:
        bad = [ln.split(" ", 2)[2] for ln in f.read().splitlines() if "known-bad subset" in ln]
    return {"scalars": scalars, "rows": rows, "events": events, "bad_line": bad}


def phase_fold_run(state):
    """The fold run as the repository's evaluation script drives it, at
    full width on seeded random weights: the proposal CLI's --use-centers,
    --coco-rle and --visualize with both switches on, then the ranking CLI
    four times (overlap 0, overlap 2, interrupted, resumed) on the default
    route, then --visualize 2.  Every kernel's count is set to 0 just before
    each run and read just after."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from mars_tpu_torch import cli, cli_proposals
    from mars_tpu_torch.core import rle
    from mars_tpu_torch.pipeline import mars as mars_lib
    from mars_tpu_torch.utils import visualize

    def start():
        torch.cuda.synchronize()
        for fn in cli.KERNELS.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in cli.KERNELS.items()}

    failures, by_path = [], {}
    tap_only = {name: TAPPED_BLOCKS if name == "attention_with_tap" else 0
                for name in cli.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        # a. the proposal CLI, both switches on; then the port's RLE on live masks
        props_dir = os.path.join(tmp, "props")
        with kernel_switches():
            start()
            pres = cli_proposals.main(["--bf16", "--use-centers", "--coco-rle", "--visualize",
                                       str(FOLD_PROPOSAL_EPISODES), "--episodes",
                                       str(FOLD_PROPOSAL_EPISODES), "--out", props_dir,
                                       "--seed", "0"])
        by_path["fold_cli_proposals_centres"] = launches()
        want = _matcher_launches(1)
        bad_eps = [i for i, got in enumerate(pres["episode_launches"]) if got != want]
        rle_files = sorted(f for f in os.listdir(props_dir) if f.endswith(".json"))
        rle_records = []
        for f in rle_files:
            with open(os.path.join(props_dir, f)) as fh:
                rle_records.append(len(json.load(fh)))
        pngs = sorted(os.listdir(os.path.join(props_dir, "viz")))
        for f in pngs:
            visualize.read_png(os.path.join(props_dir, "viz", f))  # raises unless it decodes
        _, zero = state["zero_thresholds"]
        live = zero["proposal_masks"][zero["proposal_valid"]].cpu().numpy()
        round_trip = [bool(np.array_equal(rle.rle_decode(rle.rle_encode_compressed(m)), m))
                      for m in live]
        row = {"phase": "fold_run", "run": "cli_proposals --bf16 --use-centers --coco-rle",
               "proposal_ms": pres["proposal_ms"], "live_proposals": pres["live_proposals"],
               "episode_launches": pres["episode_launches"], "launches_expected": want,
               "rle_files": rle_files, "rle_records": rle_records, "pngs": pngs,
               "zero_threshold_masks_round_trip": f"{sum(round_trip)}/{len(round_trip)}"}
        emit(row)
        if bad_eps or len(rle_files) != FOLD_PROPOSAL_EPISODES or rle_records != \
                pres["live_proposals"]:
            failures.append(("cli_proposals", bad_eps, rle_files, rle_records))
        if len(pngs) != FOLD_PROPOSAL_EPISODES or not round_trip or not all(round_trip):
            failures.append(("cli_proposals figures or RLE round trip", pngs, row[
                "zero_threshold_masks_round_trip"]))

        # b. the ranking CLI four times
        bad_path = os.path.join(tmp, "bad.txt")
        with open(bad_path, "w") as f:
            f.write("\n".join(str(i) for i in FOLD_BAD) + "\n")

        def run(name, log, extra):
            start()
            res = cli.main(FOLD_ARGS + ["--log-path", os.path.join(tmp, log),
                                        "--bad-preds-path", bad_path] + extra, keep_masks=True)
            by_path[f"fold_{name}"] = launches()
            return res

        runs = {"overlap_0": run("overlap_0", "a", ["--overlap-ranking", "0"])}
        real_launch, syncs = mars_lib.Mars.predict_launch, []

        def checked_launch(self, *a, **k):
            # CUDA's sync debug mode: each synchronising call inside the launch warns
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as seen:
                    warnings.simplefilter("always")
                    return real_launch(self, *a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                syncs.extend(str(w.message).splitlines()[0] for w in seen
                             if "synchroniz" in str(w.message))

        mars_lib.Mars.predict_launch = checked_launch
        try:
            runs["overlap_2"] = run("overlap_2", "b", ["--overlap-ranking", "2"])
        finally:
            mars_lib.Mars.predict_launch = real_launch
        real_run, recorded = mars_lib.Mars._run, []

        def interrupting_run(self, *a, **k):
            if len(recorded) + 1 == FOLD_INTERRUPT:
                raise _Interrupted(f"interrupted inside ranking {FOLD_INTERRUPT}")
            out = real_run(self, *a, **k)
            recorded.append(out["merged"].cpu().numpy() > 0.5)
            return out

        mars_lib.Mars._run = interrupting_run
        try:
            run("interrupted", "c", ["--overlap-ranking", "0", "--resume-every", "2"])
            failures.append(("interrupted run", "did not raise"))
        except _Interrupted:
            pass
        finally:
            mars_lib.Mars._run = real_run
        runs["resumed"] = run("resumed", "c", ["--resume", "--resume-every", "2"])
        files = {name: _fold_files(os.path.join(tmp, log, "1shot"))
                 for name, log in (("overlap_0", "a"), ("overlap_2", "b"), ("resumed", "c"))}
        ref = runs["overlap_0"]["masks"]
        first = runs["resumed"]["first_idx"]
        stitched = recorded[:first] + runs["resumed"]["masks"]
        equal = {"overlap_2": [bool(np.array_equal(a, b))
                               for a, b in zip(runs["overlap_2"]["masks"], ref)],
                 "interrupted_then_resumed": [bool(np.array_equal(a, b))
                                              for a, b in zip(stitched, ref)]}
        per_ep = {name: res["episode_launches"] for name, res in runs.items()}
        ms = {name: res["wall_s"] * 1e3 / len(res["episode_ms"]) for name, res in runs.items()}
        row = {"phase": "fold_run", "run": "cli.main x 4", "episodes": FOLD_EPISODES,
               "ranking_ms_per_episode_overlap_0": ms["overlap_0"],
               "ranking_ms_per_episode_overlap_2": ms["overlap_2"],
               "ranking_ms_per_episode_resumed": ms["resumed"],
               "episode_ms": {name: res["episode_ms"] for name, res in runs.items()},
               "wall_s": {name: res["wall_s"] for name, res in runs.items()},
               "live_proposals": runs["overlap_0"]["live_proposals"],
               "miou": {name: res["miou"] for name, res in runs.items()},
               "masks_equal_overlap_0": equal, "resumed_from": first,
               "interrupted_rankings_before_the_crash": len(recorded),
               "syncs_inside_predict_launch": syncs,
               "rows": files["overlap_0"]["rows"], "events": {n: f["events"]
                                                            for n, f in files.items()},
               "known_bad_line": {n: f["bad_line"] for n, f in files.items()},
               "launches_per_episode_expected": tap_only}
        emit(row)
        want_rows = [(i, 7) for i in range(FOLD_EPISODES)]
        checks = {
            "overlap_2_masks": len(equal["overlap_2"]) == FOLD_EPISODES
            and all(equal["overlap_2"]),
            "resumed_masks": len(stitched) == FOLD_EPISODES
            and all(equal["interrupted_then_resumed"]),
            "resumed_from_2": first == 2 and len(recorded) == FOLD_INTERRUPT - 1,
            "scalars": files["overlap_2"]["scalars"] == files["overlap_0"]["scalars"]
            == files["resumed"]["scalars"] and len(files["overlap_0"]["scalars"])
            == 2 * FOLD_EPISODES,
            "ranking_time_rows": all(f["rows"] == want_rows for f in files.values()),
            "events": all(f["events"] and all(f["events"].values()) for f in files.values()),
            "known_bad_line": len(files["overlap_0"]["bad_line"]) == 1
            and files["overlap_2"]["bad_line"] == files["resumed"]["bad_line"]
            == files["overlap_0"]["bad_line"],
            "launches": all(got == tap_only for eps in per_ep.values() for got in eps)
            and len(per_ep["resumed"]) == FOLD_EPISODES - 2,
            "no_sync_in_launch": not syncs,
            "resume_file_removed": not os.path.exists(os.path.join(tmp, "c", "1shot",
                                                                   "resume.pkl")),
        }
        emit({"phase": "fold_run", "checks": checks})
        failures += [(k, "failed") for k, ok in checks.items() if not ok]

        # c. --visualize 2
        res = run("visualize", "d", ["--visualize", "2", "--episodes", "2"])
        viz = os.path.join(tmp, "d", "1shot", "viz")
        pngs = sorted(os.listdir(viz)) if os.path.isdir(viz) else []
        shapes = [list(visualize.read_png(os.path.join(viz, f))[0].shape) for f in pngs]
        emit({"phase": "fold_run", "run": "cli.main --visualize 2", "pngs": pngs,
              "png_shapes": shapes, "miou": res["miou"]})
        if pngs != ["ep00000.png", "ep00001.png"]:
            failures.append(("visualize", pngs))
    state["fold_run_launches"] = by_path
    if failures:
        raise AssertionError(f"fold run failed: {failures}")


REAL_PASCAL_EPISODES = 2
REAL_TIMING_REPEATS = 5  # host timings: the median of this many calls


def _median_ms(fn, repeats=REAL_TIMING_REPEATS):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def phase_real_files(state):
    """The benchmarks' own files on the card's installation (no PIL, no
    regex): tests/real_layouts.py lays the committed JPEG and PNG fixtures
    out as COCO-20i, PASCAL-5i, FSS-1000, LVIS-92i and PACO-Part; the
    port's decodes, resizes, polygon rasters, records and
    ``episode_host_u8`` arrays are held to the digests of PIL's and of the
    JAX loaders' (tests/fixtures/images/expected.json); then the float32
    ranking over three COCO-20i episodes, the bf16 two-program evaluation
    on PASCAL-5i with both switches on, and one ``MarsServer`` request with
    a 640x480 record, every kernel's launches exact.  Host times (decode,
    resize, polygon, host prep) and ranking ms are printed beside the
    card's name and power limit."""
    import math
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import real_layouts as rl
    from mars_tpu_torch import cli, cli_proposals, serving
    from mars_tpu_torch.data import image_io, lvis
    from mars_tpu_torch.data.base import episode_host_u8
    from mars_tpu_torch.data.registry import build_dataset
    from mars_tpu_torch.text.tokenizer import tokenize

    def start():
        torch.cuda.synchronize()
        for fn in cli.KERNELS.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in cli.KERNELS.items()}

    card, exp, failures, by_path = nvidia_smi(), rl.expected(), [], {}
    tap_only = {name: TAPPED_BLOCKS if name == "attention_with_tap" else 0
                for name in cli.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        # a. the fixtures and the five layouts against PIL's and JAX's digests
        files = {}
        for name, want in exp["files"].items():
            path = os.path.join(rl.FIXTURES, name)
            got = {key: rl.array_sha(image_io.read_image(path, None if key == "none" else key))
                   == want["decode"][key] for key in want["decode"]}
            rgb, gray = image_io.read_image(path, "RGB"), image_io.read_image(path, "L")
            got["bilinear_RGB"] = rl.array_sha(image_io.resize(
                rgb, rl.SIZE, rl.SIZE, image_io.BILINEAR)) == want["resize518"]["bilinear_RGB"]
            got["nearest_L"] = rl.array_sha(image_io.resize(
                gray, rl.SIZE, rl.SIZE, image_io.NEAREST)) == want["resize518"]["nearest_L"]
            files[name] = all(got.values())
        polys = [rl.array_sha(image_io.polygon_mask(p["polygons"], p["h"], p["w"]))["sha256"]
                 == p["sha256"] for p in exp["polygons"]]
        root = rl.lay_out_all(os.path.join(tmp, "data"))
        layouts, prep_ms = {}, {}
        for bench in rl.BENCHMARKS:
            ds = build_dataset(bench, root, 0, "test", 1, rl.SEED)
            layouts[bench], prep_ms[bench] = [], []
            for idx, want in enumerate(exp["layouts"][bench]["episodes"]):
                t0 = time.perf_counter()
                rec = ds[idx]
                host = episode_host_u8(rec, rl.SIZE, 1)
                prep_ms[bench].append((time.perf_counter() - t0) * 1e3)
                layouts[bench].append(rl.record_digest(rec) == want["record"]
                                      and rl.arrays_digest(host) == want["host_u8"])
        ids = tokenize(["a photo of a jalapeño"])[0][:7].tolist()
        emit({"phase": "real_files", "run": "digests against PIL and the JAX loaders",
              "card": card, "files_equal": files, "polygons_equal": polys,
              "layouts_equal": layouts, "jalapeno_ids": ids})
        if not (all(files.values()) and all(polys) and all(all(v) for v in layouts.values())
                and len(files) == len(exp["files"])):
            failures.append(("digests", files, polys, layouts))
        if ids != [49406, 320, 1125, 539, 320, 43017, 49407]:
            failures.append(("tokenizer", ids))

        # host times: decode by format and size, resize, polygon, host prep
        decode_ms = {}
        for name in sorted(exp["files"]):
            path = os.path.join(rl.FIXTURES, name)
            decode_ms[name] = _median_ms(lambda: image_io.read_image(path))
        img = image_io.read_image(os.path.join(rl.FIXTURES, "coco_640x480.jpg"), "RGB")
        lab = image_io.read_image(os.path.join(rl.FIXTURES, "coco_640x480.png"))
        resize_ms = {"bilinear_640x480_rgb_to_518": _median_ms(
            lambda: image_io.resize(img, rl.SIZE, rl.SIZE, image_io.BILINEAR)),
            "nearest_640x480_mask_to_518": _median_ms(
            lambda: image_io.resize(lab, rl.SIZE, rl.SIZE, image_io.NEAREST))}
        rng = np.random.RandomState(0)
        segms = [rl.polygon(rng, 640, 480, outside=i % 2 == 1) for i in range(10)]
        polygon_ms = {"ten_polygons_640x480": _median_ms(
            lambda: lvis.polygons_to_mask(segms, 480, 640))}
        emit({"phase": "real_files", "run": "host times (median of "
              f"{REAL_TIMING_REPEATS})", "card": card, "decode_ms": decode_ms,
              "resize_ms": resize_ms, "polygon_ms": polygon_ms,
              "host_prep_ms_per_episode": prep_ms})

        # b. float32 ranking on COCO-20i
        args = ["--benchmark", "coco", "--datapath", root, "--fold", "0", "--episodes",
                str(rl.EPISODES), "--gt-class-names", "--proposal-bucket", "128",
                "--input-size", "518", "--seed", "0"]
        start()
        res = cli.main(args + ["--log-path", os.path.join(tmp, "coco")], keep_masks=True)
        by_path["real_coco_f32"] = launches()
        emit({"phase": "real_files", "run": "cli.main --benchmark coco (float32)", "card": card,
              "ranking_ms": res["episode_ms"], "live_proposals": res["live_proposals"],
              "episode_launches": res["episode_launches"], "launches_expected": tap_only,
              "masks_binary": res["masks_binary"], "miou": res["miou"],
              "mask_fg_pixels": [int(m.sum()) for m in res["masks"]]})
        if (len(res["episode_launches"]) != rl.EPISODES
                or any(got != tap_only for got in res["episode_launches"])
                or not res["masks_binary"] or not math.isfinite(res["miou"])):
            failures.append(("coco ranking", res["episode_launches"], res["masks_binary"]))

        # c. the shipped bf16 evaluation on PASCAL-5i, both switches on
        props = os.path.join(tmp, "pascal_props")
        pargs = ["--benchmark", "pascal5i", "--datapath", root, "--fold", "0", "--episodes",
                 str(REAL_PASCAL_EPISODES), "--seed", "0"]
        with kernel_switches():
            start()
            pres = cli_proposals.main(["--bf16", "--out", props] + pargs)
            by_path["real_pascal5i_cli_proposals"] = launches()
            start()
            res = cli.main(["--bf16", "--gt-class-names", "--proposal-bucket", "128",
                            "--input-size", "518", "--mask-proposals-path", props,
                            "--log-path", os.path.join(tmp, "pascal")] + pargs,
                           keep_masks=True)
            by_path["real_pascal5i_ranking"] = launches()
        live = res["live_proposals"]
        want_rank = [_ranking_launches([n]) for n in live]
        emit({"phase": "real_files", "run": "cli_proposals --bf16 then cli --bf16 "
              "--mask-proposals-path (pascal5i, switches on)", "card": card,
              "proposal_ms": pres["proposal_ms"], "ranking_ms": res["episode_ms"],
              "live_proposals": live, "proposal_launches": pres["episode_launches"],
              "ranking_launches": res["episode_launches"],
              "ranking_launches_expected": want_rank, "masks_binary": res["masks_binary"],
              "miou": res["miou"]})
        if (len(pres["episode_launches"]) != REAL_PASCAL_EPISODES
                or any(got != _matcher_launches(1) for got in pres["episode_launches"])
                or res["episode_launches"] != want_rank or not res["masks_binary"]):
            failures.append(("pascal5i two-program", pres["episode_launches"],
                             res["episode_launches"], want_rank))

        # d. one MarsServer request with a 640x480 record
        dev = torch.device("cuda")
        model = cli.build_model(cli.parse_args(args), dev)
        ds = build_dataset("coco", root, 0, "test", 1, rl.SEED)
        recs = [ds[i] for i in range(rl.EPISODES)]  # each call draws from the loader's rng
        rec = next(r for r in recs if r.query_img.shape == (480, 640, 3))
        prop = cli.synthetic_proposal_masks(rec, 518, np.random.RandomState(0)).numpy()
        server = serving.MarsServer(model, input_size=518, proposal_bucket=128)
        warm_s = server.warmup(rec, prop)
        start()
        t0 = time.perf_counter()
        out = server.predict(serving.PredictRequest(rec, prop, class_name=rec.class_name))
        request_ms = (time.perf_counter() - t0) * 1e3
        by_path["real_server"] = launches()
        ep = cli.to_device_episode(rec, 518, 1, dev)
        want = model.predict(ep, cli.pad_proposals(torch.from_numpy(prop).to(dev), 128),
                             class_name=rec.class_name).cpu().numpy()
        equal = bool(out.error is None and np.array_equal(out.mask, want))
        emit({"phase": "real_files", "run": "MarsServer, one 640x480 request", "card": card,
              "record_shape": list(rec.query_img.shape), "warmup_s": warm_s,
              "request_ms": request_ms, "launches": by_path["real_server"],
              "mask_equal_predict": equal})
        if not equal or by_path["real_server"] != tap_only:
            failures.append(("server", equal, by_path["real_server"]))
        del model, server
    state["real_files_launches"] = by_path
    if failures:
        raise AssertionError(f"real files failed: {failures}")


# the Matcher's other configurations (phase_matcher_configs): ε-phases of
# each auction a call launches, in order: the positives' forward and reverse
# matching (one phase each), then the cost negatives' forward (5 phases);
# the discarded negatives reuse the positives' match
NEG_PHASES = {1: [1, 1, 5], 5: [1, 1, 5]}
MULTICROP_POINTS = 32
MULTICROP_CROPS = 5  # crop_n_layers=1: the image, then 2 x 2 crops
MULTICROP_MIN_AREA = 100
CLEANUP_MASKS = 1024
INT8_EPISODES = 3
INT8_PROPOSAL_EPISODES = 2
INT8_ARGS = ["--benchmark", "synthetic", "--gt-class-names", "--bf16", "--proposal-bucket", "128",
             "--input-size", "518", "--seed", "0"]
# AlphaCLIP-L's MLP at a chunk of 16 crops x 577 tokens: W8A8 against the
# weight-only int8 route and a bf16 product
W8A8_SHAPE = (16 * 577, 1024, 4096)


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


@contextlib.contextmanager
def recorded_auction_phases(phases):
    """Every ε-phase the auction kernel runs inside the block, appended to
    ``phases`` as (inputs, outputs); ``assignment._auction_phase_kernel`` is
    the global name the wrapper looks up at call time."""
    from mars_tpu_torch.ops import assignment as asg

    real = asg._auction_phase_kernel

    def record(scores, row_valid, prices, eps, max_rounds, small_k=asg.SMALL_K):
        prices_in = prices.clone()
        col, pr, counts = real(scores, row_valid, prices, eps, max_rounds, small_k)
        phases.append((scores, row_valid, prices_in, eps, max_rounds, small_k, col, pr, counts))
        return col, pr, counts

    asg._auction_phase_kernel = record
    try:
        yield phases
    finally:
        asg._auction_phase_kernel = real


def _phases_equal_plain(phases):
    """Each recorded kernel phase replayed on the plain phase: bitwise?"""
    import torch

    from mars_tpu_torch.ops import assignment as asg

    out = []
    for sc, va, pr_in, eps, mr, sk, col, pr, counts in phases:
        col_p, pr_p, counts_p = asg._auction_phase_plain(sc, va, pr_in, eps, mr, sk)
        out.append(bool(torch.equal(col, col_p) and counts == counts_p
                        and torch.equal(pr.view(torch.int32), pr_p.view(torch.int32))))
    return out


def phase_matcher_configs(state):
    """The Matcher's other configurations at full width (DINOv2-L/14 reg4
    @518, SAM ViT-H @1024, float32, seeded random weights, the selection
    thresholds at 0 as ``_zero_thresholds``): (a) both negative sources
    with ``merge_prompt_types`` at one shot and at five, every auction phase
    the kernel ran replayed on the plain phase with the same inputs,
    bitwise; (b) ``use_box``, then a cascade call on its best mask's low-res
    logits; (c) ``generate_multicrop``
    at one crop layer and 32 points a side, the windowed switch on, then
    ``postprocess_small_regions``.  Every kernel's count is set to 0 just
    before each call and read just after."""
    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS
    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.ops import assignment as asg
    from mars_tpu_torch.pipeline import amg, matcher

    dev = torch.device("cuda")
    dino, dino_cfg = zoo.build_dinov2(None, "vit_large", 4, 0, dev)
    sam_params, sam_cfg = zoo.build_sam(None, "vit_h", 3, dev)
    acfg = amg.AmgConfig(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0,
                         box_nms_thresh=0.5, sel_multimask_output=True, sel_output_layer=3,
                         decode_batch=16)
    episodes = {s: to_device_episode(SyntheticFSS(seed=0, shot=s)[0], 518, s, dev)
                for s in (1, 5)}
    failures, by_path = [], {}

    def launches():
        return {name: fn.launches for name, fn in cli.KERNELS.items()}

    def call(shots=1, target=None, **cfg_kw):
        ep = episodes[shots]
        torch.cuda.synchronize()
        for fn in cli.KERNELS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = matcher.generate_proposals(
                dino, dino_cfg, sam_params, sam_cfg, acfg, matcher.MatcherConfig(**cfg_kw),
                ep.support_images, ep.support_masks, ep.support_valid, ep.query_image,
                generator=cli.episode_generator(0, 0, dev), bucket=128,
                target_mask_low_res=target)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        masks = out["bucket_masks"]
        return out, {"ms": ms, "launches": launches(),
                     "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "decoded_rows": int(out["proposal_valid"].shape[0]),
                     "live_proposals": int(out["proposal_valid"].sum()),
                     "bucket_live": int(out["bucket_valid"].sum()),
                     "prompt_sets": int(out["telemetry"]["n_prompt_sets"]),
                     "positive_points_inside_mask":
                         int(out["telemetry"]["positive_points_inside_mask"]),
                     "masks_binary": bool(((masks == 0) | (masks == 1)).all())}

    # a. both negative sources + merge_prompt_types; the kernel's phases
    # recorded, grouped by auction instance (each starts at phase_inputs)
    instances, phases = [], []
    real_inputs = asg.phase_inputs

    def record_inputs(scores, row_valid, n_phases=1, row_chunk=None):
        instances.append({"shape": list(scores.shape), "n_phases": n_phases,
                          "start": len(phases)})
        return real_inputs(scores, row_valid, n_phases, row_chunk)

    negatives = dict(use_negative_priors_from_discarded=True,
                     use_negative_priors_from_cost=True, merge_prompt_types=True)
    for shots in (1, 5):
        instances.clear()
        phases.clear()
        asg.phase_inputs = record_inputs
        try:
            with recorded_auction_phases(phases):
                out, row = call(shots, **negatives)
        finally:
            asg.phase_inputs = real_inputs
        ends = [inst["start"] for inst in instances[1:]] + [len(phases)]
        rows = []
        for k, (inst, end) in enumerate(zip(instances, ends)):
            inst["phases"] = phases[inst["start"]:end]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            equal = all(_phases_equal_plain(inst["phases"]))
            plain_ms = (time.perf_counter() - t0) * 1e3
            bidder_rows = sum(ph[8][2] + ph[8][3] for ph in inst["phases"])
            first = inst["phases"][0]
            scores, valid = first[0], first[1]
            eps = [ph[3] for ph in inst["phases"]]
            ms = cuda_ms(lambda: auction_phases(asg._auction_phase_kernel, scores, valid, eps),
                         iters=3, warmup=1)
            rows.append({"instance": ["matching_forward", "matching_reverse",
                                      "cost_forward"][k] if k < 3 else f"extra_{k}",
                         "shape": inst["shape"], "phases": inst["n_phases"],
                         "launches": len(inst["phases"]), "valid_rows": int(valid.sum()),
                         "variant": asg.VARIANTS[asg.auction_variant(*inst["shape"])],
                         "rounds": [ph[8][0] + ph[8][1] for ph in inst["phases"]],
                         "dense_rounds": [ph[8][0] for ph in inst["phases"]],
                         "bidder_rows": bidder_rows, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bidder_rows * inst["shape"][1] * 4.0 / PEAK_BYTES * 1e3,
                         "bound_by": "bytes", "library_ms": None, "equal_plain": equal})
        want = NEG_PHASES[shots]
        emit({"phase": "matcher_configs", "run": f"negatives, {shots} shot(s)", **row,
              "auction_instances": rows, "auction_phases_expected": want})
        by_path[f"negatives_{shots}shot"] = row["launches"]
        if ([r["launches"] for r in rows] != want or row["launches"]["auction"] != sum(want)
                or not all(r["equal_plain"] for r in rows)):
            failures.append((f"negatives {shots}", rows))
        if row["launches"]["grid_attention"] != SAM_GLOBAL_LAYERS or not row["masks_binary"]:
            failures.append((f"negatives {shots}", row))
        state.setdefault("cost_auction_rows", []).extend(
            dict(r, shots=shots) for r in rows if r["instance"].startswith("cost"))

    # b. the box prompt, then the cascade on its best mask's low-res logits
    box, row = call(use_box=True)
    emit({"phase": "matcher_configs", "run": "use_box", **row})
    by_path["use_box"] = row["launches"]
    live = box["proposal_valid"]
    best = int(torch.argmax(torch.where(live, box["mask_score"], float("-inf"))))
    cascade, crow = call(use_box=True, target=box["low_res_logits"][best])
    differs = not torch.equal(cascade["low_res_logits"], box["low_res_logits"])
    emit({"phase": "matcher_configs", "run": "cascade (target_mask_low_res)", **crow,
          "logits_differ": differs})
    by_path["cascade"] = crow["launches"]
    if not (row["masks_binary"] and crow["masks_binary"] and differs and row["live_proposals"]):
        failures.append(("box / cascade", row, crow, differs))

    # c. multicrop AMG, then the small-region cleanup
    mcfg = amg.AmgConfig(pred_iou_thresh=0.0, stability_score_thresh=0.0,
                         points_per_side=MULTICROP_POINTS, crop_n_layers=1)
    image = episodes[1].query_image
    with kernel_switches(WINDOWED_ONLY):
        torch.cuda.synchronize()
        for fn in cli.KERNELS.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = amg.generate_multicrop(sam_params, image, sam_cfg, mcfg, (518, 518))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        clean = amg.postprocess_small_regions(out, MULTICROP_MIN_AREA, mcfg.box_nms_thresh)
    torch.cuda.synchronize()
    clean_ms = (time.perf_counter() - t0) * 1e3
    clean_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the cleanup at scale: random weights leave one live mask after NMS, so
    # the first CLEANUP_MASKS non-empty slots are cleaned as if live
    nonempty = torch.nonzero(out["masks"].flatten(1).any(dim=1))[:CLEANUP_MASKS, 0]
    stress_valid = torch.zeros_like(out["valid"])
    stress_valid[nonempty] = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        stress = amg.postprocess_small_regions({**out, "valid": stress_valid}, MULTICROP_MIN_AREA,
                                               mcfg.box_nms_thresh)
    torch.cuda.synchronize()
    stress_row = {"masks": int(stress_valid.sum()), "ms": (time.perf_counter() - t0) * 1e3,
                  "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "changed": int((stress["masks"] != out["masks"])[nonempty]
                                 .flatten(1).any(dim=1).sum()),
                  "kept_by_nms": int(stress["valid"].sum())}
    want = {"attention_with_tap": 0, "attention_notap": 0,
            "grid_attention": SAM_GLOBAL_LAYERS * MULTICROP_CROPS,
            "windowed_attention": SAM_WINDOWED_LAYERS * MULTICROP_CROPS, "auction": 0}
    row = {"phase": "matcher_configs", "run": "generate_multicrop + postprocess_small_regions",
           "switches": WINDOWED_ONLY, "points_per_side": MULTICROP_POINTS, "crop_n_layers": 1,
           "slots": int(out["valid"].shape[0]), "live_masks": int(out["valid"].sum()),
           "live_after_cleanup": int(clean["valid"].sum()), "min_area": MULTICROP_MIN_AREA,
           "ms": ms, "cleanup_ms": clean_ms, "peak_memory_gib": peak,
           "cleanup_peak_memory_gib": clean_peak,
           "cleanup_at_scale": stress_row, "launches": got, "launches_expected": want}
    emit(row)
    by_path["multicrop"] = got
    if got != want or not row["live_masks"] or out["masks"].dtype != torch.bool:
        failures.append(("multicrop", row))
    state["matcher_configs_launches"] = by_path
    if failures:
        raise AssertionError(f"matcher configurations failed: {failures}")


def phase_int8_towers(state):
    """The ranking CLI's tower flags at full width on seeded random weights,
    bf16: ``--bf16`` (the reference), ``--int8-towers``, ``--int8-towers
    --w8a8-alphaclip`` over three synthetic episodes, then the last with
    ``--generate-proposals`` over two: 31 tap launches
    an episode (and the Matcher's 4 grid and 2 auction), merged masks
    against the ``--bf16`` run's, the towers' weight bytes, peak memory,
    ranking ms an episode; then ``torch._int_mm``'s W8A8 product against
    the weight-only int8 route and a bf16 product at AlphaCLIP-L's MLP.
    Every kernel's count is set to 0 just before each run and read just
    after."""
    import math

    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.models import quantization as quant

    built, failures, by_path = {}, [], {}
    real_build = cli.build_model

    def capture(args, dev):
        built["model"] = real_build(args, dev)
        return built["model"]

    def run(name, extra, episodes, proposals=False):
        torch.cuda.synchronize()
        for fn in cli.KERNELS.values():
            fn.launches = 0
        cli.build_model = capture
        try:
            res = cli.main(INT8_ARGS + ["--episodes", str(episodes)] + extra, keep_masks=True)
        finally:
            cli.build_model = real_build
        got = {name_: fn.launches for name_, fn in cli.KERNELS.items()}
        per = {"attention_with_tap": TAPPED_BLOCKS, "attention_notap": 0,
               "grid_attention": SAM_GLOBAL_LAYERS if proposals else 0,
               "windowed_attention": 0, "auction": AUCTIONS if proposals else 0}
        want = {k: v * episodes for k, v in per.items()}
        m = built.pop("model")
        towers = {"dinov2": _tree_bytes(m.dino_params), "clip_visual": _tree_bytes(m.clip_v),
                  "alphaclip_visual": _tree_bytes(m.ac_v)}
        ms = res["episode_ms"]
        row = {"phase": "int8_towers", "run": name, "flags": extra, "episodes": episodes,
               "ranking_ms": ms, "ms_per_episode_after_first": sum(ms[1:]) / len(ms[1:]),
               "proposal_ms": res["proposal_ms"], "live_proposals": res["live_proposals"],
               "tower_weight_bytes": towers, "episode_peak_memory_gib": res["episode_peak_gib"],
               "miou": res["miou"], "masks_binary": res["masks_binary"], "launches": got,
               "launches_expected": want}
        by_path[f"int8_{name}"] = got
        if got != want or not res["masks_binary"] or not math.isfinite(res["miou"]):
            failures.append((name, got, want))
        return row, res["masks"]

    ref_row, ref = run("bf16", [], INT8_EPISODES)
    emit(ref_row)
    for name, extra in (("int8_towers", ["--int8-towers"]),
                        ("w8a8_alphaclip", ["--int8-towers", "--w8a8-alphaclip"])):
        row, masks = run(name, extra, INT8_EPISODES)
        row["iou_with_bf16"] = [float(_mask_iou(a[None], b[None])[0, 0])
                                for a, b in zip(masks, ref)]
        emit(row)
    row, _ = run("w8a8_alphaclip_proposals",
                 ["--int8-towers", "--w8a8-alphaclip", "--generate-proposals"],
                 INT8_PROPOSAL_EPISODES, proposals=True)
    emit(row)

    m, k, n = W8A8_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.rand((k, n), generator=gen, device="cuda") * 0.07 - 0.035).to(torch.bfloat16)
    w8 = quant.quantize_kernel(w)
    # the towers' layout: the same codes stored column-major once
    w8a8 = quant.quantize_params({"kernel": w}, act_bits=8)["kernel"]
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
    int32_equal = (torch.equal(w8a8["q"], w8["q"]) and w8a8["q"].stride() == (1, k)
                   and torch.equal(quant.int8_product(xq, w8a8["q"]).cpu(),
                                   quant.int8_product(xq.cpu(), w8["q"].cpu())))
    row = {"phase": "int8_towers", "run": "W8A8 product", "shape": [m, k, n],
           "w8a8_ms": cuda_ms(lambda: quant.quantized_dense({"kernel": w8a8}, x)),
           "int_mm_ms": cuda_ms(lambda: quant.int8_product(xq, w8a8["q"])),
           "int_mm_b_row_major_ms": cuda_ms(lambda: torch._int_mm(xq, w8["q"])),
           "weight_only_int8_ms": cuda_ms(lambda: quant.quantized_dense({"kernel": w8}, x)),
           "bf16_ms": cuda_ms(lambda: x @ w), "int32_equal_cpu": int32_equal}
    emit(row)
    if not int32_equal:
        failures.append(("int_mm", row))
    state["int8_launches"] = by_path
    if failures:
        raise AssertionError(f"int8 towers failed: {failures}")


SS_EPISODES = 3
SS_INPUT = 518
SS_ARGS = ["--benchmark", "synthetic", "--episodes", str(SS_EPISODES), "--gt-class-names",
           "--generate-proposals", "--proposal-model", "semantic-sam", "--proposal-bucket",
           "128", "--input-size", str(SS_INPUT), "--seed", "0"]
SS_SPANS = ("matcher.features", "matcher.match", "matcher.encode", "matcher.decode",
            "matcher.upsample", "matcher.score")


def _semantic_sam_cli(extra=(), switches=None):
    """``cli.main`` over ``SS_EPISODES`` with the Semantic-SAM backend, every
    kernel's count set to 0 just before and read just after, each
    episode's Matcher output (prompt sets, every proposal, EMD scores,
    bucket) kept on the card and every auction phase recorded."""
    import torch

    from mars_tpu_torch import cli

    calls, phases = [], []
    real_bucket = cli.bucket_generated_proposals

    def keep(out):
        props = real_bucket(out)
        calls.append({"coords": out["coords01"], "set_valid": out["set_valid"],
                      "masks": out["proposal_masks"], "valid": out["proposal_valid"],
                      "emd": out["emd_score"], "bucket": props.masks > 0.5,
                      "bucket_valid": props.valid})
        return props

    cli.bucket_generated_proposals = keep
    try:
        with kernel_switches(switches or {}), recorded_auction_phases(phases):
            for fn in cli.KERNELS.values():
                fn.launches = 0
            res = cli.main(SS_ARGS + list(extra), keep_masks=True)
            launches = {name: fn.launches for name, fn in cli.KERNELS.items()}
    finally:
        cli.bucket_generated_proposals = real_bucket
    torch.cuda.synchronize()
    return res, launches, calls, phases


def _against(call, ref):
    """One episode's Matcher output against another run's: prompt sets and
    proposals equal, the least IoU of a proposal live in both with its
    counterpart row, EMD's largest difference there, the buckets equal."""
    import torch

    live = call["valid"] & ref["valid"]
    a, b = call["masks"][live].flatten(1), ref["masks"][live].flatten(1)
    union = (a | b).sum(1)
    iou = torch.where(union > 0, (a & b).sum(1) / union.clamp(min=1), 1.0)
    return {"prompts_equal": bool(torch.equal(call["coords"], ref["coords"])
                                  and torch.equal(call["set_valid"], ref["set_valid"])),
            "proposals_equal": bool(torch.equal(call["masks"], ref["masks"])
                                    and torch.equal(call["valid"], ref["valid"])),
            "live": int(call["valid"].sum()), "live_other": int(ref["valid"].sum()),
            "live_in_both": int(live.sum()),
            "min_row_iou": float(iou.min()) if len(iou) else None,
            "emd_max_abs_diff": float((call["emd"] - ref["emd"])[live].abs().max())
            if len(iou) else None,
            "bucket_equal": bool(torch.equal(call["bucket"], ref["bucket"])
                                 and torch.equal(call["bucket_valid"], ref["bucket_valid"]))}


def _semantic_sam_call_split(dino, dino_cfg, ss_params, ss_cfg, ep, generator):
    """One Semantic-SAM Matcher call (encode included: a fresh query
    tensor) on the host clock, after a warm-up call, then one under
    torch.profiler: device ms by ``matcher.*`` span, busy ms, idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars_tpu_torch.pipeline import matcher, matcher_oss

    backend = matcher_oss.SemanticSamBackend(ss_params, ss_cfg)
    mcfg = matcher.MatcherConfig(input_size=SS_INPUT, grid=SS_INPUT // dino_cfg.patch_size)

    def call():
        return matcher_oss.generate_proposals_oss(
            dino, dino_cfg, backend, mcfg, ep.support_images, ep.support_masks,
            ep.support_valid, ep.query_image.clone(), generator=generator(), bucket=128)

    with torch.no_grad():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, launches, spans, top = _profile_summary(prof, ("matcher.",))
    tele = {k: int(v) for k, v in out["telemetry"].items()}
    return {"call_ms": ms, "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": launches,
            "span_device_ms": {k: spans.get(k) for k in SS_SPANS},
            "encode_share_of_busy": (spans.get("matcher.encode") or 0.0) / busy_ms,
            "live_before_filters": tele["n_proposals"], "merged_after_filters": tele["n_merged"],
            "bucket_live": int(out["bucket_valid"].sum()), "prompt_sets": tele["n_prompt_sets"],
            "matched_points": tele["n_matched_points"], "top_kernels": top[:8]}


def _semantic_sam_bf16_network(dino, dino_cfg, ss_params, ss_cfg, ep, generator):
    """The float32 call's prompt sets through the float32 and the bf16-cast
    Semantic-SAM backends (the same matched points, so only the network's
    type differs): the encodings' and the live sets' logits' largest
    difference over the largest float32 magnitude, and each live mask's IoU
    with its float32 counterpart."""
    import torch

    from mars_tpu_torch.models.precision import cast_floating
    from mars_tpu_torch.pipeline import matcher, matcher_oss

    backends = {"float32": matcher_oss.SemanticSamBackend(ss_params, ss_cfg),
                "bf16": matcher_oss.SemanticSamBackend(cast_floating(ss_params), ss_cfg)}
    mcfg = matcher.MatcherConfig(input_size=SS_INPUT, grid=SS_INPUT // dino_cfg.patch_size)
    q = ep.query_image
    with torch.no_grad():
        out = matcher_oss.generate_proposals_oss(
            dino, dino_cfg, backends["float32"], mcfg, ep.support_images, ep.support_masks,
            ep.support_valid, q, generator=generator())
        prompts = (out["coords01"], out["labels"], out["set_valid"])
        enc = {k: b.encode(q) for k, b in backends.items()}
        live_sets = out["set_valid"].repeat_interleave(ss_cfg.num_granularities)
        logits = {k: b.set_logits(q, *prompts)[live_sets] for k, b in backends.items()}
        masks = {k: b.predict_batch(q, *prompts, tuple(q.shape[:2]))[0][live_sets]
                 for k, b in backends.items()}

    def rel(a, b):
        return float((a.float() - b).abs().max() / b.abs().max())

    a, b = masks["bf16"].flatten(1), masks["float32"].flatten(1)
    union = (a | b).sum(1)
    iou = torch.where(union > 0, (a & b).sum(1) / union.clamp(min=1), 1.0)
    return {"live_masks": int(live_sets.sum()),
            "encode_dtypes": [str(t.dtype) for t in enc["bf16"]],
            "memory_rel": rel(enc["bf16"][0], enc["float32"][0]),
            "mask_feats_rel": rel(enc["bf16"][1], enc["float32"][1]),
            "set_logits_rel": rel(logits["bf16"], logits["float32"]),
            "mask_iou_min": float(iou.min()), "mask_iou_mean": float(iou.mean()),
            "mask_iou_median": float(iou.median()),
            "pixels_agree": float((a == b).float().mean())}


def phase_semantic_sam(state):
    """The Semantic-SAM proposal path at full width (SwinL @640, hidden 256,
    8 heads, 4 points, 3 levels, 6 encoder and 9 decoder layers, 6
    granularities; DINOv2-L/14 reg4 @518 matching; seeded random weights):
    ``cli.main --generate-proposals --proposal-model semantic-sam`` over
    three synthetic episodes in float32, again with
    MARS_ATTENTION_NOTAP_IMPL=pallas, then in bf16 with it: every kernel's
    launches exact per episode (2 auction and 31 tap; with the switch 48 +
    28 + 24 per live AlphaCLIP chunk notap), every auction phase bitwise
    equal to the plain phase, the switched run's buckets and merged masks
    against the plain route's, bf16's merged masks' IoU with float32's.
    Then one call split by stage (float32 and bf16: encode = SwinL and the
    pixel decoder, decode = the point decoder and mask head, upsample,
    score = scoring and merge), and one ``SamPointBackend`` call at SAM
    ViT-H (4 grid, 2 auction launches).  Between them, the float32 call's
    prompt sets through the bf16-cast network: its encodings and set
    logits within ``SS_BF16_REL`` of float32's largest magnitude, its live
    masks at a mean IoU of at least ``SS_BF16_IOU`` with float32's."""
    import math

    import numpy as np
    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS
    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.models.precision import cast_floating
    from mars_tpu_torch.pipeline import matcher, matcher_oss

    failures, runs, by_path = [], {}, {}
    matcher_call = {"auction": AUCTIONS, "attention_notap": MATCHER_UNTAPPED}
    for name, extra, switches in (("float32", [], {}), ("float32_notap", [], NOTAP_ONLY),
                                  ("bf16_notap", ["--bf16"], NOTAP_ONLY)):
        res, launches, calls, phases = _semantic_sam_cli(extra, switches)
        equal = _phases_equal_plain(phases)
        want = []
        for live in res["live_proposals"]:
            w = _ranking_launches([live]) if switches else {
                **{k: 0 for k in cli.KERNELS}, "attention_with_tap": TAPPED_BLOCKS}
            w["auction"] += AUCTIONS
            if switches:
                w["attention_notap"] += matcher_call["attention_notap"]
            want.append(w)
        runs[name] = (res, calls)
        by_path[f"semantic_sam_{name}" if name != "float32" else "semantic_sam"] = launches
        ms, prop = res["episode_ms"], res["proposal_ms"]
        row = {"phase": "semantic_sam", "run": name, "switches": switches,
               "episodes": SS_EPISODES, "proposal_ms": prop,
               "proposal_ms_after_first": sum(prop[1:]) / len(prop[1:]),
               "ranking_ms": ms, "ranking_ms_after_first": sum(ms[1:]) / len(ms[1:]),
               "episode_peak_memory_gib": res["episode_peak_gib"],
               "live_proposals": res["live_proposals"], "miou": res["miou"],
               "masks_binary": res["masks_binary"], "launches": launches,
               "episode_launches": res["episode_launches"], "episode_launches_expected": want,
               "auction_phases": len(phases), "auction_phases_equal_plain": equal}
        if name != "float32":
            ref_res, ref_calls = runs["float32"]
            row["merged_equal_float32"] = [bool(np.array_equal(a, b)) for a, b in
                                           zip(res["masks"], ref_res["masks"])]
            row["merged_iou_float32"] = [float(_mask_iou(a[None], b[None])[0, 0])
                                         for a, b in zip(res["masks"], ref_res["masks"])]
            row["against_float32"] = [_against(c, r) for c, r in zip(calls, ref_calls)]
        emit(row)
        if res["episode_launches"] != want or not equal or not all(equal):
            failures.append((name, "launches or auction phases", res["episode_launches"], want,
                             equal))
        if not res["masks_binary"] or not math.isfinite(res["miou"]) or not any(
                res["live_proposals"]):
            failures.append((name, "masks", res["masks_binary"], res["miou"],
                             res["live_proposals"]))
        if name == "float32_notap" and min(row["merged_iou_float32"]) < NOTAP_IOU:
            failures.append((name, "merged masks depart from the plain route's",
                             row["merged_iou_float32"]))

    # one call split by stage, float32 then bf16 (switches off)
    dev = torch.device("cuda")
    dino, dino_cfg = zoo.build_dinov2(None, "vit_large", 4, 0, dev)
    ss_params, ss_cfg = zoo.build_semantic_sam(None, device=dev)
    ep = to_device_episode(SyntheticFSS(seed=0)[0], SS_INPUT, 1, dev)
    for dtype in ("float32", "bf16"):
        params = (dino, ss_params) if dtype == "float32" else (cast_floating(dino),
                                                              cast_floating(ss_params))
        torch.cuda.reset_peak_memory_stats()
        split = _semantic_sam_call_split(params[0], dino_cfg, params[1], ss_cfg, ep,
                                         lambda: cli.episode_generator(0, 0, dev))
        emit({"phase": "semantic_sam", "run": f"call split, {dtype}", **split,
              "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "config": {"swin_embed": ss_cfg.swin.embed_dim, "depths": ss_cfg.swin.depths,
                         "window": ss_cfg.swin.window, "input_size": ss_cfg.input_size,
                         "hidden": ss_cfg.hidden, "heads": ss_cfg.num_heads,
                         "points": ss_cfg.num_points, "enc_layers": ss_cfg.enc_layers,
                         "dec_layers": ss_cfg.dec_layers,
                         "granularities": ss_cfg.num_granularities}})
        if not split["live_before_filters"]:
            failures.append((f"call split {dtype}", "no live proposal"))
    net = _semantic_sam_bf16_network(dino, dino_cfg, ss_params, ss_cfg, ep,
                                     lambda: cli.episode_generator(0, 0, dev))
    emit({"phase": "semantic_sam", "run": "bf16 network on float32's prompt sets", **net,
          "bar": SS_BF16_REL, "iou_bar": SS_BF16_IOU})
    if not net["live_masks"] or max(net["memory_rel"], net["mask_feats_rel"],
                                    net["set_logits_rel"]) > SS_BF16_REL or (
                                        net["mask_iou_mean"] < SS_BF16_IOU):
        failures.append(("bf16 network", net))
    del ss_params

    # SAM ViT-H behind the point-predictor protocol
    sam_params, sam_cfg = zoo.build_sam(None, "vit_h", 3, dev)
    backend = matcher_oss.SamPointBackend(sam_params, sam_cfg)
    torch.cuda.synchronize()
    for fn in cli.KERNELS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        out = matcher_oss.generate_proposals_oss(
            dino, dino_cfg, backend,
            matcher.MatcherConfig(input_size=SS_INPUT, grid=SS_INPUT // dino_cfg.patch_size),
            ep.support_images,
            ep.support_masks, ep.support_valid, ep.query_image,
            generator=cli.episode_generator(0, 0, dev), bucket=128)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in cli.KERNELS.items()}
    want = {**{k: 0 for k in cli.KERNELS}, "grid_attention": SAM_GLOBAL_LAYERS,
            "auction": AUCTIONS}
    by_path["semantic_sam_sam_backend"] = launches
    row = {"phase": "semantic_sam", "run": "SamPointBackend, SAM ViT-H",
           "ms": (time.perf_counter() - t0) * 1e3, "launches": launches,
           "launches_expected": want, "masks": int(out["proposal_masks"].shape[0]),
           "live_before_filters": int(out["proposal_valid"].sum()),
           "merged_after_filters": int(out["chosen"].sum()),
           "bucket_live": int(out["bucket_valid"].sum())}
    emit(row)
    if launches != want or out["proposal_masks"].shape[0] != 3 * out["set_valid"].shape[0]:
        failures.append(("SamPointBackend", row))
    state["semantic_sam_launches"] = by_path
    if failures:
        raise AssertionError(f"semantic-sam path failed: {failures}")


PAR_EPISODES = 8
PAR_LOCAL_BATCH = 4
PAR_ARGS = ["--benchmark", "synthetic", "--episodes", str(PAR_EPISODES), "--gt-class-names",
            "--proposal-bucket", "128", "--input-size", "518", "--seed", "0"]
PAR_GEN_EPISODES = 4
PAR_GEN_LOCAL_BATCH = 2
SERVER_REQUESTS = 6
SERVER_MALFORMED = 3  # the request whose proposals are 2-D
TWO_RANK_EPISODES = 4


def _zero_counts():
    from mars_tpu_torch import cli

    for fn in cli.KERNELS.values():
        fn.launches = 0


def _against_serial(got, want):
    """Per-episode IoU of two mask lists and how many are bitwise equal."""
    import numpy as np

    ious = [float(_mask_iou(a[None], b[None])[0, 0]) for a, b in zip(got, want)]
    return ious, sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))


def _parallel_timing(args, dev):
    """One model and a one-rank NCCL mesh: ranking ms an episode at local
    batch 1 and ``PAR_LOCAL_BATCH`` over ``PAR_EPISODES`` episodes (the
    batches after the first), then one batch of each under torch.profiler
    (wall, device busy, idle share)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mars_tpu_torch import cli, cli_parallel
    from mars_tpu_torch.core.episode import pad_proposals
    from mars_tpu_torch.parallel import mesh as mesh_lib

    pargs = cli.parse_args(args)
    model = cli.build_model(pargs, dev)
    mesh = mesh_lib.make_mesh(device="cuda")
    out = {}
    try:
        def run(lb, n):
            rng = np.random.RandomState(0)
            return cli_parallel.evaluate_parallel(
                model, cli.dataset(pargs), mesh, input_size=518, episodes=n,
                proposal_bucket=128, local_batch=lb, log=lambda *a: None,
                props_fn=lambda idx, rec: pad_proposals(
                    cli.synthetic_proposal_masks(rec, 518, rng), 128))[3]

        for lb in (1, PAR_LOCAL_BATCH):
            times = run(lb, PAR_EPISODES)
            out[f"ms_per_episode_lb{lb}"] = float(np.mean(times[1:]) / lb * 1e3)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(lb, lb)
                wall_ms = (time.perf_counter() - t0) * 1e3
            busy_ms, launches, _, top = _profile_summary(prof, ("mars.", "matcher."))
            out[f"profiled_batch_lb{lb}"] = {
                "episodes": lb, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / wall_ms, "kernel_launches": launches,
                "top_kernels": top[:5]}
    finally:
        mesh.close()
    return out


def _two_rank(rank, world, store, args, out_dir):
    """One of two ranks sharing the card over gloo: ``evaluate_parallel``
    at mesh 2 x 1 and 1 x 2 (tensor-parallel towers) over
    ``TWO_RANK_EPISODES`` episodes, then ``make_proposal_parallel_ranker``
    on episode 0's 128-row bucket; masks and kernel counts to a file."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from mars_tpu_torch import cli, cli_parallel
    from mars_tpu_torch.core.episode import pad_proposals
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.parallel import mesh as mesh_lib, runner

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        dev = torch.device("cuda", 0)
        pargs = cli.parse_args(args)
        model = cli.build_model(pargs, dev)
        full = {k: getattr(model, k) for k in ("dino_params", "clip_v", "ac_v")}
        result = {}
        for shape, lb in (((2, 1), TWO_RANK_EPISODES // 2), ((1, 2), TWO_RANK_EPISODES)):
            mesh = mesh_lib.make_mesh(*shape, device=dev)
            for k, v in full.items():
                setattr(model, k, mesh_lib.shard_params(v, mesh))
            rng, masks = np.random.RandomState(0), []
            _zero_counts()
            t0 = time.perf_counter()
            cli_parallel.evaluate_parallel(
                model, cli.dataset(pargs), mesh, input_size=518, episodes=TWO_RANK_EPISODES,
                proposal_bucket=128, local_batch=lb, log=lambda *a: None, masks=masks,
                props_fn=lambda idx, rec: pad_proposals(
                    cli.synthetic_proposal_masks(rec, 518, rng), 128))
            result[f"mesh_{shape[0]}x{shape[1]}"] = {
                "masks": masks, "launches": cli.kernel_launches(), "wall_s": time.perf_counter() - t0}
        for k, v in full.items():
            setattr(model, k, v)
        mesh = mesh_lib.make_mesh(2, 1, device=dev)
        rec = cli.dataset(pargs)[0]
        ep = to_device_episode(rec, 518, 1, dev)
        props = cli.synthetic_proposals(rec, 518, 128, np.random.RandomState(0), dev)
        rank_fn = runner.make_proposal_parallel_ranker(
            model.dino_cfg, model.clip_vcfg, model.ac_vcfg, model.cfg.vva, model.cfg.vta,
            model.cfg.filter_merge, mesh)
        from mars_tpu_torch.text import prompts

        _zero_counts()
        t0 = time.perf_counter()
        merged, final = rank_fn(
            {"dino": model.dino_params, "clip_v": model.clip_v, "ac_v": model.ac_v,
             "logit_scale": model.clip_scale}, *ep[:4], props.masks, props.valid,
            model._vta_text_feats(rec.class_name),
            model._alpha_clip_text_feats(prompts.alpha_clip_text(rec.class_name, "")))
        result["proposal_parallel"] = {"masks": [merged.cpu().numpy() > 0.5],
                                       "launches": cli.kernel_launches(),
                                       "wall_s": time.perf_counter() - t0,
                                       "finite_scores": int(torch.isfinite(final).sum())}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def phase_parallel(state):
    """The multi-device drivers and the serving runtime at full width, one
    card (``cli_parallel``, ``parallel.runner``, ``serving``):

    (a) ``cli_parallel.main`` at one rank over NCCL, local batch 4, over
        eight synthetic episodes, float32 then --bf16: merged masks against
        the serial ``cli.main``'s at IoU >= ``NOTAP_IOU`` (the count of
        bitwise-equal ones printed), 31 tap launches an episode and no
        other kernel; ranking ms an episode at local batch 1 and 4, one
        profiled batch of each, the peak memory;
    (b) ``--generate-proposals --local-batch 2`` over four episodes, the
        AMG's selection thresholds at 0 so that the buckets hold live masks:
        merged masks against the serial CLI's at IoU >= ``NOTAP_IOU``, 4
        grid and 2 auction launches an episode (the buckets are printed
        beside the serial CLI's; both run one Matcher flow,
        ``cli.make_inline_generator``, so they are equal by construction and
        not asserted);
    (c) ``MarsServer``: a warm-up, then six requests from a producer
        thread, one with 2-D proposals (its ValueError delivered, the loop
        going on); the other masks bitwise equal to ``Mars.predict``'s;
        each request's latency;
    (d) two ranks sharing the card over gloo (NCCL refuses two ranks on
        one device): ``evaluate_parallel`` at mesh 2 x 1 and 1 x 2 over
        four episodes, ``make_proposal_parallel_ranker`` on one 128-row
        bucket; merged masks against (a)'s float32 ones at IoU >=
        ``NOTAP_IOU``, the bitwise-equal count printed."""
    import functools
    import pickle
    import queue
    import tempfile
    import threading

    import numpy as np
    import torch

    from mars_tpu_torch import cli, cli_parallel, serving
    from mars_tpu_torch.core.episode import pad_proposals
    from mars_tpu_torch.pipeline import amg, matcher

    dev = torch.device("cuda")
    failures, launches_by_path = [], {}
    serial_f32 = None
    with tempfile.TemporaryDirectory() as tmp:
        # (a)
        for bf16 in (False, True):
            args = PAR_ARGS + (["--bf16"] if bf16 else [])
            tag = "bf16" if bf16 else "f32"
            serial = cli.main(args + ["--log-path", os.path.join(tmp, f"s_{tag}")],
                              keep_masks=True)
            torch.cuda.reset_peak_memory_stats(dev)
            _zero_counts()
            res = cli_parallel.main(args + ["--local-batch", str(PAR_LOCAL_BATCH),
                                            "--log-path", os.path.join(tmp, f"p_{tag}")],
                                    keep_masks=True)
            launches = cli.kernel_launches()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            launches_by_path[f"parallel_{tag}"] = launches
            want = {name: 0 for name in launches}
            want["attention_with_tap"] = TAPPED_BLOCKS * PAR_EPISODES
            ious, equal = _against_serial(res["masks"], serial["masks"])
            row = {"phase": "parallel_one_rank", "dtype": tag, "episodes": PAR_EPISODES,
                   "local_batch": PAR_LOCAL_BATCH, "mesh": res["mesh"],
                   "batch_s": res["batch_times"], "iou_with_serial": ious,
                   "bitwise_equal_serial": equal, "iou_limit": NOTAP_IOU, "miou": res["miou"],
                   "serial_miou": serial["miou"],
                   "serial_ranking_ms_per_episode": float(np.mean(serial["episode_ms"][1:])),
                   "peak_memory_gib": peak, "launches": launches, "launches_expected": want,
                   **_parallel_timing(args, dev)}
            emit(row)
            if launches != want or len(ious) != PAR_EPISODES or min(ious) < NOTAP_IOU:
                failures.append(("one_rank", tag))
            if not bf16:
                serial_f32 = serial["masks"]

        # (b), the AMG's selection thresholds at 0 (``_zero_thresholds``'s
        # config) so that the buckets hold live masks
        buckets = {"serial": [], "parallel": []}
        real, real_amg = matcher.generate_proposals, amg.AmgConfig
        amg.AmgConfig = functools.partial(
            real_amg, sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0,
            box_nms_thresh=0.5, sel_multimask_output=True, sel_output_layer=3, decode_batch=16)
        gen_args = ["--benchmark", "synthetic", "--episodes", str(PAR_GEN_EPISODES),
                    "--gt-class-names", "--generate-proposals", "--proposal-bucket", "128",
                    "--input-size", "518", "--seed", "0"]
        try:
            for key, fn, extra in (("serial", cli.main, []),
                                   ("parallel", cli_parallel.main,
                                    ["--local-batch", str(PAR_GEN_LOCAL_BATCH)])):
                def recording(*a, _key=key, **k):
                    out = real(*a, **k)
                    buckets[_key].append((out["bucket_masks"].cpu().numpy(),
                                          out["bucket_valid"].cpu().numpy()))
                    return out

                matcher.generate_proposals = recording
                _zero_counts()
                got = fn(gen_args + extra + ["--log-path", os.path.join(tmp, f"g_{key}")],
                         keep_masks=True)
                buckets[key + "_launches"] = cli.kernel_launches()
                buckets[key + "_masks"] = got["masks"]
        finally:
            matcher.generate_proposals, amg.AmgConfig = real, real_amg
        launches = buckets["parallel_launches"]
        launches_by_path["parallel_generate"] = launches
        want = {"attention_with_tap": TAPPED_BLOCKS * PAR_GEN_EPISODES, "attention_notap": 0,
                "grid_attention": SAM_GLOBAL_LAYERS * PAR_GEN_EPISODES, "windowed_attention": 0,
                "auction": AUCTIONS * PAR_GEN_EPISODES}
        equal_buckets = [bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
                         for a, b in zip(buckets["parallel"], buckets["serial"])]
        ious, equal = _against_serial(buckets["parallel_masks"], buckets["serial_masks"])
        emit({"phase": "parallel_generate", "episodes": PAR_GEN_EPISODES,
              "local_batch": PAR_GEN_LOCAL_BATCH, "buckets_bitwise_equal": equal_buckets,
              "live_proposals": [int(b[1].sum()) for b in buckets["parallel"]],
              "iou_with_serial": ious, "bitwise_equal_serial": equal, "launches": launches,
              "launches_expected": want})
        if (launches != want or len(ious) != PAR_GEN_EPISODES or min(ious) < NOTAP_IOU
                or not any(b[1].any() for b in buckets["parallel"])):
            failures.append("generate")

    # (c)
    model = cli.build_model(cli.parse_args(PAR_ARGS), dev)
    ds = cli.dataset(cli.parse_args(PAR_ARGS))
    server = serving.MarsServer(model, input_size=518, proposal_bucket=128)
    rng = np.random.RandomState(0)
    props = [cli.synthetic_proposal_masks(ds[i], 518, rng).numpy()
             for i in range(SERVER_REQUESTS)]
    warm_s = server.warmup(ds[0], props[0])
    done, sent, results = queue.Queue(), {}, {}
    _zero_counts()
    server.start(lambda r: (results.__setitem__(r.request_id, (r, time.perf_counter())),
                            done.put(r.request_id)))

    def produce():
        for i in range(SERVER_REQUESTS):
            p = props[i][0] if i == SERVER_MALFORMED else props[i]
            sent[i] = time.perf_counter()
            server.submit(serving.PredictRequest(ds[i], p, class_name=ds[i].class_name,
                                                 request_id=i))

    producer = threading.Thread(target=produce)
    producer.start()
    producer.join(timeout=300)
    for _ in range(SERVER_REQUESTS):
        done.get(timeout=300)
    server.stop()
    launches = cli.kernel_launches()
    launches_by_path["server"] = launches
    equal, latency = [], {}
    for i in range(SERVER_REQUESTS):
        res, t_done = results[i]
        latency[i] = (t_done - sent[i]) * 1e3
        if i == SERVER_MALFORMED:
            continue
        ep = cli.to_device_episode(ds[i], 518, 1, dev)
        want = model.predict(ep, pad_proposals(torch.from_numpy(props[i]).to(dev), 128),
                             class_name=ds[i].class_name).cpu().numpy()
        equal.append(bool(res.error is None and np.array_equal(res.mask, want)))
    bad = results[SERVER_MALFORMED][0]
    emit({"phase": "parallel_server", "requests": SERVER_REQUESTS, "warmup_s": warm_s,
          "latency_ms": [latency[i] for i in range(SERVER_REQUESTS)],
          "predict_total_ms": [results[i][0].timings.get("total", 0) * 1e3
                               for i in range(SERVER_REQUESTS)],
          "malformed_error": repr(bad.error), "masks_equal_predict": equal,
          "launches": launches})
    if not isinstance(bad.error, ValueError) or len(equal) != SERVER_REQUESTS - 1 \
            or not all(equal) or launches["attention_with_tap"] != \
            TAPPED_BLOCKS * (SERVER_REQUESTS - 1):
        failures.append("server")
    del model, server

    # (d)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(_two_rank, args=(2, os.path.join(tmp, "store"), PAR_ARGS,
                                                     tmp), nprocs=2, join=True)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    row = {"phase": "parallel_two_ranks", "backend": "gloo", "episodes": TWO_RANK_EPISODES,
           "iou_limit": NOTAP_IOU}
    for key in ("mesh_2x1", "mesh_1x2", "proposal_parallel"):
        ref = serial_f32[:len(ranks[0][key]["masks"])]
        per_rank = [_against_serial(rk[key]["masks"], ref) for rk in ranks]
        launches = {name: sum(rk[key]["launches"][name] for rk in ranks)
                    for name in ranks[0][key]["launches"]}
        launches_by_path[f"two_ranks_{key}"] = launches
        row[key] = {"iou_with_serial": [p[0] for p in per_rank],
                    "bitwise_equal_serial": [p[1] for p in per_rank],
                    "ranks_equal": all(np.array_equal(a, b) for a, b in
                                       zip(ranks[0][key]["masks"], ranks[1][key]["masks"])),
                    "launches_both_ranks": launches,
                    "wall_s": [rk[key].get("wall_s") for rk in ranks]}
        # 2 x 1: each rank its two episodes; 1 x 2: each rank its heads of all
        # four; the proposal-sharded ranker: each rank the episode's towers
        taps = TAPPED_BLOCKS * {"mesh_2x1": TWO_RANK_EPISODES, "mesh_1x2": 2 * TWO_RANK_EPISODES,
                                "proposal_parallel": 2}[key]
        if (any(min(p[0]) < NOTAP_IOU or len(p[0]) != len(ref) for p in per_rank)
                or not row[key]["ranks_equal"] or launches["attention_with_tap"] != taps):
            failures.append(("two_ranks", key))
    emit(row)
    state["parallel_launches"] = launches_by_path
    if failures:
        raise AssertionError(f"parallel phase failed: {failures}")


TRAIN_IMAGES = 8  # the batch: one synthetic episode's 1024² query image each
TRAIN_POINTS = 3  # foreground points an example, drawn from its mask
TRAIN_STEPS = 8
TRAIN_LR = 1e-3  # tests/test_parallel.py's rate: the loss falls in a few steps
TRAIN_WARM = 2  # steps before a step is timed
TRAIN_LOSS_TOL = 1e-5  # relative: the loss of a step computed another way
TRAIN_PARAM_TOL = 1e-6  # the updated parameters (tests/test_parallel.py's limit)
TRAIN_VARIANTS = (("accum", {"accum_steps": 2}), ("remat", {"remat": True}),
                  ("both", {"accum_steps": 2, "remat": True}))
TRAIN_MESHES = ((2, 1), (1, 2))
AUCTION_OPT_TOL = 1e-3  # the auction's total >= optimum - this x rows (tests/test_ops.py)
SINKHORN_TOL = 5e-3  # |Sinkhorn EMD - exact EMD| (tests/test_native.py)


def _train_batch(dev):
    """ViT-H with seeded random weights; the frozen encode (no grad) of
    ``TRAIN_IMAGES`` synthetic 1024² query images, ``TRAIN_POINTS``
    foreground points an image from its mask (seeded), the mask at the
    256² low-res scale → (trainable, cfg, (embedding, coords, labels, gt),
    encode ms, launches)."""
    import numpy as np
    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.core import imaging
    from mars_tpu_torch.data.synthetic import SyntheticFSS
    from mars_tpu_torch.models import sam, zoo

    params, cfg = zoo.build_sam(None, "vit_h", device=dev)
    s = cfg.img_size
    ds = SyntheticFSS(seed=0, size=s)
    recs = [ds[i] for i in range(TRAIN_IMAGES)]
    imgs = torch.from_numpy(np.stack([r.query_img for r in recs]).astype(np.float32)).to(dev)
    imgs = imaging.normalize(imgs, sam.SAM_PIXEL_MEAN, sam.SAM_PIXEL_STD)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        emb = sam.encode_image(params["encoder"], imgs, cfg)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    launches = cli.kernel_launches()
    rng = np.random.RandomState(0)
    coords = []
    for r in recs:
        ys, xs = np.nonzero(r.query_mask > 0)
        pick = rng.choice(len(xs), TRAIN_POINTS, replace=False)
        coords.append(np.stack([xs[pick], ys[pick]], axis=-1).astype(np.float32))
    masks = torch.from_numpy(np.stack([r.query_mask for r in recs]).astype(np.float32))
    gt = (torch.nn.functional.interpolate(masks[:, None], size=(s // 4, s // 4), mode="area")[:, 0]
          > 0.5).float()
    batch = (emb, torch.from_numpy(np.stack(coords)).to(dev),
             torch.ones((TRAIN_IMAGES, TRAIN_POINTS), dtype=torch.int64, device=dev), gt.to(dev))
    trainable = {"prompt_encoder": params["prompt_encoder"], "decoder": params["decoder"]}
    del params
    return trainable, cfg, batch, encode_ms, launches


def _timed_steps(step, trainable, opt_state, batch, n):
    """``n`` steps → (trainable, state, [metrics], [ms a step], peak GiB of
    the last step)."""
    import torch

    metrics, ms = [], []
    for i in range(n):
        if i == n - 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainable, opt_state, m = step(trainable, opt_state, *batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return trainable, opt_state, metrics, ms, torch.cuda.max_memory_allocated() / 2 ** 30


def _step_against(got, got_metrics, want, want_metrics, before):
    """One train step computed another way (``got``: trees of tensors or
    numpy arrays) against the reference step from the same parameters
    ``before``: the metrics' largest relative difference, the parameters'
    largest absolute one, and that largest where the reference's Adam
    direction ``r = -Δ/lr - wd·p`` is settled (|r| > 0.9, a gradient past
    ~9 eps).  The first update is lr·(g / (|g| + eps) + wd·p), so a
    gradient within float32 rounding of zero moves its parameter by up to
    lr·δg/eps: 1e5 δg at lr 1e-3, where a full-width gradient's rounding
    δg reaches 1e-10.  Only a float64 step holds the parameters to
    ``TRAIN_PARAM_TOL`` everywhere."""
    import torch

    from mars_tpu_torch.parallel import train

    rel = max(abs(float(got_metrics[k]) - float(want_metrics[k]))
              / max(abs(float(want_metrics[k])), 1e-30) for k in want_metrics)
    diff = settled = 0.0
    for g, w, p in zip(*(train.tree_leaves(t) for t in (got, want, before))):
        d = (torch.as_tensor(g).to(w.device, w.dtype) - w).abs()
        r = -(w.double() - p.double()) / TRAIN_LR - 1e-4 * p.double()
        diff = max(diff, float(d.max()))
        if bool((r.abs() > 0.9).any()):
            settled = max(settled, float(d[r.abs() > 0.9].max()))
    return {"loss_rel_diff": rel, "param_max_abs_diff": diff,
            "param_max_abs_diff_settled": settled}


def _step_ok(f32, f64):
    """The float32 step's metrics and the float64 step's metrics and
    parameters within the phase's limits."""
    return (f32["loss_rel_diff"] <= TRAIN_LOSS_TOL and f64["loss_rel_diff"] <= TRAIN_LOSS_TOL
            and f64["param_max_abs_diff"] <= TRAIN_PARAM_TOL)


def _train_rank(rank, world, store, path, out_dir):
    """One of two ranks sharing the card over gloo: one step at each mesh of
    ``TRAIN_MESHES`` on the rank's slices and data shard, the full tree
    gathered back (``gather_params``), to a file."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from mars_tpu_torch.models import sam
    from mars_tpu_torch.parallel import mesh as mesh_lib, runner, train

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        dev = torch.device("cuda", 0)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        cfg = sam.SAM_VARIANTS["vit_h"]
        result = {}
        for shape in TRAIN_MESHES:
            mesh = mesh_lib.make_mesh(*shape, device=dev)
            for dtype in (torch.float32, torch.float64):
                full = train.tree_map(lambda a: torch.from_numpy(a).to(dev, dtype),
                                      payload["trainable"])
                batch = tuple(torch.from_numpy(x).to(dev) for x in payload["batch"])
                batch = tuple(x.to(dtype) if x.is_floating_point() else x for x in batch)
                part = mesh_lib.shard_params(full, mesh)
                opt, step = train.make_train_step(
                    cfg, train.TrainConfig(learning_rate=TRAIN_LR), mesh=mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new, _, metrics = step(part, opt.init(part), *runner.shard_batch(batch, mesh))
                torch.cuda.synchronize()
                result[shape, str(dtype).split(".")[-1]] = {
                    "s": time.perf_counter() - t0,
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "q_width": part["decoder"]["transformer"]["layer0"]["self_attn"]["q"][
                        "kernel"].shape[1],
                    "params": train.tree_map(lambda t: t.cpu().numpy(),
                                             mesh_lib.gather_params(new, mesh, full))}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _oracle_instances(dev):
    """Synthetic episode 0 at full width (DINOv2-L/14 reg4 @518): the
    Matcher's one-shot forward matching instance (similarity, valid rows)
    and the ranking's VVA cost matrix restricted to the support footprint
    and to the first live synthetic proposal's footprint with both sides
    non-empty."""
    import numpy as np
    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.core import imaging
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS
    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.pipeline import filtering, matcher, vva

    params, cfg = zoo.build_dinov2(None, "vit_large", 4, 0, dev)
    rec = SyntheticFSS(seed=0)[0]
    ep = to_device_episode(rec, 518, 1, dev)
    fm = filtering.FilterMergeConfig()
    with torch.no_grad():
        s_mat, _, fg = matcher._features_and_matrices(
            params, ep.support_images, ep.support_masks, ep.support_valid, ep.query_image,
            cfg, 37)
        _, cost, support_fg = vva.compute(params, ep.support_images, ep.support_masks,
                                          ep.support_valid, ep.query_image, cfg,
                                          vva.VVAConfig())
    props = cli.synthetic_proposals(rec, 518, 128, np.random.RandomState(0), dev)
    pooled = ((imaging.pool_mask_to_grid(props.masks, fm.grid) > 0)
              & props.valid[:, None, None]).reshape(props.masks.shape[0], -1)
    col = int(torch.nonzero(pooled.any(dim=1))[0])
    return s_mat, fg, cost, support_fg, pooled[col], fm


def phase_train(state):
    """The SAM decoder's train step (``parallel.train``) at ViT-H's full
    width, one card, float32, TF32 off, and the exact host solvers
    (``native``) on the card's approximate outputs:

    (a) ``zoo.build_sam("vit_h")`` with seeded random weights; the frozen
        encode of ``TRAIN_IMAGES`` synthetic 1024² images (exactly 4 grid
        launches an image, no other kernel); ``TRAIN_STEPS`` steps at
        batch 8, lr 1e-3: every loss finite, the last below the first;
        ms a step after ``TRAIN_WARM`` warm ones, peak memory, one profiled
        step (kernel launches, device busy, idle share);
    (b) ``accum_steps=2``, ``remat=True`` and both against the full
        batch's step from the same weights: the metrics within
        ``TRAIN_LOSS_TOL`` (relative) in float32 and in float64, the
        parameters within ``TRAIN_PARAM_TOL`` in float64 (``_step_against``
        says why not in float32; its differences are printed); ms a step
        after two warm steps and the last step's peak memory, float32;
    (c) two ranks sharing the card over gloo: one step at mesh 2 x 1
        (data-parallel) and 1 x 2 (tensor-parallel decoder), float32 and
        float64, the metrics and the gathered parameters against the
        one-process step, the same limits;
    (d) ``native.assignment_exact`` on the auction kernel's assignment of
        the one-shot Matcher's 1369² forward instance (valid, total >=
        optimum - ``AUCTION_OPT_TOL`` x rows), ``native.emd_exact`` against
        ``batched_emd`` on the card on tests/test_native.py's seeded 60 x
        40 instance and on a full-width ranking episode's cost matrix
        (within ``SINKHORN_TOL``); the exact solvers' seconds."""
    import pickle
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mars_tpu_torch import cli, native
    from mars_tpu_torch.ops import assignment as asg, emd
    from mars_tpu_torch.parallel import train

    dev = torch.device("cuda")
    failures = []
    assert not torch.backends.cuda.matmul.allow_tf32
    # (a)
    trainable, cfg, batch, encode_ms, launches = _train_batch(dev)
    want = {name: 0 for name in launches}
    want["grid_attention"] = SAM_GLOBAL_LAYERS * TRAIN_IMAGES
    state["train_launches"] = {"train_encode": launches}
    tcfg = train.TrainConfig(learning_rate=TRAIN_LR)
    opt, step = train.make_train_step(cfg, tcfg)
    _zero_counts()
    first, first_state, first_metrics = step(trainable, opt.init(trainable), *batch)
    tr, st, metrics, ms, peak = _timed_steps(step, first, first_state, batch, TRAIN_STEPS - 1)
    losses = [first_metrics["loss"].item()] + [m["loss"] for m in metrics]
    step_launches = cli.kernel_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tr, st, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_launch, _, top = _profile_summary(prof, ("mars.", "matcher."))
    row = {"phase": "train", "model": "sam_vit_h", "images": TRAIN_IMAGES,
           "embedding_shape": list(batch[0].shape), "encode_ms": encode_ms,
           "encode_launches": launches, "encode_launches_expected": want,
           "losses": losses, "lr": TRAIN_LR,
           "step_ms": ms, "step_ms_warm": float(np.mean(ms[TRAIN_WARM - 1:])),
           "peak_memory_gib": peak, "hand_kernel_launches_in_steps": step_launches,
           "profiled_step": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                             "device_idle_share": 1.0 - busy_ms / wall_ms,
                             "kernel_launches": n_launch, "top_kernels": top[:6]}}
    emit(row)
    if (launches != want or not np.isfinite(losses).all() or not losses[-1] < losses[0]
            or any(step_launches.values())):
        failures.append("train")

    # (b) timed in float32; held in float32 (the loss) and float64 (the
    # loss and the parameters: see ``_step_against``)
    tr64 = train.tree_map(torch.Tensor.double, trainable)
    batch64 = tuple(x.double() if x.is_floating_point() else x for x in batch)
    _, step64 = train.make_train_step(cfg, tcfg)
    ref64, _, ref64_metrics = step64(tr64, opt.init(tr64), *batch64)
    rows = {}
    for name, kw in TRAIN_VARIANTS:
        _, vstep = train.make_train_step(cfg, tcfg, **kw)
        got_tr, got_st, got = vstep(trainable, opt.init(trainable), *batch)
        _, _, _, vms, vpeak = _timed_steps(vstep, got_tr, got_st, batch, TRAIN_WARM)
        f32 = _step_against(got_tr, got, first, first_metrics, trainable)
        g64_tr, _, g64 = vstep(tr64, opt.init(tr64), *batch64)
        f64 = _step_against(g64_tr, g64, ref64, ref64_metrics, tr64)
        rows[name] = {"step_ms": vms, "step_ms_warm": vms[-1], "peak_memory_gib": vpeak,
                      "float32": f32, "float64": f64}
        if not _step_ok(f32, f64):
            failures.append(("variant", name))
    emit({"phase": "train_variants", "full_step_ms_warm": row["step_ms_warm"],
          "full_peak_memory_gib": peak, "loss_tol": TRAIN_LOSS_TOL,
          "param_tol": TRAIN_PARAM_TOL, **rows})

    # (c)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "payload.pkl")
        with open(path, "wb") as f:
            pickle.dump({"trainable": train.tree_map(lambda t: t.cpu().numpy(), trainable),
                         "batch": [x.cpu().numpy() for x in batch]}, f)
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_train_rank, args=(2, os.path.join(tmp, "store"), path, tmp),
                                    nprocs=2, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    row = {"phase": "train_two_ranks", "backend": "gloo", "spawn_s": spawn_s}
    for shape in TRAIN_MESHES:
        per = []
        for res in ranks:
            f32, f64 = res[shape, "float32"], res[shape, "float64"]
            per.append({"s": f32["s"], "s_float64": f64["s"], "q_width": f32["q_width"],
                        "float32": _step_against(f32["params"], f32["metrics"], first,
                                                 first_metrics, trainable),
                        "float64": _step_against(f64["params"], f64["metrics"], ref64,
                                                 ref64_metrics, tr64)})
        row[f"mesh_{shape[0]}x{shape[1]}"] = per
        if any(not _step_ok(p["float32"], p["float64"]) or p["q_width"] != 256 // shape[1]
               for p in per):
            failures.append(("two_ranks", shape))
    emit(row)
    del trainable, first, tr, st, batch, tr64, batch64, ref64

    # (d)
    s_mat, fg, cost, support_fg, col_mask, fm = _oracle_instances(dev)
    cols = asg.auction_assignment(s_mat, fg, row_chunk=128).cpu().numpy()
    valid = fg.cpu().numpy()
    s = s_mat.cpu().numpy()
    t0 = time.perf_counter()
    best = native.assignment_exact(s[valid])
    lsa_s = time.perf_counter() - t0
    live = cols[valid]
    got_total = float(s[valid][np.arange(len(live)), live].astype(np.float64).sum())
    opt_total = float(s[valid][np.arange(len(best)), best].astype(np.float64).sum())
    t_rows = int(valid.sum())
    auction_ok = (len(set(live.tolist())) == t_rows and (live >= 0).all()
                  and (cols[~valid] == -1).all()
                  and got_total >= opt_total - AUCTION_OPT_TOL * t_rows)
    seeded = (np.random.RandomState(5).rand(60, 40) * 0.5).astype(np.float32)
    sink_seeded = float(emd.batched_emd(
        torch.from_numpy(seeded).to(dev), torch.ones(60, dtype=torch.bool, device=dev),
        torch.ones((1, 40), dtype=torch.bool, device=dev), row_bucket=64, col_bucket=64)[0])
    exact_seeded = native.emd_exact(seeded)
    sink_episode = float(emd.batched_emd(cost, support_fg, col_mask[None], fm.emd_row_bucket,
                                         fm.emd_col_bucket)[0])
    sub = cost[support_fg][:, col_mask].cpu().numpy()
    t0 = time.perf_counter()
    exact_episode = native.emd_exact(sub)
    emd_s = time.perf_counter() - t0
    row = {"phase": "train_oracles",
           "auction": {"shape": list(s.shape), "valid_rows": t_rows, "total": got_total,
                       "exact_total": opt_total, "gap": opt_total - got_total,
                       "limit": AUCTION_OPT_TOL * t_rows, "exact_s": lsa_s, "ok": bool(auction_ok)},
           "emd_seeded": {"shape": [60, 40], "sinkhorn": sink_seeded, "exact": exact_seeded,
                          "diff": abs(sink_seeded - exact_seeded)},
           "emd_episode": {"shape": list(sub.shape), "sinkhorn": sink_episode,
                           "exact": exact_episode, "diff": abs(sink_episode - exact_episode),
                           "exact_s": emd_s},
           "sinkhorn_tol": SINKHORN_TOL}
    emit(row)
    if not auction_ok:
        failures.append("auction_oracle")
    if row["emd_seeded"]["diff"] >= SINKHORN_TOL or row["emd_episode"]["diff"] >= SINKHORN_TOL:
        failures.append("emd_oracle")
    if failures:
        raise AssertionError(f"train phase failed: {failures}")


def kernels_line(state):
    rows = state.get("kernel_rows", [])
    first = next((r for r in rows if r["geometry"] == GEOMETRIES[0][0]
                  and r["dtype"] == "float32"), {})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    paths = {"ranking": state.get("launches", {}), **state.get("f32_notap_launches", {}),
             "proposal": state.get("proposal_launches", {}),
             **state.get("f32_windowed_launches", {}),
             **state.get("bf16_launches", {}), **state.get("five_shot_launches", {}),
             "models_path": state.get("models_path_launches", {}),
             **state.get("backbone_launches", {}), **state.get("fold_run_launches", {}),
             **state.get("real_files_launches", {}),
             **state.get("matcher_configs_launches", {}), **state.get("int8_launches", {}),
             **state.get("semantic_sam_launches", {}),
             **state.get("parallel_launches", {}), **state.get("train_launches", {})}

    def launches(name):
        return sum(counts.get(name, 0) for counts in paths.values())

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in paths.items()}

    grid = state.get("grid_rows", [])
    grid_first = next((r for r in grid if r["geometry"] == GRID_GEOMETRIES[0][0]
                       and r["dtype"] == "float32"), {})
    auc = state.get("auction_rows", [])
    auc_first = next((r for r in auc if r["instance"] == "matching_forward"), {})
    return {"kernels": [{
        "name": "attention_with_tap", "route": "cuda",
        "source": "mars_tpu_torch/csrc/attention_tap.cu",
        "replaces": "mars_tpu/ops/flash_attention.py:69",
        "launches": launches("attention_with_tap"),
        "launches_by_path": by_path("attention_with_tap"),
        "max_abs_err": max((max(r["max_abs_err_out"], r["max_abs_err_tap"])
                            for r in rows if r["dtype"] == "float32"), default=None),
        **{k: first.get(k) for k in keys},
        "shape": first.get("shape"), "dtype": "float32",
        "bound_f32_cuda_core_ms": first.get("bound_f32_cuda_core_ms"),
        "geometries": [{k: r.get(k) for k in ("geometry", "dtype", "max_abs_err_out",
                                              "max_abs_err_tap") + keys
                        + ("bound_f32_cuda_core_ms",)} for r in rows],
    }, {
        "name": "grid_attention", "route": "cuda",
        "source": "mars_tpu_torch/csrc/sam_grid_attention.cu",
        "replaces": "mars_tpu/ops/sam_attention.py:82",
        "launches": launches("grid_attention"), "launches_by_path": by_path("grid_attention"),
        "max_abs_err": max((r["max_abs_err"] for r in grid if r["dtype"] == "float32"),
                           default=None),
        **{k: grid_first.get(k) for k in keys},
        "shape": grid_first.get("shape"), "dtype": "float32",
        "bound_f32_cuda_core_ms": grid_first.get("bound_f32_cuda_core_ms"),
        "bf16_err_over_tol": max((r["err_over_tol"] for r in grid if r["dtype"] == "bfloat16"),
                                 default=None),
        "geometries": [{k: r.get(k) for k in ("geometry", "shape", "dtype", "max_abs_err",
                                              "err_over_tol", "rerun_equal") + keys
                        + ("bound_f32_cuda_core_ms",)} for r in grid],
    }, {
        "name": "auction", "route": "cuda", "source": "mars_tpu_torch/csrc/auction.cu",
        "replaces": "mars_tpu/ops/assignment.py:330",
        "launches": launches("auction"), "launches_by_path": by_path("auction"),
        "max_abs_err": 0.0 if auc and all(r["equal"] for r in auc) else None,
        **{k: auc_first.get(k) for k in keys},
        "shape": auc_first.get("shape"), "dtype": "float32",
        "instances": [{k: r[k] for k in ("instance", "shape", "variant", "equal", "rerun_equal",
                                         "rounds", "bidder_rows", "us_per_round") + keys}
                      for r in auc],
        "negative_prior_instances": state.get("cost_auction_rows", []),
    }, _attention_entry(state, "attention_notap", "notap_rows", "alphaclip_l_336_chunk",
                        "mars_tpu_torch/csrc/attention_notap.cu",
                        "mars_tpu/ops/flash_attention.py:187", launches, by_path),
        _attention_entry(state, "windowed_attention", "window_rows", "sam_vit_h_window",
                         "mars_tpu_torch/csrc/sam_windowed_attention.cu",
                         "mars_tpu/ops/sam_attention.py:178", launches, by_path),
    ] + [_quant_entry(state, fmt, line) for fmt, line in (("int4", 229), ("nf4", 139))]}


def _attention_entry(state, name, rows_key, geometry, source, replaces, launches, by_path):
    """A path's shape in float32 stands for the kernel (the type of its
    redesign, which the float32 ranking path runs for notap and the float32
    proposal path for windowed), with both bounds; every measured geometry
    and type is listed."""
    rows = state.get(rows_key, [])
    first = next((r for r in rows if r["geometry"] == geometry and r["dtype"] == "float32"),
                 {})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("bound_f32_cuda_core_ms",)
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches(name), "launches_by_path": by_path(name),
            "max_abs_err": first.get("max_abs_err"), **{k: first.get(k) for k in keys},
            "shape": first.get("shape"), "dtype": "float32",
            **{k: first[k] for k in extra if k in first},
            "geometries": [{k: r.get(k) for k in ("geometry", "shape", "dtype", "max_abs_err",
                                                  "tol", "err_over_tol", "rerun_equal")
                            + keys + extra if k in r} for r in rows]}


def _quant_entry(state, fmt, line):
    """The decode GEMV of the LLaMA MLP (4 rows x 4096 x 11008) stands for
    the kernel, warm (``ms``), device-held (``held_ms``) and cold
    (``cold_ms``); every measured shape is listed."""
    rows = [r for r in state.get("quant_rows", []) if r["kernel"] == f"matmul_{fmt}"]
    first = next((r for r in rows if r["geometry"] == "llama_gate_up" and r["shape"][0] == 4),
                 {})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    cold = ("held_ms", "cold_ms", "library_held_ms", "library_cold_ms")
    paths = {"text_block": state.get("text_launches", {}).get(f"matmul_{fmt}", 0),
             **{path: n for path, n in state.get("text_cli_launches", {}).items()
                if (path == "cli_nf4") == (fmt == "nf4")},
             **state.get("text_files_launches", {}).get(f"matmul_{fmt}", {})}
    verify = [r for r in rows if r["shape"][0] in VERIFY_ROWS]
    return {"name": f"matmul_{fmt}", "route": "cuda",
            "source": "mars_tpu_torch/csrc/int4_matmul.cu",
            "replaces": f"mars_tpu/ops/int4_matmul.py:{line}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "verify_gemm": [{k: r.get(k) for k in ("geometry", "shape") + keys} for r in verify],
            "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
            **{k: first.get(k) for k in keys + cold}, "shape": first.get("shape"),
            "dtype": "bfloat16",
            "geometries": [{k: r.get(k) for k in ("geometry", "shape", "max_abs_err", "tol")
                            + keys + cold} for r in rows]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import mars_tpu_torch  # noqa: F401  (fails outside the repository)
    from mars_tpu_torch import device as device_lib

    device_lib.resolve("cuda")
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    state, failed = {}, []
    for phase in (phase_build, phase_kernels, phase_grid_attention, phase_notap, phase_windowed,
                  phase_auction, phase_golden, phase_golden_matcher, phase_main_path,
                  phase_f32_notap_path, phase_proposal_path, phase_zero_thresholds,
                  phase_f32_windowed_path, phase_bf16_path, phase_five_shot, phase_models_path,
                  phase_backbones,
                  phase_profile, phase_profile_proposals, phase_profile_bf16,
                  phase_profile_five_shot, phase_4bit_kernels,
                  phase_text_path, phase_profile_text, phase_text_cli, phase_text_files,
                  phase_fold_run, phase_real_files,
                  phase_matcher_configs, phase_int8_towers, phase_semantic_sam,
                  phase_parallel, phase_train):
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            failed.append(phase.__name__)
        print(f"# {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(card, flush=True)
    emit(kernels_line(state))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
