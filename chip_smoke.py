#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mars_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. every kernel against its plain version at the main path's shapes,
     in float32 and bfloat16, timed with CUDA events beside its bound and
     a PyTorch yardstick;
  3. the tiny golden episode (tests/fixtures) on the card: merged mask
     equal to the fixture;
  4. the main path at full width: ``mars_tpu_torch.cli.main`` over three
     synthetic episodes (DINOv2-L/14 reg4 @518, CLIP-B/16 @528,
     AlphaCLIP-L/14@336, seeded random weights, bucket 128), with the
     kernels' launch counts read around it;
  5. one more full-width episode under torch.profiler: device time by
     stage and by kernel, and the device's idle share;
  6. the kernels line.
The last line is {"ok": true, "device": {...}}.  Without CUDA, or outside
the repository, it exits non-zero and prints no result.  Imports nothing
of JAX or of the JAX package.
"""
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
EPISODES = 3
TAPPED_BLOCKS = 24 + 7  # DINOv2-L query blocks + CLIP-B prefinal blocks 4..10
# H100 SXM peaks (NVIDIA data sheet, dense): float32 on CUDA cores, bf16 on
# tensor cores, HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
GEOMETRIES = (("dinov2_l_518", 16, 1374, 64), ("clip_b16_528", 12, 1090, 64))
TOL = {"float32": {"out": 1e-5, "tap": 1e-5}, "bfloat16": {"out": 3e-2, "tap": 1e-5}}


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


def phase_build(state):
    from mars_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build_all()
    ptxas = {}
    for name in build.SOURCES:
        with open(build.library_path(name)[:-3] + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(built),
          "ptxas": ptxas})


def phase_kernels(state):
    import torch
    import torch.nn.functional as F

    from mars_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, h, l, d in GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype).split(".")[1]
            q, k, v = (torch.randn((h, l, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out, tap = fa.attention_with_tap(q, k, v)
            want_out, want_tap = fa.attention_with_tap_plain(q, k, v)
            torch.cuda.synchronize()
            err_out = (out.float() - want_out.float()).abs().max().item()
            err_tap = (tap - want_tap).abs().max().item()
            err_rows = (tap.sum(-1) - 1).abs().max().item()
            size = q.element_size()
            flops = 4.0 * h * l * l * d
            nbytes = 4.0 * h * l * d * size + l * l * 4.0
            bound = max(flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES) * 1e3
            row = {"phase": "kernel", "kernel": "attention_with_tap", "geometry": name,
                   "shape": [h, l, d], "dtype": dt, "max_abs_err_out": err_out,
                   "max_abs_err_tap": err_tap, "max_abs_err_tap_rowsum": err_rows,
                   "tol": TOL[dt],
                   "ms": cuda_ms(lambda: fa.attention_with_tap(q, k, v)),
                   "plain_ms": cuda_ms(lambda: fa.attention_with_tap_plain(q, k, v)),
                   "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                       q[None], k[None], v[None])),
                   "library_call": "F.scaled_dot_product_attention (out only, no tap)",
                   "bound_ms": bound,
                   "bound_by": "operations" if flops / PEAK_FLOPS[dt] > nbytes / PEAK_BYTES
                   else "bytes"}
            emit(row)
            rows.append(row)
            if (err_out > TOL[dt]["out"] or err_tap > TOL[dt]["tap"]
                    or err_rows > TOL[dt]["tap"] or not torch.isfinite(out.float()).all()):
                raise AssertionError(f"attention_with_tap disagrees with its plain version: {row}")
    state["kernel_rows"] = rows


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


def phase_main_path(state):
    import math

    import torch

    from mars_tpu_torch import cli
    from mars_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    fa.attention_with_tap.launches = 0
    res = cli.main(["--benchmark", "synthetic", "--episodes", str(EPISODES), "--gt-class-names",
                    "--proposal-bucket", "128", "--input-size", "518", "--seed", "0"])
    launches = fa.attention_with_tap.launches
    state["launches"] = {"attention_with_tap": launches}
    ms = res["episode_ms"]
    row = {"phase": "main_path", "episodes": EPISODES, "episode_ms": ms,
           "ms_per_episode_after_first": sum(ms[1:]) / len(ms[1:]),
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "miou": res["miou"], "fb_iou": res["fb_iou"], "masks_binary": res["masks_binary"],
           "launches": state["launches"], "launches_expected": TAPPED_BLOCKS * EPISODES}
    emit(row)
    if launches != TAPPED_BLOCKS * EPISODES:
        raise AssertionError(f"attention_with_tap launched {launches} times, "
                             f"expected {TAPPED_BLOCKS * EPISODES}")
    if not res["masks_binary"] or not math.isfinite(res["miou"]):
        raise AssertionError("main path produced a non-binary mask or a non-finite mIoU")


def phase_profile(state):
    """One full-width episode (after a warm-up one) under torch.profiler:
    device time by stage span (``mars.*``) and by kernel, and the device's
    idle share of the episode's wall time (profiler on)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mars_tpu_torch import cli
    from mars_tpu_torch.data.base import to_device_episode
    from mars_tpu_torch.data.synthetic import SyntheticFSS

    dev = torch.device("cuda")
    model = cli.build_model(518, dev)
    rec = SyntheticFSS(seed=0)[0]
    ep = to_device_episode(rec, 518, 1, dev)
    props = cli.synthetic_proposals(rec, 518, 128, np.random.RandomState(0), dev)
    model.predict(ep, props, class_name=rec.class_name)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict(ep, props, class_name=rec.class_name)
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e, self_only):
        names = (("self_device_time_total", "self_cuda_time_total") if self_only
                 else ("device_time_total", "cuda_time_total"))
        return next((getattr(e, n) for n in names if hasattr(e, n)), 0)

    # the mars.* spans also appear as device-side annotations: they are
    # stage spans (first to last kernel of the stage), not kernels
    avg = prof.key_averages()
    device = [e for e in avg if e.device_type == DeviceType.CUDA and dev_us(e, True) > 0]
    kernels = [e for e in device if not e.key.startswith("mars.")]
    busy_ms = sum(dev_us(e, True) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -dev_us(e, True))[:12]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "kernel_launches": sum(e.count for e in kernels),
          "stage_device_span_ms": {e.key: dev_us(e, True) / 1e3 for e in device
                                   if e.key.startswith("mars.")},
          "top_kernels": [{"name": e.key[:90], "device_ms": dev_us(e, True) / 1e3,
                           "count": e.count} for e in top]})


def kernels_line(state):
    rows = state.get("kernel_rows", [])
    first = next((r for r in rows if r["geometry"] == GEOMETRIES[0][0]
                  and r["dtype"] == "float32"), {})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"kernels": [{
        "name": "attention_with_tap", "route": "cuda",
        "source": "mars_tpu_torch/csrc/attention_tap.cu",
        "replaces": "mars_tpu/ops/flash_attention.py:69",
        "launches": state.get("launches", {}).get("attention_with_tap", 0),
        "max_abs_err": max((max(r["max_abs_err_out"], r["max_abs_err_tap"])
                            for r in rows if r["dtype"] == "float32"), default=None),
        **{k: first.get(k) for k in keys},
        "shape": first.get("shape"), "dtype": "float32",
        "geometries": [{k: r[k] for k in ("geometry", "dtype", "max_abs_err_out",
                                          "max_abs_err_tap") + keys} for r in rows],
    }]}


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
    for phase in (phase_build, phase_kernels, phase_golden, phase_main_path, phase_profile):
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
