#!/usr/bin/env python3
"""Where the float32 split-TF32 sweep of the grid and windowed attention
kernels spends its time, on one card.

    python3 tools/grid_f32_probe.py

Builds source variants of ``tf32::biased_sweep``
(``mars_tpu_torch/csrc/attention_tf32.cuh``), the loop of both
``csrc/sam_grid_attention.cu``'s ``grid_f32`` and
``csrc/sam_windowed_attention.cu``'s ``windowed_f32``, into a temporary
directory (each variant a copy of ``csrc/`` with the header edited; one
``nvcc`` per library and variant, all started together), and times each
one's float32 entry points with CUDA events at SAM ViT-H's global layer (16
heads, 64 x 64 grid, head dim 80) and ViT-B's (12 heads, head dim 64), and
at their windowed layers (400 and 300 window-heads of 14 x 14 tokens):

  base       the sources as they are;
  nosplit_v  without splitting the V tiles (into V^T) inside the key loop;
  nosplit_k  without splitting the K tiles inside the key loop;
  noload     without loading the K and V tiles inside the key loop;
  nowait     loading them, without waiting for the loads;
  onepass    one TF32 pass a product (hi x hi) in place of three;
  nobias     without the aligned grid's per-tile bias loads (zeros added);
  expf       ``expf`` in place of ``__expf`` for P;
  one_acc    P.V summed into the output's accumulator over the whole sweep
             (rescaled before each tile's passes) in place of a tile's own
             accumulator added with an fma: what the tensor cores'
             truncating float32 adds cost in accuracy;
  tables     the 14-wide window swept like any other: 64-key tiles, the
             last one masked, each key's bias through the per-tile tables,
             in place of tiles of 4 key rows (windowed only);
  noloop     no key tiles: Q and the first K and V tiles loaded and split,
             then the (meaningless) output stored;
  noqsplit   without splitting Q;
  serial_prologue  the first K and V tiles loaded after Q is split, not
             beside Q's load;
  notables   without the per-tile tables' bias lookups (no bias added where
             the grid's width is not a multiple of the key tile);
  nowinbias  without the window's bias (tiles of 4 key rows: no bias added).

Variants other than ``base``, ``expf``, ``one_acc``, ``tables`` and
``serial_prologue`` compute wrong outputs on purpose: they only split the
time.  Prints one JSON line per row with the largest difference from
``base`` and from the plain version, then the card's name and power limit.
Imports nothing of JAX.
"""
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mars_tpu_torch", "csrc")
HEADER = "attention_tf32.cuh"
SPLIT_V = "    split_vt<DP, NK>(vh, vl, raw_v);  // while Q K^T runs\n"
SPLIT_K = "      split_rows<DP>(kh, kl, raw_k, next_rows);\n"
LOAD_K = "    if (next) load_raw<DP>(raw_k, kg, (t + 1) * STEP, next_rows, L, d, vec);\n"
LOAD_V = "    if (next) load_raw<DP>(raw_v, vg, (t + 1) * STEP, next_rows, L, d, vec);\n"
WAITS = ("    sm90::cp_async_wait<0>();  // raw V tile t\n",
         "    sm90::cp_async_wait<0>();  // raw K tile t + 1\n")
QK = """    qk_pass<DP, NK>(s, ql, kh, true);  // the small terms first
    qk_pass<DP, NK>(s, qh, kl, false);
    qk_pass<DP, NK>(s, qh, kh, false);
"""
PV = """    pv_pass<DP, NK>(pv, pl, vh, true);
    pv_pass<DP, NK>(pv, ph, vl, false);
    pv_pass<DP, NK>(pv, ph, vh, false);
"""
EXP = ("const float p = __expf(",)
FMA = """#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = fmaf(o[i], corr[(i / 2) & 1], pv[i]);
"""
PV_FENCE = "    sm90::fence_regs(pv);\n"
BIAS = """        if (live[half]) {
          bh[half] = __ldg(bhr[half] + y);"""
LOOP = """  for (int t = 0; t < nfull; ++t) tile(Keys<STEP>{}, t);
  if constexpr (TAIL > 0) tile(Keys<TAIL>{}, nfull);
"""
Q_SPLIT = """  for (int g = 0; g < 2; ++g)
    split_rows<DP>(base + 2 * F::Q_BYTES * g, base + 2 * F::Q_BYTES * g + F::Q_BYTES,
                   raw_q + BQ * DP * g, BQ);
"""
PROLOGUE = """  load_raw<DP>(raw_k, kg, 0, rows0, L, d, vec);
  sm90::cp_async_commit();
  load_raw<DP>(raw_v, vg, 0, rows0, L, d, vec);
  sm90::cp_async_commit();
  sm90::cp_async_wait<2>();
  __syncthreads();
""" + Q_SPLIT + """  sm90::cp_async_wait<1>();
  __syncthreads();  // raw K tile 0 in view; raw Q is free
"""
SERIAL_PROLOGUE = """  sm90::cp_async_wait<0>();
  __syncthreads();
""" + Q_SPLIT + """  sm90::fence_async_smem();
  __syncthreads();
  load_raw<DP>(raw_k, kg, 0, rows0, L, d, vec);
  sm90::cp_async_commit();
  load_raw<DP>(raw_v, vg, 0, rows0, L, d, vec);
  sm90::cp_async_commit();
  sm90::cp_async_wait<1>();
  __syncthreads();
"""
TABLE_BIAS = ("live[half] ? __ldg(bhr[half] + ky[c]) : 0.f",
              "live[half] ? __ldg(bwr[half] + kx[c]) : 0.f")
WINDOW_BIAS = "__fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), b), bw_win[i])"
# sam_windowed_attention.cu: the choice of the window's tiles of 4 key rows
WINDOW_CHOICE = "    if (wg == tf32::WINDOW_W && L % tf32::WINDOW_STEP == tf32::WINDOW_STEP / 2)\n"
# (library, entry point, heads or window-heads B x nh, H, W, head dim)
SHAPES = (("sam_grid_attention", "mars_grid_attention_f32", (16,), 64, 64, 80),
          ("sam_grid_attention", "mars_grid_attention_f32", (12,), 64, 64, 64),
          ("sam_windowed_attention", "mars_windowed_attention_f32", (25, 16), 14, 14, 80),
          ("sam_windowed_attention", "mars_windowed_attention_f32", (25, 12), 14, 14, 64))
LIBRARIES = ("sam_grid_attention", "sam_windowed_attention")


def variants(src, windowed):
    """{variant: (header source, windowed source)}."""
    for line in (SPLIT_V, SPLIT_K, LOAD_K, LOAD_V, QK, PV, BIAS, FMA, PV_FENCE, LOOP,
                 Q_SPLIT, PROLOGUE, WINDOW_BIAS) + WAITS + EXP + TABLE_BIAS:
        if src.count(line) != 1:
            raise SystemExit(f"the sweep's source no longer holds this line once: {line!r}")
    if windowed.count(WINDOW_CHOICE) != 1:
        raise SystemExit(f"the windowed source no longer holds this line once: {WINDOW_CHOICE!r}")

    def drop(text, *lines):
        for line in lines:
            text = text.replace(line, "")
        return text

    def exact(text):
        for e in EXP:
            text = text.replace(e, e.replace("__expf(", "expf("))
        return text

    headers = {"base": src,
               "nosplit_v": drop(src, SPLIT_V),
               "nosplit_k": drop(src, SPLIT_K),
               "noload": drop(src, LOAD_K, LOAD_V),
               "nowait": drop(src, *WAITS),
               "onepass": src.replace(QK, "    qk_pass<DP, NK>(s, qh, kh, true);\n").replace(
                   PV, "    pv_pass<DP, NK>(pv, ph, vh, true);\n"),
               "nobias": src.replace(BIAS, BIAS.replace("live[half]", "false")),
               "expf": exact(src),
               "one_acc": drop(src, FMA).replace(
                   PV_FENCE, PV_FENCE.replace("pv", "o")).replace(
                   "    sm90::wgmma_fence();\n" + PV,
                   "    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) & 1];\n"
                   "    sm90::wgmma_fence();\n" + PV.replace("pv,", "o,").replace("true", "false")),
               "noloop": drop(src, LOOP),
               "noqsplit": drop(src, Q_SPLIT),
               "serial_prologue": src.replace(PROLOGUE, SERIAL_PROLOGUE),
               "notables": src.replace(TABLE_BIAS[0], "0.f").replace(TABLE_BIAS[1], "0.f"),
               "nowinbias": src.replace(WINDOW_BIAS, "__fmul_rn(s[i], scale)")}
    out = {name: (h, windowed) for name, h in headers.items()}
    out["tables"] = (src, windowed.replace(WINDOW_CHOICE, "    if (false)\n"))
    return out


def ms(fn, iters=20, warmup=3):
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


def main():
    import torch

    sys.path.insert(0, ROOT)
    from mars_tpu_torch.ops import build, sam_attention as sa

    if not torch.cuda.is_available():
        print("grid_f32_probe: CUDA is not available", file=sys.stderr)
        return 1
    with open(os.path.join(CSRC, HEADER)) as f, \
            open(os.path.join(CSRC, "sam_windowed_attention.cu")) as g:
        srcs = variants(f.read(), g.read())
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, (header, windowed) in srcs.items():
        src_dir = os.path.join(tmp, name)
        shutil.copytree(CSRC, src_dir)
        with open(os.path.join(src_dir, HEADER), "w") as f:
            f.write(header)
        with open(os.path.join(src_dir, "sam_windowed_attention.cu"), "w") as f:
            f.write(windowed)
        for lib in LIBRARIES:
            if name == "tables" and lib != "sam_windowed_attention":
                continue
            cmd = [build.nvcc_path(), *build.FLAGS, "-o", os.path.join(src_dir, lib + ".so"),
                   os.path.join(src_dir, lib + ".cu")]
            procs[name, lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT)
    libs = {}
    for (name, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:  # a variant the compiler refuses is reported and left out
            print(json.dumps({"variant": name, "library": lib, "nvcc_exit": proc.returncode,
                              "log": log.decode(errors="replace")[-400:]}), flush=True)
            if name == "base":
                return 1
            continue
        libs[name, lib] = ctypes.CDLL(os.path.join(tmp, name, lib + ".so"))

    gen = torch.Generator(device="cuda").manual_seed(6)
    stream = torch.cuda.current_stream().cuda_stream
    for lib, entry, batch, h, w, d in SHAPES:
        l = h * w
        args = [torch.randn(batch + s, generator=gen, device="cuda") for s in
                ((l, d), (l, d), (l, d), (l, h), (l, w))]
        plain = sa.grid_attention_plain if len(batch) == 1 else sa.windowed_attention_plain
        base, want = None, plain(*args, (h, w))
        for (name, built), cdll in libs.items():
            if built != lib:
                continue
            fn = getattr(cdll, entry)
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                        ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = torch.empty_like(args[0])

            def call():
                err = fn(*(t.data_ptr() for t in args), out.data_ptr(), math.prod(batch), l, d,
                         h, w, d ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            base = out.clone() if base is None else base
            print(json.dumps({"library": lib, "shape": [*batch, l, d], "variant": name,
                              "ms": ms(call),
                              "max_abs_diff_from_base": (out - base).abs().max().item(),
                              "max_abs_err": (out - want).abs().max().item()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
