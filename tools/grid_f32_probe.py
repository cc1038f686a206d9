#!/usr/bin/env python3
"""Where the float32 grid-attention kernel (split TF32) spends its time, on
one card.

    python3 tools/grid_f32_probe.py

Builds source variants of ``mars_tpu_torch/csrc/sam_grid_attention.cu``
into a temporary directory (one ``nvcc`` each, all started together) and
times each one's float32 entry point with CUDA events at SAM ViT-H's global
layer (16 heads, 64 x 64 grid, head dim 80) and ViT-B's (12 heads, head dim
64):

  base       the source as it is;
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
             truncating float32 adds cost in accuracy.

Variants other than ``base``, ``expf`` and ``one_acc`` compute wrong
outputs on purpose: they only split the time.  Prints one JSON line per
row with the largest difference from ``base`` and from
``grid_attention_plain``, then the card's name and power limit.  Imports
nothing of JAX.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mars_tpu_torch", "csrc")
SPLIT_V = "    split_vt<DP>(vh, vl, raw_v);  // while Q K^T runs\n"
SPLIT_K = "      split_rows<DP>(kh, kl, raw_k, KEYS);\n"
LOAD_K = "    if (next) load_raw<DP>(raw_k, kg, (t + 1) * KEYS, KEYS, L, d, vec);\n"
LOAD_V = "    if (next) load_raw<DP>(raw_v, vg, (t + 1) * KEYS, KEYS, L, d, vec);\n"
WAITS = ("    sm90::cp_async_wait<0>();  // raw V tile t\n",
         "    sm90::cp_async_wait<0>();  // raw K tile t + 1\n")
QK = """    qk_pass<DP>(s, ql, kh, true);  // the small terms first
    qk_pass<DP>(s, qh, kl, false);
    qk_pass<DP>(s, qh, kh, false);
"""
PV = """    pv_pass<DP>(pv, pl, vh, true);
    pv_pass<DP>(pv, ph, vl, false);
    pv_pass<DP>(pv, ph, vh, false);
"""
EXP = ("const float p = __expf(",)
FMA = """#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = fmaf(o[i], corr[(i / 2) & 1], pv[i]);
"""
PV_FENCE = "    sm90::fence_regs(pv);\n"
BIAS = """        if (live[half]) {
          bh[half] = __ldg(bhr[half] + y);"""
SHAPES = ((16, 64, 64, 80), (12, 64, 64, 64))


def variants(src):
    for line in (SPLIT_V, SPLIT_K, LOAD_K, LOAD_V, QK, PV, BIAS, FMA, PV_FENCE) + WAITS + EXP:
        if src.count(line) != 1:
            raise SystemExit(f"the kernel source no longer holds this line once: {line!r}")

    def drop(text, *lines):
        for line in lines:
            text = text.replace(line, "")
        return text

    def exact(text):
        for e in EXP:
            text = text.replace(e, e.replace("__expf(", "expf("))
        return text

    return {"base": src,
            "nosplit_v": drop(src, SPLIT_V),
            "nosplit_k": drop(src, SPLIT_K),
            "noload": drop(src, LOAD_K, LOAD_V),
            "nowait": drop(src, *WAITS),
            "onepass": src.replace(QK, "    qk_pass<DP>(s, qh, kh, true);\n").replace(
                PV, "    pv_pass<DP>(pv, ph, vh, true);\n"),
            "nobias": src.replace(BIAS, BIAS.replace("live[half]", "false")),
            "expf": exact(src),
            "one_acc": drop(src, FMA).replace(
                PV_FENCE, PV_FENCE.replace("pv", "o")).replace(
                "    sm90::wgmma_fence();\n" + PV,
                "    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) & 1];\n"
                "    sm90::wgmma_fence();\n" + PV.replace("pv,", "o,").replace("true", "false"))}


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
    with open(os.path.join(CSRC, "sam_grid_attention.cu")) as f:
        srcs = variants(f.read())
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, src in srcs.items():
        path = os.path.join(tmp, name + ".cu")
        with open(path, "w") as f:
            f.write(src)
        cmd = [build.nvcc_path(), *build.FLAGS, "-I", CSRC, "-o", os.path.join(tmp, name + ".so"),
               path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:  # a variant the compiler refuses is reported and left out
            print(json.dumps({"variant": name, "nvcc_exit": proc.returncode,
                              "log": log.decode(errors="replace")[-400:]}), flush=True)
            if name == "base":
                return 1
            continue
        lib = ctypes.CDLL(os.path.join(tmp, name + ".so"))
        fn = lib.mars_grid_attention_f32
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(6)
    stream = torch.cuda.current_stream().cuda_stream
    for nh, h, w, d in SHAPES:
        l = h * w
        args = [torch.randn(s, generator=gen, device="cuda") for s in
                ((nh, l, d), (nh, l, d), (nh, l, d), (nh, l, h), (nh, l, w))]
        base, want = None, sa.grid_attention_plain(*args, (h, w))
        for name, fn in libs.items():
            out = torch.empty_like(args[0])

            def call():
                err = fn(*(t.data_ptr() for t in args), out.data_ptr(), nh, l, d, h, w,
                         d ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            base = out.clone() if base is None else base
            print(json.dumps({"shape": [nh, l, d], "variant": name, "ms": ms(call),
                              "max_abs_diff_from_base": (out - base).abs().max().item(),
                              "max_abs_err": (out - want).abs().max().item()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
