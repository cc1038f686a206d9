#!/usr/bin/env python3
"""Where the bf16 windowed-attention kernel spends its time, on one card.

    python3 tools/windowed_probe.py

Builds source variants of ``mars_tpu_torch/csrc/sam_windowed_attention.cu``
into a temporary directory (one ``nvcc`` each, all started together) and
times each one's bf16 entry point with CUDA events at SAM ViT-H's windowed
layer (400 window-heads of 14 x 14 tokens, head dim 80) and at head dim 64:

  base           the source as it is;
  nobias         logits without the bias lookups (s * scale only);
  noload         without loading the bias rows into shared memory;
  inline_tables  each key's window row and column by division in place of
                 the shared tables.

Variants other than ``base`` compute wrong outputs on purpose: they only
split the time.  Beside them it times ``attention_notap`` at the same shape
(no bias, single sweep) and the base kernel on the first 132 and 264
window-heads.  Prints one JSON line per row, then the card's name and power
limit.  Imports nothing of JAX.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mars_tpu_torch", "csrc")
LOGIT = """      s[i] = key < L ? __fadd_rn(__fadd_rn(__fmul_rn(s[i], scale), bh[r * hg + ky[key]]),
                                 bw[r * wg + kx[key]])
                     : -INFINITY;"""
BIAS_LOADS = """    load_rows(bh, bias_h + brow * hg, min(BQ, L - q0) * hg, BQ * hg);
    load_rows(bw, bias_w + brow * wg, min(BQ, L - q0) * wg, BQ * wg);
"""


def variants(src):
    if LOGIT not in src or BIAS_LOADS not in src:
        raise SystemExit("the kernel source no longer holds the lines this probe edits")
    return {"base": src,
            "nobias": src.replace(LOGIT, "      s[i] = key < L ? __fmul_rn(s[i], scale) : -INFINITY;"
                                         " (void)r;"),
            "noload": src.replace(BIAS_LOADS, ""),
            "inline_tables": src.replace("bh[r * hg + ky[key]]", "bh[r * hg + key / wg]").replace(
                "bw[r * wg + kx[key]]", "bw[r * wg + key % wg]")}


def ms(fn, iters=50, warmup=5):
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
    from mars_tpu_torch.ops import build, flash_attention as fa, sam_attention as sa

    if not torch.cuda.is_available():
        print("windowed_probe: CUDA is not available", file=sys.stderr)
        return 1
    with open(os.path.join(CSRC, "sam_windowed_attention.cu")) as f:
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
        if proc.returncode:
            print(f"{name}: nvcc exit {proc.returncode}\n{log.decode(errors='replace')}")
            return 1
        lib = ctypes.CDLL(os.path.join(tmp, name + ".so"))
        fn = lib.mars_windowed_attention_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn

    gen = torch.Generator(device="cuda").manual_seed(6)
    stream = torch.cuda.current_stream().cuda_stream
    for b, nh, h, w, d in ((25, 16, 14, 14, 80), (25, 16, 14, 14, 64)):
        l = h * w
        args = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in
                ((b, nh, l, d), (b, nh, l, d), (b, nh, l, d), (b, nh, l, h), (b, nh, l, w))]
        want = sa.windowed_attention(*args, (h, w))
        for name, fn in libs.items():
            out = torch.empty_like(args[0])

            def call():
                err = fn(*(t.data_ptr() for t in args), out.data_ptr(), b * nh, l, d, h, w,
                         d ** -0.5, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            print(json.dumps({"shape": [b, nh, l, d], "variant": name, "ms": ms(call),
                              "equal_to_base": bool(torch.equal(out, want))}), flush=True)
        q, k, v = args[:3]
        print(json.dumps({"shape": [b, nh, l, d], "variant": "notap_same_shape",
                          "ms": ms(lambda: fa.attention_notap(q, k, v))}), flush=True)
        for heads in (132, 264):
            sub = [a.reshape(b * nh, l, -1)[:heads].reshape(1, heads, l, -1).contiguous()
                   for a in args]
            print(json.dumps({"shape": [1, heads, l, d], "variant": "base_subset",
                              "ms": ms(lambda: sa.windowed_attention(*sub, (h, w)))}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
