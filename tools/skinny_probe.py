#!/usr/bin/env python3
"""Where the bf16 skinny 4-bit GEMM (``gemm_skinny_bf16``, a verify
forward's 9-72 rows) spends its time, on one card.

    python3 tools/skinny_probe.py

Builds source variants of ``mars_tpu_torch/csrc/int4_matmul.cu`` into a
temporary directory (one ``nvcc`` each, all started together) and times the
skinny GEMM of each through ``matmul_int4`` / ``matmul_nf4`` at a LLaMA-7B
layer's three shapes and 9, 36 and 72 rows, device-held warm (one weight,
which the L2 may hold) and cold (rotating through >= 100 MB of weight
copies; ``chip_smoke.held_ms`` / ``cold_ms``):

  base       the source as it is;
  nodequant  each A register is the ldmatrix word itself, not dequantized;
  nomma      no wgmma: the dequantized registers are folded into one
             accumulator with integer ops, so they stay live (the x tile is
             still loaded, no longer read);
  nofixup    no arrival count and no reduction (the partials are written,
             fenced, and no CTA is last);
  batchB     the last CTA's sum with B = 1 or 2 float4 outputs a thread in
             flight at once (the source: SK_FIXUP_BATCH);
  stream     nodequant, nomma and nofixup: the codes' and x's stream alone;
  empty      no block streamed: launch, prologue, partial stores and fence;
  split=S    the source as it is with the K slice count forced to S (1, 2,
             4, 8) in place of ``skinny_split``'s.

Variants other than ``base`` and ``split=S`` compute wrong outputs on
purpose: they only split the time.  Prints one JSON line per row, then the
card's name and power limit.  Imports nothing of JAX.

A throwaway for this version of the kernel: the variants replace exact
source lines of the skinny kernel, and the probe stops with a message when
one is gone.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SRC = os.path.join(ROOT, "mars_tpu_torch", "csrc", "int4_matmul.cu")
DEQUANT = "    for (int j = 0; j < 4; ++j) dequant_step_k<FMT>(a[j], s.x, s.y, code, frag[j]);"
NODEQUANT = ("    for (int j = 0; j < 4; ++j) frag[j][0] = a[j], frag[j][1] = a[j] ^ 1, "
             "frag[j][2] = a[j] ^ 2, frag[j][3] = a[j] ^ 3;")
MMA = "      sm90::wgmma_bf16_rs<N>(acc, frag[j], sm90::desc_sw128(st + 32 * j), 1);"
FOLD = ("      acc[0] = __uint_as_float(__float_as_uint(acc[0]) ^ frag[j][0] ^ frag[j][1] ^ "
        "frag[j][2] ^ frag[j][3]);")
COUNT = "  if (tid == 0) last = atomicAdd(counters + tile, 1) == S * G - 1;"
NOCOUNT = "  if (tid == 0) last = 0;"
BATCH = "constexpr int SK_FIXUP_BATCH = 3; "
SLICE = "  const int kb0 = slice * blocks / S, nb = (slice + 1) * blocks / S - kb0;"
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
ROWS = (9, 36, 72)
SPLITS = (1, 2, 4, 8)


def _in_skinny(src, old, new):
    """``src`` with ``old`` replaced by ``new`` inside the skinny kernel only."""
    start = src.index("gemm_skinny_bf16(const __nv_bfloat16*")
    stop = src.index("cudaError_t launch_skinny(")
    body = src[start:stop]
    if old not in body:
        raise SystemExit(f"the skinny kernel no longer holds a line this probe edits:\n{old}")
    return src[:start] + body.replace(old, new) + src[stop:]


def _batch(src, n):
    """``src`` with the last CTA's sum taking ``n`` float4 outputs at once."""
    if BATCH not in src:
        raise SystemExit(f"the source no longer holds a line this probe edits:\n{BATCH}")
    return src.replace(BATCH, f"constexpr int SK_FIXUP_BATCH = {n}; ")


def variants(src):
    nodequant = _in_skinny(src, DEQUANT, NODEQUANT)
    stream = _in_skinny(_in_skinny(nodequant, MMA, FOLD), COUNT, NOCOUNT)
    return {"base": src, "nodequant": nodequant, "nomma": _in_skinny(src, MMA, FOLD),
            "nofixup": _in_skinny(src, COUNT, NOCOUNT),
            "batch1": _batch(src, 1), "batch2": _batch(src, 2),
            "stream": stream,
            "empty": _in_skinny(stream, SLICE, "  const int kb0 = 0, nb = 0 * blocks;")}


def build(srcs, tmp):
    from mars_tpu_torch.ops import build as b
    from mars_tpu_torch.ops import int4_matmul as im

    procs = {}
    for name, text in srcs.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [b.nvcc_path(), *b.FLAGS, f"-I{b.CSRC_DIR}", "-o", path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        lib.mars_matmul_4bit.argtypes = im._ARGTYPES
        lib.mars_matmul_4bit.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    import torch

    from chip_smoke import cold_copies, cold_ms, held_ms
    from mars_tpu_torch.models import quantization as Q
    from mars_tpu_torch.ops import int4_matmul as im

    with open(SRC) as f:
        srcs = variants(f.read())
    split = im.skinny_split
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(srcs, tmp)
        gen = torch.Generator(device="cuda").manual_seed(4)
        for fmt in ("int4", "nf4"):
            fn = im.matmul_int4 if fmt == "int4" else im.matmul_nf4
            for din, dout in SHAPES:
                w = torch.randn((din, dout), generator=gen, device="cuda")
                leaf = Q.quantize_kernel(w, 4) if fmt == "int4" else Q.quantize_kernel_nf4(w)
                packed, scale = ((leaf["q4"], leaf["scale"]) if fmt == "int4"
                                 else (leaf["nf4"], leaf["bscale"]))
                copies = cold_copies((packed, scale))
                for m in ROWS:
                    x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                    runs = [(name, lib, split) for name, lib in libs.items()]
                    runs += [(f"split={k}", libs["base"],
                              lambda d_in, d_out, rows, k=k: (k, split(d_in, d_out, rows)[1]))
                             for k in SPLITS]
                    for name, lib, skinny_split in runs:
                        im._library = lambda lib=lib: lib
                        im.skinny_split = skinny_split
                        try:
                            warm = held_ms(lambda: fn(x, packed, scale))
                            cold = cold_ms(lambda p, s: fn(x, p, s), copies)
                        finally:
                            im.skinny_split = split
                        print(json.dumps({"variant": name, "kernel": f"matmul_{fmt}",
                                          "shape": [m, din, dout],
                                          "split": skinny_split(din, dout, m)[0],
                                          "held_ms": warm, "cold_ms": cold}), flush=True)
                del copies
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
