#!/usr/bin/env python3
"""Where the bf16 4-bit decode GEMV spends its time, on one card.

    python3 tools/gemv_probe.py

Builds source variants of ``mars_tpu_torch/csrc/int4_matmul.cu`` into a
temporary directory (one ``nvcc`` each, all started together) and times the
bf16 GEMV (``gemv_bf16``, 4 rows) of each through ``matmul_int4`` /
``matmul_nf4`` at the 7B's three decode shapes, warm (one weight, which the
L2 may hold) and cold (rotating through >= 100 MB of weight copies):

  base       the source as it is;
  nodequant  each A register is the ldmatrix word itself, not dequantized;
  nomma      no mma: the dequantized registers and x are folded into one
             accumulator with integer ops, so they stay live;
  nocompute  neither: the stream, ldmatrix and the x loads only;
  nofixup    no arrival count and no reduction (the partials are written,
             fenced, and no CTA is last);
  stream     nocompute and nofixup: the weight stream alone;
  stream_4stages, stream_6stages   the same with a shallower ring;
  empty      no block streamed: launch, prologue, partial stores and fence;
  split=S    the source as it is with the K slice count forced to S (1, 2,
             4, 8, 16) in place of ``gemv_split``'s.

Variants other than ``base`` compute wrong outputs on purpose: they only
split the time.  Times are ``chip_smoke.py``'s device-held ones
(``held_ms``, ``cold_ms``: CUDA events around calls enqueued while the
device is held by ``torch.cuda._sleep``).  Prints one JSON line per row,
then the card's name and power limit.  Imports nothing of JAX.

A throwaway for this version of the kernel: the variants replace exact
source lines, and the probe stops with a message when one is gone.  Adapt
it or delete it when the GEMV is next redesigned.
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
DEQUANT = "      dequant_step<FMT>(a[j], s.x, s.y, code, frag);"
NODEQUANT = "      frag[0] = a[j]; frag[1] = a[j] ^ 1; frag[2] = a[j] ^ 2; frag[3] = a[j] ^ 3;"
MMA = "      mma_16816(acc, frag, __byte_perm(b.x, b.y, 0x5410), __byte_perm(b.x, b.y, 0x7632));"
COUNT = "  if (tid == 0) last = atomicAdd(counters + tile, 1) == S - 1;"
SLICE = "  const int kb0 = slice * blocks / S, nb = (slice + 1) * blocks / S - kb0;"
STAGES = "constexpr int GB_STAGES = 8;"
FOLD = ("      acc[0] = __uint_as_float(__float_as_uint(acc[0]) ^ frag[0] ^ frag[1] ^ frag[2] ^ "
        "frag[3] ^ b.x ^ b.y);")
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
ROWS = 4


def variants(src):
    for line in (DEQUANT, MMA, COUNT, SLICE, STAGES):
        if line not in src:
            raise SystemExit(f"the kernel source no longer holds a line this probe edits:\n"
                             f"{line}")
    nodequant = src.replace(DEQUANT, NODEQUANT)
    nocompute = nodequant.replace(MMA, FOLD)
    nofixup = "  if (tid == 0) last = 0;"
    stream = nocompute.replace(COUNT, nofixup)
    return {"base": src, "nodequant": nodequant, "nomma": src.replace(MMA, FOLD),
            "nocompute": nocompute, "nofixup": src.replace(COUNT, nofixup),
            "stream": stream,
            "stream_4stages": stream.replace(STAGES, "constexpr int GB_STAGES = 4;"),
            "stream_6stages": stream.replace(STAGES, "constexpr int GB_STAGES = 6;"),
            "empty": stream.replace(SLICE, "  const int kb0 = 0, nb = 0 * blocks;")}


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
    split = im.gemv_split
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
                x = torch.randn((ROWS, din), generator=gen, device="cuda").to(torch.bfloat16)
                runs = [(name, lib, split) for name, lib in libs.items()]
                runs += [(f"split={k}", libs["base"], lambda d_in, d_out, k=k: k)
                         for k in (1, 2, 4, 8, 16)]
                for name, lib, gemv_split in runs:
                    im._library = lambda lib=lib: lib
                    im.gemv_split = gemv_split
                    warm = held_ms(lambda: fn(x, packed, scale))
                    cold = cold_ms(lambda p, s: fn(x, p, s), copies)
                    print(json.dumps({"variant": name, "kernel": f"matmul_{fmt}",
                                      "shape": [ROWS, din, dout], "held_ms": warm,
                                      "cold_ms": cold}),
                          flush=True)
                del copies
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
