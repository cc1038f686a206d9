#!/usr/bin/env python3
"""Where the bf16 prefill 4-bit GEMM (``gemm_prefill_bf16``, M > the skinny
GEMM's rows) spends its time, and where the skinny GEMM should hand over to
it, on one card.

    python3 tools/prefill_probe.py              # variants, then the crossover
    python3 tools/prefill_probe.py --crossover  # the crossover only

Builds source variants of ``mars_tpu_torch/csrc/int4_prefill.cu`` into
4-bit libraries in a temporary directory (``ops/build.py``'s translation
units, every variant's started together) and times the
prefill GEMM of each through ``matmul_int4`` / ``matmul_nf4`` at a LLaMA-7B
layer's three shapes and ``chip_smoke.py``'s ragged 1984 -> 999 (the
cp.async variant) at 512 and 2330 rows, device-held (``held_ms``: 20
warm calls on one weight; ``chip_smoke.held_ms``):

  base        the source as it is (its tile rows from ``prefill_rows``);
  rows=N      the tile's x rows forced to N (128, 192, 256);
  unicast     each CTA of a cluster loads its whole x tile itself (both
              halves), no multicast: the same bytes land, twice the L2 reads;
  nodequant   each A register is the ldmatrix word itself, not dequantized;
  nomma       no wgmma: the dequantized registers are folded into one
              accumulator with integer ops, so they stay live (the x tile is
              still loaded, no longer read);
  noepilogue  no output stored (the products still run);
  stream      nodequant and nomma: the ring's copies, barriers and stores;
  empty       no 64-row block streamed: launch, barriers, the stores of zeros.

Variants other than ``base`` and ``rows=N`` compute wrong outputs on
purpose: they only split the time.  Then the crossover: at M = 73, 96, 112,
128, 192, 256 and 257 each format's skinny GEMM and prefill GEMM over a LLaMA-7B
layer's seven projections (q, k, v, o at 4096 -> 4096, gate and up at 4096
-> 11008, down at 11008 -> 4096), device-held, with ``SKINNY_MAX_ROWS``
forced past M (the skinny GEMM) or below it (the prefill GEMM) in this
process.  Prints one JSON line per row, then the card's name and power
limit.  Imports nothing of JAX.

A throwaway for this version of the kernel: the variants replace exact
source lines of the prefill kernel, and the probe stops with a message when
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
SRC = os.path.join(ROOT, "mars_tpu_torch", "csrc", "int4_prefill.cu")
DEQUANT = "    for (int j = 0; j < 4; ++j) dequant_step_k<FMT>(a[j], sc.x, sc.y, code, frag[j]);"
NODEQUANT = ("    for (int j = 0; j < 4; ++j) frag[j][0] = a[j], frag[j][1] = a[j] ^ 1, "
             "frag[j][2] = a[j] ^ 2, frag[j][3] = a[j] ^ 3;")
MMA = ("      sm90::wgmma_bf16_rs<N>(acc, frag[j], sm90::desc_sw128(st + 32 * j), "
       "kb > 0 || j > 0);")
FOLD = ("      acc[0] = __uint_as_float(__float_as_uint(acc[0]) ^ frag[j][0] ^ frag[j][1] ^ "
        "frag[j][2] ^ frag[j][3]);")
STORE = "        if (m >= M || col >= OUT) continue;"
NOSTORE = "        if (m >= 0) continue;"
BLOCKS = "  const int blocks = (IN + PF_BK - 1) / PF_BK;"
NOBLOCKS = "  const int blocks = 0 * IN;"
RELEASE = "    release(prev);\n"
NORELEASE = "    if (blocks > 0) release(prev);\n"
ROWS = ("  p.rows = prefill_rows(M, OUT, sms,\n"
        "                        PF_FMT == FMT_NF4 ? PF_TILE_OVERHEAD_NF4 : PF_TILE_OVERHEAD_INT4);")
MULTICAST = ("          sm90::tma_load_2d_multicast(st + rank * half * 128, &x_map, kb * PF_BK,\n"
             "                                      row0 + (int)rank * half, bar, (1 << CLUSTER) - 1);")
UNICAST = ("          sm90::tma_load_2d(st, &x_map, kb * PF_BK, row0, bar);\n"
           "          sm90::tma_load_2d(st + half * 128, &x_map, kb * PF_BK, row0 + half, bar);")
# a LLaMA-7B layer's shapes (TMA) and chip_smoke.py's ragged one (cp.async)
SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (1984, 999))
PREFILL_ROWS = (512, 2330)
WIDTHS = (128, 192, 256)
# a LLaMA-7B layer's seven projections: (IN, OUT, count)
LAYER = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))
CROSSOVER_ROWS = (73, 96, 112, 128, 192, 256, 257)


def _edit(src, old, new, start="gemm_prefill_bf16(const __grid_constant__",
          stop="// cuTensorMapEncodeTiled, looked up"):
    """``src`` with ``old`` replaced by ``new`` between ``start`` and ``stop``."""
    a, b = src.index(start), src.index(stop)
    body = src[a:b]
    if old not in body:
        raise SystemExit(f"the prefill kernel no longer holds a line this probe edits:\n{old}")
    return src[:a] + body.replace(old, new) + src[b:]


def variants(src):
    out = {"base": src}
    for n in WIDTHS:
        out[f"rows={n}"] = _edit(src, ROWS, f"  p.rows = {n};",
                                 start="Plan plan(const void* x", stop="}  // namespace")
    nodequant = _edit(src, DEQUANT, NODEQUANT)
    stream = _edit(nodequant, MMA, FOLD)
    out.update({"unicast": _edit(src, MULTICAST, UNICAST),
                "nodequant": nodequant, "nomma": _edit(src, MMA, FOLD),
                "noepilogue": _edit(src, STORE, NOSTORE), "stream": stream,
                "empty": _edit(_edit(stream, BLOCKS, NOBLOCKS), RELEASE, NORELEASE)})
    return out


def build(srcs, tmp):
    """{variant: the 4-bit library with that prefill source}, the units of
    every variant compiled at once."""
    from mars_tpu_torch.ops import build as b
    from mars_tpu_torch.ops import int4_matmul as im

    jobs = {}
    for name, text in srcs.items():
        path = os.path.join(tmp, f"{name.replace('=', '')}.cu")
        with open(path, "w") as f:
            f.write(text)
        units = [(os.path.join(b.CSRC_DIR, src + ".cu") if src != "int4_prefill" else path, flags)
                 for src, flags in b.units("int4_matmul")]
        so = path[:-3] + ".so"
        jobs[name] = (b.start_units(units, so), so)
    libs = {}
    for name, (units_jobs, so) in jobs.items():
        rc, log = b.finish_units(units_jobs, so)
        if rc:
            raise SystemExit(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
        lib = ctypes.CDLL(so)
        lib.mars_matmul_4bit.argtypes = im._ARGTYPES
        lib.mars_matmul_4bit.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _weights(fmt, din, dout, gen):
    import torch

    from mars_tpu_torch.models import quantization as Q
    from mars_tpu_torch.ops import int4_matmul as im

    if fmt == "int4":
        q = torch.randint(-7, 8, (din, dout), generator=gen, device="cuda", dtype=torch.int8)
        return im.pack_int4(q), torch.rand((dout,), generator=gen, device="cuda") * 0.1 + 0.01
    leaf = Q.quantize_kernel_nf4(torch.randn((din, dout), generator=gen, device="cuda"))
    return leaf["nf4"], leaf["bscale"]


def probe_variants(smoke):
    import torch

    from mars_tpu_torch.ops import int4_matmul as im

    with open(SRC) as f:
        srcs = variants(f.read())
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(srcs, tmp)
        gen = torch.Generator(device="cuda").manual_seed(4)
        try:
            for fmt in ("int4", "nf4"):
                fn, plain = ((im.matmul_int4, im.matmul_int4_plain) if fmt == "int4"
                             else (im.matmul_nf4, im.matmul_nf4_plain))
                for din, dout in SHAPES:
                    packed, scale = _weights(fmt, din, dout, gen)
                    for m in PREFILL_ROWS:
                        x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                        want = plain(x, packed, scale).float()
                        for name, lib in libs.items():
                            im._library = lambda lib=lib: lib
                            got = fn(x, packed, scale).float()
                            print(json.dumps({
                                "variant": name, "kernel": f"matmul_{fmt}",
                                "shape": [m, din, dout],
                                "max_abs_err": (got - want).abs().max().item(),
                                "tol": 2 ** -7 * want.abs().max().item(),
                                "held_ms": smoke.held_ms(lambda: fn(x, packed, scale))}),
                                flush=True)
        finally:
            im._library = _own_library


def probe_crossover(smoke):
    """The skinny GEMM against the prefill GEMM over a layer's projections."""
    import torch

    from mars_tpu_torch.ops import int4_matmul as im

    gen = torch.Generator(device="cuda").manual_seed(5)
    edge = im.SKINNY_MAX_ROWS
    try:
        for fmt in ("int4", "nf4"):
            fn = im.matmul_int4 if fmt == "int4" else im.matmul_nf4
            weights = {(din, dout): _weights(fmt, din, dout, gen) for din, dout, _ in LAYER}
            for m in CROSSOVER_ROWS:
                layer = {}
                for route, limit in (("skinny", 1 << 30), ("gemm", im.GEMV_MAX_ROWS)):
                    im.SKINNY_MAX_ROWS = limit
                    total = 0.0
                    for din, dout, count in LAYER:
                        packed, scale = weights[(din, dout)]
                        x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                        assert im.route(m, torch.bfloat16) == route
                        ms = smoke.held_ms(lambda: fn(x, packed, scale))
                        total += count * ms
                        print(json.dumps({"crossover": route, "kernel": f"matmul_{fmt}",
                                          "shape": [m, din, dout], "held_ms": ms}), flush=True)
                    layer[route] = total
                print(json.dumps({"crossover": "layer", "kernel": f"matmul_{fmt}", "rows": m,
                                  "skinny_ms": layer["skinny"], "gemm_ms": layer["gemm"],
                                  "faster": min(layer, key=layer.get)}), flush=True)
    finally:
        im.SKINNY_MAX_ROWS = edge


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_own_library = None


def main(argv):
    global _own_library
    from mars_tpu_torch import device as device_lib
    from mars_tpu_torch.ops import int4_matmul as im

    device_lib.resolve("cuda")
    _own_library = im._library
    smoke = _chip_smoke()
    if "--crossover" not in argv:
        probe_variants(smoke)
    probe_crossover(smoke)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
