#!/usr/bin/env python3
"""A/B the CUDA kernels of two or more mars_tpu_torch checkouts on one card.

    python3 tools/torch_kernel_ab.py PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT

Each ROOT is the top of a checkout holding ``mars_tpu_torch/``.  The roots
run one after another, in the order given (repeat them to alternate), each
in its own process that builds that checkout's kernels and times, with CUDA
events on the same seeded inputs, ``attention_with_tap`` at the ranking
path's shapes, ``attention_notap`` at the untapped blocks' shapes (an
AlphaCLIP-L chunk, DINOv2-L, CLIP-B) and ``windowed_attention`` at SAM
ViT-H's windowed layer (each in float32 and bfloat16), ``grid_attention`` at
SAM ViT-H's global layer (both types) and ViT-B's (bfloat16), and
``matmul_int4`` / ``matmul_nf4`` at ``chip_smoke.py``'s shapes (bfloat16, 4
decode rows and 2330 prefill rows).
Prints one JSON line per root and shape, then the card's name and power
limit.  Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

TAP_SHAPES = ((16, 1374, 64), (12, 1090, 64))
NOTAP_SHAPES = ((16, 16, 577, 64), (1, 16, 1374, 64), (1, 12, 1090, 64))
WINDOW_SHAPES = ((25, 16, 14, 14, 80),)  # (windows, heads, Hw, Ww, hd)
# (heads, grid H, grid W, hd, types): ViT-H and ViT-B global layers
GRID_SHAPES = ((16, 64, 64, 80, ("float32", "bfloat16")), (12, 64, 64, 64, ("bfloat16",)))
QUANT_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (5120, 4096), (1024, 4096),
                (1984, 999))
QUANT_ROWS = (4, 2330)


def _ms(fn, iters=20, warmup=3):
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


def worker(root):
    import torch

    sys.path.insert(0, root)
    from mars_tpu_torch.models import quantization as Q
    from mars_tpu_torch.ops import build, flash_attention as fa, int4_matmul as im
    from mars_tpu_torch.ops import sam_attention as sa

    build.build_all(["attention_tap", "attention_notap", "sam_grid_attention",
                     "sam_windowed_attention", "int4_matmul"])

    def emit(**row):
        print(json.dumps({"root": root, **row}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, l, d in TAP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((h, l, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            emit(kernel="attention_with_tap", shape=[h, l, d], dtype=str(dtype)[6:],
                 ms=_ms(lambda: fa.attention_with_tap(q, k, v)))
    for b, h, l, d in NOTAP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            emit(kernel="attention_notap", shape=[b, h, l, d], dtype=str(dtype)[6:],
                 ms=_ms(lambda: fa.attention_notap(q, k, v)))
    for b, nh, hw, ww, d in WINDOW_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            l = hw * ww
            args = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for shape in
                    ((b, nh, l, d), (b, nh, l, d), (b, nh, l, d), (b, nh, l, hw), (b, nh, l, ww))]
            emit(kernel="windowed_attention", shape=[b, nh, l, d], dtype=str(dtype)[6:],
                 ms=_ms(lambda: sa.windowed_attention(*args, (hw, ww))))
    for nh, hg, wg, d, dtypes in GRID_SHAPES:
        for dt in dtypes:
            l = hg * wg
            args = [torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
                    for shape in ((nh, l, d), (nh, l, d), (nh, l, d), (nh, l, hg), (nh, l, wg))]
            emit(kernel="grid_attention", shape=[nh, l, d], grid=[hg, wg], dtype=dt,
                 ms=_ms(lambda: sa.grid_attention(*args, (hg, wg))))
    gen = torch.Generator(device="cuda").manual_seed(4)
    for fmt in ("int4", "nf4"):
        fn = im.matmul_int4 if fmt == "int4" else im.matmul_nf4
        for din, dout in QUANT_SHAPES:
            if fmt == "int4":
                q = torch.randint(-7, 8, (din, dout), generator=gen, device="cuda",
                                  dtype=torch.int8)
                packed = im.pack_int4(q)
                scale = torch.rand((dout,), generator=gen, device="cuda") * 0.1 + 0.01
            else:
                leaf = Q.quantize_kernel_nf4(torch.randn((din, dout), generator=gen,
                                                         device="cuda"))
                packed, scale = leaf["nf4"], leaf["bscale"]
            for m in QUANT_ROWS:
                x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                emit(kernel=f"matmul_{fmt}", shape=[m, din, dout], dtype="bfloat16",
                     ms=_ms(lambda: fn(x, packed, scale)))


def main(argv):
    if len(argv) >= 2 and argv[0] == "--worker":
        worker(os.path.abspath(argv[1]))
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root]).returncode
        if rc:
            return rc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
