#!/usr/bin/env python3
"""A/B the CUDA kernels of two or more mars_tpu_torch checkouts on one card.

    python3 tools/torch_kernel_ab.py PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --text-path PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --grid PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --notap PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --tap PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --windowed PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --profile PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --verify PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --prefill PARENT_ROOT CHANGE_ROOT CHANGE_ROOT PARENT_ROOT
    python3 tools/torch_kernel_ab.py --text-cli PARENT_ROOT CHANGE_ROOT

Each ROOT is the top of a checkout holding ``mars_tpu_torch/``.  The roots
run one after another, in the order given (repeat them to alternate), each
in its own process that builds that checkout's kernels and times, with CUDA
events on the same seeded inputs, ``attention_with_tap`` at the ranking
path's shapes, ``attention_notap`` at the untapped blocks' shapes (an
AlphaCLIP-L chunk, DINOv2-L, CLIP-B) and ``windowed_attention`` at SAM
ViT-H's windowed layer (each in float32 and bfloat16), ``grid_attention`` at
SAM ViT-H's and ViT-B's global layers (both types), and
the auction (``_auction_phase_kernel``, every ε-phase of an instance) on
the forward and reverse matching instances of synthetic episode 0 and
the dense contested instance of ``chip_smoke.py``, with its rounds, the
microseconds a round and a digest of the assignment and prices (the same in
every root: the kernel is bit-exact), and
``matmul_int4`` / ``matmul_nf4``: the bf16 decode GEMV at the 7B's three
decode shapes at 1 and 4 rows, warm (20 calls on one weight, which the L2
may hold), device-held, and cold (the calls rotate through copies of the weight totalling
>= 100 MB, twice the L2), beside cuBLAS on the dense bf16 weight timed both
ways; the float32 GEMV at 4 x 4096 -> 11008; the bf16 prefill GEMM at
``chip_smoke.py``'s shapes (512 and 2330 rows).
With ``--text-path`` each root runs ``chip_smoke.py``'s text-path phase
instead (one ViP-LLaVA-7B text block per format, int4 then NF4, through that
root's package): block ms, prefill ms and decode ms per step.  With
``--grid`` each root builds only its grid library and times only the
``grid_attention`` rows, each with its largest difference from
``grid_attention_plain`` and a digest of its output (equal digests: bitwise
equal outputs).  With ``--notap`` each root builds only its notap library
and times only ``attention_notap``, in both types at every
``chip_smoke.NOTAP_GEOMETRIES`` shape and at (1, 12, 1374, 64), whose 132
float32 CTAs fill the card's 132 SMs once (the time of one full wave, which
DINOv2-L's 176 CTAs at B = 1 take twice), each row with its largest
difference from ``attention_notap_plain``, a digest and its time with the
device held (``held_ms``: a ~40 µs kernel's ``ms`` may read the host's
enqueue pace), then a digest of
each notap kernel's machine code (its SASS instructions, addresses left
out: equal digests, the same code).  With ``--tap`` each root builds only
its tap library and times ``attention_with_tap`` in both types at
``chip_smoke.GEOMETRIES + BACKBONE_GEOMETRIES``, warm and device-held, each
row with its largest differences from ``attention_with_tap_plain`` (output,
tap) and a digest of its output and tap, then the SASS digests of the tap
kernels.  With ``--windowed`` each root builds
only its windowed and grid libraries and times ``windowed_attention`` at
SAM ViT-H's and ViT-B's windowed layers in both types, warm and
device-held, beside SDPA with the bias expanded, each row with its largest
difference from ``windowed_attention_plain`` and a digest of its output
(bfloat16 digests equal across roots: the same outputs), then the
``grid_attention`` rows (the float32 grid kernel shares the windowed one's
sweep) and the SASS digests of both libraries' kernels.  With
``--profile`` each root runs
``chip_smoke.py``'s ``phase_profile``: one float32 ranking episode under
torch.profiler with the notap switch off, then on.  With ``--verify`` each
root builds only its 4-bit library and times ``matmul_int4`` /
``matmul_nf4`` at a LLaMA-7B layer's three shapes at a verify forward's
rows (9, 18, 36, 72) and past them (``CROSSOVER_ROWS``), warm, device-held
and cold beside cuBLAS on the dense bf16 weight, with the host's enqueue
time, the largest difference from the plain version and a digest; a root
with the skinny GEMM sends every M > 8 through it (``SKINNY_MAX_ROWS``
raised in that process), so the rows past 72 find the crossover with
another root's 128-row GEMM.  With ``--prefill`` each root builds only its
4-bit library and times ``matmul_int4`` / ``matmul_nf4`` at
``chip_smoke.py``'s prefill shapes and rows (512, 2330), warm, device-held
and cold beside cuBLAS on the dense bf16 weight, each row with its largest
difference from the plain version, whether a rerun is bitwise equal, and a
digest (the prefill GEMM has no K split: every root's digest is the same
where their sums run in the same order).  With ``--text-cli`` each root runs
``chip_smoke.py``'s ``phase_text_cli`` and ``phase_profile_text`` (the
M of every 4-bit launch; the 4-bit kernels' device ms by kernel and by what
launched them).
The timers are this checkout's ``chip_smoke.py``'s, for every root:
``ms`` is CUDA events around 20 warm calls (``cuda_ms``; the auction's
instances 5, every phase a call); the decode rows
also carry device-held times (``held_ms``, ``cold_ms`` and cuBLAS's
``library_held_ms``, ``library_cold_ms``: CUDA events around calls
enqueued while the device is held) and the host's enqueue time a call
(``host_us``, ``library_host_us``).  Prints one JSON line per root and
shape, then the card's name and power limit.  Imports nothing of JAX.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

TAP_SHAPES = ((16, 1374, 64), (12, 1090, 64))
NOTAP_SHAPES = ((16, 16, 577, 64), (1, 16, 1374, 64), (1, 12, 1090, 64))
# (windows, heads, Hw, Ww, hd): SAM ViT-H's and ViT-B's windowed layers
WINDOW_SHAPES = ((25, 16, 14, 14, 80), (25, 12, 14, 14, 64))
# (heads, grid H, grid W, hd, types): ViT-H and ViT-B global layers
GRID_SHAPES = ((16, 64, 64, 80, ("float32", "bfloat16")),
               (12, 64, 64, 64, ("float32", "bfloat16")))
DECODE_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
DECODE_ROWS = (1, 4)
PREFILL_SHAPES = DECODE_SHAPES + ((5120, 4096), (1024, 4096), (1984, 999))
PREFILL_ROWS = (512, 2330)
# a verify forward's rows (B x 9 at 8 draft tokens), then rows past them: the
# pipelined text stage's suffix forwards take 128
VERIFY_ROWS = (9, 18, 36, 72)
CROSSOVER_ROWS = (73, 96, 128, 168, 256)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, B, H, L, D): one full wave of the float32 notap kernel's 128-row CTAs
NOTAP_WAVE = (("one_wave_132_ctas", 1, 12, 1374, 64),)


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` (its timers and its text-path
    phase), whatever a root holds: every root is timed by one yardstick."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_us(fn, iters=200):
    """Host microseconds a call of ``fn`` takes to enqueue (the wrapper's
    checks, its ctypes call, the launch), with the device held so that no
    call waits on it: what a host-bound decode step pays a call."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e5 * iters))  # ~0.1 ms of device time a call, past the host's pace
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return host


def text_worker(root):
    """chip_smoke.phase_text_path on ``root``'s package: its rows tagged
    with the root."""
    chip_smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch import device as device_lib

    device_lib.resolve("cuda")
    chip_smoke.emit = lambda obj: print(json.dumps({"root": root, **obj}), flush=True)
    chip_smoke.phase_text_path({})


def auction_rows(smoke, emit):
    """The auction's instances: each ε-phase of one instance launched in
    turn, as ``chip_smoke.phase_auction`` times them."""
    import hashlib

    import torch

    from mars_tpu_torch.ops import assignment as asg

    cases = [(name, s, v, 1, 128) for name, s, v in smoke._matching_instances()]
    for name, seed, t, n, phases in smoke.AUCTION_CASES:
        if name.startswith("dense_contested"):
            s, v = smoke.auction_case(seed, t, n)
            cases.append((name, torch.from_numpy(s).cuda(), torch.from_numpy(v).cuda(), phases,
                          None))
    for name, s, v, phases, chunk in cases:
        scores, valid, _, eps = asg.phase_inputs(s, v, phases, chunk)

        def run():
            return smoke.auction_phases(asg._auction_phase_kernel, scores, valid, eps)

        col, prices, counts = run()
        rounds = sum(c[0] + c[1] for c in counts)
        ms = smoke.cuda_ms(run, iters=5, warmup=1)
        digest = hashlib.sha256(col.cpu().numpy().tobytes()
                                + prices.cpu().numpy().tobytes()).hexdigest()[:16]
        emit(kernel="auction", instance=name, shape=list(scores.shape), phases=phases,
             rounds={"dense": sum(c[0] for c in counts), "small": sum(c[1] for c in counts)},
             ms=ms, us_per_round=ms * 1e3 / max(rounds, 1), digest=digest)


def digest(t):
    """A hash of a tensor's bytes: equal digests, bitwise equal tensors."""
    import hashlib

    import torch

    return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def grid_rows(smoke, emit, gen):
    import torch

    from mars_tpu_torch.ops import sam_attention as sa

    for nh, hg, wg, d, dtypes in GRID_SHAPES:
        for dt in dtypes:
            l = hg * wg
            args = [torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
                    for shape in ((nh, l, d), (nh, l, d), (nh, l, d), (nh, l, hg), (nh, l, wg))]
            out = sa.grid_attention(*args, (hg, wg))
            want = sa.grid_attention_plain(*args, (hg, wg))
            err = (out.float() - want.float()).abs().max().item()
            emit(kernel="grid_attention", shape=[nh, l, d], grid=[hg, wg], dtype=dt,
                 ms=smoke.cuda_ms(lambda: sa.grid_attention(*args, (hg, wg))),
                 max_abs_err=err, digest=digest(out))


def grid_worker(root):
    import torch

    smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch.ops import build

    build.build_all(["sam_grid_attention"])
    grid_rows(smoke, lambda **row: print(json.dumps({"root": root, **row}), flush=True),
              torch.Generator(device="cuda").manual_seed(0))


def notap_rows(smoke, emit, gen):
    import torch

    from mars_tpu_torch.ops import flash_attention as fa

    for name, b, h, l, d in smoke.NOTAP_GEOMETRIES + NOTAP_WAVE:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            out = fa.attention_notap(q, k, v)
            err = (out.float() - fa.attention_notap_plain(q, k, v).float()).abs().max().item()
            emit(kernel="attention_notap", geometry=name, shape=[b, h, l, d], dtype=dt,
                 ms=smoke.cuda_ms(lambda: fa.attention_notap(q, k, v)),
                 held_ms=smoke.held_ms(lambda: fa.attention_notap(q, k, v)), max_abs_err=err,
                 digest=digest(out))


def sass_digests(path, kernels=r"notap_(?:bf16|f32)ILi\d+E"):
    """{kernel instantiation: digest of its SASS instructions} for the
    kernels of one library whose names match the regex ``kernels``, the
    instructions' addresses left out."""
    import hashlib
    import re

    from mars_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    code, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            m = re.search(rf"Function : \S*?({kernels})", ln)
            fn = m.group(1) if m else None
            if fn:
                code[fn] = []
        elif fn and "/*" in ln:
            code[fn].append(re.sub(r"/\*.*?\*/", "", ln).strip())
    return {k: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16] for k, v in code.items()}


def notap_worker(root):
    import torch

    smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch.ops import build

    build.build_all(["attention_notap"])

    def emit(**row):
        print(json.dumps({"root": root, **row}), flush=True)

    notap_rows(smoke, emit, torch.Generator(device="cuda").manual_seed(0))
    emit(kernel="attention_notap", sass=sass_digests(build.library_path("attention_notap")))


def tap_worker(root):
    import torch

    smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch.ops import build, flash_attention as fa

    build.build_all(["attention_tap"])

    def emit(**row):
        print(json.dumps({"root": root, **row}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, h, l, d in smoke.GEOMETRIES + smoke.BACKBONE_GEOMETRIES:
        for dt in ("float32", "bfloat16"):
            q, k, v = (torch.randn((h, l, d), generator=gen, device="cuda").to(getattr(torch, dt))
                       for _ in range(3))
            out, tap = fa.attention_with_tap(q, k, v)
            want_out, want_tap = fa.attention_with_tap_plain(q, k, v)
            emit(kernel="attention_with_tap", geometry=name, shape=[h, l, d], dtype=dt,
                 ms=smoke.cuda_ms(lambda: fa.attention_with_tap(q, k, v)),
                 held_ms=smoke.held_ms(lambda: fa.attention_with_tap(q, k, v)),
                 max_abs_err_out=(out.float() - want_out.float()).abs().max().item(),
                 max_abs_err_tap=(tap - want_tap).abs().max().item(),
                 digest=digest(out) + digest(tap))
    emit(kernel="attention_with_tap", sass=sass_digests(
        build.library_path("attention_tap"), r"tap_(?:out|mean)_(?:bf16|f32)(?:ILi\d+E)?"))


def windowed_rows(smoke, emit, gen):
    import torch
    import torch.nn.functional as F

    from mars_tpu_torch.ops import sam_attention as sa

    for b, nh, hw, ww, d in WINDOW_SHAPES:
        for dt in ("float32", "bfloat16"):
            l = hw * ww
            args = [torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
                    for shape in ((b, nh, l, d), (b, nh, l, d), (b, nh, l, d), (b, nh, l, hw),
                                  (b, nh, l, ww))]
            out = sa.windowed_attention(*args, (hw, ww))
            want = sa.windowed_attention_plain(*args, (hw, ww))
            cols = torch.arange(l, device="cuda")
            mask = args[3][..., cols // ww] + args[4][..., cols % ww]
            emit(kernel="windowed_attention", shape=[b, nh, l, d], dtype=dt,
                 ms=smoke.cuda_ms(lambda: sa.windowed_attention(*args, (hw, ww))),
                 held_ms=smoke.held_ms(lambda: sa.windowed_attention(*args, (hw, ww))),
                 library_ms=smoke.cuda_ms(lambda: F.scaled_dot_product_attention(
                     *args[:3], attn_mask=mask)),
                 max_abs_err=(out.float() - want.float()).abs().max().item(),
                 digest=digest(out))


def windowed_worker(root):
    import torch

    smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch.ops import build

    build.build_all(["sam_windowed_attention", "sam_grid_attention"])

    def emit(**row):
        print(json.dumps({"root": root, **row}), flush=True)

    windowed_rows(smoke, emit, torch.Generator(device="cuda").manual_seed(0))
    grid_rows(smoke, emit, torch.Generator(device="cuda").manual_seed(0))
    emit(kernel="windowed_attention", sass=sass_digests(
        build.library_path("sam_windowed_attention"),
        r"windowed_(?:bf16_resident|bf16_streamed|f32)I(?:Li\d+E)+"))
    emit(kernel="grid_attention", sass=sass_digests(build.library_path("sam_grid_attention"),
                                                    r"grid_(?:bf16|f32)I(?:Li\d+E)+"))


def profile_worker(root):
    """chip_smoke.phase_profile on ``root``'s package: its rows tagged with
    the root."""
    chip_smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch import device as device_lib

    device_lib.resolve("cuda")
    chip_smoke.emit = lambda obj: print(json.dumps({"root": root, **obj}), flush=True)
    chip_smoke.phase_profile({})


def text_cli_worker(root):
    """chip_smoke.phase_text_cli, then phase_profile_text, on ``root``'s
    package: their rows tagged with the root."""
    chip_smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch import device as device_lib

    device_lib.resolve("cuda")
    chip_smoke.emit = lambda obj: print(json.dumps({"root": root, **obj}), flush=True)
    chip_smoke.phase_text_cli({})
    chip_smoke.phase_profile_text({})


def verify_worker(root):
    import torch

    smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch.models import quantization as Q
    from mars_tpu_torch.ops import build, int4_matmul as im

    build.build_all(["int4_matmul"])
    skinny = hasattr(im, "SKINNY_MAX_ROWS")
    if skinny:
        im.SKINNY_MAX_ROWS = 1 << 30
    gen = torch.Generator(device="cuda").manual_seed(4)
    for fmt in ("int4", "nf4"):
        fn, plain = ((im.matmul_int4, im.matmul_int4_plain) if fmt == "int4"
                     else (im.matmul_nf4, im.matmul_nf4_plain))
        for din, dout in DECODE_SHAPES:
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
            weights, denses = smoke.cold_copies((packed, scale)), smoke.cold_copies((dense,))
            for m in VERIFY_ROWS + CROSSOVER_ROWS:
                x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                got, want = fn(x, packed, scale), plain(x, packed, scale)
                rerun_equal = bool(torch.equal(got, fn(x, packed, scale)))
                nbytes = x.numel() * 2 + packed.numel() + scale.numel() * 4 + m * dout * 2
                bound, by = smoke._bound_ms(nbytes, 2.0 * m * din * dout)
                print(json.dumps({
                    "root": root, "kernel": f"matmul_{fmt}", "shape": [m, din, dout],
                    "route": "skinny" if skinny else "gemm",
                    "split": list(im.skinny_split(din, dout, m)) if skinny else None,
                    "max_abs_err": (got.float() - want.float()).abs().max().item(),
                    "tol": 2 ** -7 * want.float().abs().max().item(),
                    "rerun_equal": rerun_equal, "digest": digest(got),
                    "ms": smoke.cuda_ms(lambda: fn(x, packed, scale)),
                    "held_ms": smoke.held_ms(lambda: fn(x, packed, scale)),
                    "cold_ms": smoke.cold_ms(lambda p, s: fn(x, p, s), weights),
                    "library_ms": smoke.cuda_ms(lambda: x @ dense),
                    "library_held_ms": smoke.held_ms(lambda: x @ dense),
                    "library_cold_ms": smoke.cold_ms(lambda w: x @ w, denses),
                    "host_us": host_us(lambda: fn(x, packed, scale)),
                    "library_host_us": host_us(lambda: x @ dense),
                    "bound_ms": bound, "bound_by": by}), flush=True)
            del dense, weights, denses


def prefill_worker(root):
    import torch

    smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch.models import quantization as Q
    from mars_tpu_torch.ops import build, int4_matmul as im

    build.build_all(["int4_matmul"])
    gen = torch.Generator(device="cuda").manual_seed(4)
    for fmt in ("int4", "nf4"):
        fn, plain = ((im.matmul_int4, im.matmul_int4_plain) if fmt == "int4"
                     else (im.matmul_nf4, im.matmul_nf4_plain))
        for din, dout in PREFILL_SHAPES:
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
            weights, denses = smoke.cold_copies((packed, scale)), smoke.cold_copies((dense,))
            for m in PREFILL_ROWS:
                x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                got, want = fn(x, packed, scale), plain(x, packed, scale)
                nbytes = x.numel() * 2 + packed.numel() + scale.numel() * 4 + m * dout * 2
                bound, by = smoke._bound_ms(nbytes, 2.0 * m * din * dout)
                print(json.dumps({
                    "root": root, "kernel": f"matmul_{fmt}", "shape": [m, din, dout],
                    "max_abs_err": (got.float() - want.float()).abs().max().item(),
                    "tol": 2 ** -7 * want.float().abs().max().item(),
                    "rerun_equal": bool(torch.equal(got, fn(x, packed, scale))),
                    "digest": digest(got),
                    "ms": smoke.cuda_ms(lambda: fn(x, packed, scale)),
                    "held_ms": smoke.held_ms(lambda: fn(x, packed, scale)),
                    "cold_ms": smoke.cold_ms(lambda p, s: fn(x, p, s), weights),
                    "library_ms": smoke.cuda_ms(lambda: x @ dense),
                    "library_held_ms": smoke.held_ms(lambda: x @ dense),
                    "library_cold_ms": smoke.cold_ms(lambda w: x @ w, denses),
                    "bound_ms": bound, "bound_by": by}), flush=True)
            del dense, weights, denses


def worker(root):
    import torch

    smoke = _chip_smoke()
    sys.path.insert(0, root)
    from mars_tpu_torch.models import quantization as Q
    from mars_tpu_torch.ops import build, flash_attention as fa, int4_matmul as im
    from mars_tpu_torch.ops import sam_attention as sa

    build.build_all(["attention_tap", "attention_notap", "sam_grid_attention",
                     "sam_windowed_attention", "auction", "int4_matmul"])

    def emit(**row):
        print(json.dumps({"root": root, **row}), flush=True)

    auction_rows(smoke, emit)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, l, d in TAP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((h, l, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            emit(kernel="attention_with_tap", shape=[h, l, d], dtype=str(dtype)[6:],
                 ms=smoke.cuda_ms(lambda: fa.attention_with_tap(q, k, v)))
    for b, h, l, d in NOTAP_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, h, l, d), generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            emit(kernel="attention_notap", shape=[b, h, l, d], dtype=str(dtype)[6:],
                 ms=smoke.cuda_ms(lambda: fa.attention_notap(q, k, v)))
    for b, nh, hw, ww, d in WINDOW_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            l = hw * ww
            args = [torch.randn(shape, generator=gen, device="cuda").to(dtype) for shape in
                    ((b, nh, l, d), (b, nh, l, d), (b, nh, l, d), (b, nh, l, hw), (b, nh, l, ww))]
            emit(kernel="windowed_attention", shape=[b, nh, l, d], dtype=str(dtype)[6:],
                 ms=smoke.cuda_ms(lambda: sa.windowed_attention(*args, (hw, ww))))
    grid_rows(smoke, emit, gen)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for fmt in ("int4", "nf4"):
        fn = im.matmul_int4 if fmt == "int4" else im.matmul_nf4
        for din, dout in PREFILL_SHAPES:
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
            if (din, dout) in DECODE_SHAPES:
                dense = Q.dequantize_kernel(leaf).to(torch.bfloat16)
                weights, denses = smoke.cold_copies((packed, scale)), smoke.cold_copies((dense,))
                for m in DECODE_ROWS:
                    x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                    emit(kernel=f"matmul_{fmt}", shape=[m, din, dout], dtype="bfloat16",
                         ms=smoke.cuda_ms(lambda: fn(x, packed, scale)),
                         held_ms=smoke.held_ms(lambda: fn(x, packed, scale)),
                         cold_ms=smoke.cold_ms(lambda p, s: fn(x, p, s), weights),
                         library_ms=smoke.cuda_ms(lambda: x @ dense),
                         library_held_ms=smoke.held_ms(lambda: x @ dense),
                         library_cold_ms=smoke.cold_ms(lambda w: x @ w, denses),
                         host_us=host_us(lambda: fn(x, packed, scale)),
                         library_host_us=host_us(lambda: x @ dense))
                if (din, dout) == (4096, 11008):
                    x = torch.randn((4, din), generator=gen, device="cuda")
                    emit(kernel=f"matmul_{fmt}", shape=[4, din, dout], dtype="float32",
                         ms=smoke.cuda_ms(lambda: fn(x, packed, scale)))
                del dense, weights, denses
            for m in PREFILL_ROWS:
                x = torch.randn((m, din), generator=gen, device="cuda").to(torch.bfloat16)
                emit(kernel=f"matmul_{fmt}", shape=[m, din, dout], dtype="bfloat16",
                     ms=smoke.cuda_ms(lambda: fn(x, packed, scale)))


def main(argv):
    workers = {"--worker": worker, "--text-worker": text_worker, "--grid-worker": grid_worker,
               "--notap-worker": notap_worker, "--windowed-worker": windowed_worker,
               "--tap-worker": tap_worker,
               "--profile-worker": profile_worker, "--verify-worker": verify_worker,
               "--prefill-worker": prefill_worker, "--text-cli-worker": text_cli_worker}
    if len(argv) >= 2 and argv[0] in workers:
        workers[argv[0]](os.path.abspath(argv[1]))
        return 0
    mode = "--worker"
    modes = {"--text-path": "--text-worker", "--grid": "--grid-worker",
             "--notap": "--notap-worker", "--windowed": "--windowed-worker",
             "--tap": "--tap-worker",
             "--profile": "--profile-worker", "--verify": "--verify-worker",
             "--prefill": "--prefill-worker", "--text-cli": "--text-cli-worker"}
    if argv and argv[0] in modes:
        mode, argv = modes[argv[0]], argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for root in argv:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), mode, root]).returncode
        if rc:
            return rc
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
