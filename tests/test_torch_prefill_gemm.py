"""The arithmetic of the bfloat16 prefill GEMM (``csrc/int4_prefill.cu``,
``gemm_prefill_bf16``: M > ``SKINNY_MAX_ROWS``, prefill and the 512-row
suffix forwards) emulated in PyTorch on the CPU, held against the port's
plain version and the JAX Pallas kernels (interpret mode, as
``tests/test_torch_int4_matmul.py`` runs them), and the kernel's tile
constants.

The kernel cannot run here; the emulation pins what it computes: the ring's
zero fill (x rows past M and inputs past IN, code bytes past IN / 2 and OUT
read as zeros, so int4's padded even rows decode to -8 against zero x),
float32 sums of k16 steps (wgmma m64nNk16) in K order through every 64-row
block, no K split, int4's column scale after the sum, one rounding to bf16.
Tiles of any width sum each output in that one order, so the tile's x rows
(``prefill_rows``) change no bit.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mars_tpu_torch.models import quantization as TQ
from mars_tpu_torch.ops import int4_matmul as tim
from test_torch_gemv import CARD_REL, _against_jax, _leaf

CSRC = Path(tim.__file__).resolve().parent.parent / "csrc"
SOURCES = ("int4_prefill.cu", "int4_dequant.cuh")  # the kernel, the formats' constants
SMEM_PER_BLOCK = 227 * 1024  # an H100's shared memory a block can use
REGISTERS_PER_SM = 65536
# chip_smoke.QUANT_SHAPES' (IN, OUT): a LLaMA-7B layer, the projector, CLIP-L's fc1, a ragged one
QUANT_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (5120, 4096), (1024, 4096),
                (1984, 999))


def _consts():
    src = "".join((CSRC / name).read_text() for name in SOURCES)

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([0-9 *+-]+);", src).group(1)
        return int(eval(expr))  # integer literals and * + - only (the pattern above)

    names = ("PF_COLS", "PF_BK", "PF_CONSUMERS", "PF_THREADS", "PF_MAX_STAGES", "PF_LAG",
             "PF_PRODUCER_REGS", "PF_CONSUMER_REGS", "PF_PRODUCER_REGS_CP",
             "PF_CONSUMER_REGS_CP", "PF_SMEM_BUDGET",
             "PF_TILE_OVERHEAD_INT4", "PF_TILE_OVERHEAD_NF4", "GB_ROWS", "GB_COLS")
    c = {name: const(name) for name in names}
    c["GB_CODE_BYTES"] = c["GB_ROWS"] * c["GB_COLS"]  # a stage's codes
    c["widths"] = tuple(int(v) for v in re.search(
        r"const int widths\[3\] = \{(\d+), (\d+), (\d+)\};", src).groups())
    launched = re.findall(r"launch_prefill<PF_FMT, (\d+), (true|false)>", src)
    c["tma"] = sorted({int(n) for n, tma in launched if tma == "true"})
    c["cp_async"] = sorted({int(n) for n, tma in launched if tma == "false"})
    return c


def _stages(c, n):
    """Prefill<N>'s ring: (stage bytes, stages, dynamic shared memory)."""
    stage = n * 128 + c["GB_CODE_BYTES"] + 1024
    stages = min((c["PF_SMEM_BUDGET"] - 1024) // stage, c["PF_MAX_STAGES"])
    return stage, stages, stages * stage + 1024


def _rows(c, fmt, m, d_out, sms=132):
    """prefill_rows: the tile's x rows whose tiles, one CTA an SM, finish
    first, each costing its rows plus the format's overhead."""
    cols = -(-d_out // c["PF_COLS"])
    over = c["PF_TILE_OVERHEAD_INT4" if fmt == "int4" else "PF_TILE_OVERHEAD_NF4"]
    best = None
    for n in c["widths"]:
        cost = -(-(cols * -(-m // n)) // sms) * (n + over)
        if best is None or cost < best[1]:
            best = (n, cost)
    return best[0]


def test_prefill_constants_match_the_kernel():
    """The tile is the skinny GEMM's 128 columns over 64-row blocks (one NF4
    scale row, 32 packed rows); every width the rule picks is instantiated;
    each ring holds at least 4 stages, PF_LAG + 2 of them (the cp.async
    variant's producer marks a stage full PF_LAG stages late and the
    consumers free one a stage late), in one block's shared memory; the
    setmaxnreg splits spend at most the CTA's registers and leave the
    consumers room for N / 2 accumulators and two sets of 16 A registers
    (the cp.async variant's tiles stop at 192 rows)."""
    c = _consts()
    assert c["PF_COLS"] == tim.SKINNY_COLS == tim.GEMV_COLS == 2 * 64
    assert c["PF_BK"] == tim.GEMV_BLOCK == 2 * c["GB_ROWS"] and c["GB_COLS"] == c["PF_COLS"]
    assert c["PF_CONSUMERS"] == 2 * 128 and c["PF_THREADS"] == c["PF_CONSUMERS"] + 128
    assert sorted(c["widths"]) == c["tma"] == [128, 192, 256] and c["cp_async"] == [128, 192]
    launch_regs = REGISTERS_PER_SM // c["PF_THREADS"] // 8 * 8  # __launch_bounds__(384, 1)
    splits = ((c["PF_PRODUCER_REGS"], c["PF_CONSUMER_REGS"]),  # TMA, then cp.async
              (c["PF_PRODUCER_REGS_CP"], c["PF_CONSUMER_REGS_CP"]))
    for producer, consumer in splits:
        assert producer * 128 + consumer * c["PF_CONSUMERS"] <= launch_regs * c["PF_THREADS"]
        assert producer % 8 == 0 and consumer % 8 == 0
        assert 24 <= producer <= launch_regs <= consumer <= 256
    static = 2 * 8 * c["PF_MAX_STAGES"] + 16 * 4  # full, empty barriers; the NF4 codebook
    for n in c["widths"]:
        assert n % 8 == 0 and n <= 256  # wgmma's N, one TMA box of x rows
        stage, stages, smem = _stages(c, n)
        assert stage % 1024 == 0 and (n * 128) % 1024 == 0  # SW128 tiles on 1024-byte lines
        assert max(4, c["PF_LAG"] + 2) <= stages <= c["PF_MAX_STAGES"]
        assert smem + static <= SMEM_PER_BLOCK
        assert c["PF_CONSUMER_REGS"] >= n // 2 + 2 * 16 + 32
        if n <= 192:  # the cp.async variant's tiles
            assert c["PF_CONSUMER_REGS_CP"] >= n // 2 + 2 * 16 + 32


# Device-held ms of the TMA variant at tiles of 128, 192 and 256 x rows, on
# an H100 80GB HBM3 at 700 W: tools/prefill_probe.py's rows=N variants
# (PERF.md's prefill GEMM findings); (format, M, IN, OUT) -> (128, 192, 256)
PROBED_MS = {
    ("int4", 512, 4096, 4096): (0.0296, 0.0349, 0.0432),
    ("int4", 2330, 4096, 4096): (0.1322, 0.1344, 0.1273),
    ("int4", 512, 4096, 11008): (0.0817, 0.0683, 0.0874),
    ("int4", 2330, 4096, 11008): (0.3359, 0.2962, 0.3011),
    ("int4", 512, 11008, 4096): (0.0728, 0.0860, 0.1089),
    ("int4", 2330, 11008, 4096): (0.3422, 0.3443, 0.3276),
    ("nf4", 512, 4096, 4096): (0.0412, 0.0467, 0.0530),
    ("nf4", 2330, 4096, 4096): (0.1885, 0.1799, 0.1564),
    ("nf4", 512, 4096, 11008): (0.1179, 0.0923, 0.1076),
    ("nf4", 2330, 4096, 11008): (0.4771, 0.3858, 0.3530),
    ("nf4", 512, 11008, 4096): (0.1034, 0.1169, 0.1334),
    ("nf4", 2330, 11008, 4096): (0.4955, 0.4628, 0.3995)}


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_prefill_rows_pick_a_probed_fastest_tile(fmt):
    """The wave reckoning with each format's overhead picks, at a LLaMA-7B
    layer's shapes and 512 and 2330 rows, a tile within 3 % (the probe's
    run-to-run spread) of the fastest one measured; at M = 512 a 4096-column
    shape takes 128-row tiles, 128 of them for 132 SMs (256-row tiles would
    make 64)."""
    c = _consts()
    for (f, m, din, dout), ms in PROBED_MS.items():
        if f == fmt:
            picked = ms[c["widths"][::-1].index(_rows(c, fmt, m, dout))]
            assert picked <= 1.03 * min(ms), (m, din, dout)
    assert _rows(c, fmt, 512, 4096) == 128 and 32 * -(-512 // 128) == 128


def _operands(fmt, x, packed, scale, n=None):
    """The operands as ``gemm_prefill_bf16``'s ring lands them: x zero-filled
    to whole tiles of n rows (``prefill_rows``' pick by default) and whole
    64-row blocks, the codes' zero bytes decoded as the kernel decodes them,
    NF4's weights rounded to x's type; float32 (xp, w) and n."""
    c = _consts()
    m, din = x.shape
    dout = packed.shape[1]
    n = n or _rows(c, fmt, m, dout)
    bk, cols = c["PF_BK"], c["PF_COLS"]
    mp, kp, op = -(-m // n) * n, -(-din // bk) * bk, -(-dout // cols) * cols
    xp = torch.zeros((mp, kp))
    xp[:m, :din] = x.float()
    pk = torch.zeros((kp // 2, op), dtype=packed.dtype)
    pk[:din // 2, :dout] = packed
    if fmt == "int4":
        w = tim.unpack_int4(pk).float()  # a zero byte: -8 in the even row
    else:
        sp = torch.zeros((kp // 64, op))
        sp[:din // 64, :dout] = scale
        w = TQ.dequantize_nf4({"nf4": pk, "bscale": sp}, x.dtype).float()
    return xp, w, n


def _sums(xp, w, drop_block=None):
    """The kernel's float32 sums: k16 steps (wgmma m64nNk16) accumulated in K
    order through every 64-row block (a running sum over the steps'
    products: cumsum adds them one after another), ``drop_block`` left out
    (a lost ring stage: the fault the card's limit has to catch)."""
    steps = xp.shape[1] // 16
    parts = torch.bmm(xp.reshape(xp.shape[0], steps, 16).transpose(0, 1),
                      w.reshape(steps, 16, w.shape[1]))
    if drop_block is not None:
        parts[4 * drop_block:4 * drop_block + 4] = 0.0
    return parts.cumsum(0)[-1]


def _finish(fmt, acc, x, scale, dout, round_output=True):
    """int4's scale after the sum, one rounding to x's type (skipped with
    ``round_output=False``)."""
    total = acc[:x.shape[0], :dout]
    if fmt == "int4":
        total = total * scale.float()
    return total.to(x.dtype) if round_output else total


def _emulate(fmt, x, packed, scale, round_output=True):
    """``gemm_prefill_bf16`` on the CPU."""
    xp, w, _ = _operands(fmt, x, packed, scale)
    return _finish(fmt, _sums(xp, w), x, scale, packed.shape[1], round_output)


# (format, IN, OUT): int4's ragged IN (300: half a block of zero-filled codes,
# the cp.async variant's x rows of 600 bytes) and ragged OUT (199: a column
# tile 57 columns deep), whole tiles at 512 -> 384, NF4 at IN 320 (5 blocks)
# and 1024 with a ragged OUT
SHAPES = [("int4", 300, 199), ("int4", 512, 384), ("nf4", 320, 384), ("nf4", 1024, 199)]


@pytest.mark.parametrize("fmt,din,dout", SHAPES)
def test_prefill_emulation_matches_plain_f32(fmt, din, dout):
    """In float32 the zero-filled tiles and k16 steps compute the plain
    version's product: only the summation order differs (1e-5 relative).
    Tiles of 128 and 256 rows sum every output alike (the rows rule's pick
    changes no output)."""
    rng, packed, scale = _leaf(fmt, din, dout, seed=31)
    packed, scale = torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale))
    plain = tim.matmul_int4_plain if fmt == "int4" else tim.matmul_nf4_plain
    x = torch.from_numpy(rng.randn(300, din).astype(np.float32))
    want = plain(x, packed, scale)
    top = want.abs().max().item()
    outs = []
    for n in (128, 256):
        xp, w, _ = _operands(fmt, x, packed, scale, n)
        outs.append(_finish(fmt, _sums(xp, w), x, scale, dout))
    torch.testing.assert_close(outs[0], want, rtol=1e-5, atol=1e-5 * top)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("fmt,din,dout", SHAPES)
def test_prefill_emulation_bf16_matches_jax_under_half_the_card_limit(fmt, din, dout):
    """bfloat16 x: the emulation's output, rounded once to bf16, and its
    float32 sums before the rounding, within half the card's limit (2^-8 x
    max |want|) of JAX's product (test_torch_gemv.py's bound: half an ulp
    of the rounding, NF4's weights rounded to bf16 as the plain version
    rounds them, the summation order)."""
    xb, packed, scale, want = _against_jax(fmt, din, dout, 257, seed=32)
    top = np.abs(want).max()
    out = _emulate(fmt, xb, packed, scale)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - want).max() <= 0.5 * CARD_REL * top
    sums = _emulate(fmt, xb, packed, scale, round_output=False).numpy()
    assert np.abs(sums - want).max() <= 0.5 * CARD_REL * top


@pytest.mark.parametrize("fmt,din,dout", [SHAPES[0], SHAPES[2]])
def test_prefill_card_limit_catches_a_dropped_block_or_tile(fmt, din, dout):
    """One 64-row block left out of the sums (a ring stage lost), or one
    tile's outputs never written, moves the result past twice the card's
    limit: the limit separates rounding from a lost stage or tile."""
    xb, packed, scale, want = _against_jax(fmt, din, dout, 300, seed=33)
    limit = 2 * CARD_REL * np.abs(want).max()
    xp, w, n = _operands(fmt, xb, packed, scale)
    for drop in range(xp.shape[1] // 64):
        sums = _finish(fmt, _sums(xp, w, drop_block=drop), xb, scale, dout, False).numpy()
        assert np.abs(sums - want).max() > limit, drop
    acc = _sums(xp, w)
    for r in range(0, xp.shape[0], n):
        for col in range(0, w.shape[1], 128):
            lost = acc.clone()
            lost[r:r + n, col:col + 128] = 0.0  # the tile's outputs never written
            sums = _finish(fmt, lost, xb, scale, dout, False).numpy()
            assert np.abs(sums - want).max() > limit, (r, col)
