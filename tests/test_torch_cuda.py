"""On-card checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``: they skip without a card.  On a machine with one, run
them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mars_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(h, l, d, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(h, l, d).astype(np.float32)).to(dev, dtype)
            for _ in range(3)]


def _assert_bf16_attention(got, want, want_on_abs_v):
    """bfloat16 attention outputs, element by element (chip_smoke.py's
    limit): each side rounds P to bf16 (the flash kernels the unnormalised
    exp(s - running max), whose float32 row sum carries the same roundings:
    weights at most 1.5 x 2^-8 apart, relative) and its output (at most
    2^-8 |out| each), so |got - want| <= 2^-7 (|want| + P|v|), P|v| the plain
    version on |v|.  With randn inputs at d = 64 that is ~6.5e-3 at a typical
    element (|out| ~0.04, P|v| ~0.8)."""
    assert got.dtype == want.dtype == torch.bfloat16
    want = want.float()
    over = (got.float() - want).abs() - 2 ** -7 * (want.abs() + want_on_abs_v.float())
    assert over.max().item() <= 0, f"exceeds the bf16 limit by {over.max().item()}"


# the path's geometries, L that fill no 64-row tile exactly, d in {16, 32, 64}
# and a single head
TAP_SHAPES = [(3, 200, 32), (2, 300, 16), (16, 1374, 64), (12, 1090, 64), (1, 17, 64),
              (2, 65, 64), (3, 129, 32), (1, 200, 16), (4, 1374, 32)]


@pytest.mark.parametrize("h,l,d", TAP_SHAPES)
def test_kernel_matches_plain_f32(dev, h, l, d):
    q, k, v = _qkv(h, l, d, torch.float32, dev)
    before = fa.attention_with_tap.launches
    out, tap = fa.attention_with_tap(q, k, v)
    torch.cuda.synchronize()
    assert fa.attention_with_tap.launches == before + 1
    want_out, want_tap = fa.attention_with_tap_plain(q, k, v)
    assert out.dtype == torch.float32 and tap.shape == (l, l)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(tap, want_tap, atol=1e-5, rtol=0)
    torch.testing.assert_close(tap.sum(-1), torch.ones(l, device=dev), atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,l,d", TAP_SHAPES + [(2, 64, 24), (2, 100, 20)])
def test_kernel_matches_plain_bf16(dev, h, l, d):
    """The tensor-core kernels.  d = 24 leaves half of the second K step of
    16 empty; d = 20 takes the element-wise tile loads (a row of 20 bf16 is
    no whole number of 16-byte chunks)."""
    q, k, v = _qkv(h, l, d, torch.bfloat16, dev)
    before = fa.attention_with_tap.launches
    out, tap = fa.attention_with_tap(q, k, v)
    torch.cuda.synchronize()
    assert fa.attention_with_tap.launches == before + 1
    want_out, want_tap = fa.attention_with_tap_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (h, l, d) and tap.shape == (l, l)
    _assert_bf16_attention(out, want_out, fa.attention_with_tap_plain(q, k, v.abs())[0])
    torch.testing.assert_close(tap, want_tap, atol=1e-5, rtol=0)
    torch.testing.assert_close(tap.sum(-1), torch.ones(l, device=dev), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(dev, dtype):
    q, k, v = _qkv(16, 1374, 64, dtype, dev, seed=3)
    out1, tap1 = fa.attention_with_tap(q, k, v)
    out2, tap2 = fa.attention_with_tap(q, k, v)
    assert torch.equal(out1, out2) and torch.equal(tap1, tap2)


def test_kernel_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(2, 64, 128, torch.float32, dev)
    with pytest.raises(ValueError):
        fa.attention_with_tap(q, k, v)
    q, k, v = _qkv(2, 64, 64, torch.float16, dev)
    with pytest.raises(TypeError):
        fa.attention_with_tap(q, k, v)


def _grid_inputs(nh, h, w, d, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    l = h * w
    arrays = [rng.randn(nh, l, d), rng.randn(nh, l, d), rng.randn(nh, l, d),
              rng.randn(nh, l, h), rng.randn(nh, l, w)]
    return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in arrays]


# the float32 kernel's bias modes (WIDE at every W that is a multiple of the
# key tile: 64, or 32 past head dim 80; GENERAL otherwise, and for a W whose
# bias rows would not fit in shared memory) and its padded head dims (32, 64,
# 80, 128): ViT-H and ViT-B global layers, ragged grids, d = 20 (element-wise
# tile loads), W = 128 and 192, a 16 x 16 grid, d = 32 and 96 at W = 64, and
# one row of 1024
GRID_F32_SHAPES = [(16, 64, 64, 80), (2, 5, 7, 24), (2, 16, 16, 16), (3, 33, 31, 128),
                   (12, 64, 64, 64), (2, 2, 128, 80), (2, 2, 192, 128), (2, 5, 7, 20),
                   (2, 3, 64, 32), (2, 4, 64, 96), (2, 1, 1024, 80)]


@pytest.mark.parametrize("nh,h,w,d", GRID_F32_SHAPES)
def test_grid_attention_matches_plain_f32(dev, nh, h, w, d):
    from mars_tpu_torch.ops import sam_attention as sa

    args = _grid_inputs(nh, h, w, d, torch.float32, dev)
    before = sa.grid_attention.launches
    out = sa.grid_attention(*args, (h, w))
    torch.cuda.synchronize()
    assert sa.grid_attention.launches == before + 1
    want = sa.grid_attention_plain(*args, (h, w))
    assert out.dtype == torch.float32 and out.shape == (nh, h * w, d)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)


# aligned grids (W % 64 == 0: ViT-H and ViT-B/L global layers, then W = 128
# and 192, whose bias_w rows sit in shared memory), then general ones: ragged,
# d = 20 (element-wise tile loads), two head-dim panels, a 16 x 16 grid
GRID_BF16_SHAPES = [(16, 64, 64, 80), (12, 64, 64, 64), (2, 2, 128, 80), (2, 2, 192, 128),
                    (2, 5, 7, 24), (2, 5, 7, 20), (3, 33, 31, 128), (2, 16, 16, 16)]


@pytest.mark.parametrize("nh,h,w,d", GRID_BF16_SHAPES)
def test_grid_attention_matches_plain_bf16(dev, nh, h, w, d):
    from mars_tpu_torch.ops import sam_attention as sa

    args = _grid_inputs(nh, h, w, d, torch.bfloat16, dev)
    before = sa.grid_attention.launches
    out = sa.grid_attention(*args, (h, w))
    torch.cuda.synchronize()
    assert sa.grid_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (nh, h * w, d)
    want = sa.grid_attention_plain(*args, (h, w))
    _assert_bf16_attention(out, want, sa.grid_attention_plain(*args[:2], args[2].abs(), *args[3:],
                                                               (h, w)))


@pytest.mark.parametrize("nh,h,w,d", [(16, 64, 64, 80), (2, 5, 7, 24), (3, 33, 31, 128)])
def test_grid_attention_f32_is_deterministic(dev, nh, h, w, d):
    from mars_tpu_torch.ops import sam_attention as sa

    args = _grid_inputs(nh, h, w, d, torch.float32, dev, seed=2)
    assert torch.equal(sa.grid_attention(*args, (h, w)), sa.grid_attention(*args, (h, w)))


@pytest.mark.parametrize("nh,h,w,d", [(16, 64, 64, 80), (2, 5, 7, 24)])
def test_grid_attention_bf16_is_deterministic(dev, nh, h, w, d):
    from mars_tpu_torch.ops import sam_attention as sa

    args = _grid_inputs(nh, h, w, d, torch.bfloat16, dev, seed=2)
    assert torch.equal(sa.grid_attention(*args, (h, w)), sa.grid_attention(*args, (h, w)))


AUCTION_BOUNDARY = (1, 2, 16, 17, 31, 32, 33)  # tests/test_torch_auction.py's BOUNDARY_BIDDERS


def _auction_instance(seed, t, n):
    """The instances of tests/test_ops.py's Pallas-vs-XLA auction test; seed
    100 + nb: tests/test_torch_auction.py's nb-boundary instance (48 x 64
    quantized scores, exactly nb valid rows)."""
    rng = np.random.RandomState(seed)
    if seed >= 100:
        s = rng.randint(0, 4, (t, n)).astype(np.float32) / 4.0
        valid = np.zeros((t,), bool)
        valid[rng.choice(t, seed - 100, replace=False)] = True
        return s, valid
    if seed == 3:
        s = rng.randint(0, 4, (t, n)).astype(np.float32) / 4.0
    else:
        s = rng.rand(t, n).astype(np.float32)
    valid = rng.rand(t) < (0.3 if t != n else 1.1)
    if not valid.any():
        valid[0] = True
    return s, valid


@pytest.mark.parametrize("seed,t,n,phases", [(0, 200, 300, 1), (2, 96, 96, 1), (3, 150, 150, 1),
                                             (5, 120, 120, 5), (6, 3, 700, 1)]
                         + [(100 + nb, 48, 64, 1) for nb in AUCTION_BOUNDARY])
def test_auction_kernel_equals_plain(dev, seed, t, n, phases):
    from mars_tpu_torch.ops import assignment as asg

    s, valid = _auction_instance(seed, t, n)
    want_stats, got_stats = [], []
    want = asg.auction_assignment(torch.from_numpy(s), torch.from_numpy(valid),
                                  n_phases=phases, stats=want_stats)
    before = asg.auction_assignment.launches
    got = asg.auction_assignment(torch.from_numpy(s).to(dev), torch.from_numpy(valid).to(dev),
                                 n_phases=phases, stats=got_stats)
    assert asg.auction_assignment.launches == before + phases
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert got_stats == want_stats


def _phases_on_card(phase, scores, valid, eps):
    from mars_tpu_torch.ops import assignment as asg

    prices = torch.zeros((scores.shape[1],), dtype=torch.float32, device=scores.device)
    out = []
    for e in eps:
        col, prices, counts = phase(scores, valid, prices, e, 20000)
        out.append((col, prices, counts))
    return out


def _bitwise_equal(a, b):
    return all(torch.equal(ca, cb) and torch.equal(pa.view(torch.int32), pb.view(torch.int32))
               and sa == sb for (ca, pa, sa), (cb, pb, sb) in zip(a, b))


def test_auction_phase_kernel_equals_plain_on_card(dev):
    """A matching-sized instance (1369², sparse valid rows), one phase with
    carried prices, both versions on the card."""
    from mars_tpu_torch.ops import assignment as asg

    rng = np.random.RandomState(7)
    s = torch.from_numpy(rng.rand(1369, 1369).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.rand(1369) < 0.15).to(dev)
    prices = torch.from_numpy(rng.rand(1369).astype(np.float32) * 1e-3).to(dev)
    col_k, pr_k, st_k = asg._auction_phase_kernel(s, valid, prices, 2e-4, 20000)
    col_p, pr_p, st_p = asg._auction_phase_plain(s, valid, prices, 2e-4, 20000)
    assert torch.equal(col_k, col_p) and torch.equal(pr_k, pr_p) and st_k == st_p


def test_auction_dense_contested_equals_plain_on_card(dev):
    """The dense contested geometry of negative_points_from_cost
    (mars_tpu/pipeline/matcher.py:193): 1369², every row valid, five
    ε-phases with carried prices; kernel and plain version on the card."""
    from mars_tpu_torch.ops import assignment as asg

    rng = np.random.RandomState(8)
    s = torch.from_numpy(rng.rand(1369, 1369).astype(np.float32)).to(dev)
    scores, valid, _, eps = asg.phase_inputs(s, torch.ones((1369,), dtype=torch.bool,
                                                           device=dev), 5)
    got = _phases_on_card(asg._auction_phase_kernel, scores, valid, eps)
    want = _phases_on_card(asg._auction_phase_plain, scores, valid, eps)
    assert _bitwise_equal(got, want)
    assert sum(c[0] for _, _, c in got) > 5  # dense rounds in every phase's opening


def test_auction_kernel_reruns_bitwise(dev):
    """Instances A, B, A on the kernel: A's two runs are bitwise equal (no
    state carried between launches, the bidder list's order free)."""
    from mars_tpu_torch.ops import assignment as asg

    runs = []
    for seed, t, n, phases in ((3, 150, 150, 1), (5, 120, 120, 5), (3, 150, 150, 1)):
        s, valid = _auction_instance(seed, t, n)
        scores, valid, _, eps = asg.phase_inputs(torch.from_numpy(s).to(dev),
                                                 torch.from_numpy(valid).to(dev), phases)
        runs.append(_phases_on_card(asg._auction_phase_kernel, scores, valid, eps))
    assert _bitwise_equal(runs[0], runs[2])


# past the kernel's shared memory and at the five-shot shapes: (T, N, the
# variant the wrapper picks, quantized scores for long wars)
AUCTION_LARGE = [(7133, 7133, "shared", False),       # T + N = 14 266, the last that fits
                 (7133, 7134, "rows_global", False),  # T + N = 14 267
                 (7225, 7225, "rows_global", False),  # grid 85 (--input-size 1190)
                 (7225, 7225, "rows_global", True),
                 (6845, 1369, "shared", False),       # five shots: the forward, footprint <= L
                 (1369, 6845, "shared", True),        # the transposed forward and the reverse
                 (2916, 14580, "global", False),      # the reverse at five shots, grid 54
                 (2916, 14580, "global", True)]


@pytest.mark.parametrize("t,n,variant,quantized", AUCTION_LARGE)
def test_auction_large_instances_equal_plain_on_card(dev, t, n, variant, quantized):
    """A matching-like instance (30 % of the rows bid, 15 % where T > N,
    compacted first as the Matcher's row_chunk does), one phase: the kernel in the variant its
    size selects and the plain version on the card, bit for bit."""
    from mars_tpu_torch.ops import assignment as asg

    assert asg.VARIANTS[asg.auction_variant(t, n)] == variant
    rng = np.random.RandomState(t + n)
    s = (rng.randint(0, 4, (t, n)).astype(np.float32) / 4.0 if quantized
         else rng.rand(t, n).astype(np.float32))
    valid = rng.rand(t) < (0.3 if t <= n else 0.15)  # never more bidders than columns
    scores, valid, _, eps = asg.phase_inputs(torch.from_numpy(s).to(dev),
                                             torch.from_numpy(valid).to(dev), 1, 128)
    before = asg.auction_assignment.launches
    got = _phases_on_card(asg._auction_phase_kernel, scores, valid, eps)
    assert asg.auction_assignment.launches == before + 1
    want = _phases_on_card(asg._auction_phase_plain, scores, valid, eps)
    assert _bitwise_equal(got, want)
    assert int((got[0][0] >= 0).sum()) == int(valid.sum())


def _quant_inputs(fmt, m, din, dout, dtype, dev, seed=0):
    from mars_tpu_torch.models import quantization as TQ

    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(din, dout).astype(np.float32))
    leaf = TQ.quantize_kernel(w, 4) if fmt == "int4" else TQ.quantize_kernel_nf4(w)
    x = torch.from_numpy(rng.randn(m, din).astype(np.float32)).to(dev, dtype)
    keys = ("q4", "scale") if fmt == "int4" else ("nf4", "bscale")
    return x, [leaf[k].to(dev) for k in keys]


# (format, IN, OUT): even shapes, then a ragged OUT that is no multiple of 4
# (the GEMV's byte-load path) and, for int4, a ragged IN
@pytest.mark.parametrize("fmt,din,dout", [("int4", 512, 384), ("int4", 300, 199),
                                          ("nf4", 512, 384), ("nf4", 320, 199)])
@pytest.mark.parametrize("m", [1, 4, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_4bit_matmul_matches_plain(dev, fmt, din, dout, m, dtype):
    """Float32: the kernel and the plain version differ in summation order
    only.  bfloat16: the output is rounded to bf16 once in each, so they
    may differ by one bf16 rounding of the largest output."""
    _check_4bit(dev, fmt, din, dout, m, dtype)


def _check_4bit(dev, fmt, din, dout, m, dtype):
    from mars_tpu_torch.ops import int4_matmul as im

    x, (packed, scale) = _quant_inputs(fmt, m, din, dout, dtype, dev)
    fn = im.matmul_int4 if fmt == "int4" else im.matmul_nf4
    plain = im.matmul_int4_plain if fmt == "int4" else im.matmul_nf4_plain
    before = fn.launches
    got = fn(x, packed, scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, packed, scale)
    assert got.dtype == dtype and got.shape == (m, dout)
    top = want.float().abs().max().item()
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rel, atol=rel * top)
    return x, packed, scale, got


# the tensor-core GEMM (bf16, M > 8): ragged OUT (199, 999), ragged int4 IN
# (300: no 16-byte x chunks; 1984), an NF4 IN of 320 (five 64-row blocks);
# chip_smoke.py holds the text path's shapes
@pytest.mark.parametrize("fmt,din,dout", [("int4", 512, 199), ("int4", 300, 999),
                                          ("int4", 1984, 384), ("nf4", 320, 199),
                                          ("nf4", 512, 999)])
@pytest.mark.parametrize("m", [9, 80, 300, 2330])
def test_4bit_gemm_bf16_matches_plain(dev, fmt, din, dout, m):
    _check_4bit(dev, fmt, din, dout, m, torch.bfloat16)


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_4bit_gemm_bf16_is_deterministic(dev, fmt):
    from mars_tpu_torch.ops import int4_matmul as im

    x, packed, scale, got = _check_4bit(dev, fmt, 1024, 999, 300, torch.bfloat16)
    fn = im.matmul_int4 if fmt == "int4" else im.matmul_nf4
    assert torch.equal(got, fn(x, packed, scale))


# a speculative verify forward's rows, B x (K + 1) at K = 8 and B = 1, 2, 4,
# 8, on every dense shape of the 7B's LLaMA layer (q, k, v, o; gate, up;
# down): the GEMM's route (M > 8), one launch a call
@pytest.mark.parametrize("fmt", ["int4", "nf4"])
@pytest.mark.parametrize("din,dout", [(4096, 4096), (4096, 11008), (11008, 4096)])
@pytest.mark.parametrize("m", [9, 18, 36, 72])
def test_4bit_gemm_bf16_verify_rows_match_plain(dev, fmt, din, dout, m):
    rng, packed, scale = _gemv_inputs(fmt, din, dout, dev, seed=m)
    _check_gemv(fmt, rng, packed, scale, m, dev)


def _gemv_inputs(fmt, din, dout, dev, seed=0, offset=0):
    """Weights quantized on the card (the 7B's shapes are slow on the host);
    ``offset`` > 0 puts the packed codes ``offset`` bytes into a larger
    buffer, so their pointer is not 16-byte aligned."""
    from mars_tpu_torch.models import quantization as TQ

    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(din, dout).astype(np.float32)).to(dev)
    leaf = TQ.quantize_kernel(w, 4) if fmt == "int4" else TQ.quantize_kernel_nf4(w)
    keys = ("q4", "scale") if fmt == "int4" else ("nf4", "bscale")
    packed, scale = leaf[keys[0]], leaf[keys[1]]
    if offset:
        buf = torch.zeros(packed.numel() + offset, dtype=packed.dtype, device=dev)
        buf[offset:] = packed.reshape(-1)
        packed = buf[offset:].view(packed.shape)
        assert packed.is_contiguous() and packed.data_ptr() % 16 == offset % 16
    return rng, packed, scale


def _check_gemv(fmt, rng, packed, scale, m, dev):
    from mars_tpu_torch.ops import int4_matmul as im

    din = packed.shape[0] * 2
    x = torch.from_numpy(rng.randn(m, din).astype(np.float32)).to(dev, torch.bfloat16)
    fn, plain = ((im.matmul_int4, im.matmul_int4_plain) if fmt == "int4"
                 else (im.matmul_nf4, im.matmul_nf4_plain))
    before = fn.launches
    got = fn(x, packed, scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(x, packed, scale).float()
    assert got.dtype == torch.bfloat16 and got.shape == (m, packed.shape[1])
    assert torch.isfinite(got.float()).all()
    top = want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=2 ** -7 * top)
    return x, got


# the bf16 GEMV (M <= 8): the 7B's decode shapes (S = 16, 4, 16), slices of
# unequal length (1984 -> 384: 31 blocks in 16 slices; 320 -> 384: 5 in 4),
# ragged OUT (199, 999: the byte-load path), int4's ragged IN (300: 150
# packed rows, no whole k16 step at the end, no 16-byte x chunks), NF4 at IN
# 320, one slice (S = 1: each CTA stores its own outputs, no workspace; odd
# OUT 199 element by element, even OUT in bf16 pairs, 33 800 and 33 792
# columns with two blocks a slice); one shape per case, every M the GEMV
# takes
@pytest.mark.parametrize("fmt,din,dout", [
    ("int4", 4096, 4096), ("int4", 4096, 11008), ("int4", 11008, 4096),
    ("nf4", 4096, 4096), ("nf4", 4096, 11008), ("nf4", 11008, 4096),
    ("int4", 1984, 384), ("nf4", 320, 384), ("int4", 512, 199), ("int4", 300, 999),
    ("nf4", 320, 199), ("nf4", 1024, 999), ("int4", 64, 199), ("nf4", 64, 384),
    ("int4", 128, 33800), ("nf4", 128, 33792)])
def test_4bit_gemv_bf16_matches_plain(dev, fmt, din, dout):
    from mars_tpu_torch.ops import int4_matmul as im

    rng, packed, scale = _gemv_inputs(fmt, din, dout, dev)
    split = im.gemv_split(din, dout)
    if (din, dout) in ((1984, 384), (320, 384)):
        blocks = -(-din // 64)
        assert len({(i + 1) * blocks // split - i * blocks // split for i in range(split)}) == 2
    if din <= 128:
        assert split == 1
    for m in (1, 2, 3, 5, 8):
        _check_gemv(fmt, rng, packed, scale, m, dev)


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_4bit_gemv_bf16_unaligned_packed(dev, fmt):
    """Packed codes one byte into a larger buffer: no cp.async of them."""
    rng, packed, scale = _gemv_inputs(fmt, 1024, 384, dev, offset=1)
    for m in (1, 4, 8):
        _check_gemv(fmt, rng, packed, scale, m, dev)


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_4bit_gemv_bf16_is_deterministic(dev, fmt):
    from mars_tpu_torch.ops import int4_matmul as im

    fn = im.matmul_int4 if fmt == "int4" else im.matmul_nf4
    rng, packed, scale = _gemv_inputs(fmt, 4096, 4096, dev)
    x, got = _check_gemv(fmt, rng, packed, scale, 4, dev)
    for _ in range(3):
        assert torch.equal(got, fn(x, packed, scale))


def test_4bit_gemv_bf16_workspace_resets(dev):
    """Shape A (16 slices over 32 column tiles), shape B (4 over 86), A
    again: the last result equals the first bit for bit, so every tile's
    arrival counter went back to 0 and B's partials did not leak into A."""
    from mars_tpu_torch.ops import int4_matmul as im

    rng_a, packed_a, scale_a = _gemv_inputs("int4", 4096, 4096, dev, seed=1)
    rng_b, packed_b, scale_b = _gemv_inputs("int4", 4096, 11008, dev, seed=2)
    x_a, first = _check_gemv("int4", rng_a, packed_a, scale_a, 4, dev)
    _check_gemv("int4", rng_b, packed_b, scale_b, 8, dev)
    again = im.matmul_int4(x_a, packed_a, scale_a)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, counters = im._WORKSPACE[(x_a.device, stream)]
    assert int(counters.abs().sum()) == 0


def test_4bit_matmul_rejects_what_it_does_not_take(dev):
    from mars_tpu_torch.ops import int4_matmul as im

    x, (packed, scale) = _quant_inputs("nf4", 4, 128, 64, torch.float32, dev)
    with pytest.raises(ValueError):
        im.matmul_nf4(x[:, :64], packed, scale)
    with pytest.raises(TypeError):
        im.matmul_nf4(x.half(), packed, scale)
    with pytest.raises(TypeError):
        im.matmul_nf4(x, packed, scale.bfloat16())


def _bhld(b, h, l, d, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, l, d).astype(np.float32)).to(dev, dtype)
            for _ in range(3)]


# (B, H, L, D): DINOv2-L and CLIP-B at B = 1, an AlphaCLIP-L chunk, five
# DINOv2-L supports, ragged tiles, the widest head dim (32-key float32 tiles),
# a single key, d = 80 (float32: the 16-float interleaved panel; bf16: the
# 16-wide second panel), d = 20 (element-wise tile loads in bf16) and d = 17
# (element-wise in both types)
NOTAP_SHAPES = [(1, 16, 1374, 64), (1, 12, 1090, 64), (16, 16, 577, 64), (2, 3, 200, 32),
                (1, 2, 17, 128), (3, 1, 1, 8), (5, 16, 1374, 64), (2, 2, 100, 80),
                (1, 3, 70, 20), (2, 3, 130, 17)]


@pytest.mark.parametrize("b,h,l,d", NOTAP_SHAPES)
def test_notap_matches_plain_f32(dev, b, h, l, d):
    q, k, v = _bhld(b, h, l, d, torch.float32, dev)
    before = fa.attention_notap.launches
    out = fa.attention_notap(q, k, v)
    torch.cuda.synchronize()
    assert fa.attention_notap.launches == before + 1
    want = fa.attention_notap_plain(q, k, v)
    assert out.dtype == torch.float32 and out.shape == (b, h, l, d)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,h,l,d", NOTAP_SHAPES)
def test_notap_matches_plain_bf16(dev, b, h, l, d):
    """The tensor-core kernel at every float32 shape: d = 80 takes the
    16-wide interleaved second panel, d = 20 element-wise tile loads, d = 128
    two SW128 panels."""
    q, k, v = _bhld(b, h, l, d, torch.bfloat16, dev)
    before = fa.attention_notap.launches
    out = fa.attention_notap(q, k, v)
    torch.cuda.synchronize()
    assert fa.attention_notap.launches == before + 1
    want = fa.attention_notap_plain(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == (b, h, l, d)
    _assert_bf16_attention(out, want, fa.attention_notap_plain(q, k, v.abs()))


@pytest.mark.parametrize("d", [64, 80, 128])
def test_notap_bf16_is_deterministic(dev, d):
    q, k, v = _bhld(2, 4, 300, d, torch.bfloat16, dev, seed=3)
    assert torch.equal(fa.attention_notap(q, k, v), fa.attention_notap(q, k, v))


@pytest.mark.parametrize("d", [17, 64, 80, 128])
def test_notap_f32_is_deterministic(dev, d):
    """The split-TF32 kernel at every padded head dim (32, 64, 80, 128; d = 17
    with element-wise tile loads)."""
    q, k, v = _bhld(2, 4, 300, d, torch.float32, dev, seed=3)
    assert torch.equal(fa.attention_notap(q, k, v), fa.attention_notap(q, k, v))


def test_notap_is_deterministic_and_rejects(dev):
    q, k, v = _bhld(2, 4, 300, 64, torch.float32, dev, seed=3)
    assert torch.equal(fa.attention_notap(q, k, v), fa.attention_notap(q, k, v))
    with pytest.raises(ValueError):
        fa.attention_notap(*_bhld(1, 2, 64, 160, torch.float32, dev))
    with pytest.raises(TypeError):
        fa.attention_notap(*_bhld(1, 2, 64, 64, torch.float16, dev))
    with pytest.raises(ValueError):
        fa.attention_notap(q[0], k[0], v[0])


def _window_inputs(b, nh, h, w, d, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    l = h * w
    arrays = [rng.randn(b, nh, l, d), rng.randn(b, nh, l, d), rng.randn(b, nh, l, d),
              rng.randn(b, nh, l, h), rng.randn(b, nh, l, w)]
    return [torch.from_numpy(a.astype(np.float32)).to(dev, dtype) for a in arrays]


# (windows, heads, Hw, Ww, hd): SAM ViT-H @1024's windowed layer, ViT-B's
# head dim on a ragged window, a small one, hd 128 (32-key tiles through the
# key tables), ViT-B's windowed layer, 14-wide windows of 6 and 2 key rows
# (the float32 kernel's tiles of 4 key rows: one and a last of 2, a last
# alone) and windows of 289, 400 and 1024 keys (64-key tiles, the last masked)
WINDOW_SHAPES = [(25, 16, 14, 14, 80), (2, 2, 5, 6, 64), (3, 4, 7, 7, 24), (2, 2, 14, 14, 128),
                 (25, 12, 14, 14, 64), (2, 2, 6, 14, 80), (3, 2, 2, 14, 32),
                 (1, 2, 17, 17, 64), (1, 2, 20, 20, 80), (1, 2, 32, 32, 128)]


@pytest.mark.parametrize("b,nh,h,w,d", WINDOW_SHAPES)
def test_windowed_matches_plain_f32(dev, b, nh, h, w, d):
    from mars_tpu_torch.ops import sam_attention as sa

    args = _window_inputs(b, nh, h, w, d, torch.float32, dev)
    before = sa.windowed_attention.launches
    out = sa.windowed_attention(*args, (h, w))
    torch.cuda.synchronize()
    assert sa.windowed_attention.launches == before + 1
    want = sa.windowed_attention_plain(*args, (h, w))
    assert out.dtype == torch.float32 and out.shape == (b, nh, h * w, d)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,nh,h,w,d", WINDOW_SHAPES + [(2, 2, 5, 6, 20)])
def test_windowed_matches_plain_bf16(dev, b, nh, h, w, d):
    """The tensor-core kernels at every float32 shape and d = 20 (element-wise
    tile loads): windows of up to 256 keys at hd <= 80 take the resident
    kernel, hd 128 and the windows of 289, 400 and 1024 keys the streamed one."""
    from mars_tpu_torch.ops import sam_attention as sa

    args = _window_inputs(b, nh, h, w, d, torch.bfloat16, dev)
    before = sa.windowed_attention.launches
    out = sa.windowed_attention(*args, (h, w))
    torch.cuda.synchronize()
    assert sa.windowed_attention.launches == before + 1
    want = sa.windowed_attention_plain(*args, (h, w))
    assert out.dtype == torch.bfloat16 and out.shape == (b, nh, h * w, d)
    _assert_bf16_attention(out, want, sa.windowed_attention_plain(
        *args[:2], args[2].abs(), *args[3:], (h, w)))


@pytest.mark.parametrize("d", [64, 80, 128])
def test_windowed_bf16_is_deterministic(dev, d):
    from mars_tpu_torch.ops import sam_attention as sa

    args = _window_inputs(4, 4, 14, 14, d, torch.bfloat16, dev, seed=3)
    assert torch.equal(sa.windowed_attention(*args, (14, 14)),
                       sa.windowed_attention(*args, (14, 14)))


@pytest.mark.parametrize("b,nh,h,w,d", [(25, 16, 14, 14, 80), (2, 2, 14, 14, 128),
                                         (1, 2, 17, 17, 64), (3, 4, 7, 7, 24)])
def test_windowed_f32_is_deterministic(dev, b, nh, h, w, d):
    from mars_tpu_torch.ops import sam_attention as sa

    args = _window_inputs(b, nh, h, w, d, torch.float32, dev, seed=4)
    assert torch.equal(sa.windowed_attention(*args, (h, w)),
                       sa.windowed_attention(*args, (h, w)))


def test_windowed_refuses_a_window_that_does_not_fit(dev):
    """Shapes the kernel does not take are refused; a window of any size is
    taken, in both types (the float32 kernel streams its keys)."""
    from mars_tpu_torch.ops import sam_attention as sa

    with pytest.raises(ValueError):
        sa.windowed_attention(*_window_inputs(1, 1, 4, 4, 8, torch.float32, dev), (2, 8))
    with pytest.raises(ValueError):
        sa.windowed_attention(*_window_inputs(1, 1, 4, 4, 129, torch.float32, dev), (4, 4))
    for dtype in (torch.float32, torch.bfloat16):
        out = sa.windowed_attention(*_window_inputs(1, 1, 32, 32, 128, dtype, dev), (32, 32))
        assert torch.isfinite(out.float()).all()


def _golden_ranking(dev):
    """The tiny golden ranking episode (tests/fixtures) on the card, the
    support masks kept on the host as ``data.base.episode_from_host`` keeps
    them: (model, episode, proposals, name, description)."""
    import os

    from mars_tpu_torch.core.episode import Episode, pad_proposals
    from mars_tpu_torch.models import clip, convert, dinov2
    from mars_tpu_torch.pipeline import filtering, mars, vta, vva

    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "golden_episode_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}

    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    tcfg = clip.ClipTextConfig(width=16, depth=2, num_heads=2, output_dim=16)

    def tower(prefix, kind, depth, alpha):
        return (convert.from_reference_state_dict(sub(prefix), kind, depth, device=dev),
                convert.from_reference_state_dict(sub(prefix), "clip_text", 2, device=dev),
                convert.logit_scale(sub(prefix), dev),
                clip.ClipVisualConfig(width=64, depth=depth, num_heads=1, output_dim=16,
                                      pos_embed_grid=7, alpha_channel=alpha), tcfg)

    model = mars.Mars(
        (convert.from_reference_state_dict(sub("dino."), "dinov2", 3, device=dev),
         dinov2.DinoV2Config(embed_dim=32, depth=3, num_heads=2, pos_embed_grid=8)),
        tower("clip.", "clip_visual", 3, False), tower("aclip.", "alpha_clip_visual", 2, True),
        cfg=mars.MarsConfig(
            vva=vva.VVAConfig(refinement_box_threshold=0.8, attn_tap_last_n=2, grid=8),
            vta=vta.VTAConfig(refinement_box_threshold=0.4, attn_tap_last_n=3, input_size=112,
                              grid=7),
            filter_merge=filtering.FilterMergeConfig(
                grid=8, alpha_clip_size=112, alpha_clip_batch=4, emd_row_bucket=128,
                emd_col_bucket=64)),
        device=dev)
    masks = data["support_masks"][0]
    valid = np.ones((2,), bool)
    ep = Episode(
        torch.from_numpy(np.ascontiguousarray(data["support_images"][0].transpose(0, 2, 3, 1)))
        .to(dev), torch.from_numpy(masks).to(dev), torch.from_numpy(valid).to(dev),
        torch.from_numpy(np.ascontiguousarray(data["query_image"][0].transpose(1, 2, 0))).to(dev),
        -1, support_host=(masks, valid))
    props = pad_proposals(torch.from_numpy(data["proposals"]).to(dev), 8)
    return model, ep, props, str(data["class_name"]), str(data["class_description"]), data


def test_predict_launch_equals_predict_without_a_sync(dev):
    """``Mars.predict_launch`` enqueues the ranking and returns without a
    synchronisation: CUDA's sync debug mode raises on none, and the CUDA
    runtime calls it makes (torch.profiler) hold no synchronise; read
    later, its mask is ``predict``'s, which is the fixture's.  (Holding the
    card with a long kernel proves nothing here: the launch queue's depth
    stalls the host's enqueue of a whole ranking.)"""
    from torch.profiler import ProfilerActivity, profile

    model, ep, props, name, desc, data = _golden_ranking(dev)
    assert props.n_live == len(data["proposals"]) and ep.support_host is not None
    want = model.predict(ep, props, class_name=name, class_description=desc)
    assert set(model.timings) == {"total", "after_text_extraction"}
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = model.predict_launch(ep, props, name, desc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again = model.predict_launch(ep, props, name, desc)
    events = prof.events()
    # the profiler synchronises as it stops: count only calls inside the
    # ranking's own spans (mars.text ... mars.score_merge)
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("mars.") and e.device_type == torch.autograd.DeviceType.CPU]
    inside = [e.name for e in events if e.name.startswith("cuda")
              and any(a <= e.time_range.start <= b for a, b in spans)]
    assert len(spans) == 5 and "cudaLaunchKernel" in inside, (spans, set(inside))
    assert not [n for n in inside if "Synchronize" in n or n == "cudaMemcpy"], set(inside)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)
    np.testing.assert_array_equal(got.cpu().numpy(), data["merged"])


def test_cost_negatives_dense_contested_equal_plain_on_card(dev, monkeypatch):
    """``negative_points_from_cost`` at one shot's 1369² (every row valid):
    the forward auction's 5 ε-phases on the kernel (5 launches), against
    the same flow with the plain phase on the card: the negatives bitwise
    equal."""
    from mars_tpu_torch.ops import assignment as asg
    from mars_tpu_torch.pipeline import matcher

    rng = np.random.RandomState(9)
    feats = rng.randn(2 * 1369, 64).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    cost = torch.from_numpy((1.0 - feats[:1369] @ feats[1369:].T) / 2.0).to(dev)
    fg = torch.from_numpy(rng.rand(1369) < 0.1).to(dev)
    cfg = matcher.MatcherConfig()
    before = asg.auction_assignment.launches
    pts, keep = matcher.negative_points_from_cost(cost, fg, cfg)
    assert asg.auction_assignment.launches - before == 5
    monkeypatch.setattr(asg, "_auction_phase_kernel", asg._auction_phase_plain)
    want_pts, want_keep = matcher.negative_points_from_cost(cost, fg, cfg)
    assert torch.equal(keep, want_keep) and torch.equal(pts, want_pts)
    assert int(keep.sum()) == 1369 // 2


def test_w8a8_int_mm_equals_cpu_int32(dev):
    """``torch._int_mm`` on the card against the CPU's int32 matmul at an
    AlphaCLIP-L chunk's MLP shape, bitwise, with the codes column-major (as
    ``quantize_params(act_bits=8)`` stores them) and row-major; a shape its
    rules refuse raises."""
    from mars_tpu_torch.models import quantization as q

    rng = np.random.RandomState(0)
    xq = torch.from_numpy(rng.randint(-127, 128, (16 * 577, 1024)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (1024, 4096)).astype(np.int8))
    want = q.int8_product(xq, w)
    for codes in (w.to(dev).t().contiguous().t(), w.to(dev)):
        got = q.int8_product(xq.to(dev), codes)
        assert got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="M > 16"):
        q.int8_product(xq[:16].to(dev), w.to(dev))
    with pytest.raises(ValueError):
        q.int8_product(xq[:, :1020].to(dev), w[:1020].to(dev))


def test_multicrop_launch_counts(dev, monkeypatch):
    """``generate_multicrop`` at one crop layer encodes five crops: the tiny
    fixture SAM (one global layer, two windowed) launches the windowed
    kernel twice an encode with the switch on, and the grid kernel never:
    its 4 × 4 grid is under the kernel's 1 024 tokens, where the global
    layer takes the plain route, as in the JAX package (at ViT-H's 64 × 64,
    ``chip_smoke.py`` counts 4 grid launches a crop)."""
    import os

    from mars_tpu_torch.models import convert, sam
    from mars_tpu_torch.ops import sam_attention as sa
    from mars_tpu_torch.pipeline import amg

    monkeypatch.setenv("MARS_SAM_WINDOWED_IMPL", "pallas")
    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "amg_multicrop_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    params = {"encoder": convert.from_reference_state_dict(sd, "sam_encoder", 3, device=dev),
              "prompt_encoder": convert.from_reference_state_dict(sd, "sam_prompt_encoder",
                                                                  device=dev),
              "decoder": convert.from_reference_state_dict(sd, "sam_decoder", device=dev)}
    cfg = sam.SamConfig(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
                        global_attn_indexes=(1,), window_size=2, out_chans=16,
                        decoder_mlp_dim=32, decoder_heads=2)
    acfg = amg.AmgConfig(points_per_side=4, decode_batch=16, pred_iou_thresh=0.0,
                         stability_score_thresh=0.0, box_nms_thresh=0.5, crop_n_layers=1,
                         crop_nms_thresh=0.5)
    img = torch.from_numpy(data["image"].astype(np.float32) / 255.0).to(dev)
    g0, w0 = sa.grid_attention.launches, sa.windowed_attention.launches
    out = amg.generate_multicrop(params, img, cfg, acfg, original_size=(64, 64))
    assert (sa.grid_attention.launches - g0, sa.windowed_attention.launches - w0) == (0, 10)
    assert out["masks"].shape == (5 * 48, 64, 64) and int(out["valid"].sum()) > 0


def test_semantic_sam_call_equals_cpu(dev):
    """One tiny Semantic-SAM Matcher call (the golden Matcher fixture's
    DINOv2, seeded ``SEMANTIC_SAM_TINY`` weights, the draw family fed the
    same noise) on the card against the same call on the CPU: 2 auction
    launches, the set logits at 1e-4, the same validity and chosen rows,
    masks that differ at few pixels and a merged mask at IoU >= 0.99."""
    import os

    from mars_tpu_torch.models import convert, dinov2, zoo
    from mars_tpu_torch.ops import assignment as asg
    from mars_tpu_torch.pipeline import matcher, matcher_oss

    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "golden_matcher_tiny.npz"))
    sd = {k[8:]: data[k] for k in data.files if k.startswith("sd.dino.")}
    cfg = matcher.MatcherConfig(input_size=64, grid=8, patch_size=8, sample_range=(2, 3),
                                max_sample_iterations=4, deep_score_filter=0.6,
                                deep_score_norm_filter=0.4, emd_row_bucket=16, emd_col_bucket=64)
    dcfg = dinov2.DinoV2Config(patch_size=8, embed_dim=32, depth=3, num_heads=2,
                               num_register_tokens=4, pos_embed_grid=8)
    ss_params, ss_cfg = zoo.build_semantic_sam(None, "tiny", device="cpu")
    sup = np.ascontiguousarray(data["support_images"][0].transpose(0, 2, 3, 1))
    qry = np.ascontiguousarray(data["query_image"][0].transpose(1, 2, 0))
    gumbel = -torch.empty((2 * 4, 64)).exponential_(
        generator=torch.Generator().manual_seed(0)).log()
    runs = {}
    for where in ("cpu", dev):
        def on(x):
            return torch.from_numpy(x).to(where)

        dino = convert.from_reference_state_dict(sd, "dinov2", 3, device=where)
        backend = matcher_oss.SemanticSamBackend(convert.from_jax_params(ss_params, where),
                                                 ss_cfg)
        before = asg.auction_assignment.launches
        out = matcher_oss.generate_proposals_oss(
            dino, dcfg, backend, cfg, on(sup), on(np.ones_like(data["support_masks"][0])),
            torch.ones((1,), dtype=torch.bool, device=where), on(qry), gumbel=gumbel,
            bucket=16)
        logits = backend.set_logits(on(qry), out["coords01"], out["labels"], out["set_valid"])
        runs[str(where)] = (out, logits.cpu(), asg.auction_assignment.launches - before)
    (cpu, cpu_logits, _), (card, card_logits, launches) = runs["cpu"], runs[str(dev)]
    assert launches == 2
    torch.testing.assert_close(card_logits, cpu_logits, atol=1e-4, rtol=1e-4)
    for key in ("proposal_valid", "set_valid", "chosen", "bucket_valid"):
        assert torch.equal(card[key].cpu(), cpu[key]), key
    flips = (card["proposal_masks"].cpu() != cpu["proposal_masks"]).sum().item()
    assert flips <= 1e-3 * cpu["proposal_masks"].numel()
    a, b = card["merged"].cpu() > 0, cpu["merged"] > 0
    assert (a & b).sum() >= 0.99 * max((a | b).sum().item(), 1)
    assert int(cpu["telemetry"]["n_matched_points"]) > 8 and cpu["proposal_valid"].any()
