"""The arithmetic of the bfloat16 skinny GEMM (``csrc/int4_matmul.cu``,
``gemm_skinny_bf16``: 8 < M <= ``SKINNY_MAX_ROWS``, a speculative verify
forward's rows) emulated in PyTorch on the CPU, held against the port's
plain version and the JAX Pallas kernels (interpret mode, as
``tests/test_torch_int4_matmul.py`` runs them), and the wrapper's choice of
kernel, K slices and row groups.

The kernel cannot run here; the emulation pins what it computes: the K
slices of ``skinny_split`` (whole 64-row blocks, cut as the kernel and the
GEMV cut them: ``test_torch_gemv._slices``), inside a slice float32 sums of k16 steps (wgmma m64nNk16), the
slices' partials added in slice order 0..S-1, int4's column scale after the
sum, one rounding to bf16.  Row groups split M between CTAs and change no
row's arithmetic.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mars_tpu_torch.models import quantization as TQ
from mars_tpu_torch.ops import int4_matmul as tim
from test_torch_gemv import CARD_REL, _against_jax, _leaf, _slices

LLAMA_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
VERIFY_ROWS = (9, 18, 36, 72)
# S the card tests and chip_smoke.py's rows rely on, at every verify row
SPLITS = {(4096, 4096): 8, (4096, 11008): 3, (11008, 4096): 8}
SOURCE = Path(tim.__file__).resolve().parent.parent / "csrc" / "int4_matmul.cu"


@pytest.mark.parametrize("din,dout", LLAMA_SHAPES + (
    (5120, 4096), (1984, 384), (1984, 999), (300, 199), (320, 384), (64, 8), (64, 199),
    (128, 33800)))
@pytest.mark.parametrize("m", VERIFY_ROWS + (10, 73, 144, 145, 168, 1000))
def test_skinny_split_covers_in_once(din, dout, m):
    """Slices tile [0, IN) in order, each starting on a 64-row block, none
    empty, lengths one block apart at most, S at most 8; G row groups of
    at most SKINNY_GROUP_ROWS rows cover M; the 7B's shapes fill one wave
    of two CTAs an SM, and one slice more would pass it, with the S pinned
    here."""
    s, g = tim.skinny_split(din, dout, m)
    bounds = _slices(din, s)
    assert 1 <= s <= tim.SKINNY_MAX_SPLIT and len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == din
    assert all(a < b and a % tim.GEMV_BLOCK == 0 for a, b in bounds)
    assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))
    blocks = [-(-(b - a) // tim.GEMV_BLOCK) for a, b in bounds]
    assert max(blocks) - min(blocks) <= 1
    rows = -(-m // g)
    assert rows <= tim.SKINNY_GROUP_ROWS and (g - 1) * rows < m
    tiles = -(-dout // tim.SKINNY_COLS)
    if (din, dout) in LLAMA_SHAPES:
        assert tiles * g * s <= tim.GEMV_MIN_CTAS < tiles * g * (s + 1) or s == 1
        if m <= tim.SKINNY_GROUP_ROWS:
            assert (s, g) == (SPLITS[(din, dout)], 1)


def test_skinny_constants_match_the_kernel():
    """The wrapper's row-group and split limits are the kernel's: N = 8 x
    SK_MAX_NT x rows at most, SK_MAX_SPLIT slices at most, 128 columns."""
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert tim.SKINNY_GROUP_ROWS <= 8 * const("SK_MAX_NT")
    assert tim.SKINNY_MAX_SPLIT == const("SK_MAX_SPLIT")
    assert tim.SKINNY_COLS == const("SK_COLS") == tim.GEMV_COLS
    assert tim.SKINNY_MAX_ROWS >= max(VERIFY_ROWS)


def _emulate(fmt, x, packed, scale, drop=None, round_output=True):
    """``gemm_skinny_bf16`` on the CPU: per slice a float32 partial summed
    over k16 steps, the partials added in slice order (``drop`` leaves one
    out: the fault the card's limit has to catch), int4's scale after the
    sum, one rounding to x's type (skipped with ``round_output=False``)."""
    m, din = x.shape
    if fmt == "int4":
        w = tim.unpack_int4(packed).float()
    else:
        w = TQ.dequantize_nf4({"nf4": packed, "bscale": scale}, x.dtype).float()
    xf = x.float()
    total = None
    s, _ = tim.skinny_split(din, packed.shape[1], m)
    for i, (a, b) in enumerate(_slices(din, s)):
        part = torch.zeros((m, packed.shape[1]))
        for k in range(a, b, 16):
            part = part + xf[:, k:k + 16] @ w[k:k + 16]
        if i != drop:
            total = part if total is None else total + part
    if fmt == "int4":
        total = total * scale.float()
    return total.to(x.dtype) if round_output else total


# (format, IN, OUT): ragged OUT (199: no whole 16-column warp tile), int4's
# ragged IN (300: the last k16 step half past IN), unequal slices (1984: 31
# blocks in 16), NF4 at IN 320 and 1024
SHAPES = [("int4", 300, 199), ("int4", 1984, 384), ("nf4", 320, 199), ("nf4", 1024, 384)]


@pytest.mark.parametrize("fmt,din,dout", SHAPES)
def test_skinny_emulation_matches_plain_f32(fmt, din, dout):
    """In float32 the slices and k16 steps compute the plain version's
    product: only the summation order differs (1e-5 relative)."""
    rng, packed, scale = _leaf(fmt, din, dout, seed=21)
    packed, scale = torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale))
    plain = tim.matmul_int4_plain if fmt == "int4" else tim.matmul_nf4_plain
    for m in (9, 40, 72):
        x = torch.from_numpy(rng.randn(m, din).astype(np.float32))
        want = plain(x, packed, scale)
        got = _emulate(fmt, x, packed, scale)
        top = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * top)


@pytest.mark.parametrize("fmt,din,dout", SHAPES)
def test_skinny_emulation_bf16_matches_jax_under_half_the_card_limit(fmt, din, dout):
    """bfloat16 x: the emulation's output, rounded once to bf16, and its
    float32 sums before the rounding, within half the card's limit (2^-8 x
    max |want|) of JAX's product (the bound of test_torch_gemv.py: half an
    ulp of the rounding, NF4's weights rounded to bf16 as the plain version
    rounds them, the summation order)."""
    for m in (9, 36):
        xb, packed, scale, want = _against_jax(fmt, din, dout, m, seed=22)
        top = np.abs(want).max()
        out = _emulate(fmt, xb, packed, scale)
        assert out.dtype == torch.bfloat16
        assert np.abs(out.float().numpy() - want).max() <= 0.5 * CARD_REL * top, m
        sums = _emulate(fmt, xb, packed, scale, round_output=False).numpy()
        assert np.abs(sums - want).max() <= 0.5 * CARD_REL * top, m


@pytest.mark.parametrize("fmt,din,dout", [SHAPES[1], SHAPES[3]])
def test_skinny_card_limit_catches_a_dropped_slice(fmt, din, dout):
    """One K slice left out of the reduction moves the result past twice
    the card's limit: the limit separates rounding from a lost slice."""
    xb, packed, scale, want = _against_jax(fmt, din, dout, 18, seed=23)
    top = np.abs(want).max()
    for drop in range(tim.skinny_split(din, dout, 18)[0]):
        sums = _emulate(fmt, xb, packed, scale, drop=drop, round_output=False).numpy()
        assert np.abs(sums - want).max() > 2 * CARD_REL * top, drop


class _Recorder:
    """Stands in for the CUDA library: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def mars_matmul_4bit(self, *args):
        self.calls.append(args)
        return 0


# the boundary tools/prefill_probe.py measured on an H100: the
# skinny GEMM through 96 rows, the prefill GEMM from 97 (the pipelined
# stage's 128-row and the block's 512-row suffix forwards, prefill)
PREFILL_FROM = 97


@pytest.mark.parametrize("m", [1, 8, 9, 18, 36, 72, 73, tim.SKINNY_MAX_ROWS,
                               tim.SKINNY_MAX_ROWS + 1, 128, 512, 2330])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_by_rows(monkeypatch, m, dtype):
    """The kernel a call takes by M: the GEMV up to 8 rows (bfloat16: a
    split-K workspace of S x 8 rows), the skinny GEMM (bfloat16) up to
    SKINNY_MAX_ROWS = 96 with skinny_split's S and G and a workspace of S x
    M rows, the prefill GEMM above it (S = 1, G = 0, no workspace); one
    launch a call.  The library is replaced by a recorder, so this runs on
    the CPU."""
    assert tim.SKINNY_MAX_ROWS == PREFILL_FROM - 1
    rec = _Recorder()
    monkeypatch.setattr(tim, "_library", lambda: rec)
    monkeypatch.setattr(tim, "_current_stream", lambda device: 7)
    monkeypatch.setattr(tim, "_WORKSPACE", {})
    din, dout = 4096, 4096
    x = torch.zeros((m, din), dtype=dtype)
    packed = torch.zeros((din // 2, dout), dtype=torch.int8)
    tim._launch(0, x, packed, torch.ones(dout))
    (call,) = rec.calls
    split, groups, ws = call[10], call[11], call[12]
    want = ("gemv" if m <= 8 else "skinny" if m <= tim.SKINNY_MAX_ROWS and dtype == torch.bfloat16
            else "gemm")
    assert tim.route(m, dtype) == want
    if want in ("skinny", "gemv") and dtype == torch.bfloat16:
        rows = m if want == "skinny" else 8
        want_split = (tim.skinny_split(din, dout, m) if want == "skinny"
                      else (tim.gemv_split(din, dout), 0))
        assert (split, groups) == want_split
        if want == "skinny":
            assert want_split == ((8, 1) if m <= tim.SKINNY_GROUP_ROWS
                                  else (264 // (32 * groups), -(-m // tim.SKINNY_GROUP_ROWS)))
        floats = tim._WORKSPACE[(x.device, 7)][0].numel()
        assert ws is not None and floats == split * rows * (dout // tim.GEMV_COLS) * 128
    else:
        assert (split, groups, ws) == (1, 0, None)
