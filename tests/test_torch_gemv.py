"""The arithmetic of the bfloat16 decode GEMV (``csrc/int4_matmul.cu``,
``gemv_bf16``) emulated in PyTorch on the CPU, held against the port's
plain version and the JAX Pallas kernels (interpret mode, as
``tests/test_torch_int4_matmul.py`` runs them).

The kernel cannot run here; the emulation pins what it computes: the K
slices of ``gemv_split`` (whole 64-row blocks, cut as the kernel cuts
them: ``_slices``), inside a
slice float32 sums of k16 steps, the slices' partials added in slice order
0..S-1, int4's column scale after the sum, one rounding to x's type.  The
weights are the plain version's: int4's integers, NF4's code × absmax
rounded to x's type.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import quantization as JQ
from mars_tpu.ops import int4_matmul as jim
from mars_tpu_torch.models import quantization as TQ
from mars_tpu_torch.ops import int4_matmul as tim

CARD_REL = 2 ** -7  # chip_smoke.py / test_torch_cuda.py: 2^-7 x max |want|
DECODE_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
# S the card tests rely on: the 7B's decode shapes, and one slice (the
# kernel's direct store, no workspace) at IN 64 or past 33 792 columns
SPLITS = {(4096, 4096): 16, (4096, 11008): 4, (11008, 4096): 16, (64, 199): 1, (64, 384): 1,
          (128, 33800): 1, (128, 33792): 1}


def _slices(d_in, s):
    """The input rows [start, stop) of each of the GEMV's ``s`` K slices, as
    ``gemv_bf16`` cuts them: slice i takes 64-row blocks [B i / s,
    B (i+1) / s) of the B = ceil(IN / 64), the last block cut at IN."""
    blocks = -(-d_in // tim.GEMV_BLOCK)
    return [(i * blocks // s * tim.GEMV_BLOCK, min((i + 1) * blocks // s * tim.GEMV_BLOCK, d_in))
            for i in range(s)]


@pytest.mark.parametrize("din,dout", DECODE_SHAPES + (
    (5120, 4096), (1024, 4096), (1984, 999), (300, 199), (320, 384), (64, 8), (2, 5),
    (130, 40000), (64, 199), (64, 384), (128, 33800), (128, 33792)))
def test_gemv_split_covers_in_once(din, dout):
    """Slices tile [0, IN) in order, each starting on a 64-row block, none
    empty, lengths one block apart at most; S a power of two up to 16; the
    7B's decode shapes fill the card at two CTAs an SM."""
    s = tim.gemv_split(din, dout)
    bounds = _slices(din, s)
    assert 1 <= s <= tim.GEMV_MAX_SPLIT and s & (s - 1) == 0 and len(bounds) == s
    assert bounds[0][0] == 0 and bounds[-1][1] == din
    assert all(a < b and a % tim.GEMV_BLOCK == 0 for a, b in bounds)
    assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))
    blocks = [-(-(b - a) // tim.GEMV_BLOCK) for a, b in bounds]
    assert max(blocks) - min(blocks) <= 1
    tiles = -(-dout // tim.GEMV_COLS)
    if (din, dout) in DECODE_SHAPES:
        assert tiles * s >= tim.GEMV_MIN_CTAS
    assert s == SPLITS.get((din, dout), s)


def _emulate(fmt, x, packed, scale, drop=None, round_output=True):
    """``gemv_bf16`` on the CPU: per slice a float32 partial summed over k16
    steps, the partials added in slice order (``drop`` leaves one out: the
    fault the card's limit has to catch), int4's scale after the sum, one
    rounding to x's type (skipped with ``round_output=False``)."""
    m, din = x.shape
    if fmt == "int4":
        w = tim.unpack_int4(packed).float()
    else:
        w = TQ.dequantize_nf4({"nf4": packed, "bscale": scale}, x.dtype).float()
    xf = x.float()
    total = None
    for i, (a, b) in enumerate(_slices(din, tim.gemv_split(din, packed.shape[1]))):
        part = torch.zeros((m, packed.shape[1]))
        for k in range(a, b, 16):
            part = part + xf[:, k:k + 16] @ w[k:k + 16]
        if i != drop:
            total = part if total is None else total + part
    if fmt == "int4":
        total = total * scale.float()
    return total.to(x.dtype) if round_output else total


def _leaf(fmt, din, dout, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(din, dout).astype(np.float32)
    if fmt == "int4":
        leaf = JQ.quantize_kernel(jnp.asarray(w), 4)
        keys = ("q4", "scale")
    else:
        w = w * rng.gamma(1.0, 1.0, (1, dout)).astype(np.float32)
        leaf = JQ.quantize_kernel_nf4(jnp.asarray(w))
        keys = ("nf4", "bscale")
    return rng, leaf[keys[0]], leaf[keys[1]]


# (format, IN, OUT): ragged OUT (199: no whole 16-column warp tile), int4's
# ragged IN (300: the last k16 step half past IN), NF4 at IN 320; all split
# into unequal slices (5 blocks in 4)
SHAPES = [("int4", 300, 199), ("int4", 512, 384), ("nf4", 320, 199), ("nf4", 512, 384)]


@pytest.mark.parametrize("fmt,din,dout", SHAPES)
def test_emulation_matches_plain_f32(fmt, din, dout):
    """In float32 the slices and k16 steps compute the plain version's
    product: only the summation order differs (1e-5 relative)."""
    rng, packed, scale = _leaf(fmt, din, dout, seed=11)
    packed, scale = torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale))
    plain = tim.matmul_int4_plain if fmt == "int4" else tim.matmul_nf4_plain
    for m in (1, 3, 8):
        x = torch.from_numpy(rng.randn(m, din).astype(np.float32))
        want = plain(x, packed, scale)
        got = _emulate(fmt, x, packed, scale)
        top = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * top)


def _against_jax(fmt, din, dout, m, seed=12):
    """(bfloat16 x, packed, scale) as torch tensors, and JAX's Pallas kernel
    in interpret mode on the same values in float32 (its CPU dots take no
    bfloat16): the exact product, NF4's weights not rounded."""
    rng, packed, scale = _leaf(fmt, din, dout, seed)
    xb = torch.from_numpy(rng.randn(m, din).astype(np.float32)).to(torch.bfloat16)
    xj = jnp.asarray(xb.float().numpy())
    fn = jim.matmul_int4 if fmt == "int4" else jim.matmul_nf4
    want = np.asarray(fn(xj, packed, scale, interpret=True))
    return xb, torch.from_numpy(np.array(packed)), torch.from_numpy(np.array(scale)), want


@pytest.mark.parametrize("fmt,din,dout", SHAPES)
def test_emulation_bf16_matches_jax_under_half_the_card_limit(fmt, din, dout):
    """bfloat16 x: the emulation's output, rounded once to bf16, within half
    the card's limit (2^-8 x max |want|) of JAX's product: half an ulp of
    the rounding is at most 2^-8 |out|, and what else is left (NF4's weight
    rounding to bf16, the plain version's, 2^-9 relative a weight; the
    summation order) stays small, as the float32 sums before the rounding
    show."""
    for m in (1, 3, 4, 8):
        xb, packed, scale, want = _against_jax(fmt, din, dout, m)
        top = np.abs(want).max()
        out = _emulate(fmt, xb, packed, scale)
        assert out.dtype == torch.bfloat16
        assert np.abs(out.float().numpy() - want).max() <= 0.5 * CARD_REL * top, m
        sums = _emulate(fmt, xb, packed, scale, round_output=False).numpy()
        assert np.abs(sums - want).max() <= 0.5 * CARD_REL * top, m


@pytest.mark.parametrize("fmt,din,dout", [SHAPES[0], SHAPES[2]])
def test_card_limit_catches_a_dropped_slice(fmt, din, dout):
    """One K slice left out of the reduction moves the result past twice
    the card's limit: the limit separates rounding from a lost slice."""
    for m in (1, 4):
        xb, packed, scale, want = _against_jax(fmt, din, dout, m)
        top = np.abs(want).max()
        for drop in range(tim.gemv_split(din, dout)):
            sums = _emulate(fmt, xb, packed, scale, drop=drop, round_output=False).numpy()
            assert np.abs(sums - want).max() > 2 * CARD_REL * top, (m, drop)
