"""The arithmetic of the bfloat16 grid attention kernel
(``csrc/sam_grid_attention.cu``, ``grid_bf16``) emulated in PyTorch, held
against the port's plain version and, through it, the JAX Pallas kernel
(interpret mode, as its own tests run it).

The kernel cannot run here; the emulation pins what it computes: 64-key
tiles, float32 logits ``(s · d^-0.5 + bias_h) + bias_w``, a running max and
sum per row, P = exp(s - running max) rounded to bfloat16 unnormalised, the
row sum of the rounded P, one output rounding.  On an aligned grid (W a
multiple of 64, every SAM global layer) it takes the bias as the kernel
does: tile t is one key row y with columns x0..x0+63, stepped tile by tile,
``bias_h[..., y]`` and ``bias_w[..., x0:x0 + 64]``, never a ``k // W``
gather.

The float32 kernel (``grid_f32``) computes each product as three TF32
passes of split operands (``csrc/sm90.cuh``): ``mode="tf32x3"`` emulates
them, the split on the float32 bits as the kernel makes it, its key tiles
(32 keys past head dim 80), each tile's P.V summed from zero and then added
to the output sum, and its order of keys inside each group of 8 in P.V;
``mode="tf32"`` is a single TF32 pass, the fault the float32 limit has to
catch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import sam_attention as jsa
from mars_tpu_torch.ops import sam_attention as tsa
from torch_tiny import PV_ORDER, tf32_product, tf32_split

BK = 64  # keys per tile
GRID_TOL = 2e-5  # the float32 kernel's limit on the card (chip_smoke.py, test_torch_cuda.py)


def _inputs(rng, nh, h, w, d):
    l = h * w
    return [rng.randn(*s).astype(np.float32) for s in
            ((nh, l, d), (nh, l, d), (nh, l, d), (nh, l, h), (nh, l, w))]


def _grid_tiles(q, k, v, bias_h, bias_w, grid_hw, skip_tile=None, mode=None):
    """``grid_bf16``'s arithmetic (float32 inputs: the same without the
    roundings), or with ``mode`` ("tf32x3", "tf32") ``grid_f32``'s on
    float32 inputs.  ``skip_tile`` drops one key tile: the fault the card's
    limit has to catch."""
    nh, l, d = q.shape
    w = grid_hw[1]
    tile = 32 if mode and d > 80 else BK
    qf, kf, vf, bh, bw = (t.float() for t in (q, k, v, bias_h, bias_w))
    m = torch.full((nh, l), -torch.inf)
    total = torch.zeros((nh, l))
    acc = torch.zeros(qf.shape)
    # the order of a whole tile's keys in P.V (tf32 modes)
    order = torch.tensor([8 * (i // 8) + PV_ORDER[i % 8] for i in range(tile)])
    y = x0 = 0  # the aligned path's key row and first column of the tile
    for t, k0 in enumerate(range(0, l, tile)):
        keys = torch.arange(k0, min(k0 + tile, l))  # keys past L are not attended
        kt = kf[:, keys].transpose(-1, -2)
        s = (tf32_product(qf, kt, mode) if mode else qf @ kt) * d ** -0.5
        if w % tile == 0:
            s = (s + bh[:, :, y:y + 1]) + bw[:, :, x0:x0 + tile]
            x0 += tile
            if x0 == w:
                y, x0 = y + 1, 0
        else:
            s = (s + bh[:, :, keys // w]) + bw[:, :, keys % w]
        if t == skip_tile:
            continue
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if q.dtype == torch.bfloat16:
            p = p.bfloat16().float()
        total = total * corr + p.sum(-1)
        if mode:
            live = order[order < len(keys)]
            acc = torch.addcmul(tf32_product(p[..., live], vf[:, keys[live]], mode), acc,
                                corr[..., None])
        else:
            acc = acc * corr[..., None] + p @ vf[:, keys]
        m = m_new
    return (acc * (1 / total)[..., None]).to(q.dtype)


@pytest.mark.parametrize("h,w,d", [(2, 64, 80), (3, 128, 64), (5, 7, 24), (33, 31, 128)])
def test_tile_emulation_matches_plain_f32(h, w, d):
    """In float32 the tile sweep computes the plain version's softmax: only
    the summation order differs, so the bias of each tile is the right one."""
    args = [torch.from_numpy(a) for a in _inputs(np.random.RandomState(3), 2, h, w, d)]
    np.testing.assert_allclose(_grid_tiles(*args, (h, w)).numpy(),
                               tsa.grid_attention_plain(*args, (h, w)).numpy(),
                               atol=1e-5, rtol=0)


def _card_limit(args, grid_hw):
    """The plain version's bf16 output and the limit the kernel's bf16
    outputs are held to on the card (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``): 2^-7 (|want| + P|v|) element by element."""
    want = tsa.grid_attention_plain(*args, grid_hw).float()
    on_abs_v = tsa.grid_attention_plain(*args[:2], args[2].abs(), *args[3:], grid_hw).float()
    return want, 2 ** -7 * (want.abs() + on_abs_v)


@pytest.mark.parametrize("h,w,d", [(2, 64, 80), (9, 16, 24)])
def test_bf16_card_limit_separates_rounding_from_a_lost_tile(h, w, d):
    """The kernel's own rounding, emulated, stays under half the card's
    limit; a kernel that skips one key tile goes past it twice over."""
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(np.random.RandomState(4), 4,
                                                            h, w, d)]
    want, limit = _card_limit(args, (h, w))

    def worst(got):
        return ((got.float() - want).abs() / limit).max().item()

    assert worst(_grid_tiles(*args, (h, w))) < 0.5
    assert worst(_grid_tiles(*args, (h, w), skip_tile=1)) > 2


def test_plain_matches_pallas_bf16_under_card_limit():
    """The port's bf16 plain version against the Pallas kernel (interpret
    mode) on a W = 64 grid at SAM ViT-H's head dim."""
    h, w, d = 2, 64, 80
    arrays = _inputs(np.random.RandomState(6), 2, h, w, d)
    args = [torch.from_numpy(a).bfloat16() for a in arrays]
    got = tsa.grid_attention(*args, (h, w))
    want = jsa.grid_attention_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), (h, w),
                                     interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.asarray(want, np.float32))
    on_abs_v = tsa.grid_attention_plain(*args[:2], args[2].abs(), *args[3:], (h, w)).float()
    limit = 2 ** -7 * (want.abs() + on_abs_v)
    assert ((got.float() - want).abs() / limit).max().item() <= 1


def test_tf32_split_reconstructs_float32():
    """hi is x rounded to 11 significant bits, ties away from zero (against
    the scaled mantissa rounded in float64), lo is x - hi cut to 11
    significant bits toward zero, both are TF32 values, and hi + lo is x to
    within 2^-21 relative, over exponents from 2^-60 to 2^60 and at exact
    ties."""
    rng = np.random.RandomState(0)
    x = (rng.randn(20000) * 2.0 ** rng.randint(-60, 60, 20000)).astype(np.float32)
    ties = np.float32([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 3 + 2 ** -10])
    x = np.concatenate([x, ties])
    hi, lo = (t.double().numpy() for t in tf32_split(torch.from_numpy(x)))
    xd = x.astype(np.float64)
    mant, exp = np.frexp(xd)
    np.testing.assert_array_equal(
        hi, np.ldexp(np.sign(mant) * np.floor(np.abs(mant) * 2 ** 11 + 0.5), exp - 11))
    np.testing.assert_array_equal(hi[-4:], [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                                            3 + 2 ** -9])
    rest = xd - hi  # exact in float32
    mant, exp = np.frexp(rest)
    np.testing.assert_array_equal(lo, np.ldexp(np.trunc(mant * 2 ** 11), exp - 11))
    for part in (hi, lo):
        assert not (part.astype(np.float32).view(np.uint32) & 0x1FFF).any()
    assert (np.abs(hi + lo - xd) <= 2.0 ** -21 * np.abs(xd)).all()


@pytest.mark.parametrize("h,w,d", [(2, 64, 80), (5, 7, 24), (3, 11, 96)])
def test_tf32x3_emulation_within_half_the_f32_limit(h, w, d):
    """The split form's error, emulated, stays under half of the float32
    kernel's 2e-5 limit against the plain version, at ViT-H's head dim on a
    W = 64 grid, on a ragged grid and past head dim 80 (32-key tiles); one
    TF32 pass and a skipped key tile are both past the limit."""
    args = [torch.from_numpy(a) for a in _inputs(np.random.RandomState(7), 2, h, w, d)]
    want = tsa.grid_attention_plain(*args, (h, w))

    def err(**kw):
        return (_grid_tiles(*args, (h, w), **kw) - want).abs().max().item()

    assert err(mode="tf32x3") < GRID_TOL / 2
    assert err(mode="tf32") > GRID_TOL
    # a 5 x 7 grid is one tile: without it the output is 0 / 0
    assert not err(mode="tf32x3", skip_tile=0) <= GRID_TOL


@pytest.mark.parametrize("h,w,d", [(2, 64, 80), (5, 7, 24)])
def test_tf32x3_emulation_matches_pallas_f32(h, w, d):
    """The split-TF32 emulation against the Pallas kernel in float32
    (interpret mode), within the card's limit."""
    arrays = _inputs(np.random.RandomState(8), 2, h, w, d)
    got = _grid_tiles(*(torch.from_numpy(a) for a in arrays), (h, w), mode="tf32x3")
    want = jsa.grid_attention_pallas(*(jnp.asarray(a) for a in arrays), (h, w), interpret=True)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRID_TOL, rtol=0)
