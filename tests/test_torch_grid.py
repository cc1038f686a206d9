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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import sam_attention as jsa
from mars_tpu_torch.ops import sam_attention as tsa

BK = 64  # keys per tile


def _inputs(rng, nh, h, w, d):
    l = h * w
    return [rng.randn(*s).astype(np.float32) for s in
            ((nh, l, d), (nh, l, d), (nh, l, d), (nh, l, h), (nh, l, w))]


def _grid_tiles(q, k, v, bias_h, bias_w, grid_hw, skip_tile=None):
    """``grid_bf16``'s arithmetic (float32 inputs: the same without the
    roundings).  ``skip_tile`` drops one key tile: the fault the card's
    limit has to catch."""
    nh, l, d = q.shape
    w = grid_hw[1]
    qf, kf, vf, bh, bw = (t.float() for t in (q, k, v, bias_h, bias_w))
    m = torch.full((nh, l), -torch.inf)
    total = torch.zeros((nh, l))
    acc = torch.zeros(qf.shape)
    y = x0 = 0  # the aligned path's key row and first column of the tile
    for t, k0 in enumerate(range(0, l, BK)):
        keys = torch.arange(k0, min(k0 + BK, l))  # keys past L are not attended
        s = qf @ kf[:, keys].transpose(-1, -2) * d ** -0.5
        if w % BK == 0:
            s = (s + bh[:, :, y:y + 1]) + bw[:, :, x0:x0 + BK]
            x0 += BK
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
