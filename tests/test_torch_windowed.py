"""The port's SAM windowed attention (``windowed_attention`` and the
``MARS_SAM_WINDOWED_IMPL`` route in ``sam._grid_attention``) against
mars_tpu.

JAX's window kernel runs in Pallas interpret mode, as its own tests run it;
the port takes the kernel's plain version on these CPU tensors.  Float32
tolerances: the same products summed in other orders, and JAX's bias
expansion through 0/1 matmuls (exact in float32).  Bfloat16: P and the
output are rounded to bfloat16 on both sides from float32 values taken in
other orders, so a value may land one bfloat16 rounding apart.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import convert as jconvert, layers as jL, sam as jsam
from mars_tpu.ops import sam_attention as jsa
from mars_tpu_torch.models import convert as tconvert, sam as tsam
from mars_tpu_torch.ops import sam_attention as tsa

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BF16_TOL = dict(atol=1.6e-2, rtol=2 ** -7)


def _inputs(rng, b, nh, h, w, d):
    l = h * w
    return [rng.randn(*s).astype(np.float32) for s in
            ((b, nh, l, d), (b, nh, l, d), (b, nh, l, d), (b, nh, l, h), (b, nh, l, w))]


@pytest.mark.parametrize("b,nh", [(2, 2), (3, 4)])
def test_plain_matches_pallas(b, nh):
    args = _inputs(np.random.RandomState(5), b, nh, 5, 6, 24)
    want = jsa.windowed_attention_pallas(*map(jnp.asarray, args), (5, 6), interpret=True)
    got = tsa.windowed_attention(*map(torch.from_numpy, args), (5, 6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    assert torch.equal(got, tsa.windowed_attention_plain(*map(torch.from_numpy, args), (5, 6)))


@pytest.mark.parametrize("h,w,d", [(5, 6, 24), (14, 14, 80)])
def test_plain_matches_pallas_bf16(h, w, d):
    args = _inputs(np.random.RandomState(7), 2, 2, h, w, d)
    want = jsa.windowed_attention_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in args), (h, w),
                                         interpret=True)
    got = tsa.windowed_attention(*(torch.from_numpy(a).bfloat16() for a in args), (h, w))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def _windowed_tiles(q, k, v, bias_h, bias_w, window_hw, two_sweeps, skip_tile=None):
    """``csrc/sam_windowed_attention.cu``'s bfloat16 arithmetic: key tiles of
    64 and float32 logits (s · d^-0.5 + bias_h) + bias_w, then either (the
    streamed kernel, ``two_sweeps``) a running max and sum per row over the
    tiles giving its log-sum-exp and P = exp(logit - lse) from the same
    logits recomputed, or (the resident kernel) every tile's logits held,
    their exact max and sum, and P = exp(logit - max) · (1 / sum).  P is
    rounded to bfloat16 when the inputs are, P·V runs in float32 and the
    output is rounded once at the end.  ``skip_tile`` drops one key tile:
    the fault the card's limit has to catch."""
    b, nh, l, d = q.shape
    w = window_hw[1]
    qf, kf, vf, bh, bw = (t.float() for t in (q, k, v, bias_h, bias_w))
    starts = [k0 for t, k0 in enumerate(range(0, l, 64)) if t != skip_tile]

    def logits(k0):
        keys = torch.arange(k0, min(k0 + 64, l))
        s = qf @ kf[..., keys, :].transpose(-1, -2)
        return (s * d ** -0.5 + bh[..., keys // w]) + bw[..., keys % w]

    def rounded(p):
        return p.bfloat16().float() if q.dtype == torch.bfloat16 else p

    acc = torch.zeros(qf.shape)
    if two_sweeps:
        m = torch.full((b, nh, l), -torch.inf)
        total = torch.zeros((b, nh, l))
        for k0 in starts:
            s = logits(k0)
            m_new = torch.maximum(m, s.amax(-1))
            total = total * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
            m = m_new
        lse = m + torch.log(total)
        for k0 in starts:
            acc = acc + rounded(torch.exp(logits(k0) - lse[..., None])) @ vf[..., k0:k0 + 64, :]
    else:
        s = [logits(k0) for k0 in starts]
        m = torch.stack([t.amax(-1) for t in s]).amax(0)[..., None]
        e = [torch.exp(t - m) for t in s]
        inv = 1 / sum(t.sum(-1) for t in e)[..., None]
        for k0, t in zip(starts, e):
            acc = acc + rounded(t * inv) @ vf[..., k0:k0 + 64, :]
    return acc.to(q.dtype)


@pytest.mark.parametrize("two_sweeps", [True, False])
@pytest.mark.parametrize("h,w,d", [(14, 14, 80), (10, 10, 64), (5, 6, 24)])
def test_tile_emulation_matches_plain_f32(h, w, d, two_sweeps):
    """In float32 both kernel designs compute the plain version's softmax:
    only the summation order differs."""
    args = [torch.from_numpy(a) for a in _inputs(np.random.RandomState(9), 2, 3, h, w, d)]
    np.testing.assert_allclose(_windowed_tiles(*args, (h, w), two_sweeps).numpy(),
                               tsa.windowed_attention_plain(*args, (h, w)).numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("two_sweeps", [True, False])
@pytest.mark.parametrize("h,w,d", [(14, 14, 80), (10, 10, 64)])
def test_bf16_card_limit_separates_rounding_from_a_lost_tile(h, w, d, two_sweeps):
    """The limit the kernel's bf16 outputs are held to on the card
    (``chip_smoke.py``, ``tests/test_torch_cuda.py``): 2^-7 (|want| + P|v|)
    element by element.  The kernel's own rounding, emulated, stays under
    half of it; a kernel that skips one key tile goes past it twice over."""
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(np.random.RandomState(11), 2, 4,
                                                             h, w, d)]
    want = tsa.windowed_attention_plain(*args, (h, w)).float()
    limit = 2 ** -7 * (want.abs() + tsa.windowed_attention_plain(
        *args[:2], args[2].abs(), *args[3:], (h, w)).float())

    def worst(got):
        return ((got.float() - want).abs() / limit).max().item()

    assert worst(_windowed_tiles(*args, (h, w), two_sweeps)) < 0.5
    assert worst(_windowed_tiles(*args, (h, w), two_sweeps, skip_tile=1)) > 2


def _window_params(rng, c, hd, h, w):
    return {"qkv": {"kernel": rng.randn(c, 3 * c).astype(np.float32) * 0.05,
                    "bias": rng.randn(3 * c).astype(np.float32) * 0.1},
            "proj": {"kernel": rng.randn(c, c).astype(np.float32) * 0.05,
                     "bias": np.zeros((c,), np.float32)},
            "rel_pos_h": rng.randn(2 * h - 1, hd).astype(np.float32) * 0.1,
            "rel_pos_w": rng.randn(2 * w - 1, hd).astype(np.float32) * 0.1}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_windowed_layer_matches_jax(monkeypatch, impl):
    """``_grid_attention`` on a batch of 9 windows of 7 × 7, the switch on
    (the kernel's route) and off (the plain route), against JAX's window
    kernel (``windowed_pallas=True``, interpret mode)."""
    rng = np.random.RandomState(6)
    b, h, w, c, nh = 9, 7, 7, 48, 2
    x = rng.randn(b, h, w, c).astype(np.float32)
    p = _window_params(rng, c, c // nh, h, w)
    jL.set_attention_impl("pallas_interpret")
    try:
        want = jsam._grid_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), nh,
                                    windowed_pallas=True)
    finally:
        jL.set_attention_impl("auto")
    monkeypatch.setenv(tsam.WINDOWED_IMPL_ENV, impl)
    got = tsam._grid_attention(tconvert.from_jax_params(p), torch.from_numpy(x), nh,
                               route="window")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_encoder_matches_jax(monkeypatch):
    """The tiny SAM encoder (2 × 2 windows, one global layer) with the
    switch on, against JAX's encoder with both kernels in interpret mode:
    the windowed layers' zero-padded border tokens are keys on both sides."""
    data = np.load(os.path.join(FIXTURES, "sam_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    jp = jconvert.sam_encoder_to_flax(sd, depth=3)
    img = np.ascontiguousarray(np.transpose(data["image"], (0, 2, 3, 1)))
    cfg = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
               global_attn_indexes=(1,), window_size=3, out_chans=16)
    jL.set_attention_impl("pallas_interpret")
    try:
        want = jsam.encode_image(jp, jnp.asarray(img), jsam.SamConfig(**cfg))
    finally:
        jL.set_attention_impl("auto")
    monkeypatch.setenv(tsam.WINDOWED_IMPL_ENV, "pallas")
    got = tsam.encode_image(tconvert.from_jax_params(jax.tree.map(np.asarray, jp)),
                            torch.from_numpy(img), tsam.SamConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_cpu_takes_plain_without_counting():
    args = [torch.from_numpy(a) for a in _inputs(np.random.RandomState(1), 1, 2, 3, 4, 8)]
    before = tsa.windowed_attention.launches
    tsa.windowed_attention(*args, (3, 4))
    assert tsa.windowed_attention.launches == before


@pytest.mark.parametrize("value", ["auto", "pallas_interpret", "Pallas"])
def test_unknown_switch_value_raises(monkeypatch, value):
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 3, 3, 16).astype(np.float32))
    p = tconvert.from_jax_params(_window_params(rng, 16, 8, 3, 3))
    monkeypatch.setenv(tsam.WINDOWED_IMPL_ENV, value)
    with pytest.raises(ValueError, match=tsam.WINDOWED_IMPL_ENV):
        tsam._grid_attention(p, x, 2, route="window")
    tsam._grid_attention(p, x, 2, route="global")  # a global layer never reads the switch
