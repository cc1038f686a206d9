"""The port's SAM windowed attention (``windowed_attention`` and the
``MARS_SAM_WINDOWED_IMPL`` route in ``sam._grid_attention``) against
mars_tpu.

JAX's window kernel runs in Pallas interpret mode, as its own tests run it;
the port takes the kernel's plain version on these CPU tensors.  Float32
tolerances: the same products summed in other orders, and JAX's bias
expansion through 0/1 matmuls (exact in float32).  Bfloat16: P and the
output are rounded to bfloat16 on both sides from float32 values taken in
other orders, so a value may land one bfloat16 rounding apart.

The float32 kernel (``csrc/sam_windowed_attention.cu``, ``windowed_f32``:
``tf32::biased_sweep`` of ``csrc/attention_tf32.cuh``) computes each product
as three TF32 passes of split operands (``csrc/sm90.cuh``):
``_windowed_f32`` emulates its arithmetic (SAM's 14-wide window at head
dims up to 80 in tiles of 4 key rows, 56 keys, the last 28 in a tile of 32;
any other window in key tiles of 64, 32 past head dim 80; keys past L
masked; each key's bias by its row and column in the window; each tile's
P·V in the kernel's order of keys inside each group of 8, summed from zero
and added to the rescaled output sum) and holds it to half the card's 2e-5
limit; one TF32 pass and a lost key tile both break the limit.
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
from torch_tiny import PV_ORDER, tf32_product, tf32_split

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BF16_TOL = dict(atol=1.6e-2, rtol=2 ** -7)
WINDOW_TOL = 2e-5  # the float32 kernel's limit on the card (chip_smoke.py, test_torch_cuda.py)
# csrc/sam_windowed_attention.cu: the window width swept in tiles of 4 key rows, and the
# width of the last tile where 28 keys are left
WINDOW_W, WINDOW_STEP, WINDOW_TAIL = 14, 56, 32


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


def _key_tiles(l, w, d):
    """(first key, width) of ``windowed_f32``'s key tiles: a window 14 wide
    whose L leaves 28 keys past whole tiles of 4 key rows (SAM's 196 = 3 ·
    56 + 28) at head dims up to 80 sweeps those, the last in a tile of 32;
    any other, tiles of 64 keys (32 past head dim 80)."""
    if w == WINDOW_W and d <= 80 and l % WINDOW_STEP == WINDOW_STEP // 2:
        starts = range(0, l - WINDOW_STEP // 2, WINDOW_STEP)
        return [(k0, WINDOW_STEP) for k0 in starts] + [(l - WINDOW_STEP // 2, WINDOW_TAIL)]
    tile = 32 if d > 80 else 64
    return [(k0, tile) for k0 in range(0, l, tile)]


def _windowed_f32(q, k, v, bias_h, bias_w, window_hw, mode="tf32x3", skip_tile=None):
    """``windowed_f32``'s arithmetic on (B, nh, L, d) float32 inputs: the key
    tiles of ``_key_tiles``; logits (s · d^-0.5 + bias_h[key row]) +
    bias_w[key column] with keys past L masked; a running max and sum per
    row; each tile's P·V (keys in the kernel's order) summed from zero, then
    added to the rescaled output sum.  ``mode`` "tf32" is one TF32 pass a
    product and ``skip_tile`` drops one key tile: the faults the card's
    limit has to catch."""
    d, l = q.shape[-1], q.shape[-2]
    w = window_hw[1]
    m = torch.full(q.shape[:-1], -torch.inf)
    total = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t, (k0, width) in enumerate(_key_tiles(l, w, d)):
        keys = torch.arange(k0, k0 + width)
        live_keys = keys[keys < l]  # the masked keys' P is 0
        if t == skip_tile:
            continue
        s = tf32_product(q, k[..., live_keys, :].transpose(-1, -2), mode) * d ** -0.5
        s = s + bias_h[..., live_keys // w]
        s = s + bias_w[..., live_keys % w]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        total = total * corr + p.sum(-1)
        order = torch.tensor([8 * (i // 8) + PV_ORDER[i % 8] for i in range(width)])
        live = order[order < len(live_keys)]
        acc = torch.addcmul(tf32_product(p[..., live], v[..., live_keys[live], :], mode), acc,
                            corr[..., None])
        m = m_new
    return acc * (1 / total)[..., None]


@pytest.mark.parametrize("b,nh,h,w,d", [(2, 3, 14, 14, 80), (2, 3, 14, 14, 64), (2, 2, 5, 6, 24),
                                        (1, 2, 14, 14, 128), (1, 2, 17, 17, 64),
                                        (2, 2, 6, 14, 80)])
def test_f32_tile_emulation_within_half_the_limit(b, nh, h, w, d):
    """The split form, emulated, at ViT-H's and ViT-B's windows (three tiles
    of 4 key rows and 28 keys in a tile of 32), a ragged window (one masked
    tile), head dim 128 (seven 32-key tiles, the last masked past its 4 live
    keys), a window of 289 keys (the last tile masked past its 33) and a
    14-wide window of 6 key rows (one tile of 4 rows, then 2)."""
    args = [torch.from_numpy(a) for a in _inputs(np.random.RandomState(12), b, nh, h, w, d)]
    err = (_windowed_f32(*args, (h, w)) - tsa.windowed_attention_plain(*args, (h, w)))
    assert err.abs().max().item() < WINDOW_TOL / 2


@pytest.mark.parametrize("fault", [dict(mode="tf32"), dict(skip_tile=1), dict(skip_tile=3)])
def test_f32_card_limit_catches_one_pass_or_a_lost_tile(fault):
    """One TF32 pass a product, a lost tile of 4 key rows and a lost last
    tile (28 live keys) at ViT-H's window each break the card's limit."""
    args = [torch.from_numpy(a) for a in _inputs(np.random.RandomState(13), 2, 3, 14, 14, 80)]
    err = (_windowed_f32(*args, (14, 14), **fault)
           - tsa.windowed_attention_plain(*args, (14, 14))).abs().max().item()
    assert err > WINDOW_TOL


@pytest.mark.parametrize("h,w,d", [(14, 14, 80), (5, 6, 24)])
def test_f32_tile_emulation_matches_pallas(h, w, d):
    """The split-TF32 emulation against JAX's window kernel in float32
    (interpret mode), within the card's limit."""
    args = _inputs(np.random.RandomState(14), 2, 2, h, w, d)
    want = jsa.windowed_attention_pallas(*map(jnp.asarray, args), (h, w), interpret=True)
    assert want.dtype == jnp.float32
    got = _windowed_f32(*map(torch.from_numpy, args), (h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=WINDOW_TOL, rtol=0)


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
