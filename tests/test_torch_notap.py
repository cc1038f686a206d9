"""The port's untapped attention (``attention_notap`` and the
``MARS_ATTENTION_NOTAP_IMPL`` route in ``layers.mha``) against mars_tpu.

JAX's kernel runs in Pallas interpret mode, as its own tests run it; the
port takes the kernel's plain version on these CPU tensors.  Float32
tolerances: the two sides sum the same products in other orders (1e-5
absolute on outputs of order 1).  Bfloat16: both round P to bfloat16 and
the output to bfloat16 from float32 sums taken in other orders, so a
value may land one bfloat16 rounding apart (2^-8 relative, 1.6e-2 at the
largest outputs here).

The float32 kernel (``csrc/attention_notap.cu``, ``notap_f32``) computes
each product as three TF32 passes of split operands (``csrc/sm90.cuh``):
``_notap_f32`` emulates its arithmetic (64-key tiles, 32 past head dim 80;
each tile's P·V in the kernel's order of keys inside each group of 8,
summed from zero and added to the output sum) and holds it to half the
card's 2e-5 limit; one TF32 pass and a lost key tile both break the limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import clip as jclip, layers as jL, zoo as jzoo
from mars_tpu.ops import flash_attention as jfa
from mars_tpu_torch.models import clip as tclip, convert as tconvert, layers as tL
from mars_tpu_torch.ops import flash_attention as tfa
from torch_tiny import tf32_sweep

BF16_TOL = dict(atol=1.6e-2, rtol=2 ** -7)
NOTAP_TOL = 2e-5  # the float32 kernel's limit on the card (chip_smoke.py, test_torch_cuda.py)


def _qkv(rng, shape):
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("l", [64, 200, 577, 900])
def test_plain_matches_pallas(l):
    q, k, v = _qkv(np.random.RandomState(0), (2, 3, l, 32))
    want = jfa.attention_notap(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = tfa.attention_notap(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)
    plain = tfa.attention_notap_plain(*map(torch.from_numpy, (q, k, v)))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("l", [130, 577])
def test_plain_matches_pallas_bf16(l):
    q, k, v = _qkv(np.random.RandomState(3), (1, 2, l, 16))
    want = jfa.attention_notap(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                               interpret=True)
    got = tfa.attention_notap(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)


def _flash_bf16(q, k, v, skip_tile=None):
    """``csrc/attention_notap.cu``'s arithmetic on bfloat16 inputs: key tiles
    of 64, a float32 running max and sum, exp(s - running max) rounded to
    bfloat16 before P·V, the output rounded once at the end.  ``skip_tile``
    drops one key tile: the fault the card's limit has to catch."""
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -torch.inf)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for t, k0 in enumerate(range(0, k.shape[-2], 64)):
        if t == skip_tile:
            continue
        s = qf @ kf[..., k0:k0 + 64, :].transpose(-1, -2) * q.shape[-1] ** -0.5
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]).bfloat16().float()
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vf[..., k0:k0 + 64, :]
        m = m_new
    return (acc / l[..., None]).bfloat16()


@pytest.mark.parametrize("l", [577, 1090])
def test_bf16_card_limit_separates_rounding_from_a_lost_tile(l):
    """The limit the kernels' bf16 outputs are held to on the card
    (``chip_smoke.py``, ``tests/test_torch_cuda.py``): 2^-7 (|want| + P|v|)
    element by element.  The kernel's own rounding, emulated, stays under
    half of it; a kernel that skips one key tile goes past it twice over."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(np.random.RandomState(7),
                                                            (1, 4, l, 64)))
    want = tfa.attention_notap_plain(q, k, v).float()
    limit = 2 ** -7 * (want.abs() + tfa.attention_notap_plain(q, k, v.abs()).float())

    def worst(got):
        return ((got.float() - want).abs() / limit).max().item()

    assert worst(_flash_bf16(q, k, v)) < 0.5
    assert worst(_flash_bf16(q, k, v, skip_tile=1)) > 2


def _notap_f32(q, k, v, mode="tf32x3", skip_tile=None):
    """``notap_f32``'s arithmetic on (B, H, L, D) float32 inputs
    (``torch_tiny.tf32_sweep``); ``mode`` "tf32" is one TF32 pass a product
    and ``skip_tile`` drops one key tile: the faults the card's limit has to
    catch."""
    return tf32_sweep(q, k, v, mode, skip_tile)[0]


@pytest.mark.parametrize("shape", [(2, 3, 577, 64), (1, 4, 1374, 64), (2, 2, 200, 32),
                                   (1, 2, 17, 128), (3, 1, 1, 8)])
def test_f32_tile_emulation_within_half_the_limit(shape):
    """The split form, emulated, at an AlphaCLIP-L chunk's and DINOv2-L's
    length, a ragged tile, the widest head dim (32-key tiles) and one key."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.RandomState(8), shape))
    err = (_notap_f32(q, k, v) - tfa.attention_notap_plain(q, k, v)).abs().max().item()
    assert err < NOTAP_TOL / 2


@pytest.mark.parametrize("fault", [dict(mode="tf32"), dict(skip_tile=1)])
def test_f32_card_limit_catches_one_pass_or_a_lost_tile(fault):
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.RandomState(9), (2, 3, 577, 64)))
    err = (_notap_f32(q, k, v, **fault) - tfa.attention_notap_plain(q, k, v)).abs().max().item()
    assert err > NOTAP_TOL


@pytest.mark.parametrize("shape", [(2, 3, 200, 32), (1, 2, 577, 64)])
def test_f32_tile_emulation_matches_pallas(shape):
    """The split-TF32 emulation against JAX's kernel in float32 (interpret
    mode), within the card's limit."""
    q, k, v = _qkv(np.random.RandomState(10), shape)
    want = jfa.attention_notap(*map(jnp.asarray, (q, k, v)), interpret=True)
    assert want.dtype == jnp.float32
    got = _notap_f32(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NOTAP_TOL, rtol=0)


def test_cpu_takes_plain_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.RandomState(1), (1, 2, 20, 8)))
    before = tfa.attention_notap.launches
    tfa.attention_notap(q, k, v)
    assert tfa.attention_notap.launches == before


def _attn_params(rng, d):
    return {"qkv": {"kernel": rng.randn(d, 3 * d).astype(np.float32) * 0.1,
                    "bias": rng.randn(3 * d).astype(np.float32) * 0.1},
            "proj": {"kernel": rng.randn(d, d).astype(np.float32) * 0.1,
                     "bias": rng.randn(d).astype(np.float32) * 0.1}}


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mha_untapped_matches_jax(monkeypatch, impl):
    """``layers.mha(return_attn=False)`` with the switch on (the kernel's
    route) and off (the plain route), against JAX's ``L.mha`` through its
    kernel in interpret mode."""
    rng = np.random.RandomState(4)
    b, l, d, nh = 2, 100, 64, 4
    x = rng.randn(b, l, d).astype(np.float32)
    p = _attn_params(rng, d)
    jL.set_attention_impl("pallas_interpret")
    try:
        want, none = jL.mha(jax.tree.map(jnp.asarray, p), jnp.asarray(x), nh)
    finally:
        jL.set_attention_impl("auto")
    assert none is None
    monkeypatch.setenv(tL.NOTAP_IMPL_ENV, impl)
    got, none = tL.mha(tconvert.from_jax_params(p), torch.from_numpy(x), nh)
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_visual_cls_matches_jax(monkeypatch):
    """``clip.visual_cls`` (the AlphaCLIP ranking head), alpha channel on,
    every block through the untapped route, against JAX's kernel path."""
    cfg = dict(patch_size=16, width=32, depth=2, num_heads=2, output_dim=8, pos_embed_grid=2,
               alpha_channel=True)
    jcfg = jclip.ClipVisualConfig(**cfg)
    params = jzoo._on_host(jclip.init_visual_params, jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(5)
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    alpha = rng.randn(2, 32, 32).astype(np.float32)
    jL.set_attention_impl("pallas_interpret")
    try:
        want = jclip.visual_cls(params, jnp.asarray(img), jcfg, alpha=jnp.asarray(alpha))
    finally:
        jL.set_attention_impl("auto")
    monkeypatch.setenv(tL.NOTAP_IMPL_ENV, "pallas")
    got = tclip.visual_cls(tconvert.from_jax_params(jax.tree.map(np.asarray, params)),
                           torch.from_numpy(img), tclip.ClipVisualConfig(**cfg),
                           alpha=torch.from_numpy(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("value", ["auto", "pallas_interpret", "PALLAS", ""])
def test_unknown_switch_value_raises(monkeypatch, value):
    """The JAX package sends every value but "xla" to its kernel; the port
    accepts only "xla" and "pallas"."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(1, 10, 16).astype(np.float32))
    p = tconvert.from_jax_params(_attn_params(rng, 16))
    monkeypatch.setenv(tL.NOTAP_IMPL_ENV, value)
    with pytest.raises(ValueError, match=tL.NOTAP_IMPL_ENV):
        tL.mha(p, x, 2)
    tL.mha(p, x, 2, return_attn=True)  # a tapped block never reads the switch
