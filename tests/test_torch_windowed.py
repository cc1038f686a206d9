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
