"""The port's image transforms against mars_tpu.core.imaging / jax.image."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.core import imaging as jim
from mars_tpu_torch.core import imaging as tim

ATOL = 1e-5


def _img(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("src,dst,method,antialias", [
    (518, 528, "bicubic", True),    # VTA query upsample (vta.py:59)
    (518, 336, "bicubic", True),    # AlphaCLIP image downsample (filtering.py:70)
    (518, 336, "bilinear", False),  # AlphaCLIP alpha masks (filtering.py:86-88)
    (30, 17, "bilinear", True),
    (7, 33, "bilinear", False),     # CLIP pos-embed upsample geometry
])
def test_resize_matches_jax(src, dst, method, antialias):
    x = _img((2, src, src, 3))
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method=method,
                            antialias=antialias)
    got = tim.resize(torch.from_numpy(x), (dst, dst), method, antialias=antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_resize_default_is_jax_default():
    x = _img((1, 40, 40, 3), seed=1)
    want = jim.resize(jnp.asarray(x), (23, 29), "bicubic")
    got = tim.resize(torch.from_numpy(x), (23, 29), "bicubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("src,dst", [(33, 37), (37, 33), (112, 8)])
def test_interpolate_2d_nearest(src, dst):
    x = _img((src, src), seed=2)
    want = jim.interpolate_2d(jnp.asarray(x), (dst, dst), "nearest")
    got = tim.interpolate_2d(torch.from_numpy(x), (dst, dst), "nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("src,dst", [(50, 37), (13, 9)])
def test_resize_mask_nearest(src, dst):
    x = (_img((3, src, src), seed=3) > 0.5).astype(np.float32)
    want = jim.resize_mask(jnp.asarray(x), (dst, dst))
    got = tim.resize_mask(torch.from_numpy(x), (dst, dst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,out", [((2, 518, 518), 37), ((3, 50, 41), 8)])
def test_pools(shape, out):
    x = _img(shape, seed=4)
    for jf, tf in ((jim.adaptive_max_pool, tim.adaptive_max_pool),
                   (jim.adaptive_avg_pool, tim.adaptive_avg_pool)):
        want = jf(jnp.asarray(x), out, out)
        got = tf(torch.from_numpy(x), out, out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    m = (x > 0.97).astype(np.float32)
    np.testing.assert_array_equal(tim.pool_mask_to_grid(torch.from_numpy(m), out).numpy(),
                                  np.asarray(jim.pool_mask_to_grid(jnp.asarray(m), out)))


def test_masked_min_max_scale_and_normalize():
    rng = np.random.RandomState(5)
    x = rng.randn(16).astype(np.float32)
    valid = rng.rand(16) > 0.4
    want = jim.masked_min_max_scale(jnp.asarray(x), jnp.asarray(valid))
    got = tim.masked_min_max_scale(torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    img = _img((4, 5, 3), seed=6)
    np.testing.assert_allclose(
        tim.normalize(torch.from_numpy(img), tim.CLIP_MEAN, tim.CLIP_STD).numpy(),
        np.asarray(jim.normalize(jnp.asarray(img), jim.CLIP_MEAN, jim.CLIP_STD)),
        atol=ATOL, rtol=0)
