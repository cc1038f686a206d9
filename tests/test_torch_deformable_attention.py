"""The port's multi-scale deformable attention (``ops/deformable_attention``)
against ``mars_tpu.ops.deformable_attention`` on the same seeded inputs and
weights: ``msda_core`` with locations straddling the borders (zero
padding), ``msda_layer`` with a batched and a shared (batch-1) memory, point
and box references.  Tolerance: 3e-5 absolute, 1e-4 relative (float32),
the JAX package's oracle tolerance for these layers."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import deformable_attention as jda
from mars_tpu_torch.models import convert as tconvert
from mars_tpu_torch.ops import deformable_attention as tda

ATOL, RTOL = 3e-5, 1e-4
SHAPES = ((6, 8), (3, 4), (2, 2))  # res5-like levels of odd sizes, flattened in this order


def _params(c, nh, npnt, seed):
    """Seeded numpy MSDA weights in the JAX package's tree (kernels at
    1/sqrt(c): offsets of a few cells)."""
    rng = np.random.RandomState(seed)
    return {name: {"kernel": (rng.randn(*leaf["kernel"]) / np.sqrt(c)).astype(np.float32),
                   "bias": (0.1 * rng.randn(*leaf["bias"])).astype(np.float32)}
            for name, leaf in tda.msda_param_shapes(c, nh, len(SHAPES), npnt).items()}


def _port(tree):
    return tconvert.from_jax_params(tree)


@pytest.mark.parametrize("b,q,nh,p", [(2, 5, 2, 4), (1, 33, 4, 2)])
def test_msda_core_equals_jax(b, q, nh, p):
    rng = np.random.RandomState(b * 10 + q)
    d = 8
    l = sum(h * w for h, w in SHAPES)
    value = rng.randn(b, l, nh, d).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, (b, q, nh, len(SHAPES), p, 2)).astype(np.float32)
    wts = rng.rand(b, q, nh, len(SHAPES), p).astype(np.float32)
    wts /= wts.sum(axis=(-2, -1), keepdims=True)
    want = np.asarray(jax.jit(jda.msda_core, static_argnums=1)(
        jnp.asarray(value), SHAPES, jnp.asarray(locs), jnp.asarray(wts)))
    got = tda.msda_core(torch.from_numpy(value), SHAPES, torch.from_numpy(locs),
                        torch.from_numpy(wts))
    assert got.shape == (b, q, nh * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("memory", ["batched", "shared"])
@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msda_layer_equals_jax(memory, ref_dim):
    """A shared memory folds the query batch into the gather's query axis
    (mars_tpu/ops/deformable_attention.py:126-130)."""
    c, nh, npnt, b, q = 32, 4, 2, 3, 7
    l = sum(h * w for h, w in SHAPES)
    params = _params(c, nh, npnt, ref_dim)
    rng = np.random.RandomState(ref_dim + (memory == "shared"))
    query = rng.randn(b, q, c).astype(np.float32)
    value = rng.randn(1 if memory == "shared" else b, l, c).astype(np.float32)
    refs = rng.rand(b, q, len(SHAPES), 2).astype(np.float32)
    if ref_dim == 4:
        refs = np.concatenate([refs, rng.uniform(0.1, 0.5, refs.shape).astype(np.float32)], -1)
    layer = jax.jit(partial(jda.msda_layer, spatial_shapes=SHAPES, num_heads=nh,
                            num_points=npnt))
    want = np.asarray(layer(jax.tree.map(jnp.asarray, params), jnp.asarray(query),
                            jnp.asarray(refs), jnp.asarray(value)))
    got = tda.msda_layer(_port(params), torch.from_numpy(query), torch.from_numpy(refs),
                         torch.from_numpy(value), SHAPES, nh, npnt)
    assert got.shape == (b, q, c)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_shared_memory_fold_equals_broadcast():
    """The fold computes what a per-query-batch copy of the memory does."""
    c, nh, npnt, b, q = 16, 2, 4, 5, 3
    l = sum(h * w for h, w in SHAPES)
    params = _port(_params(c, nh, npnt, 7))
    g = torch.Generator().manual_seed(7)
    query = torch.randn(b, q, c, generator=g)
    value = torch.randn(1, l, c, generator=g)
    refs = torch.rand(b, q, len(SHAPES), 2, generator=g)
    shared = tda.msda_layer(params, query, refs, value, SHAPES, nh, npnt)
    copied = tda.msda_layer(params, query, refs, value.expand(b, l, c), SHAPES, nh, npnt)
    torch.testing.assert_close(shared, copied, atol=1e-6, rtol=1e-5)


def test_msda_layer_bf16_runs_in_the_query_type():
    c, nh, npnt = 16, 2, 2
    l = sum(h * w for h, w in SHAPES)
    params = _port(_params(c, nh, npnt, 3))
    g = torch.Generator().manual_seed(3)
    query, value = torch.randn(4, 6, c, generator=g), torch.randn(1, l, c, generator=g)
    refs = torch.rand(4, 6, len(SHAPES), 2, generator=g)
    f32 = tda.msda_layer(params, query, refs, value, SHAPES, nh, npnt)
    bf = {k: {n: t.bfloat16() for n, t in v.items()} for k, v in params.items()}
    got = tda.msda_layer(bf, query.bfloat16(), refs, value.bfloat16(), SHAPES, nh, npnt)
    assert got.dtype == torch.bfloat16
    assert float((got.float() - f32).abs().max()) < 0.05 * float(f32.abs().max())
