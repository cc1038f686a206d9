"""The port's auction assignment and NMS against mars_tpu: bit-exact.

The port's plain auction phase is held EQUAL to the JAX package's XLA path
(``use_kernel=False``); ``tests/test_ops.py`` already holds that path equal
to the Pallas kernel in interpret mode.  The CUDA kernel is held equal to
the plain phase on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import assignment as jasg, nms as jnms
from mars_tpu_torch.ops import assignment as tasg, nms as tnms


def _instance(seed, t, n):
    rng = np.random.RandomState(seed)
    if seed == 3:
        s = rng.randint(0, 4, (t, n)).astype(np.float32) / 4.0
    else:
        s = rng.rand(t, n).astype(np.float32)
    valid = rng.rand(t) < (0.3 if t != n else 1.1)
    if not valid.any():
        valid[0] = True
    return s, valid


@pytest.mark.parametrize("seed,t,n,phases", [
    (0, 200, 300, 1),    # rectangular, sparse valid
    (2, 96, 96, 1),      # square, dense valid
    (3, 150, 150, 1),    # near-tie degenerate values (long wars)
    (5, 120, 120, 5),    # ε-scaled
    (6, 3, 700, 1),      # tiny T, wide N
])
def test_auction_equals_jax_xla_path(seed, t, n, phases):
    s, valid = _instance(seed, t, n)
    want = np.asarray(jasg.auction_assignment(jnp.asarray(s), jnp.asarray(valid),
                                              n_phases=phases, use_kernel=False))
    got = tasg.auction_assignment(torch.from_numpy(s), torch.from_numpy(valid),
                                  n_phases=phases)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("small_k", [None, 16])
def test_row_chunk_compaction_equals_jax(small_k):
    """Sparse valid rows compacted to the front (the matching auctions'
    ``row_chunk=128``), with and without the small-bidder gather."""
    s, valid = _instance(0, 300, 320)
    want = np.asarray(jasg.auction_assignment(jnp.asarray(s), jnp.asarray(valid),
                                              row_chunk=128, small_k=small_k,
                                              use_kernel=False))
    stats = []
    got = tasg.auction_assignment(torch.from_numpy(s), torch.from_numpy(valid),
                                  row_chunk=128, small_k=small_k, stats=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    dense, small, dense_rows, small_rows = stats[0]
    assert dense + small > 0 and dense_rows + small_rows >= int(valid.sum())
    assert small == 0 if small_k is None else small > 0


def test_unconverged_rows_take_the_greedy_fixup():
    s, valid = _instance(3, 150, 150)
    want = np.asarray(jasg.auction_assignment(jnp.asarray(s), jnp.asarray(valid),
                                              max_rounds=8, use_kernel=False, unroll=1))
    got = tasg.auction_assignment(torch.from_numpy(s), torch.from_numpy(valid), max_rounds=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(got.numpy())) == 150


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_equals_jax(seed):
    rng = np.random.RandomState(seed)
    n = 40
    xy = rng.randint(0, 50, (n, 2))
    wh = rng.randint(0, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[5] = boxes[6]  # an exact duplicate
    boxes[7] = 0.0       # an empty mask's box
    scores = rng.rand(n).astype(np.float32)
    scores[10] = scores[11]  # a score tie
    valid = rng.rand(n) < 0.8
    want = np.asarray(jnms.nms_keep(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), 0.5))
    got = tnms.nms_keep(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
