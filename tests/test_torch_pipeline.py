"""The port's components, PIR, EMD and score/merge against mars_tpu."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import components as jcomp
from mars_tpu.ops import emd as jemd
from mars_tpu.pipeline import filtering as jfilt
from mars_tpu.pipeline import pir as jpir
from mars_tpu_torch.ops import components as tcomp
from mars_tpu_torch.ops import emd as temd
from mars_tpu_torch.pipeline import filtering as tfilt
from mars_tpu_torch.pipeline import pir as tpir

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _blobs(g, seed, density=0.35):
    """A grid with several 8-connected components, including snakes that
    need many propagation rounds."""
    rng = np.random.RandomState(seed)
    fg = rng.rand(g, g) < density
    fg[g // 2, 1:-1] = True
    fg[1:-1:2, g - 3] = True
    return fg


@pytest.mark.parametrize("g,seed", [(33, 0), (37, 1), (37, 2), (8, 3)])
def test_components_bit_exact(g, seed):
    fg = _blobs(g, seed)
    np.testing.assert_array_equal(
        tcomp.label_components(torch.from_numpy(fg)).numpy(),
        np.asarray(jcomp.label_components(jnp.asarray(fg))))
    np.testing.assert_array_equal(
        tcomp.component_boxes_union(torch.from_numpy(fg)).numpy(),
        np.asarray(jcomp.component_boxes_union(jnp.asarray(fg))))
    prior = np.random.RandomState(seed).rand(g, g).astype(np.float32)
    for thr in (0.4, 0.8):
        np.testing.assert_array_equal(
            tcomp.threshold_prior(torch.from_numpy(prior), thr).numpy(),
            np.asarray(jcomp.threshold_prior(jnp.asarray(prior), thr)))


@pytest.mark.parametrize("thr", [0.4, 0.8])  # the fixture was made at 0.4
def test_pir_refine_matches_fixture_and_jax(thr):
    d = np.load(os.path.join(FIXTURES, "pir_tiny.npz"))
    got = tpir.refine(torch.from_numpy(d["prior"]), torch.from_numpy(d["attn_mean"]), thr)
    want = jpir.refine(jnp.asarray(d["prior"]), jnp.asarray(d["attn_mean"]), thr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if thr == 0.4:
        np.testing.assert_allclose(got.numpy(), d["refined"], atol=1e-4, rtol=1e-3)


def _emd_case(r, l, p, n_rows, valid_idx, seed):
    rng = np.random.RandomState(seed)
    cost = rng.rand(r, l).astype(np.float32)
    row_mask = np.zeros(r, bool)
    row_mask[rng.choice(r, n_rows, replace=False)] = True
    col_valid = np.zeros(p, bool)
    col_valid[valid_idx] = True
    col_masks = (rng.rand(p, l) < 0.2) & col_valid[:, None]
    col_masks[valid_idx[0]] = False  # a live proposal with an empty footprint
    return cost, row_mask, col_masks, col_valid


@pytest.mark.parametrize("n_rows", [100, 300, 700])  # row ladder: 256, 512, 1024
def test_batched_emd_matches_jax(n_rows):
    # 5 scattered live proposals in a 32 bucket: one live chunk, one dead
    cost, row_mask, col_masks, col_valid = _emd_case(800, 48, 32, n_rows,
                                                     [1, 4, 9, 20, 30], seed=n_rows)
    want = jemd.batched_emd(jnp.asarray(cost), jnp.asarray(row_mask), jnp.asarray(col_masks),
                            1024, 64, col_valid=jnp.asarray(col_valid))
    got = temd.batched_emd(torch.from_numpy(cost), torch.from_numpy(row_mask),
                           torch.from_numpy(col_masks), 1024, 64,
                           col_valid=torch.from_numpy(col_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert np.all(got.numpy()[~col_valid] == 0) and got.numpy()[1] == 0


def test_batched_emd_without_chunking_matches_jax():
    cost, row_mask, col_masks, _ = _emd_case(64, 30, 6, 20, [0, 1, 2, 3, 4, 5], seed=7)
    want = jemd.batched_emd(jnp.asarray(cost), jnp.asarray(row_mask), jnp.asarray(col_masks),
                            128, 64)
    got = temd.batched_emd(torch.from_numpy(cost), torch.from_numpy(row_mask),
                           torch.from_numpy(col_masks), 128, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_score_and_merge_core_matches_jax(seed):
    rng = np.random.RandomState(seed)
    p, size, g = 16, 56, 8
    masks = np.zeros((p, size, size), np.float32)
    for i in range(p):
        y, x = rng.randint(0, size - 12, 2)
        masks[i, y:y + rng.randint(6, 30), x:x + rng.randint(6, 30)] = 1
    valid = np.arange(p) < 7
    support_fg = rng.rand(2 * g * g) < 0.3
    cost = rng.rand(2 * g * g, g * g).astype(np.float32)
    vva, vta = rng.rand(g, g).astype(np.float32), rng.rand(g, g).astype(np.float32)
    ac = rng.randn(p).astype(np.float32)
    jcfg = jfilt.FilterMergeConfig(grid=g, emd_row_bucket=128, emd_col_bucket=64)
    tcfg = tfilt.FilterMergeConfig(grid=g, emd_row_bucket=128, emd_col_bucket=64)
    want_m, want_s = jfilt.score_and_merge_core(*map(jnp.asarray, (
        masks, valid, support_fg, cost, vva, vta, ac)), jcfg)
    got_m, got_s = tfilt.score_and_merge_core(*map(torch.from_numpy, (
        masks, valid, support_fg, cost, vva, vta, ac)), tcfg)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4, rtol=0)
