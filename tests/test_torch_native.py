"""The port's exact host solvers (``mars_tpu_torch.native``) against the
JAX package's (``mars_tpu.native``), scipy, and the port's approximate
device functions they are the oracles of: Sinkhorn EMD and the auction
(its plain version here)."""
import os

import numpy as np
import pytest
import torch

from mars_tpu import native as jnative
from mars_tpu.ops import emd as jemd
from mars_tpu_torch import native
from mars_tpu_torch.ops import assignment, emd

EMD_TOL = 1e-12  # two builds of one double-precision algorithm
SINKHORN_TOL = 5e-3  # tests/test_native.py's limit for the device EMD


def _emd_instance(seed, t, c):
    return np.random.RandomState(seed).rand(t, c)


@pytest.mark.parametrize("seed,t,c", [(0, 8, 5), (1, 12, 12), (2, 5, 20), (3, 30, 17)])
def test_emd_exact_matches_jax_native_and_lp(seed, t, c):
    cost = _emd_instance(seed, t, c)
    got = native.emd_exact(cost)
    assert abs(got - jnative.emd_exact(cost)) < EMD_TOL
    assert abs(got - jemd.exact_emd_lp(cost.astype(np.float32))) < 1e-6


def test_emd_exact_large_instance_and_tensor_input():
    cost = _emd_instance(4, 200, 120)
    got = native.emd_exact(cost)
    assert 0 <= got <= 1 and abs(got - jnative.emd_exact(cost)) < EMD_TOL
    assert native.emd_exact(torch.from_numpy(cost)) == got


@pytest.mark.parametrize("seed,t,n", [(0, 10, 10), (1, 15, 40), (2, 60, 80)])
def test_assignment_exact_matches_jax_native_and_scipy(seed, t, n):
    from scipy.optimize import linear_sum_assignment

    s = np.random.RandomState(seed).rand(t, n)
    cols = native.assignment_exact(s)
    assert cols.dtype == np.int32 and len(set(cols.tolist())) == t
    total = s[np.arange(t), cols].sum()
    want = jnative.assignment_exact(s)
    np.testing.assert_allclose(total, s[np.arange(t), want].sum(), rtol=1e-12)
    ri, ci = linear_sum_assignment(s, maximize=True)
    np.testing.assert_allclose(total, s[ri, ci].sum(), rtol=1e-12)


def test_degenerate_inputs_and_guards():
    assert native.emd_exact(np.zeros((0, 5))) == 0.0
    assert native.emd_exact(np.zeros((5, 0))) == 0.0
    with pytest.raises(ValueError, match="t <= n"):
        native.assignment_exact(np.zeros((5, 3)))  # tall
    assert native.assignment_exact(np.zeros((0, 4))).shape == (0,)
    # a single row takes its best column; a constant matrix any permutation
    np.testing.assert_array_equal(native.assignment_exact(np.array([[0.1, 0.9, 0.3]])), [1])
    cols = native.assignment_exact(np.ones((4, 4)))
    assert sorted(cols.tolist()) == [0, 1, 2, 3]
    assert native.emd_exact(np.full((3, 7), 0.25)) == pytest.approx(0.25, abs=EMD_TOL)


def test_library_is_built_from_the_port_source():
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(path)) == "_build"
    native.get_lib()
    assert os.path.exists(path)
    with open(os.path.join(os.path.dirname(native.__file__), "exact_solvers.cpp")) as f:
        src = f.read()
    assert "emd_uniform" in src and "lsa_maximize" in src and "rle_" not in src


def test_sinkhorn_emd_within_limit_of_exact():
    """tests/test_native.py's device check, on the port's ``batched_emd``."""
    cost = (np.random.RandomState(5).rand(60, 40) * 0.5).astype(np.float32)
    exact = native.emd_exact(cost)
    approx = float(emd.batched_emd(torch.from_numpy(cost), torch.ones(60, dtype=torch.bool),
                                   torch.ones((1, 40), dtype=torch.bool), row_bucket=64,
                                   col_bucket=64)[0])
    assert abs(approx - exact) < SINKHORN_TOL, (approx, exact)


@pytest.mark.parametrize("seed,t,n", [(0, 10, 10), (1, 15, 40), (2, 60, 80)])
def test_auction_within_tolerance_of_exact_optimum(seed, t, n):
    """tests/test_ops.py's bound (optimum - 1e-3 t), on the port's auction
    (its plain version: the scores lie on the CPU)."""
    s = np.random.RandomState(seed).rand(t, n).astype(np.float32)
    cols = assignment.auction_assignment(torch.from_numpy(s),
                                         torch.ones(t, dtype=torch.bool)).numpy()
    assert len(set(cols.tolist())) == t and (cols >= 0).all()
    got = s[np.arange(t), cols].astype(np.float64).sum()
    best = native.assignment_exact(s)
    opt = s[np.arange(t), best].astype(np.float64).sum()
    assert got >= opt - 1e-3 * t, (got, opt)
