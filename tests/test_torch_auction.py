"""The auction kernel's rounds (``mars_tpu_torch/csrc/auction.cu``),
emulated on the CPU, against the port's plain phase and the JAX package:
bit-exact.

The CUDA kernel runs only on the card, where ``tests/test_torch_cuda.py``
holds it equal to the plain phase.  ``emulated_phase`` repeats here what
the kernel does and in its order: a warp a bidder row, the row split into
the cluster's 8 column slices in a small round, each lane's columns (lo +
lane, lo + lane + 32, ...) in batches of loads and its branch-free compare
chain, the warp's merge by integer reductions and the slices' merge, the
columns' (bid, row) maxima, the winners' pass, and the bidder list kept
from round to round instead of a rescan (built in the same order in every
CTA; a seeded shuffle shows that the order does not matter).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import assignment as jasg
from mars_tpu_torch.ops import assignment as tasg

WARP = 32
WARPS = 16  # csrc/auction.cu: 512 threads; up to 16 bidders, a small round
UNROLL = 43  # csrc/auction.cu: a lane's loads in one batch, a whole row
CLUSTER = 8  # csrc/auction.cu: a small round's columns in 8 slices, one a CTA
SLICE_UNROLL = -(-UNROLL // CLUSTER)
NEG = np.float32(tasg.NEG)
INT_MAX = np.iinfo(np.int32).max
# the first round's bidders: one and two, 16 and 17 (the sliced small round
# and the dense one), 31 to 33 (a warp's width, ragged over the 8 CTAs)
BOUNDARY_BIDDERS = (1, 2, 16, 17, 31, 32, 33)


def _lane_top2(values, lo, hi, unroll, drop_subset):
    """(nb, N) values → each lane's (m1, m2, j) over columns [lo, hi),
    (nb, 32): lane l's chain over columns lo + l, lo + l + 32, ... in
    increasing order, a batch of ``unroll`` columns at a time, as the kernel
    runs it: the first column at the max (strict >) and
    m2 = max(m2, min(val, m1))."""
    nb = values.shape[0]
    c = -(-(hi - lo) // (WARP * unroll)) * unroll
    v = np.full((nb, c * WARP), -np.inf, np.float32)  # past hi: -inf, no effect on the chain
    v[:, :hi - lo] = values[:, lo:hi]
    v = v.reshape(nb, c, WARP)
    m1 = np.full((nb, WARP), -np.inf, np.float32)
    m2 = np.full((nb, WARP), NEG, np.float32)
    j = np.full((nb, WARP), INT_MAX, np.int64)
    lanes = np.arange(WARP)
    for batch in range(0, c, unroll):
        ju = np.full((nb, WARP), -1, np.int64)
        for u in range(unroll):
            x = v[:, batch + u, :]
            ju = np.where(x > m1, u, ju)
            m2 = np.maximum(m2, np.minimum(x, m1))
            m1 = np.maximum(m1, x)
        j = np.where(ju >= 0, lo + (batch + ju) * WARP + lanes, j)
    if drop_subset:  # a fault: lane 1's columns never reach the merge
        m1[:, 1], m2[:, 1], j[:, 1] = -np.inf, NEG, INT_MAX
    return m1, m2, j


def _enc(x):
    """float32 → int32 with the same order (the kernel's ``enc``)."""
    b = np.asarray(x, np.float32).view(np.int32)
    return np.where(b >= 0, b, b ^ 0x7FFFFFFF)


def _dec(e):
    return np.where(e >= 0, e, e ^ 0x7FFFFFFF).astype(np.int32).view(np.float32)


def _warp_merge(m1, m2, j):
    """The lanes' (m1, m2, j), (nb, 32), merged as the kernel's
    ``warp_merge`` does by integer reductions (``__reduce_max_sync`` /
    ``__reduce_min_sync`` over the order-preserving encoding): the max, the
    smallest first column among the lanes holding it, and the max of the
    holder's m2 and the others' m1, or the max itself when two lanes hold
    it → (j, m1, m2), (nb,)."""
    e1 = _enc(m1)
    top1 = e1.max(axis=1, keepdims=True)
    top = e1 == top1
    ties = top.sum(axis=1)
    top2 = np.where(top, _enc(m2), e1).max(axis=1)
    j = np.where(top, j, INT_MAX).min(axis=1)
    m1 = _dec(top1[:, 0])
    return j, m1, np.where(ties > 1, m1, _dec(top2))


def _bidder_top2(values, drop_subset=False):
    """Each bidder's (j, m1, m2).  Above 16 bidders a warp takes a whole
    row; up to 16 each of the cluster's 8 CTAs takes a slice of whole warps
    of columns, and the bidder's lane of the finishing warp merges the 8
    slices' partials as a tree (the other side holds the first max when its
    m1 is larger, or equal at a smaller column)."""
    nb, n = values.shape
    if nb > WARPS:
        return _warp_merge(*_lane_top2(values, 0, n, UNROLL, drop_subset))
    width = WARP * -(-n // (WARP * CLUSTER))
    parts = []
    for k in range(CLUSTER):
        lo, hi = min(n, k * width), min(n, k * width + width)
        parts.append(_warp_merge(*_lane_top2(values, lo, hi, SLICE_UNROLL, drop_subset)))
    step = 1
    while step < CLUSTER:  # the finishing lane merges the slices as a tree
        for k in range(0, CLUSTER, 2 * step):
            (j, m1, m2), (jo, m1o, m2o) = parts[k], parts[k + step]
            take = (m1o > m1) | ((m1o == m1) & (jo < j))
            parts[k] = (np.where(take, jo, j), np.where(take, m1o, m1),
                        np.where(take, np.maximum(m2o, m1), np.maximum(m2, m1o)))
        step *= 2
    return parts[0]


def emulated_phase(scores, row_valid, prices, eps, max_rounds, small_k=tasg.SMALL_K, *,
                   seed=0, drop_subset=False, ties_to_smaller=False, trace=None):
    """One ε-phase as ``csrc/auction.cu`` runs it → the returns of
    ``_auction_phase_plain``.  ``drop_subset`` and ``ties_to_smaller`` are
    faults for the negative checks; ``trace`` receives each round's bidder
    count."""
    s, valid = scores.numpy(), row_valid.numpy()
    price = prices.numpy().copy()
    t, n = s.shape
    eps = np.float32(eps)
    rng = np.random.RandomState(seed)
    col_of_row = np.full((t,), -1, np.int32)
    owner = np.full((n,), -1, np.int64)
    counts = [0, 0, 0, 0]
    bidders = np.flatnonzero(valid)  # the first round's list: the valid rows, scanned once
    rng.shuffle(bidders)
    for _ in range(max_rounds):
        nb = len(bidders)
        if nb == 0:
            break
        # the kept list holds what a rescan would find
        np.testing.assert_array_equal(np.sort(bidders), np.flatnonzero(valid & (col_of_row < 0)))
        small = small_k is not None and nb <= small_k
        counts[int(small)] += 1
        counts[2 + int(small)] += nb
        if trace is not None:
            trace.append(nb)
        j, m1, m2 = _bidder_top2(s[bidders] - price[None, :], drop_subset)
        bid = (price[j] + (m1 - m2)) + eps
        # each column's 64-bit key: the highest bid (-0 as +0), ties to the largest row
        best = {}
        for r, jj, b in zip(bidders.tolist(), j.tolist(), bid):
            k = (b + np.float32(0.0), -r if ties_to_smaller else r)
            if jj not in best or k > best[jj]:
                best[jj] = k
        nxt = []
        for r, jj in zip(bidders.tolist(), j.tolist()):
            b, w = best[jj]
            if b > NEG / 2 and abs(w) == r:
                old = owner[jj]
                if old >= 0:
                    col_of_row[old] = -1
                    nxt.append(old)
                owner[jj] = r
                col_of_row[r] = jj
                price[jj] = b
            else:
                nxt.append(r)
        bidders = np.asarray(nxt, np.int64)
        rng.shuffle(bidders)  # the append order of a shared atomic
    return torch.from_numpy(col_of_row), torch.from_numpy(price), tuple(counts)


def _test_ops_instance(seed, t, n):
    """tests/test_ops.py's auction instances (seed 3: quantized, tie-heavy)."""
    rng = np.random.RandomState(seed)
    if seed == 3:
        s = rng.randint(0, 4, (t, n)).astype(np.float32) / 4.0
    else:
        s = rng.rand(t, n).astype(np.float32)
    valid = rng.rand(t) < (0.3 if t != n else 1.1)
    if not valid.any():
        valid[0] = True
    return s, valid


def _matching_like(seed=1, valid_rows=100, near_cols=90, noise=0.3, dim=32, size=1369):
    """A 1369² cosine-similarity instance shaped like the matching auctions:
    ~100 valid rows near one feature, as many columns near it as there are
    fewer than valid rows, so the rows war (8 dense rounds, ~3 000 small
    ones on the plain phase)."""
    rng = np.random.RandomState(seed)
    centre = rng.randn(dim)
    fs, fq = rng.randn(size, dim), rng.randn(size, dim)
    rows = rng.choice(size, valid_rows, replace=False)
    fs[rows] = centre + noise * rng.randn(valid_rows, dim)
    near = rng.choice(size, near_cols, replace=False)
    fq[near] = centre + noise * rng.randn(near_cols, dim)
    fs /= np.linalg.norm(fs, axis=1, keepdims=True)
    fq /= np.linalg.norm(fq, axis=1, keepdims=True)
    valid = np.zeros((size,), bool)
    valid[rows] = True
    return (fs @ fq.T).astype(np.float32), valid


def _boundary(nb):
    """48 × 64 quantized scores with exactly ``nb`` valid rows: the first
    round has nb bidders, and the wars walk down through the smaller
    group sizes."""
    rng = np.random.RandomState(100 + nb)
    s = rng.randint(0, 4, (48, 64)).astype(np.float32) / 4.0
    valid = np.zeros((48,), bool)
    valid[rng.choice(48, nb, replace=False)] = True
    return s, valid


# (name, scores, valid, phases, row_chunk)
INSTANCES = {f"test_ops_seed{seed}": (*_test_ops_instance(seed, t, n), phases, None)
             for seed, t, n, phases in ((0, 200, 300, 1), (2, 96, 96, 1), (3, 150, 150, 1),
                                        (5, 120, 120, 5), (6, 3, 700, 1))}
INSTANCES["matching_like_1369"] = (*_matching_like(), 1, 128)
INSTANCES.update({f"bidders_{nb}": (*_boundary(nb), 1, None) for nb in BOUNDARY_BIDDERS})
SMALL = [name for name in INSTANCES if name.startswith("bidders_")] + ["test_ops_seed6"]


def _phases(name):
    s, valid, phases, chunk = INSTANCES[name]
    return tasg.phase_inputs(torch.from_numpy(s), torch.from_numpy(valid), phases, chunk)


def _run(phase, scores, valid, eps, **kw):
    prices = torch.zeros((scores.shape[1],), dtype=torch.float32)
    out = []
    for e in eps:
        col, prices, counts = phase(scores, valid, prices, e, 20000, **kw)
        out.append((col, prices, counts))
    return out


@pytest.mark.parametrize("name", list(INSTANCES))
def test_emulation_equals_plain(name):
    """col_of_row, prices and the round counts of every phase, bit for bit."""
    scores, valid, _, eps = _phases(name)
    for (col_e, pr_e, st_e), (col_p, pr_p, st_p) in zip(
            _run(emulated_phase, scores, valid, eps), _run(tasg._auction_phase_plain, scores,
                                                           valid, eps)):
        assert torch.equal(col_e, col_p) and torch.equal(pr_e, pr_p) and st_e == st_p


@pytest.mark.parametrize("name", list(INSTANCES))
def test_emulation_equals_jax_xla_path(name, monkeypatch):
    """Each phase's assignment and prices against ``_auction_phase`` (JAX's
    XLA path), and the whole ``auction_assignment`` with the emulation as
    its phase against ``auction_assignment(use_kernel=False)``."""
    s, valid, phases, chunk = INSTANCES[name]
    scores, valid_t, _, eps = _phases(name)
    prices = jnp.zeros((s.shape[1],), jnp.float32)
    for e, (col_e, pr_e, _) in zip(eps, _run(emulated_phase, scores, valid_t, eps)):
        col_j, prices = jasg._auction_phase(jnp.asarray(scores.numpy()),
                                            jnp.asarray(valid_t.numpy()), prices, e, 20000)
        np.testing.assert_array_equal(col_e.numpy(), np.asarray(col_j))
        np.testing.assert_array_equal(pr_e.numpy(), np.asarray(prices))
    want = np.asarray(jasg.auction_assignment(jnp.asarray(s), jnp.asarray(valid),
                                              n_phases=phases, row_chunk=chunk,
                                              use_kernel=False))
    monkeypatch.setattr(tasg, "_auction_phase_plain", emulated_phase)
    got = tasg.auction_assignment(torch.from_numpy(s), torch.from_numpy(valid), n_phases=phases,
                                  row_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", SMALL)
def test_emulation_equals_pallas_interpret(name):
    """Each phase against the Pallas kernel in interpret mode."""
    scores, valid, _, eps = _phases(name)
    prices = jnp.zeros((scores.shape[1],), jnp.float32)
    for e, (col_e, pr_e, _) in zip(eps, _run(emulated_phase, scores, valid, eps)):
        col_k, prices = jasg._auction_phase_pallas(
            jnp.asarray(scores.numpy()), jnp.asarray(valid.numpy()), prices, e, 20000,
            interpret=True)
        np.testing.assert_array_equal(col_e.numpy(), np.asarray(col_k))
        np.testing.assert_array_equal(pr_e.numpy(), np.asarray(prices))


def test_instances_cross_the_kernels_steps():
    """The nb-boundary instances open at each step named in
    ``BOUNDARY_BIDDERS`` and, with the others, take the kernel's rounds
    through both paths: the sliced small rounds (nb <= 16), dense rounds
    of at most a row a warp (8 CTAs x 16 warps) and denser ones."""
    firsts, paths = [], set()
    for name in INSTANCES:
        if name == "matching_like_1369":
            continue
        scores, valid, _, eps = _phases(name)
        trace = []
        _run(emulated_phase, scores, valid, eps, trace=trace)
        if name.startswith("bidders_"):
            firsts.append(trace[0])
        paths.update("sliced" if nb <= WARPS else "a row a warp" if nb <= CLUSTER * WARPS
                     else "rows a warp" for nb in trace)
    assert firsts == list(BOUNDARY_BIDDERS)
    assert paths == {"sliced", "a row a warp", "rows a warp"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bidder_order_is_free(seed):
    """Another append order of the kept list gives the same phase, bit for
    bit."""
    scores, valid, _, eps = _phases("test_ops_seed3")
    want = _run(emulated_phase, scores, valid, eps)
    got = _run(emulated_phase, scores, valid, eps, seed=seed + 1)
    for (col_w, pr_w, st_w), (col_g, pr_g, st_g) in zip(want, got):
        assert torch.equal(col_w, col_g) and torch.equal(pr_w, pr_g) and st_w == st_g


@pytest.mark.parametrize("name,fault", [("test_ops_seed0", "drop_subset"),
                                        ("bidders_16", "drop_subset"),
                                        ("test_ops_seed3", "ties_to_smaller"),
                                        ("bidders_33", "ties_to_smaller")])
def test_emulation_fault_differs_from_plain(name, fault):
    """Negative checks: the comparison sees a dropped column subset and a
    column tie broken to the smaller row."""
    scores, valid, _, eps = _phases(name)
    got = _run(emulated_phase, scores, valid, eps, **{fault: True})
    want = _run(tasg._auction_phase_plain, scores, valid, eps)
    assert any(not (torch.equal(cg, cw) and torch.equal(pg, pw))
               for (cg, pg, _), (cw, pw, _) in zip(got, want))


def test_kernel_wrapper_shared_memory_bound():
    """The wrapper refuses what the kernel's shared memory cannot hold
    (16 (T + N) bytes and ``EXTRA_BYTES`` in the source)
    before it builds anything."""
    limit = (tasg._MAX_SHARED - tasg._EXTRA_SHARED) // 16
    with open(tasg.build.CSRC_DIR + "/auction.cu") as f:
        source = f.read()
    for line in ("constexpr int CLUSTER = 8;", "constexpr int THREADS = 512;",
                 "constexpr int PART_BYTES = 2 * WARPS * CLUSTER * (int)sizeof(Part) + 16;",
                 "constexpr int EXTRA_BYTES = PART_BYTES + 4 * (WARPS + 2);"):
        assert line in source
    assert tasg._EXTRA_SHARED == 2 * 16 * 8 * 16 + 16 + 4 * (16 + 2)
    with pytest.raises(ValueError, match=f"T \\+ N <= {limit}"):
        tasg._auction_phase_kernel(torch.zeros((1, limit)), torch.ones((1,), dtype=torch.bool),
                                   torch.zeros((limit,)), 1e-3, 10)
