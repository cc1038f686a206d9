"""Negative priors, the box prompt and the cascade mask input of the port's
Matcher against mars_tpu's on the same seeded inputs, in both of mars_tpu's
program flows (the port runs one, the union of both prompt families).

The noise is JAX's own: ``co_sample_negatives`` splits its key into one key
per prompt set, draws ``gumbel(k, (L,))`` for the draw without replacement
and ``jax.random.categorical(k, logits, shape=(K,))``, which in jax 0.9.0
(``replace=True``, ``mode=None``) is ``argmax(gumbel(k, (K, L)) + logits)``,
for the draw with replacement: the port's ``neg_gumbel`` and
``neg_cat_gumbel`` rows are those two draws of the same row key.
Tolerance: everything compared here is bitwise equal (points, validity,
masks, buckets, merged masks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import dinov2 as jdino, sam as jsam
from mars_tpu.pipeline import amg as jamg, matcher as jmatcher
from mars_tpu_torch.models import convert as tconvert, dinov2 as tdino, sam as tsam
from mars_tpu_torch.pipeline import amg as tamg, matcher as tmatcher

DINO = dict(patch_size=14, embed_dim=32, depth=2, num_heads=2, num_register_tokens=4,
            pos_embed_grid=4)
SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=2,
           global_attn_indexes=(1,), window_size=2, out_chans=16, decoder_mlp_dim=32,
           decoder_heads=2)
# tests/test_matcher.py's tiny end-to-end configuration
MATCHER = dict(input_size=56, grid=4, patch_size=14, sample_range=(2, 3),
               max_sample_iterations=2, emd_row_bucket=16, emd_col_bucket=16)
AMG = dict(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0, decode_batch=8)
BOTH_SOURCES = dict(use_negative_priors_from_discarded=True, use_negative_priors_from_cost=True,
                    merge_prompt_types=True)


def neg_noise(key, cfg):
    """(neg_gumbel (B, L), neg_cat_gumbel (B, K, L)) of
    ``mars_tpu.pipeline.matcher.co_sample_negatives(key, ...)``."""
    b, k, l = len(jmatcher.prompt_set_sizes(cfg)), cfg.sample_range[1], cfg.grid ** 2
    keys = jax.random.split(key, b)
    g = np.stack([np.asarray(jax.random.gumbel(kk, (l,))) for kk in keys])
    cat = np.stack([np.asarray(jax.random.gumbel(kk, (k, l))) for kk in keys])
    return torch.from_numpy(g), torch.from_numpy(cat)


def _similarity(seed, r, l):
    rng = np.random.RandomState(seed)
    feats = rng.randn(r + l, 16).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    s_mat = feats[:r] @ feats[r:].T
    fg = np.zeros(r, bool)
    fg[rng.choice(r, r // 3, replace=False)] = True
    return s_mat, fg


# square (one shot), wide, and tall
# (multi-shot: R = 2 L, the forward cost auction on the transpose)
SHAPES = [(0, 64, 64), (1, 48, 64), (2, 128, 64)]


@pytest.mark.parametrize("seed,r,l", SHAPES)
def test_negative_points_equal_jax(seed, r, l):
    s_mat, fg = _similarity(seed, r, l)
    cost = (1.0 - s_mat) / 2.0
    kw = dict(input_size=64, grid=8, patch_size=8)
    jcfg, tcfg = jmatcher.MatcherConfig(**kw), tmatcher.MatcherConfig(**kw)
    st, tfg = torch.from_numpy(s_mat), torch.from_numpy(fg)
    for name, jfn, tfn, m in (("discarded", jmatcher.negative_points_from_discarded,
                               tmatcher.negative_points_from_discarded, s_mat),
                              ("cost", jmatcher.negative_points_from_cost,
                               tmatcher.negative_points_from_cost, cost)):
        jp, jk = map(np.asarray, jfn(jnp.asarray(m), jnp.asarray(fg), jcfg))
        tp, tk = tfn(torch.from_numpy(m), tfg, tcfg)
        np.testing.assert_array_equal(tp.numpy(), jp, err_msg=name)
        np.testing.assert_array_equal(tk.numpy(), jk, err_msg=name)
        assert jk.any(), name
    # the positives' match, reused: the same negatives
    match = tmatcher.bidirectional_match(st, tfg)
    np.testing.assert_array_equal(
        tmatcher.negative_points_from_discarded(st, tfg, tcfg, match)[1].numpy(),
        tmatcher.negative_points_from_discarded(st, tfg, tcfg)[1].numpy())


def test_cost_auction_phases():
    """The forward cost auction runs 5 ε-phases, on the transpose when tall;
    the reverse one of mars_tpu's source, whose result reaches no output
    (its compiled program drops it), is not run."""
    from mars_tpu_torch.ops import assignment

    seen = []
    real = assignment.auction_assignment

    def spy(scores, row_valid, *a, n_phases=1, **k):
        seen.append((tuple(scores.shape), n_phases))
        return real(scores, row_valid, *a, n_phases=n_phases, **k)

    cfg = tmatcher.MatcherConfig(input_size=64, grid=8, patch_size=8)
    assignment.auction_assignment = spy
    try:
        for seed, r, l in (SHAPES[0], SHAPES[2]):
            s_mat, fg = _similarity(seed, r, l)
            tmatcher.negative_points_from_cost(torch.from_numpy((1.0 - s_mat) / 2.0),
                                               torch.from_numpy(fg), cfg)
    finally:
        assignment.auction_assignment = real
    assert seen == [((64, 64), 5), ((64, 128), 5)]


@pytest.mark.parametrize("n_neg", [0, 5, 8, 9, 30])
def test_co_sample_negatives_equal_jax(n_neg):
    kw = dict(input_size=56, grid=8, patch_size=7, sample_range=(4, 6), max_sample_iterations=3)
    jcfg, tcfg = jmatcher.MatcherConfig(**kw), tmatcher.MatcherConfig(**kw)
    rng = np.random.RandomState(n_neg)
    l = 64
    pts = rng.randint(0, 56, (l, 2)).astype(np.float32)
    valid = np.zeros(l, bool)
    valid[rng.choice(l, n_neg, replace=False)] = True
    key = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    b = len(jmatcher.prompt_set_sizes(jcfg))
    jc, jl = map(np.asarray, jmatcher.co_sample_negatives(
        key, jnp.ones((b,), bool), jnp.asarray(pts), jnp.asarray(valid), jcfg))
    g, cat = neg_noise(key, jcfg)
    tc, tl = tmatcher.co_sample_negatives(torch.from_numpy(pts), torch.from_numpy(valid), tcfg,
                                          neg_gumbel=g, neg_cat_gumbel=cat)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tl.numpy(), jl)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_matcher.py's tiny towers and episode, JAX-initialised and
    exported once to the port."""
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(0), 5)
    dcfg, scfg = jdino.DinoV2Config(**DINO), jsam.SamConfig(**SAM)
    jdp = jdino.init_params(k1, dcfg)
    jsp = {"encoder": jsam.init_encoder_params(k2, scfg),
           "prompt_encoder": jsam.init_prompt_encoder_params(k3, scfg),
           "decoder": jsam.init_decoder_params(k4, scfg)}
    sup = np.asarray(jax.random.uniform(k5, (1, 56, 56, 3)))
    qry = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (56, 56, 3)))
    masks = np.zeros((1, 56, 56), np.float32)
    masks[:, 10:30, 10:30] = 1.0
    prev = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (16, 16)))
    port = (tconvert.from_jax_params(jax.tree.map(np.asarray, jdp)), tdino.DinoV2Config(**DINO),
            tconvert.from_jax_params(jax.tree.map(np.asarray, jsp)), tsam.SamConfig(**SAM))
    return (jdp, dcfg, jsp, scfg), port, (sup, masks, qry, prev)


def _run_jax(tiny, extra, fuse, cascade=False):
    (jdp, dcfg, jsp, scfg), _, (sup, masks, qry, prev) = tiny
    return jmatcher.generate_proposals(
        jax.random.PRNGKey(7), jdp, dcfg, jsp, scfg, jamg.AmgConfig(**AMG),
        jmatcher.MatcherConfig(**MATCHER, **extra), jnp.asarray(sup), jnp.asarray(masks),
        jnp.ones((1,), bool), jnp.asarray(qry), bucket=8,
        target_mask_low_res=jnp.asarray(prev) if cascade else None, fuse_programs=fuse)


def _run_port(tiny, extra, cascade=False):
    """The port's call with JAX's noise for ``PRNGKey(7)``."""
    _, (tdp, tdcfg, tsp, tscfg), (sup, masks, qry, prev) = tiny
    key = jax.random.PRNGKey(7)
    jcfg = jmatcher.MatcherConfig(**MATCHER, **extra)
    d = len(range(MATCHER["sample_range"][0], MATCHER["sample_range"][1] + 1)) \
        * MATCHER["max_sample_iterations"]
    gumbel = torch.from_numpy(np.asarray(jax.random.gumbel(jax.random.fold_in(key, 1),
                                                           (d, MATCHER["grid"] ** 2))))
    n_src = int(jcfg.use_negative_priors_from_discarded) + int(jcfg.use_negative_priors_from_cost)
    noise = [neg_noise(jax.random.fold_in(key, 2 + si), jcfg) for si in range(n_src)]
    return tmatcher.generate_proposals(
        tdp, tdcfg, tsp, tscfg, tamg.AmgConfig(**AMG), tmatcher.MatcherConfig(**MATCHER, **extra),
        torch.from_numpy(sup), torch.from_numpy(masks), torch.ones((1,), dtype=torch.bool),
        torch.from_numpy(qry), bucket=8, gumbel=gumbel, neg_noise=noise or None,
        target_mask_low_res=torch.from_numpy(prev) if cascade else None)


CASES = {"negatives": (BOTH_SOURCES, False), "box": (dict(use_box=True), False),
         "cascade": ({}, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_proposals_equal_jax_in_both_flows(tiny, case):
    """The port's one flow against mars_tpu's fused flow (every row) and its
    two-program flow (the bucket, its validity and the merged mask: its rows
    are the active family's only)."""
    extra, cascade = CASES[case]
    tout = _run_port(tiny, extra, cascade)
    for fuse in (True, False):
        jout = _run_jax(tiny, extra, fuse, cascade)
        for k in ("bucket_masks", "bucket_valid", "merged"):
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                          err_msg=f"{k}, fuse_programs={fuse}")
        assert int(tout["telemetry"]["n_prompt_sets"]) == int(jout["telemetry"]["n_prompt_sets"])
        assert int(tout["telemetry"]["positive_points_inside_mask"]) == \
            int(jout["telemetry"]["positive_points_inside_mask"])
        if fuse:
            np.testing.assert_array_equal(tout["proposal_valid"].numpy(),
                                          np.asarray(jout["proposal_valid"]))
        else:
            assert jout["proposal_valid"].shape[0] < tout["proposal_valid"].shape[0]
    assert tout["bucket_valid"].any()
    if cascade:  # the mask input changes the decoded logits
        plain = _run_port(tiny, {})
        assert not torch.allclose(tout["low_res_logits"], plain["low_res_logits"])
