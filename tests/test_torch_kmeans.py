"""k-means++ (``ops.kmeans``) and the Matcher's centres branch against
mars_tpu.  The seeding noise is JAX's own: ``jax.random.categorical(k, l)``
is ``argmax(gumbel(k, l.shape) + l)`` (jax 0.9.0, ``mode=None``), and
``kmeans_pp`` takes one split of its key per centre, so row i of the port's
``gumbel`` is ``jax.random.gumbel`` of the i-th split."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_matcher as tm
from mars_tpu.models import convert as jconvert, dinov2 as jdino, sam as jsam
from mars_tpu.ops import kmeans as jkmeans
from mars_tpu.pipeline import amg as jamg, matcher as jmatcher
from mars_tpu_torch.ops import kmeans as tkmeans
from mars_tpu_torch.pipeline import amg as tamg, matcher as tmatcher

K = 8


def jax_noise(key, k, n):
    """The (k, n) Gumbel noise of ``mars_tpu.ops.kmeans.kmeans_pp(key, ...)``."""
    key, k0 = jax.random.split(key)
    rows = [jax.random.gumbel(k0, (n,))]
    for _ in range(1, k):
        key, kk = jax.random.split(key)
        rows.append(jax.random.gumbel(kk, (n,)))
    return torch.from_numpy(np.stack([np.asarray(r) for r in rows]))


@pytest.mark.parametrize("seed,n,live", [(0, 1369, 60), (1, 1369, 1369), (2, 64, 5),
                                         (3, 40, 0), (4, 300, 8)])
def test_kmeans_pp_equals_jax(seed, n, live):
    """Matched-point-like inputs (pixel centres of a 37-grid); fewer valid
    points than K, none, and exactly K among them."""
    rng = np.random.RandomState(seed)
    pts = (rng.randint(0, 37, (n, 2)) * 14 + 7).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[rng.choice(n, live, replace=False)] = True
    key = jax.random.PRNGKey(seed)
    jc, ja = jkmeans.kmeans_pp(key, jnp.asarray(pts), jnp.asarray(valid), K)
    tc, ta = tkmeans.kmeans_pp(torch.from_numpy(pts), torch.from_numpy(valid), K,
                               gumbel=jax_noise(key, K, n))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(torch.round(tc).numpy(), np.round(np.asarray(jc)))
    np.testing.assert_array_equal(ta.numpy()[valid], np.asarray(ja)[valid])


def test_kmeans_pp_draws_from_a_generator():
    pts = torch.from_numpy((np.random.RandomState(0).rand(200, 2) * 500).astype(np.float32))
    valid = torch.ones(200, dtype=torch.bool)
    a = tkmeans.kmeans_pp(pts, valid, K, generator=torch.Generator().manual_seed(1))[0]
    b = tkmeans.kmeans_pp(pts, valid, K, generator=torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, b) and len(torch.unique(a, dim=0)) == K


@pytest.fixture(scope="module")
def centres_golden():
    """The golden Matcher fixture with use_points_or_centers=False, JAX
    (fused program, key 0) and the port fed JAX's seeding noise."""
    data = np.load(tm.os.path.join(tm.FIXTURES, "golden_matcher_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}
    sup = np.ascontiguousarray(d["support_images"][0].transpose(0, 2, 3, 1))
    supm = d["support_masks"][0]
    qry = np.ascontiguousarray(d["query_image"][0].transpose(1, 2, 0))
    sam_sd = tm._sub(sd, "sam.")
    jsam_params = {"encoder": jconvert.sam_encoder_to_flax(sam_sd, depth=3),
                   "prompt_encoder": jconvert.sam_prompt_encoder_to_flax(sam_sd),
                   "decoder": jconvert.sam_decoder_to_flax(sam_sd)}
    jdino_params = jconvert.dinov2_to_flax(tm._sub(sd, "dino."), depth=3, num_register_tokens=4)
    jcfg = jmatcher.MatcherConfig(**tm.MATCHER, use_points_or_centers=False)
    key = jax.random.PRNGKey(0)
    jargs = (jdino_params, jdino.DinoV2Config(**tm.DINO), jsam_params, jsam.SamConfig(**tm.SAM),
             jamg.AmgConfig(**tm.AMG), jcfg, jnp.asarray(sup), jnp.asarray(supm),
             jnp.ones((1,), bool), jnp.asarray(qry))
    jout = jmatcher.generate_proposals(key, *jargs, fuse_programs=True)
    jout = {k: np.asarray(v) for k, v in jout.items() if k != "telemetry"}
    jm = jmatcher._match_stage(key, jdino_params, jnp.asarray(sup), jnp.asarray(supm),
                               jnp.ones((1,), bool), jnp.asarray(qry),
                               jdino.DinoV2Config(**tm.DINO), jcfg)
    sam_params, sam_cfg = tm._tiny_sam(sam_sd)
    dino_params, dino_cfg = tm._tiny_dino(tm._sub(sd, "dino."))
    l = tm.MATCHER["grid"] ** 2
    out = tmatcher.generate_proposals(
        dino_params, dino_cfg, sam_params, sam_cfg, tamg.AmgConfig(**tm.AMG),
        tmatcher.MatcherConfig(**tm.MATCHER, use_points_or_centers=False),
        torch.from_numpy(sup), torch.from_numpy(supm), torch.ones((1,), dtype=torch.bool),
        torch.from_numpy(qry), generator=torch.Generator().manual_seed(0), bucket=8,
        kmeans_gumbel=jax_noise(jax.random.fold_in(key, 0), K, l))
    return out, jout, {k: np.asarray(v) for k, v in jm.items()}


def test_centres_are_jax_prompts(centres_golden):
    out, _, jm = centres_golden
    n = int(out["point_valid"].sum())
    assert 0 < n < K  # fewer matched points than centres: surplus centres masked
    np.testing.assert_array_equal(out["prompt_valid"].numpy(), jm["prompt_valid"])
    np.testing.assert_array_equal(out["prompt_pts"].numpy(), jm["prompt_pts"])
    assert out["prompt_valid"].numpy()[:n].all() and not out["prompt_valid"].numpy()[n:].any()


def test_centres_branch_proposals_equal_jax(centres_golden):
    """At test_torch_matcher's tolerances: proposals matched at IoU >= 0.999,
    the validity layout, per-mask scores at 1e-4, the merged mask."""
    out, jout, _ = centres_golden
    ours, theirs = tm._live(out), tm._live(jout)
    assert len(ours) == len(theirs) > 0
    for i, _, iou in tm._greedy_match(tm._mask_iou_matrix(theirs, ours)):
        assert iou >= 0.999, f"JAX mask {i} best IoU {iou:.4f}"
    np.testing.assert_array_equal(out["proposal_valid"].numpy(), jout["proposal_valid"])
    for k in ("purity", "coverage", "emd_score", "iou", "stability"):
        np.testing.assert_allclose(tm._live(out, k), tm._live(jout, k), atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(out["merged"].numpy() > 0, jout["merged"] > 0)
