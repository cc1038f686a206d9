"""The port's Matcher (proposal path) against the golden fixture and against
mars_tpu's generate_proposals on the same tiny weights and inputs.

The fixture was made by the reference Matcher (tests/test_golden_matcher.py
describes it); ≤ 8 matched points keep it on the combinations family, so
the flow draws no random numbers.  Masks are compared by content (IoU),
as the JAX package's own golden test does.
"""
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import convert as jconvert, dinov2 as jdino, sam as jsam
from mars_tpu.pipeline import amg as jamg, matcher as jmatcher
from mars_tpu_torch import cli as tcli
from mars_tpu_torch.models import convert as tconvert, dinov2 as tdino, sam as tsam, zoo
from mars_tpu_torch.pipeline import amg as tamg, matcher as tmatcher

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DINO = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
            pos_embed_grid=8)
SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
           global_attn_indexes=(1,), window_size=2, out_chans=32, decoder_mlp_dim=64,
           decoder_heads=2)
MATCHER = dict(input_size=64, grid=8, patch_size=8, sample_range=(2, 3),
               max_sample_iterations=4, alpha=1.0, beta=0.0, exp=0.0, emd_filter=0.0,
               purity_filter=0.02, coverage_filter=0.0, use_score_filter=True,
               deep_score_filter=0.6, deep_score_norm_filter=0.4, topk_scores_threshold=0.0,
               num_merging_mask=10, emd_row_bucket=16, emd_col_bucket=64)
AMG = dict(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.0, box_nms_thresh=0.5,
           sel_multimask_output=True, sel_output_layer=3, decode_batch=16)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _mask_iou_matrix(a, b):
    af = a.reshape(len(a), -1).astype(np.float64)
    bf = b.reshape(len(b), -1).astype(np.float64)
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def _greedy_match(iou):
    iou = iou.copy()
    out = []
    for _ in range(min(iou.shape)):
        i, j = np.unravel_index(np.argmax(iou), iou.shape)
        out.append((int(i), int(j), float(iou[i, j])))
        iou[i, :] = -1
        iou[:, j] = -1
    return out


def _tiny_sam(sd):
    return ({"encoder": tconvert.from_reference_state_dict(sd, "sam_encoder", 3),
             "prompt_encoder": tconvert.from_reference_state_dict(sd, "sam_prompt_encoder"),
             "decoder": tconvert.from_reference_state_dict(sd, "sam_decoder")},
            tsam.SamConfig(**SAM))


def _tiny_dino(sd):
    return (tconvert.from_reference_state_dict(sd, "dinov2", 3), tdino.DinoV2Config(**DINO))


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(FIXTURES, "golden_matcher_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}
    sup = np.ascontiguousarray(d["support_images"][0].transpose(0, 2, 3, 1))
    supm = d["support_masks"][0]
    qry = np.ascontiguousarray(d["query_image"][0].transpose(1, 2, 0))

    sam_sd = _sub(sd, "sam.")
    jsam_params = {"encoder": jconvert.sam_encoder_to_flax(sam_sd, depth=3),
                   "prompt_encoder": jconvert.sam_prompt_encoder_to_flax(sam_sd),
                   "decoder": jconvert.sam_decoder_to_flax(sam_sd)}
    jdino_params = jconvert.dinov2_to_flax(_sub(sd, "dino."), depth=3, num_register_tokens=4)
    jout = jmatcher.generate_proposals(
        jax.random.PRNGKey(0), jdino_params, jdino.DinoV2Config(**DINO), jsam_params,
        jsam.SamConfig(**SAM), jamg.AmgConfig(**AMG), jmatcher.MatcherConfig(**MATCHER),
        jnp.asarray(sup), jnp.asarray(supm), jnp.ones((1,), bool), jnp.asarray(qry),
        fuse_programs=True)
    jout = {k: np.asarray(v) for k, v in jout.items() if k != "telemetry"}

    sam_params, sam_cfg = _tiny_sam(sam_sd)
    dino_params, dino_cfg = _tiny_dino(_sub(sd, "dino."))
    mcfg = tmatcher.MatcherConfig(**MATCHER)
    out = tmatcher.generate_proposals(
        dino_params, dino_cfg, sam_params, sam_cfg, tamg.AmgConfig(**AMG), mcfg,
        torch.from_numpy(sup), torch.from_numpy(supm), torch.ones((1,), dtype=torch.bool),
        torch.from_numpy(qry), generator=torch.Generator().manual_seed(0), bucket=8)
    return d, out, jout, mcfg


def _live(out, key="proposal_masks"):
    valid = np.asarray(out["proposal_valid"])
    return np.asarray(out[key])[valid]


class TestGoldenMatcher:
    def test_cost_matrix_and_footprint(self, golden):
        d, out, _, _ = golden
        np.testing.assert_allclose(out["cost_matrix"].numpy(), d["cost_matrix"], atol=3e-5,
                                   rtol=1e-4)
        np.testing.assert_array_equal(out["support_fg"].numpy(), d["ref_masks_pool"] > 0)

    def test_matched_points(self, golden):
        d, out, jout, _ = golden
        ours = {tuple(map(int, p)) for p in out["points"].numpy()[out["point_valid"].numpy()]}
        assert ours == {tuple(map(int, p)) for p in d["points"]}
        np.testing.assert_array_equal(out["point_valid"].numpy(), jout["point_valid"])

    def test_proposal_set_matches_fixture(self, golden):
        d, out, _, _ = golden
        ours, ref = _live(out), d["proposals"] > 0
        assert len(ours) == len(ref), (len(ours), len(ref))
        for i, _, iou in _greedy_match(_mask_iou_matrix(ref, ours)):
            assert iou >= 0.99, f"ref mask {i} best IoU {iou:.4f}"

    def test_proposal_set_matches_jax(self, golden):
        _, out, jout, _ = golden
        ours, theirs = _live(out), _live(jout)
        assert len(ours) == len(theirs), (len(ours), len(theirs))
        for i, _, iou in _greedy_match(_mask_iou_matrix(theirs, ours)):
            assert iou >= 0.999, f"JAX mask {i} best IoU {iou:.4f}"
        np.testing.assert_array_equal(out["proposal_valid"].numpy(), jout["proposal_valid"])

    def test_per_mask_scores(self, golden):
        d, out, jout, _ = golden
        ours = _live(out)
        got = {k: _live(out, k) for k in ("purity", "coverage", "emd_score", "iou",
                                           "stability")}
        for i, j, _ in _greedy_match(_mask_iou_matrix(d["proposals"] > 0, ours)):
            np.testing.assert_allclose(got["purity"][j], d["purity"][i], atol=1e-5)
            np.testing.assert_allclose(got["coverage"][j], d["coverage"][i], atol=1e-5)
            np.testing.assert_allclose(got["emd_score"][j], d["emd"][i], atol=3e-3)
            np.testing.assert_allclose(got["iou"][j], d["iou_preds"][i], atol=1e-3)
            np.testing.assert_allclose(got["stability"][j], d["stability"][i], atol=1e-3)
        for k in got:  # same layout as JAX: compare row for row
            np.testing.assert_allclose(got[k], _live(jout, k), atol=1e-4, err_msg=k)

    def test_merged_score_filter_path(self, golden):
        d, out, jout, _ = golden
        merged = out["merged"].numpy() > 0
        assert _mask_iou_matrix((d["merged"][0] > 0)[None], merged[None])[0, 0] >= 0.99
        np.testing.assert_array_equal(merged, jout["merged"] > 0)
        np.testing.assert_allclose(float(out["final_score"]), d["final_score"], atol=3e-3)

    def test_merged_topk_path(self, golden):
        d, out, _, mcfg = golden
        merged, final, _ = tmatcher.filter_and_merge(
            out["proposal_masks"], out["proposal_valid"], out["emd_score"], out["purity"],
            out["coverage"], replace(mcfg, use_score_filter=False, topk_scores_threshold=0.2))
        iou = _mask_iou_matrix((d["merged_topk"][0] > 0)[None],
                               (merged.numpy() > 0)[None])[0, 0]
        assert iou >= 0.99, iou
        np.testing.assert_allclose(float(final), d["final_topk"], atol=3e-3)

    def test_bucket_is_compacted_best_first(self, golden):
        _, out, _, _ = golden
        valid = out["proposal_valid"].numpy()
        n = min(int(valid.sum()), 8)
        bucket_valid = out["bucket_valid"].numpy()
        assert bucket_valid.shape == (8,) and bucket_valid[:n].all() and not bucket_valid[n:].any()
        masks = out["bucket_masks"].numpy()
        assert set(np.unique(masks)) <= {0.0, 1.0}
        live = np.flatnonzero(valid)
        best = live[np.argmax(out["mask_score"].numpy()[live])]
        np.testing.assert_array_equal(masks[0], out["proposal_masks"].numpy()[best])


@pytest.mark.parametrize("n_fg", [30, 100])
def test_bidirectional_match_equals_jax(n_fg):
    """Sparse support footprint (forward over rows) and one larger than the
    query grid (forward over the transposed problem, as in multi-shot)."""
    rng = np.random.RandomState(n_fg)
    r, l = 128, 64
    feats = rng.randn(r + l, 16).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    s_mat = feats[:r] @ feats[r:].T
    fg = np.zeros(r, bool)
    fg[rng.choice(r, n_fg, replace=False)] = True
    want = jmatcher.bidirectional_match(jnp.asarray(s_mat), jnp.asarray(fg))
    got = tmatcher.bidirectional_match(torch.from_numpy(s_mat), torch.from_numpy(fg))
    for name, g, w in zip(("matched_row", "pair_valid", "retained", "sim", "retained_raw"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_sample_prompt_sets_with_jax_noise():
    """n > 8 points: the draw family, fed JAX's own Gumbel noise."""
    cfg_kw = dict(input_size=64, grid=8, patch_size=8, sample_range=(4, 6),
                  max_sample_iterations=5)
    rng = np.random.RandomState(5)
    l = 64
    points = rng.randint(0, 64, (l, 2)).astype(np.float32)
    valid = rng.rand(l) < 0.3
    assert valid.sum() > 8
    jcfg = jmatcher.MatcherConfig(**cfg_kw)
    key = jax.random.fold_in(jax.random.PRNGKey(11), 1)
    d = 3 * cfg_kw["max_sample_iterations"]
    noise = np.array(jax.random.gumbel(key, (d, l)))
    jc, jl, jv = map(np.asarray, jmatcher.sample_prompt_sets(key, jnp.asarray(points),
                                                             jnp.asarray(valid), jcfg))
    tc, tl, tv = tmatcher.sample_prompt_sets(torch.from_numpy(points), torch.from_numpy(valid),
                                             tmatcher.MatcherConfig(**cfg_kw),
                                             gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tv.numpy()[-d:].all() and not tv.numpy()[:-d].any()
    np.testing.assert_array_equal(tmatcher.prompt_set_sizes(tmatcher.MatcherConfig(**cfg_kw)),
                                  jmatcher.prompt_set_sizes(jcfg))
    assert tmatcher.union_family_rows(tmatcher.MatcherConfig(**cfg_kw)) == \
        jmatcher.union_family_rows(jcfg)


def test_cli_generate_proposals_on_cpu(monkeypatch, capsys):
    """One episode of ``--generate-proposals`` with tiny towers in place of
    the full-width ones (a full-width SAM ViT-H encode is far too slow on
    the CPU): the golden Matcher fixture's SAM, and the golden episode's
    DINOv2 (patch 14, shared by matching and ranking, as the CLI shares
    it) and CLIP towers, at input size 112."""
    data = np.load(os.path.join(FIXTURES, "golden_matcher_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    ep_data = np.load(os.path.join(FIXTURES, "golden_episode_tiny.npz"))
    ep_sd = {k[3:]: ep_data[k] for k in ep_data.files if k.startswith("sd.")}
    from mars_tpu_torch.models import clip as tclip

    tcfg = tclip.ClipTextConfig(width=16, depth=2, num_heads=2, output_dim=16)

    def clip_pair(prefix, depth, alpha):
        sub = _sub(ep_sd, prefix)
        return (tconvert.from_reference_state_dict(
                    sub, "alpha_clip_visual" if alpha else "clip_visual", depth),
                tconvert.from_reference_state_dict(sub, "clip_text", 2),
                tconvert.logit_scale(sub),
                tclip.ClipVisualConfig(width=64, depth=depth, num_heads=1, output_dim=16,
                                       pos_embed_grid=7, alpha_channel=alpha), tcfg)

    dino = (tconvert.from_reference_state_dict(_sub(ep_sd, "dino."), "dinov2", 3),
            tdino.DinoV2Config(embed_dim=32, depth=3, num_heads=2, pos_embed_grid=8))
    monkeypatch.setattr(zoo, "build_dinov2", lambda seed=0, device=None: dino)
    monkeypatch.setattr(zoo, "build_clip", lambda seed=1, device=None: clip_pair("clip.", 3,
                                                                                 False))
    monkeypatch.setattr(zoo, "build_alpha_clip", lambda seed=2, device=None: clip_pair(
        "aclip.", 2, True))
    monkeypatch.setattr(zoo, "build_sam", lambda variant="vit_h", seed=3, device=None:
                        _tiny_sam(_sub(sd, "sam.")))
    res = tcli.main(["--episodes", "1", "--gt-class-names", "--generate-proposals",
                     "--input-size", "112", "--proposal-bucket", "16", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "proposals" in printed and "live proposals" in printed
    assert res["masks_binary"] and len(res["proposal_ms"]) == 1
    assert 0 <= res["live_proposals"][0] <= 16
    # CPU tensors take the plain versions: no kernel launches
    assert res["launches"] == {"attention_with_tap": 0, "attention_notap": 0,
                               "grid_attention": 0, "windowed_attention": 0, "auction": 0}
