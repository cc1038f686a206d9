"""Episodes with more than one support shot, the port against mars_tpu.

Tiny towers on both sides (the golden episode's DINOv2 and CLIP weights,
the golden Matcher's DINOv2), the same seeded inputs:
  - VVA with two shots and a padded third: equal within 1e-4, and the
    padded shot's content changes nothing;
  - ``Mars.predict`` over a five-shot synthetic episode: priors and final
    scores within 1e-4 (float32; the VVA prior 2e-4, ``VVA_PRIOR_TOL``),
    the merged mask equal, and no live score within 1e-4 of the merge
    threshold;
  - the five-shot Matcher's similarity matrices within 1e-4, and its
    bidirectional matching on the same matrix equal, in both forward
    branches (support footprint within the query grid, and past it: the
    transposed problem);
  - the two-program evaluation at five shots on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.core.episode import Episode as JEpisode, pad_proposals as jpad
from mars_tpu.data.synthetic import SyntheticFSS as JSynthetic
from mars_tpu.models import clip as jclip, convert as jconvert, dinov2 as jdino
from mars_tpu.pipeline import filtering as jfilt, mars as jmars, matcher as jmatcher
from mars_tpu.pipeline import vta as jvta, vva as jvva
from mars_tpu_torch import cli as tcli, cli_proposals as tcli_proposals
from mars_tpu_torch.core.episode import Episode
from mars_tpu_torch.data.base import episode_host_u8
from mars_tpu_torch.data.synthetic import SyntheticFSS
from mars_tpu_torch.models import clip as tclip, convert as tconvert, dinov2 as tdino
from mars_tpu_torch.pipeline import filtering as tfilt, mars as tmars, matcher as tmatcher
from mars_tpu_torch.pipeline import vta as tvta, vva as tvva
from test_torch_cli_proposals import SIZE, tiny_port, trees  # noqa: F401  (fixtures)
from test_torch_golden_episode import AC_V, BUCKET, CLIP_T, CLIP_V, DESC, DINO, FM, VTA, VVA

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-4
# the five-shot VVA prior rescales a difference of two means over 320 rows
# twice (min-max before and after PIR): on this episode each package's
# float32 prior lies ~9e-5 from the same function evaluated in float64 by
# the port, 1.1e-4 from the other's
VVA_PRIOR_TOL = 2e-4
SHOTS = 5
MATCH_DINO = dict(patch_size=8, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
                  pos_embed_grid=8)


def _sd(name):
    data = np.load(os.path.join(FIXTURES, name))
    return {k[3:]: data[k] for k in data.files if k.startswith("sd.")}


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _port(tree):
    return tconvert.from_jax_params(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def golden_trees():
    sd = _sd("golden_episode_tiny.npz")
    clip_sd, ac_sd = _sub(sd, "clip."), _sub(sd, "aclip.")
    trees = dict(
        dino=jconvert.dinov2_to_flax(_sub(sd, "dino."), depth=3, num_register_tokens=4),
        clip_v=jconvert.clip_visual_to_flax(clip_sd, depth=3),
        clip_t=jconvert.clip_text_to_flax(clip_sd, depth=2),
        ac_v=jconvert.alpha_clip_visual_to_flax(ac_sd, depth=2),
        ac_t=jconvert.clip_text_to_flax(ac_sd, depth=2))
    scales = (np.float32(clip_sd["logit_scale"]), np.float32(ac_sd["logit_scale"]))
    return trees, scales


def test_vva_two_shots_with_padding(golden_trees):
    """Two real shots and one padded (tests/test_data_eval.py's
    test_vva_two_shots_with_padding): equal to JAX, and the padded shot's
    content changes nothing."""
    trees, _ = golden_trees
    rng = np.random.RandomState(1)
    sup = rng.rand(3, 112, 112, 3).astype(np.float32)
    qry = rng.rand(112, 112, 3).astype(np.float32)
    masks = np.zeros((3, 112, 112), np.float32)
    masks[:, 20:80, 30:90] = 1.0
    valid = np.array([True, True, False])
    jcfg, tcfg = jdino.DinoV2Config(**DINO), tdino.DinoV2Config(**DINO)
    jv, tv = jvva.VVAConfig(**VVA), tvva.VVAConfig(**VVA)
    params = _port(trees["dino"])
    want = jvva.compute(trees["dino"], jnp.asarray(sup), jnp.asarray(masks), jnp.asarray(valid),
                        jnp.asarray(qry), jcfg, jv)

    def port(s):
        return tvva.compute(params, torch.from_numpy(s), torch.from_numpy(masks),
                            torch.from_numpy(valid), torch.from_numpy(qry), tcfg, tv)

    got = port(sup)
    for name, g, w in zip(("prior", "cost", "support_fg"), got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=TOL,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    sup_b = sup.copy()
    sup_b[2] = 0.12345
    got_b = port(sup_b)
    np.testing.assert_allclose(got_b[0].numpy(), got[0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_b[2].numpy(), got[2].numpy())
    assert not got[2].numpy().reshape(3, -1)[2].any()


def _five_shot_episode(seed=0):
    """Synthetic episode ``seed`` at five shots, resized as both CLIs do,
    and its bucket: the ground truth and six boxes (cli.synthetic_proposals)."""
    rec = SyntheticFSS(seed=seed, shot=SHOTS, size=160)[0]
    jrec = JSynthetic(seed=seed, shot=SHOTS, size=160)[0]
    np.testing.assert_array_equal(rec.support_imgs[4], jrec.support_imgs[4])
    sup, msk, qry, valid = episode_host_u8(rec, 112, SHOTS)
    props = tcli.synthetic_proposals(rec, 112, BUCKET, np.random.RandomState(seed), "cpu")
    return (sup.astype(np.float32) / 255.0, msk.astype(np.float32), qry.astype(np.float32) / 255.0,
            valid, rec.class_name, props)


def test_five_shot_predict_equals_jax(golden_trees):
    trees, scales = golden_trees
    sup, msk, qry, valid, name, props = _five_shot_episode()
    assert valid.all() and sup.shape == (SHOTS, 112, 112, 3)
    jm = jmars.Mars(
        (trees["dino"], jdino.DinoV2Config(**DINO)),
        (trees["clip_v"], trees["clip_t"], jnp.asarray(scales[0]),
         jclip.ClipVisualConfig(**CLIP_V), jclip.ClipTextConfig(**CLIP_T)),
        (trees["ac_v"], trees["ac_t"], jnp.asarray(scales[1]),
         jclip.ClipVisualConfig(**AC_V), jclip.ClipTextConfig(**CLIP_T)),
        retriever=None,
        cfg=jmars.MarsConfig(vva=jvva.VVAConfig(**VVA), vta=jvta.VTAConfig(**VTA),
                             filter_merge=jfilt.FilterMergeConfig(**FM)))
    jep = JEpisode(jnp.asarray(sup), jnp.asarray(msk), jnp.asarray(valid), jnp.asarray(qry),
                   jnp.asarray(-1, jnp.int32))
    jprops = jpad(jnp.asarray(props.masks.numpy()), BUCKET, valid=jnp.asarray(props.valid))
    args = (jm.dino_params, jm.clip_v, jm.clip_scale, jm.ac_v, jep.support_images,
            jep.support_masks, jep.support_valid, jep.query_image, jprops.masks, jprops.valid,
            jm._vta_text_feats(name), jm._alpha_clip_text_feats(f"a {name}, {DESC}."))
    want = dict(zip(("merged", "scores", "vva_prior", "vta_prior", "ac_scores"),
                    map(np.asarray, jm._fused_debug()(*args))))
    t = {k: _port(v) for k, v in trees.items()}
    tm = tmars.Mars(
        (t["dino"], tdino.DinoV2Config(**DINO)),
        (t["clip_v"], t["clip_t"], torch.tensor(scales[0]),
         tclip.ClipVisualConfig(**CLIP_V), tclip.ClipTextConfig(**CLIP_T)),
        (t["ac_v"], t["ac_t"], torch.tensor(scales[1]),
         tclip.ClipVisualConfig(**AC_V), tclip.ClipTextConfig(**CLIP_T)),
        cfg=tmars.MarsConfig(vva=tvva.VVAConfig(**VVA), vta=tvta.VTAConfig(**VTA),
                             filter_merge=tfilt.FilterMergeConfig(**FM)),
        device="cpu")
    ep = Episode(torch.from_numpy(sup), torch.from_numpy(msk), torch.from_numpy(valid),
                 torch.from_numpy(qry), -1)
    got = tm.predict_debug(ep, props, class_name=name, class_description=DESC)
    for key in ("vva_prior", "vta_prior", "ac_scores", "scores"):
        np.testing.assert_allclose(got[key], want[key], atol=VVA_PRIOR_TOL if key == "vva_prior"
                                   else TOL, rtol=0, err_msg=key)
    np.testing.assert_array_equal(got["merged"], want["merged"])
    np.testing.assert_array_equal(
        tm.predict(ep, props, class_name=name, class_description=DESC).numpy(), want["merged"])
    # the equality means something: every live score is clear of the threshold
    live = got["scores"][props.valid.numpy()]
    top = live.max()
    thr = FM["dynamic_threshold"] * top if top < FM["static_threshold"] else FM["static_threshold"]
    assert np.abs(live - thr).min() > TOL
    assert 0 < (live >= thr).sum() < len(live)


@pytest.fixture(scope="module")
def matcher_dino():
    sd = _sd("golden_matcher_tiny.npz")
    tree = jconvert.dinov2_to_flax(_sub(sd, "dino."), depth=3, num_register_tokens=4)
    return tree, _port(tree)


@pytest.mark.parametrize("footprint", ["within_grid", "past_grid"])
def test_five_shot_matcher_matching_equals_jax(matcher_dino, footprint):
    """Five supports of 64 patches each (R = 320 rows over L = 64 query
    patches): small masks keep the footprint within the query grid
    (forward over the rows), large ones pass it (forward over the
    transposed problem)."""
    jtree, ttree = matcher_dino
    rng = np.random.RandomState(5)
    sup = rng.rand(SHOTS, 64, 64, 3).astype(np.float32)
    qry = rng.rand(64, 64, 3).astype(np.float32)
    masks = np.zeros((SHOTS, 64, 64), np.float32)
    side = 16 if footprint == "within_grid" else 40
    for s in range(SHOTS):
        y, x = rng.randint(0, 64 - side, 2)
        masks[s, y: y + side, x: x + side] = 1.0
    valid = np.ones((SHOTS,), bool)
    want = jmatcher._features_and_matrices(jtree, jnp.asarray(sup), jnp.asarray(masks),
                                           jnp.asarray(valid), jnp.asarray(qry),
                                           jdino.DinoV2Config(**MATCH_DINO), 8)
    got = tmatcher._features_and_matrices(ttree, torch.from_numpy(sup), torch.from_numpy(masks),
                                          torch.from_numpy(valid), torch.from_numpy(qry),
                                          tdino.DinoV2Config(**MATCH_DINO), 8)
    s_mat, fg = np.asarray(want[0]), np.asarray(want[2])
    assert s_mat.shape == (SHOTS * 64, 64)
    np.testing.assert_allclose(got[0].numpy(), s_mat, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), fg)
    assert (fg.sum() > 64) == (footprint == "past_grid")
    jout = jmatcher.bidirectional_match(jnp.asarray(s_mat), jnp.asarray(fg))
    tout = tmatcher.bidirectional_match(torch.from_numpy(s_mat), torch.from_numpy(fg))
    for name, g, w in zip(("matched_row", "pair_valid", "retained", "sim", "retained_raw"),
                          tout, jout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(tout[1].sum()) > 0


def test_five_shot_two_program_evaluation(tiny_port, tmp_path, capsys):  # noqa: F811
    """``cli_proposals --nshot 5`` writes a dump per episode (the class ids
    of the JAX package's five-shot episodes), and ``cli --nshot 5
    --mask-proposals-path`` ranks every dumped proposal into a binary
    mask."""
    out = tmp_path / "props"
    res = tcli_proposals.main(["--episodes", "2", "--nshot", "5", "--input-size", str(SIZE),
                               "--sam-size", "vit_b", "--out", str(out), "--device", "cpu"])
    jds = JSynthetic(fold=0, split="test", shot=5, seed=0)
    for idx in range(2):
        with np.load(out / f"0_{idx}.npz") as f:
            assert int(f["class_id"]) == jds[idx].class_id
            assert len(f["masks"]) == res["live_proposals"][idx]
    got = tcli.main(["--episodes", "2", "--nshot", "5", "--gt-class-names",
                     "--mask-proposals-path", str(out), "--input-size", str(SIZE),
                     "--proposal-bucket", "16", "--device", "cpu"], keep_masks=True)
    assert got["live_proposals"] == [min(n, 16) for n in res["live_proposals"]]
    assert got["masks_binary"] and [m.shape for m in got["masks"]] == [(SIZE, SIZE)] * 2
    assert got["launches"] == {name: 0 for name in tcli.KERNELS}
    assert "live proposals" in capsys.readouterr().out
