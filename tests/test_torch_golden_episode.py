"""The port's Mars.predict on the golden episode, against the fixture and
against mars_tpu's Mars on the same weights."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.core.episode import Episode as JEpisode, pad_proposals as jpad
from mars_tpu.models import clip as jclip, convert as jconvert, dinov2 as jdino
from mars_tpu.pipeline import filtering as jfilt, mars as jmars, vta as jvta, vva as jvva
from mars_tpu_torch.core.episode import Episode, pad_proposals
from mars_tpu_torch.models import clip as tclip, convert as tconvert, dinov2 as tdino
from mars_tpu_torch.pipeline import filtering as tfilt, mars as tmars, vta as tvta, vva as tvva

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BUCKET = 8
DESC = "a domesticated carnivorous mammal"
DINO = dict(patch_size=14, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
            pos_embed_grid=8)
CLIP_V = dict(patch_size=16, width=64, depth=3, num_heads=1, output_dim=16, pos_embed_grid=7)
CLIP_T = dict(context_length=77, vocab_size=49408, width=16, depth=2, num_heads=2,
              output_dim=16)
AC_V = dict(patch_size=16, width=64, depth=2, num_heads=1, output_dim=16, pos_embed_grid=7,
            alpha_channel=True)
VVA = dict(refinement_box_threshold=0.8, attn_tap_last_n=2, grid=8)
VTA = dict(refinement_box_threshold=0.4, attn_tap_last_n=3, input_size=112, grid=7)
FM = dict(alpha=0.85, static_threshold=0.55, dynamic_threshold=0.95, grid=8,
          alpha_clip_size=112, alpha_clip_batch=4, emd_row_bucket=128, emd_col_bucket=64)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(FIXTURES, "golden_episode_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}
    clip_sd, ac_sd = _sub(sd, "clip."), _sub(sd, "aclip.")
    trees = dict(
        dino=jconvert.dinov2_to_flax(_sub(sd, "dino."), depth=3, num_register_tokens=4),
        clip_v=jconvert.clip_visual_to_flax(clip_sd, depth=3),
        clip_t=jconvert.clip_text_to_flax(clip_sd, depth=2),
        ac_v=jconvert.alpha_clip_visual_to_flax(ac_sd, depth=2),
        ac_t=jconvert.clip_text_to_flax(ac_sd, depth=2),
    )
    scales = (np.float32(clip_sd["logit_scale"]), np.float32(ac_sd["logit_scale"]))
    sup = d["support_images"][0].transpose(0, 2, 3, 1)
    qry = d["query_image"][0].transpose(1, 2, 0)

    jm = jmars.Mars(
        (trees["dino"], jdino.DinoV2Config(**DINO)),
        (trees["clip_v"], trees["clip_t"], jnp.asarray(scales[0]),
         jclip.ClipVisualConfig(**CLIP_V), jclip.ClipTextConfig(**CLIP_T)),
        (trees["ac_v"], trees["ac_t"], jnp.asarray(scales[1]),
         jclip.ClipVisualConfig(**AC_V), jclip.ClipTextConfig(**CLIP_T)),
        retriever=None,
        cfg=jmars.MarsConfig(vva=jvva.VVAConfig(**VVA), vta=jvta.VTAConfig(**VTA),
                             filter_merge=jfilt.FilterMergeConfig(**FM)))
    jep = JEpisode(jnp.asarray(sup), jnp.asarray(d["support_masks"][0]), jnp.ones((2,), bool),
                   jnp.asarray(qry), jnp.asarray(-1, jnp.int32))
    jprops = jpad(jnp.asarray(d["proposals"]), BUCKET)
    j_merged = np.asarray(jm.predict(jep, jprops, class_name="dog", class_description=DESC))
    args = (jm.dino_params, jm.clip_v, jm.clip_scale, jm.ac_v, jep.support_images,
            jep.support_masks, jep.support_valid, jep.query_image, jprops.masks, jprops.valid,
            jm._vta_text_feats("dog"), jm._alpha_clip_text_feats(f"a dog, {DESC}."))
    _, j_scores = jm._fused()(*args)
    j_debug = dict(zip(("merged", "scores", "vva_prior", "vta_prior", "ac_scores"),
                       map(np.asarray, jm._fused_debug()(*args))))

    t = {k: tconvert.from_jax_params(jax.tree.map(np.asarray, v)) for k, v in trees.items()}
    tm = tmars.Mars(
        (t["dino"], tdino.DinoV2Config(**DINO)),
        (t["clip_v"], t["clip_t"], torch.tensor(scales[0]),
         tclip.ClipVisualConfig(**CLIP_V), tclip.ClipTextConfig(**CLIP_T)),
        (t["ac_v"], t["ac_t"], torch.tensor(scales[1]),
         tclip.ClipVisualConfig(**AC_V), tclip.ClipTextConfig(**CLIP_T)),
        cfg=tmars.MarsConfig(vva=tvva.VVAConfig(**VVA), vta=tvta.VTAConfig(**VTA),
                             filter_merge=tfilt.FilterMergeConfig(**FM)),
        device="cpu")
    tep = Episode(torch.from_numpy(np.ascontiguousarray(sup)),
                  torch.from_numpy(d["support_masks"][0]), torch.ones((2,), dtype=torch.bool),
                  torch.from_numpy(np.ascontiguousarray(qry)), -1)
    tprops = pad_proposals(torch.from_numpy(d["proposals"]), BUCKET)
    return d, j_merged, np.asarray(j_scores), j_debug, tm, tep, tprops


def test_merged_mask_bit_exact(golden):
    d, j_merged, _, _, tm, tep, tprops = golden
    merged = tm.predict(tep, tprops, class_name="dog", class_description=DESC).numpy()
    np.testing.assert_array_equal(merged, d["merged"])
    np.testing.assert_array_equal(merged, j_merged)


def test_debug_state_and_final_scores(golden):
    d, _, j_scores, j_debug, tm, tep, tprops = golden
    out = tm.predict_debug(tep, tprops, class_name="dog", class_description=DESC)
    np.testing.assert_array_equal(out["merged"], d["merged"])
    np.testing.assert_allclose(out["scores"], j_scores, atol=1e-4, rtol=0)
    for key in ("vva_prior", "vta_prior", "ac_scores"):
        np.testing.assert_allclose(out[key], j_debug[key], atol=1e-4, rtol=0, err_msg=key)
    assert np.all(out["scores"][6:] == -np.inf)
    np.testing.assert_allclose(out["vva_prior"], d["vva"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out["vta_prior"], d["vta_resized"], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out["ac_scores"][:6], d["ac_raw"], atol=3e-4, rtol=1e-3)
