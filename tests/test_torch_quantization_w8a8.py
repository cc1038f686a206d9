"""W8A8 (``quantize_params(act_bits=8)``) and the ranking CLI's tower flags
(``--int8-towers``, ``--w8a8-alphaclip``) against mars_tpu.

Tolerances: the activation codes and the int8 × int8 → int32 product are
bitwise equal to JAX's; the rescaled output equal to JAX's
``quantized_dense`` within 1e-6 relative (two float32 products in either
order) and within JAX's own W8A8 budget of the float product
(tests/test_precision.py:69-90: mean relative error < 0.02); the tiny
episode's final scores within ``EPISODE_SCORE_TOL`` of JAX's on the same
quantized towers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_golden_episode as ge
from mars_tpu.core.episode import Episode as JEpisode, pad_proposals as jpad
from mars_tpu.models import clip as jclip, convert as jconvert, dinov2 as jdino
from mars_tpu.models import layers as jL, quantization as jquant
from mars_tpu.pipeline import filtering as jfilt, mars as jmars, vta as jvta, vva as jvva
from mars_tpu_torch import cli as tcli
from mars_tpu_torch.core.episode import Episode, pad_proposals
from mars_tpu_torch.models import clip as tclip, convert as tconvert, dinov2 as tdino
from mars_tpu_torch.models import layers as tL, quantization as tquant
from mars_tpu_torch.pipeline import filtering as tfilt, mars as tmars, vta as tvta, vva as tvva

# float32 towers with int8 kernels on both sides: the two packages' sums
# in other orders, and a W8A8 activation code that rounds the other way,
# moved the final scores by at most 1.5e-5 on this episode (CPU)
EPISODE_SCORE_TOL = 1e-3


def _codes(x):
    """JAX's activation codes and int32 product, the lines of
    ``mars_tpu.models.quantization.quantized_dense`` on an ``act8`` kernel
    up to the product, compiled by XLA."""
    @jax.jit
    def f(x, q):
        ax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
        sx = jnp.maximum(ax, 1e-8) / 127.0
        xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
        return xq, jnp.einsum("...i,io->...o", xq, q, preferred_element_type=jnp.int32)
    return f


@pytest.mark.parametrize("shape", [(4, 37, 256), (130, 64)])
def test_w8a8_dense_equals_jax(shape):
    rng = np.random.RandomState(len(shape))
    k_in = shape[-1]
    w = rng.randn(k_in, 128).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    x = (rng.randn(*shape) * rng.rand(*shape[:-1], 1) * 3).astype(np.float32)
    jq = jquant.quantize_params({"d": {"kernel": w, "bias": b}}, bits=8, min_size=0,
                                act_bits=8)["d"]
    tq = tquant.quantize_params({"d": {"kernel": torch.from_numpy(w), "bias": torch.from_numpy(b)}},
                                bits=8, min_size=0, act_bits=8)["d"]
    assert "act8" in tq["kernel"] and "act8" in jq["kernel"]
    np.testing.assert_array_equal(tq["kernel"]["q"].numpy(), np.asarray(jq["kernel"]["q"]))
    # the codes and the int32 product, bitwise
    jxq, jy = map(np.asarray, _codes(x)(jnp.asarray(x), jq["kernel"]["q"]))
    xf = torch.from_numpy(x).reshape(-1, k_in)
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    txq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(txq.numpy(), jxq.reshape(-1, k_in))
    ty = tquant.int8_product(txq, tq["kernel"]["q"])
    assert ty.dtype == torch.int32
    np.testing.assert_array_equal(ty.numpy(), jy.reshape(-1, 128))
    # the rescaled output: JAX's own function, and the float product's budget
    got = tL.dense(tq, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jL.dense(jq, jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6 * np.abs(got).max())
    want = x @ w + b
    assert (np.abs(got - want) / (np.abs(want).mean() + 1e-6)).mean() < 0.02
    # weight-only int8 carries no marker
    assert "act8" not in tquant.quantize_params({"d": {"kernel": torch.from_numpy(w)}},
                                                min_size=0)["d"]["kernel"]


def _leaf_kinds(tree, prefix=""):
    """{path: "float" | "q" | "q+act8"} of a (JAX or port) parameter tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and ("q" in v or "q4" in v):
            out[prefix + k] = "q+act8" if "act8" in v else "q"
        elif isinstance(v, dict):
            out.update(_leaf_kinds(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = "float"
    return out


@pytest.mark.parametrize("act_bits", [None, 8])
def test_quantize_params_marks_the_same_leaves(act_bits):
    """On the tiny towers at the zoo's default size floor (2^14 elements):
    the same kernels become int8, and the same carry ``act8``; an ``act8``
    leaf holds its codes column-major (the layout ``torch._int_mm`` takes
    without a copy), equal to JAX's."""
    data = np.load(f"{ge.FIXTURES}/golden_episode_tiny.npz")
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    jtree = jconvert.alpha_clip_visual_to_flax(ge._sub(sd, "aclip."), depth=2)
    ttree = tconvert.from_jax_params(jax.tree.map(np.asarray, jtree))
    jq = jquant.quantize_params(jtree, act_bits=act_bits)
    tq = tquant.quantize_params(ttree, act_bits=act_bits)
    got = _leaf_kinds(tq)
    assert got == _leaf_kinds(jq)
    assert ("q+act8" if act_bits else "q") in got.values()
    for path, kind in got.items():
        if kind == "float":
            continue
        tk, jk = tq, jq
        for part in path.split("/"):
            tk, jk = tk[part], jk[part]
        assert tk["q"].is_contiguous() == (kind == "q"), path
        assert tk["q"].t().is_contiguous() == (kind == "q+act8"), path
        np.testing.assert_array_equal(tk["q"].numpy(), np.asarray(jk["q"]), err_msg=path)


def test_int8_tower_flags_reach_build_model(monkeypatch):
    """--int8-towers quantizes DINOv2, CLIP's visual tower and AlphaCLIP's
    visual tower after the --bf16 cast (act8 on AlphaCLIP only with
    --w8a8-alphaclip), as mars_tpu.cli.build_model does."""
    leaf = {"kernel": torch.randn(128, 256), "bias": torch.zeros(256)}
    monkeypatch.setattr(tcli.zoo, "build_dinov2", lambda *a, **k: ({"b": dict(leaf)}, "dcfg"))
    monkeypatch.setattr(tcli.zoo, "build_clip", lambda *a, **k: (
        {"b": dict(leaf)}, {"t": dict(leaf)}, 1.0, "vcfg", "tcfg"))
    monkeypatch.setattr(tcli.zoo, "build_alpha_clip", lambda *a, **k: (
        {"b": dict(leaf)}, {"t": dict(leaf)}, 1.0, "vcfg", "tcfg"))
    seen = {}
    monkeypatch.setattr(tcli.mars_lib, "Mars", lambda **kw: seen.update(kw))
    tcli.build_model(tcli.parse_args(["--gt-class-names", "--bf16", "--int8-towers",
                                      "--w8a8-alphaclip"]), "cpu")
    for tower in ("dino", "clip", "alpha_clip"):
        k = seen[tower][0]["b"]["kernel"]
        assert k["q"].dtype == torch.int8 and ("act8" in k) == (tower == "alpha_clip"), tower
        assert seen[tower][0]["b"]["bias"].dtype == torch.bfloat16  # cast before quantizing
    assert not isinstance(seen["clip"][1]["t"]["kernel"], dict)  # text towers stay floating
    tcli.build_model(tcli.parse_args(["--gt-class-names", "--int8-towers"]), "cpu")
    assert "act8" not in seen["alpha_clip"][0]["b"]["kernel"]
    tcli.build_model(tcli.parse_args(["--gt-class-names", "--w8a8-alphaclip"]), "cpu")
    assert not isinstance(seen["alpha_clip"][0]["b"]["kernel"], dict)  # needs --int8-towers


def test_int8_towers_episode_matches_jax():
    """The golden episode with every tower kernel int8 (the size floor at 0,
    so the tiny towers' kernels are all quantized) and W8A8 AlphaCLIP, on
    each side with its own quantize_params: the final scores within
    EPISODE_SCORE_TOL, the merged masks equal, or differing only by
    proposals whose keep decision flipped within that of its threshold."""
    data = np.load(f"{ge.FIXTURES}/golden_episode_tiny.npz")
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}
    clip_sd, ac_sd = ge._sub(sd, "clip."), ge._sub(sd, "aclip.")
    trees = dict(dino=jconvert.dinov2_to_flax(ge._sub(sd, "dino."), depth=3,
                                              num_register_tokens=4),
                 clip_v=jconvert.clip_visual_to_flax(clip_sd, depth=3),
                 clip_t=jconvert.clip_text_to_flax(clip_sd, depth=2),
                 ac_v=jconvert.alpha_clip_visual_to_flax(ac_sd, depth=2),
                 ac_t=jconvert.clip_text_to_flax(ac_sd, depth=2))
    t = {k: tconvert.from_jax_params(jax.tree.map(np.asarray, v)) for k, v in trees.items()}
    for k in ("dino", "clip_v", "ac_v"):
        act = 8 if k == "ac_v" else None
        trees[k] = jquant.quantize_params(trees[k], min_size=0, act_bits=act)
        t[k] = tquant.quantize_params(t[k], min_size=0, act_bits=act)
    scales = (np.float32(clip_sd["logit_scale"]), np.float32(ac_sd["logit_scale"]))
    sup = d["support_images"][0].transpose(0, 2, 3, 1)
    qry = d["query_image"][0].transpose(1, 2, 0)
    cfgs = dict(vva=ge.VVA, vta=ge.VTA, fm=ge.FM)
    jm = jmars.Mars(
        (trees["dino"], jdino.DinoV2Config(**ge.DINO)),
        (trees["clip_v"], trees["clip_t"], jnp.asarray(scales[0]),
         jclip.ClipVisualConfig(**ge.CLIP_V), jclip.ClipTextConfig(**ge.CLIP_T)),
        (trees["ac_v"], trees["ac_t"], jnp.asarray(scales[1]),
         jclip.ClipVisualConfig(**ge.AC_V), jclip.ClipTextConfig(**ge.CLIP_T)),
        retriever=None,
        cfg=jmars.MarsConfig(vva=jvva.VVAConfig(**cfgs["vva"]), vta=jvta.VTAConfig(**cfgs["vta"]),
                             filter_merge=jfilt.FilterMergeConfig(**cfgs["fm"])))
    jep = JEpisode(jnp.asarray(sup), jnp.asarray(d["support_masks"][0]), jnp.ones((2,), bool),
                   jnp.asarray(qry), jnp.asarray(-1, jnp.int32))
    jprops = jpad(jnp.asarray(d["proposals"]), ge.BUCKET)
    args = (jm.dino_params, jm.clip_v, jm.clip_scale, jm.ac_v, jep.support_images,
            jep.support_masks, jep.support_valid, jep.query_image, jprops.masks, jprops.valid,
            jm._vta_text_feats("dog"), jm._alpha_clip_text_feats(f"a dog, {ge.DESC}."))
    j_merged, j_scores = map(np.asarray, jm._fused()(*args))

    tm = tmars.Mars(
        (t["dino"], tdino.DinoV2Config(**ge.DINO)),
        (t["clip_v"], t["clip_t"], torch.tensor(scales[0]),
         tclip.ClipVisualConfig(**ge.CLIP_V), tclip.ClipTextConfig(**ge.CLIP_T)),
        (t["ac_v"], t["ac_t"], torch.tensor(scales[1]),
         tclip.ClipVisualConfig(**ge.AC_V), tclip.ClipTextConfig(**ge.CLIP_T)),
        cfg=tmars.MarsConfig(vva=tvva.VVAConfig(**cfgs["vva"]), vta=tvta.VTAConfig(**cfgs["vta"]),
                             filter_merge=tfilt.FilterMergeConfig(**cfgs["fm"])),
        device="cpu")
    tep = Episode(torch.from_numpy(np.ascontiguousarray(sup)),
                  torch.from_numpy(d["support_masks"][0]), torch.ones((2,), dtype=torch.bool),
                  torch.from_numpy(np.ascontiguousarray(qry)), -1)
    tprops = pad_proposals(torch.from_numpy(d["proposals"]), ge.BUCKET)
    out = tm.predict_debug(tep, tprops, class_name="dog", class_description=ge.DESC)
    valid = tprops.valid.numpy()
    np.testing.assert_allclose(out["scores"][valid], j_scores[valid], atol=EPISODE_SCORE_TOL,
                               rtol=0)
    if np.array_equal(out["merged"], j_merged):
        return
    masks = tprops.masks.numpy() > 0
    keep_t, thr_t = ge._kept(out["scores"], valid, ge.FM)
    keep_j, thr_j = ge._kept(j_scores, valid, ge.FM)
    for keep, merged in ((keep_t, out["merged"]), (keep_j, j_merged)):
        np.testing.assert_array_equal(merged > 0, masks[keep].any(axis=0))
    for i in np.flatnonzero(keep_t != keep_j):
        assert abs(out["scores"][i] - thr_t) <= EPISODE_SCORE_TOL, (i, out["scores"][i], thr_t)
        assert abs(j_scores[i] - thr_j) <= EPISODE_SCORE_TOL, (i, j_scores[i], thr_j)
