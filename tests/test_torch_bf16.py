"""bf16 towers (``--bf16``): the port's stages against mars_tpu's, each side
cast by its own ``cast_floating`` from the same float32 arrays.

Every stage output must have JAX's dtype: bf16 activations out of bf16
towers, float32 where JAX keeps a float32 island (LayerNorm statistics,
softmax, the attention tap, PIR, the similarity and cost matrices, EMD,
Grad-CAM's image-text logits).  Values are held to JAX's own bf16 bar
(``tests/test_precision.py``): activations within 5 % of their largest
magnitude, attention statistics within 0.02 absolute.  The two sides
round at other places (XLA fuses bf16 chains and keeps float32
intermediates; PyTorch rounds after each op), so nothing tighter holds.

``route`` "plain" runs both packages' default attention paths; "kernels"
runs JAX's Pallas kernels in interpret mode and the port with both kernel
switches on (the kernels' plain versions, on these CPU tensors).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.core import imaging
from mars_tpu.models import clip as jclip, convert as jconvert, dinov2 as jdino
from mars_tpu.models import layers as jL, sam as jsam
from mars_tpu.models.precision import cast_floating as jcast
from mars_tpu.pipeline import amg as jamg, matcher as jmatcher, vta as jvta
from mars_tpu_torch.models import clip as tclip, convert as tconvert, dinov2 as tdino
from mars_tpu_torch.models import layers as tL, sam as tsam
from mars_tpu_torch.models.precision import cast_floating as tcast
from mars_tpu_torch.pipeline import amg as tamg, matcher as tmatcher, vta as tvta

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REL = 0.05  # activations: max |Δ| / max |x|
ATTN_ATOL = 0.02  # attention statistics, probabilities


def _load(name):
    data = np.load(os.path.join(FIXTURES, name + ".npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd.")}


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _both(jtree):
    """One float32 tree → (JAX bf16 tree, port bf16 tree), each cast by its
    own package."""
    return jcast(jtree), tcast(tconvert.from_jax_params(jax.tree.map(np.asarray, jtree)))


@pytest.fixture
def route(request, monkeypatch):
    if request.param == "kernels":
        monkeypatch.setenv(tL.NOTAP_IMPL_ENV, "pallas")
        monkeypatch.setenv(tsam.WINDOWED_IMPL_ENV, "pallas")
        jL.set_attention_impl("pallas_interpret")
    yield request.param
    jL.set_attention_impl("auto")


def _same(name, j, t, rel=REL, atol=None):
    assert str(t.dtype).replace("torch.", "") == str(j.dtype), (name, t.dtype, j.dtype)
    jf, tf = np.asarray(j, np.float32), t.detach().float().numpy()
    assert jf.shape == tf.shape, (name, jf.shape, tf.shape)
    err = np.abs(jf - tf).max() if jf.size else 0.0
    bar = atol if atol is not None else rel * max(np.abs(jf).max(), 1e-6)
    assert err <= bar, (name, err, bar)


@pytest.fixture(scope="module")
def towers():
    sd, d = _load("golden_episode_tiny")
    clip_sd = _sub(sd, "clip.")
    return dict(
        dino=_both(jconvert.dinov2_to_flax(_sub(sd, "dino."), depth=3, num_register_tokens=4)),
        clip_v=_both(jconvert.clip_visual_to_flax(clip_sd, depth=3)),
        ac_v=_both(jconvert.alpha_clip_visual_to_flax(_sub(sd, "aclip."), depth=2)),
        scale=np.float32(clip_sd["logit_scale"]),
        query=np.ascontiguousarray(d["query_image"][0].transpose(1, 2, 0)),
        support=np.ascontiguousarray(d["support_images"][0].transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("route", ["plain", "kernels"], indirect=True)
def test_dinov2_forward_features(towers, route):
    jp, tp = towers["dino"]
    kw = dict(patch_size=14, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
              pos_embed_grid=8)
    x = towers["support"]
    want = jdino.forward_features(jp, jnp.asarray(x), jdino.DinoV2Config(**kw), attn_tap_last_n=2)
    got = tdino.forward_features(tp, torch.from_numpy(x), tdino.DinoV2Config(**kw),
                                 attn_tap_last_n=2)
    assert want["x_prenorm"].dtype == jnp.bfloat16
    for key in ("x_prenorm", "x_norm_clstoken", "x_norm_patchtokens"):
        _same(key, want[key], got[key])
    _same("attn_mean", want["attn_mean"], got["attn_mean"], atol=ATTN_ATOL)


@pytest.mark.parametrize("route", ["plain", "kernels"], indirect=True)
def test_clip_prefinal_and_gradcam(towers, route):
    """CLIP-B's prefinal blocks (the first untapped) and the Grad-CAM head:
    bf16 activations and CAM, float32 image-text probabilities (JAX
    promotes the bf16 image embedding against the float32 logit scale and
    text features) and attention statistics."""
    jp, tp = towers["clip_v"]
    kw = dict(patch_size=16, width=64, depth=3, num_heads=1, output_dim=16, pos_embed_grid=7)
    jcfg, tcfg = jclip.ClipVisualConfig(**kw), tclip.ClipVisualConfig(**kw)
    img = imaging.resize(jnp.asarray(towers["query"]), (112, 112), "bicubic")
    img = np.asarray(imaging.normalize(img, imaging.CLIP_MEAN, imaging.CLIP_STD))[None]
    jx = jclip.visual_embed(jp, jnp.asarray(img), jcfg)
    tx = tclip.visual_embed(tp, torch.from_numpy(img), tcfg)
    _same("embed", jx, tx)
    jt, ja = jclip.prefinal(jp, jx, jcfg, 2)
    tt, ta = tclip.prefinal(tp, tx, tcfg, 2)
    _same("tokens", jt, tt)
    _same("attn_sum", ja, ta, atol=ATTN_ATOL)
    txt = np.random.RandomState(3).randn(2, 16).astype(np.float32)
    want = jclip.gradcam_last_block(jp, jt, jnp.asarray(txt), jnp.asarray(towers["scale"]), jcfg)
    got = tclip.gradcam_last_block(tp, tt, torch.from_numpy(txt), torch.tensor(towers["scale"]),
                                   tcfg)
    assert want[0].dtype == jnp.bfloat16 and want[1].dtype == jnp.float32
    assert float(jnp.abs(want[0]).max()) > 0  # a live CAM
    _same("cam", want[0], got[0])
    _same("probs", want[1], got[1], atol=ATTN_ATOL)
    _same("attn_last", want[2], got[2], atol=ATTN_ATOL)


def test_vta_prior(towers):
    jp, tp = towers["clip_v"]
    kw = dict(patch_size=16, width=64, depth=3, num_heads=1, output_dim=16, pos_embed_grid=7)
    vkw = dict(refinement_box_threshold=0.4, attn_tap_last_n=3, input_size=112, grid=7)
    txt = np.random.RandomState(3).randn(2, 16).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    q = towers["query"]
    want = jvta.compute(jp, jnp.asarray(q), jnp.asarray(txt), jnp.asarray(towers["scale"]),
                        jclip.ClipVisualConfig(**kw), jvta.VTAConfig(**vkw))
    got = tvta.compute(tp, torch.from_numpy(q), torch.from_numpy(txt),
                       torch.tensor(towers["scale"]), tclip.ClipVisualConfig(**kw),
                       tvta.VTAConfig(**vkw))
    assert float(jnp.abs(want).max()) > 0
    _same("vta", want, got)


@pytest.mark.parametrize("route", ["plain", "kernels"], indirect=True)
def test_alphaclip_visual_cls(towers, route):
    jp, tp = towers["ac_v"]
    kw = dict(patch_size=16, width=64, depth=2, num_heads=1, output_dim=16, pos_embed_grid=7,
              alpha_channel=True)
    rng = np.random.RandomState(3)
    img = rng.rand(3, 112, 112, 3).astype(np.float32)
    alpha = rng.randn(3, 112, 112).astype(np.float32)
    want = jclip.visual_cls(jp, jnp.asarray(img), jclip.ClipVisualConfig(**kw),
                            alpha=jnp.asarray(alpha))
    got = tclip.visual_cls(tp, torch.from_numpy(img), tclip.ClipVisualConfig(**kw),
                           alpha=torch.from_numpy(alpha))
    assert want.dtype == jnp.bfloat16
    _same("visual_cls", want, got)


@pytest.mark.parametrize("route", ["plain", "kernels"], indirect=True)
def test_sam_encoder(route):
    """The tiny SAM encoder with 3 × 3 windows over its 4 × 4 grid (so the
    windowed layers carry zero-padded border keys) and one global layer."""
    sd, d = _load("sam_tiny")
    jp, tp = _both(jconvert.sam_encoder_to_flax(sd, depth=3))
    img = np.ascontiguousarray(np.transpose(d["image"], (0, 2, 3, 1)))
    kw = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
              global_attn_indexes=(1,), window_size=3, out_chans=16)
    want = jsam.encode_image(jp, jnp.asarray(img), jsam.SamConfig(**kw))
    got = tsam.encode_image(tp, torch.from_numpy(img), tsam.SamConfig(**kw))
    assert want.dtype == jnp.bfloat16
    _same("embedding", want, got)


def test_matcher_output_dtypes():
    """The golden Matcher episode with bf16 DINOv2 and SAM: every output of
    generate_proposals has JAX's dtype (bf16 embedding, IoU predictions and
    low-res logits; float32 similarity, cost and scores), and the float32
    cost matrix agrees within bf16 feature rounding."""
    import test_torch_matcher as M

    sd, d = _load("golden_matcher_tiny")
    sam_sd = _sub(sd, "sam.")
    jsp, tsp = _both({"encoder": jconvert.sam_encoder_to_flax(sam_sd, depth=3),
                      "prompt_encoder": jconvert.sam_prompt_encoder_to_flax(sam_sd),
                      "decoder": jconvert.sam_decoder_to_flax(sam_sd)})
    jdp, tdp = _both(jconvert.dinov2_to_flax(_sub(sd, "dino."), depth=3, num_register_tokens=4))
    sup = np.ascontiguousarray(d["support_images"][0].transpose(0, 2, 3, 1))
    supm, qry = d["support_masks"][0], np.ascontiguousarray(d["query_image"][0].transpose(1, 2, 0))
    jout = jmatcher.generate_proposals(
        jax.random.PRNGKey(0), jdp, jdino.DinoV2Config(**M.DINO), jsp, jsam.SamConfig(**M.SAM),
        jamg.AmgConfig(**M.AMG), jmatcher.MatcherConfig(**M.MATCHER), jnp.asarray(sup),
        jnp.asarray(supm), jnp.ones((1,), bool), jnp.asarray(qry), fuse_programs=True, bucket=8)
    tout = tmatcher.generate_proposals(
        tdp, tdino.DinoV2Config(**M.DINO), tsp, tsam.SamConfig(**M.SAM), tamg.AmgConfig(**M.AMG),
        tmatcher.MatcherConfig(**M.MATCHER), torch.from_numpy(sup), torch.from_numpy(supm),
        torch.ones((1,), dtype=torch.bool), torch.from_numpy(qry),
        generator=torch.Generator().manual_seed(0), bucket=8)
    shared = sorted(set(tout) & set(jout) - {"telemetry"})
    assert {"embedding", "iou", "low_res_logits", "cost_matrix", "emd_score",
            "bucket_masks"} <= set(shared)
    for key in shared:
        assert str(tout[key].dtype).replace("torch.", "") == str(jout[key].dtype), key
    assert jout["embedding"].dtype == jnp.bfloat16 and jout["cost_matrix"].dtype == jnp.float32
    _same("cost_matrix", jout["cost_matrix"], tout["cost_matrix"], atol=5e-3)
    _same("embedding", jout["embedding"], tout["embedding"])
