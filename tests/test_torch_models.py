"""The port's DINOv2 and CLIP towers against mars_tpu on shared weights.

Weights come from the tiny reference fixtures, converted once by
mars_tpu.models.convert and handed to the port through from_jax_params.
JAX runs with its tapped blocks on the Pallas kernel in interpret mode.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import clip as jclip
from mars_tpu.models import convert as jconvert
from mars_tpu.models import dinov2 as jdino
from mars_tpu.models import layers as jL
from mars_tpu_torch.models import clip as tclip
from mars_tpu_torch.models import convert as tconvert
from mars_tpu_torch.models import dinov2 as tdino

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ATOL = 1e-4


def _load(name):
    data = np.load(os.path.join(FIXTURES, name + ".npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd.")}


def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k


@pytest.fixture(scope="module")
def pallas_interpret():
    jL.set_attention_impl("pallas_interpret")
    yield
    jL.set_attention_impl("auto")


@pytest.fixture(scope="module")
def dino(pallas_interpret):
    sd, d = _load("dinov2_tiny")
    cfg_kw = dict(patch_size=14, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
                  pos_embed_grid=4)
    jparams = jconvert.dinov2_to_flax(sd, depth=3, num_register_tokens=4)
    return (sd, d, jdino.DinoV2Config(**cfg_kw), jparams, tdino.DinoV2Config(**cfg_kw),
            tconvert.from_jax_params(_np_tree(jparams)))


@pytest.mark.parametrize("image", ["input", "input70"])
def test_dinov2_forward_features(dino, image):
    _, d, jcfg, jparams, tcfg, tparams = dino
    x = _nhwc(d[image])
    want = jdino.forward_features(jparams, jnp.asarray(x), jcfg, attn_tap_last_n=2)
    got = tdino.forward_features(tparams, torch.from_numpy(x), tcfg, attn_tap_last_n=2)
    for key in ("x_prenorm", "attn_mean", "x_norm_patchtokens"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
    ref = {"input": "x_prenorm", "input70": "x_prenorm70"}[image]
    np.testing.assert_allclose(got["x_prenorm"].numpy(), d[ref], atol=2e-4, rtol=0)


def test_dinov2_converters_agree(dino):
    sd, _, _, _, _, tparams = dino
    _assert_same_tree(tconvert.from_reference_state_dict(sd, "dinov2", depth=3), tparams)


@pytest.fixture(scope="module")
def clip(pallas_interpret):
    sd, d = _load("clip_tiny")
    vkw = dict(patch_size=16, width=64, depth=3, num_heads=1, output_dim=16, pos_embed_grid=2)
    tkw = dict(context_length=77, vocab_size=100, width=16, depth=2, num_heads=2, output_dim=16)
    jv, jt = jconvert.clip_visual_to_flax(sd, depth=3), jconvert.clip_text_to_flax(sd, depth=2)
    return (sd, d, jclip.ClipVisualConfig(**vkw), jclip.ClipTextConfig(**tkw), jv, jt,
            tclip.ClipVisualConfig(**vkw), tclip.ClipTextConfig(**tkw),
            tconvert.from_jax_params(_np_tree(jv)), tconvert.from_jax_params(_np_tree(jt)))


def test_clip_prefinal_and_gradcam(clip):
    _, d, jvc, _, jv, _, tvc, _, tv, _ = clip
    img = _nhwc(d["image"])
    tf = d["text_feats"] / np.linalg.norm(d["text_feats"], axis=1, keepdims=True)
    scale = np.float32(d["logit_scale"])
    jx = jclip.visual_embed(jv, jnp.asarray(img), jvc)
    jtok, jsum = jclip.prefinal(jv, jx, jvc, attn_tap_last_n=3)
    jcam, jprobs, jlast = jclip.gradcam_last_block(jv, jtok, jnp.asarray(tf), jnp.asarray(scale),
                                                   jvc)
    tx = tclip.visual_embed(tv, torch.from_numpy(img), tvc)
    ttok, tsum = tclip.prefinal(tv, tx, tvc, attn_tap_last_n=3)
    tcam, tprobs, tlast = tclip.gradcam_last_block(tv, ttok, torch.from_numpy(tf),
                                                   torch.tensor(scale), tvc)
    for got, want in ((ttok, jtok), (tsum, jsum), (tcam, jcam), (tprobs, jprobs),
                      (tlast, jlast)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcam.numpy(), d["cam"], atol=2e-4, rtol=1e-3)


def test_clip_encode_text(clip):
    _, d, _, jtc, _, jt, _, ttc, _, tt = clip
    want = jclip.encode_text(jt, jnp.asarray(d["text_tokens"]), jtc)
    got = tclip.encode_text(tt, torch.from_numpy(d["text_tokens"]), ttc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_clip_converters_agree(clip):
    sd, _, _, _, _, _, _, _, tv, tt = clip
    _assert_same_tree(tconvert.from_reference_state_dict(sd, "clip_visual", depth=3), tv)
    _assert_same_tree(tconvert.from_reference_state_dict(sd, "clip_text", depth=2), tt)


def test_alpha_clip_visual_cls():
    sd, d = _load("alpha_clip_tiny")
    kw = dict(patch_size=16, width=64, depth=2, num_heads=1, output_dim=16, pos_embed_grid=2,
              alpha_channel=True)
    jv = jconvert.alpha_clip_visual_to_flax(sd, depth=2)
    tv = tconvert.from_jax_params(_np_tree(jv))
    _assert_same_tree(tconvert.from_reference_state_dict(sd, "alpha_clip_visual", depth=2), tv)
    img, alpha = _nhwc(d["image"]), np.ascontiguousarray(d["alpha"][:, 0])
    want = jclip.visual_cls(jv, jnp.asarray(img), jclip.ClipVisualConfig(**kw),
                            alpha=jnp.asarray(alpha))
    got = tclip.visual_cls(tv, torch.from_numpy(img), tclip.ClipVisualConfig(**kw),
                           alpha=torch.from_numpy(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), d["cls_emb"], atol=3e-5, rtol=1e-4)
