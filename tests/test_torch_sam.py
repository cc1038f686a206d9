"""The port's SAM (grid attention, encoder, prompt encoder, decoder, mask
geometry) against mars_tpu on the same inputs and weights.

JAX's grid attention kernel runs in Pallas interpret mode, as its own tests
run it; the port takes the kernel's plain version on these CPU tensors.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.core import masks as jmasks
from mars_tpu.models import convert as jconvert, layers as jL, sam as jsam
from mars_tpu.ops import sam_attention as jsa
from mars_tpu.pipeline import amg as jamg
from mars_tpu_torch.core import masks as tmasks
from mars_tpu_torch.models import convert as tconvert, sam as tsam
from mars_tpu_torch.ops import sam_attention as tsa
from mars_tpu_torch.pipeline import amg as tamg

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ATOL = 1e-4
TINY = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
            global_attn_indexes=(1,), window_size=2, out_chans=16, decoder_mlp_dim=32,
            decoder_heads=2)


def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


@pytest.mark.parametrize("h,w", [(5, 7), (16, 16)])
def test_grid_attention_plain_matches_pallas(h, w):
    rng = np.random.RandomState(0)
    nh, l, d = 2, h * w, 24
    q, k, v = (rng.randn(nh, l, d).astype(np.float32) for _ in range(3))
    bh = rng.randn(nh, l, h).astype(np.float32)
    bw = rng.randn(nh, l, w).astype(np.float32)
    want = jsa.grid_attention_pallas(*map(jnp.asarray, (q, k, v, bh, bw)), (h, w),
                                     interpret=True)
    got = tsa.grid_attention(*map(torch.from_numpy, (q, k, v, bh, bw)), (h, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_global_layer_matches_jax():
    """``_grid_attention`` on a 32 × 32 global grid: the port through its
    kernel wrapper, JAX through its Pallas kernel (interpret mode)."""
    rng = np.random.RandomState(1)
    b, h, w, c, nh = 1, 32, 32, 48, 2
    hd = c // nh
    x = rng.randn(b, h, w, c).astype(np.float32)
    p = {"qkv": {"kernel": rng.randn(c, 3 * c).astype(np.float32) * 0.05,
                 "bias": rng.randn(3 * c).astype(np.float32) * 0.1},
         "proj": {"kernel": rng.randn(c, c).astype(np.float32) * 0.05,
                  "bias": np.zeros((c,), np.float32)},
         "rel_pos_h": rng.randn(2 * h - 1, hd).astype(np.float32) * 0.1,
         "rel_pos_w": rng.randn(2 * w - 1, hd).astype(np.float32) * 0.1}
    jL.set_attention_impl("pallas_interpret")
    try:
        want = jsam._grid_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), nh,
                                    allow_pallas=True)
    finally:
        jL.set_attention_impl("auto")
    tp = tconvert.from_jax_params(p)
    got = tsam._grid_attention(tp, torch.from_numpy(x), nh, route="global")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    plain = tsam._grid_attention(tp, torch.from_numpy(x), nh)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("size", [3, 20])
def test_rel_pos_table_resize_matches_jax(size):
    """A table of another length is resampled linearly (jax.image)."""
    table = np.random.RandomState(2).randn(9, 4).astype(np.float32)
    want = jsam._rel_pos_table(jnp.asarray(table), size, size)
    got = tsam._rel_pos_table(torch.from_numpy(table), size, size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def sam_tiny():
    data = np.load(os.path.join(FIXTURES, "sam_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}
    jparams = {"encoder": jconvert.sam_encoder_to_flax(sd, depth=3),
               "prompt_encoder": jconvert.sam_prompt_encoder_to_flax(sd),
               "decoder": jconvert.sam_decoder_to_flax(sd)}
    ref = {"encoder": tconvert.from_reference_state_dict(sd, "sam_encoder", 3),
           "prompt_encoder": tconvert.from_reference_state_dict(sd, "sam_prompt_encoder"),
           "decoder": tconvert.from_reference_state_dict(sd, "sam_decoder")}
    from_jax = tconvert.from_jax_params(jax.tree.map(np.asarray, jparams))
    return d, jparams, {"reference": ref, "jax": from_jax}


@pytest.mark.parametrize("source", ["reference", "jax"])
def test_encoder_matches_jax_and_fixture(sam_tiny, source):
    d, jp, tp = sam_tiny
    img = _nhwc(d["image"])
    want = np.asarray(jsam.encode_image(jp["encoder"], jnp.asarray(img), jsam.SamConfig(**TINY)))
    got = tsam.encode_image(tp[source]["encoder"], torch.from_numpy(img),
                            tsam.SamConfig(**TINY)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _nhwc(d["embedding"]), atol=ATOL, rtol=0)


@pytest.mark.parametrize("source", ["reference", "jax"])
def test_prompt_encoder_matches_jax(sam_tiny, source):
    d, jp, tp = sam_tiny
    jpe, tpe = jp["prompt_encoder"], tp[source]["prompt_encoder"]
    coords, labels, boxes = d["coords"], d["labels"], d["boxes"]
    for pad in (True, False):
        want = jsam.embed_points(jpe, jnp.asarray(coords), jnp.asarray(labels), (64, 64), pad)
        got = tsam.embed_points(tpe, torch.from_numpy(coords), torch.from_numpy(labels),
                                (64, 64), pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tsam.embed_boxes(tpe, torch.from_numpy(boxes), (64, 64)).numpy(),
        np.asarray(jsam.embed_boxes(jpe, jnp.asarray(boxes), (64, 64))), atol=ATOL, rtol=0)
    mask_in = d["mask_in"][:, 0]
    np.testing.assert_allclose(
        tsam.embed_mask_input(tpe, torch.from_numpy(mask_in)).numpy(),
        np.asarray(jsam.embed_mask_input(jpe, jnp.asarray(mask_in))), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tsam.dense_pe(tpe, (4, 4)).numpy(),
                               np.asarray(jsam.dense_pe(jpe, (4, 4))), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tsam.no_mask_dense(tpe, (4, 4)).numpy(),
                               np.asarray(jsam.no_mask_dense(jpe, (4, 4))), atol=0, rtol=0)


@pytest.mark.parametrize("source", ["reference", "jax"])
def test_decoder_matches_jax(sam_tiny, source):
    """Point prompts with a padded (masked) slot, then box + mask prompts."""
    d, jp, tp = sam_tiny
    jcfg, tcfg = jsam.SamConfig(**TINY), tsam.SamConfig(**TINY)
    emb = _nhwc(d["embedding"])[0]
    jpe, tpe = jp["prompt_encoder"], tp[source]["prompt_encoder"]
    coords = np.concatenate([d["coords"], d["coords"] * 0.5])
    labels = np.concatenate([d["labels"], np.array([[1, 0, -1]], np.int32)]).astype(np.int32)
    valid = np.concatenate([labels != -1, np.ones((2, 1), bool)], axis=1)
    j_sp = jsam.embed_points(jpe, jnp.asarray(coords), jnp.asarray(labels), (64, 64), True)
    t_sp = tsam.embed_points(tpe, torch.from_numpy(coords), torch.from_numpy(labels), (64, 64),
                             True)
    for j_dense, t_dense in (
            (None, None),
            (jsam.embed_mask_input(jpe, jnp.asarray(d["mask_in"][:, 0].repeat(2, 0))),
             tsam.embed_mask_input(tpe, torch.from_numpy(d["mask_in"][:, 0].repeat(2, 0))))):
        jm, ji = jsam.decode_masks(jp["decoder"], jnp.asarray(emb), jsam.dense_pe(jpe, (4, 4)),
                                   j_sp, j_dense, jcfg, sparse_valid=jnp.asarray(valid))
        tm, ti = tsam.decode_masks(tp[source]["decoder"], torch.from_numpy(emb),
                                   tsam.dense_pe(tpe, (4, 4)), t_sp, t_dense, tcfg,
                                   sparse_valid=torch.from_numpy(valid))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=0)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL, rtol=0)
    tm, ti = tsam.decode_masks(tp[source]["decoder"], torch.from_numpy(emb),
                               tsam.dense_pe(tpe, (4, 4)), t_sp[:1], None, tcfg)
    np.testing.assert_allclose(tm[:, :1].numpy(), d["masks_single"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(ti[:, :1].numpy(), d["iou_single"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("prompts", ["points", "box_and_mask"])
def test_decode_prompt_sets_matches_jax(sam_tiny, prompts):
    """Mixed-size prompt rows (label -1 pads), dead sets, three decode
    chunks, multimask layers 3..5, the AMG filters; optionally a box and a
    low-res mask prompt."""
    d, jp, tp = sam_tiny
    rng = np.random.RandomState(6)
    b, k = 9, 3
    coords = rng.uniform(0, 48, (b, k, 2)).astype(np.float32)
    labels = rng.randint(0, 2, (b, k)).astype(np.int32)
    labels[::2, 2] = -1
    set_valid = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool)
    emb = _nhwc(d["embedding"])[0]
    kw = dict(sel_pred_iou_thresh=0.0, sel_stability_score_thresh=0.5,
              sel_multimask_output=True, sel_output_layer=3, decode_batch=3)
    box = np.array([4.0, 6.0, 40.0, 30.0], np.float32) if prompts != "points" else None
    mask_in = d["mask_in"][0, 0] if prompts != "points" else None
    want = jamg.decode_prompt_sets(
        jp, jnp.asarray(emb), jnp.asarray(coords), jnp.asarray(labels), jnp.asarray(set_valid),
        jsam.SamConfig(**TINY), jamg.AmgConfig(**kw), original_size=(48, 48),
        box=None if box is None else jnp.asarray(box),
        mask_input=None if mask_in is None else jnp.asarray(mask_in),
        use_box=box is not None, use_mask_input=mask_in is not None)
    got = tamg.decode_prompt_sets(
        tp["jax"], torch.from_numpy(emb), torch.from_numpy(coords), torch.from_numpy(labels),
        torch.from_numpy(set_valid), tsam.SamConfig(**TINY), tamg.AmgConfig(**kw),
        original_size=(48, 48), box=None if box is None else torch.from_numpy(box),
        mask_input=None if mask_in is None else torch.from_numpy(mask_in))
    live = np.repeat(set_valid, 3)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["set_index"].numpy(), np.asarray(want["set_index"]))
    for key in ("low_res_logits", "iou", "stability", "boxes"):
        np.testing.assert_allclose(got[key].numpy()[live], np.asarray(want[key])[live],
                                   atol=ATOL, rtol=0, err_msg=key)
    agree = (got["masks"].numpy()[live] == np.asarray(want["masks"])[live]).mean()
    assert agree > 0.999, agree  # thresholding at 0 may flip a near-zero logit


@pytest.mark.parametrize("size,orig", [(64, (37, 37)), (64, (50, 30))])
def test_postprocess_masks_matches_jax(size, orig):
    logits = np.random.RandomState(3).randn(2, 1, 16, 16).astype(np.float32)
    want = jsam.postprocess_masks(jnp.asarray(logits), size, orig)
    got = tsam.postprocess_masks(torch.from_numpy(logits), size, orig)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    coords = np.array([[3.0, 4.0], [36.0, 20.0]], np.float32)
    np.testing.assert_allclose(
        tsam.transform_coords(torch.from_numpy(coords), orig, size).numpy(),
        np.asarray(jsam.transform_coords(jnp.asarray(coords), orig, size)), atol=0, rtol=0)


def test_mask_geometry_matches_jax():
    rng = np.random.RandomState(4)
    logits = (rng.randn(6, 20, 24) * 3).astype(np.float32)
    logits[2] = -5.0  # an empty mask → box [0, 0, 0, 0]
    np.testing.assert_array_equal(
        tmasks.mask_to_box(torch.from_numpy(logits > 0)).numpy(),
        np.asarray(jmasks.mask_to_box(jnp.asarray(logits > 0))))
    np.testing.assert_array_equal(
        tmasks.stability_score(torch.from_numpy(logits), 0.0, 1.0).numpy(),
        np.asarray(jmasks.stability_score(jnp.asarray(logits), 0.0, 1.0)))
    boxes = rng.randint(0, 20, (7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tmasks.box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes[:5])).numpy(),
        np.asarray(jmasks.box_iou(jnp.asarray(boxes), jnp.asarray(boxes[:5]))), atol=1e-7)
