"""The port's dense AMG, crop pyramid and small-region cleanup, and the mask
helpers they use, against mars_tpu's on the same inputs, and the crop
pyramid against the reference SamAutomaticMaskGenerator's output
(``tests/fixtures/amg_multicrop_tiny.npz``, as tests/test_matcher.py reads
it).  Tolerances: bitwise for boxes, crop boxes, components, cleaned masks
and the crop pyramid's outputs; grid points within one float32 ulp (see
``test_grid_points_equal_jax``); the reference's masks at IoU > 0.98 each,
as JAX's own test asks; the helpers' float results at 1e-6.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.core import masks as jmasks
from mars_tpu.models import convert as jconvert, sam as jsam
from mars_tpu.ops import components as jcomp
from mars_tpu.pipeline import amg as jamg
from mars_tpu_torch.core import masks as tmasks
from mars_tpu_torch.models import convert as tconvert, sam as tsam
from mars_tpu_torch.ops import components as tcomp
from mars_tpu_torch.pipeline import amg as tamg

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "amg_multicrop_tiny.npz")
SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
           global_attn_indexes=(1,), window_size=2, out_chans=16, decoder_mlp_dim=32,
           decoder_heads=2)
# the fixture's generator settings (tests/test_matcher.py TestMultiCropAmg)
AMG = dict(points_per_side=4, decode_batch=16, pred_iou_thresh=0.0, stability_score_thresh=0.0,
           box_nms_thresh=0.5, crop_n_layers=1, crop_nms_thresh=0.5, multimask_output=True,
           output_layer=3)


@pytest.fixture(scope="module")
def multicrop():
    data = np.load(FIXTURE)
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    jparams = {"encoder": jconvert.sam_encoder_to_flax(sd, depth=3),
               "prompt_encoder": jconvert.sam_prompt_encoder_to_flax(sd),
               "decoder": jconvert.sam_decoder_to_flax(sd)}
    tparams = {"encoder": tconvert.from_reference_state_dict(sd, "sam_encoder", 3),
               "prompt_encoder": tconvert.from_reference_state_dict(sd, "sam_prompt_encoder"),
               "decoder": tconvert.from_reference_state_dict(sd, "sam_decoder")}
    img01 = data["image"].astype(np.float32) / 255.0
    jout = jamg.generate_multicrop(jparams, jnp.asarray(img01), jsam.SamConfig(**SAM),
                                   jamg.AmgConfig(**AMG), original_size=(64, 64))
    tout = tamg.generate_multicrop(tparams, torch.from_numpy(img01), tsam.SamConfig(**SAM),
                                   tamg.AmgConfig(**AMG), original_size=(64, 64))
    return data, (jparams, tparams, img01), {k: np.asarray(v) for k, v in jout.items()}, tout


@pytest.mark.parametrize("size,layers,ratio", [((64, 64), 1, 512 / 1500),
                                               ((518, 518), 1, 512 / 1500),
                                               ((480, 640), 2, 512 / 1500),
                                               ((333, 250), 3, 0.25)])
def test_crop_boxes_equal_jax(size, layers, ratio):
    assert tamg.generate_crop_boxes(size, layers, ratio) == \
        jamg.generate_crop_boxes(size, layers, ratio)


@pytest.mark.parametrize("n,size", [(4, (64, 64)), (32, (518, 518)), (16, (347, 347)),
                                    (7, (480, 640)), (1, (56, 56))])
def test_grid_points_equal_jax(n, size):
    """The float32 arithmetic of XLA's linspace; XLA:CPU's LLVM fuses its
    last multiply-add into an FMA, so an entry may differ by one float32
    ulp (bitwise at the fixture's 4 × 4 grid)."""
    got, want = tamg.grid_points(n, size).numpy(), np.asarray(jamg.grid_points(n, size))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    if n == 4:
        np.testing.assert_array_equal(got, want)


def test_generate_dense_slots(multicrop):
    """48 slots at 4 × 4 points × 3 multimask slots, the same validity and
    masks as JAX's sweep."""
    _, (jparams, tparams, img01), _, _ = multicrop
    scfg, cfg = jsam.SamConfig(**SAM), jamg.AmgConfig(**AMG)
    jout = jamg.generate_dense(jparams, jamg.encode_target(jparams, jnp.asarray(img01), scfg),
                               scfg, cfg, original_size=(64, 64))
    tcfg = tsam.SamConfig(**SAM)
    tout = tamg.generate_dense(tparams, tamg.encode_target(tparams, torch.from_numpy(img01), tcfg),
                               tcfg, tamg.AmgConfig(**AMG), original_size=(64, 64))
    assert tout["masks"].shape[0] == 48
    np.testing.assert_array_equal(tout["valid"].numpy(), np.asarray(jout["valid"]))
    np.testing.assert_array_equal(tout["masks"].numpy(), np.asarray(jout["masks"]))


def test_multicrop_matches_reference_fixture(multicrop):
    data, _, _, tout = multicrop
    valid = tout["valid"].numpy()
    got = tout["masks"].numpy()[valid]
    got = got[got.sum(axis=(1, 2)) > 0]  # empty masks stay valid on both sides
    want = data["masks"].astype(bool)
    want = want[want.sum(axis=(1, 2)) > 0]
    assert got.shape[0] == want.shape[0]
    iou = tmasks.mask_iou(torch.from_numpy(got), torch.from_numpy(want)).numpy()
    assert (iou.max(axis=0) > 0.98).all(), iou.max(axis=0)


def test_multicrop_equals_jax(multicrop):
    """Five crops (4 × 4 points at layer 0, 4 × 4 in each of the four layer-1
    crops, 3 slots each): validity, the valid masks, boxes, points and
    crop areas equal to JAX's."""
    _, _, jout, tout = multicrop
    valid = tout["valid"].numpy()
    assert valid.shape == (5 * 48,) and "low_res_logits" not in tout
    np.testing.assert_array_equal(valid, jout["valid"])
    for k in ("masks", "boxes", "points", "crop_area"):
        np.testing.assert_array_equal(tout[k].numpy()[valid], jout[k][valid], err_msg=k)


def _random_masks(seed, n=6, h=40, w=36):
    rng = np.random.RandomState(seed)
    blobs = rng.rand(n, h // 4, w // 4) < 0.45
    masks = np.repeat(np.repeat(blobs, 4, axis=1), 4, axis=2)
    return masks ^ (rng.rand(n, h, w) < 0.04)  # speckle: tiny islands and holes


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode_holes", [True, False])
@pytest.mark.parametrize("area", [3, 30, 5000])
def test_remove_small_regions_bitwise_equal_jax(seed, mode_holes, area):
    """area 5000 puts every region under the threshold: islands mode keeps
    the largest (the first of equal ones, as cv2's label order)."""
    masks = _random_masks(seed)
    got_m, got_c = tcomp.remove_small_regions(torch.from_numpy(masks), float(area), mode_holes)
    for i, m in enumerate(masks):
        want_m, want_c = jcomp.remove_small_regions(jnp.asarray(m), float(area), mode_holes)
        np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(want_m))
        assert bool(got_c[i]) == bool(want_c)


def test_keep_largest_breaks_ties_like_cv2():
    """Two islands of equal size: the one whose first pixel comes first in
    row-major order stays."""
    m = np.zeros((12, 12), bool)
    m[7:9, 1:3] = True  # first pixel at (7, 1)
    m[2:4, 8:10] = True  # first pixel at (2, 8): earlier
    got, changed = tcomp.remove_small_regions(torch.from_numpy(m), 10.0, False)
    want, want_changed = jcomp.remove_small_regions(jnp.asarray(m), 10.0, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy()[2:4, 8:10].all() and not got.numpy()[7:9, 1:3].any()
    assert bool(changed) == bool(want_changed)


def test_postprocess_small_regions_equal_jax(monkeypatch):
    """Cleaned masks, their boxes and the re-NMS (changed masks scored 0)
    equal to JAX's on every live slot, four live masks a batch; dead slots
    stay dead."""
    monkeypatch.setattr(tamg, "CLEANUP_CHUNK", 4)
    masks = _random_masks(3, n=8)
    valid = np.array([1, 1, 1, 0, 1, 1, 0, 1], bool)
    data = {"masks": masks, "boxes": np.zeros((8, 4), np.float32),
            "iou": np.linspace(0.5, 0.9, 8).astype(np.float32), "valid": valid}
    want = jamg.postprocess_small_regions({k: jnp.asarray(v) for k, v in data.items()},
                                          min_area=20, nms_thresh=0.7)
    got = tamg.postprocess_small_regions({k: torch.from_numpy(v) for k, v in data.items()},
                                         min_area=20, nms_thresh=0.7)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["masks"].numpy()[valid], np.asarray(want["masks"])[valid])
    np.testing.assert_array_equal(got["boxes"].numpy()[valid], np.asarray(want["boxes"])[valid])
    assert not got["masks"].numpy()[valid].__eq__(masks[valid]).all()  # something was cleaned


def test_mask_helpers_equal_jax():
    rng = np.random.RandomState(0)
    a, b = rng.rand(5, 20, 24) > 0.6, rng.rand(3, 20, 24) > 0.4
    np.testing.assert_allclose(tmasks.mask_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jmasks.mask_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    boxes = rng.randint(0, 100, (40, 4)).astype(np.float32)
    crop, orig = (10, 20, 70, 90), (0, 0, 100, 100)
    np.testing.assert_array_equal(
        tmasks.is_box_near_crop_edge(torch.from_numpy(boxes), crop, orig).numpy(),
        np.asarray(jmasks.is_box_near_crop_edge(jnp.asarray(boxes), crop, orig)))
    np.testing.assert_array_equal(
        tmasks.uncrop_boxes_xyxy(torch.from_numpy(boxes), crop).numpy(),
        np.asarray(jmasks.uncrop_boxes_xyxy(jnp.asarray(boxes), crop)))
    pts = boxes[:, :2].copy()
    np.testing.assert_array_equal(tmasks.uncrop_points(torch.from_numpy(pts), crop).numpy(),
                                  np.asarray(jmasks.uncrop_points(jnp.asarray(pts), crop)))
    m = rng.rand(2, 70, 60) > 0.5  # a 60 × 70 crop of a 100 × 100 image
    for cb in (crop, (0, 0, 100, 100)):
        src = m if cb == crop else rng.rand(2, 100, 100) > 0.5
        np.testing.assert_array_equal(
            tmasks.uncrop_masks(torch.from_numpy(src), cb, 100, 100).numpy(),
            np.asarray(jmasks.uncrop_masks(jnp.asarray(src), cb, 100, 100)))
    vals = rng.rand(4, 9).astype(np.float32)
    sel = rng.rand(4, 9) > 0.5
    for axis in (None, 1):
        np.testing.assert_allclose(
            tmasks.masked_mean(torch.from_numpy(vals), torch.from_numpy(sel), axis=axis).numpy(),
            np.asarray(jmasks.masked_mean(jnp.asarray(vals), jnp.asarray(sel), axis=axis)),
            rtol=1e-6)
    prior = rng.rand(8, 8).astype(np.float32)
    props = (rng.rand(5, 8, 8) > 0.5).astype(np.float32)
    sup = (rng.rand(8, 8) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        tmasks.coverage_and_prior_scores(torch.from_numpy(prior), torch.from_numpy(props),
                                         torch.from_numpy(sup), 0.85).numpy(),
        np.asarray(jmasks.coverage_and_prior_scores(jnp.asarray(prior), jnp.asarray(props),
                                                    jnp.asarray(sup), 0.85)), rtol=1e-6)
