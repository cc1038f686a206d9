"""The port's Swin backbone (``models/swin.py``) against ``mars_tpu.models.swin``
and the transformers ``SwinModel`` outputs stored in ``swin_tiny.npz`` (image
56, window 4: window padding, shift masks, an odd-size patch merge and, on a
12² crop, the window clamped below the table's), with the weights through
both of the port's converters: transformers' names (``swin_tree``) and
Microsoft's fused-qkv names (``swin_semantic_sam_tree``, the layout under
``backbone.`` in Semantic-SAM checkpoints).  Tolerance: 3e-5 absolute, 1e-4
relative (the JAX package's TestSwin)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import convert as jconvert, swin as jswin
from mars_tpu_torch.models import convert as tconvert, layers as tL, swin as tswin

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ATOL, RTOL = 3e-5, 1e-4
DEPTHS = (2, 2, 2)
CFG = dict(patch_size=4, embed_dim=24, depths=DEPTHS, num_heads=(2, 4, 8), window=4)


def microsoft_names(sd):
    """transformers SwinModel names → the Microsoft layout (fused qkv)."""
    out = {"patch_embed.proj.weight": sd["embeddings.patch_embeddings.projection.weight"],
           "patch_embed.proj.bias": sd["embeddings.patch_embeddings.projection.bias"],
           "patch_embed.norm.weight": sd["embeddings.norm.weight"],
           "patch_embed.norm.bias": sd["embeddings.norm.bias"]}
    for s, depth in enumerate(DEPTHS):
        for i in range(depth):
            h, m = f"encoder.layers.{s}.blocks.{i}", f"layers.{s}.blocks.{i}"
            for leaf in ("weight", "bias"):
                out[f"{m}.norm1.{leaf}"] = sd[f"{h}.layernorm_before.{leaf}"]
                out[f"{m}.norm2.{leaf}"] = sd[f"{h}.layernorm_after.{leaf}"]
                out[f"{m}.attn.qkv.{leaf}"] = np.concatenate(
                    [sd[f"{h}.attention.self.{n}.{leaf}"] for n in ("query", "key", "value")])
                out[f"{m}.attn.proj.{leaf}"] = sd[f"{h}.attention.output.dense.{leaf}"]
                out[f"{m}.mlp.fc1.{leaf}"] = sd[f"{h}.intermediate.dense.{leaf}"]
                out[f"{m}.mlp.fc2.{leaf}"] = sd[f"{h}.output.dense.{leaf}"]
            out[f"{m}.attn.relative_position_bias_table"] = \
                sd[f"{h}.attention.self.relative_position_bias_table"]
        ds = f"encoder.layers.{s}.downsample"
        if f"{ds}.reduction.weight" in sd:
            for leaf in ("norm.weight", "norm.bias", "reduction.weight"):
                out[f"layers.{s}.downsample.{leaf}"] = sd[f"{ds}.{leaf}"]
    return out


@pytest.fixture(scope="module")
def fixture():
    data = np.load(os.path.join(FIXTURES, "swin_tiny.npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    d = {k: data[k] for k in data.files if not k.startswith("sd.")}
    image = np.ascontiguousarray(d["input"].transpose(0, 2, 3, 1))
    jparams = jconvert.swin_to_flax(sd, depths=DEPTHS)
    return sd, d, image, jparams, tconvert.from_jax_params(tconvert.swin_tree(sd, DEPTHS))


@pytest.mark.parametrize("converter", ["transformers", "microsoft"])
def test_forward_equals_transformers_and_jax(fixture, converter):
    sd, d, image, jparams, params = fixture
    if converter == "microsoft":
        params = tconvert.from_jax_params(tconvert.swin_semantic_sam_tree(microsoft_names(sd),
                                                                         DEPTHS))
    cfg = tswin.SwinConfig(**CFG)
    got = tswin.forward_features(params, torch.from_numpy(image), cfg)
    want = jswin.forward_features(jparams, jnp.asarray(image), jswin.SwinConfig(**CFG))
    assert sorted(got) == sorted(want) == ["stage0", "stage1", "stage2"]
    for stage in got:
        assert got[stage].shape == want[stage].shape
        np.testing.assert_allclose(got[stage].numpy(), np.asarray(want[stage]), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(got["stage2"].reshape(2, -1, 96).numpy(), d["h3"], atol=ATOL,
                               rtol=RTOL)
    ln = {"scale": torch.from_numpy(sd["layernorm.weight"]),
          "bias": torch.from_numpy(sd["layernorm.bias"])}
    np.testing.assert_allclose(tL.layer_norm(ln, got["stage2"].reshape(2, -1, 96)).numpy(),
                               d["last_hidden"], atol=ATOL, rtol=RTOL)


def test_both_converters_equal_jaxs(fixture):
    """The port's two converters give one tree, leaf for leaf equal to the
    JAX package's converters."""
    sd, _, _, jparams, _ = fixture
    ms = microsoft_names(sd)
    trees = [tconvert.swin_tree(sd, DEPTHS), tconvert.swin_semantic_sam_tree(ms, DEPTHS),
             jax.tree.map(np.asarray, jparams),
             jax.tree.map(np.asarray, jconvert.swin_semantic_sam_to_flax(ms, DEPTHS))]
    want = tconvert.leaf_shapes(trees[0])
    for tree in trees[1:]:
        assert tconvert.leaf_shapes(tree) == want
        jax.tree.map(np.testing.assert_array_equal, trees[0], tree)


def test_patch_merge_chain(fixture):
    """The post-downsample states h1 and h2 from the pre-downsample maps,
    h2 through the odd-size pad (7 → 8)."""
    _, d, image, _, params = fixture
    cfg = tswin.SwinConfig(**CFG)
    out = tswin.forward_features(params, torch.from_numpy(image), cfg)
    m1 = tswin._patch_merge(params["stage0"]["downsample"], out["stage0"], cfg.ln_eps)
    np.testing.assert_allclose(m1.reshape(2, -1, 48).numpy(), d["h1"], atol=ATOL, rtol=RTOL)
    x = torch.nn.functional.pad(out["stage1"], (0, 0, 0, 1, 0, 1))
    m2 = tswin._patch_merge(params["stage1"]["downsample"], x, cfg.ln_eps)
    np.testing.assert_allclose(m2.reshape(2, -1, 96).numpy(), d["h2"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window,table", [(3, 8), (5, 8), (4, 4), (12, 12)])
def test_rel_index_and_shift_mask_equal_jax(window, table):
    """A clamped window keeps the table's (2·table - 1) stride."""
    np.testing.assert_array_equal(tswin._rel_index(window, table), jswin._rel_index(window,
                                                                                    table))
    assert tswin._rel_index(window, table).max() < (2 * table - 1) ** 2
    h = 3 * window
    np.testing.assert_array_equal(tswin._shift_mask(h, h, window, window // 2 or 1),
                                  jswin._shift_mask(h, h, window, window // 2 or 1))


def test_clamped_window_forward_equals_jax(fixture):
    """A 12² crop: stage 0 is 3² < window 4, so the window clamps to 3 and
    reads the table laid out for 4."""
    _, _, image, jparams, params = fixture
    crop = np.ascontiguousarray(image[:, :12, :12])
    got = tswin.forward_features(params, torch.from_numpy(crop), tswin.SwinConfig(**CFG))
    want = jswin.forward_features(jparams, jnp.asarray(crop), jswin.SwinConfig(**CFG))
    for stage in got:
        np.testing.assert_allclose(got[stage].numpy(), np.asarray(want[stage]), atol=ATOL,
                                   rtol=RTOL)


def test_param_shapes_are_jax_init_tree():
    cfg = dict(embed_dim=16, depths=(1, 2, 1, 1), num_heads=(2, 2, 4, 4), window=4)
    want = tconvert.leaf_shapes(jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        lambda: jswin.init_params(jax.random.PRNGKey(0), jswin.SwinConfig(**cfg)))))
    assert tconvert.leaf_shapes(tswin.param_shapes(tswin.SwinConfig(**cfg))) == want
    assert tswin.SWIN_L == tswin.SwinConfig() and tswin.SWIN_L.__dict__ == jswin.SWIN_L.__dict__
