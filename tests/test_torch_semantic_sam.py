"""The port's Semantic-SAM network (``models/semantic_sam.py``) and its
checkpoint loading (``convert.semantic_sam_*_tree``,
``zoo.build_semantic_sam``) against ``mars_tpu``.

  - the sine position and GroupNorm against JAX's and transformers'/torch's;
  - the pixel decoder against transformers' ``Mask2FormerPixelDecoder``
    (weights through the port's converter, in transformers' and MaskDINO's
    names) and against JAX's ``pixel_decoder``;
  - ``encode_image`` and ``predict_points`` (with and without
    ``return_embeddings``) against JAX's at ``SEMANTIC_SAM_TINY`` on seeded
    weights, one numpy tree fed to both packages;
  - a ``swinl_only_sam_many2many.pth``-layout file at the tiny config
    (Microsoft Swin names under ``backbone.``, a transformers pixel-decoder
    state dict under ``sem_seg_head.pixel_decoder.``, MaskDINO point-decoder
    names under ``sem_seg_head.predictor.``) loaded by both zoos: equal
    trees; a renamed, misshaped or unread key in a section raises in the
    port (the JAX zoo warns and keeps random weights).
  - the bf16-cast network (``--bf16``) against JAX's bf16 cast.
Tolerance: 3e-5 absolute, 1e-4 relative (float32), the JAX package's
oracle tolerance for these layers; bf16 as ``test_bf16_encode_and_predict``
states."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mars_tpu.models import convert as jconvert, semantic_sam as jss, zoo as jzoo
from mars_tpu_torch.models import convert as tconvert, semantic_sam as tss, zoo

ATOL, RTOL = 3e-5, 1e-4
BF16_ENCODE, BF16_DECODE = 0.05, 0.02  # bf16: of the largest magnitude
TINY = tss.SEMANTIC_SAM_TINY


def random_tree(shapes, rng):
    """Seeded numpy weights for a tree of shapes: norm scales near 1,
    kernels at 1/sqrt(fan-in), everything else at 0.5 (biases 0.1)."""
    out = {}
    for name, leaf in shapes.items():
        if isinstance(leaf, dict):
            out[name] = random_tree(leaf, rng)
        elif name == "scale":
            out[name] = (1.0 + 0.1 * rng.randn(*leaf)).astype(np.float32)
        elif name == "bias":
            out[name] = (0.1 * rng.randn(*leaf)).astype(np.float32)
        elif name == "kernel":
            fan_in = int(np.prod(leaf[:-1]))
            out[name] = (rng.randn(*leaf) / math.sqrt(fan_in)).astype(np.float32)
        else:
            out[name] = (0.5 * rng.randn(*leaf)).astype(np.float32)
    return out


def both(tree):
    """One numpy tree as JAX arrays and as the port's tensors."""
    return jax.tree.map(jnp.asarray, tree), tconvert.from_jax_params(tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _bf16_close(got, want, rel):
    """JAX's type and shape; max |diff| within ``rel`` of max |want|."""
    assert str(got.dtype).replace("torch.", "") == str(want.dtype), (got.dtype, want.dtype)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.fixture(scope="module")
def tiny():
    tree = random_tree(tss.param_shapes(TINY), np.random.RandomState(0))
    jparams, params = both(tree)
    image = np.random.RandomState(1).randn(TINY.input_size, TINY.input_size, 3).astype(
        np.float32)
    jmem, jfeats = jss.encode_image(jparams, jnp.asarray(image), jss.SEMANTIC_SAM_TINY)
    return tree, jparams, params, image, np.asarray(jmem), np.asarray(jfeats)


def test_configs_and_shapes_equal_jax():
    for name in ("SEMANTIC_SAM_L", "SEMANTIC_SAM_TINY"):
        got, want = getattr(tss, name), getattr(jss, name)
        assert got.swin.__dict__ == want.swin.__dict__
        assert {k: v for k, v in got.__dict__.items() if k != "swin"} == \
            {k: v for k, v in want.__dict__.items() if k != "swin"}
    for size in (640, 518, 100, 64):
        assert tss.feature_shapes(tss.SEMANTIC_SAM_L, size, size) == \
            tuple(jss.feature_shapes(jss.SEMANTIC_SAM_L, size, size))
    assert tss.feature_shapes(tss.SEMANTIC_SAM_L, 640, 640) == ((20, 20), (40, 40), (80, 80))


@pytest.mark.parametrize("name", ["SEMANTIC_SAM_TINY", "SEMANTIC_SAM_L"])
def test_param_shapes_are_jax_init_tree(name):
    want = jax.eval_shape(lambda: jss.init_params(jax.random.PRNGKey(0), getattr(jss, name)))
    want = tconvert.leaf_shapes(jax.tree.map(lambda a: tuple(a.shape), want))
    assert tconvert.leaf_shapes(tss.param_shapes(getattr(tss, name))) == want
    sections = tss.section_shapes(getattr(tss, name))
    assert sum(len(tconvert.leaf_shapes(t)) for t in sections.values()) == len(want)
    if name == "SEMANTIC_SAM_L":  # SwinL's ~197 M parameters, the decoders' ~13 M
        n = sum(math.prod(s) for s in tconvert.leaf_shapes(sections["backbone"]).values())
        assert 190e6 < n < 200e6


def test_sine_position_equals_jax_and_mask2former():
    from transformers.models.mask2former.modeling_mask2former import (
        Mask2FormerSinePositionEmbedding)

    h, w, dim = 5, 7, 32
    want = Mask2FormerSinePositionEmbedding(num_pos_feats=dim // 2, normalize=True)(
        torch.Size((1, dim, h, w)), "cpu", torch.float32)[0].permute(1, 2, 0).reshape(h * w, dim)
    grid = tss._pos_grid(h, w)
    np.testing.assert_array_equal(grid, jss._pos_grid(h, w))
    np.testing.assert_array_equal(tss._level_grid(h, w), jss._level_grid(h, w))
    got = tss._sine_embed_2d(torch.from_numpy(grid), dim)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    _close(got, jss._sine_embed_2d(jnp.asarray(grid), dim))


def test_group_norm_equals_jax_and_torch():
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 5, 7, 64) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.randn(64)).astype(np.float32),
         "bias": (0.1 * rng.randn(64)).astype(np.float32)}
    jp, tp = both(p)
    got = tss._group_norm(tp, torch.from_numpy(x))
    _close(got, jss._group_norm(jp, jnp.asarray(x)))
    want = F.group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), 32, tp["scale"], tp["bias"])
    _close(got, want.permute(0, 2, 3, 1))
    assert tss._group_norm(tp, torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def maskdino_names(sd):
    """transformers Mask2FormerPixelDecoder names → detectron2/MaskDINO's
    (the layout under sem_seg_head.pixel_decoder. in Semantic-SAM files)."""
    prefixes = (("level_embed", "transformer.level_embed"), ("input_projections.", "input_proj."),
                ("encoder.layers.", "transformer.encoder.layers."),
                ("adapter_1.0.", "adapter_1."), ("adapter_1.1.", "adapter_1.norm."),
                ("layer_1.0.", "layer_1."), ("layer_1.1.", "layer_1.norm."),
                ("mask_projection", "mask_features"))
    inner = (("self_attn_layer_norm", "norm1"), ("final_layer_norm", "norm2"),
             (".fc1.", ".linear1."), (".fc2.", ".linear2."))
    out = {}
    for k, v in sd.items():
        for a, b in prefixes:
            if k.startswith(a):
                k = b + k[len(a):]
        for a, b in inner:
            k = k.replace(a, b)
        out[k] = v
    return out


def mask2former_pixel_decoder(hidden, heads, ffn, enc_layers, channels, points, seed):
    """A transformers Mask2FormerPixelDecoder with every parameter drawn
    (level_embed ships uninitialised), its deformable layers at ``points``
    sampling points."""
    from transformers import Mask2FormerConfig
    from transformers.models.mask2former import modeling_mask2former as m2f

    torch.manual_seed(seed)
    cfg = Mask2FormerConfig(feature_size=hidden, mask_feature_size=hidden,
                            num_attention_heads=heads, encoder_feedforward_dim=ffn, dropout=0.0,
                            encoder_layers=enc_layers, common_stride=4,
                            feature_strides=[4, 8, 16, 32])
    dec = m2f.Mask2FormerPixelDecoder(cfg, channels).eval()
    for layer in dec.encoder.layers:
        layer.self_attn = m2f.Mask2FormerPixelDecoderEncoderMultiscaleDeformableAttention(
            hidden, heads, 3, points)
    with torch.no_grad():
        for p in dec.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    return dec


@pytest.mark.parametrize("dialect", ["transformers", "maskdino"])
def test_pixel_decoder_equals_mask2former_and_jax(dialect):
    """The whole pixel decoder: level order, input projections, sine and
    level embeddings, the deformable encoder, the FPN tail, the mask
    projection (transformers builds its layers at 4 points)."""
    c, enc_layers, channels = 32, 2, [8, 12, 16, 24]
    dec = mask2former_pixel_decoder(c, 4, 64, enc_layers, channels, 4, seed=5)
    g = torch.Generator().manual_seed(6)
    sizes = [(16, 16), (8, 8), (4, 4), (2, 2)]  # res2..res5
    features = [torch.randn(1, ch, h, w, generator=g) for ch, (h, w) in zip(channels, sizes)]
    with torch.no_grad():
        want = dec(features)
    sd = {k: v.numpy() for k, v in dec.state_dict().items()}
    if dialect == "maskdino":
        sd = maskdino_names(sd)
        assert "transformer.encoder.layers.0.linear1.weight" in sd
        assert "mask_features.weight" in sd and "adapter_1.norm.weight" in sd
    tree = tconvert.semantic_sam_pixel_decoder_tree(sd, enc_layers)
    jax.tree.map(np.testing.assert_array_equal, tree, jax.tree.map(
        np.asarray, jconvert.semantic_sam_pixel_decoder_to_flax(sd, enc_layers)))
    cfg = dict(hidden=c, num_heads=4, enc_layers=enc_layers, ffn_dim=64, num_points=4)
    feats = {f"stage{i}": features[i].permute(0, 2, 3, 1).contiguous() for i in range(4)}
    memory, mask_feats = tss.pixel_decoder(tconvert.from_jax_params(tree), feats,
                                           tss.SemanticSamConfig(**cfg))
    start = 0
    for (h, w), lvl in zip([(2, 2), (4, 4), (8, 8)], want.multi_scale_features):
        _close(memory[0, start:start + h * w], lvl[0].permute(1, 2, 0).reshape(-1, c))
        start += h * w
    _close(mask_feats[0], want.mask_features[0].permute(1, 2, 0))
    jmem, jfeats = jax.jit(jss.pixel_decoder, static_argnums=2)(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v.numpy()) for k, v in feats.items()},
        jss.SemanticSamConfig(**cfg))
    _close(memory, jmem)
    _close(mask_feats, jfeats)


def test_encode_image_equals_jax(tiny):
    _, _, params, image, jmem, jfeats = tiny
    memory, mask_feats = tss.encode_image(params, torch.from_numpy(image), TINY)
    s = TINY.input_size
    assert memory.shape == (1, sum(h * w for h, w in tss.feature_shapes(TINY, s, s)), 32)
    assert mask_feats.shape == (1, s // 4, s // 4, 32)
    _close(memory, jmem)
    _close(mask_feats, jfeats)


@pytest.mark.parametrize("return_embeddings", [False, True])
def test_predict_points_equals_jax(tiny, return_embeddings):
    """Five clicks (one on the border), each with its six granularity
    queries; both packages read JAX's encoding."""
    _, jparams, params, _, jmem, jfeats = tiny
    points = np.array([[0.3, 0.4], [0.9, 0.1], [0.0, 1.0], [0.5, 0.5], [0.71, 0.26]],
                      np.float32)
    shapes = tss.feature_shapes(TINY, TINY.input_size, TINY.input_size)
    got = tss.predict_points(params, torch.from_numpy(jmem), torch.from_numpy(jfeats),
                             torch.from_numpy(points), TINY, shapes,
                             return_embeddings=return_embeddings)
    want = jss.predict_points(jparams, jnp.asarray(jmem), jnp.asarray(jfeats),
                              jnp.asarray(points), jss.SEMANTIC_SAM_TINY, shapes=shapes,
                              return_embeddings=return_embeddings)
    g = TINY.num_granularities
    assert got[1].shape == (5, g)
    assert got[0].shape == ((5, g, 32) if return_embeddings else (5, g, 16, 16))
    for a, b in zip(got, want):
        _close(a, b)


def test_bf16_encode_and_predict(tiny):
    """``--bf16``: each package casts the same float32 tree with its own
    ``cast_floating``.  JAX's network then runs SwinL in bf16 and, through
    its float32 sine positions and clicks, both decoders in float32 with
    bf16 kernels: every output must have JAX's type.  Values: the encoding
    within ``BF16_ENCODE`` of its largest magnitude (JAX's bf16 bar, as in
    test_torch_bf16; measured <= 0.033 over three seeded trees), the point
    decoder on JAX's encoding within ``BF16_DECODE`` (measured <= 0.0072:
    its activations are float32 on both sides)."""
    from mars_tpu.models.precision import cast_floating as jcast
    from mars_tpu_torch.models.precision import cast_floating

    tree, _, _, image, _, _ = tiny
    jbf, bf = jcast(jax.tree.map(jnp.asarray, tree)), cast_floating(tconvert.from_jax_params(tree))
    assert bf["backbone"]["patch_embed"]["kernel"].dtype == torch.bfloat16
    jmem, jfeats = jss.encode_image(jbf, jnp.asarray(image), jss.SEMANTIC_SAM_TINY)
    memory, mask_feats = tss.encode_image(bf, torch.from_numpy(image), TINY)
    _bf16_close(memory, jmem, BF16_ENCODE)
    _bf16_close(mask_feats, jfeats, BF16_ENCODE)
    points = np.array([[0.3, 0.4], [0.9, 0.1], [0.0, 1.0], [0.5, 0.5], [0.71, 0.26]],
                      np.float32)
    shapes = tss.feature_shapes(TINY, TINY.input_size, TINY.input_size)
    for return_embeddings in (False, True):
        got = tss.predict_points(bf, torch.from_numpy(np.asarray(jmem)),
                                 torch.from_numpy(np.asarray(jfeats)), torch.from_numpy(points),
                                 TINY, shapes, return_embeddings=return_embeddings)
        want = jss.predict_points(jbf, jmem, jfeats, jnp.asarray(points), jss.SEMANTIC_SAM_TINY,
                                  shapes=shapes, return_embeddings=return_embeddings)
        for a, b in zip(got, want):
            _bf16_close(a, b, BF16_DECODE)


# --------------------------------------------------------------------------
# the checkpoint
# --------------------------------------------------------------------------

def _oihw(kernel):
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def swin_microsoft_sd(tree, depths):
    """A models.swin tree → Microsoft's names (the inverse of
    convert.swin_semantic_sam_tree)."""
    sd = {"patch_embed.proj.weight": _oihw(tree["patch_embed"]["kernel"]),
          "patch_embed.proj.bias": tree["patch_embed"]["bias"],
          "patch_embed.norm.weight": tree["patch_norm"]["scale"],
          "patch_embed.norm.bias": tree["patch_norm"]["bias"]}
    for s, depth in enumerate(depths):
        st = tree[f"stage{s}"]
        for i in range(depth):
            blk, b = st[f"block{i}"], f"layers.{s}.blocks.{i}"
            for ours, theirs in (("ln1", "norm1"), ("ln2", "norm2")):
                sd[f"{b}.{theirs}.weight"], sd[f"{b}.{theirs}.bias"] = (blk[ours]["scale"],
                                                                      blk[ours]["bias"])
            for ours, theirs in ((blk["attn"]["qkv"], "attn.qkv"),
                                 (blk["attn"]["proj"], "attn.proj"),
                                 (blk["mlp"]["fc1"], "mlp.fc1"), (blk["mlp"]["fc2"], "mlp.fc2")):
                sd[f"{b}.{theirs}.weight"] = np.ascontiguousarray(ours["kernel"].T)
                sd[f"{b}.{theirs}.bias"] = ours["bias"]
            sd[f"{b}.attn.relative_position_bias_table"] = blk["attn"]["rel_bias_table"]
        if "downsample" in st:
            ds = st["downsample"]
            sd[f"layers.{s}.downsample.norm.weight"] = ds["norm"]["scale"]
            sd[f"layers.{s}.downsample.norm.bias"] = ds["norm"]["bias"]
            sd[f"layers.{s}.downsample.reduction.weight"] = np.ascontiguousarray(
                ds["reduction"]["kernel"].T)
    return sd


def point_decoder_sd(tree, dec_layers):
    """The point-decoder subtree → MaskDINO names (the JAX package's
    test_audit_point_decoder_roundtrip layout)."""
    sd = {"query_feat.weight": tree["granularity_embed"]}
    for i in range(dec_layers):
        d, b = tree[f"dec{i}"], f"transformer.decoder.layers.{i}"
        sd[f"{b}.self_attn.in_proj_weight"] = np.ascontiguousarray(
            d["self_attn"]["qkv"]["kernel"].T)
        sd[f"{b}.self_attn.in_proj_bias"] = d["self_attn"]["qkv"]["bias"]
        sd[f"{b}.self_attn.out_proj.weight"] = np.ascontiguousarray(
            d["self_attn"]["proj"]["kernel"].T)
        sd[f"{b}.self_attn.out_proj.bias"] = d["self_attn"]["proj"]["bias"]
        for k in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
            sd[f"{b}.cross_attn.{k}.weight"] = np.ascontiguousarray(d["msda"][k]["kernel"].T)
            sd[f"{b}.cross_attn.{k}.bias"] = d["msda"][k]["bias"]
        for theirs, ours in (("norm2", "ln1"), ("norm1", "ln2"), ("norm3", "ln3")):
            sd[f"{b}.{theirs}.weight"], sd[f"{b}.{theirs}.bias"] = (d[ours]["scale"],
                                                                  d[ours]["bias"])
        for theirs, ours in (("linear1", "fc1"), ("linear2", "fc2")):
            sd[f"{b}.{theirs}.weight"] = np.ascontiguousarray(d["ffn"][ours]["kernel"].T)
            sd[f"{b}.{theirs}.bias"] = d["ffn"][ours]["bias"]
    for head, name in (("mask_embed", "mask_embed"), ("iou_head", "iou_prediction_head")):
        for j in range(3):
            sd[f"{name}.layers.{j}.weight"] = np.ascontiguousarray(
                tree[head][f"l{j}"]["kernel"].T)
            sd[f"{name}.layers.{j}.bias"] = tree[head][f"l{j}"]["bias"]
    return sd


def checkpoint_sd():
    """A swinl_only_sam_many2many.pth-layout state dict at the tiny config,
    with two keys outside the three sections (neither zoo reads them)."""
    shapes = tss.section_shapes(TINY)
    rng = np.random.RandomState(11)
    sd = {f"backbone.{k}": v for k, v in swin_microsoft_sd(
        random_tree(shapes["backbone"], rng), TINY.swin.depths).items()}
    dec = mask2former_pixel_decoder(TINY.hidden, TINY.num_heads, TINY.ffn_dim, TINY.enc_layers,
                                    [TINY.swin.stage_dim(i) for i in range(4)], TINY.num_points,
                                    seed=12)
    sd.update({f"sem_seg_head.pixel_decoder.{k}": v.numpy()
               for k, v in dec.state_dict().items()})
    sd.update({f"sem_seg_head.predictor.{k}": v for k, v in point_decoder_sd(
        random_tree(shapes["point_decoder"], rng), TINY.dec_layers).items()})
    sd["criterion.empty_weight"] = np.ones(3, np.float32)
    sd["sem_seg_head.class_embed"] = np.zeros((4, 4), np.float32)
    return sd


def _write(folder, sd):
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               str(folder / zoo.SEMANTIC_SAM_CHECKPOINT))
    return str(folder)


def test_checkpoint_loads_equal_jax(tmp_path):
    folder = _write(tmp_path, checkpoint_sd())
    params, cfg = zoo.build_semantic_sam(folder, "tiny", device="cpu")
    jparams, jcfg = jzoo.build_semantic_sam(folder, "tiny")
    assert cfg == TINY and jcfg == jss.SEMANTIC_SAM_TINY
    assert tconvert.leaf_shapes(params) == tconvert.leaf_shapes(tss.param_shapes(TINY))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                 params, jparams)
    image = torch.rand(TINY.input_size, TINY.input_size, 3, generator=torch.Generator()
                       .manual_seed(0))
    memory, _ = tss.encode_image(params, image, TINY)
    assert torch.isfinite(memory).all()


@pytest.mark.parametrize("section,key", [
    ("backbone", "backbone.layers.1.blocks.0.attn.qkv.weight"),
    ("pixel_decoder", "sem_seg_head.pixel_decoder.encoder.layers.1.fc2.bias"),
    ("point_decoder", "sem_seg_head.predictor.mask_embed.layers.2.weight"),
    ("point_decoder", "sem_seg_head.predictor.query_feat.weight")])
def test_checkpoint_renamed_key_raises(tmp_path, section, key):
    """A renamed key: the converter does not find the name it needs (or,
    for the optional granularity queries, the leaf is missing) and the
    renamed tensor is left unread."""
    sd = checkpoint_sd()
    sd[key.replace(".weight", ".renamed").replace(".bias", ".renamed")] = sd.pop(key)
    with pytest.raises((KeyError, ValueError)):
        zoo.build_semantic_sam(_write(tmp_path, sd), "tiny", device="cpu")


@pytest.mark.parametrize("key", ["sem_seg_head.pixel_decoder.level_embed",
                                 "backbone.layers.2.blocks.0.attn.relative_position_bias_table",
                                 "sem_seg_head.predictor.transformer.decoder.layers.0.norm3.bias"])
def test_checkpoint_misshaped_key_raises(tmp_path, key):
    sd = checkpoint_sd()
    sd[key] = np.zeros((sd[key].shape[0] + 1,) + sd[key].shape[1:], np.float32)
    with pytest.raises(ValueError, match="shape_mismatch"):
        zoo.build_semantic_sam(_write(tmp_path, sd), "tiny", device="cpu")


def test_checkpoint_unread_key_in_a_section_raises(tmp_path):
    sd = checkpoint_sd()
    sd["sem_seg_head.predictor.transformer.decoder.layers.0.extra_embed.weight"] = np.zeros(
        (3, 3), np.float32)
    with pytest.raises(ValueError, match="unconsumed"):
        zoo.build_semantic_sam(_write(tmp_path, sd), "tiny", device="cpu")


def test_random_weights_without_the_file(tmp_path):
    a, cfg = zoo.build_semantic_sam(str(tmp_path), "tiny", device="cpu")
    b, _ = zoo.build_semantic_sam(None, "tiny", device="cpu")
    assert cfg == TINY
    assert tconvert.leaf_shapes(a) == tconvert.leaf_shapes(tss.param_shapes(TINY))
    jax.tree.map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)
    assert float(a["backbone"]["patch_norm"]["scale"].min()) == 1.0
