"""The port's zoo loads the reference's checkpoint files by name.

Each tower's tiny fixture state dict (tests/fixtures) is written under the
reference's file name in the formats the reference ships: a plain
``torch.save`` state dict, a ``{"model": ...}`` bundle, and a TorchScript
archive of nested modules named as OpenAI's CLIP names them.  The tiny
configs are patched into both packages' variant tables; the port's
``zoo.build_*(models_path=...)`` is held to the fixture's reference outputs
and to the JAX package's zoo fed the same file, with a clean audit.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import clip as jclip
from mars_tpu.models import convert as jconvert
from mars_tpu.models import dinov2 as jdino
from mars_tpu.models import sam as jsam
from mars_tpu.models import zoo as jzoo
from mars_tpu_torch.models import clip as tclip
from mars_tpu_torch.models import convert as tconvert
from mars_tpu_torch.models import dinov2 as tdino
from mars_tpu_torch.models import sam as tsam
from mars_tpu_torch.models import zoo

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
ATOL = 1e-4
DINO = dict(patch_size=14, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
            pos_embed_grid=4)
CLIP_V = dict(patch_size=16, width=64, depth=3, num_heads=1, output_dim=16, pos_embed_grid=2)
CLIP_T = dict(context_length=77, vocab_size=100, width=16, depth=2, num_heads=2, output_dim=16)
AC_V = dict(patch_size=16, width=64, depth=2, num_heads=1, output_dim=16, pos_embed_grid=2,
            alpha_channel=True)
AC_T = dict(context_length=12, vocab_size=100, width=16, depth=2, num_heads=2, output_dim=16)
SAM = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=2,
           global_attn_indexes=(1,), window_size=2, out_chans=16, decoder_mlp_dim=32,
           decoder_heads=2)
MASK_IN_CHANS = 8
JIT_SCALARS = {"input_resolution": 224, "context_length": 77, "vocab_size": 100}


def _load(name):
    data = np.load(os.path.join(FIXTURES, name + ".npz"))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd.")}
    return sd, {k: data[k] for k in data.files if not k.startswith("sd.")}


def _nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


class _Holder(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def save_torchscript(sd: dict, path: str, buffers=()):
    """A TorchScript archive whose state dict is ``sd``: nested modules
    named by the keys' dotted prefixes (``visual.transformer.resblocks.0
    .attn`` ...), each leaf a parameter, or a buffer for ``buffers``."""
    root = _Holder()
    for key, value in _tensors(sd).items():
        *path_parts, leaf = key.split(".")
        mod = root
        for part in path_parts:
            if not hasattr(mod, part):
                mod.add_module(part, _Holder())
            mod = getattr(mod, part)
        if key in buffers:
            mod.register_buffer(leaf, value)
        else:
            mod.register_parameter(leaf, torch.nn.Parameter(value, requires_grad=False))
    torch.jit.save(torch.jit.script(root), path)


def test_load_torch_state_dict_reads_every_format(tmp_path):
    """Plain state dict, ``{"model": ...}`` bundle and TorchScript archive
    give the same flat numpy dict; only the archive is detected as one."""
    sd, _ = _load("sam_tiny")
    want = {k: v for k, v in list(sd.items())[:20]}
    torch.save(_tensors(want), tmp_path / "plain.pth")
    torch.save({"model": _tensors(want), "epoch": 3}, tmp_path / "bundle.pth")
    save_torchscript(want, str(tmp_path / "archive.pt"))
    for name in ("plain.pth", "bundle.pth", "archive.pt"):
        got = zoo.load_torch_state_dict(str(tmp_path / name))
        assert got.keys() == want.keys(), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert zoo._is_torchscript(str(tmp_path / "archive.pt"))
    assert not zoo._is_torchscript(str(tmp_path / "plain.pth"))


def test_load_torch_state_dict_bfloat16_comes_back_float32(tmp_path):
    torch.save({"w": torch.ones(3, dtype=torch.bfloat16) / 3}, tmp_path / "bf16.pth")
    got = zoo.load_torch_state_dict(str(tmp_path / "bf16.pth"))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, (torch.ones(3, dtype=torch.bfloat16) / 3).float().numpy())


@pytest.mark.parametrize("variant,regs,name", [
    ("vit_small", 4, "dinov2_vits14_reg4_pretrain.pth"),
    ("vit_base", 4, "dinov2_vitb14_reg4_pretrain.pth"),
    ("vit_large", 4, "dinov2_vitl14_reg4_pretrain.pth"),
    ("vit_large", 0, "dinov2_vitl14_pretrain.pth"),
    ("vit_giant2", 4, "dinov2_vitg14_reg4_pretrain.pth"),
])
def test_reference_file_names(variant, regs, name):
    assert zoo.dinov2_checkpoint(variant, regs) == name


def test_variant_tables_equal_jax():
    for name, cfg in tdino.DINOV2_VARIANTS.items():
        assert cfg.__dict__ == jdino.DINOV2_VARIANTS[name].__dict__, name
    assert tdino.DINOV2_VARIANTS["vit_large"] == tdino.DinoV2Config()
    for name in ("CLIP_B16_VISUAL", "CLIP_L14_VISUAL", "CLIP_L14_TEXT",
                 "ALPHA_CLIP_L14_336_VISUAL", "ALPHA_CLIP_L14_TEXT"):
        assert getattr(tclip, name).__dict__ == getattr(jclip, name).__dict__, name
    assert zoo.SAM_CHECKPOINTS == {"vit_b": "sam_vit_b_01ec64.pth",
                                   "vit_l": "sam_vit_l_0b3195.pth",
                                   "vit_h": "sam_vit_h_4b8939.pth"}


@pytest.fixture
def tiny_tables(monkeypatch):
    monkeypatch.setitem(tdino.DINOV2_VARIANTS, "vit_large", tdino.DinoV2Config(**DINO))
    monkeypatch.setitem(jdino.DINOV2_VARIANTS, "vit_large", jdino.DinoV2Config(**DINO))
    for mod in (tclip, jclip):
        monkeypatch.setattr(mod, "CLIP_B16_VISUAL", mod.ClipVisualConfig(**CLIP_V))
        monkeypatch.setattr(mod, "CLIP_B16_TEXT", mod.ClipTextConfig(**CLIP_T))
        monkeypatch.setattr(mod, "ALPHA_CLIP_L14_336_VISUAL", mod.ClipVisualConfig(**AC_V))
        monkeypatch.setattr(mod, "ALPHA_CLIP_L14_TEXT", mod.ClipTextConfig(**AC_T))
    monkeypatch.setitem(tsam.SAM_VARIANTS, "vit_b", tsam.SamConfig(**SAM))
    monkeypatch.setitem(jsam.SAM_VARIANTS, "vit_b", jsam.SamConfig(**SAM))
    # the tiny SAM fixture's mask downscaler has 8 channels where SAM's has 16
    pe_shapes = tsam.prompt_encoder_param_shapes

    def tiny_pe_shapes(cfg, mic=MASK_IN_CHANS):
        shapes = pe_shapes(cfg)
        shapes["mask_downscale"] = {
            "conv1": {"kernel": (2, 2, 1, mic // 4), "bias": (mic // 4,)},
            "ln1": tsam._ln_shape(mic // 4),
            "conv2": {"kernel": (2, 2, mic // 4, mic), "bias": (mic,)},
            "ln2": tsam._ln_shape(mic),
            "conv3": {"kernel": (1, 1, mic, cfg.out_chans), "bias": (cfg.out_chans,)}}
        return shapes

    monkeypatch.setattr(tsam, "prompt_encoder_param_shapes", tiny_pe_shapes)


def test_dinov2_from_file(tiny_tables, tmp_path):
    sd, d = _load("dinov2_tiny")
    torch.save(_tensors(sd), tmp_path / "dinov2_vitl14_reg4_pretrain.pth")
    params, cfg = zoo.build_dinov2(str(tmp_path), "vit_large", 4, device="cpu")
    assert cfg == tdino.DinoV2Config(**DINO)
    jparams, jcfg = jzoo.build_dinov2(str(tmp_path), "vit_large", 4)
    x = _nhwc(d["input"])
    got = tdino.forward_features(params, torch.from_numpy(x), cfg, attn_tap_last_n=2)
    want = jdino.forward_features(jparams, jnp.asarray(x), jcfg, attn_tap_last_n=2)
    for key in ("x_prenorm", "attn_mean", "x_norm_patchtokens"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["x_prenorm"].numpy(), d["x_prenorm"], atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["attn_mean"][0].numpy(), d["attn_mean_last2"], atol=2e-4,
                               rtol=0)


def test_clip_from_torchscript_archive(tiny_tables, tmp_path):
    """OpenAI's ViT-B-16.pt is a TorchScript archive with three scalar
    buffers the reference drops."""
    sd, d = _load("clip_tiny")
    scalars = {k: np.asarray(v) for k, v in JIT_SCALARS.items()}
    save_torchscript({**sd, **scalars}, str(tmp_path / "ViT-B-16.pt"), buffers=tuple(scalars))
    vp, tp, scale, vcfg, tcfg = zoo.build_clip(str(tmp_path), "ViT-B/16", device="cpu")
    jvp, jtp, jscale, jvcfg, jtcfg = jzoo.build_clip(str(tmp_path), "ViT-B/16")
    assert float(scale) == float(jscale) == float(d["logit_scale"])
    img = _nhwc(d["image"])
    tok, _ = tclip.prefinal(vp, tclip.visual_embed(vp, torch.from_numpy(img), vcfg), vcfg)
    jtok, _ = jclip.prefinal(jvp, jclip.visual_embed(jvp, jnp.asarray(img), jvcfg), jvcfg)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tok.numpy(), d["image_tokens_prefinal"], atol=2e-4, rtol=1e-3)
    feats = tclip.encode_text(tp, torch.from_numpy(d["text_tokens"]), tcfg)
    jfeats = jclip.encode_text(jtp, jnp.asarray(d["text_tokens"]), jtcfg)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL, rtol=0)
    np.testing.assert_allclose(feats.numpy(), d["text_feats"], atol=2e-4, rtol=1e-3)


def _alpha_files(tmp_path):
    """The base CLIP file (text tower, ``in_proj_weight`` names, visual
    tensors of junk the override must replace, no alpha conv) as a
    ``{"model": ...}`` bundle, and the GRIT-20M override (the fixture's
    visual tower without its ``visual.`` prefix)."""
    sd, d = _load("alpha_clip_tiny")
    rng = np.random.RandomState(0)
    base = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            if "conv1_alpha" not in k:
                base[k.replace("attn.in_proj.", "attn.in_proj_")] = rng.rand(*v.shape).astype(
                    v.dtype)
        else:
            base[k] = v
    torch.save({"model": _tensors(base)}, tmp_path / "ViT-L-14-336px.pt")
    torch.save(_tensors({k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}),
               tmp_path / "clip_l14_336_grit_20m_4xe.pth")
    return sd, d


def test_alpha_clip_base_with_override(tiny_tables, tmp_path):
    """The override replaces every visual tensor of the base: the visual
    CLS embedding equals the fixture's and JAX's converter on it; the text
    tower and logit scale come from the base."""
    sd, d = _alpha_files(tmp_path)
    vp, tp, scale, vcfg, tcfg = zoo.build_alpha_clip(str(tmp_path), device="cpu")
    img, alpha = _nhwc(d["image"]), np.ascontiguousarray(d["alpha"][:, 0])
    got = tclip.visual_cls(vp, torch.from_numpy(img), vcfg, alpha=torch.from_numpy(alpha))
    jv = jconvert.alpha_clip_visual_to_flax(sd, depth=2)
    want = jclip.visual_cls(jv, jnp.asarray(img), jclip.ClipVisualConfig(**AC_V),
                            alpha=jnp.asarray(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), d["cls_emb"], atol=3e-5, rtol=1e-4)
    toks = np.zeros((2, 12), np.int64)
    toks[0, :4], toks[1, :6] = [5, 7, 9, 99], [3, 4, 5, 6, 7, 99]
    jt = jconvert.clip_text_to_flax(sd, depth=2)
    np.testing.assert_allclose(
        tclip.encode_text(tp, torch.from_numpy(toks), tcfg).numpy(),
        np.asarray(jclip.encode_text(jt, jnp.asarray(toks), jclip.ClipTextConfig(**AC_T))),
        atol=ATOL, rtol=0)
    assert float(scale) == float(sd["logit_scale"])


def test_sam_from_file(tiny_tables, tmp_path):
    sd, d = _load("sam_tiny")
    torch.save(_tensors(sd), tmp_path / "sam_vit_b_01ec64.pth")
    params, cfg = zoo.build_sam(str(tmp_path), "vit_b", device="cpu")
    jparams, jcfg = jzoo.build_sam(str(tmp_path), "vit_b")
    img = _nhwc(d["image"])
    got = tsam.encode_image(params["encoder"], torch.from_numpy(img), cfg).numpy()
    want = np.asarray(jsam.encode_image(jparams["encoder"], jnp.asarray(img), jcfg))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _nhwc(d["embedding"]), atol=ATOL, rtol=0)
    for part in ("prompt_encoder", "decoder"):
        ref = tconvert.from_reference_state_dict(sd, f"sam_{part}", 0 if part != "decoder" else 2)
        assert tconvert.leaf_shapes(params[part]) == tconvert.leaf_shapes(ref)
        for (ka, a), (kb, b) in zip(sorted(_leaves(params[part])), sorted(_leaves(ref))):
            assert ka == kb and torch.equal(a, b), ka


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name,tower,args,shapes,ignore", [
    ("dinov2_tiny", "dinov2", (3, 4), lambda: tdino.param_shapes(tdino.DinoV2Config(**DINO)),
     zoo.IGNORED_KEYS["dinov2"]),
    ("sam_tiny", "sam_encoder", (3,),
     lambda: tsam.param_shapes(tsam.SamConfig(**SAM))["encoder"], ()),
])
def test_audit_is_clean_and_catches_drift(name, tower, args, shapes, ignore):
    """The fixture converts with nothing unconsumed and every leaf at the
    tower's shape; an extra key, a tensor of another shape and a missing
    one each raise."""
    sd, _ = _load(name)
    if tower == "sam_encoder":
        sd = {k: v for k, v in sd.items() if k.startswith("image_encoder.")}
    fn = {"dinov2": tconvert.dinov2_tree, "sam_encoder": tconvert.sam_encoder_tree}[tower]
    parts = {tower: (fn, args, shapes())}
    tree, report = tconvert.audit_conversion(fn, sd, *args, expected=shapes())
    assert set(report["unconsumed"]) <= set(ignore)
    assert report["missing"] == report["extra"] == report["shape_mismatch"] == []
    tconvert.audited_trees(sd, parts, ignore)
    key = next(k for k in sd if k.endswith("norm1.weight"))
    with pytest.raises(ValueError, match="unconsumed"):
        tconvert.audited_trees({**sd, key.replace("norm1", "norm9"): sd[key]}, parts, ignore)
    with pytest.raises(ValueError, match="shape_mismatch"):
        tconvert.audited_trees({**sd, key: sd[key][:-1]}, parts, ignore)
    with pytest.raises(KeyError):
        tconvert.audited_trees({k: v for k, v in sd.items() if k != key}, parts, ignore)


def test_missing_file_gives_the_seeded_random_tower(tiny_tables, tmp_path):
    """No file under the name: the seeded random weights the zoo drew
    before it read checkpoints (the random_params walk over the tower's
    shapes), bit for bit, whether models_path is None or holds nothing."""
    for build, shapes, seed in (
            (lambda p: zoo.build_dinov2(p, "vit_large", 4, device="cpu")[0],
             lambda: tdino.param_shapes(tdino.DinoV2Config(**DINO)), 0),
            (lambda p: zoo.build_clip(p, "ViT-B/16", device="cpu")[:2],
             lambda: (tclip.visual_param_shapes(tclip.ClipVisualConfig(**CLIP_V)),
                      tclip.text_param_shapes(tclip.ClipTextConfig(**CLIP_T))), 1)):
        gen = torch.Generator().manual_seed(seed)
        want = shapes()
        want = (zoo.random_params(want, gen, torch.device("cpu")) if isinstance(want, dict)
                else tuple(zoo.random_params(w, gen, torch.device("cpu")) for w in want))
        for got in (build(None), build(str(tmp_path))):
            got_l = dict(_leaves({"t": got} if isinstance(got, dict) else dict(enumerate(got))))
            want_l = dict(_leaves({"t": want} if isinstance(want, dict)
                                  else dict(enumerate(want))))
            assert got_l.keys() == want_l.keys()
            assert all(torch.equal(got_l[k], want_l[k]) for k in want_l)


@pytest.mark.parametrize("name,parts,dropped", [
    ("dinov2_tiny", (("dinov2", lambda sd: tconvert.dinov2_tree(sd, 3, 4)),), {"mask_token"}),
    ("clip_tiny", (("clip_visual", lambda sd: tconvert.clip_visual_tree(sd, 3)),
                   ("clip_text", lambda sd: tconvert.clip_text_tree(sd, 2))),
     {"logit_scale", "visual.positional_embedding_new"}),
    ("alpha_clip_tiny", (("alpha_clip_visual", lambda sd: tconvert.clip_visual_tree(sd, 2, True)),
                         ("clip_text", lambda sd: tconvert.clip_text_tree(sd, 2))),
     {"logit_scale"}),
])
def test_reference_state_dict_inverts_the_converters(name, parts, dropped):
    """Tree → reference names and back: every fixture tensor, bit for bit
    (what chip_smoke.py writes its checkpoint files with)."""
    sd, _ = _load(name)
    back = {}
    for tower, fn in parts:
        tree = tconvert.from_jax_params(fn(sd))
        back.update(tconvert.reference_state_dict(tree, tower))
    assert set(back) == set(sd) - dropped
    for k, v in back.items():
        assert v.dtype == sd[k].dtype and np.array_equal(v, sd[k]), k
