"""The evaluation CLI's text path on the CPU: ``mars_tpu_torch.cli.main``
without ``--gt-class-names`` against ``mars_tpu.cli.main``.

Both CLIs get the golden episode's tiny towers and, in place of
``build_retriever``, a ``TextRetriever`` over the same scripted VLM: it
records every request and answers from a table keyed by the drawn image.
WordNet runs on ``tests/nltk_minicorpus.py``'s tree (nltk in JAX, the
port's reader through ``--nltk-path``).  The JAX CLI runs once at its
default text block; the port at ``--text-block 4``, ``--pipelined-text``
and ``--text-block 0``.  Per episode the class names, definitions and
merged masks must be equal (bitwise), and at the same block the VLM's
requests (drawn images bitwise, prompts, budgets, batch shapes).
"""
import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu import cli as jcli
from mars_tpu.models import clip as jclip, convert as jconvert, dinov2 as jdino, zoo as jzoo
from mars_tpu.pipeline import mars as jmars
from mars_tpu.text import retriever as jret
from mars_tpu_torch import cli as tcli
from mars_tpu_torch.models import clip as tclip, convert as tconvert, dinov2 as tdino, zoo
from mars_tpu_torch.models import vip_llava as tvl
from mars_tpu_torch.text import processor as tproc, retriever as tret
from nltk_minicorpus import ensure_minicorpus
from vip_llava_files import random_state_dict, tokenizer_spec, write_vip_llava_dir

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
SIZE = 112
EPISODES = 5  # a block of 4 and a flush of 1
ARGV = ["--benchmark", "synthetic", "--episodes", str(EPISODES), "--input-size", str(SIZE),
        "--proposal-bucket", "16", "--seed", "3"]
DINO = dict(patch_size=14, embed_dim=32, depth=3, num_heads=2, num_register_tokens=4,
            pos_embed_grid=8)
NAMES = ("dog", "plant", "sheep", "potted plant", "hotdog")
# a tiny ViP-LLaVA for the CLI's reading of --vlm-path (vocabulary: the
# test tokenizer's 640 pieces, <image> and <pad>)
VLM_CFG = tvl.VipLlavaConfig(v_hidden=32, v_intermediate=64, v_layers=4, v_heads=2,
                             image_size=56, patch_size=14, vision_feature_layers=(-2, -4),
                             hidden=32, intermediate=64, layers=2, heads=4, kv_heads=2,
                             vocab=648, rms_eps=1e-5, image_token_index=640)


class ScriptedVLM:
    """Answers from a table keyed by the drawn image, records each call as
    (method, shapes, prompts, max, min, shared_prefix) and the images."""
    supports_shared_prefix = True

    def __init__(self):
        self.calls, self.images = [], []

    def _answer(self, image, prompt):
        name = NAMES[int(image.astype(np.int64).sum()) % len(NAMES)]
        if "definition" in prompt:
            return f"a {name} that grows in a pot in the soil" if "plant" in prompt \
                else f"a domesticated {name} kept as a pet"
        return name

    def generate(self, image, prompt, max_new_tokens=20, min_new_tokens=0, shared_prefix=None):
        self.calls.append(("generate", [image.shape], [prompt], max_new_tokens, min_new_tokens,
                           shared_prefix))
        self.images.append([image])
        return self._answer(image, prompt)

    def generate_batch(self, images, prompts, max_new_tokens=20, min_new_tokens=0,
                       shared_prefix=None):
        self.calls.append(("generate_batch", [im.shape for im in images], list(prompts),
                           max_new_tokens, min_new_tokens, shared_prefix))
        self.images.append(list(images))
        return [self._answer(im, pr) for im, pr in zip(images, prompts)]


def _sd():
    data = np.load(os.path.join(FIXTURES, "golden_episode_tiny.npz"))
    return {k[3:]: data[k] for k in data.files if k.startswith("sd.")}


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def nltk_root(tmp_path_factory):
    return ensure_minicorpus(str(tmp_path_factory.mktemp("nltk")))


@pytest.fixture(scope="module")
def tiny_towers():
    """The golden episode's tiny towers in both packages' zoos."""
    with pytest.MonkeyPatch.context() as mp:
        _patch_towers(mp)
        yield


def _patch_towers(monkeypatch):
    sd = _sd()
    tcfg = dict(width=16, depth=2, num_heads=2, output_dim=16)

    def jpair(prefix, depth, alpha):
        sub = _sub(sd, prefix)
        vis = (jconvert.alpha_clip_visual_to_flax(sub, depth=depth) if alpha
               else jconvert.clip_visual_to_flax(sub, depth=depth))
        return (vis, jconvert.clip_text_to_flax(sub, depth=2),
                jnp.asarray(jconvert.clip_logit_scale(sub)),
                jclip.ClipVisualConfig(patch_size=16, width=64, depth=depth, num_heads=1,
                                       output_dim=16, pos_embed_grid=7, alpha_channel=alpha),
                jclip.ClipTextConfig(**tcfg))

    def tpair(prefix, depth, alpha):
        sub = _sub(sd, prefix)
        return (tconvert.from_reference_state_dict(
                    sub, "alpha_clip_visual" if alpha else "clip_visual", depth),
                tconvert.from_reference_state_dict(sub, "clip_text", 2),
                tconvert.logit_scale(sub),
                tclip.ClipVisualConfig(width=64, depth=depth, num_heads=1, output_dim=16,
                                       pos_embed_grid=7, alpha_channel=alpha),
                tclip.ClipTextConfig(**tcfg))

    jd = jconvert.dinov2_to_flax(_sub(sd, "dino."), depth=3, num_register_tokens=4)
    monkeypatch.setattr(jzoo, "build_dinov2", lambda *a, **k: (jd, jdino.DinoV2Config(**DINO)))
    monkeypatch.setattr(jzoo, "build_clip", lambda *a, **k: jpair("clip.", 3, False))
    monkeypatch.setattr(jzoo, "build_alpha_clip", lambda *a, **k: jpair("aclip.", 2, True))
    td = tconvert.from_jax_params(jax.tree.map(np.asarray, jd))
    monkeypatch.setattr(zoo, "build_dinov2", lambda *a, **k: (td, tdino.DinoV2Config(**DINO)))
    monkeypatch.setattr(zoo, "build_clip", lambda *a, **k: tpair("clip.", 3, False))
    monkeypatch.setattr(zoo, "build_alpha_clip", lambda *a, **k: tpair("aclip.", 2, True))


@pytest.fixture(scope="module")
def jax_run(tiny_towers, tmp_path_factory, nltk_root):
    """mars_tpu.cli.main at its default text block: (per-episode (name,
    definition, merged mask), the scripted VLM)."""
    vlm = ScriptedVLM()
    seen = []
    real = jmars.Mars.predict

    def predict(self, ep, props, class_name=None, class_description=""):
        merged = real(self, ep, props, class_name=class_name,
                      class_description=class_description)
        seen.append((class_name, class_description, np.asarray(merged)))
        return merged

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "build_retriever", lambda args: jret.TextRetriever(vlm))
        mp.setattr(jmars.Mars, "predict", predict)
        jcli.main(ARGV + ["--log-path", str(tmp_path_factory.mktemp("jax")),
                          "--overlap-ranking", "0", "--nltk-path", nltk_root])
    return seen, vlm


def _port(monkeypatch, nltk_root, extra):
    vlm = ScriptedVLM()
    monkeypatch.setattr(tcli, "build_retriever", lambda args: tret.TextRetriever(vlm))
    res = tcli.main(ARGV + ["--device", "cpu", "--nltk-path", nltk_root] + extra,
                    keep_masks=True)
    return res, vlm


@pytest.mark.parametrize("extra", [["--text-block", "4"], ["--pipelined-text"],
                                   ["--text-block", "0"]])
def test_names_definitions_and_masks_equal_jax(jax_run, monkeypatch, nltk_root, extra):
    want, jvlm = jax_run
    res, vlm = _port(monkeypatch, nltk_root, extra)
    assert len(want) == EPISODES
    assert res["names"] == [w[0] for w in want]
    assert res["descriptions"] == [w[1] for w in want]
    assert any(res["descriptions"]), "WordNet resolved no definition"
    for got, (_, _, mask) in zip(res["masks"], want):
        np.testing.assert_array_equal(got, mask > 0.5)
    assert len(res["text_ms"]) == EPISODES and all(t >= 0 for t in res["text_ms"])
    if extra == ["--text-block", "4"]:  # the JAX CLI's default: the same requests
        assert vlm.calls == jvlm.calls
        for got, want_ims in zip(vlm.images, jvlm.images):
            for a, b in zip(got, want_ims):
                np.testing.assert_array_equal(a, b)


def test_gt_class_names_runs_no_retriever(tiny_towers, monkeypatch, nltk_root):
    def refuse(args):
        raise AssertionError("--gt-class-names must not build the retriever")

    monkeypatch.setattr(tcli, "build_retriever", refuse)
    res = tcli.main(ARGV[:2] + ["--episodes", "1", "--input-size", str(SIZE),
                                "--proposal-bucket", "16", "--gt-class-names", "--device", "cpu"])
    assert res["descriptions"] == [""] and res["text_ms"] == [0.0]


def test_build_retriever_without_checkpoint_raises():
    args = tcli.parse_args(["--vlm4bit", "--vlm-path", "/nonexistent/vip-llava"])
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        tcli.build_retriever(args)


def test_build_retriever_with_files_names_the_missing_loader(tmp_path):
    """A directory with SentencePiece's tokenizer.model in place of
    tokenizer.json: the port names the file it reads."""
    for name in ("config.json", "model-00001-of-00003.safetensors", "tokenizer.model",
                 "tokenizer_config.json", "preprocessor_config.json"):
        (tmp_path / name).write_bytes(b"")
    args = tcli.parse_args(["--vlm4bit", "--vlm-path", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="missing: tokenizer.json"):
        tcli.build_retriever(args)


@pytest.fixture(scope="module")
def vlm_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vip_llava"))
    write_vip_llava_dir(path, VLM_CFG, random_state_dict(VLM_CFG, seed=7, dtype=torch.float32),
                        tokenizer_spec(640, seed=1, corpus=NAMES), shard_bytes=60_000)
    return path


def test_cli_names_the_class_through_the_files(tiny_towers, monkeypatch, nltk_root, vlm_dir):
    """``cli.main`` without --gt-class-names reads --vlm-path (the weights
    onto --device, the tokenizer and image processor): its names and
    definitions equal those of the same arrays passed as ``params=`` with
    the directory's processor."""
    argv = ARGV[:2] + ["--episodes", "2", "--input-size", str(SIZE), "--proposal-bucket", "16",
                       "--seed", "3", "--device", "cpu", "--nltk-path", nltk_root,
                       "--vlm-path", vlm_dir, "--vlm4bit", "--text-block", "2"]
    got = tcli.main(argv)
    real, built = tret.TorchVipLlava, []

    def from_params(path, **kw):
        sd = {zoo.vip_llava_key(k): v.numpy() for k, v in
              random_state_dict(VLM_CFG, seed=7, dtype=torch.float32).items()}
        built.append(path)
        return real(params=tvl.convert_hf(sd, VLM_CFG), cfg=VLM_CFG, processor=tproc.load(path),
                    **{k: v for k, v in kw.items() if k != "device"})

    monkeypatch.setattr(tret, "TorchVipLlava", from_params)
    want = tcli.main(argv)
    assert built == [vlm_dir]
    assert got["names"] == want["names"] and len(got["names"]) == 2
    assert got["descriptions"] == want["descriptions"]
    assert any(n.strip() for n in got["names"]), got["names"]


# the tiny directory widened so that dense kernels reach quantize_params'
# 2^14 elements (LLaMA q, o and the MLP; CLIP's MLP), input dims multiples of 64
WIDE_CFG = dataclasses.replace(VLM_CFG, v_hidden=64, v_intermediate=256, hidden=128,
                               intermediate=256)
LEAF_KEYS = {(8, "affine"): {"q", "scale"}, (4, "affine"): {"q4", "scale"},
             (4, "nf4"): {"nf4", "bscale"}}


@pytest.fixture(scope="module")
def wide_vlm_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vip_llava_wide"))
    sd = random_state_dict(WIDE_CFG, seed=8, dtype=torch.float32)
    write_vip_llava_dir(path, WIDE_CFG, sd, tokenizer_spec(640, seed=1, corpus=NAMES),
                        shard_bytes=1 << 20)
    return path, {zoo.vip_llava_key(k): v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("flags", [[], ["--vlm-kv8"], ["--vlm8bit"], ["--vlm4bit", "--vlm-kv8"],
                                   ["--vlm4bit", "--vlm4bit-nf4"]],
                         ids=["default", "kv8", "vlm8bit", "vlm4bit-kv8", "nf4"])
def test_build_retriever_quantizes_as_jax(monkeypatch, wide_vlm_dir, flags):
    """``cli.build_retriever`` on the release-layout directory quantizes and
    picks the KV cache as ``mars_tpu.cli.build_retriever`` asks
    ``JaxVipLlava`` to (without a bit flag: 8-bit weights), and its tree
    equals the ``params=`` route's at those settings."""
    path, sd = wide_vlm_dir
    asked = {}
    monkeypatch.setattr(jret, "JaxVipLlava", lambda p, **kw: asked.update(kw, path=p))
    parser = argparse.ArgumentParser()
    jcli.add_eval_args(parser)
    jcli.build_retriever(parser.parse_args(["--jax-vlm", "--vlm-path", path] + flags))
    vlm = tcli.build_retriever(tcli.parse_args(["--vlm-path", path, "--device", "cpu"]
                                               + flags)).vlm
    bits, fmt = asked["quantize_bits"], asked["int4_format"]
    assert asked["path"] == path and (vlm.kv_bits, vlm.draft_tokens) == (
        asked["kv_bits"], asked["draft_tokens"])
    layer = vlm.params["language"]["layer0"]
    for leaf in (layer["attn"]["q"], layer["mlp"]["gate"], layer["mlp"]["down"],
                 vlm.params["vision"]["layer0"]["mlp"]["fc1"]):
        assert set(leaf["kernel"]) == LEAF_KEYS[bits, fmt]
    ref = tret.TorchVipLlava(params=tvl.convert_hf(sd, WIDE_CFG), cfg=WIDE_CFG,
                             processor=object(), dtype=torch.bfloat16, quantize_bits=bits,
                             int4_format=fmt)
    _assert_same_tree(vlm.params, ref.params)


def _assert_same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_same_tree(got[k], want[k])
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)
