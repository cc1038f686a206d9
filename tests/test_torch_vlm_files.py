"""The port's readers of a ViP-LLaVA directory in transformers' format, held
against the packages the JAX package reads it with: the LLaMA tokenizer
(``text.llama_tokenizer``) against ``LlamaTokenizerFast`` and ``tokenizers``
in the legacy (``Prepend`` + ``Replace``) and ``Metaspace`` forms, its
``decode`` against transformers'; CLIP's image processor
(``text.image_processor``) against PIL's ``BICUBIC`` and
``CLIPImageProcessor``; the safetensors reader (``models.safetensors_io``)
against ``safetensors``; ``zoo.load_vip_llava`` under both sets of names;
and ``TorchVipLlava(dir)`` against ``JaxVipLlava`` with its ``AutoProcessor``
on a tiny model that transformers saved, in float32 on the CPU."""
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from mars_tpu.models import vip_llava as jvl
from mars_tpu.text import retriever as jret
from mars_tpu_torch.data.coco import COCO_CLASS_NAMES
from mars_tpu_torch.data.pascal5i import PASCAL_CLASS_NAMES
from mars_tpu_torch.data.synthetic import CLASS_NAMES as SYNTHETIC_NAMES
from mars_tpu_torch.models import safetensors_io, vip_llava as tvl, zoo
from mars_tpu_torch.text import image_processor, llama_tokenizer, processor as tproc
from mars_tpu_torch.text import retriever as tret
from mars_tpu_torch.text.prompts import (COLORS, VISUAL_PROMPTS, VISUAL_PROMPTS_DESCRIPTIONS,
                                         VLM_SYSTEM_TEMPLATE)
from vip_llava_files import (random_state_dict, tokenizer_spec, write_safetensors,
                             write_tokenizer, write_vip_llava_dir)

NAMES = (COCO_CLASS_NAMES[::8] + PASCAL_CLASS_NAMES + SYNTHETIC_NAMES[::4]
         + ["crème brûlée", "日本の猫"])
PIECES = 640  # the test tokenizer's pieces; <image> is 640, <pad> 641
# TINY's widths (models/vip_llava.py) with the test tokenizer's vocabulary
CFG = tvl.VipLlavaConfig(v_hidden=32, v_intermediate=64, v_layers=4, v_heads=2, image_size=56,
                         patch_size=14, vision_feature_layers=(-2, -4), hidden=32,
                         intermediate=64, layers=2, heads=4, kv_heads=2, vocab=648,
                         rms_eps=1e-5, image_token_index=PIECES)
JCFG = jvl.VipLlavaConfig(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})


def _prompts():
    out = []
    for kind in VISUAL_PROMPTS:
        for color in COLORS:
            out.append(VLM_SYSTEM_TEMPLATE.format(VISUAL_PROMPTS[kind].format(color)))
            out += [VLM_SYSTEM_TEMPLATE.format(
                VISUAL_PROMPTS_DESCRIPTIONS[kind].format(n, color, n, n)) for n in NAMES]
    return out


PROMPTS = _prompts()


@pytest.fixture(scope="module", autouse=True)
def _transformers_without_tensorflow():
    """transformers imports TensorFlow where it finds it (~5 s), which no
    test here uses."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        yield


@pytest.fixture(scope="module", params=["legacy", "metaspace"])
def tokenizers_pair(request, tmp_path_factory):
    """(the port's, transformers', tokenizers', the port's without
    tokenizer_config.json) over one seeded tokenizer.json."""
    from tokenizers import Tokenizer
    from transformers import LlamaTokenizerFast

    spec = tokenizer_spec(PIECES, seed=1, form=request.param, corpus=PROMPTS)
    path = str(tmp_path_factory.mktemp(f"tok_{request.param}"))
    write_tokenizer(path, spec)
    return (llama_tokenizer.load(path), LlamaTokenizerFast.from_pretrained(path),
            Tokenizer.from_file(os.path.join(path, "tokenizer.json")),
            llama_tokenizer.LlamaTokenizer(spec))


def _same_ids(pair, text):
    mine, hf, raw, bare = pair
    assert mine.encode(text) == hf(text)["input_ids"], text
    assert bare.encode(text) == raw.encode(text).ids, text


def test_tokenizer_ids_equal_transformers_on_every_prompt(tokenizers_pair):
    for p in PROMPTS:
        _same_ids(tokenizers_pair, p)
        _same_ids(tokenizers_pair, p.replace("<image>", "<image>" * 16))


_TEXT_PIECES = ["<image>", "</s>", "<s>", " ", "  ", "   ", "\n", "\n\n", "\t", "Human", ":",
                "name", " of", "the", "é", "日本", "😀", "　", "\xa0", "ø", "?", "a", "m"]


@settings(max_examples=120, deadline=None, database=None)
@given(st.one_of(st.lists(st.sampled_from(_TEXT_PIECES), max_size=14).map("".join),
                 st.text(max_size=24)))
def test_tokenizer_ids_equal_transformers_on_generated_strings(tokenizers_pair, text):
    _same_ids(tokenizers_pair, text)


def test_tokenizer_decode_equals_transformers(tokenizers_pair):
    """Random ids, runs of byte pieces (cut-off UTF-8 among them) and the
    special tokens, with and without skip_special_tokens."""
    mine, hf, _, _ = tokenizers_pair
    rs = np.random.RandomState(0)
    specials = [0, 1, 2, PIECES, PIECES + 1]
    for _ in range(300):
        ids = []
        for _ in range(rs.randint(1, 8)):
            kind = rs.randint(4)
            if kind == 0:
                raw = rs.choice(["é", "日本", "😀", "ø"]).encode()
                ids += [3 + b for b in raw[:rs.randint(1, len(raw) + 1)]]
            elif kind == 1:
                ids.append(int(rs.choice(specials)))
            else:
                ids += rs.randint(0, PIECES, rs.randint(1, 4)).tolist()
        for skip in (True, False):
            assert mine.decode(ids, skip_special_tokens=skip) == hf.decode(
                ids, skip_special_tokens=skip), ids
    assert mine.eos_token_id == hf.eos_token_id == 2


def test_tokenizer_traps():
    """A "▁" after every added token (each piece normalised on its own), and
    BPE by merge rank ("m"+"a" ranked before "Hu"+"m" leaves "Hu", "ma",
    "n"), in the port and in ``tokenizers``."""
    from tokenizers import Tokenizer

    spec = tokenizer_spec(PIECES, seed=3, learnt=0)
    model, first = spec["model"], [["m", "a"], ["H", "u"], ["Hu", "m"]]
    vocab, merges = model["vocab"], model["merges"]
    for a, b in merges[-len(first):]:  # the last random pieces give their ids to the new ones
        vocab.pop(a + b)
    merges[-len(first):] = []
    for k, (a, b) in enumerate(first):
        vocab.setdefault(a + b, PIECES - len(first) + k)
    model["merges"] = first + [m for m in merges if m not in first]
    text = "Human: <image>\nwhat"
    ids = llama_tokenizer.LlamaTokenizer(spec).encode(text, add_special_tokens=False)
    assert ids == Tokenizer.from_str(json.dumps(spec)).encode(
        text, add_special_tokens=False).ids
    inv = {i: t for t, i in model["vocab"].items()}
    inv[PIECES] = "<image>"
    pieces = [inv[i] for i in ids]
    assert pieces[:4] == ["▁", "Hu", "ma", "n"]
    at = pieces.index("<image>")
    assert pieces[at + 1:at + 3] == ["▁", "<0x0A>"]


def _variants():
    """tokenizer.json variants past the two Llama forms: every Metaspace
    scheme with and without split (and the older ``add_prefix_space``
    spelling), added tokens with lstrip / rstrip, and a normalized one."""
    out = []
    for scheme in ("first", "always", "never"):
        for split in (False, True):
            spec = tokenizer_spec(PIECES, seed=4, form="metaspace", corpus=PROMPTS[:40])
            spec["pre_tokenizer"].update(prepend_scheme=scheme, split=split)
            out.append(spec)
    spec = tokenizer_spec(PIECES, seed=4, form="metaspace", corpus=PROMPTS[:40])
    spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}
    out.append(spec)
    for form in ("legacy", "metaspace"):
        spec = tokenizer_spec(PIECES, seed=5, form=form, corpus=PROMPTS[:40])
        spec["added_tokens"][3]["lstrip"] = True  # <image>
        spec["added_tokens"][2]["rstrip"] = True  # </s>
        spec["added_tokens"].append({"id": PIECES + 2, "content": "dog", "single_word": False,
                                     "lstrip": False, "rstrip": False, "normalized": True,
                                     "special": False})
        out.append(spec)
    return out


def test_tokenizer_components_equal_tokenizers():
    from tokenizers import Tokenizer

    texts = PROMPTS[::25] + ["a dog  <image>  b", " </s>  x", "hot dog dogs", "\n <image>\n",
                             "  Human:  <image> </s>dog", "<image>", " ", ""]
    for spec in _variants():
        mine, theirs = llama_tokenizer.LlamaTokenizer(spec), Tokenizer.from_str(json.dumps(spec))
        for text in texts:
            assert mine.encode(text) == theirs.encode(text).ids, (spec["pre_tokenizer"], text)


def test_tokenizer_configs_of_older_directories(tmp_path):
    """A tokenizer_config.json without added_tokens_decoder: transformers
    then reads special_tokens_map.json (the EOS here) and added_tokens.json
    (a token tokenizer.json lacks), and so does the port; with
    clean_up_tokenization_spaces, the decode's clean-up."""
    from transformers import LlamaTokenizerFast

    spec = tokenizer_spec(PIECES, seed=1, corpus=PROMPTS[:40])
    spec["added_tokens"] = spec["added_tokens"][:4]  # no <pad>
    write_tokenizer(str(tmp_path), spec)
    with open(tmp_path / "tokenizer_config.json") as f:
        config = json.load(f)
    del config["added_tokens_decoder"]
    config.update(eos_token="<unk>", clean_up_tokenization_spaces=True)
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump(config, f)
    with open(tmp_path / "special_tokens_map.json", "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "pad_token": "<pad>"}, f)
    with open(tmp_path / "added_tokens.json", "w") as f:
        json.dump({"<pad>": PIECES + 1}, f)
    mine, hf = llama_tokenizer.load(str(tmp_path)), LlamaTokenizerFast.from_pretrained(tmp_path)
    for text in ("Human: <image>\nhi<pad><pad> there</s>", PROMPTS[3]):
        assert mine.encode(text) == hf(text)["input_ids"]
    for ids in ([1, 5, PIECES + 1, 300, 2], mine.encode("a dog . it 's here , is n't it ?")):
        assert mine.decode(ids, skip_special_tokens=True) == hf.decode(
            ids, skip_special_tokens=True)
    assert mine.eos_token_id == hf.eos_token_id == 2


def test_tokenizer_files_it_does_not_read(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x0a\x00")
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        llama_tokenizer.load(str(tmp_path))
    spec = tokenizer_spec(PIECES, seed=1)
    for part, value, name in (("normalizer", {"type": "NFKC"}, "NFKC"),
                              ("pre_tokenizer", {"type": "ByteLevel"}, "ByteLevel"),
                              ("decoder", {"type": "WordPiece"}, "WordPiece"),
                              ("post_processor", {"type": "BertProcessing"}, "BertProcessing")):
        with pytest.raises(ValueError, match=name):
            llama_tokenizer.LlamaTokenizer({**spec, part: value})
    with pytest.raises(ValueError, match="WordLevel"):
        llama_tokenizer.LlamaTokenizer({**spec, "model": {**spec["model"], "type": "WordLevel"}})


RESIZES = [(70, 90, 56, 72), (33, 17, 336, 200), (500, 375, 336, 448), (10, 10, 10, 3),
           (7, 301, 1, 299), (5, 5, 13, 29), (1001, 999, 336, 335), (480, 640, 336, 448)]


def test_resize_equals_pil_bicubic():
    from PIL import Image

    rs = np.random.RandomState(0)
    for h, w, oh, ow in RESIZES:
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
        np.testing.assert_array_equal(image_processor.resize_bicubic(img, ow, oh), want)


def test_pixel_values_equal_clip_image_processor():
    from PIL import Image
    from transformers import CLIPImageProcessor

    hf = CLIPImageProcessor(size={"shortest_edge": 336}, crop_size={"height": 336, "width": 336},
                            resample=3)
    mine = image_processor.ClipImageProcessor(hf.to_dict())
    rs = np.random.RandomState(1)
    for shape in [(480, 640, 3), (336, 336, 3), (101, 50, 3), (20, 31, 3), (64, 48),
                  (40, 60, 4)]:
        img = rs.randint(0, 256, shape).astype(np.uint8)
        want = hf(Image.fromarray(img), return_tensors="np")["pixel_values"][0]
        got = mine(img)
        assert got.dtype == np.float32 and got.shape == want.shape == (3, 336, 336)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    small = CLIPImageProcessor(size={"shortest_edge": 40}, crop_size={"height": 56, "width": 48},
                               resample=3)  # a crop past the resized image: zero padding
    img = rs.randint(0, 256, (30, 70, 3)).astype(np.uint8)
    np.testing.assert_allclose(image_processor.ClipImageProcessor(small.to_dict())(img),
                               small(Image.fromarray(img), return_tensors="np")["pixel_values"][0],
                               rtol=0, atol=1e-6)
    for flag, value in (("do_center_crop", False), ("resample", 2), ("do_normalize", False)):
        with pytest.raises(ValueError, match=flag):
            image_processor.ClipImageProcessor({**hf.to_dict(), flag: value})


def _every_dtype():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
            "bf16": torch.randn(4, 6, generator=g).bfloat16(),
            "i64": torch.randint(-2 ** 40, 2 ** 40, (5,), generator=g),
            "i32": torch.randint(-2 ** 30, 2 ** 30, (2, 2), generator=g, dtype=torch.int32),
            "i8": torch.randint(-128, 128, (9,), generator=g, dtype=torch.int8),
            "u8": torch.randint(0, 256, (3, 1, 2), generator=g, dtype=torch.uint8),
            "bool": torch.rand(6, generator=g) > 0.5, "scalar": torch.tensor(2.5),
            "empty": torch.zeros(0, 4)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_safetensors_reader_equals_safetensors(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load, save_file

    tensors = _every_dtype()
    theirs, ours = str(tmp_path / "theirs.safetensors"), str(tmp_path / "ours.safetensors")
    save_file(tensors, theirs)
    write_safetensors(ours, tensors)
    for path in (theirs, ours):
        got, want = safetensors_io.load_file(path), torch_load(path)
        assert set(got) == set(want) == set(tensors)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert torch.equal(_bits(got[k]), _bits(want[k])), k
    numpy_side = {k: v for k, v in tensors.items() if k != "bf16"}
    save_file(numpy_side, str(tmp_path / "np.safetensors"))
    for k, v in np_load(str(tmp_path / "np.safetensors")).items():
        np.testing.assert_array_equal(safetensors_io.load_file(
            str(tmp_path / "np.safetensors"))[k].numpy(), v)
    save_file({"x": torch.zeros(2, dtype=torch.float64)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        safetensors_io.load_file(str(tmp_path / "f64.safetensors"))


def _new_name(key):
    return zoo.vip_llava_key(key)


def _numpy_sd(tensors):
    return {_new_name(k): v.float().numpy() for k, v in tensors.items()}


def _assert_trees_equal(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_loader_reads_both_names_and_audits(tmp_path):
    """The release's names (shards and index) and transformers >= 4.52's
    (one model.safetensors) load into ``convert_hf``'s tree, cast and
    quantized as ``TorchVipLlava(params=)`` casts and quantizes; a missing,
    extra or misshapen tensor and an unimplemented config value raise."""
    tensors = random_state_dict(CFG, seed=2)
    spec = tokenizer_spec(PIECES, seed=1)
    release = str(tmp_path / "release")
    write_vip_llava_dir(release, CFG, tensors, spec, shard_bytes=60_000)
    assert len([f for f in os.listdir(release) if f.endswith(".safetensors")]) >= 2
    want = tvl.convert_hf(_numpy_sd(tensors), CFG)
    got, cfg = zoo.load_vip_llava(release, device="cpu")
    assert cfg == CFG
    _assert_trees_equal(got, want)
    quantized = tret.TorchVipLlava(params=want, cfg=CFG, dtype=torch.bfloat16, quantize_bits=4,
                                   int4_format="nf4", processor=object()).params
    _assert_trees_equal(zoo.load_vip_llava(release, torch.bfloat16, 4, "nf4", "cpu")[0], quantized)

    renamed = str(tmp_path / "renamed")
    write_vip_llava_dir(renamed, CFG, {_new_name(k): v for k, v in tensors.items()}, spec,
                        shard_bytes=1 << 30)
    assert os.path.exists(os.path.join(renamed, "model.safetensors"))
    _assert_trees_equal(zoo.load_vip_llava(renamed, device="cpu")[0], want)

    first = "language_model.model.layers.1.mlp.up_proj.weight"
    for label, edit, match in (
            ("missing", lambda t: t.pop(first), "missing"),
            ("extra", lambda t: t.update({"language_model.model.extra.weight": t[first]}),
             "unconsumed"),
            ("shape", lambda t: t.update({first: t[first][:, :-1]}), "shape_mismatch")):
        bad = dict(tensors)
        edit(bad)
        path = str(tmp_path / label)
        write_vip_llava_dir(path, CFG, bad, spec, shard_bytes=60_000)
        with pytest.raises(ValueError, match=match):
            zoo.load_vip_llava(path, device="cpu")
    with open(os.path.join(release, "config.json")) as f:
        config = json.load(f)
    for section, key, value in (("text_config", "rope_scaling", {"type": "linear", "factor": 2}),
                                ("text_config", "hidden_act", "gelu"),
                                ("", "projector_layernorm_eps", 1e-6),
                                ("vision_config", "layer_norm_eps", 1e-6)):
        changed = json.loads(json.dumps(config))
        (changed[section] if section else changed)[key] = value
        with pytest.raises(ValueError, match=key):
            tvl.config_from_hf(changed)


# llava-hf/vip-llava-7b-hf's config.json as released: most fields left to
# transformers' defaults
RELEASE_CONFIG = {
    "architectures": ["VipLlavaForConditionalGeneration"], "ignore_index": -100,
    "image_token_index": 32000, "model_type": "vipllava", "pad_token_id": 32001,
    "projector_hidden_act": "gelu", "projector_layernorm_eps": 1e-05,
    "text_config": {"_name_or_path": "lmsys/vicuna-7b-v1.5",
                    "architectures": ["LlamaForCausalLM"], "max_position_embeddings": 4096,
                    "model_type": "llama", "rms_norm_eps": 1e-05, "torch_dtype": "float16",
                    "vocab_size": 32064},
    "torch_dtype": "float16", "vision_config": {
        "hidden_size": 1024, "image_size": 336, "intermediate_size": 4096,
        "model_type": "clip_vision_model", "num_attention_heads": 16, "num_hidden_layers": 24,
        "patch_size": 14, "projection_dim": 768, "vocab_size": 32000},
    "vision_feature_layers": [-2, -5, -8, -11, 6], "vocab_size": 32064}


def test_config_defaults_equal_transformers():
    """``config_from_hf`` fills what a config.json leaves out as
    transformers' ``VipLlavaConfig`` does; the release's file gives the 7B."""
    import copy

    from transformers import VipLlavaConfig

    assert tvl.config_from_hf(RELEASE_CONFIG) == tvl.VipLlavaConfig()
    for d in (RELEASE_CONFIG, {}, {"text_config": {"num_hidden_layers": 2}},
              {"vision_config": {"hidden_size": 64}, "image_token_id": 7}):
        hf = VipLlavaConfig(**copy.deepcopy(d))
        t, v = hf.text_config, hf.vision_config
        assert tvl.config_from_hf(d) == tvl.VipLlavaConfig(
            v_hidden=v.hidden_size, v_intermediate=v.intermediate_size,
            v_layers=v.num_hidden_layers, v_heads=v.num_attention_heads,
            image_size=v.image_size, patch_size=v.patch_size,
            vision_feature_layers=tuple(hf.vision_feature_layers), hidden=t.hidden_size,
            intermediate=t.intermediate_size, layers=t.num_hidden_layers,
            heads=t.num_attention_heads, kv_heads=t.num_key_value_heads, vocab=t.vocab_size,
            rope_theta=t.rope_theta, rms_eps=t.rms_norm_eps,
            image_token_index=hf.image_token_index), d


def test_processor_without_processor_config_counts_the_tower(tmp_path):
    """Without processor_config.json, <image> becomes the tower's
    (56 / 14)² = 16 slots, as the model requires."""
    write_vip_llava_dir(str(tmp_path), CFG, random_state_dict(CFG), tokenizer_spec(PIECES),
                        shard_bytes=1 << 30)
    img = np.zeros((40, 50, 3), np.uint8)
    with_file = tproc.load(str(tmp_path))(text="Human: <image>\nhi", images=img)
    os.remove(tmp_path / "processor_config.json")
    without = tproc.load(str(tmp_path))(text="Human: <image>\nhi", images=img)
    np.testing.assert_array_equal(with_file["input_ids"], without["input_ids"])
    assert (without["input_ids"] == PIECES).sum() == 16


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny ViP-LLaVA that transformers saved (at least two shards, the
    release's names) with its processor, and its state dict (numpy)."""
    from transformers import (CLIPImageProcessor, CLIPVisionConfig, LlamaConfig,
                              LlamaTokenizerFast, LlavaProcessor, VipLlavaConfig,
                              VipLlavaForConditionalGeneration)

    path = str(tmp_path_factory.mktemp("vip_llava_hf"))
    write_tokenizer(path, tokenizer_spec(PIECES, seed=1, corpus=PROMPTS))
    hf_cfg = VipLlavaConfig(
        vision_config=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=4,
                                       num_attention_heads=2, image_size=56, patch_size=14),
        text_config=LlamaConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=4, num_key_value_heads=2, vocab_size=648,
                                rms_norm_eps=1e-5),
        vision_feature_layers=[-2, -4], image_token_index=PIECES)
    torch.manual_seed(0)
    model = VipLlavaForConditionalGeneration(hf_cfg).eval()
    with torch.no_grad():  # logits spread wider than the init's, so argmax has no near ties
        for p in model.parameters():
            p.mul_(4.0)
    model.save_pretrained(path, safe_serialization=True, max_shard_size="60KB")
    LlavaProcessor(image_processor=CLIPImageProcessor(
                       size={"shortest_edge": 56}, crop_size={"height": 56, "width": 56},
                       resample=3),
                   tokenizer=LlamaTokenizerFast.from_pretrained(path), patch_size=14,
                   vision_feature_select_strategy="default",
                   num_additional_image_tokens=1).save_pretrained(path)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    return path, sd


def test_sharded_index_equals_safetensors(hf_dir):
    from safetensors.torch import load_file

    path, _ = hf_dir
    with open(os.path.join(path, "model.safetensors.index.json")) as f:
        weight_map = json.load(f)["weight_map"]
    assert len(set(weight_map.values())) >= 2
    assert any(k.startswith("language_model.model.") for k in weight_map)
    shards = {s: load_file(os.path.join(path, s)) for s in set(weight_map.values())}
    with safetensors_io.Checkpoint(path) as ckpt:
        assert set(ckpt.keys()) == set(weight_map)
        for k, s in weight_map.items():
            assert torch.equal(_bits(ckpt.tensor(k)), _bits(shards[s][k])), k


def _recording(tokenizer):
    rows = []
    decode = tokenizer.decode

    def recorded(ids, skip_special_tokens=False):
        rows.append([int(i) for i in ids])
        return decode(ids, skip_special_tokens=skip_special_tokens)

    tokenizer.decode = recorded
    return rows


def test_torch_vlm_from_files_equals_jax(hf_dir):
    """float32 on the CPU: input ids and pixels against JAX's
    ``AutoProcessor``, greedy tokens and decoded answers against
    ``JaxVipLlava`` on ``convert_hf`` of the same arrays."""
    from PIL import Image

    path, sd = hf_dir
    port = tret.TorchVipLlava(path, device="cpu", draft_tokens=0)
    assert port.cfg == CFG and port.params["language"]["lm_head"].dtype == torch.float32
    ref = jret.JaxVipLlava(path, params=jvl.convert_hf(sd, JCFG), cfg=JCFG, draft_tokens=0)
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (70, 90, 3)).astype(np.uint8)
    name_q = VLM_SYSTEM_TEMPLATE.format(VISUAL_PROMPTS["contour"].format("red"))
    def_q = VLM_SYSTEM_TEMPLATE.format(VISUAL_PROMPTS_DESCRIPTIONS["bb"].format(
        "dog", "blue", "dog", "dog"))
    for q in (name_q, def_q):
        mine = port.processor(text=q, images=img, return_tensors="np")
        theirs = ref.processor(text=q, images=Image.fromarray(img), return_tensors="np")
        np.testing.assert_array_equal(mine["input_ids"], theirs["input_ids"])
        np.testing.assert_allclose(mine["pixel_values"], theirs["pixel_values"], rtol=0,
                                   atol=1e-6)
    got_rows, want_rows = _recording(port.processor.tokenizer), _recording(
        ref.processor.tokenizer)
    got = [port.generate(img, name_q, max_new_tokens=8),
           port.generate(img, def_q, max_new_tokens=12, min_new_tokens=6)]
    want = [ref.generate(img, name_q, max_new_tokens=8),
            ref.generate(img, def_q, max_new_tokens=12, min_new_tokens=6)]
    assert got_rows == want_rows and all(len(r) for r in got_rows)
    assert got == want and any(got)


def test_torch_vlm_without_device_takes_the_card(hf_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tret.TorchVipLlava(hf_dir[0])


def test_written_directory_loads_in_transformers(tmp_path):
    """The layout ``vip_llava_files`` writes (``chip_smoke.py``'s) is the
    one transformers reads: every tensor taken, none left over, and the
    same input ids as the port's processor."""
    from transformers import AutoProcessor, VipLlavaForConditionalGeneration

    path = str(tmp_path)
    write_vip_llava_dir(path, CFG, random_state_dict(CFG, seed=5, dtype=torch.float32),
                        tokenizer_spec(PIECES, seed=1, corpus=PROMPTS), shard_bytes=60_000)
    _, info = VipLlavaForConditionalGeneration.from_pretrained(path, output_loading_info=True)
    assert not any(info.values()), info
    img = np.random.RandomState(6).randint(0, 256, (61, 47, 3)).astype(np.uint8)
    q = PROMPTS[5]
    want = AutoProcessor.from_pretrained(path)(text=q, images=img, return_tensors="np")
    got = tproc.load(path)(text=q, images=img)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], rtol=0, atol=1e-6)
