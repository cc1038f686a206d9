"""ViP-LLaVA directories in transformers' format, written without
transformers (the layout of ``llava-hf/vip-llava-7b-hf``): ``config.json``,
safetensors shards under the release's names with their index, a seeded
Llama ``tokenizer.json`` with its ``tokenizer_config.json`` and
``special_tokens_map.json``, ``preprocessor_config.json`` and
``processor_config.json``.  The CPU tests and ``chip_smoke.py`` write their
directories with it; it imports torch and numpy only.
"""
import json
import os
import struct

import numpy as np
import torch

SPACE = "▁"  # "▁", SentencePiece's word marker
SPECIALS = ("<unk>", "<s>", "</s>")
ALPHABET = (SPACE + "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
            ".,:;?!'\"-()/")
_CODES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
          torch.int64: "I64", torch.int32: "I32", torch.int8: "I8", torch.uint8: "U8",
          torch.bool: "BOOL"}


def _added(i, content):
    return {"id": i, "content": content, "single_word": False, "lstrip": False,
            "rstrip": False, "normalized": False, "special": True}


def _learn_merges(corpus, vocab, merges, limit):
    """Greedy BPE training on the words of ``corpus`` (each "▁"-prefixed):
    the most frequent adjacent pair merges next, ``limit`` merges at most."""
    words = {}
    for text in corpus:
        for w in text.split():
            key = tuple(SPACE + w)
            if all(c in vocab for c in key):
                words[key] = words.get(key, 0) + 1
    for _ in range(limit):
        pairs = {}
        for w, n in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] = pairs.get((a, b), 0) + n
        pairs = {p: n for p, n in pairs.items() if p[0] + p[1] not in vocab}
        if not pairs:
            return
        best = max(sorted(pairs), key=pairs.get)
        vocab[best[0] + best[1]] = len(vocab)
        merges.append(list(best))
        merged = {}
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + n
        words = merged


def tokenizer_spec(vocab_size: int = 32000, seed: int = 0, form: str = "legacy",
                   corpus=(), learnt: int = 400) -> dict:
    """A Llama ``tokenizer.json``: <unk> <s> </s>, the 256 byte pieces, the
    alphabet, merges learnt on ``corpus``, then seeded merges of random
    pairs up to ``vocab_size`` pieces; ``<image>`` and ``<pad>`` after them.
    ``form`` "legacy": the ``Prepend`` + ``Replace`` normalizer; "metaspace":
    the ``Metaspace`` pre-tokenizer, prepend scheme "first"."""
    vocab = {tok: i for i, tok in enumerate(SPECIALS)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for ch in ALPHABET:
        vocab[ch] = len(vocab)
    merges = []
    _learn_merges(corpus, vocab, merges, min(learnt, vocab_size - len(vocab)))
    rs = np.random.RandomState(seed)
    pieces = [t for t in vocab if not t.startswith("<")]
    while len(vocab) < vocab_size:
        a, b = pieces[rs.randint(len(pieces))], pieces[rs.randint(len(pieces))]
        if len(a + b) > 10 or a + b in vocab or (SPACE in b):
            continue
        vocab[a + b] = len(vocab)
        merges.append([a, b])
        pieces.append(a + b)
    decoder = {"type": "Sequence", "decoders": [
        {"type": "Replace", "pattern": {"String": SPACE}, "content": " "},
        {"type": "ByteFallback"}, {"type": "Fuse"},
        {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [_added(i, t) for i, t in enumerate(SPECIALS)]
        + [_added(vocab_size, "<image>"), _added(vocab_size + 1, "<pad>")],
        "normalizer": None, "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}},
        "decoder": decoder,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges}}
    if form == "legacy":
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": SPACE},
            {"type": "Replace", "pattern": {"String": " "}, "content": SPACE}]}
    elif form == "metaspace":
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": SPACE,
                                 "prepend_scheme": "first", "split": False}
    else:
        raise ValueError(f"unknown tokenizer form {form}")
    return spec


def write_tokenizer(path: str, spec: dict) -> None:
    """``spec`` and the configs ``LlamaTokenizerFast`` reads beside it."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    added = {str(t["id"]): {k: t[k] for k in ("content", "lstrip", "normalized", "rstrip",
                                              "single_word", "special")}
             for t in spec["added_tokens"]}
    config = {"add_bos_token": True, "add_eos_token": False, "added_tokens_decoder": added,
              "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>",
              "clean_up_tokenization_spaces": False, "legacy": spec["normalizer"] is not None,
              "model_max_length": 4096, "padding_side": "left",
              "processor_class": "LlavaProcessor", "tokenizer_class": "LlamaTokenizer"}
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f, indent=2)
    with open(os.path.join(path, "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                   "pad_token": "<pad>"}, f, indent=2)


def write_processor(path: str, image_size: int, patch_size: int) -> None:
    """``preprocessor_config.json`` (CLIP's, at ``image_size``) and
    ``processor_config.json`` (the ``<image>`` expansion)."""
    os.makedirs(path, exist_ok=True)
    pre = {"crop_size": {"height": image_size, "width": image_size}, "do_center_crop": True,
           "do_convert_rgb": True, "do_normalize": True, "do_rescale": True,
           "do_resize": True, "image_mean": [0.48145466, 0.4578275, 0.40821073],
           "image_processor_type": "CLIPImageProcessor",
           "image_std": [0.26862954, 0.26130258, 0.27577711],
           "processor_class": "LlavaProcessor", "resample": 3,
           "rescale_factor": 0.00392156862745098, "size": {"shortest_edge": image_size}}
    proc = {"image_token": "<image>", "num_additional_image_tokens": 1,
            "patch_size": patch_size, "processor_class": "LlavaProcessor",
            "vision_feature_select_strategy": "default"}
    for name, obj in (("preprocessor_config.json", pre), ("processor_config.json", proc)):
        with open(os.path.join(path, name), "w") as f:
            json.dump(obj, f, indent=2)


def hf_config(cfg) -> dict:
    """A ``VipLlavaConfig`` (the port's or JAX's) → transformers' ``config.json``."""
    return {
        "architectures": ["VipLlavaForConditionalGeneration"], "ignore_index": -100,
        "image_token_index": cfg.image_token_index, "model_type": "vipllava",
        "pad_token_id": cfg.image_token_index + 1, "projector_hidden_act": "gelu",
        "projector_layernorm_eps": 1e-05, "torch_dtype": "bfloat16",
        "vision_feature_layers": list(cfg.vision_feature_layers), "vocab_size": cfg.vocab,
        "text_config": {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                        "hidden_size": cfg.hidden, "intermediate_size": cfg.intermediate,
                        "num_hidden_layers": cfg.layers, "num_attention_heads": cfg.heads,
                        "num_key_value_heads": cfg.kv_heads, "max_position_embeddings": 4096,
                        "rms_norm_eps": cfg.rms_eps, "rope_theta": cfg.rope_theta,
                        "vocab_size": cfg.vocab},
        "vision_config": {"model_type": "clip_vision_model", "hidden_size": cfg.v_hidden,
                          "intermediate_size": cfg.v_intermediate,
                          "num_hidden_layers": cfg.v_layers,
                          "num_attention_heads": cfg.v_heads, "image_size": cfg.image_size,
                          "patch_size": cfg.patch_size, "projection_dim": 768}}


def release_shapes(cfg) -> dict:
    """{name: shape} of a ViP-LLaVA checkpoint under the release's names
    (``VipLlavaForConditionalGeneration.state_dict()``, CLIP's unused
    ``post_layernorm`` included)."""
    v, g = "vision_tower.vision_model.", cfg.image_size // cfg.patch_size
    d, hd = cfg.v_hidden, cfg.hidden // cfg.heads
    out = {v + "embeddings.class_embedding": (d,),
           v + "embeddings.patch_embedding.weight": (d, 3, cfg.patch_size, cfg.patch_size),
           v + "embeddings.position_embedding.weight": (g * g + 1, d),
           v + "pre_layrnorm.weight": (d,), v + "pre_layrnorm.bias": (d,)}
    for i in range(cfg.v_layers):
        b = f"{v}encoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            out[f"{b}self_attn.{n}_proj.weight"] = (d, d)
            out[f"{b}self_attn.{n}_proj.bias"] = (d,)
        for n in ("layer_norm1", "layer_norm2"):
            out[f"{b}{n}.weight"], out[f"{b}{n}.bias"] = (d,), (d,)
        out[b + "mlp.fc1.weight"], out[b + "mlp.fc1.bias"] = (cfg.v_intermediate, d), (
            cfg.v_intermediate,)
        out[b + "mlp.fc2.weight"], out[b + "mlp.fc2.bias"] = (d, cfg.v_intermediate), (d,)
    out[v + "post_layernorm.weight"], out[v + "post_layernorm.bias"] = (d,), (d,)
    feat = d * len(cfg.vision_feature_layers)
    mp = "multi_modal_projector."
    out.update({mp + "projector_layernorm.weight": (feat,),
                mp + "projector_layernorm.bias": (feat,),
                mp + "linear_1.weight": (cfg.hidden, feat), mp + "linear_1.bias": (cfg.hidden,),
                mp + "linear_2.weight": (cfg.hidden, cfg.hidden),
                mp + "linear_2.bias": (cfg.hidden,)})
    lm = "language_model.model."
    out[lm + "embed_tokens.weight"] = (cfg.vocab, cfg.hidden)
    for i in range(cfg.layers):
        b = f"{lm}layers.{i}."
        out[b + "input_layernorm.weight"] = out[b + "post_attention_layernorm.weight"] = (
            cfg.hidden,)
        out[b + "self_attn.q_proj.weight"] = out[b + "self_attn.o_proj.weight"] = (
            cfg.hidden, cfg.hidden)
        out[b + "self_attn.k_proj.weight"] = out[b + "self_attn.v_proj.weight"] = (
            cfg.kv_heads * hd, cfg.hidden)
        out[b + "mlp.gate_proj.weight"] = out[b + "mlp.up_proj.weight"] = (
            cfg.intermediate, cfg.hidden)
        out[b + "mlp.down_proj.weight"] = (cfg.hidden, cfg.intermediate)
    out[lm + "norm.weight"] = (cfg.hidden,)
    out["language_model.lm_head.weight"] = (cfg.vocab, cfg.hidden)
    return out


def random_state_dict(cfg, seed: int = 0, dtype=torch.bfloat16, device="cpu") -> dict:
    """``release_shapes(cfg)`` drawn from a seeded generator on ``device``:
    norm weights near 1, biases and every other tensor N(0, 0.02²)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in release_shapes(cfg).items():
        t = torch.randn(shape, generator=gen, device=device) * 0.02
        if "norm" in name and name.endswith("weight"):
            t = t + 1.0
        out[name] = t.to(dtype)
    return out


def write_safetensors(path: str, tensors: dict) -> None:
    """{name: tensor} → one ``.safetensors`` file (the header padded with
    spaces to 8 bytes, as the format's own writer pads it), each tensor's
    bytes written as they come off its device."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())


def write_checkpoint(path: str, tensors: dict, shard_bytes: int) -> list:
    """{name: tensor} → shards of at most ``shard_bytes`` (one tensor may
    exceed it) named as transformers names them, with
    ``model.safetensors.index.json``; one shard is ``model.safetensors``.
    → the file names."""
    os.makedirs(path, exist_ok=True)
    shards, size = [{}], 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += n
    if len(shards) == 1:
        write_safetensors(os.path.join(path, "model.safetensors"), shards[0])
        return ["model.safetensors"]
    names = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
    weight_map = {}
    for fname, shard in zip(names, shards):
        write_safetensors(os.path.join(path, fname), shard)
        weight_map.update({k: fname for k in shard})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return names


def write_vip_llava_dir(path: str, cfg, tensors: dict, spec: dict, shard_bytes: int) -> None:
    """A whole ViP-LLaVA directory: ``cfg``'s ``config.json``, ``tensors``
    (release names) in shards, the tokenizer ``spec`` and the processor."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config(cfg), f, indent=2)
    write_checkpoint(path, tensors, shard_bytes)
    write_tokenizer(path, spec)
    write_processor(path, cfg.image_size, cfg.patch_size)
