"""Parameter converters (port of ``mars_tpu/models/convert.py``).

Two sources, one layout: the port's towers take the JAX package's nested
parameter dicts (dense kernels (in, out), conv kernels HWIO, transposed-conv
kernels (kh, kw, O, I)).

  - ``from_jax_params(tree)``: a JAX parameter tree materialized to numpy
    (``jax.tree.map(np.asarray, params)``) → the same tree of tensors, so
    both packages compute with the same numbers in the tests.
  - ``from_reference_state_dict(sd, tower, depth)``: reference-format torch
    key names (flat name → array) → the tree for one tower, without JAX.
  - ``resnet_tree(sd, layers)``: a torchvision ResNet state dict → the
    Matcher's alternative encoder (BatchNorm folded).
  - ``vip_llava_tree(sd, v_layers, layers)``: an HF ViP-LLaVA state dict →
    the VLM's tree (numpy), which ``models.vip_llava.convert_hf`` makes
    tensors of.
  - ``reference_state_dict(tree, tower)``: the inverse for the ranking
    towers, a tree back to the reference's key names (seeded weights
    written as the checkpoint files the zoo reads).
  - ``swin_tree`` / ``swin_semantic_sam_tree`` (transformers' and
    Microsoft's Swin names), ``semantic_sam_pixel_decoder_tree`` (MaskDINO's
    and transformers' names) and ``semantic_sam_point_decoder_tree``: the
    Semantic-SAM checkpoint's sections (JAX ``convert.py:307-600``).
  - ``audited_trees(sd, parts, ignore)``: several converters over one
    checkpoint under ``AuditedStateDict`` (the JAX package's
    ``audit_conversion``), raising on a key no converter read or a leaf
    missing, extra or of another shape than the tower's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


_QUANTIZED = ("q", "q4", "nf4")


def from_jax_params(tree, device="cpu", dtype=torch.float32):
    """Nested dict of arrays → the same nested dict of tensors, floating
    leaves at ``dtype``.  A weight-only quantized kernel (a dict holding
    ``q``, ``q4`` or ``nf4``) keeps its int8 codes and float32 scales
    whatever ``dtype`` is, as the kernels' contract requires."""
    if isinstance(tree, dict):
        sub = torch.float32 if any(k in tree for k in _QUANTIZED) else dtype
        return {k: from_jax_params(v, device, sub) for k, v in tree.items()}
    a = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype if a.dtype.kind == "f" else t.dtype)


def _t(w):
    """torch Linear weight (out, in) → dense kernel (in, out)."""
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):
    """torch Conv2d weight (O, I, kh, kw) → HWIO kernel (kh, kw, I, O).
    The same axis order takes a ConvTranspose2d weight (I, O, kh, kw) to
    (kh, kw, O, I), the layout of the JAX package's
    ``conv_transpose(transpose_kernel=True)`` and ``models.sam._conv_transpose``."""
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


class AuditedStateDict:
    """A checkpoint that records which keys the converters read (port of
    the JAX package's ``AuditedStateDict``).  Reading ``sd[k]`` consumes k;
    ``k in sd`` and iterating the keys do not.  ``rekeyed`` views (a prefix
    stripped or selected) record under the checkpoint's own names."""

    def __init__(self, sd, consumed=None, origin=None):
        self.sd = sd
        self.consumed = set() if consumed is None else consumed
        self.origin = origin  # view key → checkpoint key; None: the same

    def __getitem__(self, k):
        v = self.sd[k]
        self.consumed.add(k if self.origin is None else self.origin[k])
        return v

    def __contains__(self, k):
        return k in self.sd

    def __iter__(self):
        return iter(self.sd)

    def keys(self):
        return self.sd.keys()

    def rekeyed(self, fn) -> "AuditedStateDict":
        sd, origin = {}, {}
        for k, v in self.sd.items():
            nk = fn(k)
            if nk is not None:
                sd[nk] = v
                origin[nk] = k if self.origin is None else self.origin[k]
        return AuditedStateDict(sd, self.consumed, origin)


def _rekey(sd, fn):
    """The keys mapped by ``fn`` (None drops one), as a view if ``sd`` is
    audited."""
    if isinstance(sd, AuditedStateDict):
        return sd.rekeyed(fn)
    return {fn(k): v for k, v in sd.items() if fn(k) is not None}


def _strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    return _rekey(sd, lambda k: k[len(prefix):] if k.startswith(prefix) else k)


def _ln(sd: StateDict, name: str) -> dict:
    return {"scale": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _dense(sd: StateDict, name: str) -> dict:
    out = {"kernel": _t(sd[f"{name}.weight"])}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def dinov2_tree(sd: StateDict, depth: int, num_register_tokens: int = 4) -> dict:
    """DINOv2 checkpoint names (dinov2/models/vision_transformer.py)."""
    for p in ("teacher.backbone.", "teacher.", "backbone."):
        if any(k.startswith(p) for k in sd):
            sd = _strip_prefix(sd, p)
    params = {
        "patch_embed": {"kernel": _conv(sd["patch_embed.proj.weight"]),
                        "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
        "norm": _ln(sd, "norm"),
    }
    if num_register_tokens:
        params["register_tokens"] = sd["register_tokens"]
    for i in range(depth):
        b = f"blocks.{i}"
        blk = {
            "ln1": _ln(sd, f"{b}.norm1"),
            "ln2": _ln(sd, f"{b}.norm2"),
            "attn": {"qkv": _dense(sd, f"{b}.attn.qkv"), "proj": _dense(sd, f"{b}.attn.proj")},
            "mlp": {"fc1": _dense(sd, f"{b}.mlp.fc1"), "fc2": _dense(sd, f"{b}.mlp.fc2")},
        }
        if f"{b}.ls1.gamma" in sd:
            blk["ls1"] = {"gamma": sd[f"{b}.ls1.gamma"]}
            blk["ls2"] = {"gamma": sd[f"{b}.ls2.gamma"]}
        params[f"block{i}"] = blk
    return params


def _clip_block(sd: StateDict, b: str) -> dict:
    """CLIP's MultiheadAttention packs qkv as in_proj_weight/in_proj_bias;
    AlphaCLIP's visual tower uses an nn.Linear in_proj (in_proj.weight),
    and the AlphaCLIP zoo renames its base checkpoint's text tower so."""
    qkv = (_dense(sd, f"{b}.attn.in_proj") if f"{b}.attn.in_proj.weight" in sd else
           {"kernel": _t(sd[f"{b}.attn.in_proj_weight"]), "bias": sd[f"{b}.attn.in_proj_bias"]})
    return {
        "ln1": _ln(sd, f"{b}.ln_1"),
        "ln2": _ln(sd, f"{b}.ln_2"),
        "attn": {"qkv": qkv, "proj": _dense(sd, f"{b}.attn.out_proj")},
        "mlp": {"fc1": _dense(sd, f"{b}.mlp.c_fc"), "fc2": _dense(sd, f"{b}.mlp.c_proj")},
    }


def clip_visual_tree(sd: StateDict, depth: int, alpha: bool = False) -> dict:
    """CLIP (or, with ``alpha``, AlphaCLIP) visual tower under ``visual.``."""
    v = _prefixed(sd, "visual.")
    params = {
        "patch_embed": {"kernel": _conv(v["conv1.weight"])},
        "class_embedding": v["class_embedding"],
        "pos_embed": np.asarray(v["positional_embedding"])[None],
        "ln_pre": _ln(v, "ln_pre"),
        "ln_post": _ln(v, "ln_post"),
        "proj": v["proj"],
    }
    if alpha:
        params["patch_embed_alpha"] = {"kernel": _conv(v["conv1_alpha.weight"])}
    for i in range(depth):
        params[f"block{i}"] = _clip_block(v, f"transformer.resblocks.{i}")
    return params


def clip_text_tree(sd: StateDict, depth: int) -> dict:
    params = {
        "token_embedding": {"embedding": sd["token_embedding.weight"]},
        "pos_embed": sd["positional_embedding"],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }
    for i in range(depth):
        params[f"block{i}"] = _clip_block(sd, f"transformer.resblocks.{i}")
    return params


def _prefixed(sd: StateDict, prefix: str) -> StateDict:
    return _rekey(sd, lambda k: k[len(prefix):] if k.startswith(prefix) else None)


def sam_encoder_tree(sd: StateDict, depth: int) -> dict:
    """SAM checkpoint names under ``image_encoder.`` (segment_anything/modeling)."""
    e = _prefixed(sd, "image_encoder.")
    params = {
        "patch_embed": {"kernel": _conv(e["patch_embed.proj.weight"]),
                        "bias": e["patch_embed.proj.bias"]},
        "pos_embed": e["pos_embed"],
        "neck_conv1": {"kernel": _conv(e["neck.0.weight"])},
        "neck_ln1": _ln(e, "neck.1"),
        "neck_conv2": {"kernel": _conv(e["neck.2.weight"])},
        "neck_ln2": _ln(e, "neck.3"),
    }
    for i in range(depth):
        b = f"blocks.{i}"
        attn = {"qkv": _dense(e, f"{b}.attn.qkv"), "proj": _dense(e, f"{b}.attn.proj")}
        if f"{b}.attn.rel_pos_h" in e:
            attn["rel_pos_h"] = e[f"{b}.attn.rel_pos_h"]
            attn["rel_pos_w"] = e[f"{b}.attn.rel_pos_w"]
        params[f"block{i}"] = {
            "ln1": _ln(e, f"{b}.norm1"), "ln2": _ln(e, f"{b}.norm2"), "attn": attn,
            "mlp": {"fc1": _dense(e, f"{b}.mlp.lin1"), "fc2": _dense(e, f"{b}.mlp.lin2")},
        }
    return params


def sam_prompt_encoder_tree(sd: StateDict) -> dict:
    p = _prefixed(sd, "prompt_encoder.")

    def conv(i):
        return {"kernel": _conv(p[f"mask_downscaling.{i}.weight"]),
                "bias": p[f"mask_downscaling.{i}.bias"]}

    return {
        "pe_gaussian": p["pe_layer.positional_encoding_gaussian_matrix"],
        "not_a_point_embed": p["not_a_point_embed.weight"],
        "no_mask_embed": p["no_mask_embed.weight"],
        # neg, pos, box top-left, box bottom-right
        "point_embeddings": np.stack([np.asarray(p[f"point_embeddings.{i}.weight"])[0]
                                      for i in range(4)]),
        "mask_downscale": {"conv1": conv(0), "ln1": _ln(p, "mask_downscaling.1"),
                           "conv2": conv(3), "ln2": _ln(p, "mask_downscaling.4"),
                           "conv3": conv(6)},
    }


def _sam_attn(sd: StateDict, b: str) -> dict:
    return {"q": _dense(sd, f"{b}.q_proj"), "k": _dense(sd, f"{b}.k_proj"),
            "v": _dense(sd, f"{b}.v_proj"), "out": _dense(sd, f"{b}.out_proj")}


def sam_decoder_tree(sd: StateDict, depth: int = 2) -> dict:
    d = _prefixed(sd, "mask_decoder.")
    t = {}
    for i in range(depth):
        b = f"transformer.layers.{i}"
        t[f"layer{i}"] = {
            "self_attn": _sam_attn(d, f"{b}.self_attn"),
            "norm1": _ln(d, f"{b}.norm1"),
            "cross_attn_t2i": _sam_attn(d, f"{b}.cross_attn_token_to_image"),
            "norm2": _ln(d, f"{b}.norm2"),
            "mlp": {"fc1": _dense(d, f"{b}.mlp.lin1"), "fc2": _dense(d, f"{b}.mlp.lin2")},
            "norm3": _ln(d, f"{b}.norm3"),
            "cross_attn_i2t": _sam_attn(d, f"{b}.cross_attn_image_to_token"),
            "norm4": _ln(d, f"{b}.norm4"),
        }
    t["final_attn"] = _sam_attn(d, "transformer.final_attn_token_to_image")
    t["norm_final"] = _ln(d, "transformer.norm_final_attn")
    n_masks = np.asarray(d["mask_tokens.weight"]).shape[0]
    iou_layers = sorted({int(k.split(".")[2]) for k in d
                         if k.startswith("iou_prediction_head.layers.")})
    return {
        "iou_token": d["iou_token.weight"],
        "mask_tokens": d["mask_tokens.weight"],
        "transformer": t,
        "upscale_conv1": {"kernel": _conv(d["output_upscaling.0.weight"]),
                          "bias": d["output_upscaling.0.bias"]},
        "upscale_ln": _ln(d, "output_upscaling.1"),
        "upscale_conv2": {"kernel": _conv(d["output_upscaling.3.weight"]),
                          "bias": d["output_upscaling.3.bias"]},
        "hypernetworks": {f"mlp{i}": {f"layer{j}": _dense(d, f"output_hypernetworks_mlps.{i}"
                                                          f".layers.{j}") for j in range(3)}
                          for i in range(n_masks)},
        "iou_head": {f"layer{j}": _dense(d, f"iou_prediction_head.layers.{j}")
                     for j in iou_layers},
    }


def _folded_bn(sd: StateDict, prefix: str, eps: float = 1e-5) -> dict:
    """Inference BatchNorm folded to y = x · scale + bias."""
    w, b = np.asarray(sd[prefix + ".weight"]), np.asarray(sd[prefix + ".bias"])
    mean, var = np.asarray(sd[prefix + ".running_mean"]), np.asarray(sd[prefix + ".running_var"])
    scale = w / np.sqrt(var + eps)
    return {"scale": scale.astype(np.float32), "bias": (b - mean * scale).astype(np.float32)}


def resnet_tree(sd: StateDict, layers) -> dict:
    """torchvision ResNet (v1.5 bottlenecks) names → the trunk's tree, BN
    folded (the JAX package's ``resnet.convert_torchvision``); ``layers``:
    blocks a stage.  ``fc.*`` and ``num_batches_tracked`` are not read."""
    out = {"stem": {"kernel": _conv(sd["conv1.weight"])}, "stem_bn": _folded_bn(sd, "bn1")}
    for s, n in enumerate(layers):
        stage = {}
        for i in range(n):
            pre = f"layer{s + 1}.{i}"
            blk = {}
            for j in (1, 2, 3):
                blk[f"conv{j}"] = {"kernel": _conv(sd[f"{pre}.conv{j}.weight"])}
                blk[f"bn{j}"] = _folded_bn(sd, f"{pre}.bn{j}")
            if pre + ".downsample.0.weight" in sd:
                blk["downsample"] = {"conv": {"kernel": _conv(sd[pre + ".downsample.0.weight"])},
                                     "bn": _folded_bn(sd, pre + ".downsample.1")}
            stage[f"block{i}"] = blk
        out[f"layer{s + 1}"] = stage
    return out


def vip_llava_tree(sd: StateDict, v_layers: int, layers: int) -> dict:
    """HF ``VipLlavaForConditionalGeneration`` state dict (numpy) → the
    parameter tree of ``models.vip_llava`` (the JAX package's ``convert_hf``
    layout): HF-CLIP vision tower, the multi-layer projector, LLaMA."""
    v = "model.vision_tower.vision_model."
    vision = {
        "patch_embed": {"kernel": _conv(sd[v + "embeddings.patch_embedding.weight"])},
        "class_embedding": sd[v + "embeddings.class_embedding"],
        "position_embedding": sd[v + "embeddings.position_embedding.weight"],
        "pre_layernorm": _ln(sd, v + "pre_layrnorm"),
    }
    for i in range(v_layers):
        b = f"{v}encoder.layers.{i}."
        vision[f"layer{i}"] = {
            "ln1": _ln(sd, b + "layer_norm1"), "ln2": _ln(sd, b + "layer_norm2"),
            "attn": {n: _dense(sd, f"{b}self_attn.{n}_proj") for n in ("q", "k", "v", "out")},
            "mlp": {"fc1": _dense(sd, b + "mlp.fc1"), "fc2": _dense(sd, b + "mlp.fc2")},
        }
    mp = "model.multi_modal_projector."
    projector = {"ln": _ln(sd, mp + "projector_layernorm"),
                 "linear_1": _dense(sd, mp + "linear_1"), "linear_2": _dense(sd, mp + "linear_2")}
    lm = "model.language_model."
    language = {"embed_tokens": sd[lm + "embed_tokens.weight"], "norm": sd[lm + "norm.weight"],
                "lm_head": _t(sd["lm_head.weight"])}
    for i in range(layers):
        b = f"{lm}layers.{i}."
        language[f"layer{i}"] = {
            "input_ln": sd[b + "input_layernorm.weight"],
            "post_ln": sd[b + "post_attention_layernorm.weight"],
            "attn": {n: _dense(sd, f"{b}self_attn.{n}_proj") for n in ("q", "k", "v", "o")},
            "mlp": {n: _dense(sd, f"{b}mlp.{n}_proj") for n in ("gate", "up", "down")},
        }
    return {"vision": vision, "projector": projector, "language": language}


def swin_tree(sd: StateDict, depths) -> dict:
    """transformers ``SwinModel`` names → the ``models.swin`` tree (JAX
    ``swin_to_flax``)."""
    params = {"patch_embed": {"kernel": _conv(sd["embeddings.patch_embeddings.projection.weight"]),
                              "bias": sd["embeddings.patch_embeddings.projection.bias"]},
              "patch_norm": _ln(sd, "embeddings.norm")}
    for s, depth in enumerate(depths):
        stage = {}
        for i in range(depth):
            b = f"encoder.layers.{s}.blocks.{i}"
            names = ("query", "key", "value")
            stage[f"block{i}"] = {
                "ln1": _ln(sd, f"{b}.layernorm_before"),
                "ln2": _ln(sd, f"{b}.layernorm_after"),
                "attn": {
                    "qkv": {"kernel": np.concatenate(
                                [_t(sd[f"{b}.attention.self.{n}.weight"]) for n in names], axis=1),
                            "bias": np.concatenate(
                                [sd[f"{b}.attention.self.{n}.bias"] for n in names])},
                    "proj": _dense(sd, f"{b}.attention.output.dense"),
                    "rel_bias_table": sd[f"{b}.attention.self.relative_position_bias_table"]},
                "mlp": {"fc1": _dense(sd, f"{b}.intermediate.dense"),
                        "fc2": _dense(sd, f"{b}.output.dense")},
            }
        ds = f"encoder.layers.{s}.downsample"
        if f"{ds}.reduction.weight" in sd:
            stage["downsample"] = {"norm": _ln(sd, f"{ds}.norm"),
                                   "reduction": {"kernel": _t(sd[f"{ds}.reduction.weight"])}}
        params[f"stage{s}"] = stage
    return params


def swin_semantic_sam_tree(sd: StateDict, depths) -> dict:
    """Microsoft-layout Swin (fused qkv; Semantic-SAM checkpoints carry it
    under ``backbone.``) → the ``models.swin`` tree (JAX
    ``swin_semantic_sam_to_flax``): ``patch_embed.{proj,norm}``,
    ``layers.{s}.blocks.{i}.{norm1,norm2,attn.qkv,attn.proj,mlp.fc1,mlp.fc2,
    attn.relative_position_bias_table}``, ``layers.{s}.downsample``."""
    params = {"patch_embed": {"kernel": _conv(sd["patch_embed.proj.weight"]),
                              "bias": sd["patch_embed.proj.bias"]},
              "patch_norm": _ln(sd, "patch_embed.norm")}
    for s, depth in enumerate(depths):
        stage = {}
        for i in range(depth):
            b = f"layers.{s}.blocks.{i}"
            stage[f"block{i}"] = {
                "ln1": _ln(sd, f"{b}.norm1"), "ln2": _ln(sd, f"{b}.norm2"),
                "attn": {"qkv": _dense(sd, f"{b}.attn.qkv"), "proj": _dense(sd, f"{b}.attn.proj"),
                         "rel_bias_table": sd[f"{b}.attn.relative_position_bias_table"]},
                "mlp": {"fc1": _dense(sd, f"{b}.mlp.fc1"), "fc2": _dense(sd, f"{b}.mlp.fc2")},
            }
        ds = f"layers.{s}.downsample"
        if f"{ds}.reduction.weight" in sd:
            stage["downsample"] = {"norm": _ln(sd, f"{ds}.norm"),
                                   "reduction": {"kernel": _t(sd[f"{ds}.reduction.weight"])}}
        params[f"stage{s}"] = stage
    return params


def _first(sd: StateDict, *names: str):
    """The first of ``names`` the checkpoint holds (one name a dialect)."""
    for n in names:
        if n in sd:
            return sd[n]
    raise KeyError(f"none of {names} in state dict")


def _gn(sd: StateDict, *names: str) -> dict:
    return {"scale": _first(sd, *(f"{n}.weight" for n in names)),
            "bias": _first(sd, *(f"{n}.bias" for n in names))}


def _conv1x1_dense(w) -> np.ndarray:
    """torch 1x1 Conv2d weight (O, I, 1, 1) → dense kernel (I, O)."""
    return np.ascontiguousarray(np.asarray(w)[:, :, 0, 0].T)


def semantic_sam_pixel_decoder_tree(sd: StateDict, enc_layers: int) -> dict:
    """Pixel-decoder tensors → the ``models.semantic_sam`` subtree
    (``input_proj{0..2}``, ``level_embed``, ``enc{i}``, ``adapter``,
    ``layer``, ``mask_projection``), in both dialects of the same decoder
    (JAX ``semantic_sam_pixel_decoder_to_flax``):

    - detectron2/MaskDINO, under ``sem_seg_head.pixel_decoder.`` in
      Semantic-SAM checkpoints: ``input_proj.{i}.{0,1}``,
      ``transformer.level_embed``, ``transformer.encoder.layers.{i}.
      {self_attn,norm1,linear1,linear2,norm2}``, ``adapter_1.{weight,norm}``,
      ``layer_1.{weight,norm}``, ``mask_features``;
    - transformers ``Mask2FormerPixelDecoder``: ``input_projections.{i}.
      {0,1}``, ``level_embed``, ``encoder.layers.{i}.{self_attn,
      self_attn_layer_norm,fc1,fc2,final_layer_norm}``, ``adapter_1.{0,1}``,
      ``layer_1.{0,1}``, ``mask_projection``.

    Level 0 is res5 in both."""
    params = {"level_embed": _first(sd, "transformer.level_embed", "level_embed")}
    for lev in range(3):
        names = (f"input_proj.{lev}", f"input_projections.{lev}")
        params[f"input_proj{lev}"] = {
            "proj": {"kernel": _conv1x1_dense(_first(sd, *(f"{n}.0.weight" for n in names))),
                     "bias": _first(sd, *(f"{n}.0.bias" for n in names))},
            "norm": _gn(sd, *(f"{n}.1" for n in names))}
    for i in range(enc_layers):
        bases = (f"transformer.encoder.layers.{i}", f"encoder.layers.{i}")

        def pick(subs, leaf):
            return _first(sd, *(f"{b}.{s}.{leaf}" for b in bases for s in subs))

        def dns(*subs):
            return {"kernel": _t(pick(subs, "weight")), "bias": pick(subs, "bias")}

        def lnp(*subs):
            return {"scale": pick(subs, "weight"), "bias": pick(subs, "bias")}

        params[f"enc{i}"] = {
            "msda": {k: dns(f"self_attn.{k}") for k in
                     ("value_proj", "sampling_offsets", "attention_weights", "output_proj")},
            "ln1": lnp("norm1", "self_attn_layer_norm"),
            "ln2": lnp("norm2", "final_layer_norm"),
            "ffn": {"fc1": dns("linear1", "fc1"), "fc2": dns("linear2", "fc2")}}
    params["adapter"] = {
        "conv": {"kernel": _conv1x1_dense(_first(sd, "adapter_1.weight", "adapter_1.0.weight"))},
        "norm": _gn(sd, "adapter_1.norm", "adapter_1.1")}
    params["layer"] = {"conv": {"kernel": _conv(_first(sd, "layer_1.weight", "layer_1.0.weight"))},
                       "norm": _gn(sd, "layer_1.norm", "layer_1.1")}
    params["mask_projection"] = {
        "kernel": _conv1x1_dense(_first(sd, "mask_features.weight", "mask_projection.weight")),
        "bias": _first(sd, "mask_features.bias", "mask_projection.bias")}
    return params


def semantic_sam_point_decoder_tree(sd: StateDict, dec_layers: int) -> dict:
    """Interactive point-decoder tensors (``sem_seg_head.predictor.`` of a
    Semantic-SAM checkpoint) → the ``dec{i}``, ``mask_embed``, ``iou_head``
    and ``granularity_embed`` subtree (JAX
    ``semantic_sam_point_decoder_to_flax``).  MaskDINO / Deformable-DETR
    names: a DETR self-attention (fused ``in_proj_weight``), an MSDeformAttn
    ``cross_attn``, norms in Deformable-DETR order (norm2 after the
    self-attention, norm1 after the cross-attention, norm3 after the FFN:
    ln1, ln2, ln3 here); transformers' ``DeformableDetrDecoderLayer``
    spellings as a second dialect.  The granularity queries are
    ``query_feat``, ``query_embed`` or ``pattern``; when none is there the
    leaf is missing and the audit reports it."""
    params = {}
    for n in ("query_feat.weight", "query_embed.weight", "pattern.weight"):
        if n in sd:
            params["granularity_embed"] = sd[n]
            break
    for i in range(dec_layers):
        bases = (f"transformer.decoder.layers.{i}", f"decoder.layers.{i}", f"layers.{i}")

        def first(*subs):
            return _first(sd, *(f"{b}.{s}" for b in bases for s in subs))

        def dns(*subs):
            return {"kernel": _t(first(*(f"{s}.weight" for s in subs))),
                    "bias": first(*(f"{s}.bias" for s in subs))}

        def lnp(*subs):
            return {"scale": first(*(f"{s}.weight" for s in subs)),
                    "bias": first(*(f"{s}.bias" for s in subs))}

        params[f"dec{i}"] = {
            "self_attn": {"qkv": {"kernel": _t(first("self_attn.in_proj_weight")),
                                  "bias": first("self_attn.in_proj_bias")},
                          "proj": dns("self_attn.out_proj")},
            "msda": {k: dns(f"cross_attn.{k}", f"encoder_attn.{k}")
                     for k in ("value_proj", "sampling_offsets", "attention_weights",
                               "output_proj")},
            "ln1": lnp("norm2", "self_attn_layer_norm"),
            "ln2": lnp("norm1", "encoder_attn_layer_norm"),
            "ln3": lnp("norm3", "final_layer_norm"),
            "ffn": {"fc1": dns("linear1", "fc1"), "fc2": dns("linear2", "fc2")}}
    for head, names in (("mask_embed", ("mask_embed",)),
                        ("iou_head", ("iou_prediction_head", "iou_embed"))):
        params[head] = {f"l{j}": {"kernel": _t(_first(sd, *(f"{n}.layers.{j}.weight"
                                                            for n in names))),
                                  "bias": _first(sd, *(f"{n}.layers.{j}.bias" for n in names))}
                        for j in range(3)}
    return params


def from_reference_state_dict(sd: StateDict, tower: str, depth: int = 0,
                              num_register_tokens: int = 4, device="cpu"):
    """Reference-format state dict → parameter tree of tensors for
    ``tower`` in {dinov2, clip_visual, alpha_clip_visual, clip_text,
    sam_encoder, sam_prompt_encoder, sam_decoder} (``depth``: blocks of the
    tower; the SAM decoder's two-way layers, default 2)."""
    if tower == "sam_encoder":
        tree = sam_encoder_tree(sd, depth)
    elif tower == "sam_prompt_encoder":
        tree = sam_prompt_encoder_tree(sd)
    elif tower == "sam_decoder":
        tree = sam_decoder_tree(sd, depth or 2)
    elif tower == "dinov2":
        tree = dinov2_tree(sd, depth, num_register_tokens)
    elif tower in ("clip_visual", "alpha_clip_visual"):
        tree = clip_visual_tree(sd, depth, alpha=tower == "alpha_clip_visual")
    elif tower == "clip_text":
        tree = clip_text_tree(sd, depth)
    else:
        raise ValueError(f"unknown tower: {tower}")
    return from_jax_params(tree, device)


def logit_scale(sd: StateDict, device="cpu") -> torch.Tensor:
    return torch.tensor(float(np.asarray(sd["logit_scale"])), dtype=torch.float32, device=device)


def leaf_shapes(tree, prefix: str = "") -> dict:
    """Nested dict of arrays or of shape tuples → {dotted path: shape}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_shapes(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tuple(v) if isinstance(v, tuple) else tuple(np.shape(v))
    return out


def audit_conversion(fn, sd, *args, expected=None):
    """``fn(sd, *args)`` with consumption tracking (the JAX package's
    ``audit_conversion``) → (tree, report): ``unconsumed`` checkpoint keys
    (of this call's dict; with an ``AuditedStateDict`` shared by several
    calls, of all of them so far), and against ``expected`` (a tree of
    shapes) the leaf paths ``missing``, ``extra`` and ``shape_mismatch``."""
    asd = sd if isinstance(sd, AuditedStateDict) else AuditedStateDict(sd)
    tree = fn(asd, *args)
    report = {"unconsumed": sorted(set(asd.keys()) - asd.consumed)}
    if expected is not None:
        got, want = leaf_shapes(tree), leaf_shapes(expected)
        report["missing"] = sorted(set(want) - set(got))
        report["extra"] = sorted(set(got) - set(want))
        report["shape_mismatch"] = sorted((p, got[p], want[p]) for p in set(got) & set(want)
                                          if got[p] != want[p])
    return tree, report


def audited_trees(sd: StateDict, parts: dict, ignore=()) -> dict:
    """Run each of ``parts`` {name: (converter, args, expected shapes)} on
    one audited checkpoint → {name: numpy tree}.  Raises ``ValueError``
    when a key is left that no converter read (``ignore``: the keys the
    reference itself drops, such as a JIT archive's scalars) or a tree
    differs from its expected shapes."""
    asd = AuditedStateDict(sd)
    trees, faults = {}, []
    for name, (fn, args, expected) in parts.items():
        trees[name], report = audit_conversion(fn, asd, *args, expected=expected)
        faults += [f"{name} {kind}: {report[kind][:5]}"
                   for kind in ("missing", "extra", "shape_mismatch") if report[kind]]
    unconsumed = sorted(set(asd.keys()) - asd.consumed - set(ignore))
    if unconsumed:
        faults.append(f"unconsumed: {unconsumed[:5]} ({len(unconsumed)} keys)")
    if faults:
        raise ValueError("checkpoint conversion: " + "; ".join(faults))
    return trees


def _host(a) -> np.ndarray:
    return np.ascontiguousarray(a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                                else np.asarray(a))


def _put_ln(out: dict, name: str, leaf: dict) -> None:
    out[f"{name}.weight"], out[f"{name}.bias"] = _host(leaf["scale"]), _host(leaf["bias"])


def _put_dense(out: dict, name: str, leaf: dict) -> None:
    out[f"{name}.weight"] = np.ascontiguousarray(_host(leaf["kernel"]).T)
    if "bias" in leaf:
        out[f"{name}.bias"] = _host(leaf["bias"])


def _unconv(kernel) -> np.ndarray:
    """HWIO (kh, kw, I, O) → torch Conv2d (O, I, kh, kw), ``_conv``'s inverse."""
    return np.ascontiguousarray(np.transpose(_host(kernel), (3, 2, 0, 1)))


def _put_clip_block(out: dict, b: str, blk: dict, linear_in_proj: bool) -> None:
    _put_ln(out, f"{b}.ln_1", blk["ln1"])
    _put_ln(out, f"{b}.ln_2", blk["ln2"])
    if linear_in_proj:
        _put_dense(out, f"{b}.attn.in_proj", blk["attn"]["qkv"])
    else:
        out[f"{b}.attn.in_proj_weight"] = np.ascontiguousarray(
            _host(blk["attn"]["qkv"]["kernel"]).T)
        out[f"{b}.attn.in_proj_bias"] = _host(blk["attn"]["qkv"]["bias"])
    _put_dense(out, f"{b}.attn.out_proj", blk["attn"]["proj"])
    _put_dense(out, f"{b}.mlp.c_fc", blk["mlp"]["fc1"])
    _put_dense(out, f"{b}.mlp.c_proj", blk["mlp"]["fc2"])


def reference_state_dict(tree: dict, tower: str) -> StateDict:
    """A parameter tree (tensors or arrays) → the reference's flat key names
    and layouts for ``tower`` in {dinov2, clip_visual, alpha_clip_visual,
    clip_text}: the inverse of ``dinov2_tree``, ``clip_visual_tree`` and
    ``clip_text_tree`` (CLIP's visual keys under ``visual.``, AlphaCLIP's
    with its ``nn.Linear`` in_proj)."""
    out: StateDict = {}
    blocks = sorted((k for k in tree if k.startswith("block")), key=lambda k: int(k[5:]))
    if tower == "dinov2":
        out["patch_embed.proj.weight"] = _unconv(tree["patch_embed"]["kernel"])
        out["patch_embed.proj.bias"] = _host(tree["patch_embed"]["bias"])
        for name in ("cls_token", "pos_embed", "register_tokens"):
            if name in tree:
                out[name] = _host(tree[name])
        _put_ln(out, "norm", tree["norm"])
        for k in blocks:
            blk, b = tree[k], f"blocks.{k[5:]}"
            _put_ln(out, f"{b}.norm1", blk["ln1"])
            _put_ln(out, f"{b}.norm2", blk["ln2"])
            for part in ("qkv", "proj"):
                _put_dense(out, f"{b}.attn.{part}", blk["attn"][part])
            for part in ("fc1", "fc2"):
                _put_dense(out, f"{b}.mlp.{part}", blk["mlp"][part])
            for ls in ("ls1", "ls2"):
                if ls in blk:
                    out[f"{b}.{ls}.gamma"] = _host(blk[ls]["gamma"])
    elif tower in ("clip_visual", "alpha_clip_visual"):
        alpha = tower == "alpha_clip_visual"
        out["visual.conv1.weight"] = _unconv(tree["patch_embed"]["kernel"])
        if alpha:
            out["visual.conv1_alpha.weight"] = _unconv(tree["patch_embed_alpha"]["kernel"])
        out["visual.class_embedding"] = _host(tree["class_embedding"])
        out["visual.positional_embedding"] = np.ascontiguousarray(_host(tree["pos_embed"])[0])
        _put_ln(out, "visual.ln_pre", tree["ln_pre"])
        _put_ln(out, "visual.ln_post", tree["ln_post"])
        out["visual.proj"] = _host(tree["proj"])
        for k in blocks:
            _put_clip_block(out, f"visual.transformer.resblocks.{k[5:]}", tree[k], alpha)
    elif tower == "clip_text":
        out["token_embedding.weight"] = _host(tree["token_embedding"]["embedding"])
        out["positional_embedding"] = _host(tree["pos_embed"])
        _put_ln(out, "ln_final", tree["ln_final"])
        out["text_projection"] = _host(tree["text_projection"])
        for k in blocks:
            _put_clip_block(out, f"transformer.resblocks.{k[5:]}", tree[k], False)
    else:
        raise ValueError(f"unknown tower: {tower}")
    return out

