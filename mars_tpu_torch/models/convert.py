"""Parameter converters (port of ``mars_tpu/models/convert.py:24-298``).

Two sources, one layout: the port's towers take the JAX package's nested
parameter dicts (dense kernels (in, out), conv kernels HWIO, transposed-conv
kernels (kh, kw, O, I)).

  - ``from_jax_params(tree)``: a JAX parameter tree materialized to numpy
    (``jax.tree.map(np.asarray, params)``) → the same tree of tensors, so
    both packages compute with the same numbers in the tests.
  - ``from_reference_state_dict(sd, tower, depth)``: reference-format torch
    key names (flat name → array) → the tree for one tower, without JAX.
  - ``vip_llava_tree(sd, v_layers, layers)``: an HF ViP-LLaVA state dict →
    the VLM's tree (numpy), which ``models.vip_llava.convert_hf`` makes
    tensors of.
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


def _strip_prefix(sd: StateDict, prefix: str) -> StateDict:
    return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()}


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


def _clip_block(sd: StateDict, b: str, linear_in_proj: bool) -> dict:
    """CLIP's MultiheadAttention packs qkv as in_proj_weight/in_proj_bias;
    AlphaCLIP's visual tower uses an nn.Linear in_proj."""
    qkv = (_dense(sd, f"{b}.attn.in_proj") if linear_in_proj else
           {"kernel": _t(sd[f"{b}.attn.in_proj_weight"]), "bias": sd[f"{b}.attn.in_proj_bias"]})
    return {
        "ln1": _ln(sd, f"{b}.ln_1"),
        "ln2": _ln(sd, f"{b}.ln_2"),
        "attn": {"qkv": qkv, "proj": _dense(sd, f"{b}.attn.out_proj")},
        "mlp": {"fc1": _dense(sd, f"{b}.mlp.c_fc"), "fc2": _dense(sd, f"{b}.mlp.c_proj")},
    }


def clip_visual_tree(sd: StateDict, depth: int, alpha: bool = False) -> dict:
    """CLIP (or, with ``alpha``, AlphaCLIP) visual tower under ``visual.``."""
    v = _strip_prefix({k: x for k, x in sd.items() if k.startswith("visual.")}, "visual.")
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
        params[f"block{i}"] = _clip_block(v, f"transformer.resblocks.{i}", linear_in_proj=alpha)
    return params


def clip_text_tree(sd: StateDict, depth: int) -> dict:
    params = {
        "token_embedding": {"embedding": sd["token_embedding.weight"]},
        "pos_embed": sd["positional_embedding"],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": sd["text_projection"],
    }
    for i in range(depth):
        params[f"block{i}"] = _clip_block(sd, f"transformer.resblocks.{i}", linear_in_proj=False)
    return params


def _prefixed(sd: StateDict, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


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
