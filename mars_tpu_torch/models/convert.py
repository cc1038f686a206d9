"""Parameter converters (port of ``mars_tpu/models/convert.py:24-190``).

Two sources, one layout: the port's towers take the JAX package's nested
parameter dicts (dense kernels (in, out), conv kernels HWIO).

  - ``from_jax_params(tree)``: a JAX parameter tree materialized to numpy
    (``jax.tree.map(np.asarray, params)``) → the same tree of tensors, so
    both packages compute with the same numbers in the tests.
  - ``from_reference_state_dict(sd, tower, depth)``: reference-format torch
    key names (flat name → array) → the tree for one tower, without JAX.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


def from_jax_params(tree, device="cpu", dtype=torch.float32):
    """Nested dict of arrays → the same nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device, dtype) for k, v in tree.items()}
    a = np.asarray(tree)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype if a.dtype.kind == "f" else t.dtype)


def _t(w):
    """torch Linear weight (out, in) → dense kernel (in, out)."""
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):
    """torch Conv2d weight (O, I, kh, kw) → HWIO kernel (kh, kw, I, O)."""
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


def from_reference_state_dict(sd: StateDict, tower: str, depth: int,
                              num_register_tokens: int = 4, device="cpu"):
    """Reference-format state dict → parameter tree of tensors for
    ``tower`` in {dinov2, clip_visual, alpha_clip_visual, clip_text}."""
    if tower == "dinov2":
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
