"""Model zoo: the reference's checkpoints by file name, or full-width towers
with seeded random weights (port of ``mars_tpu/models/zoo.py``).

With ``models_path`` holding the reference's file for a tower (the names
below; reference models/README.md:4-10), its build function loads it
(``load_torch_state_dict``: a plain state dict, a ``{"model": ...}``
bundle or a TorchScript archive such as OpenAI's CLIP files) and converts
it under ``convert.audited_trees``, which raises on a key no converter
read or a tensor of another shape than the tower's.  Without the file it
builds the tower with seeded random weights, as the JAX package does
without checkpoints: norm scales and layerscale gammas are ones, biases
zeros, and every other leaf is uniform in [-0.035, 0.035]; here the draws
come from a ``torch.Generator`` on the target device, so the numbers
differ from JAX's threefry draws.  SAM's relative-position tables are
drawn like any other leaf (JAX's init zeroes them), so the bias path of
the grid attention is exercised.  ViP-LLaVA draws as the JAX package's
``vip_llava.init_random_params`` does (normal leaves, quantized kernels
drawn quantized).
"""
from __future__ import annotations

import math
import os
import zipfile
from typing import Optional

import torch

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.models import clip as clip_m
from mars_tpu_torch.models import convert
from mars_tpu_torch.models import dinov2
from mars_tpu_torch.models import resnet
from mars_tpu_torch.models import sam
from mars_tpu_torch.models import semantic_sam
from mars_tpu_torch.models import vip_llava

_DINO_LETTER = {"vit_small": "s", "vit_base": "b", "vit_large": "l", "vit_giant2": "g"}
# --vta-backbone spellings (main_MARS.py:144) → (checkpoint, visual and text configs)
CLIP_BACKBONES = {"ViT-B/16": ("ViT-B-16.pt", "CLIP_B16_VISUAL", "CLIP_B16_TEXT"),
                  "ViT-L/14": ("ViT-L-14.pt", "CLIP_L14_VISUAL", "CLIP_L14_TEXT")}
ALPHA_CLIP_BASE = "ViT-L-14-336px.pt"
ALPHA_CLIP_OVERRIDE = "clip_l14_336_grit_20m_4xe.pth"
SAM_CHECKPOINTS = {"vit_b": "sam_vit_b_01ec64.pth", "vit_l": "sam_vit_l_0b3195.pth",
                   "vit_h": "sam_vit_h_4b8939.pth"}
SEMANTIC_SAM_CHECKPOINT = "swinl_only_sam_many2many.pth"
SEMANTIC_SAM_VARIANTS = {"swinl": semantic_sam.SEMANTIC_SAM_L,
                         "tiny": semantic_sam.SEMANTIC_SAM_TINY}
# a Semantic-SAM checkpoint's sections, by the tree they fill
SEMANTIC_SAM_SECTIONS = {"backbone": "backbone.",
                         "pixel_decoder": "sem_seg_head.pixel_decoder.",
                         "point_decoder": "sem_seg_head.predictor."}
# keys the reference itself drops: DINOv2's training-time mask token; the
# scalars of OpenAI's JIT archives (clip/model.py:605-607); the CLIP-ES
# fork's resized position table, rebuilt from positional_embedding
IGNORED_KEYS = {"dinov2": ("mask_token",),
                "clip": ("input_resolution", "context_length", "vocab_size",
                         "visual.positional_embedding_new")}


def dinov2_checkpoint(variant: str, num_register_tokens: int) -> str:
    """``dinov2_vit{s,b,l,g}14[_reg4]_pretrain.pth``."""
    reg = "_reg4" if num_register_tokens else ""
    return f"dinov2_vit{_DINO_LETTER[variant]}14{reg}_pretrain.pth"


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive is a zip with a ``code/`` tree and
    ``constants.pkl``; ``torch.save`` zips have neither."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/constants.pkl") or "/code/" in n for n in z.namelist())


def load_torch_state_dict(path: str) -> dict:
    """A reference checkpoint → flat {name: numpy array} on the host: a plain
    state dict, a ``{"model": state dict}`` bundle, or a TorchScript archive
    (OpenAI's CLIP files).  bfloat16 tensors come back as float32."""
    if _is_torchscript(path):
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
            obj = obj["model"]
    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def _file(models_path: Optional[str], name: str) -> Optional[str]:
    path = os.path.join(models_path, name) if models_path else None
    return path if path and os.path.exists(path) else None


def random_params(shapes: dict, gen: torch.Generator, device: torch.device) -> dict:
    out = {}
    for name, leaf in shapes.items():
        if isinstance(leaf, dict):
            out[name] = random_params(leaf, gen, device)
        elif name in ("scale", "gamma"):
            out[name] = torch.ones(leaf, device=device)
        elif name == "bias":
            out[name] = torch.zeros(leaf, device=device)
        else:
            out[name] = (torch.rand(leaf, generator=gen, device=device) * 0.07 - 0.035)
    return out


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _tensors(trees: dict, dev: torch.device) -> dict:
    return {name: convert.from_jax_params(tree, dev) for name, tree in trees.items()}


def build_dinov2(models_path: Optional[str] = None, variant: str = "vit_large",
                 num_register_tokens: int = 4, seed: int = 0, device=None):
    """→ (params, DinoV2Config): ``dinov2.DINOV2_VARIANTS[variant]`` with
    ``num_register_tokens``, from ``dinov2_checkpoint(...)`` in
    ``models_path`` or seeded random weights."""
    dev = device_lib.resolve(device)
    cfg = dinov2.DINOV2_VARIANTS[variant]
    cfg = type(cfg)(**{**cfg.__dict__, "num_register_tokens": num_register_tokens})
    path = _file(models_path, dinov2_checkpoint(variant, num_register_tokens))
    if path is None:
        return random_params(dinov2.param_shapes(cfg), _generator(seed, dev), dev), cfg
    trees = convert.audited_trees(
        load_torch_state_dict(path),
        {"dinov2": (convert.dinov2_tree, (cfg.depth, num_register_tokens),
                    dinov2.param_shapes(cfg))},
        IGNORED_KEYS["dinov2"])
    return _tensors(trees, dev)["dinov2"], cfg


def _clip_pair_from(sd: dict, vcfg, tcfg, dev):
    """visual, text and logit scale of one CLIP checkpoint, audited."""
    trees = convert.audited_trees(sd, {
        "visual": (convert.clip_visual_tree, (vcfg.depth, vcfg.alpha_channel),
                   clip_m.visual_param_shapes(vcfg)),
        "text": (convert.clip_text_tree, (tcfg.depth,), clip_m.text_param_shapes(tcfg)),
        "scale": (lambda s: {"logit_scale": s["logit_scale"]}, (), {"logit_scale": ()}),
    }, IGNORED_KEYS["clip"])
    t = _tensors(trees, dev)
    return t["visual"], t["text"], t["scale"]["logit_scale"], vcfg, tcfg


def _build_clip_pair(vcfg, tcfg, seed: int, dev):
    gen = _generator(seed, dev)
    vp = random_params(clip_m.visual_param_shapes(vcfg), gen, dev)
    tp = random_params(clip_m.text_param_shapes(tcfg), gen, dev)
    scale = torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=dev)
    return vp, tp, scale, vcfg, tcfg


def build_clip(models_path: Optional[str] = None, backbone: str = "ViT-B/16", seed: int = 1,
               device=None):
    """→ (visual, text, logit_scale, vcfg, tcfg): CLIP ``backbone``
    (``CLIP_BACKBONES``), from its OpenAI file in ``models_path`` or seeded
    random weights."""
    dev = device_lib.resolve(device)
    fname, vname, tname = CLIP_BACKBONES[backbone]
    vcfg, tcfg = getattr(clip_m, vname), getattr(clip_m, tname)
    path = _file(models_path, fname)
    if path is None:
        return _build_clip_pair(vcfg, tcfg, seed, dev)
    return _clip_pair_from(load_torch_state_dict(path), vcfg, tcfg, dev)


def build_alpha_clip(models_path: Optional[str] = None, seed: int = 2, device=None):
    """→ (visual, text, logit_scale, vcfg, tcfg): AlphaCLIP ViT-L/14@336,
    the base CLIP file with the GRIT-20M visual override (reference
    alpha_clip/alpha_clip.py:94-150), or seeded random weights.  The base
    archive names its attention ``in_proj_weight``, the override an
    ``nn.Linear`` ``in_proj.weight``: the base's names are renamed to the
    override's so that each of its visual tensors is replaced (JAX
    ``mars_tpu/models/zoo.py:189-219``)."""
    dev = device_lib.resolve(device)
    vcfg, tcfg = clip_m.ALPHA_CLIP_L14_336_VISUAL, clip_m.ALPHA_CLIP_L14_TEXT
    base = _file(models_path, ALPHA_CLIP_BASE)
    if base is None:
        return _build_clip_pair(vcfg, tcfg, seed, dev)
    sd = load_torch_state_dict(base)
    alpha = _file(models_path, ALPHA_CLIP_OVERRIDE)
    if alpha is not None:
        sd.update({k if k.startswith("visual.") else f"visual.{k}": v
                   for k, v in load_torch_state_dict(alpha).items()})
    sd = {k.replace("attn.in_proj_weight", "attn.in_proj.weight")
           .replace("attn.in_proj_bias", "attn.in_proj.bias"): v for k, v in sd.items()}
    return _clip_pair_from(sd, vcfg, tcfg, dev)


def build_sam(models_path: Optional[str] = None, variant: str = "vit_h", seed: int = 3,
              device=None):
    """→ (params {"encoder", "prompt_encoder", "decoder"}, SamConfig):
    full width, from ``SAM_CHECKPOINTS[variant]`` in ``models_path`` or
    seeded random weights.  The random-Fourier matrix ``pe_gaussian`` is
    standard normal, as the JAX init and the reference draw it: at ±0.035
    every prompt point would get nearly the same encoding."""
    dev = device_lib.resolve(device)
    cfg = sam.SAM_VARIANTS[variant]
    path = _file(models_path, SAM_CHECKPOINTS[variant])
    if path is not None:
        shapes = sam.param_shapes(cfg)
        trees = convert.audited_trees(load_torch_state_dict(path), {
            "encoder": (convert.sam_encoder_tree, (cfg.depth,), shapes["encoder"]),
            "prompt_encoder": (convert.sam_prompt_encoder_tree, (), shapes["prompt_encoder"]),
            "decoder": (convert.sam_decoder_tree, (cfg.decoder_depth,), shapes["decoder"]),
        })
        return _tensors(trees, dev), cfg
    gen = _generator(seed, dev)
    params = random_params(sam.param_shapes(cfg), gen, dev)
    pe = params["prompt_encoder"]
    pe["pe_gaussian"] = torch.randn(pe["pe_gaussian"].shape, generator=gen, device=dev)
    return params, cfg


def build_semantic_sam(models_path: Optional[str] = None, variant: str = "swinl",
                       seed: int = 9, device=None):
    """→ (params, SemanticSamConfig): the native Semantic-SAM network
    (``SEMANTIC_SAM_VARIANTS[variant]``), from ``SEMANTIC_SAM_CHECKPOINT`` in
    ``models_path`` or seeded random weights.  The file's three sections
    (``SEMANTIC_SAM_SECTIONS``: the Microsoft-layout Swin, the MaskDINO
    pixel decoder, the interactive point decoder) are converted under
    ``convert.audited_trees``; keys outside them are not read.  A section
    that fails (a name not found, a tensor left unread inside it, a leaf
    missing or of another shape) raises, where the JAX package's zoo warns
    and keeps random weights for that decoder."""
    dev = device_lib.resolve(device)
    cfg = SEMANTIC_SAM_VARIANTS[variant]
    path = _file(models_path, SEMANTIC_SAM_CHECKPOINT)
    if path is None:
        return random_params(semantic_sam.param_shapes(cfg), _generator(seed, dev), dev), cfg
    sd = load_torch_state_dict(path)
    shapes = semantic_sam.section_shapes(cfg)
    prefixes = SEMANTIC_SAM_SECTIONS
    converters = {"backbone": (convert.swin_semantic_sam_tree, cfg.swin.depths),
                  "pixel_decoder": (convert.semantic_sam_pixel_decoder_tree, cfg.enc_layers),
                  "point_decoder": (convert.semantic_sam_point_decoder_tree, cfg.dec_layers)}

    def section(name):
        fn, arg = converters[name]
        return (lambda s: fn(convert._prefixed(s, prefixes[name]), arg)), (), shapes[name]

    outside = [k for k in sd if not k.startswith(tuple(prefixes.values()))]
    trees = _tensors(convert.audited_trees(sd, {name: section(name) for name in prefixes},
                                           outside), dev)
    return {"backbone": trees["backbone"], **trees["pixel_decoder"],
            **trees["point_decoder"]}, cfg


def build_resnet(models_path: Optional[str] = None, variant: str = "resnet101", seed: int = 4,
                 device=None):
    """→ (params, ResNetConfig): the Matcher's alternative encoder
    (reference utils/backbone_loader.py:100-151), torchvision's
    ``{variant}.pth`` from ``models_path`` (its ``fc`` head and BatchNorm
    counters unread) or seeded random weights."""
    dev = device_lib.resolve(device)
    cfg = resnet.ResNetConfig(layers=resnet.BOTTLENECK_LAYERS[variant])
    path = _file(models_path, f"{variant}.pth")
    if path is None:
        return random_params(resnet.param_shapes(cfg), _generator(seed, dev), dev), cfg
    sd = load_torch_state_dict(path)
    ignore = ["fc.weight", "fc.bias"] + [k for k in sd if k.endswith("num_batches_tracked")]
    trees = convert.audited_trees(
        sd, {"resnet": (convert.resnet_tree, (cfg.layers,), resnet.param_shapes(cfg))}, ignore)
    return _tensors(trees, dev)["resnet"], cfg


def build_vip_llava(seed: int = 0, quantize_bits=4, int4_format: str = "affine",
                    dtype=torch.bfloat16, device=None):
    """→ (params, VipLlavaConfig): ViP-LLaVA-7B at full width (CLIP-L/14@336
    tower, LLaMA-7B), weights ``dtype`` and the dense kernels weight-only
    quantized (``quantize_bits`` 8 or 4; 4 with ``int4_format`` "affine" or
    "nf4"; None keeps them floating)."""
    cfg = vip_llava.VipLlavaConfig()
    return vip_llava.init_random_params(seed, cfg, quantize_bits, dtype, int4_format,
                                        device), cfg
