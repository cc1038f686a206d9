"""ViP-LLaVA's processor (transformers' ``LlavaProcessor``) from a
transformers directory, without transformers.

``processor(text=, images=, return_tensors="np")`` →
``{"input_ids": (1, L) int64, "pixel_values": (1, 3, H, W) float32}``, the
contract ``text.retriever.TorchVipLlava`` calls: the image through
``text.image_processor`` (CLIP's), each ``<image>`` of the text repeated
once for every image slot of the vision tower, then the text through
``text.llama_tokenizer``.  ``.tokenizer`` gives ``decode`` and
``eos_token_id``.

The slots are ``(H // patch_size) * (W // patch_size)
+ num_additional_image_tokens``, less one with
``vision_feature_select_strategy`` "default", from
``processor_config.json`` (576 at 336 / 14 with the one additional CLS
token dropped); where the directory has no such file, the tower's patch
grid from ``config.json``, the count ``models.vip_llava.embed_multimodal``
needs.
"""
from __future__ import annotations

import json
import os

import numpy as np

from mars_tpu_torch.models import vip_llava
from mars_tpu_torch.text import image_processor, llama_tokenizer

PROCESSOR_FILE = "processor_config.json"


class VipLlavaProcessor:
    def __init__(self, tokenizer, images, patch_size: int,
                 num_additional_image_tokens: int = 0, strategy=None,
                 image_token: str = "<image>"):
        self.tokenizer = tokenizer
        self.image_processor = images
        self.patch_size = patch_size
        self.extra = num_additional_image_tokens - (1 if strategy == "default" else 0)
        self.image_token = image_token

    def __call__(self, text: str, images, return_tensors: str = "np") -> dict:
        if return_tensors != "np":
            raise ValueError(f"return_tensors {return_tensors!r}: only 'np'")
        pixels = self.image_processor(images)[None]
        h, w = pixels.shape[2:]
        slots = (h // self.patch_size) * (w // self.patch_size) + self.extra
        ids = self.tokenizer.encode(text.replace(self.image_token, self.image_token * slots))
        return {"input_ids": np.asarray([ids], np.int64), "pixel_values": pixels}


def load(path: str) -> VipLlavaProcessor:
    """The processor of a ViP-LLaVA directory: ``tokenizer.json`` and its
    configs, ``preprocessor_config.json``, ``processor_config.json`` or
    else ``config.json``."""
    tokenizer = llama_tokenizer.load(path)
    images = image_processor.load(path)
    proc_path = os.path.join(path, PROCESSOR_FILE)
    if os.path.exists(proc_path):
        with open(proc_path) as f:
            cfg = json.load(f)
        if cfg.get("patch_size") is None:
            raise ValueError(f"{PROCESSOR_FILE}: no patch_size, so <image> would stay one "
                             f"token where the model takes one per image slot")
        return VipLlavaProcessor(tokenizer, images, cfg["patch_size"],
                                 cfg.get("num_additional_image_tokens", 0),
                                 cfg.get("vision_feature_select_strategy"),
                                 cfg.get("image_token", "<image>"))
    with open(os.path.join(path, "config.json")) as f:
        model = vip_llava.config_from_hf(json.load(f))
    return VipLlavaProcessor(tokenizer, images, model.patch_size, 1, "default")
