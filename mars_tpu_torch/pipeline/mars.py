"""The MARS orchestrator: one ranking episode (port of
``mars_tpu/pipeline/mars.py``, with a known class name).

  1. VVA prior (DINOv2, 24 tapped blocks on the query)
  2. VTA prior (CLIP Grad-CAM, 7 tapped prefinal blocks), nearest-resized
     to the VVA grid and min-max scaled (reference mars/MARS.py:77-82)
  3. AlphaCLIP text "a {name}, {description}." (:84-89)
  4. proposal scoring, filtering and merging
The VLM retriever (class name from the support set) is not ported yet:
``class_name`` is required.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.profiler import record_function

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.core import imaging
from mars_tpu_torch.core.episode import Episode, Proposals
from mars_tpu_torch.models import clip as clip_m
from mars_tpu_torch.pipeline import filtering, vta, vva
from mars_tpu_torch.text import prompts as prompt_data
from mars_tpu_torch.text import tokenizer


@dataclass(frozen=True)
class MarsConfig:
    vva: vva.VVAConfig = field(default_factory=vva.VVAConfig)
    vta: vta.VTAConfig = field(default_factory=vta.VTAConfig)
    filter_merge: filtering.FilterMergeConfig = field(default_factory=filtering.FilterMergeConfig)
    use_multiple_prompts: bool = False


class Mars:
    """Frozen towers + configs; ``predict`` runs one episode.

    dino:       (params, DinoV2Config)
    clip:       (visual_params, text_params, logit_scale, vcfg, tcfg)
    alpha_clip: (visual_params, text_params, logit_scale, vcfg, tcfg)
    Parameters must already lie on ``device`` (``None`` = the card).
    """

    def __init__(self, dino, clip, alpha_clip, cfg: MarsConfig = MarsConfig(), device=None):
        self.device = device_lib.resolve(device)
        self.dino_params, self.dino_cfg = dino
        (self.clip_v, self.clip_t, self.clip_scale, self.clip_vcfg, self.clip_tcfg) = clip
        (self.ac_v, self.ac_t, self.ac_scale, self.ac_vcfg, self.ac_tcfg) = alpha_clip
        self.cfg = cfg

    def _tokens(self, texts):
        return torch.from_numpy(tokenizer.tokenize(texts)).to(self.device)

    def _vta_text_feats(self, label: str) -> torch.Tensor:
        fg, bg = prompt_data.vta_text_pair(label, self.cfg.use_multiple_prompts)
        return vta.compute_text_feats(self.clip_t, self.clip_tcfg, self._tokens(fg),
                                      self._tokens(bg))

    def _alpha_clip_text_feats(self, text: str) -> torch.Tensor:
        feats = clip_m.encode_text(self.ac_t, self._tokens([text]), self.ac_tcfg)
        return feats / feats.norm(dim=-1, keepdim=True)

    @torch.no_grad()
    def _run(self, episode: Episode, proposals: Proposals, class_name: str,
             class_description: str):
        # stage spans are read by torch.profiler (no cost without one)
        g = self.cfg.vva.grid
        with record_function("mars.text"):
            vta_text = self._vta_text_feats(class_name)
            ac_text = self._alpha_clip_text_feats(
                prompt_data.alpha_clip_text(class_name, class_description))
            # one host sync: the live-proposal count gates the AlphaCLIP and
            # EMD dead-chunk skips (device conditionals in the JAX package)
            n_valid = int(proposals.valid.sum())
        with record_function("mars.vva"):
            vva_prior, cost, support_fg = vva.compute(
                self.dino_params, episode.support_images, episode.support_masks,
                episode.support_valid, episode.query_image, self.dino_cfg, self.cfg.vva)
        with record_function("mars.vta"):
            vta_prior = vta.compute(self.clip_v, episode.query_image, vta_text,
                                    self.clip_scale, self.clip_vcfg, self.cfg.vta)
            vta_prior = imaging.interpolate_2d(vta_prior, (g, g), "nearest")
            vta_prior = (vta_prior - vta_prior.min()) / (
                1e-7 + vta_prior.max() - vta_prior.min())
        with record_function("mars.alphaclip"):
            ac_scores = filtering.alphaclip_scores(
                self.ac_v, episode.query_image, proposals.masks, ac_text, self.ac_vcfg,
                self.cfg.filter_merge, proposal_valid=proposals.valid, n_valid=n_valid)
        with record_function("mars.score_merge"):
            merged, scores = filtering.score_and_merge_core(
                proposals.masks, proposals.valid, support_fg, cost, vva_prior, vta_prior,
                ac_scores, self.cfg.filter_merge, n_valid=n_valid)
        return {"merged": merged, "scores": scores, "vva_prior": vva_prior,
                "vta_prior": vta_prior, "ac_scores": ac_scores}

    def predict(self, episode: Episode, proposals: Proposals,
                class_name: Optional[str] = None, class_description: str = "") -> torch.Tensor:
        """→ (H, W) float mask in {0, 1} on the device, not yet synced
        (reference MARS.predict :33-104)."""
        if class_name is None:
            raise NotImplementedError("the VLM retriever is not ported yet: pass class_name")
        return self._run(episode, proposals, class_name, class_description)["merged"]

    def predict_debug(self, episode: Episode, proposals: Proposals, class_name: str,
                      class_description: str = "") -> dict:
        """predict(), plus the per-stage state: merged, scores, vva_prior,
        vta_prior (both (g, g)) and ac_scores, as host numpy."""
        out = self._run(episode, proposals, class_name, class_description)
        return {k: v.cpu().numpy() for k, v in out.items()}
