"""The MARS orchestrator: one episode (port of ``mars_tpu/pipeline/mars.py``).

  1. class name and definition from the support set (the VLM retriever on
     the host's drawn prompts, WordNet), unless the caller gives the name
  2. VVA prior (DINOv2, 24 tapped blocks on the query)
  3. VTA prior (CLIP Grad-CAM, 7 tapped prefinal blocks), nearest-resized
     to the VVA grid and min-max scaled (reference mars/MARS.py:77-82)
  4. AlphaCLIP text "a {name}, {description}." (:84-89)
  5. proposal scoring, filtering and merging

``predict`` synchronises and records ``timings`` (host clock, seconds):
``total`` from the call, ``after_text_extraction`` from the moment the
class name is known.  ``predict_launch`` enqueues the same work and
returns the merged mask on the device without waiting for it, so a loop
can pull it a few episodes later (``cli --overlap-ranking``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.core import imaging
from mars_tpu_torch.core.episode import Episode, Proposals, live_count
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
    retriever:  ``text.retriever.TextRetriever`` (VLM + WordNet), or None
                when every caller gives the class name
    Parameters must already lie on ``device`` (``None`` = the card).
    """

    def __init__(self, dino, clip, alpha_clip, cfg: MarsConfig = MarsConfig(), device=None,
                 retriever=None):
        self.device = device_lib.resolve(device)
        self.dino_params, self.dino_cfg = dino
        (self.clip_v, self.clip_t, self.clip_scale, self.clip_vcfg, self.clip_tcfg) = clip
        (self.ac_v, self.ac_t, self.ac_scale, self.ac_vcfg, self.ac_tcfg) = alpha_clip
        self.cfg = cfg
        self.retriever = retriever
        self.timings = {}

    def support_host_arrays(self, episode: Episode):
        """The valid support shots as host uint8 images and float masks, the
        retriever's input (JAX's clip and cast: x * 255 in float32, clipped
        to [0, 255], truncated)."""
        imgs = (episode.support_images * 255).clamp(0, 255).to(torch.uint8).cpu().numpy()
        masks = episode.support_masks.cpu().numpy()
        n = int(episode.support_valid.sum())
        return [imgs[i] for i in range(n)], [masks[i] for i in range(n)]

    def conceptual_information(self, episode: Episode):
        """(class name, definition) of the support set, by the retriever."""
        return self.retriever.get_conceptual_information(*self.support_host_arrays(episode))

    def _tokens(self, texts):
        return device_lib.to_device(torch.from_numpy(tokenizer.tokenize(texts)), self.device)

    def _support_rows(self, episode: Episode) -> Optional[int]:
        """The support footprint's patch count on the VVA grid (EMD's live
        rows), counted on the host where the episode kept its masks there."""
        if episode.support_host is None:
            return None
        masks, valid = episode.support_host
        pooled = imaging.pooled_footprint_host(masks, self.cfg.vva.grid)
        return int((pooled & np.asarray(valid, bool)[:, None, None]).sum())

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
            # the live-proposal count gates the AlphaCLIP and EMD dead-chunk
            # skips (device conditionals in the JAX package): known on the
            # host for a stack built there, else one host sync
            n_valid = live_count(proposals)
            n_rows = self._support_rows(episode)
        with record_function("mars.vva"):
            vva_prior, cost, support_fg = vva.compute(
                self.dino_params, episode.support_images, episode.support_masks,
                episode.support_valid, episode.query_image, self.dino_cfg, self.cfg.vva)
        with record_function("mars.vta"):
            vta_prior = vta.scaled_to_grid(
                vta.compute(self.clip_v, episode.query_image, vta_text, self.clip_scale,
                            self.clip_vcfg, self.cfg.vta), g)
        with record_function("mars.alphaclip"):
            ac_scores = filtering.alphaclip_scores(
                self.ac_v, episode.query_image, proposals.masks, ac_text, self.ac_vcfg,
                self.cfg.filter_merge, proposal_valid=proposals.valid, n_valid=n_valid)
        with record_function("mars.score_merge"):
            merged, scores = filtering.score_and_merge_core(
                proposals.masks, proposals.valid, support_fg, cost, vva_prior, vta_prior,
                ac_scores, self.cfg.filter_merge, n_valid=n_valid, n_rows=n_rows)
        return {"merged": merged, "scores": scores, "vva_prior": vva_prior,
                "vta_prior": vta_prior, "ac_scores": ac_scores}

    def predict(self, episode: Episode, proposals: Proposals,
                class_name: Optional[str] = None, class_description: str = "") -> torch.Tensor:
        """→ (H, W) float mask in {0, 1} on the device, synchronised
        (reference MARS.predict :33-104), and ``timings``.  Without
        ``class_name`` the retriever names the support set's class first."""
        t0 = time.perf_counter()
        if class_name is None:
            class_name, class_description = self.conceptual_information(episode)
        t1 = time.perf_counter()
        merged = self._run(episode, proposals, class_name, class_description)["merged"]
        if merged.device.type == "cuda":
            torch.cuda.synchronize(merged.device)
        t2 = time.perf_counter()
        self.timings = {"total": t2 - t0, "after_text_extraction": t2 - t1}
        return merged

    def predict_launch(self, episode: Episode, proposals: Proposals, class_name: str,
                       class_description: str = "") -> torch.Tensor:
        """Enqueues ``predict``'s work and returns the merged mask on the
        device without synchronising: the caller reads it later.  The same
        operations on the same inputs as ``predict``, so the same mask.
        It reads nothing back from the device while ``proposals.n_live`` is
        known and the episode kept its support masks on the host."""
        return self._run(episode, proposals, class_name, class_description)["merged"]

    def predict_debug(self, episode: Episode, proposals: Proposals, class_name: str,
                      class_description: str = "") -> dict:
        """predict(), plus the per-stage state: merged, scores, vva_prior,
        vta_prior (both (g, g)) and ac_scores, as host numpy."""
        out = self._run(episode, proposals, class_name, class_description)
        return {k: v.cpu().numpy() for k, v in out.items()}
