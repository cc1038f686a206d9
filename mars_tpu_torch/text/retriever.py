"""Class-name and definition retrieval: a visual-prompted VLM and WordNet
(port of ``mars_tpu/text/retriever.py``; reference
mars/components/TextRetrieverModule.py:42-366).

  - each support shot drawn with a visual prompt (``text.visual_prompts``),
    the VLM asked for the class name (greedy, at most 20 new tokens), a
    majority vote within each shot's ensemble variants and then across
    shots;
  - a second query on the last shot for a definition (at least 20, at most
    50 new tokens);
  - WordNet resolution of the voted name (``get_synset``: underscore,
    concatenation and per-word fallbacks, stopword-filtered token overlap
    with the VLM's description), read without nltk (``text.wordnet``).

``TextRetriever`` answers one episode; ``PipelinedTextStage`` and
``BlockTextStage`` batch the queries of several episodes into one decode.

VLM backends: ``TorchVipLlava`` (ViP-LLaVA on the card, ``JaxVipLlava``'s
counterpart) and ``OracleVLM`` (a fixed answer).  The transformers
side-car ``HFVipLlava`` has no counterpart: transformers is not on the
card's machine.

``TorchVipLlava`` reads a ViP-LLaVA directory in transformers' format:
the weights through ``models.zoo.load_vip_llava``, the processor (the LLaMA
tokenizer, CLIP's image processor, the ``<image>`` expansion) through
``text.processor``.  A caller may pass either instead, duck-typed like
transformers' ``AutoProcessor``:
``processor(text=..., images=<(H, W, 3) uint8 numpy>, return_tensors="np")``
→ ``{"input_ids": (1, L), "pixel_values": (1, 3, H, W)}``, with
``processor.tokenizer``'s ``eos_token_id`` and ``decode``.
"""
from __future__ import annotations

import glob
import os
import warnings
from collections import Counter, OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from mars_tpu_torch.models import vip_llava as vl
from mars_tpu_torch.models import zoo
from mars_tpu_torch.models.precision import cast_floating
from mars_tpu_torch.models.quantization import quantize_params
from mars_tpu_torch.text import processor as processor_lib
from mars_tpu_torch.text import wordnet
from mars_tpu_torch.text.prompts import (COLORS, VISUAL_PROMPTS, VISUAL_PROMPTS_DESCRIPTIONS,
                                         VLM_SYSTEM_TEMPLATE)
from mars_tpu_torch.text.visual_prompts import GENERATORS


class VLM(Protocol):
    def generate(self, image: np.ndarray, prompt: str, max_new_tokens: int = 20,
                 min_new_tokens: int = 0) -> str: ...


class OracleVLM:
    """Answers with a fixed class name and definition."""

    def __init__(self, name: str, definition: str = ""):
        self.name = name
        self.definition = definition

    def generate(self, image, prompt, max_new_tokens=20, min_new_tokens=0):
        if "definition" in prompt:
            return self.definition or f"a {self.name}"
        return self.name


# the checkpoint and processor files of a transformers ViP-LLaVA directory
_VLM_FILES = ("config.json", "model*.safetensors", "tokenizer.json", "tokenizer_config.json",
              "preprocessor_config.json")


class TorchVipLlava:
    """ViP-LLaVA on the card through ``models.vip_llava``.

    ``model_path``: a ViP-LLaVA directory in transformers' format
    (``_VLM_FILES``), read for what the caller does not pass: the weights
    onto ``device`` (``device.resolve``: the card unless "cpu") with their
    ``config.json`` (``models.zoo.load_vip_llava``), the processor
    (``text.processor``).  ``params``: the model's parameter tree
    (``vl.convert_hf`` of a checkpoint, or ``models.zoo.build_vip_llava``'s
    random weights) on the device the decode should run on, with its
    ``cfg``.  ``dtype`` casts the floating leaves first, then
    ``quantize_bits`` (8, or 4 with ``int4_format`` "affine" or "nf4")
    quantizes the dense kernels, as ``JaxVipLlava`` does.
    ``draft_tokens``, ``ngram``, ``draft_gate``: prompt-lookup speculative
    decoding (exact greedy; 0 draft tokens turns it off; with fewer than
    ``vl.VERIFY_SLACK`` and weights of 8 or 16 bits its tokens are bit for
    bit plain decoding's, and more warns that they may not be);
    ``kv_bits=8``: the int8 KV cache."""

    # Largest device batch per decode; longer request lists are chunked.
    MAX_DECODE_BATCH = 8
    # The shared-prefix path holds a full-length KV buffer per row (~0.4 GB
    # of bf16 KV per row at the 7B's ~770 positions), so it chunks tighter.
    MAX_PREFIX_BATCH = 4
    # In-place buffer headroom past prefix + bucket: covers every retriever
    # budget (name 20, definition 50), so the definition decode always fits
    # the buffer its name decode prefilled.
    _INPLACE_BUDGET = 64
    supports_shared_prefix = True

    def __init__(self, model_path: str = "llava-hf/vip-llava-7b-hf", params=None, cfg=None,
                 dtype=None, quantize_bits=None, int4_format: str = "affine",
                 draft_tokens: int = 8, ngram: int = 3, draft_gate: int = 2, kv_bits=None,
                 processor=None, device=None):
        if params is None or processor is None:
            missing = [f for f in _VLM_FILES if not glob.glob(os.path.join(model_path, f))]
            if missing:
                raise FileNotFoundError(
                    f"TorchVipLlava: the ViP-LLaVA checkpoint and processor files are not all "
                    f"at {model_path} (missing: {', '.join(missing)}); pass params= "
                    f"(models.zoo.build_vip_llava for random weights) and processor= instead")
        if draft_tokens >= vl.VERIFY_SLACK:
            warnings.warn(f"draft_tokens={draft_tokens}: a verify forward of more than "
                          f"{vl.VERIFY_SLACK} rows sums in another order than a plain decode "
                          f"step, so speculative and plain decoding may split where two "
                          f"logits are nearly tied")
        self.draft_tokens, self.ngram, self.draft_gate = draft_tokens, ngram, draft_gate
        self.kv_bits = kv_bits
        self.processor = processor if processor is not None else processor_lib.load(model_path)
        if params is None:
            params, cfg = zoo.load_vip_llava(model_path, dtype, quantize_bits, int4_format,
                                             device)
        else:
            if dtype is not None:
                params = cast_floating(params, dtype)
            if quantize_bits is not None:
                params = quantize_params(params, bits=quantize_bits, int4_format=int4_format)
        self.cfg = cfg or vl.VipLlavaConfig()
        self.params = params
        self.device = params["language"]["embed_tokens"].device
        self._prefix_ids_cache = {}
        self._prefix_kv_cache = None
        self._batch_prefix_cache = OrderedDict()

    def _eos_id(self):
        return getattr(self.processor.tokenizer, "eos_token_id", None)

    def _draft_slack(self) -> int:
        """KV slots a verify forward writes past the accepted length (K
        drafts and the bonus token); 0 without speculation."""
        return self.draft_tokens + 1 if self.draft_tokens else 0

    def _inplace_buffer_len(self, prefix_len: int, bucket: int) -> int:
        """Allocation length of the full-decode-length KV buffer of the
        in-place chained flow; >= ``_inplace_need`` for every retriever
        budget, and the same whether the retriever speculates or not
        (``vl.kv_slack``)."""
        return prefix_len + bucket + self._INPLACE_BUDGET + vl.kv_slack(self.draft_tokens)

    def _inplace_need(self, prefix_len: int, bucket: int, budget: int) -> int:
        return prefix_len + bucket + budget + self._draft_slack()

    def _decode_kw(self):
        return dict(eos_id=self._eos_id(), draft_tokens=self.draft_tokens, ngram=self.ngram,
                    draft_gate=self.draft_gate, kv_bits=self.kv_bits)

    def _decode_row(self, toks):
        eos = self._eos_id()
        toks = [int(t) for t in toks]
        if eos is not None and eos in toks:
            toks = toks[: toks.index(eos)]
        return self.processor.tokenizer.decode(toks, skip_special_tokens=True).strip()

    def _process(self, text, image):
        out = self.processor(text=text, images=image, return_tensors="np")
        return np.asarray(out["input_ids"]), np.asarray(out["pixel_values"], np.float32)

    def _pixels(self, pixel_values):
        """(B, 3, H, W) numpy → (B, H, W, 3) float32 on the model's device."""
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(pixel_values, (0, 2, 3, 1)))).to(self.device)

    def _ids(self, ids):
        return torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int64)).to(self.device)

    def generate(self, image, prompt, max_new_tokens=20, min_new_tokens=0,
                 shared_prefix: str = None):
        ids_np, pix_np = self._process(prompt, image)
        l0 = ids_np.shape[1]
        pixels = self._pixels(pix_np)
        prefix_len, prefix_kv = 0, None
        if shared_prefix:
            prefix_len, prefix_kv = self._prefix_state(shared_prefix, image, ids_np, pixels)
        if prefix_kv is not None:
            body, tl = ids_np[:, prefix_len:], l0 - prefix_len
        else:
            prefix_len, body, tl = 0, ids_np, l0
        # right-pad to a 128-bucket: the in-place buffer is sized by the
        # bucket, so a definition decode fits the buffer its name decode
        # prefilled
        lb = body.shape[1]
        bucket = ((lb + 127) // 128) * 128
        body = np.pad(body, ((0, 0), (0, bucket - lb)))
        budget = max(max_new_tokens, min_new_tokens)
        kw = dict(max_new_tokens=budget, true_length=tl, min_new_tokens=min_new_tokens,
                  prefix_kv=prefix_kv, prefix_len=prefix_len, **self._decode_kw())
        if prefix_kv is not None and prefix_kv[0][0].shape[1] >= self._inplace_need(
                prefix_len, bucket, budget):
            # in place: the decode writes into the cached buffer and the
            # definition query chains off it
            toks, new_kv = vl.generate_greedy(self.params, self._ids(body), None, self.cfg,
                                              inplace_prefix=True, return_caches=True, **kw)
            self._prefix_kv_cache = (self._prefix_kv_cache[0], new_kv)
        else:
            # fresh caches (no prefix), or a copy of the prefix when the
            # decode outgrew the buffer
            toks = vl.generate_greedy(self.params, self._ids(body),
                                      None if prefix_kv is not None else pixels, self.cfg, **kw)
        return self._decode_row(toks[0].tolist())

    def _prefix_state(self, shared_prefix, image, ids_np, pixels):
        """→ (prefix_len, prefix_kv) from the one-slot cache, or (0, None)
        when the prefix's tokens do not start the prompt's."""
        key_ids = self._prefix_ids_cache.get(shared_prefix)
        if key_ids is None:
            key_ids = tuple(self._process(shared_prefix, image)[0][0].tolist())
            self._prefix_ids_cache[shared_prefix] = key_ids
        lp = len(key_ids)
        if ids_np.shape[1] <= lp or tuple(ids_np[0, :lp].tolist()) != key_ids:
            return 0, None
        cache_key = (key_ids, image.shape, hash(image.tobytes()))
        if self._prefix_kv_cache is not None and self._prefix_kv_cache[0] == cache_key:
            return lp, self._prefix_kv_cache[1]
        self._prefix_kv_cache = None  # free the old buffer before allocating
        bucket = ((ids_np.shape[1] - lp + 127) // 128) * 128
        kv = vl.prefill_prefix(self.params, self._ids(np.asarray(key_ids)[None]), pixels,
                               self.cfg, max_len=self._inplace_buffer_len(lp, bucket),
                               kv_bits=self.kv_bits)
        self._prefix_kv_cache = (cache_key, kv)
        return lp, kv

    def generate_batch(self, images, prompts, max_new_tokens=20, min_new_tokens=0,
                       shared_prefix: str = None):
        """Batched decode over variable-length (image, prompt) pairs: rows
        right-padded to a shared 128-bucket with per-row lengths, chunked
        by ``MAX_DECODE_BATCH`` (``MAX_PREFIX_BATCH`` with a shared prefix).

        ``max_new_tokens`` / ``min_new_tokens`` may be per-row sequences:
        per-row minima ride the decoder's per-row EOS floor, per-row maxima
        truncate the emitted tokens (greedy emission is causal).
        ``shared_prefix``: every row starts with the same template text, so
        one batched ``prefill_prefix`` builds the (B, L_prefix) KV stack,
        cached by the batch's images: the definition decode over the same
        images reuses the name decode's buffer, in place.  A row whose
        tokens break the prefix sends its chunk down the plain path."""
        b = len(images)
        maxs = (list(max_new_tokens) if isinstance(max_new_tokens, (list, tuple))
                else [max_new_tokens] * b)
        mins = (list(min_new_tokens) if isinstance(min_new_tokens, (list, tuple))
                else [min_new_tokens] * b)
        # int8 KV halves a row's residency: a shared-prefix batch then
        # chunks as a plain one
        chunk = (self.MAX_PREFIX_BATCH if shared_prefix and self.kv_bits != 8
                 else self.MAX_DECODE_BATCH)
        out = []
        for s in range(0, b, chunk):
            out.extend(self._generate_batch_chunk(
                images[s:s + chunk], prompts[s:s + chunk], maxs[s:s + chunk],
                mins[s:s + chunk], shared_prefix=shared_prefix))
        return out

    def _batch_prefix_state(self, shared_prefix, images, ids, lens, pixels):
        """→ (prefix_len, cache_key, stacked prefix KV) when every row
        starts with the shared template's tokens, else (0, None, None).
        The stack is allocated at the full decode length; the caller
        stores the decode's returned (same, mutated) buffer back."""
        key_ids = self._prefix_ids_cache.get(shared_prefix)
        if key_ids is None:
            key_ids = tuple(self._process(shared_prefix, images[0])[0][0].tolist())
            self._prefix_ids_cache[shared_prefix] = key_ids
        lp = len(key_ids)
        ref = np.asarray(key_ids)
        for row, l in zip(ids, lens):
            if l <= lp or not np.array_equal(row[:lp], ref):
                return 0, None, None
        cache_key = (key_ids, tuple(im.shape for im in images),
                     tuple(hash(im.tobytes()) for im in images))
        cache = self._batch_prefix_cache
        if cache_key in cache:
            return lp, cache_key, cache[cache_key]
        # a FIFO per chunk: a block deeper than MAX_PREFIX_BATCH replays its
        # chunks for the definitions; stale stacks go before the allocation
        while len(cache) > 1:
            cache.popitem(last=False)
        bucket = ((max(l - lp for l in lens) + 127) // 128) * 128
        prefix_ids = self._ids(np.broadcast_to(ref, (len(images), lp)))
        kv = vl.prefill_prefix(self.params, prefix_ids, pixels, self.cfg,
                               max_len=self._inplace_buffer_len(lp, bucket), kv_bits=self.kv_bits)
        cache[cache_key] = kv
        return lp, cache_key, kv

    def _generate_batch_chunk(self, images, prompts, maxs, mins, shared_prefix=None):
        if len(images) != len(prompts) or not images:
            raise ValueError("need one prompt per image, and at least one")
        per = [self._process(pr, im) for im, pr in zip(images, prompts)]
        lens = [ids.shape[1] for ids, _ in per]
        rows = [ids[0] for ids, _ in per]
        pixels = self._pixels(np.concatenate([pix for _, pix in per]))

        prefix_len, cache_key, prefix_kv = 0, None, None
        if shared_prefix:
            prefix_len, cache_key, prefix_kv = self._batch_prefix_state(
                shared_prefix, images, rows, lens, pixels)
        if prefix_kv is not None:
            rows = [r[prefix_len:] for r in rows]
            lens = [l - prefix_len for l in lens]
            pixels = None  # the suffixes are text only

        bucket = ((max(lens) + 127) // 128) * 128
        ids = np.stack([np.pad(r, (0, bucket - l)) for r, l in zip(rows, lens)])
        mn = mins[0] if len(set(mins)) == 1 else tuple(mins)
        budget = max(max(maxs), max(mins))
        kw = dict(max_new_tokens=budget, true_length=np.asarray(lens, np.int64),
                  min_new_tokens=mn, prefix_kv=prefix_kv, prefix_len=prefix_len,
                  **self._decode_kw())
        if prefix_kv is not None and prefix_kv[0][0].shape[1] >= self._inplace_need(
                prefix_len, bucket, budget):
            toks, new_kv = vl.generate_greedy(self.params, self._ids(ids), pixels, self.cfg,
                                              inplace_prefix=True, return_caches=True, **kw)
            self._batch_prefix_cache[cache_key] = new_kv
        else:
            toks = vl.generate_greedy(self.params, self._ids(ids), pixels, self.cfg, **kw)
        toks = toks.cpu().numpy()
        return [self._decode_row(toks[i][:mx]) for i, mx in enumerate(maxs)]


@dataclass(frozen=True)
class PromptGenConfig:
    prompt_type: str = "contour"  # scripts/coco_1shot.sh
    color: str = "red"
    alpha: float = 0.5
    thickness: int = 2
    zoom_percent: int = 50


@dataclass(frozen=True)
class EnsembleConfig:
    """The prompt dimensions to ensemble over (reference EnsambleConfig
    :383-444)."""

    colors: Tuple[str, ...] = ()
    zooms: Tuple[int, ...] = ()
    prompt_types: Tuple[str, ...] = ()

    @property
    def active(self) -> bool:
        return bool(self.colors or self.zooms or self.prompt_types)

    def variants(self, base: PromptGenConfig):
        for t in self.prompt_types or (base.prompt_type,):
            for c in self.colors or (base.color,):
                for z in self.zooms or (base.zoom_percent,):
                    yield PromptGenConfig(prompt_type=t, color=c, alpha=base.alpha,
                                          thickness=base.thickness, zoom_percent=z)


def _draw(image, mask, cfg: PromptGenConfig):
    return GENERATORS[cfg.prompt_type](image, mask, color=COLORS[cfg.color], alpha=cfg.alpha,
                                       thickness=cfg.thickness, zoom_percent=cfg.zoom_percent)


class TextRetriever:
    def __init__(self, vlm: VLM, gen_cfg: PromptGenConfig = PromptGenConfig(),
                 ensemble: EnsembleConfig = EnsembleConfig()):
        self.vlm = vlm
        self.gen_cfg = gen_cfg
        self.ensemble = ensemble

    def _name_requests(self, support_images, support_masks):
        """Every shot x variant as one list of (shot index, drawn image,
        prompt); a batch-capable VLM answers them in one decode, and the
        votes (reference TextRetrieverModule.py:42-99) apply to the
        answers."""
        variants = (list(self.ensemble.variants(self.gen_cfg)) if self.ensemble.active
                    else [self.gen_cfg])
        return [(si, _draw(img, mask, cfg),
                 VLM_SYSTEM_TEMPLATE.format(VISUAL_PROMPTS[cfg.prompt_type].format(cfg.color)))
                for si, (img, mask) in enumerate(zip(support_images, support_masks))
                for cfg in variants]

    @staticmethod
    def _vote(requests, answers, n_shots: int) -> str:
        """Majority vote within each shot, then across shots (ties go to the
        answer seen first)."""
        names: List[str] = []
        for si in range(n_shots):
            votes = Counter(a for (s, _, _), a in zip(requests, answers) if s == si)
            names.append(max(votes, key=votes.get))
        counts = Counter(names)
        return max(counts, key=counts.get)

    def _definition_request(self, support_images, support_masks, name: str):
        """(drawn, prompt) of the definition query on the LAST shot
        (reference :103-122)."""
        cfg = self.gen_cfg
        drawn = _draw(support_images[-1], support_masks[-1], cfg)
        return drawn, VLM_SYSTEM_TEMPLATE.format(
            VISUAL_PROMPTS_DESCRIPTIONS[cfg.prompt_type].format(name, cfg.color, name, name))

    def _prefix_kw(self):
        # the name and definition queries share "Human: <image>\n" and the
        # last shot's drawn image: the VLM prefills that prefix once
        if getattr(self.vlm, "supports_shared_prefix", False):
            return {"shared_prefix": VLM_SYSTEM_TEMPLATE.split("{}")[0]}
        return {}

    @staticmethod
    def _finish(name: str, description: str) -> Tuple[str, str]:
        """WordNet resolution of the voted name against the VLM's
        description → (name, the synset's definition or '')."""
        synset = get_synset(name, description)
        if synset is not None:
            return name, wordnet.wordnet().synset(synset).definition()
        return name, ""

    def get_conceptual_information(self, support_images: Sequence[np.ndarray],
                                   support_masks: Sequence[np.ndarray]) -> Tuple[str, str]:
        """(H, W, 3) uint8 images and (H, W) masks per shot → (class name,
        WordNet definition or '')."""
        requests = self._name_requests(support_images, support_masks)
        prefix_kw = self._prefix_kw()
        if len(requests) > 1 and hasattr(self.vlm, "generate_batch"):
            answers = self.vlm.generate_batch([r[1] for r in requests], [r[2] for r in requests],
                                              max_new_tokens=20)
        else:
            answers = [self.vlm.generate(d, p, max_new_tokens=20, **prefix_kw)
                       for _, d, p in requests]
        name = self._vote(requests, answers, len(support_images))
        drawn, dprompt = self._definition_request(support_images, support_masks, name)
        description = self.vlm.generate(drawn, dprompt, max_new_tokens=50, min_new_tokens=20,
                                        **prefix_kw)
        return self._finish(name, description)


class PipelinedTextStage:
    """One decode per episode instead of two: episode N's definition rides
    the batch of episode N+1's name queries (a one-episode lookahead).

        stage = PipelinedTextStage(retriever)
        done_prev = stage.step(images_N, masks_N)   # None on the first call
        done_last = stage.flush()                   # after the last episode

    ``step`` returns the (name, definition) of the episode the previous
    step pushed; greedy decoding is exact per row, so the results equal the
    serial retriever's."""

    def __init__(self, retriever: TextRetriever):
        self.r = retriever
        self._pending = None  # (name, drawn, prompt) awaiting its definition

    def step(self, support_images, support_masks) -> Optional[Tuple[str, str]]:
        r = self.r
        requests = r._name_requests(support_images, support_masks)
        images = [d for _, d, _ in requests]
        prompts = [p for _, _, p in requests]
        maxs, mins = [20] * len(images), [0] * len(images)
        if self._pending is not None:
            name_prev, drawn_d, dprompt = self._pending
            images, prompts = [drawn_d] + images, [dprompt] + prompts
            maxs, mins = [50] + maxs, [20] + mins
        answers = self._generate(images, prompts, maxs, mins)
        done = None
        if self._pending is not None:
            done = r._finish(name_prev, answers[0])
            answers = answers[1:]
        name = r._vote(requests, answers, len(support_images))
        self._pending = (name,) + r._definition_request(support_images, support_masks, name)
        return done

    def flush(self) -> Optional[Tuple[str, str]]:
        """The last pending definition → (name, definition), or None."""
        if self._pending is None:
            return None
        name, drawn, dprompt = self._pending
        self._pending = None
        return self.r._finish(name, self._generate([drawn], [dprompt], [50], [20])[0])

    def _generate(self, images, prompts, maxs, mins):
        vlm = self.r.vlm
        if len(images) > 1 and hasattr(vlm, "generate_batch"):
            return vlm.generate_batch(images, prompts, max_new_tokens=maxs, min_new_tokens=mins)
        prefix_kw = self.r._prefix_kw()
        return [vlm.generate(im, pr, max_new_tokens=mx, min_new_tokens=mn, **prefix_kw)
                for im, pr, mx, mn in zip(images, prompts, maxs, mins)]


class BlockTextStage:
    """D episodes' text in two batched decodes: all their name queries, the
    votes on the host, then their D definitions, the batch's prefix
    prefilled once for both.

        stage = BlockTextStage(retriever, depth=4)
        results = stage.step(images, masks)   # [] until a block fills,
                                              # then D (name, definition)
        results = stage.flush()               # the last, partial block

    Results equal the serial retriever's, up to D - 1 episodes late."""

    def __init__(self, retriever: TextRetriever, depth: int = 4):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.r = retriever
        self.depth = depth
        self._buf: list = []  # (support_images, support_masks) per episode

    def step(self, support_images, support_masks) -> List[Tuple[str, str]]:
        self._buf.append((support_images, support_masks))
        return self._run_block() if len(self._buf) >= self.depth else []

    def flush(self) -> List[Tuple[str, str]]:
        return self._run_block() if self._buf else []

    def _generate(self, images, prompts, maxs, mins):
        vlm = self.r.vlm
        if hasattr(vlm, "generate_batch"):
            kw = ({"shared_prefix": VLM_SYSTEM_TEMPLATE.split("{}")[0]}
                  if getattr(vlm, "supports_shared_prefix", False) else {})
            return vlm.generate_batch(images, prompts, max_new_tokens=maxs, min_new_tokens=mins,
                                      **kw)
        return [vlm.generate(im, pr, max_new_tokens=mx, min_new_tokens=mn)
                for im, pr, mx, mn in zip(images, prompts, maxs, mins)]

    def _run_block(self) -> List[Tuple[str, str]]:
        r = self.r
        episodes, self._buf = self._buf, []
        spans, reqs = [], []
        for imgs, masks in episodes:
            ep_reqs = r._name_requests(imgs, masks)
            spans.append((len(reqs), len(ep_reqs), len(imgs)))
            reqs.extend(ep_reqs)
        answers = self._generate([q[1] for q in reqs], [q[2] for q in reqs], [20] * len(reqs),
                                 [0] * len(reqs))
        names, d_imgs, d_prompts = [], [], []
        for (start, cnt, n_shots), (imgs, masks) in zip(spans, episodes):
            name = r._vote(reqs[start:start + cnt], answers[start:start + cnt], n_shots)
            names.append(name)
            drawn, dprompt = r._definition_request(imgs, masks, name)
            d_imgs.append(drawn)
            d_prompts.append(dprompt)
        defs = self._generate(d_imgs, d_prompts, [50] * len(names), [20] * len(names))
        return [r._finish(n, d) for n, d in zip(names, defs)]


def get_synset(class_name: str, vlm_description: str) -> Optional[str]:
    """WordNet synset of a class name (reference _get_synset :139-185): the
    name with underscores, then concatenated, then each of its words; among
    several synsets, the one whose definition shares the most
    non-stopword tokens with the VLM's description."""
    stop = set(wordnet.stopwords_english())
    wn = wordnet.wordnet()
    lower = class_name.strip().lower()
    synsets = wn.synsets(lower.replace(" ", "_"))
    if not synsets:
        synsets = wn.synsets(lower.replace(" ", ""))
    if not synsets:
        for word in lower.split():
            synsets += wn.synsets(word.strip())
    if not synsets:
        return None
    if len(synsets) == 1:
        return synsets[0].name()
    desc_tokens = set(wordnet.word_tokenize(vlm_description.lower())) - stop
    best, best_overlap = None, 0
    for s in synsets:
        overlap = len(desc_tokens & (set(wordnet.word_tokenize(s.definition().lower())) - stop))
        if overlap > best_overlap:
            best, best_overlap = s, overlap
    return best.name() if best else None
