"""The VLM backend of class-name/definition retrieval on the card (port of
``JaxVipLlava``, ``mars_tpu/text/retriever.py:87-461``).

``TorchVipLlava`` answers the retriever's queries (a class name, greedy,
at most 20 new tokens; a definition, 50 with at least 20) with
``models.vip_llava``'s greedy decoder: single queries (``generate``) and
batches of (image, prompt) pairs (``generate_batch``), both with the
shared-prefix reuse that prefills "Human: <image>\\n" (the vision tower and
~580 positions) once per image and chains the name and definition decodes
through one full-length KV buffer, in place.

The processor (tokenizer and image preprocessing) is injected and
duck-typed like transformers' ``AutoProcessor``: ``processor(text=...,
images=<(H, W, 3) uint8 numpy>, return_tensors="np")`` → ``{"input_ids":
(1, L), "pixel_values": (1, 3, H, W)}``, with ``processor.tokenizer``'s
``eos_token_id`` and ``decode``.  Neither the ViP-LLaVA-7B checkpoint nor
its tokenizer is in the repository; the host side of the retriever (visual
prompts, votes, WordNet) is not ported yet (ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from mars_tpu_torch.models import vip_llava as vl


class TorchVipLlava:
    """ViP-LLaVA on the card through ``models.vip_llava``.

    ``params``: the model's parameter tree (``vl.convert_hf`` of a
    checkpoint, or ``models.zoo.build_vip_llava``'s random weights), on the
    device the decode should run on.  ``dtype`` casts its floating leaves
    first, then ``quantize_bits`` (8, or 4 with ``int4_format`` "affine" or
    "nf4") quantizes its dense kernels, as ``JaxVipLlava`` does.
    ``draft_tokens`` and ``kv_bits=8`` are not ported yet and raise."""

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
                 draft_tokens: int = 0, kv_bits=None, processor=None):
        if params is None or processor is None:
            raise FileNotFoundError(
                f"TorchVipLlava needs the ViP-LLaVA-7B checkpoint ({model_path}: "
                "model-*.safetensors, config.json) and its processor files (tokenizer.model, "
                "tokenizer_config.json, preprocessor_config.json); none is in the "
                "repository: pass params= (models.zoo.build_vip_llava for random weights) "
                "and processor=")
        if draft_tokens or kv_bits == 8:
            raise NotImplementedError("speculative decoding and the int8 KV cache are not "
                                      "ported yet: ROADMAP Queue 1 item 13")
        self.processor = processor
        self.cfg = cfg or vl.VipLlavaConfig()
        if dtype is not None:
            from mars_tpu_torch.models.precision import cast_floating

            params = cast_floating(params, dtype)
        if quantize_bits is not None:
            from mars_tpu_torch.models.quantization import quantize_params

            params = quantize_params(params, bits=quantize_bits, int4_format=int4_format)
        self.params = params
        self.device = params["language"]["embed_tokens"].device
        self._prefix_ids_cache = {}
        self._prefix_kv_cache = None
        self._batch_prefix_cache = OrderedDict()

    def _eos_id(self):
        return getattr(self.processor.tokenizer, "eos_token_id", None)

    def _inplace_buffer_len(self, prefix_len: int, bucket: int) -> int:
        """Allocation length of the full-decode-length KV buffer of the
        in-place chained flow; >= ``_inplace_need`` for every retriever
        budget."""
        return prefix_len + bucket + self._INPLACE_BUDGET

    @staticmethod
    def _inplace_need(prefix_len: int, bucket: int, budget: int) -> int:
        return prefix_len + bucket + budget

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
        kw = dict(max_new_tokens=budget, true_length=tl, eos_id=self._eos_id(),
                  min_new_tokens=min_new_tokens, prefix_kv=prefix_kv, prefix_len=prefix_len)
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
                               self.cfg, max_len=self._inplace_buffer_len(lp, bucket))
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
        chunk = self.MAX_PREFIX_BATCH if shared_prefix else self.MAX_DECODE_BATCH
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
                               max_len=self._inplace_buffer_len(lp, bucket))
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
                  eos_id=self._eos_id(), min_new_tokens=mn,
                  prefix_kv=prefix_kv, prefix_len=prefix_len)
        if prefix_kv is not None and prefix_kv[0][0].shape[1] >= self._inplace_need(
                prefix_len, bucket, budget):
            toks, new_kv = vl.generate_greedy(self.params, self._ids(ids), pixels, self.cfg,
                                              inplace_prefix=True, return_caches=True, **kw)
            self._batch_prefix_cache[cache_key] = new_kv
        else:
            toks = vl.generate_greedy(self.params, self._ids(ids), pixels, self.cfg, **kw)
        toks = toks.cpu().numpy()
        return [self._decode_row(toks[i][:mx]) for i, mx in enumerate(maxs)]
