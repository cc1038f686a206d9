"""ViP-LLaVA (the retriever's vision-language model) in PyTorch (port of
``mars_tpu/models/vip_llava.py``, mirroring transformers'
``VipLlavaForConditionalGeneration``):

  - HF-CLIP vision tower (pre-LayerNorm, separate q/k/v/out projections,
    quick-GELU MLP) with per-layer hidden-state taps;
  - ViP-LLaVA feature selection (hidden states of ``vision_feature_layers``
    without CLS, concatenated over channels) and the LayerNorm → Linear →
    GELU → Linear projector;
  - LLaMA decoder: RMSNorm, half-rotation RoPE, grouped-query attention,
    SwiGLU MLP, a KV cache written in place (in the model's type, or int8
    with per-token per-head scales);
  - greedy decoding: a fixed-trip loop, or HF ``generate``'s EOS semantics
    (rows freeze at EOS, the loop stops once every row has), with per-row
    prompt lengths and EOS floors, shared-prefix resume and the in-place
    chained name → definition flow; and prompt-lookup speculative decoding
    (B = 1 and batched, with the acceptance and laggard gates), which is
    exact greedy.

Parameters are nested dicts in the JAX package's layout (dense kernels
(in, out)); a dense kernel that is a dict is weight-only quantized and its
products run through ``ops.int4_matmul`` (``layers.dense``).  Every entry
point runs on the device its parameters lie on and holds no state but
``STATS``, the counts the decode loops keep (LLaMA forwards, speculative
rounds, verify rounds and accepted drafts; vision-tower calls), which a
caller may reset.  ``config_from_hf`` reads transformers' ``config.json``
and ``param_shapes`` gives the tree's shapes, which a checkpoint is
audited against (``models.zoo.load_vip_llava``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mars_tpu_torch import device as device_lib
from mars_tpu_torch.models import convert
from mars_tpu_torch.models import layers as L
from mars_tpu_torch.models import quantization as Q
from mars_tpu_torch.ops import int4_matmul

# vision-tower calls, LLaMA forwards, speculative loop rounds, verify rounds
# among them, draft tokens accepted: counted where they run
STATS = {"vision": 0, "forwards": 0, "rounds": 0, "verify_rounds": 0, "accepted": 0}

# A cached forward of fewer rows (a decode step; a speculative verify of
# K + 1 rows) runs at this many query rows, and a decode's KV buffer holds
# this many slots past its last token, speculating or not.  cuBLAS and
# torch's reductions sum a row in an order set by the shapes (a GEMM's by
# its row count, attention's by the buffer's length), so a row then gets
# the same bits in a plain decode step as in a verify forward, and
# speculative decoding gives the tokens plain decoding gives, for every
# K < VERIFY_SLACK.  Not with 4-bit weights: their kernels take a route
# by the row count (the GEMV at a decode step's rows, the skinny GEMM at a
# verify's), which padding would trade away, and the routes sum apart, so
# there the streams may split where two logits are nearly tied.
VERIFY_SLACK = 16


def kv_slack(draft_tokens: int) -> int:
    """KV slots a decode allocates past its last token, speculating or not."""
    return max(VERIFY_SLACK, draft_tokens + 1)


@dataclass(frozen=True)
class VipLlavaConfig:
    # vision (CLIP-L/14@336 for the real model)
    v_hidden: int = 1024
    v_intermediate: int = 4096
    v_layers: int = 24
    v_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    vision_feature_layers: Tuple[int, ...] = (-2, -5, -8, -11, 6)
    # text (LLaMA-7B)
    hidden: int = 4096
    intermediate: int = 11008
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    vocab: int = 32064
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    image_token_index: int = 32000


TINY = VipLlavaConfig(
    v_hidden=32, v_intermediate=64, v_layers=4, v_heads=2, image_size=56,
    patch_size=14, vision_feature_layers=(-2, -4),
    hidden=32, intermediate=64, layers=2, heads=4, kv_heads=2, vocab=128,
    image_token_index=100,
)


# --------------------------------------------------------------------------
# vision tower (HF CLIP dialect)
# --------------------------------------------------------------------------

def vision_hidden_states(p, pixel_values, cfg: VipLlavaConfig):
    """(B, H, W, 3) → list of (B, 1+P, D) hidden states: the embeddings'
    output, then each encoder layer's."""
    b = pixel_values.shape[0]
    x = L.conv_patch_embed(p["patch_embed"], pixel_values, cfg.patch_size)
    cls = p["class_embedding"].reshape(1, 1, -1).expand(b, 1, cfg.v_hidden).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p["position_embedding"][None]
    x = L.layer_norm(p["pre_layernorm"], x)
    states = [x]
    for i in range(cfg.v_layers):
        lp = p[f"layer{i}"]
        x = x + _hf_attn(lp["attn"], L.layer_norm(lp["ln1"], x), cfg.v_heads)
        h = L.layer_norm(lp["ln2"], x)
        x = x + L.mlp(lp["mlp"], h, L.quick_gelu, _sliced(lp["attn"], x.shape[-1]))
        states.append(x)
    return states


def _sliced(attn, dim: int) -> bool:
    """Whether ``parallel.mesh.shard_params`` sliced this layer (its query
    projection is narrower than the hidden width): the layer then computes
    its local heads and reduces over the model group (``layers``)."""
    return L.out_features(attn["q"]) < dim


def _hf_attn(p, x, num_heads: int):
    b, l, d = x.shape
    hd = d // num_heads
    sliced = _sliced(p, d)
    if sliced:
        x = L.model_input(x)
    heads = L.out_features(p["q"]) // hd
    q = L.dense(p["q"], x).reshape(b, l, heads, hd)
    k = L.dense(p["k"], x).reshape(b, l, heads, hd)
    v = L.dense(p["v"], x).reshape(b, l, heads, hd)
    logits = torch.einsum("blhd,bmhd->bhlm", q * hd ** -0.5, k)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(b, l, heads * hd)
    return L.dense_reduce(p["out"], out, sliced)


def image_features(p, pixel_values, cfg: VipLlavaConfig):
    """Multi-layer feature selection + projector → (B, P, hidden)."""
    STATS["vision"] += 1
    states = vision_hidden_states(p["vision"], pixel_values, cfg)
    feats = torch.cat([states[i][:, 1:] for i in cfg.vision_feature_layers], dim=-1)
    mp = p["projector"]
    h = L.dense(mp["linear_1"], L.layer_norm(mp["ln"], feats))
    return L.dense(mp["linear_2"], F.gelu(h))


# --------------------------------------------------------------------------
# LLaMA decoder
# --------------------------------------------------------------------------

def _padded_rows(x, rows: int):
    """x (B, L, ...) zero-padded to ``rows`` along L."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, rows - x.shape[1]))


def _four_bit(layer) -> bool:
    """Whether a LLaMA layer's dense kernels are 4-bit (int4 or NF4)."""
    return any(isinstance(d["kernel"], dict) and ("q4" in d["kernel"] or "nf4" in d["kernel"])
               for d in list(layer["attn"].values()) + list(layer["mlp"].values())
               if isinstance(d, dict) and "kernel" in d)


def _rms_norm(w, x, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * w).to(x.dtype)


def _rope(x, positions, theta: float):
    """HF half-rotation RoPE: x (B, L, H, hd), positions (B, L)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions[..., None].float() * inv  # (B, L, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _kv_quant(x):
    """Per-token per-head symmetric int8: (B, L, KVH, hd) → int8 values and
    (B, L, KVH, 1) float32 dequant scales (amax / 127 over the head dim)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.round(xf * (127.0 / s)).to(torch.int8), s * (1.0 / 127.0)


def _llama_attention(p, x, positions, cfg: VipLlavaConfig, kv_cache=None, cache_pos=None,
                     live: Optional[int] = None):
    """Self-attention with RoPE and GQA.  With ``kv_cache`` = (K, V), each
    (B, MAX, KVH, hd), the new keys and values are written IN PLACE at
    ``cache_pos`` (an int, or a (B,) tensor for per-row positions, which
    scatters only the written slots) and attention runs over the whole
    cache, masked beyond each query's position.  A 4-tuple (K_i8, V_i8,
    k_scale, v_scale) is the int8 cache: keys and values are quantized per
    token and head as they are written and dequantized for the read.
    ``live`` < L: only the first ``live`` rows are tokens; the rest are
    padding (``llama_forward``), which writes nothing to the cache."""
    b, rows, d = x.shape
    l = rows if live is None else live
    hd = d // cfg.heads
    sliced = _sliced(p, d)
    if sliced:
        x = L.model_input(x)
    heads, kv_heads = L.out_features(p["q"]) // hd, L.out_features(p["k"]) // hd
    q = _rope(L.dense(p["q"], x).reshape(b, rows, heads, hd), positions, cfg.rope_theta)
    k = _rope(L.dense(p["k"], x).reshape(b, rows, kv_heads, hd), positions,
              cfg.rope_theta)[:, :l]
    v = L.dense(p["v"], x).reshape(b, rows, kv_heads, hd)[:, :l]

    if kv_cache is None:
        keys, values, kv_positions = k, v, positions
    else:
        quant = len(kv_cache) == 4
        if quant:
            (kq, ks), (vq, vs) = _kv_quant(k), _kv_quant(v)
            news = (kq, vq, ks, vs)
        else:
            news = (k, v)
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1:
            brow = torch.arange(b, device=x.device)[:, None]
            cols = cache_pos[:, None] + torch.arange(l, device=x.device)[None]
            if l > 1:
                # a frozen row of the batched speculative loop may verify
                # past the buffer; its writes land in the last slot, which
                # no live query attends (JAX drops them)
                cols = cols.clamp(max=kv_cache[0].shape[1] - 1)
            for buf, new in zip(kv_cache, news):
                buf[brow, cols] = new.to(buf.dtype)
        else:
            for buf, new in zip(kv_cache, news):
                buf[:, cache_pos:cache_pos + l] = new.to(buf.dtype)
        if quant:
            keys = (kv_cache[0].float() * kv_cache[2]).to(x.dtype)
            values = (kv_cache[1].float() * kv_cache[3]).to(x.dtype)
        else:
            keys, values = kv_cache
        kv_positions = torch.arange(keys.shape[1], device=x.device)[None]

    rep = heads // kv_heads
    if rep > 1:
        keys = keys.repeat_interleave(rep, dim=2)
        values = values.repeat_interleave(rep, dim=2)
    logits = torch.einsum("blhd,bmhd->bhlm", q * hd ** -0.5, keys)
    valid = kv_positions[:, None, None, :] <= positions[:, None, :, None]
    if kv_cache is not None:
        cp = cache_pos.reshape(-1, 1, 1, 1) if isinstance(cache_pos, torch.Tensor) else cache_pos
        valid = valid & (kv_positions[:, None, None, :] <= cp + l - 1)
    logits = logits.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs, values).reshape(b, rows, heads * hd)
    return L.dense_reduce(p["o"], out, sliced), kv_cache


def _llama_layer(p, x, positions, cfg, kv_cache=None, cache_pos=None,
                 live: Optional[int] = None):
    live = x.shape[1] if live is None else live
    h, kv_cache = _llama_attention(p["attn"], _rms_norm(p["input_ln"], x, cfg.rms_eps),
                                   positions, cfg, kv_cache, cache_pos, live)
    x = x + h
    h = _rms_norm(p["post_ln"], x, cfg.rms_eps)
    sliced = _sliced(p["attn"], x.shape[-1])
    if sliced:
        h = L.model_input(h)
    gate = F.silu(L.dense(p["mlp"]["gate"], h))
    x = x + L.dense_reduce(p["mlp"]["down"], gate * L.dense(p["mlp"]["up"], h), sliced)
    return x, kv_cache


def llama_forward(p, embeds, positions, cfg: VipLlavaConfig, kv_caches=None, cache_pos=None):
    """embeds (B, L, D) → (logits (B, L, V), the caches, written in place).
    A cached forward of L < VERIFY_SLACK rows without 4-bit weights runs at
    VERIFY_SLACK: zero rows after the L tokens, at the last one's position,
    whose keys and values are not written and whose logits are dropped."""
    STATS["forwards"] += 1
    live = embeds.shape[1]
    x = embeds
    if kv_caches is not None and live < VERIFY_SLACK and not _four_bit(p["layer0"]):
        x = _padded_rows(embeds, VERIFY_SLACK)
        positions = torch.cat(
            [positions, positions[:, -1:].expand(-1, VERIFY_SLACK - live)], dim=1)
    for i in range(cfg.layers):
        cache = None if kv_caches is None else kv_caches[i]
        x, _ = _llama_layer(p[f"layer{i}"], x, positions, cfg, cache, cache_pos, live)
    x = _rms_norm(p["norm"], x, cfg.rms_eps)
    lm = p["lm_head"]
    logits = L.dense({"kernel": lm}, x) if isinstance(lm, dict) else x @ lm
    return logits[:, :live], kv_caches


# --------------------------------------------------------------------------
# multimodal assembly + greedy decoding
# --------------------------------------------------------------------------

def embed_multimodal(p, input_ids, pixel_values, cfg: VipLlavaConfig):
    """Token embeddings with the image-token slots replaced, in order, by
    the projected image features; ``input_ids`` holds exactly
    (image_size / patch)² image tokens per row."""
    embeds = p["language"]["embed_tokens"][input_ids]
    feats = image_features(p, pixel_values, cfg)  # (B, P, D)
    is_img = input_ids == cfg.image_token_index
    ordinal = (torch.cumsum(is_img.long(), dim=1) - 1).clamp(0, feats.shape[1] - 1)
    gathered = torch.take_along_dim(feats, ordinal[..., None], dim=1)
    return torch.where(is_img[..., None], gathered.to(embeds.dtype), embeds)


def _alloc_cache(b: int, length: int, cfg: VipLlavaConfig, dtype, device, kv_bits=None,
                 kv_heads: Optional[int] = None):
    """One layer's zeroed cache: (K, V) in ``dtype``, or with ``kv_bits=8``
    the int8 4-tuple (K_i8, V_i8, k_scale, v_scale) (zero scales at
    unwritten slots are inert: the causal mask excludes them).
    ``kv_heads``: the layer's own (a sliced layer holds its local heads)."""
    shape = (b, length, kv_heads or cfg.kv_heads, cfg.hidden // cfg.heads)
    if kv_bits == 8:
        sshape = shape[:3] + (1,)
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device))
    if kv_bits not in (None, 16):
        raise ValueError(f"kv_bits must be None/16/8, got {kv_bits}")
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _kv_heads(layer, cfg: VipLlavaConfig) -> int:
    """The key/value heads a LLaMA layer's parameters hold."""
    return L.out_features(layer["attn"]["k"]) // (cfg.hidden // cfg.heads)


@torch.no_grad()
def prefill_prefix(p, prefix_ids, pixel_values, cfg: VipLlavaConfig, max_len: int = 0,
                   kv_bits: Optional[int] = None):
    """KV caches of a shared multimodal prompt prefix.  ``max_len`` > the
    prefix length allocates the caches at the full decode length with the
    prefix at their head: the in-place flow (``generate_greedy(prefix_kv=…,
    inplace_prefix=True)``) then chains the name and definition decodes
    through this one buffer."""
    b, lp = prefix_ids.shape
    embeds = embed_multimodal(p, prefix_ids, pixel_values, cfg)
    positions = torch.arange(lp, device=embeds.device)[None].expand(b, lp)
    if max_len and max_len < lp:
        raise ValueError(f"max_len {max_len} < prefix length {lp}")
    lang = p["language"]
    caches = [_alloc_cache(b, max_len or lp, cfg, embeds.dtype, embeds.device, kv_bits,
                           _kv_heads(lang[f"layer{i}"], cfg)) for i in range(cfg.layers)]
    _, caches = llama_forward(p["language"], embeds, positions, cfg, caches, 0)
    return caches


def _argmax_first(x):
    """Index of the first maximum along the last axis (``jnp.argmax``'s tie
    rule, stated rather than left to the backend)."""
    top = x.max(dim=-1, keepdim=True).values
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(x == top, idx, x.shape[-1]).min(dim=-1).values


@torch.no_grad()
def generate_greedy(p, input_ids, pixel_values, cfg: VipLlavaConfig, max_new_tokens: int = 20,
                    true_length=None, eos_id: Optional[int] = None, min_new_tokens=0,
                    draft_tokens: int = 0, ngram: int = 3, draft_gate: int = 2,
                    prefix_kv=None, prefix_len: int = 0, inplace_prefix: bool = False,
                    return_caches: bool = False, kv_bits: Optional[int] = None):
    """Greedy decode → (B, max_new_tokens) token ids (and the caches when
    ``return_caches``).

    ``true_length``: the real prompt length (an int, or (B,) per row) when
    ``input_ids`` is right-padded to a bucket; stale pad slots sit past each
    query's position and are rewritten before they are attended.
    ``eos_id``: a row that emits EOS is frozen and EOS-filled, and the loop
    stops once every row is done; ``min_new_tokens`` (an int or a per-row
    tuple) masks EOS for the first N emitted tokens.  ``eos_id=None`` runs a
    fixed trip of ``max_new_tokens - 1`` decode steps.
    ``draft_tokens=K > 0``: prompt-lookup speculative decoding, exact
    greedy (``_speculative_greedy_batched``, every B),
    gated by ``draft_gate`` consecutive hits of the ``ngram`` lookup.
    ``prefix_kv`` + ``prefix_len``: resume from ``prefill_prefix``;
    ``input_ids`` is then the text-only suffix.  Without ``inplace_prefix``
    the prefix is COPIED into fresh decode caches (of the prefix's format,
    whatever ``kv_bits`` says) and ``prefix_kv`` is left as it was; with it,
    the decode writes into ``prefix_kv`` itself (sized by
    ``prefill_prefix(max_len=…)``), which is returned with
    ``return_caches=True`` and chains into the next query.
    ``kv_bits=8``: the int8 KV cache (``_kv_quant``).

    The EOS loop reads ``all(done)`` on the host after every step: one
    small copy per step, and exactly the decode steps of the JAX package's
    ``lax.while_loop`` (none past the step where the last row finishes)."""
    lang = p["language"]
    dev = lang["embed_tokens"].device
    b, l0 = input_ids.shape
    if prefix_kv is not None:
        embeds = lang["embed_tokens"][input_ids]
    else:
        embeds = embed_multimodal(p, input_ids, pixel_values, cfg)
    positions = (prefix_len + torch.arange(l0, device=dev))[None].expand(b, l0)
    end = prefix_len + l0 + max_new_tokens
    if inplace_prefix:
        if prefix_kv is None:
            raise ValueError("inplace_prefix needs prefix_kv")
        # a verify forward writes K + 1 slots past the accepted length
        need = end + (draft_tokens + 1 if draft_tokens else 0)
        if prefix_kv[0][0].shape[1] < need:
            raise ValueError(f"inplace prefix_kv length {prefix_kv[0][0].shape[1]} < required "
                             f"{need} (prefill with max_len >= this)")
        caches = prefix_kv
    else:
        bits = (8 if len(prefix_kv[0]) == 4 else None) if prefix_kv is not None else kv_bits
        caches = [_alloc_cache(b, end + kv_slack(draft_tokens), cfg, embeds.dtype, dev, bits,
                               _kv_heads(lang[f"layer{i}"], cfg)) for i in range(cfg.layers)]
        if prefix_kv is not None:
            for cache, pcache in zip(caches, prefix_kv):
                for buf, pbuf in zip(cache, pcache):
                    buf[:, :prefix_len] = pbuf[:, :prefix_len].to(buf.dtype)
    logits, caches = llama_forward(lang, embeds, positions, cfg, caches, prefix_len)

    mins = (list(min_new_tokens) if isinstance(min_new_tokens, (tuple, list))
            else [min_new_tokens] * b)

    def pick_next(last, emit_idx):
        # HF's MinNewTokensLengthLogitsProcessor: no EOS before the floor
        low = [r for r, m in enumerate(mins) if emit_idx < m]
        if eos_id is not None and low:
            last = last.clone()
            last[low, eos_id] = float("-inf")
        return _argmax_first(last)

    if true_length is None:
        next_tok = pick_next(logits[:, -1], 0)
        start = prefix_len + l0
        per_row = False
    else:
        tl = torch.as_tensor(true_length, device=dev).long()
        per_row = tl.dim() == 1
        if per_row:
            last = logits[torch.arange(b, device=dev), tl - 1]
            start = prefix_len + tl
        else:
            last = logits[:, int(tl) - 1]
            start = prefix_len + int(tl)
        next_tok = pick_next(last, 0)

    if draft_tokens > 0:
        # the lookup buffer holds the (suffix) input_ids, so it indexes at
        # buffer-relative positions; cache writes stay absolute
        rel = (start.cpu().numpy() if per_row else np.full((b,), start)) - prefix_len
        out = _speculative_greedy_batched(lang, cfg, input_ids.cpu().numpy(), caches,
                                          next_tok.cpu().numpy(), rel, max_new_tokens, eos_id,
                                          mins, draft_tokens, ngram, prefix_len, draft_gate)
        return (out, caches) if return_caches else out

    def advance(tok, i):
        pos = start + i
        emb = lang["embed_tokens"][tok][:, None]
        pos_ids = pos[:, None] if per_row else torch.full((b, 1), pos, device=dev)
        out, _ = llama_forward(lang, emb, pos_ids, cfg, caches, pos)
        return pick_next(out[:, -1], i + 1)

    if eos_id is None:
        toks = [next_tok]
        for i in range(max_new_tokens - 1):
            toks.append(advance(toks[-1], i))
        out = torch.stack(toks, dim=1)
        return (out, caches) if return_caches else out

    buf = torch.full((b, max_new_tokens), eos_id, dtype=next_tok.dtype, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tok = next_tok
    for i in range(max_new_tokens):
        buf[:, i] = tok
        done |= tok == eos_id
        if i + 1 >= max_new_tokens or bool(done.all()):
            break
        # frozen rows keep streaming EOS; their KV writes are never read
        tok = torch.where(done, eos_id, advance(tok, i))
    return (buf, caches) if return_caches else buf


def _prompt_lookup_draft(seq: np.ndarray, end: int, n: int, k: int) -> np.ndarray:
    """K draft tokens by n-gram self-lookup: the K tokens that followed the
    most recent earlier occurrence of ``seq[end-n+1 .. end]``.  No match (or
    a continuation that runs past ``end``) drafts stale tokens, which the
    verify rejects.  Slices clamp as ``lax.dynamic_slice`` does."""
    size = seq.shape[0]
    g0 = min(max(end - n + 1, 0), size - n)
    gram = seq[g0:g0 + n]
    idx = np.arange(size)
    ok = (idx >= n - 1) & (idx < end)
    for t in range(n):  # ok[j] ⇔ seq[j-n+1 .. j] == gram
        ok &= np.roll(seq, t) == gram[n - 1 - t]
    q = int(np.max(np.where(ok, idx, -1)))
    s0 = min(max(q + 1, 0), size - k)
    return seq[s0:s0 + k]


def _spec_argmax(lang, cfg, ids, cache_pos, emit0, mins, eos_id, caches):
    """One forward of ``ids`` (B, L) at per-row cache positions ``cache_pos``
    (B,) (an int for B = 1), EOS masked where the emitted slot
    ``emit0 + j`` is under the row's floor → the (B, L) greedy tokens on the
    host: the round's one sync."""
    dev = lang["embed_tokens"].device
    b, l = ids.shape
    pos = np.asarray(cache_pos).reshape(-1, 1) + np.arange(l)[None]
    positions = torch.from_numpy(np.array(np.broadcast_to(pos, (b, l)))).to(dev)
    cp = cache_pos if isinstance(cache_pos, int) else torch.from_numpy(
        np.asarray(cache_pos, np.int64)).to(dev)
    low = None
    if eos_id is not None and max(mins) > 0:
        low = torch.from_numpy((np.asarray(emit0).reshape(-1, 1) + np.arange(l)[None])
                               < np.asarray(mins).reshape(-1, 1)).to(dev)
    # a draft copied from the lookup buffer's unwritten tail is -1: it
    # indexes the last embedding row, as JAX's wrapping gather does, and
    # never matches a greedy token
    emb = lang["embed_tokens"][torch.from_numpy(np.mod(ids, cfg.vocab)).to(dev)]
    logits, _ = llama_forward(lang, emb, positions, cfg, caches, cp)
    lg = logits.float()
    if low is not None:
        lg[..., eos_id] = lg[..., eos_id].masked_fill(low, float("-inf"))
    return _argmax_first(lg).cpu().numpy()


def _accepted(d, g, eos_id, k: int):
    """Per row, the drafts of ``d`` (B, K) that the greedy tokens ``g``
    (B, K+1) confirm: the matching prefix, cut at an EOS inside it (that
    EOS becomes the carry)."""
    a = np.cumprod(d == g[:, :-1], axis=1).sum(axis=1)
    if eos_id is None:
        return a
    j = np.arange(k + 1)[None]
    f = np.where((g == eos_id) & (j <= a[:, None]), j, k + 1).min(axis=1)
    return np.minimum(a, f)


def _speculative_greedy_batched(lang, cfg, input_ids, caches, next_tok, start,
                                max_new_tokens: int, eos_id, mins, k: int, n: int,
                                cache_offset: int = 0, gate: int = 0):
    """Prompt-lookup speculative greedy (``mars_tpu``'s
    ``_speculative_greedy_batched``, and at B = 1 its
    ``_speculative_greedy``, whose rounds this loop makes there): per-row
    emitted counts, lookup buffers and done flags; the carry is a correct
    greedy token not yet emitted, and each round emits it, then one
    (B, K+1)-position verify forward at per-row cache positions extends
    each row by its accepted drafts, or yields the next carry.  Finished
    rows ride along frozen.  The bookkeeping lives on the host, the
    forwards and argmaxes on the device: one sync a round.  ``start`` is
    relative to ``input_ids``; ``cache_offset`` shifts the cache positions
    of a prefix resume.

    ``gate > 0``: a round verifies only when every laggard (a live row of
    least progress) is in verify mode and some live row is; otherwise it is
    a plain (B, 1) step.  A verify round scores each live row on its own
    acceptance (one that accepts nothing drops back to probing), a probe
    round counts each row's lookup hits."""
    bsz, l0 = input_ids.shape
    big_n = max_new_tokens
    fill = eos_id if eos_id is not None else 0
    mins = np.asarray(mins, np.int64)
    # a frozen row's progress may sit at up to N + K and its ignored writes
    # index K past that
    seq = np.full((bsz, l0 + big_n + 2 * k + 1), -1, np.int64)
    seq[:, :l0] = input_ids
    buf = np.full((bsz, big_n + 2 * k), fill, np.int64)
    rows = np.arange(bsz)
    start = np.asarray(start, np.int64)
    tok = np.asarray(next_tok, np.int64)
    i = np.zeros((bsz,), np.int64)
    done = np.zeros((bsz,), bool)
    score = np.zeros((bsz,), np.int64)
    kk = np.arange(k)
    while np.any(~done & (i < big_n)):
        active = ~done & (i < big_n)
        buf[rows, i] = np.where(active, tok, buf[rows, i])
        if eos_id is not None:
            done = done | (active & (tok == eos_id))
        end = start + i
        seq[rows, end] = np.where(active, tok, seq[rows, end])
        live = ~done & (i + 1 < big_n)
        d = np.stack([_prompt_lookup_draft(seq[r], int(end[r]), n, k) for r in rows])
        if gate > 0:
            spec = score >= gate
            lag = live & (i == np.where(live, i, np.iinfo(np.int64).max).min())
            verify = bool(np.any(live & spec)) and not np.any(lag & ~spec)
        else:
            verify = True
        if not live.any():
            # the last emissions: no forward result would be used (JAX runs
            # one and discards it)
            w, carry, gd = np.zeros((bsz,), np.int64), tok, np.full((bsz, k), fill, np.int64)
        elif verify:
            g = _spec_argmax(lang, cfg, np.concatenate([tok[:, None], d], axis=1),
                             cache_offset + end, i + 1, mins, eos_id, caches)
            w = np.where(live, _accepted(d, g, eos_id, k), 0)
            carry = np.where(live, g[rows, w], tok)
            gd = np.where(live[:, None], g[:, :k], fill)
            STATS["verify_rounds"] += 1
            STATS["accepted"] += int(w.sum())
        else:
            g0 = _spec_argmax(lang, cfg, tok[:, None], cache_offset + end, i + 1, mins, eos_id,
                              caches)[:, 0]
            w = np.zeros((bsz,), np.int64)
            carry = np.where(live, g0, tok)
            gd = np.full((bsz, k), fill, np.int64)
        if gate > 0:
            score = np.where(~live, score,
                             np.where(w > 0, np.maximum(score, gate), 0) if verify
                             else np.where(d[:, 0] == carry, score + 1, 0))
        seq[rows[:, None], end[:, None] + 1 + kk[None]] = gd
        bcols = i[:, None] + 1 + kk[None]
        inb = bcols < buf.shape[1]  # JAX drops the writes past the buffer
        keep = np.where(kk[None] < w[:, None], gd, buf[rows[:, None], np.minimum(
            bcols, buf.shape[1] - 1)])
        buf[np.broadcast_to(rows[:, None], bcols.shape)[inb], bcols[inb]] = keep[inb]
        i = i + np.where(active, 1 + w, 0)
        tok = carry
        STATS["rounds"] += 1
    dev = lang["embed_tokens"].device
    return torch.from_numpy(buf[:, :big_n]).to(dev)


@torch.no_grad()
def forward_logits(p, input_ids, pixel_values, cfg: VipLlavaConfig):
    """Full-sequence logits (parity testing)."""
    embeds = embed_multimodal(p, input_ids, pixel_values, cfg)
    b, l = input_ids.shape
    positions = torch.arange(l, device=embeds.device)[None].expand(b, l)
    logits, _ = llama_forward(p["language"], embeds, positions, cfg)
    return logits


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

# transformers' defaults for what a ViP-LLaVA ``config.json`` leaves out
# (``LlamaConfig``, ``CLIPVisionConfig``, ``VipLlavaConfig``), and the vision
# tower ``VipLlavaConfig`` builds when the file has none
_HF_TOP = {"model_type": "vipllava", "projector_hidden_act": "gelu",
           "projector_layernorm_eps": 1e-5, "vision_feature_layers": [-2, -5, -8, -11, 6],
           "image_token_index": 32000}
_HF_TEXT = {"model_type": "llama", "vocab_size": 32000, "hidden_size": 4096,
            "intermediate_size": 11008, "num_hidden_layers": 32, "num_attention_heads": 32,
            "num_key_value_heads": None, "head_dim": None, "hidden_act": "silu",
            "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "rope_scaling": None,
            "attention_bias": False, "mlp_bias": False, "tie_word_embeddings": False}
_HF_VISION = {"model_type": "clip_vision_model", "hidden_size": 768, "intermediate_size": 3072,
              "num_hidden_layers": 12, "num_attention_heads": 12, "num_channels": 3,
              "image_size": 224, "patch_size": 32, "hidden_act": "quick_gelu",
              "layer_norm_eps": 1e-5}
_HF_VIP_VISION = {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24,
                  "num_attention_heads": 16, "image_size": 336, "patch_size": 14}
# (section, field, the one value the model implements): the projector's
# LayerNorm and every vision LayerNorm run at ``layers.layer_norm``'s 1e-5
_HF_FIXED = (("", "model_type", "vipllava"), ("", "projector_hidden_act", "gelu"),
             ("", "projector_layernorm_eps", 1e-5),
             ("text_config", "model_type", "llama"), ("text_config", "hidden_act", "silu"),
             ("text_config", "rope_scaling", None), ("text_config", "attention_bias", False),
             ("text_config", "mlp_bias", False), ("text_config", "tie_word_embeddings", False),
             ("vision_config", "model_type", "clip_vision_model"),
             ("vision_config", "hidden_act", "quick_gelu"),
             ("vision_config", "layer_norm_eps", 1e-5), ("vision_config", "num_channels", 3))


def config_from_hf(d: dict) -> VipLlavaConfig:
    """transformers' ViP-LLaVA ``config.json`` (parsed) → VipLlavaConfig,
    transformers' defaults filling the fields it leaves out.  Raises
    ``ValueError`` on a value the model does not implement (a rope scaling,
    another activation, LayerNorm epsilon or head width, biased LLaMA
    projections, tied embeddings)."""
    top = {**_HF_TOP, **d}
    if "image_token_id" in d and "image_token_index" not in d:
        top["image_token_index"] = d["image_token_id"]
    sections = {"": top, "text_config": {**_HF_TEXT, **(d.get("text_config") or {})},
                "vision_config": {**_HF_VISION, **(_HF_VIP_VISION if d.get("vision_config") is None
                                                   else d["vision_config"])}}
    for section, key, want in _HF_FIXED:
        got = sections[section][key]
        if got != want:
            name = f"{section}.{key}" if section else key
            raise ValueError(f"config.json: {name} is {got!r}; the model implements {want!r}")
    text, vision = sections["text_config"], sections["vision_config"]
    heads = text["num_attention_heads"]
    if text["head_dim"] is not None and text["head_dim"] * heads != text["hidden_size"]:
        raise ValueError(f"config.json: text_config.head_dim is {text['head_dim']}; the model "
                         f"implements hidden_size / num_attention_heads")
    return VipLlavaConfig(
        v_hidden=vision["hidden_size"], v_intermediate=vision["intermediate_size"],
        v_layers=vision["num_hidden_layers"], v_heads=vision["num_attention_heads"],
        image_size=vision["image_size"], patch_size=vision["patch_size"],
        vision_feature_layers=tuple(top["vision_feature_layers"]),
        hidden=text["hidden_size"], intermediate=text["intermediate_size"],
        layers=text["num_hidden_layers"], heads=heads,
        kv_heads=text["num_key_value_heads"] or heads, vocab=text["vocab_size"],
        rope_theta=float(text["rope_theta"]), rms_eps=float(text["rms_norm_eps"]),
        image_token_index=top["image_token_index"])


def convert_hf(sd: dict, cfg: VipLlavaConfig, device="cpu", dtype=torch.float32) -> dict:
    """HF ``VipLlavaForConditionalGeneration`` state dict (numpy) → params."""
    return convert.from_jax_params(convert.vip_llava_tree(sd, cfg.v_layers, cfg.layers),
                                   device, dtype)


def param_shapes(cfg: VipLlavaConfig) -> dict:
    """The parameter tree's shapes (``convert_hf``'s layout)."""
    c = cfg
    g = c.image_size // c.patch_size
    hd = c.hidden // c.heads

    def ln(d):
        return {"scale": (d,), "bias": (d,)}

    def dense(din, dout, bias=True):
        return {"kernel": (din, dout), **({"bias": (dout,)} if bias else {})}

    vision = {"patch_embed": {"kernel": (c.patch_size, c.patch_size, 3, c.v_hidden)},
              "class_embedding": (c.v_hidden,), "position_embedding": (g * g + 1, c.v_hidden),
              "pre_layernorm": ln(c.v_hidden)}
    for i in range(c.v_layers):
        vision[f"layer{i}"] = {
            "ln1": ln(c.v_hidden), "ln2": ln(c.v_hidden),
            "attn": {n: dense(c.v_hidden, c.v_hidden) for n in ("q", "k", "v", "out")},
            "mlp": {"fc1": dense(c.v_hidden, c.v_intermediate),
                    "fc2": dense(c.v_intermediate, c.v_hidden)},
        }
    n_feat = len(c.vision_feature_layers)
    projector = {"ln": ln(c.v_hidden * n_feat),
                 "linear_1": dense(c.v_hidden * n_feat, c.hidden),
                 "linear_2": dense(c.hidden, c.hidden)}
    language = {"embed_tokens": (c.vocab, c.hidden), "norm": (c.hidden,),
                "lm_head": (c.hidden, c.vocab)}
    for i in range(c.layers):
        language[f"layer{i}"] = {
            "input_ln": (c.hidden,), "post_ln": (c.hidden,),
            "attn": {"q": dense(c.hidden, c.hidden, False),
                     "k": dense(c.hidden, c.kv_heads * hd, False),
                     "v": dense(c.hidden, c.kv_heads * hd, False),
                     "o": dense(c.hidden, c.hidden, False)},
            "mlp": {"gate": dense(c.hidden, c.intermediate, False),
                    "up": dense(c.hidden, c.intermediate, False),
                    "down": dense(c.intermediate, c.hidden, False)},
        }
    return {"vision": vision, "projector": projector, "language": language}


# the leaves drawn as ones; "bias" leaves are zeros, every other leaf is drawn
_ONES = ("scale", "norm", "input_ln", "post_ln")


def init_random_params(seed: int, cfg: VipLlavaConfig, quantize_bits: Optional[int] = None,
                       dtype=torch.bfloat16, int4_format: str = "affine", device=None) -> dict:
    """Seeded random parameters with ``convert_hf``'s tree (smoke runs and
    benchmarks without weights), drawn from a ``torch.Generator`` on the
    target device in the JAX package's distributions: floating leaves
    N(0, 0.02²), norm scales 1, biases 0; with ``quantize_bits`` the 2-D
    kernels of at least 2^14 elements are drawn QUANTIZED, one kernel at a
    time (int8/int4 codes uniform over their range, scales uniform in
    [1e-4, 3e-4]; NF4 quantizes one N(0, 0.02²) kernel), so a full-width
    float32 7B (27 GB) is never made.  ``lm_head`` stays floating."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    def scales(n):
        return torch.empty((n,), device=dev).uniform_(1e-4, 3e-4, generator=gen)

    def kernel(din, dout):
        if din * dout >= (1 << 14) and quantize_bits == 8:
            q = torch.randint(-127, 128, (din, dout), generator=gen, device=dev,
                              dtype=torch.int8)
            return {"q": q, "scale": scales(dout)}
        if din * dout >= (1 << 14) and quantize_bits == 4:
            if int4_format == "nf4":
                return Q.quantize_kernel_nf4(normal(din, dout))
            q = torch.randint(-7, 8, (din, dout), generator=gen, device=dev, dtype=torch.int8)
            return {"q4": int4_matmul.pack_int4(q), "scale": scales(dout)}
        return normal(din, dout).to(dtype)

    def draw(name, shape):
        if isinstance(shape, dict):
            return {k: draw(k, v) for k, v in shape.items()}
        if name in _ONES:
            return torch.ones(shape, dtype=dtype, device=dev)
        if name == "bias":
            return torch.zeros(shape, dtype=dtype, device=dev)
        if name == "kernel" and len(shape) == 2:
            return kernel(*shape)
        return normal(*shape).to(dtype)

    return draw("", param_shapes(cfg))
