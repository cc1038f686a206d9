#!/usr/bin/env python3
"""Where the text path's speculative streams can split from plain decoding,
and what running a cached forward at ``vip_llava.VERIFY_SLACK`` rows
costs, on one card.

    python3 tools/text_splits_probe.py [ops] [blocks] [phase]

ViP-LLaVA-7B at full width on seeded random weights, as ``chip_smoke.py``
builds it.  One JSON line per measurement (no argument: all three parts):

- ``ops``: at 8 and 4 bits, each operation of a LLaMA forward at a decode
  step's rows (B = 4, one query row each) against the same rows inside a
  speculative verify forward (B x 9 query rows), neither padded: the dense
  (the 8-bit route, or the 4-bit kernels' GEMV against their skinny GEMM),
  the LM head, RMSNorm, the two attention products, one layer's attention
  over a bf16 and an int8 cache of 781 slots; then the whole 32-layer
  forward over each cache, run at VERIFY_SLACK rows (the port; not with
  4-bit weights, whose forwards keep their rows) and at its own rows
  (``VERIFY_SLACK`` = 0): a verify of 9 rows against 9 decode steps.  Equal bits, the largest difference, and for the forward the
  largest difference over the largest logit.
- ``blocks``: ``chip_smoke.py``'s text block (4 rows, names then
  definitions) at 8 bits, 8 bits with the int8 KV cache and int4 with it,
  each through both forms (padded, unpadded, unpadded, padded), speculating
  (K = 8) and decoding plainly: block ms, prefill ms, forwards and decode
  ms a step; the first speculative block of each form is rerun plainly
  (``chip_smoke._plain_splits``): rows that split and the largest top-two
  logit gap at a split over the top logit; at 8 bits also over four more
  seeds of the block's images, in both forms.
- ``phase``: ``chip_smoke.phase_text_int8`` alone.
"""
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEVICE = "cuda"
DRAFT = 8
CONTEXT = 700  # cached positions before the decode step (the block's ~700-770)
SLOTS = CONTEXT + 81


def emit(row):
    print(json.dumps(row), flush=True)


def _same_rows(one, many):
    """A decode step's rows against the same rows of a verify forward."""
    d = (one.float() - many.float()).abs()
    return {"equal": bool(d.max() == 0), "max_abs_diff": float(d.max()),
            "max_abs": float(one.float().abs().max())}


def _clone(caches):
    return [tuple(t.clone() for t in c) for c in caches]


class _Slack:
    """``vip_llava.VERIFY_SLACK`` set to ``value`` inside the block: 0 runs
    every cached forward at its own rows, over a buffer of K + 1 slots past
    the decode (1 without speculation)."""

    def __init__(self, value):
        self.value = value

    def __enter__(self):
        from mars_tpu_torch.models import vip_llava as vl

        self.saved, vl.VERIFY_SLACK = vl.VERIFY_SLACK, self.value

    def __exit__(self, *exc):
        from mars_tpu_torch.models import vip_llava as vl

        vl.VERIFY_SLACK = self.saved


def ops(params, cfg, bits):
    import torch

    from mars_tpu_torch.models import layers as L, vip_llava as vl

    lang, b, l = params["language"], 4, DRAFT + 1
    layer = lang["layer0"]
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    bf = torch.bfloat16
    x = torch.randn((b, l, cfg.hidden), generator=gen, device=DEVICE).to(bf)
    x1 = x[:, :1].contiguous()
    rows = {}
    for name, fn in (("dense", lambda t: L.dense(layer["mlp"]["gate"], t)),
                     ("lm_head", lambda t: t @ lang["lm_head"]),
                     ("rms_norm", lambda t: vl._rms_norm(layer["input_ln"], t, cfg.rms_eps))):
        rows[name] = _same_rows(fn(x1), fn(x)[:, :1])
    hd = cfg.hidden // cfg.heads
    q = torch.randn((b, l, cfg.heads, hd), generator=gen, device=DEVICE).to(bf)
    keys = torch.randn((b, SLOTS, cfg.heads, hd), generator=gen, device=DEVICE).to(bf)
    lg = torch.einsum("blhd,bmhd->bhlm", q, keys)
    rows["qk_product"] = _same_rows(torch.einsum("blhd,bmhd->bhlm", q[:, :1].contiguous(), keys),
                                    lg[:, :, :1])
    probs = torch.softmax(lg.float(), dim=-1).to(bf)
    out = torch.einsum("bhlm,bmhd->blhd", probs, keys)
    rows["pv_product"] = _same_rows(
        torch.einsum("bhlm,bmhd->blhd", probs[:, :, :1].contiguous(), keys), out[:, :1])
    pos0 = torch.arange(CONTEXT, device=DEVICE)[None].expand(b, CONTEXT)
    x0 = torch.randn((b, CONTEXT, cfg.hidden), generator=gen, device=DEVICE).to(bf)
    cp = torch.full((b,), CONTEXT, dtype=torch.long, device=DEVICE)
    pos = (CONTEXT + torch.arange(l, device=DEVICE))[None].expand(b, l)
    for kv_bits in (None, 8):
        cache = vl._alloc_cache(b, SLOTS, cfg, bf, DEVICE, kv_bits)
        vl._llama_attention(layer["attn"], x0, pos0, cfg, cache, 0)
        one, _ = vl._llama_attention(layer["attn"], x1, pos[:, :1], cfg, _clone([cache])[0], cp)
        many, _ = vl._llama_attention(layer["attn"], x, pos, cfg, _clone([cache])[0], cp)
        rows[f"attention_{'kv8' if kv_bits else 'bf16'}_cache"] = _same_rows(one, many[:, :1])
        del cache
    for kv_bits in (None, 8):
        for slack in (16, 0):
            with _Slack(slack):
                caches = [vl._alloc_cache(b, CONTEXT + l + slack, cfg, bf, DEVICE, kv_bits,
                                          vl._kv_heads(lang[f"layer{i}"], cfg))
                          for i in range(cfg.layers)]
                ids0 = torch.randint(0, cfg.vocab, (b, CONTEXT), generator=gen, device=DEVICE)
                vl.llama_forward(lang, lang["embed_tokens"][ids0], pos0, cfg, caches, 0)
                emb = lang["embed_tokens"][torch.randint(0, cfg.vocab, (b, l), generator=gen,
                                                         device=DEVICE)]
                many = vl.llama_forward(lang, emb, pos, cfg, _clone(caches), cp)[0]
                steps, worst = _clone(caches), {"equal": True, "max_abs_diff": 0.0}
                for j in range(l):
                    one = vl.llama_forward(lang, emb[:, j:j + 1].contiguous(), pos[:, j:j + 1],
                                           cfg, steps, cp + j)[0]
                    r = _same_rows(one, many[:, j:j + 1])
                    worst = {"equal": worst["equal"] and r["equal"],
                             "max_abs_diff": max(worst["max_abs_diff"], r["max_abs_diff"]),
                             "max_abs": r["max_abs"]}
                worst["rel"] = worst["max_abs_diff"] / worst["max_abs"]
                rows[f"forward_{'kv8' if kv_bits else 'bf16'}_cache_slack{slack}"] = worst
                del caches, steps
    torch.cuda.empty_cache()
    emit({"part": "ops", "weight_bits": bits, "rows": b, "verify_rows": l,
          "cache_slots": SLOTS, "ops": rows})


def _block(vlm, images, draft):
    """One text block, its prefill timed apart → row."""
    import chip_smoke as cs
    import torch

    from mars_tpu_torch.models import vip_llava as vl

    vlm.draft_tokens = draft
    vlm._batch_prefix_cache.clear()
    real, prefill_ms = vl.prefill_prefix, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    for k in vl.STATS:
        vl.STATS[k] = 0
    vl.prefill_prefix = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs._text_block(vlm, images)
        torch.cuda.synchronize()
        block_ms = (time.perf_counter() - t0) * 1e3
    finally:
        vl.prefill_prefix = real
    fw = vl.STATS["forwards"]
    return {"draft_tokens": draft, "block_ms": block_ms, "prefill_ms": sum(prefill_ms),
            "forwards": fw, "verify_rounds": vl.STATS["verify_rounds"],
            "decode_ms_per_step": (block_ms - sum(prefill_ms)) / max(fw - 1, 1)}


def blocks(with_ops, with_blocks):
    import numpy as np
    import torch

    import chip_smoke as cs
    from mars_tpu_torch.models import zoo
    from mars_tpu_torch.text.retriever import TorchVipLlava

    rs = np.random.RandomState(3)
    images = [(rs.rand(336, 336, 3) * 255).astype(np.uint8) for _ in range(cs.TEXT_ROWS)]
    done_ops = set()
    for label, bits, kv_bits in cs.TEXT_INT8_BLOCKS:
        params, cfg = zoo.build_vip_llava(0, bits, "affine")
        if with_ops and bits not in done_ops:
            done_ops.add(bits)
            ops(params, cfg, bits)
        if not with_blocks:
            continue
        vlm = TorchVipLlava(params=params, cfg=cfg, processor=cs.StandInProcessor(cfg),
                            kv_bits=kv_bits)
        del params
        calls = cs._recorded_batches(vlm)
        seen = set()
        for form in ("padded", "unpadded", "unpadded", "padded"):
            with _Slack(16 if form == "padded" else 0):
                for draft in (DRAFT, 0):
                    calls.clear()
                    row = {"part": "blocks", "block": label, "form": form, **_block(
                        vlm, images, draft)}
                    if draft and form not in seen:
                        seen.add(form)
                        vlm._batch_prefix_cache.clear()
                        row["rows_compared"], row["rows_split"], row["max_split_rel_gap"] = (
                            cs._plain_splits(vlm, list(calls)))
                    vlm.draft_tokens = DRAFT
                    emit(row)
        for seed in (4, 5, 6, 7) if label == "int8" else ():
            rs = np.random.RandomState(seed)
            more = [(rs.rand(336, 336, 3) * 255).astype(np.uint8) for _ in range(cs.TEXT_ROWS)]
            for form in ("padded", "unpadded"):
                with _Slack(16 if form == "padded" else 0):
                    calls.clear()
                    row = {"part": "blocks", "block": label, "form": form, "image_seed": seed,
                           **_block(vlm, more, DRAFT)}
                    vlm._batch_prefix_cache.clear()
                    row["rows_compared"], row["rows_split"], row["max_split_rel_gap"] = (
                        cs._plain_splits(vlm, list(calls)))
                    vlm.draft_tokens = DRAFT
                    emit(row)
        del vlm, calls
        gc.collect()
        torch.cuda.empty_cache()


def main():
    import chip_smoke as cs
    from mars_tpu_torch import device as device_lib

    parts = sys.argv[1:] or ["ops", "blocks", "phase"]
    device_lib.resolve("cuda")
    print(cs.nvidia_smi(), flush=True)
    cs.phase_build({})
    if "phase" in parts:
        state, failed = {}, None
        t0 = time.perf_counter()
        try:
            cs.phase_text_int8(state)
        except AssertionError as e:  # reported; the other parts still run
            failed = str(e)
        finally:
            cs._release_text_files(state)
            emit({"part": "phase", "seconds": time.perf_counter() - t0, "failed": failed})
    if "blocks" in parts or "ops" in parts:
        blocks("ops" in parts, "blocks" in parts)


if __name__ == "__main__":
    main()
