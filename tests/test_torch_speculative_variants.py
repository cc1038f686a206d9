"""Prompt-lookup speculative decoding in the port with quantized weights
(int4 and NF4, the kernels' plain versions on the CPU; int8, the CLI's
default) and with the int8 KV cache, alone and under 8-bit and int4
weights, against the JAX package's ``generate_greedy`` in float32: token
streams equal to JAX's and to the port's own plain (``draft_tokens=0``)
streams.  The fixtures and helpers are ``test_torch_speculative.py``'s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import quantization as JQ
from mars_tpu.models import vip_llava as jvl
from mars_tpu_torch.models import convert, quantization as TQ, vip_llava as tvl
from mars_tpu_torch.text.retriever import TorchVipLlava
from test_torch_speculative import SPEC, _jax, _port, model  # noqa: F401  (fixture)


@pytest.mark.parametrize("bits,fmt,kv_bits", [
    pytest.param(4, "affine", None, id="affine"), pytest.param(4, "nf4", None, id="nf4"),
    pytest.param(8, "affine", None, id="int8"), pytest.param(8, "affine", 8, id="int8-kv8"),
    pytest.param(4, "affine", 8, id="int4-kv8")])
def test_quantized_weights_equal_jax(bits, fmt, kv_bits):
    """int4 and NF4 weights (the kernels' plain versions on the CPU) and
    8-bit ones (what ``cli.main`` builds without a bit flag), with the int8
    KV cache as ``--vlm-kv8`` adds it, dims that are multiples of 64 so
    every dense kernel quantizes."""
    cfg = tvl.VipLlavaConfig(
        v_hidden=64, v_intermediate=128, v_layers=2, v_heads=2, image_size=56, patch_size=14,
        vision_feature_layers=(-1, -2), hidden=128, intermediate=256, layers=2, heads=4,
        kv_heads=2, vocab=160, image_token_index=150)
    jcfg = jvl.VipLlavaConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    tp32 = tvl.init_random_params(3, cfg, dtype=torch.float32, device="cpu")
    jp = JQ.quantize_params(_jax_tree(tp32), bits=bits, min_size=64, int4_format=fmt)
    tp = convert.from_jax_params(jp)
    g = (cfg.image_size // cfg.patch_size) ** 2
    ids = np.full((2, 8 + g), 5, np.int64)
    ids[:, 2:2 + g] = cfg.image_token_index
    ids[0, 2 + g:] = [20, 21, 22, 20, 21, 22]
    ids[1, 2 + g:] = [30, 31, 30, 31, 30, 31]
    pix = np.random.RandomState(1).rand(2, 56, 56, 3).astype(np.float32)
    kw = dict(max_new_tokens=10, draft_gate=2, kv_bits=kv_bits, **SPEC)
    got = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), cfg, **kw)
    plain = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), cfg,
                                max_new_tokens=10, kv_bits=kv_bits)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), _jax(jp, ids, pix, cfg=jcfg, **kw))


@pytest.mark.parametrize("bits,kv_bits", [
    pytest.param(None, None, id="bf16"), pytest.param(8, None, id="int8"),
    pytest.param(8, 8, id="int8-kv8")])
def test_cached_forward_rows_equal_in_any_call(bits, kv_bits):
    """A token's logits are the same bits whether it comes in a plain
    decode step (one row a sequence) or in a speculative verify forward
    (K + 1 rows), both over a buffer of ``VERIFY_SLACK`` slots past the
    decode: each forward runs at ``VERIFY_SLACK`` rows (weights of 8 or 16
    bits).  The CPU's products may not depend on the row count at these
    sizes; the card test of this name in ``test_torch_cuda.py`` is the one
    that needs the padding."""
    cfg = tvl.VipLlavaConfig(
        v_hidden=64, v_intermediate=128, v_layers=1, v_heads=2, image_size=28, patch_size=14,
        vision_feature_layers=(-1,), hidden=128, intermediate=256, layers=2, heads=4,
        kv_heads=2, vocab=160, image_token_index=150)
    tp = tvl.init_random_params(3, cfg, dtype=torch.float32, device="cpu")
    if bits:
        tp = TQ.quantize_params(tp, bits=bits, min_size=64)
    lang, b, ctx, k = tp["language"], 2, 12, 8
    ids = torch.from_numpy(np.random.RandomState(kv_bits or 1).randint(0, cfg.vocab,
                                                                       (b, ctx + k + 1)))
    pos = torch.arange(ctx + k + 1)[None].expand(b, -1)
    caches = [tvl._alloc_cache(b, ctx + k + 1 + tvl.VERIFY_SLACK, cfg, torch.float32, "cpu",
                               kv_bits) for _ in range(cfg.layers)]
    tvl.llama_forward(lang, lang["embed_tokens"][ids[:, :ctx]], pos[:, :ctx], cfg, caches, 0)
    clone = lambda: [tuple(t.clone() for t in c) for c in caches]  # noqa: E731
    verify, _ = tvl.llama_forward(lang, lang["embed_tokens"][ids[:, ctx:]], pos[:, ctx:], cfg,
                                  clone(), torch.full((b,), ctx))
    plain = clone()
    for j in range(k + 1):
        step, _ = tvl.llama_forward(lang, lang["embed_tokens"][ids[:, ctx + j:ctx + j + 1]],
                                    pos[:, ctx + j:ctx + j + 1], cfg, plain, ctx + j)
        assert torch.equal(step[:, 0], verify[:, j])


@pytest.mark.parametrize("draft", [0, 4, 8, 16])
def test_buffer_length_does_not_depend_on_speculation(model, draft):
    """A decode's KV buffer, and the retriever's in-place one, hold the same
    slots whether they speculate or not (any K < ``VERIFY_SLACK``):
    attention sums over the whole buffer, so a plain decode then sums as a
    speculative one does.  A longer draft gets the slots its verify writes,
    and the retriever warns."""
    _, tp, ids, pix, _, _ = model
    _, caches = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), tvl.TINY,
                                    max_new_tokens=6, draft_tokens=draft, return_caches=True)
    slack = 17 if draft == 16 else tvl.VERIFY_SLACK
    assert caches[0][0].shape[1] == ids.shape[1] + 6 + slack
    if draft < tvl.VERIFY_SLACK:
        vlm = TorchVipLlava(params=tp, cfg=tvl.TINY, processor=object(), draft_tokens=draft)
    else:
        with pytest.warns(UserWarning, match="draft_tokens=16"):
            vlm = TorchVipLlava(params=tp, cfg=tvl.TINY, processor=object(), draft_tokens=draft)
    assert vlm._inplace_buffer_len(19, 128) == 19 + 128 + vlm._INPLACE_BUDGET + slack
    assert vlm._inplace_buffer_len(19, 128) >= vlm._inplace_need(19, 128, vlm._INPLACE_BUDGET)


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("rows", [1, 2])
def test_int8_kv_cache_equals_jax(model, rows):
    """kv_bits=8: the prefill's quantized caches agree with JAX's (float32
    keys summed in other orders: scales to 1e-5 relative, codes within one
    step) and the token streams (plain and speculative) are equal."""
    jp, tp, ids, pix, ids2, pix2 = model
    ids_r, pix_r = (ids, pix) if rows == 1 else (ids2, pix2)
    lp = 19
    kv = tvl.prefill_prefix(tp, torch.from_numpy(ids_r[:, :lp]), torch.from_numpy(pix_r),
                            tvl.TINY, kv_bits=8)
    jkv = jvl.prefill_prefix(jp, jnp.asarray(ids_r[:, :lp]), jnp.asarray(pix_r), jvl.TINY,
                             kv_bits=8)
    assert len(kv[0]) == 4 and kv[0][0].dtype == torch.int8 and kv[0][2].shape[-1] == 1
    for got, want in zip(kv[0][:2], jkv[0][:2]):
        assert np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32)).max() <= 1
    for got, want in zip(kv[0][2:], jkv[0][2:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)
    kw = dict(max_new_tokens=12, kv_bits=8)
    plain = _port(tp, ids_r, pix_r, **kw)
    got = _port(tp, ids_r, pix_r, draft_gate=2, **SPEC, **kw)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, _jax(jp, ids_r, pix_r, draft_gate=2, **SPEC, **kw))
    # a resume from the int8 prefix keeps its format whatever kv_bits says
    resumed = _port(tp, ids_r[:, lp:], None, prefix_kv=kv, prefix_len=lp, max_new_tokens=12)
    np.testing.assert_array_equal(resumed, plain)
