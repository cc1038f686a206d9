"""Prompt-lookup speculative decoding in the port with quantized weights
(int4 and NF4, the kernels' plain versions on the CPU) and with the int8
KV cache, against the JAX package's ``generate_greedy`` in float32: token
streams equal to JAX's and to the port's own plain (``draft_tokens=0``)
streams.  The fixtures and helpers are ``test_torch_speculative.py``'s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import quantization as JQ
from mars_tpu.models import vip_llava as jvl
from mars_tpu_torch.models import convert, vip_llava as tvl
from test_torch_speculative import SPEC, _jax, _port, model  # noqa: F401  (fixture)


@pytest.mark.parametrize("fmt", ["affine", "nf4"])
def test_quantized_weights_equal_jax(fmt):
    """int4 and NF4 weights (the kernels' plain versions on the CPU), dims
    that are multiples of 64 so every dense kernel quantizes."""
    cfg = tvl.VipLlavaConfig(
        v_hidden=64, v_intermediate=128, v_layers=2, v_heads=2, image_size=56, patch_size=14,
        vision_feature_layers=(-1, -2), hidden=128, intermediate=256, layers=2, heads=4,
        kv_heads=2, vocab=160, image_token_index=150)
    jcfg = jvl.VipLlavaConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    tp32 = tvl.init_random_params(3, cfg, dtype=torch.float32, device="cpu")
    jp = JQ.quantize_params(_jax_tree(tp32), bits=4, min_size=64, int4_format=fmt)
    tp = convert.from_jax_params(jp)
    g = (cfg.image_size // cfg.patch_size) ** 2
    ids = np.full((2, 8 + g), 5, np.int64)
    ids[:, 2:2 + g] = cfg.image_token_index
    ids[0, 2 + g:] = [20, 21, 22, 20, 21, 22]
    ids[1, 2 + g:] = [30, 31, 30, 31, 30, 31]
    pix = np.random.RandomState(1).rand(2, 56, 56, 3).astype(np.float32)
    kw = dict(max_new_tokens=10, draft_gate=2, **SPEC)
    got = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), cfg, **kw)
    plain = tvl.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(pix), cfg,
                                max_new_tokens=10)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), _jax(jp, ids, pix, cfg=jcfg, **kw))


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
