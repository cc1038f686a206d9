"""The tap kernel's plain version against the Pallas kernel (interpret
mode), and the wrapper's CPU route."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import flash_attention as jfa
from mars_tpu_torch.ops import flash_attention as tfa


def _qkv(h, l, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(h, l, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("h,l,d", [(3, 200, 32), (2, 300, 16)])  # L not a tile multiple
def test_plain_matches_pallas_interpret(h, l, d):
    q, k, v = _qkv(h, l, d, seed=l)
    want_out, want_tap = jfa.attention_with_tap(*map(jnp.asarray, (q, k, v)), interpret=True)
    out, tap = tfa.attention_with_tap_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tap.numpy(), np.asarray(want_tap), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tap.sum(-1).numpy(), 1.0, atol=1e-5)


def test_cpu_tensor_takes_plain_path_without_launching():
    q, k, v = map(torch.from_numpy, _qkv(2, 50, 16, seed=1))
    before = tfa.attention_with_tap.launches
    out, tap = tfa.attention_with_tap(q, k, v)
    want_out, want_tap = tfa.attention_with_tap_plain(q, k, v)
    assert torch.equal(out, want_out) and torch.equal(tap, want_tap)
    assert tfa.attention_with_tap.launches == before


def test_mha_tap_matches_mha_pallas_interpret():
    rng = np.random.RandomState(2)
    qkv = rng.randn(2, 70, 3, 2, 16).astype(np.float32)
    want_out, want_attn = jfa.mha_pallas(jnp.asarray(qkv), 2, interpret=True)
    out, attn = tfa.mha_tap(torch.from_numpy(qkv))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(attn.numpy(), np.asarray(want_attn), atol=1e-5, rtol=0)
