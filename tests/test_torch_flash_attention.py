"""The tap kernel's plain version against the Pallas kernel (interpret
mode), and the wrapper's CPU route.

The float32 kernels (``csrc/attention_tap.cu``: ``tap_out_f32``,
``tap_mean_f32``) compute each product as three TF32 passes of split
operands: ``_tap_f32`` emulates both launches (the sweep of
``torch_tiny.tf32_sweep`` with its log-sum-exp, then exp(s - lse) / H
summed over the heads in order) and holds them to half the card's 1e-5
limit on the output, the tap and the tap's row sums; one TF32 pass and a
lost key tile break the output limit, and one pass the tap limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.ops import flash_attention as jfa
from mars_tpu_torch.ops import flash_attention as tfa
from torch_tiny import tf32_product, tf32_sweep

TAP_TOL = 1e-5  # the float32 kernels' limit on the card (chip_smoke.py, test_torch_cuda.py)


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


def _tap_f32(q, k, v, mode="tf32x3", skip_tile=None):
    """``tap_out_f32`` then ``tap_mean_f32`` on (H, L, D) float32 inputs →
    (out, tap): the sweep's output and log-sum-exp, then each head's
    logits again as the same TF32 passes, exp(s - lse) / H added to the
    tap in head order.  ``mode`` and ``skip_tile`` as in
    ``torch_tiny.tf32_sweep``."""
    h, _, d = q.shape
    out, lse = tf32_sweep(q, k, v, mode, skip_tile)
    tap = torch.zeros(q.shape[1], k.shape[1])
    for i in range(h):
        s = tf32_product(q[i], k[i].T, mode) * d ** -0.5
        tap = tap + torch.exp(s - lse[i, :, None]) * (1 / h)
    return out, tap


def _errors(got, want):
    """max |Δ| of the output, of the tap and of the tap's row sums from 1."""
    (out, tap), (want_out, want_tap) = got, want
    return ((out - want_out).abs().max().item(), (tap - want_tap).abs().max().item(),
            (tap.sum(-1) - 1).abs().max().item())


@pytest.mark.parametrize("h,l,d", [(4, 1374, 64), (3, 577, 64), (2, 200, 32), (1, 17, 64),
                                   (2, 100, 20)])
def test_f32_tile_emulation_within_half_the_limit(h, l, d):
    """The split form, emulated, at DINOv2-L's length, an AlphaCLIP-L one, a
    ragged tile at head dim 32, fewer keys than a tile and head dim 20."""
    q, k, v = map(torch.from_numpy, _qkv(h, l, d, seed=11))
    errs = _errors(_tap_f32(q, k, v), tfa.attention_with_tap_plain(q, k, v))
    assert max(errs) < TAP_TOL / 2, errs


@pytest.mark.parametrize("fault", [dict(mode="tf32"), dict(skip_tile=1)])
def test_f32_card_limit_catches_one_pass_or_a_lost_tile(fault):
    """Each fault breaks the output's limit; one TF32 pass breaks the tap's
    too."""
    q, k, v = map(torch.from_numpy, _qkv(3, 577, 64, seed=12))
    out_err, tap_err, _ = _errors(_tap_f32(q, k, v, **fault), tfa.attention_with_tap_plain(q, k, v))
    assert out_err > TAP_TOL
    if "mode" in fault:
        assert tap_err > TAP_TOL


@pytest.mark.parametrize("h,l,d", [(3, 200, 32), (2, 300, 64)])
def test_f32_tile_emulation_matches_pallas(h, l, d):
    """The split-TF32 emulation against JAX's kernel in float32 (interpret
    mode), within the card's limit."""
    q, k, v = _qkv(h, l, d, seed=13)
    want_out, want_tap = jfa.attention_with_tap(*map(jnp.asarray, (q, k, v)), interpret=True)
    out, tap = _tap_f32(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TAP_TOL, rtol=0)
    np.testing.assert_allclose(tap.numpy(), np.asarray(want_tap), atol=TAP_TOL, rtol=0)
