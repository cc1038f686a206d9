"""On-card checks of the port's CUDA kernels against their plain versions.

Marked ``cuda``: they skip without a card.  On a machine with one, run
them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from mars_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(h, l, d, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(h, l, d).astype(np.float32)).to(dev, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("h,l,d", [(3, 200, 32), (2, 300, 16), (16, 1374, 64),
                                   (12, 1090, 64), (1, 17, 64)])
def test_kernel_matches_plain_f32(dev, h, l, d):
    q, k, v = _qkv(h, l, d, torch.float32, dev)
    before = fa.attention_with_tap.launches
    out, tap = fa.attention_with_tap(q, k, v)
    torch.cuda.synchronize()
    assert fa.attention_with_tap.launches == before + 1
    want_out, want_tap = fa.attention_with_tap_plain(q, k, v)
    assert out.dtype == torch.float32 and tap.shape == (l, l)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(tap, want_tap, atol=1e-5, rtol=0)
    torch.testing.assert_close(tap.sum(-1), torch.ones(l, device=dev), atol=1e-5, rtol=0)


@pytest.mark.parametrize("h,l", [(16, 1374), (12, 1090)])
def test_kernel_matches_plain_bf16(dev, h, l):
    q, k, v = _qkv(h, l, 64, torch.bfloat16, dev)
    out, tap = fa.attention_with_tap(q, k, v)
    want_out, want_tap = fa.attention_with_tap_plain(q, k, v)
    assert out.dtype == torch.bfloat16
    # out: one bf16 rounding of values |x| < 4 (2^-7 relative) can differ
    torch.testing.assert_close(out.float(), want_out.float(), atol=3e-2, rtol=0)
    torch.testing.assert_close(tap, want_tap, atol=1e-5, rtol=0)


def test_kernel_is_deterministic(dev):
    q, k, v = _qkv(16, 1374, 64, torch.float32, dev, seed=3)
    out1, tap1 = fa.attention_with_tap(q, k, v)
    out2, tap2 = fa.attention_with_tap(q, k, v)
    assert torch.equal(out1, out2) and torch.equal(tap1, tap2)


def test_kernel_rejects_what_it_does_not_take(dev):
    q, k, v = _qkv(2, 64, 128, torch.float32, dev)
    with pytest.raises(ValueError):
        fa.attention_with_tap(q, k, v)
    q, k, v = _qkv(2, 64, 64, torch.float16, dev)
    with pytest.raises(TypeError):
        fa.attention_with_tap(q, k, v)
