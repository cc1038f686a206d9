"""The port's 4-bit packing, quantization and plain matmuls against the JAX
package (``mars_tpu/ops/int4_matmul.py``, ``mars_tpu/models/quantization.py``):
same seeded numpy inputs through both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mars_tpu.models import quantization as JQ
from mars_tpu.ops import int4_matmul as jim
from mars_tpu_torch.models import convert
from mars_tpu_torch.models import quantization as TQ
from mars_tpu_torch.ops import int4_matmul as tim


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _weights(seed, din, dout, gamma=False):
    rng = np.random.RandomState(seed)
    w = rng.randn(din, dout)
    if gamma:  # per-column spread, as tests/test_ops.py's NF4 cases
        w = w * rng.gamma(1.0, 1.0, (1, dout))
    return w.astype(np.float32), rng


@pytest.mark.parametrize("din,dout", [(128, 96), (300, 200), (512, 256)])
def test_pack_and_quantize_bit_equal(din, dout):
    w, _ = _weights(0, din, dout)
    for bits in (4, 8):
        want = JQ.quantize_kernel(jnp.asarray(w), bits)
        got = TQ.quantize_kernel(torch.from_numpy(w), bits)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == {"q": torch.int8, "q4": torch.int8, "scale": torch.float32}[k]
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=f"{bits} {k}")
    q = np.random.RandomState(1).randint(-7, 8, (din, dout)).astype(np.int8)
    np.testing.assert_array_equal(_np(tim.pack_int4(torch.from_numpy(q))),
                                  np.asarray(jim.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(_np(tim.unpack_int4(tim.pack_int4(torch.from_numpy(q)))), q)


@pytest.mark.parametrize("din,dout", [(128, 96), (320, 200), (512, 256)])
def test_quantize_nf4_bit_equal(din, dout):
    w, _ = _weights(5, din, dout, gamma=True)
    want = JQ.quantize_kernel_nf4(jnp.asarray(w))
    got = TQ.quantize_kernel_nf4(torch.from_numpy(w))
    assert got["nf4"].dtype == torch.int8 and got["bscale"].dtype == torch.float32
    for k in ("nf4", "bscale"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(_np(TQ.dequantize_nf4(got)), np.asarray(JQ.dequantize_nf4(want)))
    np.testing.assert_array_equal(_np(TQ.dequantize_kernel(got)),
                                  np.asarray(JQ.dequantize_kernel(want)))


# tests/test_ops.py's shapes: (rows, IN, OUT); the last of each pads in JAX
@pytest.mark.parametrize("fmt,shape", [("int4", (1, 512, 256)), ("int4", (3, 256, 512)),
                                       ("int4", (2, 300, 200)), ("nf4", (1, 512, 256)),
                                       ("nf4", (3, 256, 512)), ("nf4", (2, 320, 200))])
def test_plain_matches_jax_interpret(fmt, shape):
    b, din, dout = shape
    w, rng = _weights(0 if fmt == "int4" else 5, din, dout, gamma=fmt == "nf4")
    x = rng.randn(b, din).astype(np.float32)
    if fmt == "int4":
        leaf = JQ.quantize_kernel(jnp.asarray(w), 4)
        want = jim.matmul_int4(jnp.asarray(x), leaf["q4"], leaf["scale"], interpret=True)
        got = tim.matmul_int4(torch.from_numpy(x), *(torch.from_numpy(np.array(leaf[k]))
                                                     for k in ("q4", "scale")))
    else:
        leaf = JQ.quantize_kernel_nf4(jnp.asarray(w))
        want = jim.matmul_nf4(jnp.asarray(x), leaf["nf4"], leaf["bscale"], interpret=True)
        got = tim.matmul_nf4(torch.from_numpy(x), *(torch.from_numpy(np.array(leaf[k]))
                                                     for k in ("nf4", "bscale")))
    assert got.dtype == torch.float32 and got.shape == (b, dout)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_plain_bf16_matches_jax_interpret(fmt):
    """bfloat16 x: JAX's interpret mode computes in float32 (its CPU dots
    take no bf16), the port rounds the NF4 weight to bf16 and the output to
    bf16: within tests/test_ops.py's bf16 tolerance."""
    w, rng = _weights(6, 256, 256)
    x = rng.randn(2, 256).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    if fmt == "int4":
        leaf = JQ.quantize_kernel(jnp.asarray(w), 4)
        want = jim.matmul_int4(xj, leaf["q4"], leaf["scale"], interpret=True)
        got = tim.matmul_int4(xt, torch.from_numpy(np.array(leaf["q4"])),
                              torch.from_numpy(np.array(leaf["scale"])))
    else:
        leaf = JQ.quantize_kernel_nf4(jnp.asarray(w))
        want = jim.matmul_nf4(xj, leaf["nf4"], leaf["bscale"], interpret=True)
        got = tim.matmul_nf4(xt, torch.from_numpy(np.array(leaf["nf4"])),
                             torch.from_numpy(np.array(leaf["bscale"])))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=0.15, rtol=2e-2)


def _leaf(fmt, w):
    if fmt == "int8":
        return JQ.quantize_kernel(jnp.asarray(w), 8)
    if fmt == "int4":
        return JQ.quantize_kernel(jnp.asarray(w), 4)
    return JQ.quantize_kernel_nf4(jnp.asarray(w))


@pytest.mark.parametrize("fmt", ["int8", "int4", "nf4"])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_quantized_dense_matches_jax_cpu(fmt, lead):
    """quantized_dense dispatch on each leaf type, with a bias and a 3-D x:
    the port's plain path against JAX's CPU branch, 1e-5 relative in
    float32 (the two differ only in summation order)."""
    w, rng = _weights(7, 256, 192, gamma=fmt == "nf4")
    x = rng.randn(*lead, 256).astype(np.float32)
    bias = rng.randn(192).astype(np.float32)
    jp = {"kernel": _leaf(fmt, w), "bias": jnp.asarray(bias)}
    want = np.asarray(JQ.quantized_dense(jp, jnp.asarray(x)))
    tp = convert.from_jax_params(jp)
    got = _np(TQ.quantized_dense(tp, torch.from_numpy(x)))
    assert got.shape == lead + (192,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    w, rng = _weights(8, 128, 64)
    leaf = TQ.quantize_kernel(torch.from_numpy(w), 4)
    x = torch.from_numpy(rng.randn(4, 128).astype(np.float32))
    before = tim.matmul_int4.launches, tim.matmul_nf4.launches
    y = tim.matmul_int4(x, leaf["q4"], leaf["scale"])
    nf = TQ.quantize_kernel_nf4(torch.from_numpy(w))
    y2 = tim.matmul_nf4(x, nf["nf4"], nf["bscale"])
    assert (tim.matmul_int4.launches, tim.matmul_nf4.launches) == before
    torch.testing.assert_close(y, tim.matmul_int4_plain(x, leaf["q4"], leaf["scale"]),
                               rtol=0, atol=0)
    torch.testing.assert_close(y2, tim.matmul_nf4_plain(x, nf["nf4"], nf["bscale"]),
                               rtol=0, atol=0)


def test_quantize_params_tree_and_conversion():
    """Same leaf kinds as JAX's quantize_params (min size, NF4 with the
    affine fallback for input dims that are no multiple of 64, lm_head and
    norms floating); from_jax_params keeps codes int8 and scales float32
    under a bfloat16 cast."""
    rng = np.random.RandomState(9)
    tree = {"a": {"kernel": rng.randn(128, 64).astype(np.float32),
                  "bias": rng.randn(64).astype(np.float32)},
            "b": {"kernel": rng.randn(96, 256).astype(np.float32)},
            "small": {"kernel": rng.randn(8, 8).astype(np.float32)},
            "ln": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)},
            "lm_head": rng.randn(64, 512).astype(np.float32)}
    jt = {k: ({n: jnp.asarray(a) for n, a in v.items()} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in tree.items()}
    tt = convert.from_jax_params(tree)
    for bits, fmt in ((8, "affine"), (4, "affine"), (4, "nf4")):
        want = JQ.quantize_params(jt, bits=bits, min_size=1024, int4_format=fmt)
        got = TQ.quantize_params(tt, bits=bits, min_size=1024, int4_format=fmt)
        for name in ("a", "b"):
            assert set(got[name]["kernel"]) == set(want[name]["kernel"]), (bits, fmt, name)
            for k, v in want[name]["kernel"].items():
                np.testing.assert_array_equal(_np(got[name]["kernel"][k]), np.asarray(v))
        assert isinstance(got["small"]["kernel"], torch.Tensor)
        assert isinstance(got["lm_head"], torch.Tensor)
        bf = convert.from_jax_params(want, dtype=torch.bfloat16)
        for leaf in (bf["a"]["kernel"], bf["b"]["kernel"]):
            for k, v in leaf.items():
                assert v.dtype == (torch.int8 if k in ("q", "q4", "nf4") else torch.float32), k
        assert bf["ln"]["scale"].dtype == torch.bfloat16
        assert bf["a"]["bias"].dtype == torch.bfloat16
