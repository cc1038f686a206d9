"""Weight-only quantization of dense kernels (port of
``mars_tpu/models/quantization.py``).

Quantized leaves replace a dense ``kernel`` with a dict, which
``layers.dense`` hands to ``quantized_dense``:

  - int8:  {"q": int8 (IN, OUT), "scale": float32 (OUT,)};
  - int4:  {"q4": hybrid-packed int8 (IN/2, OUT), "scale": float32 (OUT,)}
    (``ops.int4_matmul.pack_int4``);
  - NF4:   {"nf4": packed codebook indices int8 (IN/2, OUT),
    "bscale": float32 (IN/64, OUT)}, the bitsandbytes NormalFloat-4 layout
    behind the reference's ``--vlm4bit``.

The int4 and NF4 products go through ``ops.int4_matmul`` (the hand-written
kernels on a CUDA tensor); int8 is a float32 product of the int8 values
with the scale after it.  An int8 leaf that also carries ``act8``
(``quantize_params(act_bits=8)``, W8A8) quantizes the activations per row
on the fly and multiplies int8 by int8 into int32, exactly: ``torch._int_mm``
(cuBLASLt) on the card, an int32 matmul on the CPU; as in the JAX package,
where XLA computes that product outside any Pallas kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from mars_tpu_torch.ops import int4_matmul

# The 16-entry NormalFloat-4 codebook (QLoRA, Dettmers et al. 2023) as
# published in bitsandbytes: quantiles of N(0, 1) scaled to [-1, 1];
# index 7 is an exact zero.
NF4_CODE = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], np.float32)
# bitsandbytes rounds by binary search against the interval midpoints
_NF4_MID = (NF4_CODE[1:] + NF4_CODE[:-1]) / 2.0

NF4_BLOCK = 64  # bitsandbytes' default block size for NF4


def quantize_kernel_nf4(w: torch.Tensor, block: int = NF4_BLOCK) -> dict:
    """(IN, OUT) kernel → {"nf4": packed codes, "bscale": float32}: absmax
    per block of 64 input rows of each output column, nearest codebook
    entry by midpoint search, two codes per byte (even row = low nibble)."""
    d_in, d_out = w.shape
    if d_in % block or d_in % 2:
        raise ValueError(f"input dim {d_in} must be a multiple of {block}")
    wf = w.float().reshape(d_in // block, block, d_out)
    bscale = wf.abs().amax(dim=1)                           # (IN/block, OUT)
    xn = wf / bscale.clamp_min(1e-12)[:, None, :]
    mid = torch.from_numpy(_NF4_MID).to(w.device)
    codes = torch.searchsorted(mid, xn.reshape(d_in, d_out).contiguous())
    lo, hi = codes[0::2], codes[1::2]
    packed = ((lo | (hi << 4)) & 0xFF).to(torch.uint8).view(torch.int8)  # bit pattern
    return {"nf4": packed, "bscale": bscale}


def dequantize_nf4(p: dict, dtype=torch.float32) -> torch.Tensor:
    """NF4 leaf → dense (IN, OUT): codebook value × block scale, computed in
    float32 and rounded to ``dtype``."""
    packed = p["nf4"].to(torch.int32) & 0xFF
    lo, hi = packed & 0xF, (packed >> 4) & 0xF
    n2, d_out = p["nf4"].shape
    codes = torch.stack([lo, hi], dim=1).reshape(n2 * 2, d_out)
    vals = torch.from_numpy(NF4_CODE).to(packed.device)[codes.long()]
    block = (n2 * 2) // p["bscale"].shape[0]
    scale = p["bscale"].float().repeat_interleave(block, dim=0)
    return (vals * scale).to(dtype)


def quantize_kernel(w: torch.Tensor, bits: int = 8) -> dict:
    """(IN, OUT) kernel → per-output-channel affine leaf: bits=8 gives
    {"q": int8, "scale"}, bits=4 {"q4": hybrid-packed int8 (IN/2, OUT),
    "scale"}.  ``torch.round`` is half-to-even, as ``jnp.round``."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    maxq = 127.0 if bits == 8 else 7.0
    # XLA folds the JAX package's ``absmax / maxq`` into a product with the
    # float32 reciprocal; the same product keeps the scales bit-equal
    scale = w.abs().amax(dim=0) * (1.0 / maxq)
    q = torch.round(w / scale.clamp_min(1e-12)[None, :])
    q = q.clamp(-maxq, maxq).to(torch.int8)
    if bits == 4:
        return {"q4": int4_matmul.pack_int4(q), "scale": scale.float()}
    return {"q": q, "scale": scale.float()}


def dequantize_kernel(p: dict) -> torch.Tensor:
    if "nf4" in p:
        return dequantize_nf4(p)
    if "q4" in p:
        return int4_matmul.unpack_int4(p["q4"]).float() * p["scale"][None, :]
    return p["q"].float() * p["scale"][None, :]


def int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 → (M, N) int32, exact.  On the card
    ``torch._int_mm``, whose shape rules (M > 16, K and N multiples of 8)
    are checked here: a shape that breaks them raises."""
    (m, kd), n = xq.shape, q.shape[1]
    if xq.is_cuda:
        if m <= 16 or kd % 8 or n % 8:
            raise ValueError(f"torch._int_mm needs M > 16 and K, N multiples of 8: "
                             f"{m} x {kd} @ {kd} x {n}")
        # cuBLASLt's int8 GEMM wants B column-major, the layout
        # ``quantize_params(act_bits=8)`` stores the codes in
        return torch._int_mm(xq.contiguous(), q)
    return torch.matmul(xq.to(torch.int32), q.to(torch.int32))


def w8a8_dense(k: dict, x2: torch.Tensor) -> torch.Tensor:
    """(M, IN) floating x @ an ``act8`` int8 leaf: per-row absmax scale
    max(|x|, 1e-8) / 127, round half to even, clip to ±127, the exact int32
    product, then (y · sx · scale) in x's type (the JAX package's
    ``quantized_dense``)."""
    xf = x2.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return (int8_product(xq, k["q"]).float() * sx * k["scale"]).to(x2.dtype)


def quantized_dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., IN) @ W for a quantized kernel, plus the bias; the result in
    x's type.  One int4 or NF4 call is one kernel launch on the card."""
    k = p["kernel"]
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if "act8" in k and x.is_floating_point():
        y = w8a8_dense(k, x2)
    elif "nf4" in k:
        y = int4_matmul.matmul_nf4(x2.contiguous(), k["nf4"], k["bscale"])
    elif "q4" in k:
        y = int4_matmul.matmul_int4(x2.contiguous(), k["q4"], k["scale"])
    else:
        y = (torch.matmul(x2.float(), k["q"].float()) * k["scale"]).to(x.dtype)
    y = y.reshape(shape[:-1] + (y.shape[-1],))
    if "bias" in p:
        y = y + p["bias"]
    return y


def quantize_params(params, bits: int = 8, min_size: int = 1 << 14,
                    act_bits: int = None, int4_format: str = "affine"):
    """Quantize every 2-D floating ``kernel`` with at least ``min_size``
    elements; ``lm_head`` (not named ``kernel``), biases, norms and
    embeddings stay floating.  ``act_bits=8`` (with bits=8) marks the
    kernels ``act8``: dynamic int8 activations too (W8A8,
    ``quantized_dense``).  ``int4_format`` (bits=4): "affine" = hybrid
    int4, "nf4" = the bitsandbytes codebook; a kernel whose input dim is no
    multiple of 64 falls back to affine int4."""
    if int4_format not in ("affine", "nf4"):
        raise ValueError(f"int4_format must be affine or nf4, got {int4_format}")

    def q(name, leaf):
        if isinstance(leaf, dict):
            return {k: q(k, v) for k, v in leaf.items()}
        if (name == "kernel" and isinstance(leaf, torch.Tensor) and leaf.dim() == 2
                and leaf.is_floating_point() and leaf.numel() >= min_size):
            if bits == 4 and int4_format == "nf4" and leaf.shape[0] % NF4_BLOCK == 0:
                return quantize_kernel_nf4(leaf)
            out = quantize_kernel(leaf, bits)
            if act_bits == 8 and bits == 8:
                # the codes column-major once, as ``int8_product`` passes them
                out["q"] = out["q"].t().contiguous().t()
                out["act8"] = torch.ones((), dtype=torch.int8, device=leaf.device)  # marker
            return out
        return leaf

    return q("", params)
