"""Attention with the head-mean probability tap (port of
``mars_tpu/ops/flash_attention.py``: ``attention_with_tap``, ``mha_pallas``).

PIR consumes the mean over heads (and later blocks) of the softmax
attention probabilities.  ``attention_with_tap`` returns it from the same
pass that computes the attention output, so per-head probabilities never
reach device memory.  On a CUDA tensor it launches the hand-written Hopper
kernel ``csrc/attention_tap.cu`` (which replaces the Pallas TPU kernel; its
source note says what bounds it and how it is laid out) or raises; on a CPU
tensor it takes ``attention_with_tap_plain``, the plain PyTorch version the
CPU tests hold against the JAX package.

Layout: q, k, v as (H, L, D) per batch element, as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mars_tpu_torch.ops import build

MAX_HEAD_DIM = 64  # csrc/attention_tap.cu DMAX
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def attention_with_tap_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in plain PyTorch: logits, softmax and tap in
    float32; probabilities rounded to the input type before P.V."""
    h, _, d = q.shape
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)
    return out, (probs * (1.0 / h)).sum(dim=0)


def _library() -> ctypes.CDLL:
    lib = build.load("attention_tap")
    for fn in (lib.mars_attention_tap_f32, lib.mars_attention_tap_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def attention_with_tap(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: (H, L, D) → (out (H, L, D) in the input type,
    attn_mean (L, L) float32).

    out = softmax(q kᵀ / √D) v per head; attn_mean = head-mean probs.
    ``attention_with_tap.launches`` counts the kernel's launches.
    """
    if not q.is_cuda:
        return attention_with_tap_plain(q, k, v)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (H, L, D) shape: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must all be float32 or bfloat16: {q.dtype} {k.dtype} {v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    h, l, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    lib = _library()
    fn = lib.mars_attention_tap_f32 if q.dtype == torch.float32 else lib.mars_attention_tap_bf16
    out = torch.empty_like(q)
    tap = torch.empty((l, l), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tap.data_ptr(),
             h, l, d, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_tap kernel launch failed with CUDA error {err}")
    attention_with_tap.launches += 1
    return out, tap


attention_with_tap.launches = 0


def mha_tap(qkv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L, 3, H, hd) packed qkv → (out (B, L, H*hd), attn_mean (B, L, L)),
    one ``attention_with_tap`` per batch element."""
    b, l, _, nh, hd = qkv.shape
    outs, attns = [], []
    for i in range(b):
        q, k, v = (qkv[i, :, j].transpose(0, 1).contiguous() for j in range(3))
        out, attn = attention_with_tap(q, k, v)
        outs.append(out)
        attns.append(attn)
    out = torch.stack(outs).transpose(1, 2).reshape(b, l, nh * hd)
    return out, torch.stack(attns)
