"""Attention with the head-mean probability tap, and without it (port of
``mars_tpu/ops/flash_attention.py``: ``attention_with_tap``, ``mha_pallas``,
``attention_notap``, ``mha_pallas_notap``).

PIR consumes the mean over heads (and later blocks) of the softmax
attention probabilities.  ``attention_with_tap`` returns it without
per-head probabilities ever reaching device memory.  On a CUDA tensor it
runs the hand-written Hopper kernels of ``csrc/attention_tap.cu`` (which
replace the Pallas TPU kernel; the source note says what bounds them and
how they are laid out), two launches per call: ``tap_out`` (grid query
tiles × heads) writes the output and each row's log-sum-exp into a float32
(H, L) scratch, ``tap_mean`` (grid query tiles × key tiles) recomputes the
logits head by head and writes the tap once.  Both types run on the tensor
cores (wgmma): bfloat16 as it is, float32 in split TF32 (three TF32 passes
a product, ``csrc/attention_tf32.cuh``).  Its counter
``attention_with_tap.launches`` counts calls, one per call.  On a CPU
tensor it takes ``attention_with_tap_plain``, the plain PyTorch version the
CPU tests hold against the JAX package.

The untapped blocks' ``attention_notap`` (taken by ``layers.mha`` when
``MARS_ATTENTION_NOTAP_IMPL=pallas``) launches ``csrc/attention_notap.cu``
on a CUDA tensor, once for the whole (B·H) batch, or raises; on a CPU
tensor it takes ``attention_notap_plain``.  The JAX kernel's
``heads_per_step`` (and ``MARS_NOTAP_HEADS_PER_STEP``) only sized Mosaic's
grid steps and has no counterpart here.

Layout: q, k, v as (H, L, D) per batch element for the tap, (B, H, L, D)
for ``attention_notap``, as in the JAX package.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mars_tpu_torch.ops import build

MAX_HEAD_DIM = 64  # csrc/attention_tap.cu DMAX (both types)
NOTAP_MAX_HEAD_DIM = 128  # csrc/attention_notap.cu DMAX
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
_NOTAP_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


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
    return build.load("attention_tap", {"mars_attention_tap_f32": _ARGTYPES,
                                        "mars_attention_tap_bf16": _ARGTYPES})


def attention_with_tap(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: (H, L, D) → (out (H, L, D) in the input type,
    attn_mean (L, L) float32).

    out = softmax(q kᵀ / √D) v per head; attn_mean = head-mean probs.
    On a CUDA tensor: two kernel launches (output and log-sum-exp, then the
    tap); ``attention_with_tap.launches`` counts calls, one per call.
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
    lse = torch.empty((h, l), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tap.data_ptr(),
             lse.data_ptr(), h, l, d, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
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


def attention_notap_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The untapped kernel's contract in plain PyTorch: logits and softmax in
    float32, probabilities rounded to v's type before P.V."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def _notap_library() -> ctypes.CDLL:
    return build.load("attention_notap", {"mars_attention_notap_f32": _NOTAP_ARGTYPES,
                                          "mars_attention_notap_bf16": _NOTAP_ARGTYPES})


def attention_notap(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, H, L, D) → (B, H, L, D) = softmax(q kᵀ / √D) v, in the
    input type, one launch for the whole (B·H) batch.
    ``attention_notap.launches`` counts the kernel's launches."""
    if not q.is_cuda:
        return attention_notap_plain(q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, L, D) shape: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must all be float32 or bfloat16: {q.dtype} {k.dtype} {v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    b, h, l, d = q.shape
    if d > NOTAP_MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {NOTAP_MAX_HEAD_DIM}")
    lib = _notap_library()
    fn = lib.mars_attention_notap_f32 if q.dtype == torch.float32 else lib.mars_attention_notap_bf16
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, l, d, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_notap kernel launch failed with CUDA error {err} "
                           f"(shape {tuple(q.shape)})")
    attention_notap.launches += 1
    return out


attention_notap.launches = 0


def mha_notap(qkv: torch.Tensor) -> torch.Tensor:
    """(B, L, 3, H, hd) packed qkv → out (B, L, H*hd), one
    ``attention_notap`` over the whole batch."""
    b, l, _, nh, hd = qkv.shape
    q, k, v = (qkv[:, :, j].transpose(1, 2).contiguous() for j in range(3))
    return attention_notap(q, k, v).transpose(1, 2).reshape(b, l, nh * hd)
