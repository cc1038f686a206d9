"""SAM's grid attention with the decomposed relative-position bias, global
and windowed (port of ``mars_tpu/ops/sam_attention.py``:
``grid_attention_pallas``, ``windowed_attention_pallas``).

The SAM image encoder's global layers attend over the whole token grid
(4096 tokens at ViT-H @1024) with the bias
``B[q, k] = bias_h[q, k // W] + bias_w[q, k % W]`` added to the scaled
logits.  On a CUDA tensor ``grid_attention`` launches the hand-written
Hopper kernel ``csrc/sam_grid_attention.cu`` (flash-style online softmax;
its source note says what bounds it) or raises; on a CPU tensor it takes
``grid_attention_plain``, the plain PyTorch version the CPU tests hold
against the JAX package.

The windowed layers' ``windowed_attention`` (taken by ``sam.encode_image``
when ``MARS_SAM_WINDOWED_IMPL=pallas``) launches the hand-written kernel
``csrc/sam_windowed_attention.cu`` on a CUDA tensor, all window-heads in
one launch, or raises; on a CPU tensor it takes
``windowed_attention_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mars_tpu_torch.ops import build

MAX_HEAD_DIM = 128  # csrc/sam_grid_attention.cu DMAX
WINDOWED_MAX_HEAD_DIM = 128  # csrc/sam_windowed_attention.cu DMAX
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def grid_attention_plain(q, k, v, bias_h, bias_w, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """The kernel's contract in plain PyTorch: float32 logits
    ``(q kᵀ)·d^-0.5 + bias_h[q, k // W] + bias_w[q, k % W]`` and softmax,
    probabilities rounded to v's type before P.V."""
    _, l, d = q.shape
    h, w = grid_hw
    cols = torch.arange(l, device=q.device)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    logits = logits + bias_h.float()[:, :, cols // w] + bias_w.float()[:, :, cols % w]
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def _check_inputs(tensors, max_head_dim: int) -> None:
    """Type, device, layout and head-dim checks shared by both wrappers."""
    q = tensors[0]
    if len({t.dtype for t in tensors}) != 1 or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"inputs must all be float32 or bfloat16: {[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if q.shape[-1] > max_head_dim:
        raise ValueError(f"head dim {q.shape[-1]} > {max_head_dim}")


def _library() -> ctypes.CDLL:
    return build.load("sam_grid_attention", {"mars_grid_attention_f32": _ARGTYPES,
                                             "mars_grid_attention_bf16": _ARGTYPES})


def grid_attention(q, k, v, bias_h, bias_w, grid_hw: Tuple[int, int]) -> torch.Tensor:
    """q, k, v: (heads, L, hd), q unscaled; bias_h (heads, L, H) and bias_w
    (heads, L, W) in the same type; ``grid_hw`` = (H, W) with H·W = L.
    Returns (heads, L, hd) in the input type.
    ``grid_attention.launches`` counts the kernel's launches."""
    if not q.is_cuda:
        return grid_attention_plain(q, k, v, bias_h, bias_w, grid_hw)
    nh, l, d = q.shape
    h, w = grid_hw
    if h * w != l or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (heads, H*W, hd) shape: {q.shape} "
                         f"{k.shape} {v.shape}, grid {grid_hw}")
    if bias_h.shape != (nh, l, h) or bias_w.shape != (nh, l, w):
        raise ValueError(f"bias shapes {bias_h.shape} {bias_w.shape} != "
                         f"{(nh, l, h)} {(nh, l, w)}")
    _check_inputs((q, k, v, bias_h, bias_w), MAX_HEAD_DIM)
    lib = _library()
    fn = lib.mars_grid_attention_f32 if q.dtype == torch.float32 else lib.mars_grid_attention_bf16
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
             out.data_ptr(), nh, l, d, h, w, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sam_grid_attention kernel launch failed with CUDA error {err} "
                           f"(shape {tuple(q.shape)}, grid {grid_hw})")
    grid_attention.launches += 1
    return out


grid_attention.launches = 0


def windowed_attention_plain(q, k, v, bias_h, bias_w, window_hw: Tuple[int, int]
                             ) -> torch.Tensor:
    """The windowed kernel's contract in plain PyTorch: ``grid_attention_plain``
    over every window-head of the (B, nh) batch; no key is masked."""
    b, nh, l, d = q.shape
    h, w = window_hw
    flat = (t.reshape(b * nh, l, -1) for t in (q, k, v, bias_h, bias_w))
    return grid_attention_plain(*flat, (h, w)).reshape(b, nh, l, d)


def _windowed_library() -> ctypes.CDLL:
    return build.load("sam_windowed_attention", {"mars_windowed_attention_f32": _ARGTYPES,
                                                 "mars_windowed_attention_bf16": _ARGTYPES})


def windowed_attention(q, k, v, bias_h, bias_w, window_hw: Tuple[int, int]) -> torch.Tensor:
    """q, k, v: (B, nh, L, hd) with B = batch · windows and L = Hw·Ww, q
    unscaled; bias_h (B, nh, L, Hw) and bias_w (B, nh, L, Ww) in the same
    type.  Returns (B, nh, L, hd) in the input type, one launch for every
    window-head.  ``windowed_attention.launches`` counts the kernel's
    launches."""
    if not q.is_cuda:
        return windowed_attention_plain(q, k, v, bias_h, bias_w, window_hw)
    b, nh, l, d = q.shape
    h, w = window_hw
    if h * w != l or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, heads, Hw*Ww, hd) shape: {q.shape} "
                         f"{k.shape} {v.shape}, window {window_hw}")
    if bias_h.shape != (b, nh, l, h) or bias_w.shape != (b, nh, l, w):
        raise ValueError(f"bias shapes {bias_h.shape} {bias_w.shape} != "
                         f"{(b, nh, l, h)} {(b, nh, l, w)}")
    _check_inputs((q, k, v, bias_h, bias_w), WINDOWED_MAX_HEAD_DIM)
    lib = _windowed_library()
    fn = (lib.mars_windowed_attention_f32 if q.dtype == torch.float32
          else lib.mars_windowed_attention_bf16)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
             out.data_ptr(), b * nh, l, d, h, w, d ** -0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sam_windowed_attention kernel launch failed with CUDA error {err} "
                           f"(shape {tuple(q.shape)}, window {window_hw})")
    windowed_attention.launches += 1
    return out


windowed_attention.launches = 0
