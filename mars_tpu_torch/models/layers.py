"""Shared transformer layers for the frozen towers (port of
``mars_tpu/models/layers.py``).

Models are plain functions over nested parameter dicts with the JAX
package's keys and layouts (dense kernels (in, out), patch-embed kernels
HWIO), so ``models.convert.from_jax_params`` is a tensor conversion.
Layout: batch-first (B, L, D) tokens; images NHWC.

Tapped blocks (``mha(return_attn=True)``) go through
``ops.flash_attention.mha_tap``: the hand-written kernel on a CUDA tensor,
its plain version on a CPU tensor.  Untapped blocks take the plain
einsum/softmax path, as the JAX package's default XLA path does, unless
``MARS_ATTENTION_NOTAP_IMPL=pallas`` (the JAX package's switch, read at each
call) sends them through ``ops.flash_attention.mha_notap``.  Masked blocks
and the Grad-CAM head stay plain.
A dense whose ``kernel`` is a dict is weight-only quantized and goes to
``models.quantization.quantized_dense``.
"""
from __future__ import annotations

import os
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from mars_tpu_torch.core import imaging
from mars_tpu_torch.ops import flash_attention


def quick_gelu(x):
    """CLIP's QuickGELU (reference: clip/model.py:274-276)."""
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x):
    """torch.nn.GELU default (erf formulation), used by DINOv2."""
    return F.gelu(x)


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm in float32 regardless of the input type."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dtype)


def dense(p, x):
    """x @ kernel (+ bias).  Operands of two floating types are promoted
    to the wider one, as ``jnp``'s ``x @ k`` does (a float32 activation
    through a bf16-cast tower's kernel runs in float32)."""
    k = p["kernel"]
    if isinstance(k, dict):  # weight-only quantized (models.quantization)
        from mars_tpu_torch.models.quantization import quantized_dense

        return quantized_dense(p, x)
    if x.dtype != k.dtype:
        dtype = torch.promote_types(x.dtype, k.dtype)
        x, k = x.to(dtype), k.to(dtype)
    y = x @ k
    if "bias" in p:
        y = y + p["bias"]
    return y


def conv_patch_embed(p, images, patch_size: int):
    """(B, H, W, C) → (B, gh*gw, D): a stride-p VALID convolution written
    as one matmul over p*p*C patches (HWIO kernel order)."""
    k = p["kernel"]
    b, h, w, c = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images[:, :gh * patch_size, :gw * patch_size].to(k.dtype)
    x = x.reshape(b, gh, patch_size, gw, patch_size, c).permute(0, 1, 3, 2, 4, 5)
    y = x.reshape(b, gh * gw, patch_size * patch_size * c) @ k.reshape(-1, k.shape[-1])
    if "bias" in p:
        y = y + p["bias"]
    return y


NOTAP_IMPL_ENV = "MARS_ATTENTION_NOTAP_IMPL"


def kernel_switch(env: str) -> bool:
    """One of the JAX package's kernel switches, read at call time: "xla"
    (the default) keeps the plain path, "pallas" takes the kernel; any
    other value raises."""
    impl = os.environ.get(env, "xla")
    if impl not in ("xla", "pallas"):
        raise ValueError(f"{env}={impl!r}: expected 'xla' or 'pallas'")
    return impl == "pallas"


def mha(p, x, num_heads: int, return_attn: bool = False, mask=None,
        force_plain: bool = False):
    """Multi-head self-attention with an optional head-averaged prob tap
    (B, L, L).  ``force_plain``: the Grad-CAM head differentiates through
    its attention, so it takes the plain path (the kernels have no
    backward), as ``force_xla`` does in the JAX package."""
    b, l, d = x.shape
    head_dim = d // num_heads
    qkv = dense(p["qkv"], x).reshape(b, l, 3, num_heads, head_dim)
    if return_attn and mask is None and not force_plain:
        out, attn = flash_attention.mha_tap(qkv)
        return dense(p["proj"], out.to(x.dtype)), attn
    if not return_attn and mask is None and not force_plain and kernel_switch(NOTAP_IMPL_ENV):
        return dense(p["proj"], flash_attention.mha_notap(qkv).to(x.dtype)), None
    q, k, v = qkv.unbind(dim=2)  # (B, L, H, hd)
    q = q * head_dim ** -0.5
    logits = torch.einsum("blhd,bmhd->bhlm", q, k)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", probs.to(x.dtype), v).reshape(b, l, d)
    out = dense(p["proj"], out)
    return out, (probs.mean(dim=1) if return_attn else None)


def mlp(p, x, act: Callable):
    return dense(p["fc2"], act(dense(p["fc1"], x)))


def block(p, x, num_heads: int, act: Callable = exact_gelu, ln_eps: float = 1e-5,
          return_attn: bool = False, mask=None):
    """Pre-LN residual block, DINOv2 (layerscale) and CLIP dialects."""
    a, attn_probs = mha(p["attn"], layer_norm(p["ln1"], x, ln_eps), num_heads,
                        return_attn=return_attn, mask=mask)
    if "ls1" in p:
        a = a * p["ls1"]["gamma"]
    x = x + a
    h = mlp(p["mlp"], layer_norm(p["ln2"], x, ln_eps), act)
    if "ls2" in p:
        h = h * p["ls2"]["gamma"]
    return x + h, attn_probs


def _torch_cubic_1d(x: torch.Tensor, out_len: int, scale: float, axis: int,
                    a: float = -0.75) -> torch.Tensor:
    """torch F.interpolate(mode='bicubic', align_corners=False) along one
    axis with the scale FACTOR ``scale``: Keys kernel A = -0.75, source
    coordinates (i + 0.5) / scale - 0.5, border replication."""
    in_len = x.shape[axis]
    src = (torch.arange(out_len, dtype=torch.float32, device=x.device) + 0.5) / scale - 0.5
    i0 = torch.floor(src)
    t = src - i0

    def kern(dist):
        d = dist.abs()
        near = (a + 2.0) * d * d * d - (a + 3.0) * d * d + 1.0
        far = a * d * d * d - 5.0 * a * d * d + 8.0 * a * d - 4.0 * a
        return torch.where(d <= 1.0, near, torch.where(d < 2.0, far, torch.zeros_like(d)))

    offs = torch.arange(-1, 3, device=x.device)
    weights = kern(t[None, :] - offs[:, None].float())  # (4, out)
    idx = (i0.long()[None, :] + offs[:, None]).clamp(0, in_len - 1)  # (4, out)
    gathered = x.index_select(axis, idx.reshape(-1))
    gshape = list(x.shape)
    gshape[axis:axis + 1] = [4, out_len]
    wshape = [1] * len(gshape)
    wshape[axis], wshape[axis + 1] = 4, out_len
    return (gathered.reshape(gshape) * weights.reshape(wshape)).sum(dim=axis)


def interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw: Tuple[int, int],
                          num_prefix: int = 1, method: str = "bicubic",
                          interpolate_offset: float = 0.0) -> torch.Tensor:
    """Resample a (1, num_prefix + P, D) learned pos embed to a new grid.

    'bicubic' is DINOv2's torch bicubic (A = -0.75) with, when
    ``interpolate_offset`` is nonzero, scale factors (h + offset) / M;
    'bilinear' is CLIP's upsample through the jax.image-semantics resize
    (no antialias).  Prefix tokens pass through."""
    prefix, grid = pos_embed[:, :num_prefix], pos_embed[:, num_prefix:]
    n, d = grid.shape[1], grid.shape[2]
    m = int(round(n ** 0.5))
    if m * m != n:
        raise ValueError(f"pos embed grid is not square: {n}")
    h, w = grid_hw
    if (h, w) == (m, m):
        return pos_embed
    grid = grid.reshape(1, m, m, d).float()
    if method == "bicubic":
        sy = (h + interpolate_offset) / m if interpolate_offset else h / m
        sx = (w + interpolate_offset) / m if interpolate_offset else w / m
        grid = _torch_cubic_1d(grid, h, sy, axis=1)
        grid = _torch_cubic_1d(grid, w, sx, axis=2)
    else:
        grid = imaging.resize(grid, (h, w), method, antialias=False)
    grid = grid.reshape(1, h * w, d).to(pos_embed.dtype)
    return torch.cat([prefix, grid], dim=1)


def block_shapes(dim: int, mlp_hidden: int, layer_scale: bool = False) -> dict:
    """Parameter shapes of one block, keyed as the JAX package keys them."""
    p = {
        "ln1": {"scale": (dim,), "bias": (dim,)},
        "ln2": {"scale": (dim,), "bias": (dim,)},
        "attn": {"qkv": {"kernel": (dim, 3 * dim), "bias": (3 * dim,)},
                 "proj": {"kernel": (dim, dim), "bias": (dim,)}},
        "mlp": {"fc1": {"kernel": (dim, mlp_hidden), "bias": (mlp_hidden,)},
                "fc2": {"kernel": (mlp_hidden, dim), "bias": (dim,)}},
    }
    if layer_scale:
        p["ls1"] = {"gamma": (dim,)}
        p["ls2"] = {"gamma": (dim,)}
    return p
