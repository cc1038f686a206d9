"""Mixed-precision policy for the frozen towers (port of
``mars_tpu/models/precision.py``).

Casting a tower's floating parameters to bfloat16 flips its matmuls to
bfloat16, while LayerNorm, RMSNorm and the attention softmax keep computing
in float32 by construction (``layers.layer_norm``, ``vip_llava._rms_norm``,
the ``.float()`` before each softmax).
"""
from __future__ import annotations

import torch


def cast_floating(params, dtype=torch.bfloat16):
    """Cast the floating-point tensors of a nested parameter dict to ``dtype``."""
    if isinstance(params, dict):
        return {k: cast_floating(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params
