"""Device selection and the float32 numerics policy.

Entry points (``Mars``, ``cli.main``, the weight constructors in ``models.zoo``)
take a ``device`` argument.  ``None`` means the card: without CUDA that is
an error, never a quiet fall back to the CPU.  ``"cpu"`` is an explicit
request, which the tests make.

TF32 is off on both matmul and cuDNN: the port is held against the JAX
package at float32 (``jax_default_matmul_precision=highest`` in its tests),
and TF32 keeps about three decimal digits.  cuDNN would otherwise run a
float32 convolution in TF32 by default.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def set_float32_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); ``"cpu"`` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        set_float32_policy()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device: {dev}")
    return dev
