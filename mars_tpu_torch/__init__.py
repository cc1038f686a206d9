"""mars_tpu_torch — the MARS few-shot segmentation system in PyTorch for an
NVIDIA H100.

A port of ``mars_tpu`` (the JAX/XLA/Pallas rebuild), module for module:
``core``, ``models``, ``ops``, ``pipeline``, ``data``, ``text`` and
``utils`` pair with the JAX package's files of the same names.  Plain
tensor work is PyTorch; every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (sources under ``csrc/``), built at first
use, with a plain PyTorch version beside it that the CPU tests compare.

The package imports neither ``jax`` nor ``mars_tpu``.  Entry points run on
``cuda`` and raise when no card is present, unless the caller passes
``device="cpu"`` (``device.resolve``).
"""

__version__ = "0.1.0"
