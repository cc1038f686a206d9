"""Port of ``mars_tpu/ops``."""
