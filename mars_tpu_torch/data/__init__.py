"""Port of ``mars_tpu/data``."""
