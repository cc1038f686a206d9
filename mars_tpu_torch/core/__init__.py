"""Port of ``mars_tpu/core``."""
