"""Port of ``mars_tpu/utils``."""
