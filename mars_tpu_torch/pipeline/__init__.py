"""Port of ``mars_tpu/pipeline``."""
