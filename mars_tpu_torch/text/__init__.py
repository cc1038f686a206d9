"""Port of ``mars_tpu/text``."""
