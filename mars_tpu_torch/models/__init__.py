"""Port of ``mars_tpu/models``."""
