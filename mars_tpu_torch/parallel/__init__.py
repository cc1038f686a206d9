"""Multi-device drivers over ``torch.distributed`` (port of ``mars_tpu/parallel``)."""
