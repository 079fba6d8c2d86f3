"""Activation recompute (port of ``paddle_tpu/distributed/parallel``)."""
