"""Seeds, random streams and the training step (port of ``paddle_tpu/framework``)."""
