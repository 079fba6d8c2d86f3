"""Single-card counterparts of ``paddle_tpu/distributed``."""
