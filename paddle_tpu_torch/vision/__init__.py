"""paddle_tpu_torch.vision (port of ``paddle_tpu/vision/__init__.py``):
the model zoo (:mod:`.models`), the host-side image transforms
(:mod:`.transforms`), the dataset readers (:mod:`.datasets`), the
detection and region ops (:mod:`.ops`) and the image backend switch.

The detectors and the recognizer live in :mod:`paddle_tpu_torch.models`
(``ppyoloe``, ``yolo``, ``ocr``), as in the reference. PIL (and opencv
for the "cv2" backend) is imported only when an image is loaded.
"""
from . import datasets, models, ops, transforms

__all__ = ["models", "transforms", "datasets", "ops",
           "get_image_backend", "set_image_backend", "image_load"]

_image_backend = "pil"


def set_image_backend(backend: str) -> None:
    """Choose the decoder for ``image_load``: 'pil' or 'cv2' (opencv is
    needed only when an image is loaded with it)."""
    if backend not in ("pil", "cv2"):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {backend!r}")
    global _image_backend
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path: str, backend: str = None):
    """Load an image through the configured backend: a PIL image, or
    opencv's array for 'cv2'."""
    backend = backend or _image_backend
    if backend not in ("pil", "cv2"):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {backend!r}")
    if backend == "cv2":
        import cv2

        return cv2.imread(path)
    from PIL import Image

    return Image.open(path)
