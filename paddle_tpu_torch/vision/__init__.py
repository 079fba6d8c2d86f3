"""paddle_tpu_torch.vision: the detection and region ops (:mod:`.ops`)
and the image backend switch (port of ``paddle_tpu/vision/__init__.py``).

``models``, ``transforms`` and ``datasets`` are not ported yet: they are
queued in ROADMAP A9. The detectors and the recognizer live in
:mod:`paddle_tpu_torch.models` (``ppyoloe``, ``yolo``, ``ocr``), as in
the reference. PIL (and opencv for the "cv2" backend) is imported only
when an image is loaded.
"""
from . import ops

__all__ = ["ops", "get_image_backend", "set_image_backend", "image_load"]

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
