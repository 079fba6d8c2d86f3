"""Vision datasets (port of ``paddle_tpu/vision/datasets.py``; it imports
nothing of JAX, so this is a copy, adapted).

Reference parity: ``python/paddle/vision/datasets/``. Nothing is
downloaded: each reader takes local files in the published format (MNIST
and Fashion-MNIST idx, raw or gzipped; the CIFAR python tarballs; the
Flowers-102 images and ``.mat`` files; the VOC2012 devkit tree) and
raises when they are absent. ``DatasetFolder`` (one subdirectory per
class, labelled) and ``ImageFolder`` (every image under a root,
unlabelled) decode ``.npy`` themselves and any other image through a
``loader=`` (PIL, for example). ``FakeData`` makes seeded synthetic
images. Samples are numpy arrays on the host; a DataLoader batches them.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..io.dataset import Dataset

__all__ = ["FakeData", "MNIST", "Cifar10", "Cifar100", "DatasetFolder",
           "ImageFolder"]

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".npy")


class FakeData(Dataset):
    """Deterministic synthetic images (reference CI stand-in)."""

    def __init__(self, num_samples: int = 128,
                 image_shape: Sequence[int] = (3, 32, 32),
                 num_classes: int = 10, transform: Optional[Callable] = None,
                 seed: int = 0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        img = rng.integers(0, 256, self.image_shape, np.uint8)
        label = np.int64(rng.integers(self.num_classes))
        if self.transform:
            img = self.transform(img)
        return img, label


class MNIST(Dataset):
    """IDX-format reader (``vision/datasets/mnist.py``); pass local
    ``image_path``/``label_path`` (.gz or raw idx)."""

    def __init__(self, image_path: str, label_path: str, mode: str = "train",
                 transform: Optional[Callable] = None,
                 backend: str = "cv2"):
        self.transform = transform
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)
        assert len(self.images) == len(self.labels)

    @staticmethod
    def _open(path: str):
        if path.endswith(".gz"):
            return gzip.open(path, "rb")
        return open(path, "rb")

    def _read_images(self, path: str) -> np.ndarray:
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad MNIST image magic {magic} in {path}")
            data = np.frombuffer(f.read(n * rows * cols), np.uint8)
            return data.reshape(n, rows, cols)

    def _read_labels(self, path: str) -> np.ndarray:
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise ValueError(f"bad MNIST label magic {magic} in {path}")
            return np.frombuffer(f.read(n), np.uint8).astype(np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]


class Cifar10(Dataset):
    """Reads the python-pickle CIFAR tarball from a local ``data_file``
    (``vision/datasets/cifar.py`` minus the downloader)."""

    _TRAIN_MEMBERS = [f"data_batch_{i}" for i in range(1, 6)]
    _TEST_MEMBERS = ["test_batch"]
    _LABEL_KEY = b"labels"

    def __init__(self, data_file: str, mode: str = "train",
                 transform: Optional[Callable] = None):
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"{data_file} not found; download the CIFAR python tarball "
                f"out-of-band (no network access here)")
        members = (self._TRAIN_MEMBERS if mode == "train"
                   else self._TEST_MEMBERS)
        images, labels = [], []
        with tarfile.open(data_file) as tar:
            for m in tar.getmembers():
                base = os.path.basename(m.name)
                if base in members:
                    d = pickle.load(tar.extractfile(m), encoding="bytes")
                    images.append(d[b"data"].reshape(-1, 3, 32, 32))
                    labels.extend(d[self._LABEL_KEY])
        self.images = np.concatenate(images)
        self.labels = np.asarray(labels, np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx].transpose(1, 2, 0)  # HWC uint8
        if self.transform:
            img = self.transform(img)
        return img, self.labels[idx]


class Cifar100(Cifar10):
    _TRAIN_MEMBERS = ["train"]
    _TEST_MEMBERS = ["test"]
    _LABEL_KEY = b"fine_labels"


class DatasetFolder(Dataset):
    """class-per-subdir layout (``vision/datasets/folder.py``); .npy or
    image files (image decoding needs an out-of-band loader arg)."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions: Sequence[str] = _IMG_EXTS,
                 transform: Optional[Callable] = None):
        self.root = root
        self.loader = loader or self._default_loader
        self.transform = transform
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        if not classes:
            raise ValueError(f"no class subdirectories under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(tuple(extensions)):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    @staticmethod
    def _default_loader(path: str):
        if path.endswith(".npy"):
            return np.load(path)
        raise ValueError(
            f"no builtin decoder for {path}; pass loader= (e.g. PIL/cv2)")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, np.int64(label)


class ImageFolder(Dataset):
    """Unlabeled flat/recursive image list (reference ``ImageFolder``)."""

    def __init__(self, root: str, loader: Optional[Callable] = None,
                 extensions: Sequence[str] = _IMG_EXTS,
                 transform: Optional[Callable] = None):
        self.loader = loader or DatasetFolder._default_loader
        self.transform = transform
        self.samples: List[str] = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                if fname.lower().endswith(tuple(extensions)):
                    self.samples.append(os.path.join(dirpath, fname))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform:
            img = self.transform(img)
        return (img,)


class FashionMNIST(MNIST):
    """Same IDX wire format as MNIST (reference ``fashion_mnist.py``);
    point image_path/label_path at the Fashion-MNIST archives."""


class Flowers(Dataset):
    """Flowers-102 (reference ``flowers.py``): local extracted archive —
    ``data_file`` is the image directory (image_%05d.jpg), ``label_file``
    the imagelabels .mat, ``setid_file`` the split ids .mat."""

    def __init__(self, data_file: str, label_file: str, setid_file: str,
                 mode: str = "train", transform: Optional[Callable] = None,
                 backend: str = "pil"):
        import scipy.io as sio

        self.transform = transform
        self.data_dir = data_file
        labels = sio.loadmat(label_file)["labels"].reshape(-1)
        setid = sio.loadmat(setid_file)
        key = {"train": "trnid", "valid": "valid", "test": "tstid"}[mode]
        self.ids = setid[key].reshape(-1)
        self.labels = labels

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, idx):
        import os

        from PIL import Image

        img_id = int(self.ids[idx])
        path = os.path.join(self.data_dir, f"image_{img_id:05d}.jpg")
        img = np.asarray(Image.open(path))
        if self.transform:
            img = self.transform(img)
        return img, np.int64(self.labels[img_id - 1] - 1)


class VOC2012(Dataset):
    """VOC2012 segmentation pairs (reference ``voc2012.py``): point
    ``data_file`` at the extracted VOCdevkit/VOC2012 directory."""

    def __init__(self, data_file: str, mode: str = "train",
                 transform: Optional[Callable] = None,
                 backend: str = "pil"):
        import os

        self.transform = transform
        self.root = data_file
        split = {"train": "train", "valid": "val", "test": "val",
                 "trainval": "trainval"}[mode]
        list_path = os.path.join(self.root, "ImageSets", "Segmentation",
                                 f"{split}.txt")
        with open(list_path) as f:
            self.names = [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, idx):
        import os

        from PIL import Image

        name = self.names[idx]
        img = np.asarray(Image.open(
            os.path.join(self.root, "JPEGImages", f"{name}.jpg")))
        seg = np.asarray(Image.open(
            os.path.join(self.root, "SegmentationClass", f"{name}.png")))
        if self.transform:
            img = self.transform(img)
        return img, seg


__all__ += ["FashionMNIST", "Flowers", "VOC2012"]
