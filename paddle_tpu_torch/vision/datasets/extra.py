"""Flowers-102 and VOC2012 from local archives (nothing is downloaded).

Counterpart of ``paddle_tpu/vision/datasets/extra.py``: ``Flowers`` reads
a tgz of jpgs with its labels and splits from scipy ``.mat`` files,
``VOC2012`` one tar with the segmentation splits, images and class masks.
A missing file raises, naming the public URL of the archive to place
locally.  The tar is opened on first use in each process and left out of
pickling, so the datasets work in the DataLoader's spawned workers.
"""

from __future__ import annotations

import io
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Flowers", "VOC2012"]

_MODE_FLAG = {"train": "trnid", "valid": "valid", "test": "tstid"}


def _require(f, what, url):
    if not f:
        raise RuntimeError(
            f"nothing is downloaded: pass {what}= pointing at a local "
            f"copy ({url})")
    return f


def _check_backend(backend):
    backend = backend or "pil"
    if backend not in ("pil", "cv2"):
        raise ValueError(
            f"Expected backend are one of ['pil', 'cv2'], but got {backend}")
    return backend


class _TarBacked:
    """Lazy tar access: the handle is opened on first use in each
    process."""

    _tar_handle = None
    _member_map = None

    def _tar(self):
        if self._tar_handle is None:
            self._tar_handle = tarfile.open(self.data_file)
            self._member_map = {m.name: m
                                for m in self._tar_handle.getmembers()}
        return self._tar_handle

    def _read_member(self, name) -> bytes:
        tar = self._tar()
        return tar.extractfile(self._member_map[name]).read()

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_tar_handle"] = None
        state["_member_map"] = None
        return state

    def __del__(self):
        try:
            if self._tar_handle is not None:
                self._tar_handle.close()
        except Exception:
            pass


class Flowers(_TarBacked, Dataset):
    """Oxford 102 Flowers.  Items: ``(image, [label])`` (backend ``pil``:
    a PIL image; ``cv2``: a float32 HWC array)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        assert mode.lower() in ("train", "valid", "test"), mode
        url = "https://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
        self.data_file = _require(data_file, "data_file", url + "102flowers.tgz")
        label_file = _require(label_file, "label_file", url + "imagelabels.mat")
        setid_file = _require(setid_file, "setid_file", url + "setid.mat")
        self.transform = transform
        self.backend = _check_backend(backend)

        import scipy.io as scio

        self.labels = scio.loadmat(label_file)["labels"][0]
        self.indexes = scio.loadmat(setid_file)[_MODE_FLAG[mode.lower()]][0]

    def __getitem__(self, idx):
        from PIL import Image

        index = int(self.indexes[idx])
        label = np.array([self.labels[index - 1]])
        raw = self._read_member("jpg/image_%05d.jpg" % index)
        image = Image.open(io.BytesIO(raw)).convert("RGB")
        if self.backend == "cv2":
            image = np.array(image)
        if self.transform is not None:
            image = self.transform(image)
        if self.backend == "cv2":
            image = np.asarray(image).astype("float32")
        return image, label.astype("int64")

    def __len__(self):
        return len(self.indexes)


class VOC2012(_TarBacked, Dataset):
    """PASCAL VOC2012 segmentation.  Items: ``(image, mask)``.  Mode
    ``train`` reads ``trainval.txt``, ``valid`` ``val.txt`` and ``test``
    ``train.txt``, as Paddle's ``voc2012.py`` does."""

    SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
    DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
    LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
    _FLAG = {"train": "trainval", "valid": "val", "test": "train"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        assert mode.lower() in ("train", "valid", "test"), mode
        self.data_file = _require(
            data_file, "data_file",
            "http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
            "VOCtrainval_11-May-2012.tar")
        self.transform = transform
        self.backend = _check_backend(backend)
        self.flag = self._FLAG[mode.lower()]
        split = self._read_member(self.SET_FILE.format(self.flag))
        self.data, self.labels = [], []
        for line in split.splitlines():
            name = line.strip().decode("utf-8")
            if not name:
                continue
            self.data.append(self.DATA_FILE.format(name))
            self.labels.append(self.LABEL_FILE.format(name))

    def __getitem__(self, idx):
        from PIL import Image

        data = Image.open(io.BytesIO(self._read_member(self.data[idx])))
        label = Image.open(io.BytesIO(self._read_member(self.labels[idx])))
        if self.backend == "cv2":
            data, label = np.array(data), np.array(label)
        if self.transform is not None:
            data = self.transform(data)
        if self.backend == "cv2":
            return (np.asarray(data).astype("float32"),
                    np.asarray(label).astype("float32"))
        return data, label

    def __len__(self):
        return len(self.data)
