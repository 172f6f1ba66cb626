"""The port's folder and tar datasets (``DatasetFolder``, ``ImageFolder``,
``Flowers``, ``VOC2012``) and ``vision.image`` against the reference's on
the CPU, over files made in ``tmp_path`` from seeds (nothing is
downloaded).

Mirrors ``tests/test_vision_datasets.py``: the folder datasets over PNG
files through PIL and over ``.npy`` arrays (which load without PIL, as
on the card's machine), ``Flowers`` from a tgz with scipy ``.mat`` labels
and splits, ``VOC2012`` from a tar, and ``Flowers`` through the port's
DataLoader with two spawned workers.  Samples are compared with the
reference's item for item: classes, targets and labels exactly, images
as arrays exactly (both decode through the same PIL).
"""

import functools
import io as _io
import tarfile

import numpy as np
import pytest

import paddle_tpu as jp

import paddle_tpu_torch as tp


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _arr(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _same_items(jds, tds):
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(_arr(v), _arr(u))


@pytest.fixture
def png_root(tmp_path):
    from PIL import Image

    root = tmp_path / "png"
    rng = np.random.RandomState(0)
    for cls in ("cat", "dog", "eel"):
        d = root / cls
        d.mkdir(parents=True)
        for i in range(3):
            px = rng.randint(0, 256, (8, 6, 3)).astype("uint8")
            Image.fromarray(px).save(d / f"{i}.png")
    (root / "dog" / "notes.txt").write_text("skipped")
    return str(root)


@pytest.fixture
def npy_root(tmp_path):
    root = tmp_path / "npy"
    rng = np.random.RandomState(1)
    for cls in ("b", "a"):
        d = root / cls / "nested"
        d.mkdir(parents=True)
        for i in range(2):
            np.save(d / f"{i}.npy",
                    rng.randint(0, 256, (5, 7, 3)).astype("uint8"))
    return str(root)


def test_folder_datasets_over_png(png_root):
    for P in (jp, tp):
        ds = P.vision.datasets.DatasetFolder(png_root)
        assert ds.classes == ["cat", "dog", "eel"] and len(ds) == 9
        img, label = ds[0]
        assert label == 0 and img.size == (6, 8)
        assert ds.targets.count(1) == 3
        flat = P.vision.datasets.ImageFolder(png_root)
        assert len(flat) == 9 and flat[0][0].size == (6, 8)
    _same_items(jp.vision.datasets.DatasetFolder(png_root, transform=np.asarray),
                tp.vision.datasets.DatasetFolder(png_root, transform=np.asarray))
    _same_items(jp.vision.datasets.ImageFolder(png_root, transform=np.asarray),
                tp.vision.datasets.ImageFolder(png_root, transform=np.asarray))


def test_folder_datasets_over_npy_with_transforms(npy_root):
    """``.npy`` images need no PIL; a transform pipeline applies."""
    def pipe(P):
        T = P.vision.transforms
        return T.Compose([T.CenterCrop(4), T.Normalize(127.5, 127.5, "HWC"),
                          T.Transpose()])

    jds = jp.vision.datasets.DatasetFolder(npy_root, transform=pipe(jp))
    tds = tp.vision.datasets.DatasetFolder(npy_root, transform=pipe(tp))
    assert tds.classes == ["a", "b"] and tds.class_to_idx == {"a": 0, "b": 1}
    assert [p[1] for p in tds.samples] == [0, 0, 1, 1]
    _same_items(jds, tds)
    assert tds[0][0].shape == (3, 4, 4) and tds[0][0].dtype == np.float32
    for P in (jp, tp):
        only = P.vision.datasets.DatasetFolder(
            npy_root, is_valid_file=lambda p: p.endswith("1.npy"))
        assert len(only) == 2
        with pytest.raises(RuntimeError):
            P.vision.datasets.DatasetFolder(npy_root, extensions=(".png",))
    fm = tp.vision.datasets.folder
    assert fm.has_valid_extension("a/B.NPY", fm.IMG_EXTENSIONS)
    assert not fm.has_valid_extension("a/b.txt", (".png",))


def _flowers_fixture(tmp_path):
    from PIL import Image
    import scipy.io as scio

    fdir = tmp_path / "flowers"
    fdir.mkdir()
    tar_p = str(fdir / "102flowers.tgz")
    rng = np.random.RandomState(2)
    with tarfile.open(tar_p, "w:gz") as tf:
        for i in range(1, 5):
            buf = _io.BytesIO()
            px = rng.randint(0, 256, (6, 6, 3)).astype("uint8")
            Image.fromarray(px).save(buf, format="JPEG")
            data = buf.getvalue()
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = len(data)
            tf.addfile(info, _io.BytesIO(data))
    lab_p = str(fdir / "imagelabels.mat")
    set_p = str(fdir / "setid.mat")
    scio.savemat(lab_p, {"labels": np.array([[1, 2, 1, 2]])})
    scio.savemat(set_p, {"trnid": np.array([[1, 3]]),
                         "valid": np.array([[2]]),
                         "tstid": np.array([[4]])})
    return tar_p, lab_p, set_p


def test_flowers(tmp_path):
    files = _flowers_fixture(tmp_path)
    kw = dict(zip(("data_file", "label_file", "setid_file"), files))
    for mode in ("train", "valid", "test"):
        for backend in ("pil", "cv2"):
            jds = jp.vision.datasets.Flowers(mode=mode, backend=backend, **kw)
            tds = tp.vision.datasets.Flowers(mode=mode, backend=backend, **kw)
            _same_items(jds, tds)
    img, label = tp.vision.datasets.Flowers(mode="train", **kw)[0]
    assert img.size == (6, 6) and label.tolist() == [1]
    arr, _ = tp.vision.datasets.Flowers(mode="valid", backend="cv2", **kw)[0]
    assert arr.dtype == np.float32 and arr.shape == (6, 6, 3)
    with pytest.raises(ValueError):
        tp.vision.datasets.Flowers(backend="CV2", **kw)
    with pytest.raises(RuntimeError, match="102flowers.tgz"):
        tp.vision.datasets.Flowers(label_file=files[1], setid_file=files[2])


def test_flowers_multiprocess_dataloader(tmp_path):
    """An open tar handle does not go into the spawned workers' pickles."""
    files = _flowers_fixture(tmp_path)
    ds = tp.vision.datasets.Flowers(
        *files, mode="train",
        transform=functools.partial(np.asarray, dtype="float32"))
    ds[0]  # open the handle before the workers start
    batches = list(tp.io.DataLoader(ds, batch_size=2, num_workers=2))
    assert len(batches) == 1
    imgs, labels = batches[0]
    np.testing.assert_array_equal(
        imgs.numpy(), np.stack([ds[0][0], ds[1][0]]))
    assert labels.numpy().reshape(-1).tolist() == [1, 1]


def test_voc2012(tmp_path):
    from PIL import Image

    voc_p = str(tmp_path / "voc.tar")
    rng = np.random.RandomState(3)
    with tarfile.open(voc_p, "w") as tf:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, _io.BytesIO(data))

        base = "VOCdevkit/VOC2012"
        add(f"{base}/ImageSets/Segmentation/train.txt", b"a\n")
        add(f"{base}/ImageSets/Segmentation/trainval.txt", b"a\nb\n")
        add(f"{base}/ImageSets/Segmentation/val.txt", b"b\n")
        for n in ("a", "b"):
            buf = _io.BytesIO()
            Image.fromarray(rng.randint(0, 256, (5, 5, 3)).astype(
                "uint8")).save(buf, format="JPEG")
            add(f"{base}/JPEGImages/{n}.jpg", buf.getvalue())
            buf = _io.BytesIO()
            Image.fromarray(rng.randint(0, 21, (5, 5)).astype("uint8"),
                            "P").save(buf, format="PNG")
            add(f"{base}/SegmentationClass/{n}.png", buf.getvalue())
    for mode, n in (("train", 2), ("valid", 1), ("test", 1)):
        for backend in ("pil", "cv2"):
            jds = jp.vision.datasets.VOC2012(data_file=voc_p, mode=mode,
                                             backend=backend)
            tds = tp.vision.datasets.VOC2012(data_file=voc_p, mode=mode,
                                             backend=backend)
            assert len(tds) == n
            _same_items(jds, tds)
    im, mask = tp.vision.datasets.VOC2012(data_file=voc_p, mode="train")[1]
    assert im.size == (5, 5) and mask.size == (5, 5)
    with pytest.raises(RuntimeError, match="VOCtrainval"):
        tp.vision.datasets.VOC2012()


def test_image_backend_and_image_load(tmp_path):
    from PIL import Image

    p = str(tmp_path / "x.png")
    px = np.random.RandomState(4).randint(0, 256, (4, 5, 3)).astype("uint8")
    Image.fromarray(px).save(p)
    image = tp.vision.image
    assert image.get_image_backend() == "pil"
    try:
        for backend in ("cv2", "tensor", "pil"):
            image.set_image_backend(backend)
            assert image.get_image_backend() == backend
            got = _arr(image.image_load(p))
            want = _arr(jp.vision.image.image_load(p, backend=backend))
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError):
            image.set_image_backend("opencv")
    finally:
        image.set_image_backend("pil")
    np.testing.assert_array_equal(_arr(image.image_load(p, "cv2")),
                                  px[:, :, ::-1])


def test_dataset_names_match_reference():
    assert sorted(tp.vision.datasets.__all__) == sorted(
        jp.vision.datasets.__all__)
