"""The port's ``text`` datasets and legacy ``dataset`` readers against the
JAX package's, on the CPU.

Mirrors ``tests/test_text_datasets.py`` (8 cases) and
``tests/test_legacy_dataset.py`` (3): each case writes a small archive in
the reference's on-disk format under ``tmp_path``, and both packages
parse it.  Vocabularies, ids, lengths and every item must be equal
(numbers exactly: both are the same host arithmetic).
"""

import gzip
import io
import struct
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as jdataset
import paddle_tpu.text as jtext

import paddle_tpu_torch as tp
import paddle_tpu_torch.dataset as tdataset
import paddle_tpu_torch.text as ttext


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _tar_add(tf, name, content: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(content)
    tf.addfile(info, io.BytesIO(content))


def _same_items(jds, tds):
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, (i, x, y)
            np.testing.assert_array_equal(x, y)


def _both(name, **kw):
    return getattr(jtext, name)(**kw), getattr(ttext, name)(**kw)


def test_zero_egress_guidance():
    for mod in (jtext, ttext):
        with pytest.raises(RuntimeError, match="zero-egress"):
            mod.Imdb()
        with pytest.raises(RuntimeError, match="data_file"):
            mod.UCIHousing()
    with pytest.raises(RuntimeError, match="stanford"):
        ttext.Imdb()


def test_imdb(tmp_path):
    p = str(tmp_path / "aclImdb.tar")
    with tarfile.open(p, "w") as tf:
        for name, text in {
                "aclImdb/train/pos/0.txt": b"good good movie!",
                "aclImdb/train/neg/0.txt": b"bad bad movie.",
                "aclImdb/train/pos/1.txt": b"a good plot, good cast",
                "aclImdb/test/pos/0.txt": b"good movie",
                "aclImdb/test/neg/0.txt": b"bad movie"}.items():
            _tar_add(tf, name, text)
    for mode in ("train", "test"):
        jds, tds = _both("Imdb", data_file=p, mode=mode, cutoff=1)
        assert jds.word_idx == tds.word_idx
        assert len(tds.word_idx) == 4
        _same_items(jds, tds)


def test_imikolov(tmp_path):
    p = str(tmp_path / "simple-examples.tgz")
    with tarfile.open(p, "w:gz") as tf:
        _tar_add(tf, "./simple-examples/data/ptb.train.txt",
                 b"the cat sat\nthe dog sat\na dog ran far\n")
        _tar_add(tf, "./simple-examples/data/ptb.valid.txt",
                 b"the cat ran\n")
    jds, tds = _both("Imikolov", data_file=p, data_type="NGRAM",
                     window_size=2, mode="train", min_word_freq=1)
    assert jds.word_idx == tds.word_idx
    _same_items(jds, tds)
    jds, tds = _both("Imikolov", data_file=p, data_type="SEQ", mode="test",
                     min_word_freq=1)
    _same_items(jds, tds)
    src, trg = tds[0]
    assert len(src) == len(trg)


def test_uci_housing(tmp_path):
    p = str(tmp_path / "housing.data")
    np.savetxt(p, np.random.RandomState(0).rand(20, 14))
    for mode, n in (("train", 16), ("test", 4)):
        jds, tds = _both("UCIHousing", data_file=p, mode=mode)
        assert len(tds) == n
        _same_items(jds, tds)
    x, y = tds[0]
    assert x.shape == (13,) and y.shape == (1,) and x.dtype == np.float32


def test_movielens(tmp_path):
    p = str(tmp_path / "ml-1m.zip")
    with zipfile.ZipFile(p, "w") as zf:
        zf.writestr("ml-1m/movies.dat",
                    "1::Toy Story (1995)::Animation|Comedy\n"
                    "2::Jumanji (1995)::Adventure\n")
        zf.writestr("ml-1m/users.dat",
                    "1::M::25::4::12345\n2::F::35::7::54321\n")
        zf.writestr("ml-1m/ratings.dat",
                    "1::1::5::978300760\n1::2::3::978302109\n"
                    "2::1::4::978301968\n2::2::2::978301969\n")
    for mode, ratio in (("train", 0.0), ("train", 0.5), ("test", 0.5)):
        jds, tds = _both("Movielens", data_file=p, mode=mode,
                         test_ratio=ratio, rand_seed=3)
        assert jds.movie_info == tds.movie_info
        assert jds.user_info == tds.user_info
        _same_items(jds, tds)
    assert len(tds[0]) == 8


def test_wmt14(tmp_path):
    p = str(tmp_path / "wmt14.tgz")
    with tarfile.open(p, "w:gz") as tf:
        _tar_add(tf, "wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n")
        _tar_add(tf, "wmt14/trg.dict", b"<s>\n<e>\n<unk>\nbonjour\nmonde\n")
        _tar_add(tf, "wmt14/train/train",
                 b"hello world\tbonjour monde\nhello\tbonjour\nbad line\n")
        _tar_add(tf, "wmt14/test/test", b"world\tmonde\n")
    for mode, size in (("train", 5), ("train", 4), ("test", 5)):
        jds, tds = _both("WMT14", data_file=p, mode=mode, dict_size=size)
        assert jds.src_dict == tds.src_dict
        assert jds.trg_dict == tds.trg_dict
        _same_items(jds, tds)
    src, trg, trg_next = tds[0]
    assert src[0] == tds.src_dict["<s>"] and src[-1] == tds.src_dict["<e>"]


def test_wmt16(tmp_path):
    p = str(tmp_path / "wmt16.tar.gz")
    with tarfile.open(p, "w:gz") as tf:
        _tar_add(tf, "wmt16/train",
                 b"a small dog\tein kleiner hund\nthe dog\tder hund\n")
        _tar_add(tf, "wmt16/val", b"a dog\tein hund\n")
        _tar_add(tf, "wmt16/test", b"the small dog\tder kleine hund\n")
    for mode, lang in (("train", "en"), ("val", "en"), ("test", "de")):
        jds, tds = _both("WMT16", data_file=p, mode=mode, lang=lang,
                         src_dict_size=6, trg_dict_size=-1)
        assert jds.src_dict == tds.src_dict
        assert jds.trg_dict == tds.trg_dict
        _same_items(jds, tds)
    assert "hund" in ttext.WMT16(data_file=p, mode="train").trg_dict


def test_conll05(tmp_path):
    words = b"The\ncat\nsat\n\nA\ndog\nran\n\n"
    props = b"-\t*\n-\t(A0*)\nsit\t(V*)\n\n-\t(A0*\n-\t*)\nrun\t(V*)\n\n"
    buf_w, buf_p = io.BytesIO(), io.BytesIO()
    with gzip.GzipFile(fileobj=buf_w, mode="w") as g:
        g.write(words)
    with gzip.GzipFile(fileobj=buf_p, mode="w") as g:
        g.write(props)
    p = str(tmp_path / "conll05st-tests.tar.gz")
    with tarfile.open(p, "w:gz") as tf:
        _tar_add(tf, "conll05st-release/test.wsj/words/test.wsj.words.gz",
                 buf_w.getvalue())
        _tar_add(tf, "conll05st-release/test.wsj/props/test.wsj.props.gz",
                 buf_p.getvalue())
    wd, vd, td = (str(tmp_path / n) for n in
                  ("wordDict.txt", "verbDict.txt", "targetDict.txt"))
    open(wd, "w").write("The\ncat\nsat\ndog\n<unk>\n")
    open(vd, "w").write("sit\nrun\n")
    open(td, "w").write("B-A0\nI-A0\nB-V\nI-V\nO\n")
    jds, tds = _both("Conll05st", data_file=p, word_dict_file=wd,
                     verb_dict_file=vd, target_dict_file=td, emb_file=td)
    assert len(tds) == 2
    assert jds.label_dict == tds.label_dict
    _same_items(jds, tds)
    assert len(tds[0]) == 9 and tds[0][7].sum() == 1


# -- the legacy readers (tests/test_legacy_dataset.py) ----------------------


def test_legacy_surface_importable():
    for mod in ("mnist", "cifar", "uci_housing", "imdb", "imikolov",
                "movielens", "flowers", "voc2012", "wmt14", "wmt16",
                "conll05"):
        assert hasattr(tdataset, mod), mod
    assert sorted(tdataset.__all__) == sorted(jdataset.__all__)
    assert callable(tdataset.mnist.train())
    with pytest.raises((RuntimeError, FileNotFoundError)):
        next(iter(tdataset.uci_housing.train()()))


def test_legacy_mnist_reader_and_batch(tmp_path):
    n = 8
    imgs = np.random.RandomState(0).randint(0, 256, (n, 28, 28), "uint8")
    labels = (np.arange(n) % 10).astype("uint8")
    ip, lp = tmp_path / "imgs.gz", tmp_path / "labels.gz"
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(labels.tobytes())
    kw = dict(image_path=str(ip), label_path=str(lp))
    want = list(jdataset.mnist.train(**kw)())
    got = list(tdataset.mnist.train(**kw)())
    assert len(got) == len(want) == n
    for (a, la), (b, lb) in zip(want, got):
        assert b.dtype == np.float32 and b.shape == (784,) and la == lb
        np.testing.assert_array_equal(a, b)
    reader = tdataset.mnist.train(**kw)
    assert [len(b) for b in tp.batch(reader, batch_size=3)()] == [3, 3, 2]
    assert [len(b) for b in tp.batch(reader, batch_size=3,
                                     drop_last=True)()] == [3, 3]


def test_legacy_text_readers(tmp_path):
    rows = np.random.RandomState(0).rand(10, 14).astype("float64")
    data_file = tmp_path / "housing.data"
    np.savetxt(data_file, rows.reshape(-1, 7))
    for fn in ("train", "test"):
        want = list(getattr(jdataset.uci_housing, fn)(
            data_file=str(data_file))())
        got = list(getattr(tdataset.uci_housing, fn)(
            data_file=str(data_file))())
        assert len(got) == len(want)
        for (a, pa), (b, pb) in zip(want, got):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(pa, pb)
    p = str(tmp_path / "simple-examples.tgz")
    with tarfile.open(p, "w:gz") as tf:
        _tar_add(tf, "./simple-examples/data/ptb.train.txt",
                 b"the cat sat on the mat\nthe dog sat\n")
        _tar_add(tf, "./simple-examples/data/ptb.valid.txt",
                 b"the cat ran\n")
    wd = ttext.Imikolov(data_file=p, data_type="SEQ",
                        min_word_freq=1).word_idx
    want = list(jdataset.imikolov.train(wd, 3, data_file=p)())
    got = list(tdataset.imikolov.train(wd, 3, data_file=p)())
    assert got == want and len(got) > 0
