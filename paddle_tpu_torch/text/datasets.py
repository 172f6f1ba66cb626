"""``paddle.text`` datasets: parsers of the reference's archives, read
from local files only.

Counterpart of ``paddle_tpu/text/datasets.py``: the same constructors, the
same ``__getitem__`` tuples (numpy arrays) and the same on-disk formats as
the reference's ``text/datasets/`` (imdb, imikolov, uci_housing, movielens,
wmt14, wmt16, conll05).  Nothing is downloaded: without ``data_file`` a
constructor raises, naming the file and the URL it comes from.
"""

from __future__ import annotations

import collections
import gzip
import re
import string
import tarfile
import zipfile

import numpy as np

from ..io import Dataset

_NO_DOWNLOAD = (
    "this build is zero-egress: pass data_file= pointing at a local copy "
    "of {name} ({url}); automatic download is unavailable"
)


def _require(data_file, name, url):
    if data_file is None:
        raise RuntimeError(_NO_DOWNLOAD.format(name=name, url=url))
    return data_file


class Imdb(Dataset):
    """IMDB sentiment (aclImdb tar).  Parity: imdb.py:76 — word dict built
    from the corpus with ``cutoff`` frequency, docs as id arrays, label 0
    (pos) / 1 (neg)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True, word_idx=None):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _require(
            data_file, "aclImdb_v1.tar.gz",
            "https://ai.stanford.edu/~amaas/data/sentiment/")
        # a caller-supplied dict (legacy imdb.train(word_idx) contract) must
        # govern the id mapping, not a freshly rebuilt one
        self.word_idx = (dict(word_idx) if word_idx is not None
                         else self._build_word_dict(cutoff))
        self._load(self.mode)

    def _docs(self, pattern):
        pat = re.compile(pattern)
        strip = bytes.maketrans(b"", b"")
        punct = string.punctuation.encode()
        with tarfile.open(self.data_file) as tf:
            for member in tf:
                if pat.match(member.name):
                    raw = tf.extractfile(member).read().rstrip(b"\n\r")
                    yield raw.translate(strip, punct).lower().split()

    def _build_word_dict(self, cutoff):
        freq = collections.defaultdict(int)
        for doc in self._docs(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$"):
            for w in doc:
                freq[w] += 1
        kept = sorted(((w, c) for w, c in freq.items() if c > cutoff),
                      key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx[b"<unk>"] = len(word_idx)
        return word_idx

    def _load(self, mode):
        unk = self.word_idx[b"<unk>"]
        self.docs, self.labels = [], []
        for label, sub in ((0, "pos"), (1, "neg")):
            for doc in self._docs(rf"aclImdb/{mode}/{sub}/.*\.txt$"):
                self.docs.append([self.word_idx.get(w, unk) for w in doc])
                self.labels.append(label)

    def __getitem__(self, idx):
        return np.array(self.docs[idx]), np.array([self.labels[idx]])

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB language modelling (imikolov tar).  Parity: imikolov.py:76 —
    NGRAM windows or SEQ id sequences over a min-frequency dict."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True,
                 word_idx=None):
        assert data_type.upper() in ("NGRAM", "SEQ"), data_type
        assert mode.lower() in ("train", "test"), mode
        self.data_type = data_type.upper()
        self.window_size = window_size
        self.mode = mode.lower()
        self.min_word_freq = min_word_freq
        self.data_file = _require(
            data_file, "simple-examples.tgz",
            "http://www.fit.vutbr.cz/~imikolov/rnnlm/")
        # legacy imikolov.train(word_idx, n) contract: a supplied dict
        # governs the id mapping
        self.word_idx = (dict(word_idx) if word_idx is not None
                         else self._build_word_dict())
        self._load()

    def _lines(self, which):
        path = f"./simple-examples/data/ptb.{which}.txt"
        with tarfile.open(self.data_file) as tf:
            names = [m.name for m in tf
                     if m.name.endswith(f"ptb.{which}.txt")]
            f = tf.extractfile(names[0] if names else path)
            for line in f:
                yield line.decode("utf-8", "replace").strip().split()

    def _build_word_dict(self):
        # reference semantics (imikolov.py word_count): the <s>/<e>
        # sentinels are counted once per sentence so they land IN the dict
        freq = collections.defaultdict(int)
        for words in self._lines("train"):
            freq["<s>"] += 1
            freq["<e>"] += 1
            for w in words:
                freq[w] += 1
        freq.pop("<unk>", None)
        kept = sorted(((w, c) for w, c in freq.items()
                       if c >= self.min_word_freq),
                      key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def _load(self):
        n = self.window_size
        idx = self.word_idx
        unk = idx["<unk>"]
        self.data = []
        for words in self._lines(self.mode if self.mode != "test"
                                 else "valid"):
            sent = ["<s>"] + words + ["<e>"]
            ids = [idx.get(w, unk) for w in sent]
            if self.data_type == "NGRAM":
                assert n > -1, "window_size must be set for NGRAM data"
                if len(ids) < n:  # reference skips short sentences
                    continue
                for i in range(n, len(ids) + 1):
                    self.data.append(tuple(ids[i - n:i]))
            else:
                self.data.append((ids[:-1], ids[1:]))

    def __getitem__(self, idx):
        return tuple(np.array(x) for x in self.data[idx])

    def __len__(self):
        return len(self.data)


class UCIHousing(Dataset):
    """Boston housing regression.  Parity: uci_housing.py:78 — 13 features
    min-max-mean normalized, 80/20 train/test split."""

    FEATURE_NUM = 14

    def __init__(self, data_file=None, mode="train", download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.data_file = _require(
            data_file, "housing.data",
            "https://archive.ics.uci.edu/ml/machine-learning-databases/housing/")
        self.dtype = "float32"
        self._load()

    def _load(self):
        data = np.loadtxt(self.data_file).reshape(-1, self.FEATURE_NUM)
        maxs = data.max(axis=0)
        mins = data.min(axis=0)
        avgs = data.sum(axis=0) / data.shape[0]
        for i in range(self.FEATURE_NUM - 1):
            data[:, i] = (data[:, i] - avgs[i]) / (maxs[i] - mins[i])
        offset = int(data.shape[0] * 0.8)
        self.data = data[:offset] if self.mode == "train" else data[offset:]

    def __getitem__(self, idx):
        row = self.data[idx]
        return (np.array(row[:-1]).astype(self.dtype),
                np.array(row[-1:]).astype(self.dtype))

    def __len__(self):
        return len(self.data)


class Movielens(Dataset):
    """MovieLens 1M ratings.  Parity: movielens.py:134 — each item is
    (user_id, gender, age, job, movie_id, title_ids, category_ids,
    rating)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        assert mode.lower() in ("train", "test"), mode
        self.mode = mode.lower()
        self.test_ratio = test_ratio
        self.rand_seed = rand_seed
        self.data_file = _require(
            data_file, "ml-1m.zip",
            "https://files.grouplens.org/datasets/movielens/")
        self._load()

    @staticmethod
    def _read(zf, name):
        inner = [n for n in zf.namelist() if n.endswith(name)][0]
        for line in zf.read(inner).decode("latin1").splitlines():
            if line.strip():
                yield line.strip().split("::")

    _TITLE_YEAR = re.compile(r"(.*)\((\d{4})\)$")

    def _load(self):
        categories, titles = {}, {}
        self.movie_info, self.user_info = {}, {}
        with zipfile.ZipFile(self.data_file) as zf:
            for mid, title, cats in self._read(zf, "movies.dat"):
                # reference (movielens.py MovieInfo): strip the trailing
                # '(year)' and lowercase before building the title vocab
                m = self._TITLE_YEAR.match(title)
                words = [w.lower() for w in
                         (m.group(1) if m else title).split()]
                for c in cats.split("|"):
                    categories.setdefault(c, len(categories))
                for w in words:
                    titles.setdefault(w, len(titles))
                self.movie_info[int(mid)] = (
                    int(mid),
                    [categories[c] for c in cats.split("|")],
                    [titles[w] for w in words],
                )
            age_table = [1, 18, 25, 35, 45, 50, 56]  # movielens.py:36
            for uid, gender, age, job, _zip in self._read(zf, "users.dat"):
                self.user_info[int(uid)] = (
                    int(uid), 0 if gender == "M" else 1,
                    age_table.index(int(age)) if int(age) in age_table
                    else len(age_table) - 1,
                    int(job))
            rng = np.random.RandomState(self.rand_seed)
            self.data = []
            for uid, mid, rating, _ts in self._read(zf, "ratings.dat"):
                uid, mid = int(uid), int(mid)
                if uid not in self.user_info or mid not in self.movie_info:
                    continue
                is_test = rng.rand() < self.test_ratio
                if (self.mode == "test") == is_test:
                    self.data.append(
                        self.user_info[uid] + self.movie_info[mid]
                        + (float(rating),))

    def __getitem__(self, idx):
        u = self.data[idx]
        return tuple(np.array(x) for x in u)

    def __len__(self):
        return len(self.data)


_WMT_UNK = "<unk>"
_WMT_START = "<s>"
_WMT_END = "<e>"


class WMT14(Dataset):
    """WMT14 en-fr.  Parity: wmt14.py:88 — archive carries src.dict /
    trg.dict and ``{mode}/{mode}`` tab-separated parallel text; items are
    (src_ids, trg_ids, trg_ids_next)."""

    UNK_IDX = 2

    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=True):
        assert mode.lower() in ("train", "test", "gen"), mode
        self.mode = mode.lower()
        self.dict_size = dict_size
        self.data_file = _require(
            data_file, "wmt14 tar (wmt_shrinked_data)",
            "http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz")
        self._load()

    def _to_dict(self, fd, size):
        out = {}
        for i, line in enumerate(fd):
            if 0 <= size <= i:
                break
            out[line.decode("utf-8", "replace").strip()] = i
        return out

    def _load(self):
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            src_name = [m.name for m in tf if m.name.endswith("src.dict")][0]
            trg_name = [m.name for m in tf if m.name.endswith("trg.dict")][0]
            self.src_dict = self._to_dict(tf.extractfile(src_name),
                                          self.dict_size)
            self.trg_dict = self._to_dict(tf.extractfile(trg_name),
                                          self.dict_size)
            data = f"{self.mode}/{self.mode}"
            for name in [m.name for m in tf if m.name.endswith(data)]:
                for line in tf.extractfile(name):
                    parts = line.decode("utf-8", "replace").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src = [self.src_dict.get(w, self.UNK_IDX)
                           for w in [_WMT_START] + parts[0].split() + [_WMT_END]]
                    trg = [self.trg_dict.get(w, self.UNK_IDX)
                           for w in parts[1].split()]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    self.src_ids.append(src)
                    self.trg_ids.append([self.trg_dict[_WMT_START]] + trg)
                    self.trg_ids_next.append(trg + [self.trg_dict[_WMT_END]])

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)


class WMT16(Dataset):
    """WMT16 en-de (Multi30k).  Parity: wmt16.py:106 — both language dicts
    are built from ``wmt16/train`` in ONE archive pass; items are
    (src_ids, trg_ids, trg_ids_next)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        assert mode.lower() in ("train", "test", "val"), mode
        self.mode = mode.lower()
        self.lang = lang
        self.src_dict_size = src_dict_size
        self.trg_dict_size = trg_dict_size
        self.data_file = _require(
            data_file, "wmt16.tar.gz (Multi30k)",
            "http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz")
        en_dict, de_dict = self._build_dicts(src_dict_size if lang == "en"
                                             else trg_dict_size,
                                             trg_dict_size if lang == "en"
                                             else src_dict_size)
        self.src_dict = en_dict if lang == "en" else de_dict
        self.trg_dict = de_dict if lang == "en" else en_dict
        self._load()

    def _build_dicts(self, en_size, de_size):
        """One pass over wmt16/train building both language vocabs."""
        freqs = (collections.defaultdict(int), collections.defaultdict(int))
        with tarfile.open(self.data_file) as tf:
            name = [m.name for m in tf if m.name.endswith("wmt16/train")][0]
            for line in tf.extractfile(name):
                parts = line.decode("utf-8", "replace").strip().split("\t")
                if len(parts) != 2:
                    continue
                for col in (0, 1):
                    for w in parts[col].split():
                        freqs[col][w] += 1

        def mk(freq, size):
            words = [_WMT_START, _WMT_END, _WMT_UNK] + [
                w for w, _ in sorted(freq.items(), key=lambda x: -x[1])]
            if size > 0:
                words = words[:size]
            return {w: i for i, w in enumerate(words)}

        return mk(freqs[0], en_size), mk(freqs[1], de_size)

    def _load(self):
        start = self.src_dict[_WMT_START]
        end = self.src_dict[_WMT_END]
        unk = self.src_dict[_WMT_UNK]
        src_col = 0 if self.lang == "en" else 1
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            name = [m.name for m in tf
                    if m.name.endswith(f"wmt16/{self.mode}")][0]
            for line in tf.extractfile(name):
                parts = line.decode("utf-8", "replace").strip().split("\t")
                if len(parts) != 2:
                    continue
                src = [start] + [self.src_dict.get(w, unk)
                                 for w in parts[src_col].split()] + [end]
                trg = [self.trg_dict.get(w, unk)
                       for w in parts[1 - src_col].split()]
                self.src_ids.append(src)
                self.trg_ids.append([start] + trg)
                self.trg_ids_next.append(trg + [end])

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)


class Conll05st(Dataset):
    """CoNLL-2005 SRL (test.wsj split; the train split is licensed).

    Parity: conll05.py:99 — items are the 9-slot tuple
    (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_id, mark,
    label_ids): the sentence, five predicate-window context columns, the
    predicate id, the predicate-position mark, and the IOB label ids.
    """

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, emb_file=None,
                 download=True):
        url = "http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz"
        self.data_file = _require(data_file, "conll05st-tests.tar.gz", url)
        self.word_dict = self._load_dict(
            _require(word_dict_file, "wordDict.txt", url))
        self.predicate_dict = self._load_dict(
            _require(verb_dict_file, "verbDict.txt", url))
        self.label_dict = self._load_label_dict(
            _require(target_dict_file, "targetDict.txt", url))
        self._load()

    @staticmethod
    def _load_dict(path):
        with open(path) as f:
            return {line.strip(): i for i, line in enumerate(f)}

    @staticmethod
    def _load_label_dict(path):
        tags = set()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line[:2] in ("B-", "I-"):
                    tags.add(line[2:])
        d = {}
        for tag in sorted(tags):
            d["B-" + tag] = len(d)
            d["I-" + tag] = len(d)
        d["O"] = len(d)
        return d

    @staticmethod
    def _props_to_iob(col):
        """One predicate's bracketed props column -> IOB tags."""
        out, cur, inside = [], "O", False
        for tok in col:
            if tok == "*":
                out.append("I-" + cur if inside else "O")
            elif tok == "*)":
                out.append("I-" + cur)
                inside = False
            elif "(" in tok:
                cur = tok[1:tok.find("*")]
                out.append("B-" + cur)
                inside = ")" not in tok
            else:
                raise ValueError(f"unexpected props token {tok!r}")
        return out

    def _load(self):
        self.sentences, self.predicates, self.labels = [], [], []
        with tarfile.open(self.data_file) as tf:
            words_n = [m.name for m in tf
                       if m.name.endswith("words/test.wsj.words.gz")][0]
            props_n = [m.name for m in tf
                       if m.name.endswith("props/test.wsj.props.gz")][0]
            with gzip.GzipFile(fileobj=tf.extractfile(words_n)) as wf, \
                    gzip.GzipFile(fileobj=tf.extractfile(props_n)) as pf:
                sent, cols = [], []
                for wline, pline in zip(wf, pf):
                    word = wline.decode().strip()
                    props = pline.decode().strip().split()
                    if not props:  # sentence boundary
                        self._emit(sent, cols)
                        sent, cols = [], []
                    else:
                        sent.append(word)
                        cols.append(props)
        # columns are [verb, pred1, pred2, ...] per token

    def _emit(self, sent, cols):
        if not sent:
            return
        n_cols = len(cols[0])
        verbs = [cols[i][0] for i in range(len(sent))
                 if cols[i][0] != "-"]
        for c in range(1, n_cols):
            col = [cols[i][c] for i in range(len(sent))]
            try:
                iob = self._props_to_iob(col)
            except ValueError:
                continue
            if c - 1 < len(verbs):
                self.sentences.append(list(sent))
                self.predicates.append(verbs[c - 1])
                self.labels.append(iob)

    def __getitem__(self, idx):
        words = self.sentences[idx]
        labels = self.labels[idx]
        pred = self.predicates[idx]
        wd, pd, ld = self.word_dict, self.predicate_dict, self.label_dict
        unk = wd.get("<unk>", len(wd) - 1)
        n = len(words)
        # predicate position from the B-V label (the props lemma is NOT the
        # surface form, so words.index(pred) would mis-mark most sentences)
        try:
            p_idx = labels.index("B-V")
        except ValueError:
            p_idx = 0

        def ctx(off):
            j = min(max(p_idx + off, 0), n - 1)
            return wd.get(words[j], unk)

        word_ids = np.array([wd.get(w, unk) for w in words])
        mark = np.array([1 if i == p_idx else 0 for i in range(n)])
        label_ids = np.array([ld.get(l, ld["O"]) for l in labels])
        return (word_ids,
                np.full(n, ctx(-2)), np.full(n, ctx(-1)), np.full(n, ctx(0)),
                np.full(n, ctx(1)), np.full(n, ctx(2)),
                np.full(n, pd.get(pred, 0)), mark, label_ids)

    def __len__(self):
        return len(self.sentences)
