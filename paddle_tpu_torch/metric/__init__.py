"""``paddle.metric``: Accuracy, Precision, Recall and Auc.

Counterpart of ``paddle_tpu/metric/__init__.py``, name for name and
decision for decision: the metrics keep their state on the host in numpy,
as the reference's do, and take port Tensors, torch tensors or numpy
arrays (a tensor on the card is read back once an update).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if hasattr(x, "numpy"):
        if hasattr(x, "detach"):        # a torch tensor
            return x.detach().cpu().numpy()
        return x.numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, *args):
        """Pre-processing of (pred, label) whose result ``update`` takes;
        the identity by default."""
        return args


class Accuracy(Metric):
    """Top-k accuracy: ``compute`` marks where each row's k best
    predictions hit the label, ``update`` counts the hits."""

    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        if label.ndim == 1:
            label = label[:, None]
        idx = np.argsort(-pred, axis=-1)[:, : self.maxk]
        return idx == label

    def update(self, correct, *args):
        correct = _np(correct)
        res = []
        for i, k in enumerate(self.topk):
            num = correct[:, :k].any(axis=-1).sum()
            self.total[i] += float(num)
            self.count[i] += correct.shape[0]
            res.append(float(num) / correct.shape[0])
        return res[0] if len(res) == 1 else res

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of predictions thresholded at 0.5."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("int64").reshape(-1)
        labels = _np(labels).astype("int64").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0


class Recall(Metric):
    """Binary recall of predictions thresholded at 0.5."""

    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype("int64").reshape(-1)
        labels = _np(labels).astype("int64").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0


class Auc(Metric):
    """ROC AUC over ``num_thresholds + 1`` buckets of the positive class's
    probability (column 1 of a two-column prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2:
            preds = preds[:, 1] if preds.shape[1] > 1 else preds[:, 0]
        idx = np.clip((preds * self.num_thresholds).astype("int64"), 0,
                      self.num_thresholds)
        pos = labels.astype(bool)
        np.add.at(self._stat_pos, idx[pos], 1)
        np.add.at(self._stat_neg, idx[~pos], 1)

    def accumulate(self):
        tot_pos = tot_neg = auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            auc += self._stat_neg[i] * (tot_pos + self._stat_pos[i] / 2)
            tot_pos += self._stat_pos[i]
            tot_neg += self._stat_neg[i]
        d = tot_pos * tot_neg
        return auc / d if d else 0.0


def accuracy(input, label, k=1):
    from ..nn import functional as F

    return F.accuracy(input, label, k)
