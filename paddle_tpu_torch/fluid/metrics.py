"""``paddle.fluid.metrics``: host-side accumulators (Accuracy,
Precision, Recall, Auc) fed with fetched values."""

from __future__ import annotations

import numpy as np

from ..metric import Accuracy as _Acc2, Auc as _Auc2  # noqa: F401


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *a, **k):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    """fluid accumulator form: update(value=batch_acc, weight=batch_size)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight=1):
        self.value += float(np.asarray(value).sum()) * weight
        self.weight += weight

    def eval(self):
        return self.value / max(self.weight, 1e-12)


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        return self.tp / max(self.tp + self.fp, 1e-12)


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        return self.tp / max(self.tp + self.fn, 1e-12)


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._auc = _Auc2(curve=curve, num_thresholds=num_thresholds)

    def reset(self):
        self._auc.reset()

    def update(self, preds, labels):
        self._auc.update(np.asarray(preds), np.asarray(labels))

    def eval(self):
        return self._auc.accumulate()
