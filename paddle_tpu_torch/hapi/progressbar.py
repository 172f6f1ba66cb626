"""The progress bar of hapi's fit loops.

Counterpart of ``paddle_tpu/hapi/progressbar.py``: one line a step,
``step i/n - name: value ...``, ended by a newline at the last step.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self.file = file
        self._start = time.time()

    def update(self, current_num, values=None):
        if self._verbose == 0:
            return
        values = values or []
        msg = f"step {current_num}"
        if self._num:
            msg += f"/{self._num}"
        for k, v in values:
            if isinstance(v, (list, tuple)):
                v = v[0]
            msg += f" - {k}: {v:.4f}" if isinstance(v, float) else f" - {k}: {v}"
        end = "\n" if (self._num and current_num >= self._num) else "\r"
        print(msg, end=end, file=self.file, flush=True)
