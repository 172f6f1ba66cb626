"""Unique name generator: the counters that name parameters
(``linear_0.w_0``) and so the keys of the optimizer's state dict.

Counterpart of ``paddle_tpu/framework/unique_name.py``
(``UniqueNameGenerator``, ``generate``, ``guard``, ``switch``), counting
as it does.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.ids = defaultdict(int)
        self.prefix = prefix

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{tmp}"


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def switch(new_generator: UniqueNameGenerator | None = None) -> UniqueNameGenerator:
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
