"""The flags the port reads, bootstrapped from ``FLAGS_*`` environment
variables: the port's own copy of the two live flags of
``paddle_tpu/framework/flags.py`` that its profiler reads.

* ``FLAGS_benchmark``: a :class:`~paddle_tpu_torch.profiler.RecordEvent`
  synchronizes the CUDA card before it closes, so its host span measures
  the card's work and not the asynchronous enqueue (the reference blocks
  on every eager op for the same reason);
* ``FLAGS_profiler_logdir``: where :func:`~paddle_tpu_torch.profiler.
  start_profiler` writes the device trace (under the temporary directory
  by default).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

_DEFAULTS: Dict[str, Any] = {
    "FLAGS_benchmark": False,
    "FLAGS_profiler_logdir": os.path.join(tempfile.gettempdir(),
                                          "paddle_tpu_torch_profile"),
}
_VALUES: Dict[str, Any] = {}


def _parse(name: str, raw: Any) -> Any:
    if isinstance(_DEFAULTS[name], bool):
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return type(_DEFAULTS[name])(raw)


for _name, _default in _DEFAULTS.items():
    _env = os.environ.get(_name)
    _VALUES[_name] = _parse(_name, _env) if _env is not None else _default


def flag(name: str) -> Any:
    """A flag's value (KeyError on an unknown flag)."""
    return _VALUES[name]


def set_flags(flags: Dict[str, Any]) -> None:
    """``paddle.set_flags``: update flags by name."""
    if not isinstance(flags, dict):
        raise TypeError("set_flags expects a dict of {flag_name: value}")
    for n, v in flags.items():
        if n not in _VALUES:
            raise ValueError(f"Flag {n!r} is not registered")
        _VALUES[n] = _parse(n, v)
