"""Python 2/3 compatibility helpers: ``paddle.compat``.

Counterpart of ``paddle_tpu/compat.py``, after the reference's
``compat.py`` (``to_text``, ``to_bytes``, ``round``, ``floor_division``,
``get_exception_message``), which user code and the reference's tools
import.
"""

import math

__all__ = []


def to_text(obj, encoding="utf-8", inplace=False):
    """Convert ``obj`` (bytes/str or a container of them) to str."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            for i, v in enumerate(obj):
                obj[i] = _to_text(v, encoding)
            return obj
        return [_to_text(v, encoding) for v in obj]
    if isinstance(obj, set):
        if inplace:
            for v in list(obj):
                obj.remove(v)
                obj.add(_to_text(v, encoding))
            return obj
        return {_to_text(v, encoding) for v in obj}
    if isinstance(obj, dict):
        if inplace:
            new_obj = {_to_text(k, encoding): _to_text(v, encoding)
                       for k, v in obj.items()}
            obj.clear()
            obj.update(new_obj)
            return obj
        return {_to_text(k, encoding): _to_text(v, encoding)
                for k, v in obj.items()}
    return _to_text(obj, encoding)


def _to_text(obj, encoding):
    if obj is None:
        return obj
    if isinstance(obj, bytes):
        return obj.decode(encoding)
    if isinstance(obj, str):
        return obj
    if isinstance(obj, (bool, float)):
        return obj
    return str(obj)


def to_bytes(obj, encoding="utf-8", inplace=False):
    """Convert ``obj`` (str/bytes or a container of them) to bytes."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            for i, v in enumerate(obj):
                obj[i] = _to_bytes(v, encoding)
            return obj
        return [_to_bytes(v, encoding) for v in obj]
    if isinstance(obj, set):
        if inplace:
            for v in list(obj):
                obj.remove(v)
                obj.add(_to_bytes(v, encoding))
            return obj
        return {_to_bytes(v, encoding) for v in obj}
    return _to_bytes(obj, encoding)


def _to_bytes(obj, encoding):
    if obj is None:
        return obj
    assert encoding is not None
    if isinstance(obj, str):
        return obj.encode(encoding)
    if isinstance(obj, bytes):
        return obj
    return str(obj).encode(encoding)


def round(x, d=0):
    """Python-2-style half-away-from-zero rounding."""
    if x is None:
        return x
    p = 10 ** d
    if x >= 0:
        return float(math.floor((x * p) + math.copysign(0.5, x))) / p
    return float(math.ceil((x * p) + math.copysign(0.5, x))) / p


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    assert exc is not None
    return str(exc)
