"""``paddle.hub``: models from a repository's ``hubconf.py``.

Counterpart of ``paddle_tpu/hub.py``, after the reference's
``hapi/hub.py`` (``list`` / ``help`` / ``load`` call a ``hubconf.py``'s
entry points).  ``source="local"`` (a directory that holds the
``hubconf.py``) works; the github and gitee sources need the network,
which this build does not use, and raise saying so.
"""

from __future__ import annotations

import importlib.util
import os
import sys

__all__ = ["list", "help", "load"]

_HUBCONF = "hubconf.py"


def _load_local(repo_dir: str):
    path = os.path.join(repo_dir, _HUBCONF)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_HUBCONF} under {repo_dir}")
    spec = importlib.util.spec_from_file_location("paddle_tpu_torch_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["paddle_tpu_torch_hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def _resolve(repo_dir: str, source: str):
    if source == "local":
        return _load_local(repo_dir)
    raise RuntimeError(
        f"paddle.hub source={source!r} needs network egress, which this "
        "build does not have; clone the repo and use source='local'")


def list(repo_dir: str, source: str = "github", force_reload: bool = False):
    """Entrypoint names exported by the repo's hubconf.py."""
    mod = _resolve(repo_dir, source)
    return [k for k, v in vars(mod).items()
            if callable(v) and not k.startswith("_")]


def help(repo_dir: str, model: str, source: str = "github",
         force_reload: bool = False):
    mod = _resolve(repo_dir, source)
    return getattr(mod, model).__doc__


def load(repo_dir: str, model: str, *args, source: str = "github",
         force_reload: bool = False, **kwargs):
    mod = _resolve(repo_dir, source)
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"no callable entrypoint {model!r} in {_HUBCONF}")
    return fn(*args, **kwargs)
