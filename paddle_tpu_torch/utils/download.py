"""The weights cache: ``paddle.utils.download``.

Counterpart of ``paddle_tpu/utils/download.py``, after the reference's
``utils/download.py`` (a URL fetched into an md5-checked cache under
``~/.cache/paddle``).  Nothing is fetched here: a file that is in the
cache and passes its md5 is returned, and a missing one raises with the
path to put it at.
"""

from __future__ import annotations

import hashlib
import os.path as osp

__all__ = ["get_weights_path_from_url"]

WEIGHTS_HOME = osp.expanduser("~/.cache/paddle/hapi/weights")


def _md5check(fullname: str, md5sum: str | None) -> bool:
    if md5sum is None:
        return True
    md5 = hashlib.md5()
    with open(fullname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            md5.update(chunk)
    return md5.hexdigest() == md5sum


def get_path_from_url(url: str, root_dir: str, md5sum: str | None = None,
                      check_exist: bool = True) -> str:
    """``root_dir``'s copy of the file that ``url`` names."""
    fname = osp.split(url)[-1]
    fullname = osp.join(root_dir, fname)
    if osp.exists(fullname) and (not check_exist
                                 or _md5check(fullname, md5sum)):
        return fullname
    raise RuntimeError(
        f"weights file {fname!r} not found in the local cache and this "
        f"environment has no network egress.  Place the file (from {url}) "
        f"at: {fullname}")


def get_weights_path_from_url(url: str, md5sum: str | None = None) -> str:
    """The cached copy of the weights that ``url`` names (the cache is
    only read: nothing is downloaded)."""
    return get_path_from_url(url, WEIGHTS_HOME, md5sum)
