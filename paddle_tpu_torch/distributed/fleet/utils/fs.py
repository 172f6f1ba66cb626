"""File systems for checkpoints and data: ``FS``, ``LocalFS`` and
``HDFSClient``.

Counterpart of ``paddle_tpu/distributed/fleet/utils/fs.py``.  ``LocalFS``
serves a local or shared mount; ``HDFSClient`` runs ``hadoop fs -<cmd>``
for every operation, with its ``configs`` as ``-D`` options: the
``hadoop`` of ``hadoop_home/bin``, or the one on ``PATH`` without
``hadoop_home``.  Without one, construction raises.
"""

from __future__ import annotations

import os
import shutil
from typing import List

__all__ = [
    "ExecuteError", "FSFileExistsError", "FSFileNotExistsError", "FSTimeOut",
    "FSShellCmdAborted", "FS", "LocalFS", "HDFSClient",
]


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FSShellCmdAborted(ExecuteError):
    pass


class FS:
    """The operations every file system gives."""

    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def cat(self, fs_path=None):
        raise NotImplementedError


class LocalFS(FS):
    """A local or shared-mount file system."""

    def ls_dir(self, fs_path):
        """``([dirs], [files])`` under ``fs_path``, sorted."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            if os.path.isdir(os.path.join(fs_path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def list_dirs(self, fs_path) -> List[str]:
        return self.ls_dir(fs_path)[0]

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        elif self.is_file(fs_path):
            os.remove(fs_path)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        # the checks hold whatever test_exists says: callers detect a
        # concurrent writer by FSFileExistsError
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if not overwrite and self.is_exist(dst_path):
            raise FSFileExistsError(dst_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        os.rename(src_path, dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            os.utime(fs_path, None)
            return
        with open(fs_path, "a"):
            pass

    def cat(self, fs_path=None):
        with open(fs_path, "r") as f:
            return f.read()

    def upload(self, local_path, fs_path):
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        shutil.copy(fs_path, local_path)

    def need_upload_download(self):
        return False


class HDFSClient(FS):
    """``hadoop fs`` in a subprocess for every operation (see the module
    docstring); ``time_out`` and ``sleep_inter`` in milliseconds, as the
    reference's."""

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        if hadoop_home:
            self._hadoop = os.path.join(hadoop_home, "bin", "hadoop")
        else:
            self._hadoop = shutil.which("hadoop") or "hadoop"
        self._timeout = max(time_out / 1000.0, 1.0)
        self._configs = []
        for k, v in (configs or {}).items():
            self._configs += ["-D", f"{k}={v}"]
        if not os.path.exists(self._hadoop):
            raise RuntimeError(
                "HDFSClient needs a hadoop CLI (hadoop_home/bin/hadoop, or "
                "hadoop on PATH) and found none; LocalFS serves a shared "
                "mount")

    def _run(self, *args, ok_codes=(0,), binary=False):
        import subprocess

        cmd = [self._hadoop, "fs"] + self._configs + list(args)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=not binary,
                                  timeout=self._timeout)
        except subprocess.TimeoutExpired as e:
            raise FSTimeOut(f"{' '.join(cmd)} timed out") from e
        if proc.returncode not in ok_codes:
            err = proc.stderr
            if binary:
                err = err.decode("utf-8", "replace")
            raise ExecuteError(
                f"{' '.join(cmd)} failed (rc={proc.returncode}): "
                f"{err.strip()[:500]}")
        return proc.returncode, proc.stdout

    def ls_dir(self, fs_path):
        """``(dirs, files)`` under ``fs_path``, from ``hadoop fs -ls``'s
        rows."""
        if not self.is_exist(fs_path):
            return [], []
        _, out = self._run("-ls", fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8 or parts[0] == "Found":
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def _test(self, flag, fs_path) -> bool:
        rc, _ = self._run("-test", flag, fs_path, ok_codes=(0, 1))
        return rc == 0

    def is_file(self, fs_path):
        return self._test("-f", fs_path)

    def is_dir(self, fs_path):
        return self._test("-d", fs_path)

    def is_exist(self, fs_path):
        return self._test("-e", fs_path)

    def upload(self, local_path, fs_path, multi_processes=1, overwrite=False):
        if not os.path.exists(local_path):
            raise FSFileNotExistsError(local_path)
        if not overwrite:
            if self.is_exist(fs_path):
                raise FSFileExistsError(fs_path)
            # a plain -put: a writer that raced past is_exist fails loudly
            self._run("-put", local_path, fs_path)
            return
        if self.is_dir(fs_path):
            # '-put -f file dir' would put the file inside the directory
            self.delete(fs_path)
        # -put -f replaces a file in one step
        self._run("-put", "-f", local_path, fs_path)

    def download(self, fs_path, local_path, multi_processes=1,
                 overwrite=False):
        if not self.is_exist(fs_path):
            raise FSFileNotExistsError(fs_path)
        if os.path.exists(local_path) and overwrite:
            if os.path.isdir(local_path):
                shutil.rmtree(local_path)
            else:
                os.remove(local_path)
        self._run("-get", fs_path, local_path)

    def mkdirs(self, fs_path):
        if not self.is_exist(fs_path):
            self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        if self.is_exist(fs_path):
            self._run("-rm", "-r", "-f", fs_path)

    def mv(self, fs_src_path, fs_dst_path, overwrite=False, test_exists=True):
        if test_exists and not self.is_exist(fs_src_path):
            raise FSFileNotExistsError(fs_src_path)
        if overwrite and self.is_exist(fs_dst_path):
            self.delete(fs_dst_path)
        self._run("-mv", fs_src_path, fs_dst_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        self._run("-touchz", fs_path)

    def cat(self, fs_path, binary=False):
        """The file's contents: bytes with ``binary=True``, else text
        decoded with replacement characters (a binary file never raises
        UnicodeDecodeError)."""
        if not self.is_exist(fs_path):
            return b"" if binary else ""
        _, out = self._run("-cat", fs_path, binary=True)
        return out if binary else out.decode("utf-8", "replace")

    def need_upload_download(self):
        return True
