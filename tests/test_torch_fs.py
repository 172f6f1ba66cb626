"""The port's ``fleet.utils.fs`` (``LocalFS``, ``HDFSClient``) against the
reference's, on the CPU.

Each scenario runs once with each package's module and the transcripts
(return values, raised exception types, the file tree left behind) must
be equal.  ``HDFSClient`` runs a fake ``hadoop`` (a bash script over a
sandbox directory that logs each call): none is installed here.  The
port also finds ``hadoop`` on ``PATH`` when no ``hadoop_home`` is given,
and both raise without one.
"""

import os
import stat

import pytest

from paddle_tpu.distributed.fleet.utils import fs as jfs

from paddle_tpu_torch.distributed.fleet.utils import fs as tfs

_FAKE_HADOOP = r"""#!/bin/bash
# fake `hadoop fs` over a local sandbox: $HDFS_SANDBOX prefixes every path
echo "$@" >> "$HDFS_SANDBOX.calls"
shift  # drop "fs"
while [ "$1" = "-D" ]; do shift 2; done
cmd="$1"; shift
p() { echo "$HDFS_SANDBOX/$1"; }
case "$cmd" in
  -test)
    flag="$1"; tgt=$(p "$2")
    case "$flag" in
      -e) [ -e "$tgt" ] ;;
      -f) [ -f "$tgt" ] ;;
      -d) [ -d "$tgt" ] ;;
    esac ;;
  -ls)
    ls -l "$(p "$1")" | while read -r mode n u g s m1 m2 m3 name; do
      [ -z "$name" ] && continue
      echo "$mode $n $u $g $s $m1 $m2 $m3 $name"
    done ;;
  -mkdir) [ "$1" = "-p" ] && shift; mkdir -p "$(p "$1")" ;;
  -put) force=0; [ "$1" = "-f" ] && { force=1; shift; }
        if [ -e "$(p "$2")" ] && [ $force = 0 ]; then
          echo "put: exists" >&2; exit 1; fi
        cp -r "$1" "$(p "$2")" ;;
  -get) cp -r "$(p "$1")" "$2" ;;
  -rm) [ "$1" = "-r" ] && shift; [ "$1" = "-f" ] && shift; rm -rf "$(p "$1")" ;;
  -mv) mv "$(p "$1")" "$(p "$2")" ;;
  -touchz) touch "$(p "$1")" ;;
  -cat) cat "$(p "$1")" ;;
  *) echo "unknown $cmd" >&2; exit 2 ;;
esac
"""


def _tree(root):
    out = []
    for d, dirs, files in sorted(os.walk(root)):
        rel = os.path.relpath(d, root)
        out += [(rel, f, open(os.path.join(d, f), "rb").read())
                for f in sorted(files)]
        out += [(rel, x + "/") for x in sorted(dirs)]
    return out


def _call(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except Exception as e:          # the transcript records the type
        return ("raised", type(e).__name__)


def _local_scenario(fs, root):
    c, t = fs.LocalFS(), []
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    t.append(_call(c.mkdirs, os.path.join(a, "inner")))
    t.append(_call(c.touch, os.path.join(a, "f")))
    t.append(_call(c.touch, os.path.join(a, "f"), exist_ok=False))
    with open(os.path.join(a, "g"), "w") as f:
        f.write("text")
    t += [_call(c.ls_dir, a), _call(c.list_dirs, a), _call(c.cat,
          os.path.join(a, "g")), _call(c.is_file, a), _call(c.is_dir, a),
          _call(c.is_exist, b), _call(c.ls_dir, b)]
    t.append(_call(c.mv, os.path.join(a, "g"), os.path.join(a, "f")))
    t.append(_call(c.mv, os.path.join(a, "g"), os.path.join(a, "f"),
                   overwrite=True))
    t.append(_call(c.mv, os.path.join(a, "missing"), b))
    t.append(_call(c.rename, a, b))
    t.append(_call(c.upload, os.path.join(b, "f"), os.path.join(b, "h")))
    t.append(_call(c.download, os.path.join(b, "h"), os.path.join(b, "i")))
    t.append(_call(c.delete, os.path.join(b, "inner")))
    t.append(_call(c.need_upload_download))
    return t, _tree(root)


def test_local_fs_matches_reference(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _local_scenario(jfs, str(tmp_path / "ref"))
    got = _local_scenario(tfs, str(tmp_path / "port"))
    assert got == want


def _fake(tmp_path, name):
    home = tmp_path / f"{name}_home"
    (home / "bin").mkdir(parents=True)
    script = home / "bin" / "hadoop"
    script.write_text(_FAKE_HADOOP)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    sandbox = tmp_path / f"{name}_sandbox"
    sandbox.mkdir()
    return str(home), sandbox


def _hdfs_scenario(fs, home, sandbox, tmp, monkeypatch):
    monkeypatch.setenv("HDFS_SANDBOX", str(sandbox))
    c = fs.HDFSClient(hadoop_home=home, configs={
        "fs.default.name": "hdfs://x", "hadoop.job.ugi": "u"})
    t = [_call(c.mkdirs, "data/inner"), _call(c.is_exist, "data"),
         _call(c.is_dir, "data"), _call(c.is_file, "data")]
    local = tmp / "payload.txt"
    local.write_text("hello hdfs")
    blob = tmp / "blob.bin"
    blob.write_bytes(bytes(range(256)))
    t += [_call(c.upload, str(local), "data/payload.txt"),
          _call(c.upload, str(local), "data/payload.txt"),
          _call(c.upload, str(blob), "data/payload.txt", overwrite=True),
          _call(c.cat, "data/payload.txt", binary=True),
          _call(c.upload, str(local), "data/payload.txt", overwrite=True),
          _call(c.is_file, "data/payload.txt"),
          _call(c.cat, "data/payload.txt"), _call(c.cat, "data/none"),
          _call(c.ls_dir, "data"), _call(c.ls_dir, "none")]
    back = tmp / "back.txt"
    t += [_call(c.download, "data/payload.txt", str(back)),
          back.read_text(),
          _call(c.download, "data/missing.txt", str(back)),
          _call(c.mv, "data/payload.txt", "data/renamed.txt"),
          _call(c.mv, "data/payload.txt", "data/x"),
          _call(c.is_exist, "data/payload.txt"),
          _call(c.touch, "data/flag"), _call(c.touch, "data/flag",
                                             exist_ok=False),
          _call(c.upload, str(local), "data/inner", overwrite=True),
          _call(c.is_file, "data/inner"), _call(c.delete, "data/flag"),
          _call(c.need_upload_download)]
    calls = open(f"{sandbox}.calls").read().replace(home, "HOME")
    return t, _tree(sandbox), calls.replace(str(tmp), "TMP")


def test_hdfs_client_matches_reference(tmp_path, monkeypatch):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    jh, js = _fake(tmp_path / "r", "hadoop")
    th, ts = _fake(tmp_path / "p", "hadoop")
    want = _hdfs_scenario(jfs, jh, js, tmp_path / "r", monkeypatch)
    got = _hdfs_scenario(tfs, th, ts, tmp_path / "p", monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2].replace("/p/", "/r/") == want[2]
    assert "-put -f" in got[2] and "-D fs.default.name=hdfs://x" in got[2]


def test_hdfs_client_finds_hadoop_on_path_and_raises_without(tmp_path,
                                                             monkeypatch):
    home, sandbox = _fake(tmp_path, "onpath")
    monkeypatch.setenv("HDFS_SANDBOX", str(sandbox))
    monkeypatch.setenv("PATH", os.path.join(home, "bin") + os.pathsep
                       + os.environ.get("PATH", ""))
    c = tfs.HDFSClient()
    c.mkdirs("x")
    assert c.is_dir("x") and (sandbox / "x").is_dir()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for fs in (tfs, jfs):
        with pytest.raises(RuntimeError, match="hadoop CLI"):
            fs.HDFSClient(hadoop_home=str(tmp_path / "nope"))
    with pytest.raises(RuntimeError, match="hadoop CLI"):
        tfs.HDFSClient()
    assert sorted(tfs.__all__) == sorted(jfs.__all__)
