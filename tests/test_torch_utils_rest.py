"""The rest of the port's utilities against the JAX package's, on the CPU:
``framework.crypto``, ``utils`` (``deprecated``, ``try_import``,
``require_version``, ``run_check``, ``download``, the custom C++ ops of
``cpp_extension``), ``fluid.install_check``, ``hub``, ``compat``,
``sysconfig``, ``version`` and ``linalg``.

Crypto mirrors ``tests/test_crypto_mp_dp.py:13-60`` (the clear error is
checked with ``cryptography`` hidden from the import system, since it is
installed here).  The custom ops mirror ``tests/test_custom_op.py`` (5
cases): one g++ compile of ``tests/custom_op_src/relu2_op.cc`` (a
module-scoped fixture) is loaded into both packages, and the port's
forward, gradient and static program are held to the JAX package's bit
for bit (the same C++ runs on the same host values).  ``linalg`` is held
to the JAX package's at 1e-5 relative (LAPACK and XLA's decompositions
round differently).
"""

import hashlib
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.compat as jcompat
import paddle_tpu.version as jversion
from paddle_tpu.utils import cpp_extension as jcpp

import paddle_tpu_torch as tp
from paddle_tpu_torch import compat as tcompat
from paddle_tpu_torch import hub as thub
from paddle_tpu_torch import sysconfig as tsysconfig
from paddle_tpu_torch import utils as tutils
from paddle_tpu_torch import version as tversion
from paddle_tpu_torch.framework import crypto
from paddle_tpu_torch.utils import cpp_extension as tcpp
from paddle_tpu_torch.utils import download

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "custom_op_src", "relu2_op.cc")


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


# -- crypto -------------------------------------------------------------------


def test_cipher_errors_clearly_without_cryptography(monkeypatch):
    key = crypto.CipherUtils.gen_key(256)   # needs no cryptography
    assert len(key) == 32
    for mod in ("cryptography", "cryptography.hazmat.primitives.ciphers.aead"):
        monkeypatch.setitem(sys.modules, mod, None)
    assert not crypto.is_available()
    with pytest.raises(ImportError, match="cryptography"):
        crypto.Cipher().encrypt(b"payload", key)


def test_cipher_roundtrip(tmp_path):
    pytest.importorskip("cryptography")
    import paddle_tpu.framework.crypto as jcrypto

    key = crypto.CipherUtils.gen_key(256)
    c = crypto.CipherFactory.create_cipher()
    msg = b"model bytes \x00\x01" * 100
    ct = c.encrypt(msg, key)
    assert ct != msg and c.decrypt(ct, key) == msg
    # the two packages read each other's ciphertext
    assert jcrypto.Cipher().decrypt(ct, key) == msg
    assert c.Decrypt(jcrypto.Cipher().encrypt(msg, key), key) == msg
    with pytest.raises(Exception):
        c.decrypt(ct, crypto.CipherUtils.gen_key(256))
    kf = str(tmp_path / "key")
    key2 = crypto.CipherUtils.gen_key_to_file(128, kf)
    assert crypto.CipherUtils.read_key_from_file(kf) == key2
    mf = str(tmp_path / "model.enc")
    c.encrypt_to_file(msg, key2, mf)
    assert c.decrypt_from_file(key2, mf) == msg
    with pytest.raises(ValueError):
        c.encrypt(msg, b"short")
    cfg = tmp_path / "cipher.conf"
    cfg.write_text("cipher_name: AES_CTR_NoPadding\n")
    with pytest.raises(NotImplementedError):
        crypto.CipherFactory.create_cipher(str(cfg))
    tp.seed(0)
    net = tp.nn.Linear(4, 2)
    sd = str(tmp_path / "m.pdparams")
    tp.save(net.state_dict(), sd)
    c.encrypt_to_file(open(sd, "rb").read(), key, sd + ".enc")
    assert c.decrypt_from_file(key, sd + ".enc") == open(sd, "rb").read()


# -- utils --------------------------------------------------------------------


def test_deprecated_try_import_require_version():
    @tutils.deprecated(update_to="paddle.new_api", since="2.0")
    def old(x):
        """Doc."""
        return x + 1

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert old(1) == 2
    assert w and issubclass(w[0].category, DeprecationWarning)
    assert "paddle.new_api" in str(w[0].message) and "2.0" in old.__doc__
    assert tutils.try_import("json") is __import__("json")
    with pytest.raises(ImportError, match="pip install no_such_mod"):
        tutils.try_import("no_such_mod")
    with pytest.raises(ImportError, match="custom"):
        tutils.try_import("no_such_mod", "custom")
    tutils.require_version("0.0.1")
    tutils.require_version("0.1", "1.0")
    with pytest.raises(Exception, match="VersionError"):
        tutils.require_version("99.0")
    with pytest.raises(Exception, match="VersionError"):
        tutils.require_version("0.0.1", "0.0.2")
    for name in ("deprecated", "run_check", "require_version", "try_import",
                 "download", "cpp_extension", "load_op_library",
                 "unique_name", "Profiler", "ProfilerOptions",
                 "get_profiler"):
        assert hasattr(tutils, name), name
    assert tutils.__all__ == jp.utils.__all__


def test_run_check_and_fluid_install_check(capsys):
    tutils.run_check()
    tp.fluid.install_check()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and all("installed successfully" in s for s in out)
    assert ("gpu:0" if torch.cuda.is_available() else "cpu") in out[0]


def test_download_checks_md5_and_fetches_nothing(tmp_path, monkeypatch):
    import paddle_tpu.utils.download as jdownload

    url = "https://example.invalid/weights/lenet.pdparams"
    f = tmp_path / "lenet.pdparams"
    f.write_bytes(b"weights" * 10)
    md5 = hashlib.md5(f.read_bytes()).hexdigest()
    for d in (download, jdownload):
        assert d.get_path_from_url(url, str(tmp_path), md5) == str(f)
        assert d.get_path_from_url(url, str(tmp_path)) == str(f)
        with pytest.raises(RuntimeError, match="no network egress"):
            d.get_path_from_url(url, str(tmp_path), "0" * 32)
        assert d.get_path_from_url(url, str(tmp_path), "0" * 32,
                                   check_exist=False) == str(f)
    monkeypatch.setattr(download, "WEIGHTS_HOME", str(tmp_path))
    assert download.get_weights_path_from_url(url, md5) == str(f)
    with pytest.raises(RuntimeError, match=str(tmp_path / "other.pd")):
        download.get_weights_path_from_url(
            "https://example.invalid/other.pd")


# -- hub, compat, sysconfig, version, linalg ----------------------------------


def test_hub_from_a_local_hubconf(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "def tiny(n=2):\n    '''A tiny entry point.'''\n    return n * 2\n\n"
        "def _private():\n    return 0\n\nVALUE = 3\n")
    assert thub.list(str(tmp_path), source="local") == jp.hub.list(
        str(tmp_path), source="local") == ["tiny"]
    assert thub.help(str(tmp_path), "tiny", source="local") == \
        "A tiny entry point."
    assert thub.load(str(tmp_path), "tiny", 5, source="local") == 10
    with pytest.raises(RuntimeError, match="no callable entrypoint"):
        thub.load(str(tmp_path), "VALUE", source="local")
    for source in ("github", "gitee"):
        with pytest.raises(RuntimeError, match="network egress"):
            thub.list(str(tmp_path), source=source)
    with pytest.raises(FileNotFoundError):
        thub.list(str(tmp_path / "none"), source="local")


def test_compat_matches_reference():
    samples = [b"abc", "abc", ["a", b"b"], {b"k": "v"}, {"x", b"y"}, 3,
               None, 1.5]
    for s in samples:
        assert tcompat.to_text(s) == jcompat.to_text(s)
        if not isinstance(s, dict):
            assert tcompat.to_bytes(s) == jcompat.to_bytes(s)
    lst = [b"a", "b"]
    assert tcompat.to_text(lst, inplace=True) is lst and lst == ["a", "b"]
    for x, d in ((2.5, 0), (-2.5, 0), (1.25, 1), (-0.35, 1), (None, 0)):
        assert tcompat.round(x, d) == jcompat.round(x, d)
    assert tcompat.floor_division(7, 2) == 3
    assert tcompat.get_exception_message(ValueError("m")) == "m"


def test_sysconfig_and_version():
    inc = tsysconfig.get_include()
    assert os.path.isfile(os.path.join(inc, "paddle_tpu_ext.h"))
    assert inc == tcpp.get_include()
    from paddle_tpu_torch.kernels._build import BUILD_DIR

    assert tsysconfig.get_lib() == str(BUILD_DIR)
    names = {n for n in vars(jversion) if not n.startswith("_")}
    assert all(hasattr(tversion, n) for n in names)
    assert tversion.cuda() == (torch.version.cuda or "False")
    cudnn = torch.backends.cudnn.version()
    assert tversion.cudnn() == tversion.cudnn_version == (
        str(cudnn) if cudnn else "False")
    assert tp.version is tversion and tp.__version__ == jp.__version__
    for name in ("text", "dataset", "distribution", "linalg", "onnx", "hub",
                 "compat", "sysconfig", "version", "utils"):
        assert hasattr(tp, name), name


def test_linalg_matches_reference():
    r = np.random.RandomState(0)
    a = r.randn(5, 5).astype("float32")
    spd = (a @ a.T + 5 * np.eye(5)).astype("float32")
    assert tp.linalg.__all__ == jp.linalg.__all__
    for name, x in (("cholesky", spd), ("inv", spd), ("norm", a)):
        want = getattr(jp.linalg, name)(jp.to_tensor(x)).numpy()
        got = getattr(tp.linalg, name)(tp.to_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- custom C++ ops (tests/test_custom_op.py) ---------------------------------


@pytest.fixture(scope="module")
def ext(tmp_path_factory):
    build = str(tmp_path_factory.mktemp("custom_op_build"))
    t = tcpp.load("relu2_ext", [SRC], build_directory=build)
    j = jcpp.load_op_library(t._library_path)
    return j, t


def test_forward_matches_reference(ext):
    j, t = ext
    x = np.random.RandomState(0).randn(4, 5).astype("float32")
    out = t.relu2(tp.to_tensor(x)).numpy()
    np.testing.assert_array_equal(out, np.maximum(x, 0))
    np.testing.assert_array_equal(out, np.asarray(j.relu2(
        jp.to_tensor(x)).numpy()))
    np.testing.assert_array_equal(t.scale3(tp.to_tensor(x)).numpy(),
                                  np.asarray(j.scale3(jp.to_tensor(x))
                                             .numpy()))


def test_backward_through_custom_op(ext):
    j, t = ext
    x_np = np.random.RandomState(1).randn(3, 4).astype("float32")
    grads = []
    for P, e in ((jp, j), (tp, t)):
        x = P.to_tensor(x_np, stop_gradient=False)
        (e.relu2(x * 2.0) * 0.5).sum().backward()
        grads.append(np.asarray(x.grad.numpy()))
    np.testing.assert_array_equal(grads[1], grads[0])
    np.testing.assert_array_equal(grads[1],
                                  np.where(x_np > 0, 1.0, 0.0) * 1.0)
    # scale3 exports no backward: no gradient flows through it
    x = tp.to_tensor(x_np, stop_gradient=False)
    assert t.scale3(x).stop_gradient


def test_static_mode_custom_op(ext):
    from paddle_tpu_torch.framework.scope import Scope

    _, t = ext
    xs = np.random.RandomState(3).randn(2, 4).astype("float32")
    tp.enable_static()
    try:
        main, startup = tp.static.Program(), tp.static.Program()
        with tp.static.program_guard(main, startup):
            xv = tp.static.data("x", [None, 4], "float32")
            xv.stop_gradient = False
            out = t.relu2(xv)
            loss = tp.mean(out)
            tp.static.append_backward(loss)
        assert [op.type for op in main.global_block().ops][:1] == ["relu2"]
        res, gx = tp.static.Executor(tp.CPUPlace()).run(
            main, feed={"x": xs}, fetch_list=[out, "x@GRAD"], scope=Scope())
    finally:
        tp.disable_static()
    np.testing.assert_array_equal(res, np.maximum(xs, 0))
    np.testing.assert_allclose(gx, (xs > 0) / xs.size, rtol=1e-6)


def test_build_cache_and_the_collision_guard(ext, tmp_path):
    _, t = ext
    first = t._library_path
    again = tcpp.load("relu2_ext", [SRC],
                      build_directory=os.path.dirname(first))
    assert again._library_path == first
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build failed"):
        tcpp.load("bad_ext", [str(bad)], build_directory=str(tmp_path))
    clash = tmp_path / "clash.cc"
    clash.write_text(
        '#include "paddle_tpu_ext.h"\nextern "C" {\nPT_EXPORT_OPS("relu")\n'
        "int pt_relu_num_outputs(void) { return 1; }\n}\n")
    with pytest.raises(ValueError, match="built-in"):
        tcpp.load("clash_ext", [str(clash)], build_directory=str(tmp_path))
    with pytest.raises(NotImplementedError, match="cpp_extension"):
        tp.fluid.load_op_library(first)


def test_custom_op_on_a_card_tensor_returns_to_it(ext, monkeypatch):
    """A tensor on another device than the host is copied over for the
    call and the outputs go back to its device (here the ``meta`` device
    stands for the card: the op only infers shapes there)."""
    _, t = ext
    x = tp.to_tensor(np.ones((3, 2), "float32"))
    x._t = torch.empty((3, 2), device="meta")
    out = t.relu2(x)
    assert out._t.device.type == "meta" and out.shape == [3, 2]


def test_version_reads_cudnn_only_when_asked(monkeypatch):
    """Importing the package must not load cuDNN: a DataLoader worker
    imports it, and loading cuDNN there gave the worker a CUDA context on
    the card (smoke phase 10's check)."""
    import importlib

    calls = []
    monkeypatch.setattr(torch.backends.cudnn, "version",
                        lambda: calls.append(1) or 8902)
    mod = importlib.reload(tversion)
    assert calls == []
    assert mod.cudnn() == mod.cudnn_version == "8902" and len(calls) == 2
    monkeypatch.undo()
    importlib.reload(tversion)
