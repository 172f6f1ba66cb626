"""The port's vision models, conv and pooling layers and datasets against
the reference's, on the CPU.

Each model is built in both packages under fresh unique-name counters,
the reference's ``state_dict()`` (parameters and BatchNorm statistics) is
loaded into the port's, and the same seeded input runs forward in
training mode (BatchNorm on the batch's statistics; dropout on the same
injected uniforms in both packages).  A ``BottleneckBlock`` also runs
backward.  Tolerances: 1e-4 relative to the output's scale for the
forwards (17 to 18 layers of convolutions whose sums the two packages
order differently, each followed by a BatchNorm over a few samples), 1e-5
for the one block and its gradients.  The datasets: ``FakeData`` sample
for sample, and MNIST / Cifar10 read from small files written here.
"""

import gzip
import pickle
import struct
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import random as trand
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.weights import load_paddle_state_dict


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


@pytest.fixture(autouse=True)
def uniforms(monkeypatch):
    def draws(shape):
        return np.random.RandomState(11).rand(*shape).astype("float32")

    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None, **kw:
                        jnp.asarray(draws(tuple(shape))))
    monkeypatch.setattr(trand, "uniform", lambda key, shape, device:
                        torch.as_tensor(draws(tuple(shape))))


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _build(P, names, factory):
    with names.guard():
        P.seed(0)
        return factory(P)


def _pair(factory):
    """The reference's model and the port's, with the reference's state."""
    jm = _build(jp, jnames, factory)
    tm = _build(tp, tnames, factory)
    assert list(tm.state_dict()) == list(jm.state_dict())
    load_paddle_state_dict(tm, {k: np.asarray(v.numpy())
                                for k, v in jm.state_dict().items()})
    return jm, tm


def _close(got, want, tol, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


MODELS = [
    ("resnet18_nchw", lambda P: P.vision.models.resnet18(num_classes=10),
     (4, 3, 32, 32)),
    ("resnet18_nhwc", lambda P: P.vision.models.resnet18(
        num_classes=10, data_format="NHWC"), (4, 32, 32, 3)),
    ("lenet", lambda P: P.vision.models.LeNet(), (2, 1, 28, 28)),
    ("vgg11_features", lambda P: P.vision.models.vgg11(
        num_classes=0, with_pool=False), (2, 3, 32, 32)),
    ("vgg11_bn_features", lambda P: P.vision.models.vgg11(
        batch_norm=True, num_classes=0, with_pool=False), (2, 3, 32, 32)),
    ("mobilenet_v1", lambda P: P.vision.models.mobilenet_v1(
        scale=0.25, num_classes=10), (2, 3, 32, 32)),
    ("mobilenet_v2", lambda P: P.vision.models.mobilenet_v2(
        scale=0.25, num_classes=10), (2, 3, 32, 32)),
]


@pytest.mark.parametrize("name,factory,shape", MODELS,
                         ids=[m[0] for m in MODELS])
def test_model_forward_matches_reference(name, factory, shape):
    jm, tm = _pair(factory)
    x = _data(*shape)
    want = jm(jp.to_tensor(x)).numpy()
    got = tm(tp.to_tensor(x)).numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-4, name)
    # BatchNorm's running statistics moved the same way
    ws = {k: v.numpy() for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        _close(v.numpy(), ws[k], 1e-4, k)


def test_resnet_layouts_agree():
    """NHWC is NCHW with the activations transposed: the same weights give
    the same logits (in eval mode: in training, BatchNorm over two samples
    at 1 x 1 amplifies the layouts' different summation orders)."""
    a = _build(tp, tnames, lambda P: P.vision.models.resnet18(
        num_classes=10))
    b = _build(tp, tnames, lambda P: P.vision.models.resnet18(
        num_classes=10, data_format="NHWC"))
    b.set_state_dict({k: v.numpy() for k, v in a.state_dict().items()})
    a.eval()
    b.eval()
    x = _data(2, 3, 32, 32)
    _close(b(tp.to_tensor(np.ascontiguousarray(x.transpose(0, 2, 3, 1))))
           .numpy(), a(tp.to_tensor(x)).numpy(), 1e-5)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_bottleneck_block_forward_and_gradients(fmt):
    def factory(P):
        ds = P.nn.Sequential(
            P.nn.Conv2D(16, 32, 1, stride=2, bias_attr=False,
                        data_format=fmt),
            P.nn.BatchNorm2D(32, data_format=fmt))
        return P.vision.models.resnet.BottleneckBlock(
            16, 8, stride=2, downsample=ds, data_format=fmt)

    jm, tm = _pair(factory)
    shape = (4, 16, 8, 8) if fmt == "NCHW" else (4, 8, 8, 16)
    x = _data(*shape)
    g = None
    res = []
    for P, m in ((jp, jm), (tp, tm)):
        xt = P.to_tensor(x, stop_gradient=False)
        out = m(xt)
        g = _data(*out.shape, seed=5)
        P.sum(out * P.to_tensor(g)).backward()
        res.append({"out": out.numpy(), "dx": xt.grad.numpy(),
                    **{n: p.grad.numpy() for n, p in m.named_parameters()}})
    want, got = res
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-5, k)


def test_layers_name_and_initialise_like_the_reference():
    """Parameter names, shapes and which exist (bias_attr=False) match;
    the initializers draw from the same distributions (KaimingUniform's
    bound for Conv2D)."""
    for P, names in ((jp, jnames), (tp, tnames)):
        with names.guard():
            conv = P.nn.Conv2D(8, 16, 3, bias_attr=False, data_format="NHWC")
            convt = P.nn.Conv2DTranspose(8, 4, 3, stride=2)
            conv1 = P.nn.Conv1D(4, 6, 5)
        if P is jp:
            want = [(n, p.shape) for m in (conv, convt, conv1)
                    for n, p in m.named_parameters()]
            names_j = [p.name for m in (conv, convt, conv1)
                       for p in m.parameters()]
        else:
            got = [(n, p.shape) for m in (conv, convt, conv1)
                   for n, p in m.named_parameters()]
            names_t = [p.name for m in (conv, convt, conv1)
                       for p in m.parameters()]
            bound = np.sqrt(6.0 / (8 * 9))
            w = conv.weight.numpy()
            assert np.abs(w).max() <= bound and np.abs(w).max() > 0.8 * bound
    assert got == want and names_t == names_j
    assert conv.bias is None


@pytest.mark.parametrize("layer", [
    lambda P: P.nn.MaxPool2D(3, 2, 1, ceil_mode=True),
    lambda P: P.nn.AvgPool2D(3, 2, 1, exclusive=False),
    lambda P: P.nn.AdaptiveAvgPool2D([3, 2]),
    lambda P: P.nn.AdaptiveMaxPool2D(1),
    lambda P: P.nn.MaxPool1D(3, 2, 1),
    lambda P: P.nn.AvgPool1D(2),
    lambda P: P.nn.Conv1D(4, 6, 3, stride=2, padding=1),
    lambda P: P.nn.Conv2DTranspose(4, 3, 3, stride=2, padding=1),
], ids=["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D", "AdaptiveMaxPool2D",
        "MaxPool1D", "AvgPool1D", "Conv1D", "Conv2DTranspose"])
def test_pool_and_conv_layers_match_reference(layer):
    jm, tm = _pair(layer)
    one_d = isinstance(tm, (tp.nn.MaxPool1D, tp.nn.AvgPool1D, tp.nn.Conv1D))
    x = _data(2, 4, 12) if one_d else _data(2, 4, 9, 8)
    _close(tm(tp.to_tensor(x)).numpy(), jm(jp.to_tensor(x)).numpy(), 1e-5)


def test_pretrained_raises():
    for make in (tp.vision.models.resnet50, tp.vision.models.vgg11,
                 tp.vision.models.mobilenet_v1, tp.vision.models.mobilenet_v2):
        with pytest.raises(NotImplementedError):
            make(pretrained=True)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def test_fake_data_matches_reference_sample_for_sample():
    a = jp.vision.datasets.FakeData(8, image_shape=(5, 4, 3), num_classes=7)
    b = tp.vision.datasets.FakeData(8, image_shape=(5, 4, 3), num_classes=7)
    assert len(a) == len(b) == 8
    for i in range(8):
        (xa, ya), (xb, yb) = a[i], b[i]
        np.testing.assert_array_equal(xb, xa)
        assert xb.dtype == xa.dtype and yb == ya and yb.dtype == ya.dtype


def _mnist_files(tmp_path):
    r = np.random.RandomState(0)
    images = r.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = r.randint(0, 10, 5).astype(np.uint8)
    img_p, lab_p = tmp_path / "img.gz", tmp_path / "lab.gz"
    with gzip.open(img_p, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + images.tobytes())
    with gzip.open(lab_p, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    return str(img_p), str(lab_p)


def _cifar_file(tmp_path):
    r = np.random.RandomState(1)
    path = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("data_batch_1", 3), ("test_batch", 2)):
            blob = pickle.dumps({
                b"data": r.randint(0, 256, (n, 3072)).astype(np.uint8),
                b"labels": r.randint(0, 10, n).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            import io as _io

            tf.addfile(info, _io.BytesIO(blob))
    return str(path)


def test_mnist_and_cifar_read_local_files_like_the_reference(tmp_path):
    img_p, lab_p = _mnist_files(tmp_path)
    cifar = _cifar_file(tmp_path)
    pairs = [
        (jp.vision.datasets.MNIST(img_p, lab_p),
         tp.vision.datasets.MNIST(img_p, lab_p)),
        (jp.vision.datasets.FashionMNIST(img_p, lab_p),
         tp.vision.datasets.FashionMNIST(img_p, lab_p)),
        (jp.vision.datasets.Cifar10(cifar, mode="train"),
         tp.vision.datasets.Cifar10(cifar, mode="train")),
        (jp.vision.datasets.Cifar10(cifar, mode="test"),
         tp.vision.datasets.Cifar10(cifar, mode="test")),
    ]
    for a, b in pairs:
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            (xa, ya), (xb, yb) = a[i], b[i]
            np.testing.assert_array_equal(xb, xa)
            assert yb == ya
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        tp.vision.datasets.MNIST(str(tmp_path / "no.gz"), lab_p)
    with pytest.raises(FileNotFoundError):
        tp.vision.datasets.Cifar100(str(tmp_path / "none.tar.gz"))
