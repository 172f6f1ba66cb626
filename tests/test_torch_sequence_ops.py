"""The port's sequence ops against the reference's, on the CPU.

A sequence batch is a padded dense tensor and a length per row.  Beyond
the one case per op of ``tests/test_torch_ops.py``, each op runs here over
more attributes and lengths (every pool type, ``maxlen`` below and above
the batch's steps, no ``Length`` at all, a row of length 0, other context
windows): the same seeded numpy inputs through the reference's
``registry.run_kernel`` and the port's, outputs to 1e-6 relative (integers
exactly), and the values' gradients for seeded output gradients, the
port's ``registry.op_grad`` against the reference's ``<type>_grad``
kernel (``jax.vjp``), which also holds that no gradient reaches the pad.
Then graph mode: the ``static.nn`` sequence builders' output shapes
(inferred on ``meta`` tensors, with a batch dim of -1) against the
reference's program, and ``fluid.nets.sequence_conv_pool`` as a static
program: its op list, and its outputs run by both Executors from the
reference's startup values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference's ops)
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch as tp
from paddle_tpu_torch.ops import registry as treg
import torch_static_parity as sp

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def f(*s, seed=0):
    return np.random.RandomState(seed).randn(*s).astype("float32")


LENS = np.array([5, 0, 3])
CASES = [
    *[("sequence_pool", {"X": [f(3, 5, 2)], "Length": [LENS]},
       {"pooltype": pt}) for pt in ("SUM", "AVERAGE", "SQRT", "MAX",
                                    "FIRST", "LAST")],
    ("sequence_pool", {"X": [f(3, 5)]}, {"pool_type": "sqrt"}),
    ("sequence_pad", {"X": [f(3, 5, 2)], "Length": [LENS]},
     {"pad_value": 2.5, "maxlen": 3}),
    ("sequence_pad", {"X": [f(3, 5)]}, {"maxlen": 0}),
    ("sequence_softmax", {"X": [f(3, 5, 2)], "Length": [LENS]}, {}),
    ("sequence_reverse", {"X": [f(3, 5)]}, {}),
    ("sequence_unpad", {"X": [f(3, 5, 2, 2)], "Length": [LENS]}, {}),
    ("sequence_slice", {"X": [f(3, 5)], "Offset": [np.array([4, 0, 1])],
                        "SliceLength": [np.array([1, 0, 4])]}, {}),
    ("sequence_reshape", {"X": [f(2, 3, 4)]}, {"new_dim": 6}),
    ("sequence_concat", {"X": [f(2, 3), f(2, 2), f(2, 4)]}, {}),
    ("sequence_expand_as", {"X": [f(3, 2, 2)], "Length": [LENS]},
     {"maxlen": 5}),
    ("sequence_enumerate", {"X": [np.arange(10).reshape(2, 5)]},
     {"win_size": 2}),
    ("sequence_scatter", {"X": [f(2, 5)],
                          "Ids": [np.array([[0, 4, 0], [2, 1, 3]])],
                          "Updates": [f(2, 3, seed=1)]}, {}),
    ("sequence_conv", {"X": [f(3, 5, 2)], "Filter": [f(8, 3, seed=1)],
                       "Length": [LENS]},
     {"contextLength": 4, "contextStart": -3}),
    ("sequence_conv", {"X": [f(3, 5, 2)], "Filter": [f(4, 3, seed=1)]},
     {"context_length": 2, "context_start": 1}),
]


def _ref(op, ins, attrs):
    out = jreg.run_kernel(jreg.get_op_def(op),
                          {s: [jnp.asarray(a) for a in v]
                           for s, v in ins.items()}, dict(attrs))
    return {s: [np.asarray(a) for a in v] for s, v in out.items()}


def _port(op, ins, attrs):
    with torch.no_grad():
        out = treg.run_kernel(treg.get_op_def(op),
                              {s: [torch.as_tensor(np.asarray(a)) for a in v]
                               for s, v in ins.items()}, dict(attrs))
    return {s: [a.numpy() for a in v] for s, v in out.items()}


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu":
        assert got.dtype.kind == want.dtype.kind, what
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    assert got.dtype == want.dtype, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("op,ins,attrs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_reference(op, ins, attrs):
    want, got = _ref(op, ins, attrs), _port(op, ins, attrs)
    assert sorted(got) == sorted(want)
    for slot in want:
        for i, (g, w) in enumerate(zip(got[slot], want[slot])):
            _close(g, w, f"{op}.{slot}[{i}]")
    od = treg.get_op_def(op)
    if od.no_grad:
        return
    r = np.random.RandomState(5)
    ogs = {s: [r.randn(*np.shape(a)).astype(a.dtype) for a in v]
           for s, v in got.items() if v[0].dtype.kind == "f"}
    jouts = jreg.run_kernel(
        jreg.get_grad_op_def(op),
        {**{s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
         **{s + "@GRAD": [jnp.asarray(a) for a in v]
            for s, v in ogs.items()}}, dict(attrs))
    tgot = treg.op_grad(op, {s: [torch.as_tensor(np.asarray(a)) for a in v]
                             for s, v in ins.items()}, attrs,
                        {s: [torch.as_tensor(a) for a in v]
                         for s, v in ogs.items()})
    for slot, ws in jouts.items():
        if slot[:-5] in od.nondiff_slots or slot[:-5] not in ins:
            continue
        for i, (g, w) in enumerate(zip(tgot[slot], ws)):
            _close(g.numpy(), np.asarray(w), f"{op}.{slot}[{i}]")


def test_sequence_mask_needs_maxlen_in_both():
    ins = {"X": [np.array([2, 4])]}
    for run in (_ref, _port):
        with pytest.raises(ValueError, match="maxlen"):
            run("sequence_mask", ins, {})


def _sequence_program(P, st):
    """Every static.nn sequence builder over a [-1, 6, 4] batch and its
    lengths."""
    x = st.data("x", [-1, 6, 4], "float32")
    ln = st.data("len", [-1], "int64")
    ids = st.data("ids", [-1, 6], "int64")
    y = st.data("y", [-1, 6], "float32")
    snn = st.nn
    outs = [
        snn.sequence_pad(x, 1.0, maxlen=8, length=ln)[0],
        snn.sequence_unpad(x, ln),
        snn.sequence_softmax(x, length=ln),
        snn.sequence_pool(x, "max", length=ln),
        snn.sequence_first_step(x, length=ln),
        snn.sequence_last_step(x, length=ln),
        snn.sequence_reverse(x, length=ln),
        snn.sequence_slice(x, ln, ln),
        snn.sequence_reshape(x, 8, length=ln),
        snn.sequence_concat([x, x], lengths=[ln, ln]),
        snn.sequence_expand(snn.sequence_pool(x, "sum"), ln, maxlen=5),
        snn.sequence_enumerate(ids, 3, length=ln),
        snn.sequence_scatter(y, ids, y, length=ln),
        snn.sequence_conv(x, 5, 3, length=ln),
    ]
    return [(x, ln, ids, y)] + outs


def test_static_sequence_builders_match_reference():
    programs = (sp.build("ref", _sequence_program),
                sp.build("port", _sequence_program))
    (jm, _, jo), (tm, _, to) = programs
    assert sp.op_list(tm) == sp.op_list(jm)
    for j, t in zip(jo[1:], to[1:]):
        assert (tuple(t.shape), t.dtype) == (tuple(j.shape), j.dtype), t.name
    r = np.random.RandomState(0)
    feed = {"x": f(3, 6, 4), "len": np.array([6, 2, 4], "int64"),
            "ids": r.randint(0, 6, (3, 6)).astype("int64"),
            "y": f(3, 6, seed=1)}
    (want,), (got,) = sp.run_both(None, lambda i: feed, lambda o: o[1:],
                                  programs=programs)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(np.asarray(g), np.asarray(w), f"output {i}")


def test_sequence_conv_pool_program_matches_reference():
    """``fluid.nets.sequence_conv_pool`` (a context window of 3 over
    embedded words, sigmoid, max pooling over each row's length), then a
    softmax classifier, trained 3 SGD steps as a static program."""

    def net(P, st):
        words = st.data("words", [-1, 7], "int64")
        ln = st.data("len", [-1], "int64")
        label = st.data("label", [-1, 1], "int64")
        emb = P.fluid.layers.embedding(words, size=[20, 8])
        conv = P.fluid.layers.sequence_conv(emb, 6, 3, act="sigmoid",
                                            length=ln)
        pooled = P.fluid.layers.sequence_pool(conv, "max", length=ln)
        both = P.fluid.nets.sequence_conv_pool(emb, 6, 3)
        pred = P.fluid.layers.fc(P.concat([pooled, both], axis=1), 2,
                                 act="softmax")
        loss = P.mean(P.fluid.layers.cross_entropy(pred, label))
        P.fluid.optimizer.SGD(0.05).minimize(loss)
        return loss, pooled, both

    programs = sp.build("ref", net), sp.build("port", net)
    assert sp.op_list(programs[1][0]) == sp.op_list(programs[0][0])

    def feeds(i):
        r = np.random.RandomState(10 + i)
        return {"words": r.randint(0, 20, (4, 7)).astype("int64"),
                "len": np.array([7, 3, 1, 5], "int64"),
                "label": r.randint(0, 2, (4, 1)).astype("int64")}

    want, got = sp.run_both(None, feeds, lambda o: list(o), steps=3,
                            programs=programs)
    for step, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} fetch {i}")
    assert want[-1][0] < want[0][0]
