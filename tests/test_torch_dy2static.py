"""dy2static in the port against the reference: the 29 cases of
``tests/test_dy2static.py``, each run through both packages.

Every function case is written once as a factory over the package ``P``;
it runs eagerly and through ``jit.to_static`` in each package, and the
four results are equal (1e-6).  The other cases (a layer's forward, a
sub-layer's, the counted loop's gradient, the conversion errors) run the
same steps in both packages and compare values and error messages.
"""

import contextlib

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.jit import dy2static as jd2s
from paddle_tpu_torch.jit import dy2static as td2s

PKGS = {"ref": (jp, jd2s), "port": (tp, td2s)}


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _f32(*shape_value):
    shape, value = shape_value
    return np.full(shape, value, "float32")


# -- the function cases: (factory over P, its inputs, the expected first value)


def if_tensor_condition_assignment(P):
    def fn(x):
        if x.sum() > 0:
            y = x * 2.0
        else:
            y = x - 1.0
        return y + 0.5
    return fn


def if_without_else_branch(P):
    def fn(x):
        y = x + 1.0
        if y.mean() > 10.0:
            y = y * 0.0
        return y
    return fn


def if_both_branches_return(P):
    def fn(x):
        if x.sum() > 0:
            return x * 3.0
        else:
            return -x
    return fn


def early_return_with_fallthrough(P):
    def fn(x):
        if x.sum() > 0:
            return x + 10.0
        y = x * 2.0
        return y
    return fn


def elif_chain(P):
    def fn(x):
        s = x.sum()
        if s > 10.0:
            y = x * 100.0
        elif s > 0.0:
            y = x * 10.0
        else:
            y = x
        return y
    return fn


def while_tensor_condition(P):
    def fn(x):
        s = P.zeros([1])
        i = P.zeros([1])
        while s.sum() < x.sum():
            s = s + 1.0
            i = i + 2.0
        return s + i
    return fn


def while_python_condition_stays_python(P):
    def fn(x):
        n = 3
        while n > 0:
            x = x + 1.0
            n -= 1
        return x
    return fn


def for_range_python_bound(P):
    def fn(x):
        acc = P.zeros([1])
        for i in range(4):
            acc = acc + x.sum() + float(0 * i)
        return acc
    return fn


def for_range_tensor_bound(P):
    def fn(x):
        n = x.sum().astype("int64")
        acc = P.zeros([1])
        for i in range(n):
            acc = acc + 1.5
        return acc
    return fn


def nested_if_inside_while(P):
    def fn(x):
        s = P.zeros([1])
        k = P.zeros([1])
        while k.sum() < 5.0:
            if s.sum() > 2.0:
                s = s + 0.5
            else:
                s = s + 1.0
            k = k + 1.0
        return s
    return fn


def return_inside_tensor_while(P):
    def fn(x):
        s = P.zeros([1])
        while s.sum() < 5.0:
            s = s + 1.0
            if s.sum() > 2.0:
                return s
        return s
    return fn


def return_in_loop_branch(P):
    def fn(x):
        s = P.zeros([1])
        while s.sum() < 3.0:
            if x.sum() > 0:
                return s - 100.0
            s = s + 1.0
        return s
    return fn


def return_in_python_for_loop(P):
    def fn(x):
        for i in range(10):
            x = x + 1.0
            if i == 2:
                return x * 10.0
        return x
    return fn


def return_in_nested_loop(P):
    def fn(x):
        for i in range(3):
            for j in range(4):
                x = x + 1.0
                if x.sum() >= 5.0:
                    return x
        return x
    return fn


def break_in_for_range_python_bound(P):
    def fn(x):
        acc = P.zeros([1])
        for i in range(100):
            if i == 3:
                break
            acc = acc + x
        return acc
    return fn


def break_in_for_range_tensor_bound(P):
    def fn(x):
        n = x.sum().astype("int64")
        acc = P.zeros([1])
        for i in range(n):
            if acc.sum() >= 5.0:
                break
            acc = acc + 1.0
        return acc
    return fn


def continue_in_for_range_tensor_bound(P):
    def fn(x):
        n = x.sum().astype("int64")
        acc = P.zeros([1])
        for i in range(n):
            if i % 2 == 0:
                continue
            acc = acc + 1.0
        return acc
    return fn


def break_statements_after_guard(P):
    def fn(x):
        acc = P.zeros([1])
        for i in range(10):
            if i == 4:
                break
            acc = acc + x
            acc = acc + x
        return acc
    return fn


def break_in_while_tensor_condition(P):
    def fn(x):
        acc = P.zeros([1])
        while acc.sum() < 100.0:
            acc = acc + x
            if acc.sum() >= 7.0:
                break
        return acc
    return fn


def nested_loop_break_stays_inner(P):
    def fn(x):
        acc = P.zeros([1])
        for i in range(3):
            for j in range(10):
                if j >= 2:
                    break
                acc = acc + x
        return acc
    return fn


def return_chain_normalization(P):
    def fn(x):
        if x.sum() > 10.0:
            return x * 2.0
        if x.sum() > 5.0:
            return x * 3.0
        return x
    return fn


def list_append_trace_time_loop(P):
    def fn(x):
        acc = []
        for i in range(4):
            acc.append(x * float(i))
        out = acc[0]
        for a in acc[1:]:
            out = out + a
        return out
    return fn


def while_true_tensor_break_static(P):
    def fn(x):
        acc = P.zeros([1])
        while True:
            acc = acc + x
            if acc.sum() >= 5.0:
                break
        return acc
    return fn


def break_inside_with_block(P):
    def fn(x):
        total = x * 0.0
        for i in range(10):
            with contextlib.nullcontext():
                if i == 2:
                    break
            total = total + x
        return total
    return fn


ONES2, NEG2 = ((2,), 1.0), ((2,), -1.0)
FUNCTION_CASES = [
    (if_tensor_condition_assignment, ((2, 3), 1.0), 2.5),
    (if_tensor_condition_assignment, ((2, 3), -1.0), -1.5),
    (if_without_else_branch, ((3,), 1.0), 2.0),
    (if_without_else_branch, ((3,), 100.0), 0.0),
    (if_both_branches_return, ONES2, 3.0),
    (if_both_branches_return, NEG2, 1.0),
    (early_return_with_fallthrough, ONES2, 11.0),
    (early_return_with_fallthrough, NEG2, -2.0),
    (elif_chain, ((4,), 5.0), 500.0),
    (elif_chain, ((4,), 0.5), 5.0),
    (elif_chain, ((4,), -1.0), -1.0),
    (while_tensor_condition, ((4,), 1.8), 24.0),
    (while_python_condition_stays_python, ((2,), 0.0), 3.0),
    (for_range_python_bound, ONES2, 8.0),
    (for_range_tensor_bound, ((5,), 1.0), 7.5),
    (nested_if_inside_while, ((1,), 0.0), 4.0),
    (return_inside_tensor_while, ((1,), 0.0), 3.0),
    (return_in_loop_branch, ((1,), 1.0), -100.0),
    (return_in_loop_branch, ((1,), -1.0), 3.0),
    (return_in_python_for_loop, ((1,), 0.0), 30.0),
    (return_in_nested_loop, ((1,), 0.0), 5.0),
    (break_in_for_range_python_bound, ((1,), 2.0), 6.0),
    (break_in_for_range_tensor_bound, ((100,), 1.0), 5.0),
    (continue_in_for_range_tensor_bound, ((6,), 1.0), 3.0),
    (break_statements_after_guard, ((1,), 1.0), 8.0),
    (break_in_while_tensor_condition, ((1,), 2.0), 8.0),
    (nested_loop_break_stays_inner, ((1,), 1.0), 6.0),
    (return_chain_normalization, ((3,), 4.0), 8.0),
    (return_chain_normalization, ((3,), 2.0), 6.0),
    (return_chain_normalization, ((3,), 1.0), 1.0),
    (list_append_trace_time_loop, ((1,), 2.0), 12.0),
    (while_true_tensor_break_static, ((1,), 2.0), 6.0),
    (break_inside_with_block, ((1,), 1.0), 2.0),
]


@pytest.mark.parametrize(
    "factory,arg,first", FUNCTION_CASES,
    ids=[f"{f.__name__}-{a[1]:g}" for f, a, _ in FUNCTION_CASES])
def test_function_case_matches_reference(factory, arg, first):
    x = _f32(*arg)
    got = {}
    for name, (P, _) in PKGS.items():
        fn = factory(P)
        got[name, "eager"] = np.asarray(fn(P.to_tensor(x)).numpy())
        got[name, "static"] = np.asarray(
            P.jit.to_static(fn)(P.to_tensor(x)).numpy())
    want = got["ref", "eager"]
    assert want.reshape(-1)[0] == first
    for key, v in got.items():
        np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-6,
                                   err_msg=str(key))


def _gate(P):
    class Gate(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if h.sum() > 0:
                out = h * 2.0
            else:
                out = h * -1.0
            return out
    return Gate()


def _outer(P):
    class Inner(P.nn.Layer):
        def forward(self, x):
            if x.sum() > 0:
                return x * 2.0
            return x * -3.0

    class Outer(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.inner = Inner()
            self.fc = P.nn.Linear(4, 4)

        def forward(self, x):
            return self.inner(self.fc(x))
    return Outer()


def _same_weights(models):
    """The port's model takes the reference's Linear weights."""
    ref, port = models["ref"], models["port"]
    w, b = ref.fc.weight.numpy(), ref.fc.bias.numpy()
    port.fc.weight.set_value(w)
    port.fc.bias.set_value(b)


@pytest.mark.parametrize("make", [_gate, _outer],
                         ids=["layer_forward", "sublayer_transitive"])
def test_layer_forward_converts_as_reference(make):
    """A layer's forward and, transitively, a sub-layer's convert; the
    converted and eager outputs of both packages agree (1e-6)."""
    models = {name: make(P) for name, (P, _) in PKGS.items()}
    _same_weights(models)
    rng = np.random.RandomState(0)
    inputs = [rng.randn(2, 4).astype("float32"), np.full((2, 4), 2.0, "f4"),
              np.full((2, 4), -2.0, "f4")]
    for name, (P, _) in PKGS.items():
        models[name].eval()
    outs = {}
    for name, (P, _) in PKGS.items():
        m = models[name]
        eager = [m(P.to_tensor(x)).numpy() for x in inputs]
        P.jit.to_static(m)
        outs[name] = eager + [m(P.to_tensor(x)).numpy() for x in inputs]
    for i, want in enumerate(outs["ref"][:3]):
        for name in PKGS:
            np.testing.assert_allclose(outs[name][i], want, rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(outs[name][3 + i], want, rtol=1e-6,
                                       atol=1e-6)


def _counted_loop(P):
    st = P.static
    main, startup = st.Program(), st.Program()
    P.enable_static()
    try:
        with st.program_guard(main, startup):
            x = st.data("x", [2], "float32")
            x.stop_gradient = False

            def body(i, acc):
                return i + 1, acc + (x * x).sum()

            i0 = P.assign(np.zeros([1], "float32"))
            a0 = P.assign(np.zeros([1], "float32"))
            _, aN = st.while_loop(
                lambda i, a: i < P.assign(np.full([1], 3.0, "float32")),
                body, [i0, a0])
            loss = aN.sum()
            grads = st.append_backward(loss, parameter_list=[x])
    finally:
        P.disable_static()
    exe = st.Executor(P.CPUPlace())
    exe.run(startup)
    xv = np.array([1.0, 2.0], "float32")
    (gx,) = [g for p, g in grads if p.name == x.name]
    return exe.run(main, feed={"x": xv}, fetch_list=[loss, gx])


def test_counted_loop_is_differentiable_as_reference():
    got = {name: _counted_loop(P) for name, (P, _) in PKGS.items()}
    for name, (loss, gx) in got.items():
        assert float(np.asarray(loss).reshape(-1)[0]) == 15.0, name
        np.testing.assert_allclose(np.asarray(gx), [6.0, 12.0], rtol=1e-6)


def test_list_append_in_symbolic_loop_raises_as_reference():
    def factory(P):
        def fn(x):
            n = x.sum().astype("int64")
            acc = []
            i = P.zeros([1])
            while i.sum() < n:
                acc.append(i * 1.0)
                i = i + 1
            return i
        return fn

    msgs = {}
    for name, (P, d2s) in PKGS.items():
        st = P.static
        P.enable_static()
        try:
            with st.program_guard(st.Program(), st.Program()):
                xv = st.data("x", [4], "float32")
                with pytest.raises(d2s.ConversionError,
                                   match="preallocate|trace-time") as e:
                    d2s.convert_func(factory(P))(xv)
                msgs[name] = str(e.value)
        finally:
            P.disable_static()
    assert msgs["port"] == msgs["ref"]


def test_variable_bool_raises_in_static_as_reference():
    msgs = {}
    for name, (P, _) in PKGS.items():
        st = P.static
        P.enable_static()
        try:
            with st.program_guard(st.Program(), st.Program()):
                v = st.data("b", [1], "float32")
                with pytest.raises(TypeError, match="cond") as e:
                    bool(v)
                msgs[name] = str(e.value)
        finally:
            P.disable_static()
    assert msgs["port"] == msgs["ref"]


@pytest.mark.parametrize("src,why", [
    ("def fn(x):\n    while x.sum() > 0:\n        x = x - 1.0\n"
     "    else:\n        x = x + 1.0\n    return x\n", "while/else"),
    ("def fn(x):\n    for i in range(3):\n        x = x + 1.0\n"
     "    else:\n        x = x * 2.0\n    return x\n", "for/else"),
    ("def fn(x):\n    y = x\n    if x.sum() > 0:\n"
     "        if x.sum() > 1:\n            return x\n"
     "        y = x * 2.0\n    z = y + 1.0\n    return z\n", "one branch"),
], ids=["while_else", "for_else", "return_in_one_branch"])
def test_conversion_errors_match_reference(src, why, tmp_path):
    """The unconvertible forms raise the same ConversionError (the file
    and line named) in both packages."""
    path = tmp_path / "case.py"
    path.write_text(src)
    msgs = {}
    for name, (P, d2s) in PKGS.items():
        ns = {"__file__": str(path)}
        exec(compile(src, str(path), "exec"), ns)
        with pytest.raises(d2s.ConversionError) as e:
            d2s.convert_func(ns["fn"])
        msgs[name] = str(e.value)
    assert msgs["port"] == msgs["ref"], msgs
    assert why in msgs["port"]


def test_branch_rebinding_a_name_it_reads_converts():
    """A return-merge branch that reads a name before it rebinds it
    (``q = f(q)`` after an early ``return``, as the GPT attention's
    forward has): the branch takes the name as an argument.  Eager in the
    reference, to_static in the port: equal."""
    def factory(P):
        def fn(x):
            q = x * 2.0
            if x.sum() > 100.0:
                return q
            q = q + 1.0
            return q * 3.0
        return fn

    for v in (1.0, 100.0):
        x = np.full((4,), v, "float32")
        want = factory(jp)(jp.to_tensor(x)).numpy()
        got = tp.jit.to_static(factory(tp))(tp.to_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
