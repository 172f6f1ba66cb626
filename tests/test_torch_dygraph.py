"""The dygraph Tensor's semantics in the port against the reference.

Each scenario is one function run twice, with the reference package and
with the port as ``P`` (the two share the paddle API), on the same seeded
numpy data; what it returns (values, gradients, flags) must agree: flags
exactly, values and gradients to 1e-6 relative.  The scenarios:
``stop_gradient`` defaults, gradient accumulation over two
``backward()`` calls, ``clear_grad``, ``no_grad``, ``paddle.grad``
(first and second order, unreachable inputs), hooks, ``detach``,
``set_value``, indexing and ``__setitem__`` with gradients, and
``PyLayer``.
"""

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.autograd  # noqa: F401

import paddle_tpu_torch as tp


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")


def _data(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _both(scenario):
    got, want = scenario(tp), scenario(jp)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, (bool, type(None), str, int)):
            assert g == w, (k, g, w)
        else:
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    return got


def _np(t):
    return None if t is None else t.numpy()


def test_stop_gradient_defaults():
    def s(P):
        x = P.to_tensor(_data(3, 4))
        w = P.to_tensor(_data(4, 2, seed=1), stop_gradient=False)
        lin = P.nn.Linear(4, 2)
        y = P.matmul(x, w)
        with P.no_grad():
            z = P.matmul(x, w)
        vals, idx = P.topk(y, 1)
        return {"to_tensor": x.stop_gradient, "leaf": w.stop_gradient,
                "param": lin.weight.stop_gradient,
                "bias": lin.bias.stop_gradient,
                "op_of_leaf": y.stop_gradient,
                "op_of_constants": P.add(x, x).stop_gradient,
                "under_no_grad": z.stop_gradient,
                "topk_values": vals.stop_gradient,
                "topk_indices": idx.stop_gradient,
                "argmax": P.argmax(y, axis=1).stop_gradient,
                "layer_out": lin(x).stop_gradient,
                "is_leaf": w.is_leaf and not y.is_leaf}

    _both(s)


def test_gradients_accumulate_over_two_backward_calls_and_clear():
    def s(P):
        w = P.to_tensor(_data(4, 2), stop_gradient=False)
        x = P.to_tensor(_data(3, 4, seed=1))
        P.sum(P.matmul(x, w) ** 2).backward()
        first = _np(w.grad)
        P.mean(P.tanh(P.matmul(x, w))).backward()
        out = {"first": first, "both": _np(w.grad)}
        w.clear_grad()
        out["cleared"] = w.grad is None
        P.sum(P.matmul(x, w)).backward()
        out["after_clear"] = _np(w.grad)
        return out

    _both(s)


def test_no_grad_context_and_decorator():
    def s(P):
        w = P.to_tensor(_data(3), stop_gradient=False)

        @P.no_grad()
        def f(t):
            return t * 3.0

        with P.no_grad():
            a = w * 2.0
        b = f(w)
        c = P.sum(w * w)
        c.backward()
        return {"a": a.stop_gradient, "b": b.stop_gradient,
                "c": c.stop_gradient, "grad": _np(w.grad),
                "enabled": P.is_grad_enabled()}

    _both(s)


def test_paddle_grad_first_second_order_and_unused():
    def s(P):
        x = P.to_tensor(_data(5), stop_gradient=False)
        u = P.to_tensor(_data(5, seed=1), stop_gradient=False)
        y = P.sum(x * x * x)
        (gx,) = P.grad(y, x, create_graph=True)
        (ggx,) = P.grad(P.sum(gx), x)
        z = P.sum(x * 2.0)
        (gz, gu) = P.grad(z, [x, u], allow_unused=True)
        try:
            P.grad(P.sum(x * 2.0), [u])
            raised = False
        except ValueError:
            raised = True
        return {"gx": _np(gx), "ggx": _np(ggx), "gz": _np(gz),
                "gu": gu is None, "raised": raised,
                "x_grad_untouched": x.grad is None}

    _both(s)


def test_layer_forward_hooks():
    def s(P):
        P.seed(0)
        lin = P.nn.Linear(4, 3)
        lin.set_state_dict({"weight": _data(4, 3), "bias": _data(3, seed=1)})
        seen = []
        pre = lin.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2.0,))
        post = lin.register_forward_post_hook(
            lambda layer, inputs, out: seen.append(1) or out + 1.0)
        x = P.to_tensor(_data(2, 4, seed=2))
        hooked = lin(x)
        pre.remove()
        post.remove()
        plain = lin(x)
        return {"hooked": _np(hooked), "plain": _np(plain),
                "post_calls": len(seen)}

    _both(s)


def test_tensor_hook_replaces_the_gradient():
    """``register_hook`` (the reference's Tensor has none): the hook's
    return value replaces the gradient flowing back, so doubling it
    doubles the leaf's gradient the reference computes without hook."""
    x = tp.to_tensor(_data(4), stop_gradient=False)
    y = x * x
    seen = []
    h = y.register_hook(lambda g: seen.append(g.numpy()) or g * 2.0)
    tp.sum(y * 3.0).backward()
    jx = jp.to_tensor(_data(4), stop_gradient=False)
    jp.sum(jx * jx * 3.0).backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * jx.grad.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(seen[0], np.full(4, 3.0, "float32"))
    h.remove()


def test_detach():
    def s(P):
        w = P.to_tensor(_data(3), stop_gradient=False)
        d = (w * 2.0).detach()
        loss = P.sum(w * d)
        loss.backward()
        return {"stop": d.stop_gradient, "value": _np(d),
                "grad": _np(w.grad)}

    _both(s)


def test_set_value_on_a_leaf_and_on_an_intermediate():
    def s(P):
        w = P.to_tensor(_data(3), stop_gradient=False)
        w.set_value(_data(3, seed=4))
        h = w * 3.0
        read_old = h * 1.0           # reads h before the overwrite
        h.set_value(np.ones(3, "float32"))
        loss = P.sum(read_old * w) + P.sum(h * w)
        loss.backward()
        return {"w": _np(w), "h": _np(h), "stop": h.stop_gradient,
                "grad": _np(w.grad)}

    _both(s)


def test_indexing_and_setitem_with_gradients():
    def s(P):
        x = P.to_tensor(_data(4, 6), stop_gradient=False)
        v = P.to_tensor(_data(3, seed=2), stop_gradient=False)
        y = x[1:, ::2] * 2.0
        z = x * 1.0
        z[0, :3] = v
        z[2] = 0.5
        loss = P.sum(y * y) + P.sum(z * z)
        loss.backward()
        buf = P.to_tensor(np.zeros((2, 3), "float32"))
        buf[1] = P.to_tensor(_data(3, seed=3))
        return {"y": _np(y), "z": _np(z), "gx": _np(x.grad),
                "gv": _np(v.grad), "buf": _np(buf),
                "buf_stop": buf.stop_gradient}

    _both(s)


def test_pylayer():
    def s(P):
        class Cube(P.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, k):
                ctx.save_for_backward(x)
                ctx.k = k
                return x * x * x * k

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                return dy * x * x * (3.0 * ctx.k)

        x = P.to_tensor(_data(4), stop_gradient=False)
        y = Cube.apply(x, 2.0)
        P.sum(y * y).backward()
        c = Cube.apply(P.to_tensor(_data(4)), 1.0)
        return {"y": _np(y), "grad": _np(x.grad), "stop": y.stop_gradient,
                "const_stop": c.stop_gradient}

    _both(s)


def test_tracer_flags_spans_and_keys():
    """The tracer's per-op decisions: ``FLAGS_check_nan_inf`` raises
    naming the op, ``FLAGS_benchmark`` opens one span per op named after
    it (the same names as the reference's), and a ``needs_rng`` op takes
    a fresh key each call from a chain that ``seed`` re-anchors."""
    import paddle_tpu.profiler as jprof

    import paddle_tpu_torch.profiler as tprof

    def s(P, prof):
        P.set_flags({"FLAGS_check_nan_inf": True})
        try:
            P.log(P.to_tensor(np.array([-1.0], "float32")))
            raised = None
        except RuntimeError as e:
            raised = "'log'" in str(e)
        finally:
            P.set_flags({"FLAGS_check_nan_inf": False})
        spans = []

        def sink(name, t0, t1):
            spans.append(name)

        prof.add_span_sink(sink)
        P.set_flags({"FLAGS_benchmark": True})
        try:
            x = P.to_tensor(_data(2, 3), stop_gradient=False)
            P.sum(P.nn.functional.relu(P.matmul(x, x, transpose_y=True)))
        finally:
            P.set_flags({"FLAGS_benchmark": False})
            prof.remove_span_sink(sink)
        return {"nan_inf_raised": raised, "spans": ",".join(spans)}

    got, want = s(tp, tprof), s(jp, jprof)
    assert got == want
    assert got["nan_inf_raised"] and got["spans"] == \
        "matmul_v2,relu,reduce_sum"

    x = tp.to_tensor(np.ones((4, 64), "float32"))
    tp.seed(3)
    a = tp.nn.functional.dropout(x, 0.5).numpy()
    b = tp.nn.functional.dropout(x, 0.5).numpy()
    tp.seed(3)
    c = tp.nn.functional.dropout(x, 0.5).numpy()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, c)
