"""The port's collective ops (``paddle_tpu_torch/ops/collective_ops.py``)
against the reference's, on the CPU.

The port's ops run on 2 and 4 gloo ranks (``torch_dist_workers.
collective_ops``, one spawn a world size); the reference's kernels run in
the test process under ``shard_map`` over as many of its 8 virtual CPU
devices, the ring named by an ``axis_name``.  Held: each op's output on
every rank and each differentiable op's input gradients for the same
output gradients, the port's by ``registry.op_grad`` (its grad op, or
autograd through its collectives), the reference's by the kernel of the
grad op its grad maker emits (``c_identity`` / ``c_allreduce_sum`` /
``c_embedding_grad`` / ``c_softmax_with_cross_entropy_grad``) or of its
``jax.vjp`` grad op.  ``c_broadcast``'s output gradient is the same on
every rank (the reference's vjp takes a replicated cotangent only).
Tolerance 1e-6 (relative and absolute): a sum over ranks in another
order.  Also on the ranks, against numpy: ``send_v2`` / ``recv_v2`` /
``partial_send`` (the reference's raise inside a traced program),
``c_embedding`` with each rank's own vocabulary rows, and a static
tensor-parallel program run by the Executor (loss and gradients within
1e-5 of torch autograd on the whole tensors).  In one process: every
op is registered, and static programs record the reference's op types,
grads included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as jp
from paddle_tpu import distributed as jdist
from paddle_tpu.distributed.fleet import meta_parallel as jmpp
from paddle_tpu.ops import collective_ops as jcoll
from paddle_tpu.ops import registry as jreg
from paddle_tpu.ops.dispatch import dispatch_static as jdispatch_static

import paddle_tpu_torch as tp
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmpp
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.ops.dispatch import dispatch_static as tdispatch_static
import torch_dist_workers as W
from torch_static_parity import build, op_list

try:
    from jax import shard_map
except ImportError:             # older jax
    from jax.experimental.shard_map import shard_map

TOL = dict(rtol=1e-6, atol=1e-6)
# the reference's grad op for the ops with a grad maker, and its inputs
HAND = {"c_allreduce_sum": "c_identity", "mp_allreduce_sum": "c_identity",
        "c_identity": "c_allreduce_sum"}


def _reference_ops():
    return sorted(t for t in jreg.all_ops()
                  if jreg.get_op_def(t).kernel.__module__
                  == jcoll.__name__)


def test_every_collective_op_is_registered():
    ref = _reference_ops()
    assert len(ref) == 23
    port = set(treg.all_ops())
    assert [t for t in ref if t not in port] == []
    for t in ref:
        j, p = jreg.get_op_def(t), treg.get_op_def(t)
        assert (j.no_grad, set(j.nondiff_slots), set(j.nondiff_out_slots)) \
            == (p.no_grad, p.nondiff_slots, p.nondiff_out_slots), t
        assert (j.grad_maker is None) == (p.grad_maker is None), t


def _cases(n, seed=0):
    """op -> {"ins": slot -> per-rank stacked array, "attrs", "grad":
    (output slot, per-rank cotangents) or None}."""
    r = np.random.RandomState(seed)

    def f(*s):
        return r.randn(n, *s).astype("float32")

    cases = {}
    for op in ("c_allreduce_sum", "mp_allreduce_sum", "c_identity"):
        cases[op] = {"ins": {"X": f(4, 6)}, "grad": ("Out", f(4, 6))}
    for op in ("c_allreduce_max", "c_allreduce_min", "barrier",
               "c_sync_calc_stream", "c_sync_comm_stream", "c_wait_compute"):
        cases[op] = {"ins": {"X": f(4, 6)}, "grad": None}
    cases["c_allreduce_prod"] = {
        "ins": {"X": (r.rand(n, 4, 6) + 0.5).astype("float32")},
        "grad": None}
    g = r.randn(4, 6).astype("float32")
    cases["c_broadcast"] = {"ins": {"X": f(4, 6)},
                            "grad": ("Out", np.stack([g] * n)),
                            "attrs": {"root": 1}}
    cases["c_allgather"] = {"ins": {"X": f(3, 5)},
                            "grad": ("Out", f(3 * n, 5))}
    cases["c_reducescatter"] = {"ins": {"X": f(2 * n, 5)},
                                "grad": ("Out", f(2, 5))}
    cases["alltoall"] = {"ins": {"X": f(2 * n, 3)},
                         "grad": ("Out", f(2 * n, 3))}
    cases["c_concat"] = {"ins": {"X": f(4, 3)}, "grad": ("Out", f(4, 3 * n))}
    cases["c_split"] = {"ins": {"X": f(4, 3 * n)}, "grad": ("Out", f(4, 3))}
    ids = r.randint(0, 9, (7,)).astype("int64")
    cases["c_embedding"] = {
        "ins": {"W": f(5, 4), "Ids": np.stack([ids] * n)},
        "grad": ("Out", np.stack([r.randn(7, 4).astype("float32")] * n)),
        "attrs": {"start_index": 2}}
    label = r.randint(0, 4 * n, (5, 1)).astype("int64")
    cases["c_softmax_with_cross_entropy"] = {
        "ins": {"Logits": f(5, 4), "Label": np.stack([label] * n)},
        "grad": ("Loss", np.stack([r.randn(5, 1).astype("float32")] * n))}
    for c in cases.values():
        c["attrs"] = {"ring_id": 0, **c.get("attrs", {})}
    return cases


def _shmap(n, fn, *arrays, replicated=()):
    """``fn`` on each device's slice of the per-rank stacked ``arrays``
    (leading dim n; those at the indices ``replicated`` are one array
    every device sees whole) under shard_map over axis "x"; outputs
    stacked the same way."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))

    def body(*xs):
        outs = fn(*[x if i in replicated else x[0]
                    for i, x in enumerate(xs)])
        return tuple(o[None] for o in outs)

    specs = tuple(P() if i in replicated else P("x")
                  for i in range(len(arrays)))
    res = shard_map(body, mesh=mesh, in_specs=specs,
                    out_specs=P("x"))(*[jnp.asarray(a) for a in arrays])
    return [np.asarray(x) for x in res]


def _reference(n, op, case):
    """The reference's outputs and input gradients, per rank."""
    attrs = {**case["attrs"], "axis_name": "x"}
    slots = sorted(case["ins"])
    od = jreg.get_op_def(op)

    def fwd(*xs):
        out = jreg.run_kernel(od, {s: [x] for s, x in zip(slots, xs)},
                              attrs)
        return [out[k][0] for k in sorted(out)]

    outs = _shmap(n, fwd, *[case["ins"][s] for s in slots])
    names = sorted(jreg.run_kernel(
        od, {s: [jnp.asarray(case["ins"][s][0])] for s in slots},
        {"ring_id": 0}))
    res = dict(zip(names, outs))
    if case["grad"] is None:
        return res, None
    slot, g = case["grad"]
    if op in HAND:
        gd, gslots, gins = jreg.get_op_def(HAND[op]), ["X"], [g]
        want = ["Out"]
    elif op == "c_embedding":
        gd = jreg.get_op_def("c_embedding_grad")
        gslots, gins = ["W", "Ids", "Out@GRAD"], [
            case["ins"]["W"], case["ins"]["Ids"], g]
        want = ["W@GRAD"]
    elif op == "c_softmax_with_cross_entropy":
        gd = jreg.get_op_def("c_softmax_with_cross_entropy_grad")
        gslots, gins = ["Softmax", "Label", "Loss@GRAD"], [
            res["Softmax"], case["ins"]["Label"], g]
        want = ["Logits@GRAD"]
    else:
        gd = jreg.get_grad_op_def(op)
        gslots, gins = slots + [slot + "@GRAD"], [
            case["ins"][s] for s in slots] + [g]
        want = [s + "@GRAD" for s in slots]

    def bwd(*xs):
        out = jreg.run_kernel(gd, {s: [x] for s, x in zip(gslots, xs)},
                              attrs)
        return [out[k][0] for k in want]

    replicated = ()
    if op == "c_broadcast":
        # the cotangent of psum's (device-invariant) output is invariant
        gins[-1], replicated = gins[-1][0], (len(gins) - 1,)
    grads = _shmap(n, bwd, *gins, replicated=replicated)
    if op in HAND:
        want = ["X@GRAD"]
    return res, dict(zip(want, grads))


def _static_payload(n, seed=1):
    r = np.random.RandomState(seed)
    v, h, b = 4 * n, 6, 5
    return {"table": r.randn(v, h).astype("float32"),
            "w": r.randn(h, v).astype("float32"),
            "ids": r.randint(0, v, (b,)).astype("int64"),
            "label": r.randint(0, v, (b, 1)).astype("int64")}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    n = request.param
    cases = _cases(n)
    r = np.random.RandomState(5)
    payload = {"ops": cases,
               "emb": {"table": r.randn(3 * n, 4).astype("float32"),
                       "ids": r.randint(0, 3 * n, (6,)).astype("int64")},
               "static": _static_payload(n)}
    res = W.run(tmp_path_factory.mktemp(f"cops{n}"), n, "collective_ops",
                payload)
    return n, payload, res


def test_outputs_and_gradients_match_reference(world):
    n, payload, res = world
    for op, case in payload["ops"].items():
        want, grads = _reference(n, op, case)
        for rank in range(n):
            got = res[rank][op]
            for slot, w in want.items():
                np.testing.assert_allclose(got[slot], w[rank], **TOL,
                                           err_msg=f"{op}.{slot} rank {rank}")
            if grads is not None:
                assert sorted(got["grads"]) == sorted(grads), op
                for slot, w in grads.items():
                    np.testing.assert_allclose(
                        got["grads"][slot], w[rank], **TOL,
                        err_msg=f"{op} {slot} rank {rank}")


def test_p2p_and_own_rows_embedding(world):
    n, payload, res = world
    x0 = np.arange(12.0, dtype="float32").reshape(3, 4)
    np.testing.assert_array_equal(res[1]["recv_v2"], x0)
    np.testing.assert_array_equal(res[1]["partial_recv"], x0.reshape(-1)[6:])
    emb = payload["emb"]
    for rank in range(n):
        np.testing.assert_allclose(res[rank]["emb_own_rows"],
                                   emb["table"][emb["ids"]], **TOL)
    # inside a traced reference program p2p raises
    with pytest.raises(NotImplementedError):
        jreg.run_kernel(jreg.get_op_def("send_v2"), {"X": [jnp.ones(2)]},
                        {"ring_id": 0, "peer": 1})


def test_static_tensor_parallel_program_on_ranks(world):
    n, payload, res = world
    p = payload["static"]
    table = torch.tensor(p["table"], requires_grad=True)
    w = torch.tensor(p["w"], requires_grad=True)
    logits = table[torch.as_tensor(p["ids"])] @ w
    loss = torch.nn.functional.cross_entropy(
        logits, torch.as_tensor(p["label"][:, 0]))
    loss.backward()
    vl = p["table"].shape[0] // n
    for rank in range(n):
        got = res[rank]["static_tp"]
        assert "c_softmax_with_cross_entropy_grad" in got["ops"]
        assert "c_allreduce_sum" in got["ops"]       # c_identity's grad op
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        sl = slice(rank * vl, (rank + 1) * vl)
        np.testing.assert_allclose(got["table_grad"],
                                   table.grad.numpy()[sl], atol=1e-5)
        np.testing.assert_allclose(got["w_grad"], w.grad.numpy()[:, sl],
                                   atol=1e-5)


def _collective_program(P, st):
    pkg = jdist if P is jp else tdist
    mpp = jmpp if P is jp else tmpp
    x = st.data("x", [4, 8], "float32")
    label = st.data("label", [4, 1], "int64")
    w = P.create_parameter([8, 16], "float32")
    h = pkg.all_reduce(P.matmul(x, w))
    h = pkg.broadcast(h, src=0)
    g = pkg.all_gather([], h)
    loss = mpp.ParallelCrossEntropy()(g, label)
    avg = P.mean(loss)
    st.append_backward(avg)
    return avg


def test_static_programs_record_the_reference_op_types():
    ref, _, _ = build("ref", _collective_program)
    port, _, _ = build("port", _collective_program)
    assert op_list(port) == op_list(ref)
    types = [o[0] for o in op_list(port)]
    for t in ("c_allreduce_sum", "c_broadcast", "c_allgather",
              "c_softmax_with_cross_entropy",
              "c_softmax_with_cross_entropy_grad", "c_allgather_grad",
              "c_broadcast_grad", "c_identity"):
        assert t in types, t


def test_grad_ops_of_the_megatron_pair_and_the_hand_grads():
    """append_backward emits the reference's grad op types: c_identity
    for c_allreduce_sum / mp_allreduce_sum and c_allreduce_sum for
    c_identity, the hand-written grad ops for c_embedding and
    c_softmax_with_cross_entropy, each gradient under its input's
    name."""
    def program(P, st):
        from_dispatch = (jdispatch_static if P is jp
                         else tdispatch_static)
        ids = st.data("ids", [4], "int64")
        label = st.data("label", [4, 1], "int64")
        table = P.create_parameter([6, 8], "float32")
        w = P.create_parameter([8, 6], "float32")
        h = from_dispatch("c_embedding", {"W": [table], "Ids": [ids]},
                          {"ring_id": 0, "start_index": 0})["Out"][0]
        h = from_dispatch("c_identity", {"X": [h]}, {"ring_id": 0})
        logits = P.matmul(h["Out"][0], w)
        logits = from_dispatch("mp_allreduce_sum", {"X": [logits]},
                               {"ring_id": 0})["Out"][0]
        loss = from_dispatch("c_softmax_with_cross_entropy",
                             {"Logits": [logits], "Label": [label]},
                             {"ring_id": 0})["Loss"][0]
        st.append_backward(P.mean(loss))

    ref, _, _ = build("ref", program)
    port, _, _ = build("port", program)
    assert op_list(port) == op_list(ref)
    ops = port.global_block().ops
    grads = {o.type: (dict(o.inputs), dict(o.outputs)) for o in ops}
    assert grads["c_identity"][1]["Out"] == [
        o.input("X")[0] + "@GRAD" for o in ops
        if o.type == "mp_allreduce_sum"]
    assert "W@GRAD" in grads["c_embedding_grad"][1]
