"""The generic train step of both packages side by side, from the
reference's state at every step (``tests/test_torch_step_builder.py``'s
method, shared with the ViT and ERNIE tests).

:func:`run_both` builds one model in each package under fresh
unique-name counters, carries the reference's state dict into the
port's, and runs ``steps`` steps of each package's
``build_model_train_step``, each step from the reference's parameters,
buffers and moments; per step it returns the loss pair and the worst
relative differences: each parameter's update as a norm ratio
``||got - want|| / ||want - start||``, all updates together, the buffers
and the moments.  The key part of a fused QKV projection's bias is left
out of the updates: it adds ``q . b_k`` to a whole row of scores, which
the softmax cancels, so its gradient is zero but for rounding, and AdamW
steps each element by ~lr on its own noise.
"""

import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu as jp
from paddle_tpu.framework import unique_name as jnames
from paddle_tpu.models.step_builder import build_model_train_step as jbuild

import paddle_tpu_torch as tp
from paddle_tpu_torch.framework import unique_name as tnames
from paddle_tpu_torch.models.step_builder import \
    build_model_train_step as tbuild
from paddle_tpu_torch.weights import load_paddle_state_dict


def pair(factory):
    with jnames.guard():
        jp.seed(0)
        jm = factory(jp)
    with tnames.guard():
        tp.seed(0)
        tm = factory(tp)
    load_paddle_state_dict(tm, {k: np.asarray(v.numpy())
                                for k, v in jm.state_dict().items()})
    return jm, tm


def rel(a, b):
    n = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / n) if n else float(
        np.linalg.norm(a))


def run_both(case, steps=3, skip=(), **kw):
    """``steps`` steps of both packages' steps, each from the reference's
    state; per step the loss pair and the worst relative differences.
    The updates of the parameters whose names end in one of ``skip`` are
    left out (a bias on the keys alone, whose gradient the softmax
    cancels)."""
    factory, loss, batch = case
    jm, tm = pair(factory)
    js, jpar, jbuf, jopt = jbuild(jm, loss(jp), **kw)
    ts, tpar, tbuf, topt = tbuild(tm, loss(tp), **kw)
    keep = []
    for name, p in tm.named_parameters():
        k = np.ones(p.shape, bool)
        if name.endswith("qkv.bias"):
            h = p.shape[0] // 3
            k[h:2 * h] = False
        keep.append(None if skip and name.endswith(tuple(skip)) else k)
    hist = []
    for _ in range(steps):
        start = [np.asarray(a) for a in jpar]
        for t, a in zip(tpar, start):
            t.copy_(torch.as_tensor(a))
        tbuf = [torch.as_tensor(np.asarray(a)) for a in jbuf]
        for k in topt:
            if k != "t":
                for t, a in zip(topt[k], jopt[k]):
                    t.copy_(torch.as_tensor(np.asarray(a)))
        jpar, jbuf, jopt, jl = js(jpar, jbuf, jopt,
                                  *[jnp.asarray(a) for a in batch])
        tpar, tbuf, topt, tl = ts(tpar, tbuf, topt, *batch)
        kept = [(a, b, c, k) for a, b, c, k in zip(jpar, tpar, start, keep)
                if k is not None]
        upd = [float(np.linalg.norm((b.numpy() - np.asarray(a))[k])
                     / np.linalg.norm((np.asarray(a) - c)[k]))
               for a, b, c, k in kept]
        diff = [((b.numpy() - np.asarray(a))[k], (np.asarray(a) - c)[k])
                for a, b, c, k in kept]
        hist.append({
            "loss": (float(tl), float(jl)), "update": max(upd),
            "update_all": float(np.sqrt(sum((d ** 2).sum() for d, _ in diff)
                                        / sum((w ** 2).sum()
                                              for _, w in diff))),
            "buffers": max([rel(b.numpy(), np.asarray(a))
                            for a, b in zip(jbuf, tbuf)], default=0.0),
            "moments": max(rel(b.numpy(), np.asarray(a))
                           for k in topt if k != "t"
                           for a, b, m in zip(jopt[k], topt[k], keep)
                           if m is not None),
            "t": (topt["t"], int(jopt["t"]))})
    return hist, (jm, tm, tpar, tbuf)


def loss_rel(h):
    got, want = h["loss"]
    return abs(got - want) / abs(want)
