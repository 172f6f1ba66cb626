"""The pipeline engine: 1F1B over ``torch.distributed``, one process per
pipeline rank.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel/
pipeline_engine.py`` (``PipelineEngine``: ``_sig``, ``_partition``,
``extract_opt_config``, ``_init_opt_state``, ``_apply_update``,
``train_step``, ``eval_output``, ``sync_to_layers``,
``sync_from_layers``; its ``_clip_by_global_norm`` is the hybrid
optimizer's clip here).  The reference compiles the schedule into one
program over the mesh's pp axis; here each rank runs its part eagerly
and the stages exchange activations and their gradients by
point-to-point sends (``distributed/collective.py``).

* **Partition**, as the reference's: the ``PipelineLayer``'s layers split
  into ``prologue | homogeneous middle | epilogue``, the middle being the
  longest run of layers of one signature (class tree, scalar settings,
  parameter shapes and dtypes, forward function; :meth:`PipelineEngine.
  _sig`), cut to a multiple of S.  Rank s holds middle blocks ``[s bps,
  (s + 1) bps)`` and drops the others; the prologue runs on stage 0, the
  epilogue (and the loss) on stage S - 1.
* **Prologue and epilogue parameters** (the embeddings, the final
  LayerNorm, the tied head) and all their optimizer state are stored 1/S
  per pp rank (each flattened, padded to a multiple of S, rank s holding
  chunk s), as the reference stores them: gathered whole at the start of
  a step, their gradients reduce-scattered at its end (the tied
  embedding's two gradients, the embedding's on stage 0 and the head's
  on stage S - 1, summed there), the whole copies released.  At S = 1
  the layers' own tensors are the storage and nothing is gathered.
* **Schedule**: 1F1B.  Stage s runs S - s - 1 warm-up forwards, then one
  forward and one backward alternating, then the remaining backwards, so
  it holds at most S microbatches' activations; at S = 1 each
  microbatch's backward follows its forward.  Sends and receives that
  cross are posted together (``batch_isend_irecv``), so no two stages
  wait on each other; every activation travels behind a small header
  (its shape and dtype).
* **Optimizer**: the registered update ops (sgd, momentum, adam, adamw
  with the decay mask of ``apply_decay_param_fun``) on this rank's
  parameters and chunks, after L2 decay and the global-norm clip of
  ``HybridParallelOptimizer`` (``_HybridClip``), whose squared norm is
  summed over the pp ranks (and over mp for split parameters) so that it
  is the one-device clip; the learning rate is
  read on every call, so schedulers work.  Parameters that are not fp32
  update through fp32 masters.
* **Dropout**: one key per step from the seed chain; a microbatch's keys
  fold its index in, and every block of a microbatch draws from the same
  key, as the reference's scanned block body draws one for all layers.
* **Data parallelism** beside the pipeline: each dp rank takes its rows
  of the batch, and gradients and the loss are averaged over dp.

Multi-rank pipelines run over gloo on the CPU; NCCL puts one rank on a
card.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ....dygraph import tracer
from ....dygraph.tensor import Tensor
from ....framework import random as _random
from ....nn.clip import ClipGradByGlobalNorm
from ...collective import (_DTYPES, _HEADER, _all_gather_flat, _coalesced,
                           _exchange, _Flat, _header, _reduce_scatter_flat)
from ... import mesh as mesh_mod
from .sharding_optimizer import _HybridClip

__all__ = ["PipelineEngine", "extract_opt_config"]


# -- the optimizer --------------------------------------------------------------


def _inner_optimizer(optimizer):
    """The user's optimizer under the hybrid and sharding wrappers."""
    while hasattr(optimizer, "_inner"):
        optimizer = optimizer._inner
    return optimizer


def extract_opt_config(optimizer) -> Tuple[str, dict, Optional[float]]:
    """``(mode, hyper, clip_norm)`` of a port optimizer (under its
    wrappers): SGD, Momentum, Adam or AdamW, L2 decay, the global-norm
    clip.  Anything else raises: a silently different update would train
    another trajectory."""
    from .... import optimizer as opt_mod
    from ....regularizer import L2Decay

    optimizer = _inner_optimizer(optimizer)
    clip = getattr(optimizer, "_grad_clip", None)
    if clip is not None and not isinstance(clip, ClipGradByGlobalNorm):
        raise NotImplementedError(
            f"pipeline engine supports grad_clip=ClipGradByGlobalNorm only, "
            f"got {type(clip).__name__}")
    clip_norm = clip.clip_norm if clip is not None else None
    reg = getattr(optimizer, "regularization", None)
    l2 = 0.0
    if isinstance(reg, L2Decay):
        l2 = reg.coeff
    elif reg is not None:
        raise NotImplementedError(
            f"pipeline engine supports L2Decay regularization only, got {reg}")
    if isinstance(optimizer, opt_mod.AdamW):
        return ("adamw", {"beta1": optimizer._beta1, "beta2": optimizer._beta2,
                          "epsilon": optimizer._epsilon,
                          "coeff": optimizer._coeff, "l2": l2}, clip_norm)
    if isinstance(optimizer, opt_mod.Adam):
        return ("adam", {"beta1": optimizer._beta1, "beta2": optimizer._beta2,
                         "epsilon": optimizer._epsilon, "l2": l2}, clip_norm)
    if isinstance(optimizer, opt_mod.Momentum):
        return ("momentum", {"momentum": optimizer._momentum,
                             "use_nesterov": optimizer._use_nesterov,
                             "l2": l2}, clip_norm)
    if type(optimizer) is opt_mod.SGD:
        return ("sgd", {"l2": l2}, clip_norm)
    raise NotImplementedError(
        f"the pipeline engine's update does not support "
        f"{type(optimizer).__name__}; use SGD, Momentum, Adam or AdamW")


def _init_opt_state(mode, params):
    """Zero moments (fp32, the shape of each updated tensor) and, for
    parameters that are not fp32, fp32 masters."""
    def zeros():
        return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in params]

    if mode == "sgd":
        state = {}
    elif mode == "momentum":
        state = {"velocity": zeros()}
    elif mode in ("adam", "adamw"):
        state = {"m": zeros(), "v": zeros(), "b1p": None, "b2p": None}
    else:
        raise ValueError(f"unknown optimizer mode {mode!r}")
    if any(p.dtype != torch.float32 for p in params):
        state["master"] = [p.detach().float().clone() for p in params]
    return state


def _apply_update(mode, hyper, params, grads, state, lr, decay):
    """One update of every tensor in ``params`` (in place) from ``grads``
    by the registered op of ``mode``; ``decay`` is AdamW's mask."""
    masters = state.get("master")
    work = masters if masters is not None else params

    def run(op_type, ins, attrs):
        outs = tracer.run_eager_kernel(
            op_type, {k: [v] for k, v in ins.items()}, attrs)
        return {k: v[0] for k, v in outs.items()}

    if mode in ("adam", "adamw") and state["b1p"] is None:
        dev = params[0].device
        state["b1p"] = torch.full((1,), hyper["beta1"], device=dev)
        state["b2p"] = torch.full((1,), hyper["beta2"], device=dev)
    out = None
    for i, (w, g) in enumerate(zip(work, grads)):
        if mode == "sgd":
            new = run("sgd", {"Param": w, "Grad": g, "LearningRate": lr},
                      {})["ParamOut"]
        elif mode == "momentum":
            out = run("momentum", {"Param": w, "Grad": g,
                                   "Velocity": state["velocity"][i],
                                   "LearningRate": lr},
                      {"mu": hyper["momentum"],
                       "use_nesterov": hyper["use_nesterov"]})
            new = out["ParamOut"]
            state["velocity"][i] = out["VelocityOut"]
        else:
            attrs = {"beta1": hyper["beta1"], "beta2": hyper["beta2"],
                     "epsilon": hyper["epsilon"]}
            if mode == "adamw":
                attrs.update(coeff=hyper["coeff"], with_decay=decay[i])
            out = run(mode, {"Param": w, "Grad": g, "LearningRate": lr,
                             "Moment1": state["m"][i],
                             "Moment2": state["v"][i],
                             "Beta1Pow": state["b1p"],
                             "Beta2Pow": state["b2p"]}, attrs)
            new = out["ParamOut"]
            state["m"][i], state["v"][i] = out["Moment1Out"], out["Moment2Out"]
        if masters is not None:
            masters[i] = new.float()
        with torch.no_grad():
            params[i].copy_(new.to(params[i].dtype))
    if mode in ("adam", "adamw") and out is not None:
        state["b1p"], state["b2p"] = out["Beta1PowOut"], out["Beta2PowOut"]


# -- the engine -----------------------------------------------------------------


def _unique(params):
    """``params`` without repeats (by identity), in order."""
    seen, out = set(), []
    for p in params:
        if id(p) not in seen:
            seen.add(id(p))
            out.append(p)
    return out


class PipelineEngine:
    """This rank's part of a ``PipelineLayer`` and its train step (behind
    ``PipelineParallel``)."""

    def __init__(self, pipeline_layer, loss_fn=None):
        from ....nn.layer_base import Layer

        self.layers = pipeline_layer
        self.S = pipeline_layer.get_num_stages()
        self.mesh = mesh_mod.get_mesh()
        pp = 1 if self.mesh is None else self.mesh.shape["pp"]
        if pp != self.S:
            raise ValueError(f"the PipelineLayer has {self.S} stages and the "
                             f"installed mesh's pp degree is {pp}: build it "
                             "with num_stages = pp_degree under fleet.init")
        if self.S > 1 and not dist.is_initialized():
            raise RuntimeError("a pipeline of several stages needs an "
                               "initialised process group (fleet.init)")
        self.stage = 0 if self.mesh is None else self.mesh.coord["pp"]
        self.seq_major = bool(getattr(pipeline_layer, "seq_major", False))
        self.loss_fn = loss_fn or pipeline_layer._loss_fn
        self._funcs = list(pipeline_layer._funcs)
        self._modules = [l for l, _ in self._funcs if isinstance(l, Layer)]
        self._partition()
        self._hold()
        self.opt_state = None
        self._opt_key = None

    # -- groups --------------------------------------------------------------
    def _peer(self, stage):
        coord = dict(self.mesh.coord, pp=stage)
        return self.mesh.rank_of(**coord)

    def _group(self, axes):
        """The mesh's group over ``axes`` when it has more than one rank."""
        if self.mesh is None or self.mesh.degree(axes) == 1:
            return None
        return self.mesh.group(axes)

    # -- the partition ---------------------------------------------------------
    @staticmethod
    def _sig(entry):
        """Homogeneity signature: the layer's class tree and scalar
        settings, its parameters' shapes and dtypes, its forward
        function (two blocks with equal weights' shapes but other classes
        or windows are not one stage function)."""
        from ....nn.layer_base import Layer

        layer, fwd = entry
        if not isinstance(layer, Layer):
            return None
        ps = list(layer.parameters())
        if not ps:
            return None

        def scalars(l, prefix=""):
            out = [(prefix + "::class", type(l).__name__)]
            for k, v in vars(l).items():
                if k.startswith("_") or k == "training":
                    continue
                if isinstance(v, (int, float, bool, str)):
                    out.append((prefix + k, v))
            for name, sub in getattr(l, "_sub_layers", {}).items():
                out.extend(scalars(sub, prefix + name + "."))
            return out

        fwd_id = getattr(fwd, "__qualname__", repr(fwd)) if fwd else None
        return (fwd_id, tuple(scalars(layer)),
                tuple((tuple(p.shape), str(p._t.dtype)) for p in ps))

    def _partition(self):
        """``prologue | homogeneous middle | epilogue``."""
        sigs = [self._sig(e) for e in self._funcs]
        best = (0, 0)
        i = 0
        while i < len(sigs):
            if sigs[i] is None:
                i += 1
                continue
            j = i
            while j < len(sigs) and sigs[j] == sigs[i]:
                j += 1
            if j - i > best[0]:
                best = (j - i, i)
            i = j
        run_len, lo = best
        usable = (run_len // self.S) * self.S
        if usable == 0:
            raise ValueError(
                "the pipeline needs a contiguous run of >= num_stages layers "
                "with identical parameter structure (e.g. transformer "
                f"blocks); the longest run is {run_len} for {self.S} stages")
        if usable < run_len:
            warnings.warn(
                f"pipeline stage partition: {run_len - usable} of {run_len} "
                f"homogeneous layers do not divide into {self.S} stages and "
                f"run in the epilogue on the last stage (their parameters "
                f"stored 1/S like the epilogue's); prefer num_layers a "
                f"multiple of num_stages")
        hi = lo + usable
        self._lo, self._hi = lo, hi
        self._pro = self._funcs[:lo]
        self._epi = self._funcs[hi:]
        self.blocks_per_stage = usable // self.S
        first = lo + self.stage * self.blocks_per_stage
        self._mine = range(first, first + self.blocks_per_stage)
        self._mid = self._funcs[first:first + self.blocks_per_stage]

    def _hold(self):
        """Drop the other stages' blocks; lay out the prologue and
        epilogue parameters (1/S flat chunks when S > 1)."""
        from ....nn.layer_base import Layer

        subs = self.layers.run_functions._sub_layers
        for i in range(self._lo, self._hi):
            if i not in self._mine:
                self.layers._funcs[i] = (None, self._funcs[i][1])
                subs.pop(str(i), None)
        self.mid_params = _unique(p for l, _ in self._mid
                                  for p in l.parameters())
        mine = {id(p) for p in self.mid_params}
        self.other_params = _unique(
            p for l, _ in self._pro + self._epi if isinstance(l, Layer)
            for p in l.parameters() if id(p) not in mine)
        self._flats = None
        if self.S > 1:
            self._flats = [_Flat(p.shape, self.S, self.stage)
                           for p in self.other_params]
            self.other = [f.shard(p._t.detach())
                          for f, p in zip(self._flats, self.other_params)]
            self._release()
        self._whole = self.S == 1

    # -- the prologue and epilogue's whole copies ----------------------------
    def _gather(self):
        """Make the prologue / epilogue parameters whole on every rank."""
        if self._whole:
            return
        whole = _all_gather_flat(self.other, self._flats,
                                 self.mesh.group("pp"), self.other[0].dtype)
        for p, w in zip(self.other_params, whole):
            p._t = w.detach().clone().requires_grad_(p.trainable)
        self._whole = True

    def _release(self):
        for p in self.other_params:
            p._t = p._t.new_empty(0).requires_grad_(p.trainable)
        self._whole = False

    def sync_to_layers(self):
        """The layer objects hold the trained values (the prologue and
        epilogue whole) for ``state_dict``."""
        self._gather()

    def sync_from_layers(self):
        """Take the parameters from the layer objects again (after
        ``set_state_dict``); fp32 masters are re-seeded from them, moments
        kept, as eager ``set_state_dict`` keeps them."""
        if self.S > 1:
            self.other = [f.shard(p._t.detach())
                          for f, p in zip(self._flats, self.other_params)]
        if self.opt_state is not None and "master" in self.opt_state:
            self.opt_state["master"] = [t.detach().float().clone()
                                        for t in self._updated()]

    def _updated(self):
        """The tensors the optimizer updates: this stage's block
        parameters, then the prologue / epilogue ones (their chunks)."""
        other = (self.other if self.S > 1
                 else [p._t for p in self.other_params])
        return [p._t for p in self.mid_params] + list(other)

    # -- the forward and backward of one microbatch --------------------------
    def _run(self, entries, x, key=None):
        for layer, fwd in entries:
            if key is not None:
                with _random.trace_rng_scope(key):
                    x = fwd(layer, x) if fwd is not None else layer(x)
            else:
                x = fwd(layer, x) if fwd is not None else layer(x)
        return x

    def _forward(self, ids, labels, x, keys):
        """This stage's forward of one microbatch: (its output Tensor or
        its loss, the received input Tensor or None)."""
        pro_key, blk_key, epi_key = keys
        first, last = self.stage == 0, self.stage == self.S - 1
        xin = None
        if first:
            with _random.trace_rng_scope(pro_key):
                h = self._run(self._pro, Tensor._wrap(ids))
        else:
            xin = Tensor._wrap(x.requires_grad_(True))
            h = xin
        # every block draws from the microbatch's block key
        h = self._run(self._mid, h, key=blk_key)
        if not last:
            return h, xin
        with _random.trace_rng_scope(epi_key):
            h = self._run(self._epi, h)
            res = self.loss_fn(h, Tensor._wrap(labels))
        if res.ndim:
            from .... import tensor_api as T

            res = T.mean(res)
        return res, xin

    def _keys(self, step_key, j):
        k = _random.fold_in(step_key, j)
        return tuple(_random.fold_in(k, i) for i in range(3))

    # -- the schedule ----------------------------------------------------------
    def _send_fwd(self, y, recv_grad):
        """Send activation ``y`` (behind its header) to the next stage;
        with ``recv_grad`` receive its gradient in the same exchange."""
        peer = self._peer(self.stage + 1)
        g = torch.empty_like(y) if recv_grad else None
        _exchange([(_header(y), peer), (y.detach(), peer)],
                  [(g, peer)] if recv_grad else [])
        return g

    def _recv_fwd(self, send_grad=None):
        """Receive the previous stage's activation; ``send_grad`` (the
        gradient of the last one) goes back in the same exchange."""
        peer = self._peer(self.stage - 1)
        h = torch.empty(_HEADER, dtype=torch.long, device=self._device)
        _exchange([(send_grad, peer)] if send_grad is not None else [],
                  [(h, peer)])
        n = int(h[0])
        x = torch.empty([int(d) for d in h[1:1 + n]],
                        dtype=_DTYPES[int(h[-1])], device=self._device)
        _exchange(recvs=[(x, peer)])
        return x

    def _send_grad(self, g):
        _exchange([(g, self._peer(self.stage - 1))])

    def _recv_grad(self, like):
        g = torch.empty_like(like)
        _exchange(recvs=[(g, self._peer(self.stage + 1))])
        return g

    def _schedule(self, ids_mb, labels_mb, step_key):
        """1F1B over the microbatches; returns the sum of the microbatch
        losses on the last stage (None elsewhere)."""
        M, S, s = len(ids_mb), self.S, self.stage
        first, last = s == 0, s == S - 1
        warm = min(S - s - 1, M)
        rest = M - warm
        outs, ins = {}, {}
        total = None

        def fwd(j, x):
            nonlocal total
            y, xin = self._forward(ids_mb[j], labels_mb[j], x,
                                   self._keys(step_key, j))
            outs[j], ins[j] = y, xin
            if last:
                d = y._t.detach().float()
                total = d if total is None else total + d
            return y._t

        def bwd(j, g):
            y, xin = outs.pop(j), ins.pop(j)
            if last:
                (y._t / M).backward()
            else:
                torch.autograd.backward(y._t, g)
            return None if first else xin._t.grad

        for j in range(warm):
            y = fwd(j, None if first else self._recv_fwd())
            self._send_fwd(y, recv_grad=False)
        x = None if first or rest == 0 else self._recv_fwd()
        for i in range(rest):
            y = fwd(warm + i, x)
            g = None if last else self._send_fwd(y, recv_grad=True)
            dx = bwd(i, g)
            if first:
                x = None
            elif i == rest - 1:
                self._send_grad(dx)
            else:
                x = self._recv_fwd(send_grad=dx)
        for i in range(rest, M):
            g = None if last else self._recv_grad(outs[i]._t)
            dx = bwd(i, g)
            if not first:
                self._send_grad(dx)
        return total

    def train_step(self, ids, labels, optimizer=None, lr=None):
        """One step over the microbatches of ``ids`` / ``labels`` ((M, mb,
        ...) torch tensors on this rank's device: its dp rows): 1F1B
        forward and backward, gradient reductions, the update.  Returns
        the mean loss over the microbatches and the dp ranks (a 0-d fp32
        tensor on every rank)."""
        if optimizer is not None:
            mode, hyper, clip_norm = extract_opt_config(optimizer)
            inner = _inner_optimizer(optimizer)
            lr_val = inner.get_lr()
            decay_fn = getattr(inner, "_apply_decay_param_fun", None)
        else:
            mode, hyper, clip_norm = "sgd", {"l2": 0.0}, None
            lr_val, decay_fn = (1e-3 if lr is None else lr), None
        self._device = ids.device
        self._gather()
        for p in self.mid_params + self.other_params:
            p.clear_grad()
        step_key = _random.next_rng_key()
        M = ids.shape[0]
        total = self._schedule(list(ids), list(labels), step_key)
        grads = self._grads()
        if self.S > 1:
            self._release()
        params = self._updated()
        okey = (mode, tuple(sorted(hyper.items())))
        if self.opt_state is None or self._opt_key != okey:
            self.opt_state = _init_opt_state(mode, params)
            self._opt_key = okey
        if hyper.get("l2"):
            grads = [g + hyper["l2"] * p.float()
                     for p, g in zip(params, grads)]
        if clip_norm is not None:
            grads = self._clip(grads, clip_norm)
        names = ([p.name for p in self.mid_params]
                 + [p.name for p in self.other_params])
        decay = [decay_fn is None or bool(decay_fn(n)) for n in names]
        lr_t = torch.tensor([lr_val], dtype=torch.float32,
                            device=params[0].device)
        _apply_update(mode, hyper, params, grads, self.opt_state, lr_t,
                      decay)
        return self._loss(total, M)

    def _clip(self, grads, clip_norm):
        """``grads`` through the hybrid optimizer's global-norm clip
        (``_HybridClip``: split gradients' squared norms summed over mp,
        the total over pp), each beside the parameter it updates."""
        groups = {a: g for a in ("mp", "pp")
                  if (g := self._group(a)) is not None}
        clip = _HybridClip(ClipGradByGlobalNorm(clip_norm), groups)
        pairs = clip([(p, Tensor._wrap(g)) for p, g in zip(
            self.mid_params + self.other_params, grads)])
        return [g._t for _, g in pairs]

    def _grads(self):
        """This rank's fp32 gradients of the updated tensors: the blocks'
        whole, the prologue / epilogue's summed over pp and cut to this
        rank's chunk; averaged over dp."""
        def grad(p):
            g = p._t.grad
            return (torch.zeros(p._t.shape, dtype=torch.float32,
                                device=p._t.device) if g is None
                    else g.float())

        mid = [grad(p) for p in self.mid_params]
        other = [grad(p) for p in self.other_params]
        if self.S > 1:
            other = _reduce_scatter_flat(other, self._flats,
                                         self.mesh.group("pp"))
        grads = mid + other
        data = self._group(("dp", "sharding"))
        if data is not None:
            n = float(self.mesh.degree(("dp", "sharding")))
            _coalesced(grads, lambda b: dist.all_reduce(b, group=data))
            torch._foreach_div_(grads, n)
        return grads

    def _loss(self, total, M):
        """The step's mean loss on every rank."""
        loss = (torch.zeros((), device=self._device) if total is None
                else total / M)
        data = self._group(("dp", "sharding"))
        if data is not None:
            dist.all_reduce(loss, group=data)
            loss = loss / self.mesh.degree(("dp", "sharding"))
        if self.S > 1:
            dist.broadcast(loss, src=self._peer(self.S - 1),
                           group=self.mesh.group("pp"))
        return loss

    # -- eval ----------------------------------------------------------------
    @torch.no_grad()
    def eval_output(self, ids):
        """The epilogue's output for ``ids`` (one batch, eval mode, no
        gradient), on every pp rank."""
        self._device = ids.device
        was = [m.training for m in self._modules]
        for m in self._modules:
            m.eval()
        released = not self._whole
        try:
            self._gather()
            h = None
            if self.stage == 0:
                h = self._run(self._pro, Tensor._wrap(ids))
            else:
                h = Tensor._wrap(self._recv_fwd())
            h = self._run(self._mid, h)
            if self.stage < self.S - 1:
                self._send_fwd(h._t, recv_grad=False)
                h = None
            else:
                h = self._run(self._epi, h)
            if self.S > 1:
                src = self._peer(self.S - 1)
                group = self.mesh.group("pp")
                hdr = (_header(h._t) if h is not None else
                       torch.empty(_HEADER, dtype=torch.long,
                                   device=self._device))
                dist.broadcast(hdr, src=src, group=group)
                if h is None:
                    n = int(hdr[0])
                    h = Tensor._wrap(torch.empty(
                        [int(d) for d in hdr[1:1 + n]],
                        dtype=_DTYPES[int(hdr[-1])], device=self._device))
                dist.broadcast(h._t, src=src, group=group)
            return h
        finally:
            if released:
                self._release()
            for m, tr in zip(self._modules, was):
                m.training = tr
