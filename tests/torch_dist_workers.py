"""Rank programs of the port's distributed tests, and the runner that
spawns them.

This module imports torch, numpy and the port only: every spawned rank
imports it (``spawn`` starts fresh interpreters that import the module
defining the rank's function), so a rank never loads JAX or the
reference.  The reference runs in the test process; its inputs and the
ranks' results cross as numpy, pickled through files under the test's
``tmp_path``.

:func:`run` spawns ``world`` gloo ranks of one program (a function here,
by name) with a FileStore rendezvous under ``tmp_path``, a 60 s timeout
on every collective and a join deadline, and returns each rank's result
in rank order.
"""

import os
import pickle
import time

import numpy as np

JOIN_TIMEOUT = 240      # seconds: a hung rank fails its test, not the run
GROUP_TIMEOUT = 60


def run(tmp_path, world, program, payload=None, timeout=JOIN_TIMEOUT):
    from paddle_tpu_torch.distributed import spawn

    tmp = str(tmp_path)
    tag = f"{program}-{time.monotonic_ns()}"
    pin = os.path.join(tmp, f"{tag}.in.pkl")
    with open(pin, "wb") as f:
        pickle.dump(payload, f)
    spawn(_entry, args=(tmp, tag, program, pin), nprocs=world,
          timeout=timeout)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{tag}.rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _entry(tmp, tag, program, pin):
    import torch

    from paddle_tpu_torch.distributed import init_parallel_env

    torch.set_num_threads(1)
    env = init_parallel_env(backend="gloo",
                            store_path=os.path.join(tmp, f"{tag}.store"),
                            timeout=GROUP_TIMEOUT)
    with open(pin, "rb") as f:
        payload = pickle.load(f)
    result = globals()[program](payload)
    with open(os.path.join(tmp, f"{tag}.rank{env.rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _np(t):
    """A torch tensor or an eager-API Tensor as numpy."""
    if hasattr(t, "_t"):
        return t.numpy()
    return t.detach().cpu().numpy()


# -- programs -----------------------------------------------------------------


def hang(payload):
    """Rank 0 never finishes (the join deadline must end it)."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        time.sleep(600)


def fail(payload):
    """Rank 1 raises while rank 0 waits for it in a collective (the first
    failure must end the pool)."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def _fleet(dp=1, mp=1, pp=1, sharding=1, stage=None):
    """fleet.init over the hybrid degrees (the strategy's ZeRO stage when
    ``stage`` is given); returns the installed mesh."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    if stage is not None:
        s.sharding = True
        s.sharding_configs = {"sharding_degree": sharding, "stage": stage}
    fleet.init(is_collective=True, strategy=s)
    return mesh_mod.get_mesh()


def collectives(payload):
    """Every collective of the public API on this rank's values, and the
    five ``_c_*`` Functions' outputs and input gradients."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet

    r, n = dist.get_rank(), dist.get_world_size()
    out = {}
    base = torch.tensor([r + 1.0, 2.0 - r, 0.5 * (r + 2)])
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD)):
        out["all_reduce_" + name] = _np(C.all_reduce(base.clone(), op))
    gathered = []
    C.all_gather(gathered, base * 10)
    out["all_gather"] = np.stack([_np(t) for t in gathered])
    out["broadcast"] = _np(C.broadcast(base.clone(), src=n - 1))
    red = C.reduce(base.clone(), dst=0)
    out["reduce_on_0"] = _np(red) if r == 0 else None
    src_list = [torch.full((2,), 100.0 * i) for i in range(n)]
    out["scatter"] = _np(C.scatter(torch.zeros(2), src_list, src=0))
    received = []
    C.alltoall([torch.full((2,), 10.0 * r + j) for j in range(n)], received)
    out["alltoall"] = np.stack([_np(t) for t in received])
    buf = torch.zeros(3)
    if r == 0:
        C.send(base * 7, dst=1)
    elif r == 1:
        C.recv(buf, src=0)
    out["recv_on_1"] = _np(buf)
    C.barrier()
    g = C.new_group([0, 1])
    out["new_group"] = (g.rank, g.nranks, g.ranks)
    out["new_group_sum"] = (_np(C.all_reduce(base.clone(), group=g))
                            if r in (0, 1) else None)
    out["get_group"] = (C.get_group(0).nranks, C.get_group(g.id).ranks)
    w = torch.from_numpy(payload["w"])            # (4, 3 n): same on all
    wr = torch.from_numpy(payload["wr"][r])       # (4, 3): this rank's
    x_loc = torch.from_numpy(payload["x"][r]).requires_grad_()   # (4, 3)
    x_glob = torch.from_numpy(payload["xg"]).requires_grad_()    # (4, 3 n)
    world = C.get_group(0)
    y = C._c_identity(x_glob, world)
    (y[:, :3] * wr).sum().backward()
    out["c_identity"] = (_np(y), _np(x_glob.grad))
    x_glob.grad = None
    y = C._mp_allreduce(x_loc, group=world)
    (y * w[:, :3]).sum().backward()
    out["mp_allreduce"] = (_np(y), _np(x_loc.grad))
    x_loc.grad = None
    y = C._c_concat(x_loc, world)
    (y * w).sum().backward()
    out["c_concat"] = (_np(y), _np(x_loc.grad))
    y = C._c_split(x_glob, world)
    (y * wr).sum().backward()
    out["c_split"] = (_np(y), _np(x_glob.grad))
    logits = torch.from_numpy(payload["logits"][r]).requires_grad_()
    label = torch.from_numpy(payload["label"])
    loss, soft = C._c_softmax_with_cross_entropy(logits, label, world,
                                                  return_softmax=True)
    loss.sum().backward()
    out["xent"] = (_np(loss), _np(soft), _np(logits.grad))
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    env = init_parallel_env()                 # up already: the same group
    out["env"] = (env.rank, env.world_size, env.nranks, str(env.device),
                  dist.get_backend())
    mesh = _fleet(dp=-1)
    out["shard_batch"] = mesh_mod.shard_batch(np.arange(2 * n))
    try:
        mesh_mod.shard_batch(np.arange(2 * n + 1))
        out["shard_batch_ragged"] = None
    except ValueError as e:
        out["shard_batch_ragged"] = str(e)
    out["util_sum"] = fleet.util.all_reduce(np.array([r + 1.0]))
    out["files"] = fleet.util.get_file_shard([f"f{i}" for i in range(5)])
    out["worker"] = (fleet.worker_index(), fleet.worker_num(),
                     fleet.is_first_worker())
    out["mesh"] = mesh.shape
    _fleet(mp=n)
    x = torch.from_numpy(payload["x"][0])                     # (4, 3)
    out["split"] = (tuple(C.split(x, (3, 2 * n), "linear", axis=1,
                                  gather_out=True).shape),
                    tuple(C.split(x, (3, 2 * n), "linear", axis=1,
                                  gather_out=False).shape),
                    tuple(C.split(torch.zeros(4, 2 * n), (2 * n, 3),
                                  "linear", axis=0).shape),
                    tuple(C.split(torch.tensor([[0, n]]), (2 * n, 5),
                                  "embedding").shape))
    return out


HCG_ACCESSORS = ("get_parallel_mode", "get_global_rank",
                 "get_data_parallel_rank", "get_data_parallel_world_size",
                 "get_model_parallel_rank", "get_model_parallel_world_size",
                 "get_stage_id", "get_pipe_parallel_world_size",
                 "is_first_stage", "is_last_stage",
                 "get_sharding_parallel_rank",
                 "get_sharding_parallel_world_size")


def hcg(payload):
    """The accessors of each topology's HybridCommunicateGroup, and each
    axis group's ranks."""
    from paddle_tpu_torch.distributed import fleet

    out = []
    for dp, pp, sd, mp in payload["dims"]:
        _fleet(dp=dp, mp=mp, pp=pp, sharding=sd)
        h = fleet.get_hybrid_communicate_group()
        acc = {name: getattr(h, name)() for name in HCG_ACCESSORS}
        acc["rank_from_stage"] = [h.get_rank_from_stage(s)
                                  for s in range(pp)]
        acc["groups"] = {axis: getattr(h, f"get_{axis}_group")().ranks
                         for axis in ("data_parallel", "model_parallel",
                                      "pipe_parallel", "sharding_parallel")}
        out.append(acc)
    return out


def tp_layers(payload):
    """The reference's tensor-parallel layer setups on its global
    weights: column -> row parallel linear, the vocab-parallel embedding
    and the parallel cross-entropy (paddle ``nn.Layer``s on the eager
    API's Tensors); outputs and gradients."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp

    tp.set_device("cpu")
    mesh = _fleet(mp=payload["mp"], dp=1)
    out = {"coord": mesh.coord}
    col = mpp.ColumnParallelLinear(8, 16, gather_output=False)
    row = mpp.RowParallelLinear(16, 8, input_is_parallel=True)
    col.set_global(payload["wc"], payload["bc"])
    row.set_global(payload["wr"], payload["br"])
    x = tp.to_tensor(payload["x"], stop_gradient=False)
    y = row(col(x))
    (y * tp.to_tensor(payload["gy"])).sum().backward()
    out["linear"] = (_np(y), _np(x.grad), _np(col.weight.grad),
                     _np(col.bias.grad), _np(row.weight.grad),
                     _np(row.bias.grad))
    gathered = mpp.ColumnParallelLinear(8, 16, gather_output=True)
    gathered.set_global(payload["wc"], payload["bc"])
    out["gather_output"] = _np(gathered(x))
    emb = mpp.VocabParallelEmbedding(32, 16)
    emb.set_global(payload["emb"])
    e = emb(tp.to_tensor(payload["ids"]))
    (e * tp.to_tensor(payload["ge"])).sum().backward()
    out["embedding"] = (_np(e), _np(emb.weight.grad))
    logits = tp.to_tensor(payload["logits"], stop_gradient=False)
    local = tp.chunk(logits, payload["mp"], axis=-1)[mesh.coord["mp"]]
    loss = mpp.ParallelCrossEntropy()(local, tp.to_tensor(
        payload["labels"]))
    loss.sum().backward()
    out["xent"] = (_np(loss), _np(logits.grad))
    # the modules' own initialisation: the slices of the one-rank layers of
    # the same seed
    out["init"] = (_np(mpp.ColumnParallelLinear(8, 16, seed=5).weight),
                   _np(mpp.RowParallelLinear(16, 8, seed=5).weight),
                   _np(mpp.VocabParallelEmbedding(32, 16, seed=5).weight))
    return out


class _Uniforms:
    """Dropout key ``order[n]`` gets ``arrays[n]`` (the test hands the
    reference the same arrays in its draw order)."""

    def __init__(self, arrays, order):
        self.arrays, self.order = arrays, order

    def __call__(self, key, shape, device):
        import torch

        a = self.arrays[self.order.index(key)]
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a).to(device)


def train(payload):
    """The port's distributed train step, one run per entry of
    ``payload["runs"]``, from the reference's global weights (the run's
    ``named``, else the payload's): losses,
    this rank's leaves (whole, by port name), the optimizer state's
    sizes."""
    import torch

    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.framework import random as trand
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTParams,
                                             build_functional_train_step)
    from paddle_tpu_torch.weights import load_jax_named_params

    results = []
    for run in payload["runs"]:
        mesh = _fleet(**run["dims"], stage=run.get("strategy_stage"))
        cfg = GPTConfig(**{**payload["cfg"], **run.get("over", {})})
        model = GPTParams(cfg, device="cpu")
        load_jax_named_params(model, run.get("named", payload["named"]))
        if run.get("dtype"):
            model.to(getattr(torch, run["dtype"]))
        old = trand.uniform
        if run.get("uniforms") is not None:
            # the step's first keys: its base key is the chain's next
            from paddle_tpu_torch.models.gpt import _step_keys

            trand.seed(0)
            keys = _step_keys(cfg, trand.next_rng_key(), 0,
                              mesh.shape["pp"] > 1)
            trand.uniform = _Uniforms(run["uniforms"],
                                      list(dict.fromkeys(keys)))
        try:
            trand.seed(0)
            step, params, opt = build_functional_train_step(model,
                                                            **run["step"])
            ids = mesh_mod.shard_batch(payload["ids"])
            labels = mesh_mod.shard_batch(payload["labels"])
            losses = []
            for _ in range(run.get("steps", 3)):
                params, opt, loss = step(params, opt, ids, labels)
                losses.append(float(loss))
        finally:
            trand.uniform = old
        full = step.unshard(params)
        results.append({
            "coord": mesh.coord, "losses": losses, "stage": step.stage,
            "heads": None if model.tp is None else model.tp.heads,
            "params": {n: _np(p.float()) for n, p in zip(step.names, full)},
            "numel": {"params": [p.numel() for p in params],
                      "m": [t.numel() for t in opt["m"]],
                      "v": [t.numel() for t in opt["v"]],
                      "whole": [p.numel() for p in full],
                      "master": [t.numel() for t in opt.get("master", [])]},
            "in_place": all(p.data_ptr() == q.data_ptr() for p, q in zip(
                params, [model.leaves()[i] for i in _held(model, step)])),
        })
    return results


def _held(model, step):
    """Indices into ``model.leaves()`` of the step's leaves."""
    names = {}
    blocks = [f"blocks.{i}.{k}" for i in range(model.cfg.num_layers)
              for k in ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w",
                        "proj_b", "ln2_g", "ln2_b", "fc1_w", "fc1_b",
                        "fc2_w", "fc2_b")]
    for i, n in enumerate(["wte", "wpe", *blocks, "lnf_g", "lnf_b"]):
        names[n] = i
    return [names[n] for n in step.names]


def decode(payload):
    """Tensor-parallel greedy, beam and int8 greedy / beam decoding from
    the reference's global weights, one result per model of
    ``payload["models"]`` (a config and its named weights)."""
    from paddle_tpu_torch.models import (build_beam_search_fn,
                                         build_generate_fn)
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTParams
    from paddle_tpu_torch.weights import load_jax_named_params

    _fleet(mp=payload["mp"])
    ids, n = payload["ids"], payload["new"]
    out = []
    for cfg, named in payload["models"]:
        model = GPTParams(GPTConfig(**cfg, use_parallel=True),
                                  device="cpu")
        load_jax_named_params(model, named)
        model.eval()
        out.append({
            "heads": model.tp.heads,
            "logits": _np(model(ids)),
            "greedy": _np(build_generate_fn(model, n)(ids)),
            "beam": _np(build_beam_search_fn(model, n, beam_size=3)(ids)),
            "int8": _np(build_generate_fn(model, n, int8=True)(ids)),
            "int8_beam": _np(build_beam_search_fn(model, n, beam_size=3,
                                                  int8=True)(ids)),
        })
    return out


def ring(payload):
    """ring_attention / ring_flash_attention over the mesh's mp axis on
    global inputs: each case's output and input gradients; the S % ring
    check."""
    import torch

    from paddle_tpu_torch.kernels.ring import (ring_attention,
                                               ring_flash_attention)

    _fleet(mp=payload["ring"])
    out = {}
    for name, case in payload["cases"].items():
        q, k, v, w = (torch.from_numpy(a) for a in (case["q"], case["k"],
                                                     case["v"], case["w"]))
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        fn = ring_flash_attention if case["flash"] else ring_attention
        o = fn(q, k, v, axis="mp", causal=case["causal"],
               layout=case["layout"], window=case.get("window"))
        (o * w).sum().backward()
        out[name] = (_np(o), _np(q.grad), _np(k.grad), _np(v.grad))
    bad = torch.zeros(1, 2, 66, 16)
    try:
        ring_attention(bad, bad, bad, axis="mp")
        out["ragged"] = None
    except ValueError as e:
        out["ragged"] = str(e)
    return out


# -- fleet on nn.Layer ---------------------------------------------------------


def _strategy(dp=1, mp=1, pp=1, sharding=1, acc=None):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                        "sharding_degree": sharding}
    if sharding > 1:
        s.sharding = True
    if acc is not None:
        s.pipeline_configs = {"accumulate_steps": acc, "micro_batch_size": 2}
    return s


def _fleet_init(**dims):
    """fleet.init over ``dims`` on the CPU; returns (strategy, hcg)."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed import fleet

    tp.set_device("cpu")
    s = _strategy(**dims)
    fleet.init(is_collective=True, strategy=s)
    return s, fleet.get_hybrid_communicate_group()


def tp_layer_train(payload):
    """A paddle nn.Layer holding a ColumnParallelLinear and a
    RowParallelLinear at mp=1, one AdamW step from the reference's
    weights: the loss and the parameters after it."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn, optimizer as opt
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                          state_dict_to_numpy)

    _fleet_init()

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.col = mpp.ColumnParallelLinear(8, 16, gather_output=False)
            self.row = mpp.RowParallelLinear(16, 8, input_is_parallel=True)

        def forward(self, x):
            return self.row(nn.functional.gelu(self.col(x)))

    with unique_name.guard():
        net = Net()
    load_paddle_state_dict(net, payload["state"])
    o = opt.AdamW(learning_rate=1e-2, parameters=net.parameters(),
                  weight_decay=0.01)
    loss = (net(tp.to_tensor(payload["x"])) ** 2).mean()
    loss.backward()
    o.step()
    return {"loss": float(loss), "state": state_dict_to_numpy(net),
            "names": [p.name for p in net.parameters()],
            "layer": [isinstance(m, nn.Layer) for m in (net.col, net.row)]}


def fleet_wrappers(payload):
    """The wrapper types ``distributed_model`` / ``distributed_optimizer``
    return for a small nn.Layer and optimizer under each parallel mode
    the payload names."""
    from paddle_tpu_torch import nn, optimizer as opt
    from paddle_tpu_torch.distributed import fleet

    out = {}
    for mode, dims in payload["modes"].items():
        _fleet_init(**dims)
        net = nn.Linear(4, 4)
        model = fleet.distributed_model(net)
        o = fleet.distributed_optimizer(
            opt.SGD(0.1, parameters=net.parameters()))
        out[mode] = (type(model).__name__, type(o).__name__)
    return out


def _adamw(params, clip=1.0, lr=1e-3):
    from paddle_tpu_torch import nn, optimizer as opt

    return opt.AdamW(learning_rate=lr, parameters=params, weight_decay=0.01,
                     grad_clip=nn.ClipGradByGlobalNorm(clip))


def _pipe(cfg_kw, state, pp, acc):
    """fleet.init at pp, a GPTForPretrainingPipe from ``state`` (the
    reference GPTForPretraining's) wrapped in PipelineParallel."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import gpt_layers
    from paddle_tpu_torch.weights import load_paddle_state_dict

    s, hcg = _fleet_init(pp=pp, acc=acc)
    with unique_name.guard():
        tp.seed(0)
        pipe = gpt_layers.GPTForPretrainingPipe(
            gpt_layers.GPTConfig(**cfg_kw), num_stages=pp)
    load_paddle_state_dict(pipe, state)
    return pipe, mpp.PipelineParallel(pipe, hcg, s)


def pipeline(payload):
    """PipelineParallel at pp=2 (one rank a stage): AdamW and clip over
    4 microbatches for 4 steps; the scheduler-and-momentum case; fresh
    dropout per step."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.weights import state_dict_to_numpy

    ids, labels = payload["ids"], payload["labels"]
    out = {}
    pipe, model = _pipe(payload["cfg"], payload["state"], 2, 4)
    params = pipe.parameters()
    o = _adamw(params)
    losses = []
    for _ in range(4):
        losses.append(float(model.train_batch(
            (tp.to_tensor(ids), tp.to_tensor(labels)), optimizer=o)))
    eng = model._engine
    out["adamw"] = {
        "losses": losses, "stage": eng.stage,
        "blocks": sorted({int(k.split(".")[1]) for k in pipe.state_dict()}),
        "other_numel": [f.numel for f in eng._flats],
        "chunks": [t.numel() for t in eng.other],
        "released": [p._t.numel() for p in eng.other_params],
        "moments": [t.numel() for t in eng.opt_state["m"]],
        "mid_numel": [p.numel() for p in eng.mid_params],
        "state": state_dict_to_numpy(model)}

    pipe, model = _pipe(payload["cfg"], payload["state2"], 2, 2)
    sched = opt.lr.StepDecay(learning_rate=0.05, step_size=1, gamma=0.5)
    o = opt.Momentum(learning_rate=sched, momentum=0.9,
                     parameters=pipe.parameters())
    ids2, labels2 = payload["ids2"], payload["labels2"]
    losses = [float(model.train_batch(
        (tp.to_tensor(ids2), tp.to_tensor(labels2)), optimizer=o,
        lr_scheduler=sched)) for _ in range(3)]
    ev = model.eval_batch((tp.to_tensor(ids2), tp.to_tensor(labels2)))
    out["momentum"] = {"losses": losses, "last_epoch": sched.last_epoch,
                       "eval": float(ev)}

    pipe, model = _pipe({**payload["cfg"], "dropout": 0.3},
                        payload["state2"], 2, 2)
    o = opt.SGD(learning_rate=0.0, parameters=pipe.parameters())
    out["dropout"] = [float(model.train_batch(
        (tp.to_tensor(ids2), tp.to_tensor(labels2)), optimizer=o))
        for _ in range(2)]
    return out


def fleet_checks(payload):
    """Two ranks: DataParallel at dp=2; the sharding optimizer at
    sharding=2 beside its unsharded run; the hybrid optimizer's clip at
    mp=2; LocalSGD; DGC's sparse exchange; the paddle GPT at mp=2
    through distributed_model / distributed_optimizer."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn, optimizer as opt
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer, LocalSGDOptimizer)
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import gpt_layers
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                          state_dict_to_numpy)

    r = dist.get_rank()
    out = {}

    # DataParallel at dp=2: the reference's test_dp_matches_single_device
    _fleet_init(dp=2)
    net = nn.Linear(4, 1)
    load_paddle_state_dict(net, payload["dp_state"])
    model = tp.DataParallel(net)
    o = opt.SGD(0.1, parameters=net.parameters())
    xb, yb = payload["dp_x"], payload["dp_y"]
    for _ in range(5):
        loss = F.mse_loss(model(tp.to_tensor(xb)),
                          tp.to_tensor(mesh_mod.shard_batch(yb)))
        loss.backward()
        o.step()
        o.clear_grad()
    out["dp"] = state_dict_to_numpy(net)

    # ZeRO-1 at sharding=2 beside the same run unsharded (dp=2)
    runs = {}
    for name, dims in (("sharded", {"sharding": 2}), ("unsharded",
                                                      {"dp": 2})):
        _fleet_init(**dims)
        with unique_name.guard():
            net = nn.Sequential(nn.Linear(8, 16), nn.GELU(),
                                nn.Linear(16, 4))
        load_paddle_state_dict(net, payload["mlp_state"])
        model = fleet.distributed_model(net)
        o = fleet.distributed_optimizer(_adamw(net.parameters(), clip=0.5,
                                               lr=1e-2))
        losses = []
        for _ in range(3):
            loss = F.mse_loss(model(tp.to_tensor(payload["mlp_x"])),
                              tp.to_tensor(mesh_mod.shard_batch(
                                  payload["mlp_y"])))
            loss.backward()
            o.step()
            o.clear_grad()
            losses.append(float(loss))
        moments = sum(v.numel() for k, v in o._inner.state_dict().items()
                      if "moment1" in k)
        runs[name] = {"losses": losses, "moments": moments,
                      "state": state_dict_to_numpy(net),
                      "model": type(model).__name__,
                      "opt": type(o._inner_wrapped).__name__}
    out["sharding"] = runs

    # the hybrid clip at mp=2: column -> row parallel, AdamW with a clip
    # that bites, one step
    s, hcg = _fleet_init(mp=2)

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.col = mpp.ColumnParallelLinear(8, 16, gather_output=False)
            self.row = mpp.RowParallelLinear(16, 8, input_is_parallel=True)

        def forward(self, x):
            return self.row(nn.functional.gelu(self.col(x)))

    net = Net()
    load_paddle_state_dict(net, payload["tp_state"])
    model = fleet.distributed_model(net)
    o = fleet.distributed_optimizer(_adamw(net.parameters(), clip=0.05,
                                           lr=1e-2))
    loss = (model(tp.to_tensor(payload["tp_x"])) ** 2).mean()
    loss.backward()
    o.step()
    out["mp_clip"] = {"state": state_dict_to_numpy(net),
                      "model": type(model).__name__}

    # LocalSGD: each rank its own data, parameters averaged every 2 steps
    _fleet_init(dp=2)
    net = nn.Linear(4, 1)
    load_paddle_state_dict(net, payload["dp_state"])
    o = LocalSGDOptimizer(opt.SGD(0.1, parameters=net.parameters()),
                          k_steps=2)
    after = []
    for i in range(3):
        x = payload["local_x"][r][i]
        loss = F.mse_loss(net(tp.to_tensor(x)),
                          tp.to_tensor(payload["local_y"][r][i]))
        loss.backward()
        o.step()
        o.clear_grad()
        after.append(state_dict_to_numpy(net))
    out["localsgd"] = after

    # DGC: tests/dgc_train_script.py's two ranks, k = 1
    n = 16
    w = tp.to_tensor(np.zeros((n,), "float32"), stop_gradient=False)
    g = np.zeros((n,), "float32")
    g[2 + r] = 10.0 * (r + 1)
    g[8] = 0.1
    w.grad = tp.to_tensor(g)
    o = DGCMomentumOptimizer(learning_rate=1.0, momentum=0.0,
                             parameters=[w], rampup_begin_step=0,
                             sparsity=[1.0 - 1.0 / n])
    o.step()
    out["dgc"] = (w.numpy(), list(o._u.values())[0].cpu().numpy())

    # the paddle GPT at mp=2, two steps through fleet's wrappers
    s, hcg = _fleet_init(mp=2)
    with unique_name.guard():
        tp.seed(0)
        cfg = gpt_layers.GPTConfig(**{**payload["gpt_cfg"],
                                      "use_parallel": True})
        gpt = gpt_layers.GPTForPretraining(cfg)
        crit = gpt_layers.GPTPretrainingCriterion()
    load_paddle_state_dict(gpt, payload["gpt_state"])
    model = fleet.distributed_model(gpt)
    o = fleet.distributed_optimizer(_adamw(gpt.parameters()))
    losses = []
    for _ in range(2):
        loss = crit(model(tp.to_tensor(payload["gpt_ids"])),
                    tp.to_tensor(payload["gpt_labels"]))
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss))
    out["gpt_mp"] = {"losses": losses, "coord": mesh_mod.get_mesh().coord,
                     "state": state_dict_to_numpy(gpt)}
    out["wrappers"] = fleet_wrappers(payload)
    return out


def solo_rank(tmp):
    """The rank of ``spawn(solo_rank, (tmp,))`` with spawn's default
    ``nprocs`` (one rank on a host without a card): a gloo group of one,
    ``all_reduce`` with the reference's arguments (positional, then the
    ``use_calc_stream`` keyword); writes its rank, world and result."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch import distributed as D

    env = D.init_parallel_env(backend="gloo",
                              store_path=os.path.join(tmp, "solo.store"),
                              timeout=GROUP_TIMEOUT)
    t = torch.arange(3.0)
    D.all_reduce(t, D.ReduceOp.SUM, None, True, True)
    D.all_reduce(t, op=D.ReduceOp.MAX, use_calc_stream=False)
    with open(os.path.join(tmp, "solo.pkl"), "wb") as f:
        pickle.dump({"rank": env.rank, "world": env.world_size,
                     "t": t.numpy()}, f)
    dist.destroy_process_group()


def bn_dp(payload):
    """ROADMAP C.4's case: BatchNorm2D at dp=2 through
    ``fleet.distributed_model``, from the reference's weights, on the
    payload's global batch (each rank takes its rows): one training
    forward, ``mean(out * g)`` on the rank's rows backward (the wrapper
    averages the parameters' gradients over dp); returns the rank's
    output rows, its input gradient, the parameters' gradients and the
    running statistics."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.weights import load_paddle_state_dict

    _fleet_init(dp=2)
    with unique_name.guard():
        bn = nn.BatchNorm2D(payload["x"].shape[1], momentum=0.8)
    load_paddle_state_dict(bn, payload["state"])
    model = fleet.distributed_model(bn)
    x = tp.to_tensor(payload["x"], stop_gradient=False)
    out = model(x)
    g = tp.to_tensor(mesh_mod.shard_batch(payload["g"]))
    tp.mean(out * g).backward()
    return {"out": _np(out), "dx": _np(x.grad),
            "dw": _np(bn.weight.grad), "db": _np(bn.bias.grad),
            "mean": _np(bn._mean), "var": _np(bn._variance)}


def rec_mp_train(payload):
    """DeepFM with its tables' rows split over mp (fleet.init at mp =
    world) from the reference's global weights, 5 Adam steps on the
    payload's batches: the losses, this rank's state and the tables'
    ``is_distributed``."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import DeepFM, RecConfig
    from paddle_tpu_torch.weights import (load_paddle_state_dict,
                                          state_dict_to_numpy)
    import torch.distributed as dist

    _fleet_init(mp=dist.get_world_size())
    with unique_name.guard():
        tp.seed(0)
        model = DeepFM(RecConfig(**payload["cfg"]))
    load_paddle_state_dict(model, payload["state"])
    o = tp.optimizer.Adam(0.02, parameters=model.parameters())
    losses = []
    for ids, dense, label in payload["batches"]:
        loss = tp.nn.functional.binary_cross_entropy_with_logits(
            model(tp.to_tensor(ids), tp.to_tensor(dense)),
            tp.to_tensor(label))
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    return {"losses": losses, "state": state_dict_to_numpy(model),
            "distributed": [model.embedding.weight.is_distributed,
                            model.fo_weight.weight.is_distributed]}


# -- the collective ops, the checkpoint, the generic step, train_gpt --------

# op -> (input slots, output slot of the gradient's cotangent); the inputs
# of each rank are payload[op][slot][rank]
COLLECTIVE_OPS = ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
                  "c_allreduce_prod", "mp_allreduce_sum", "c_identity",
                  "c_broadcast", "c_allgather", "c_reducescatter",
                  "alltoall", "c_concat", "c_split", "c_embedding",
                  "c_softmax_with_cross_entropy", "barrier",
                  "c_sync_calc_stream", "c_sync_comm_stream",
                  "c_wait_compute")


def collective_ops(payload):
    """Each collective op's outputs and (where it has one) its input
    gradients for the payload's output gradients, on this rank's inputs
    (``registry.run_kernel`` / ``registry.op_grad``, the forward on ring
    0, the world); then p2p (``send_v2`` / ``recv_v2`` / ``partial_send``
    from rank 0 to rank 1), ``c_embedding`` with this rank's own rows,
    and a static program of the tensor-parallel pattern run by the
    Executor."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as tp
    from paddle_tpu_torch.ops import registry as R

    tp.set_device("cpu")
    r = dist.get_rank()
    out = {}
    for op, case in payload["ops"].items():
        ins = {s: [torch.as_tensor(v[r])] for s, v in case["ins"].items()}
        attrs = dict(case["attrs"])
        res = R.run_kernel(R.get_op_def(op), ins, attrs)
        got = {s: _np(v[0]) for s, v in res.items()}
        if case.get("grad") is not None:
            slot, g = case["grad"]
            grads = R.op_grad(op, ins, attrs,
                              {slot: [torch.as_tensor(g[r])]})
            got["grads"] = {s: _np(v[0]) for s, v in grads.items()}
        out[op] = got
    x = torch.arange(12.0).reshape(3, 4) * (r + 1)
    if r == 0:
        R.run_kernel(R.get_op_def("send_v2"), {"X": [x]},
                     {"ring_id": 0, "peer": 1})
        R.run_kernel(R.get_op_def("partial_send"), {"X": [x]},
                     {"ring_id": 0, "peer": 1, "num": 2, "id": 1})
    elif r == 1:
        out["recv_v2"] = _np(R.run_kernel(
            R.get_op_def("recv_v2"), {},
            {"ring_id": 0, "peer": 0, "out_shape": [3, 4],
             "dtype": "float32"})["Out"][0])
        out["partial_recv"] = _np(R.run_kernel(
            R.get_op_def("recv_v2"), {},
            {"ring_id": 0, "peer": 0, "out_shape": [6],
             "dtype": "float32"})["Out"][0])
    emb = payload["emb"]
    n_local = emb["table"].shape[0] // dist.get_world_size()
    out["emb_own_rows"] = _np(R.run_kernel(
        R.get_op_def("c_embedding"),
        {"W": [torch.as_tensor(emb["table"][r * n_local:(r + 1) * n_local])],
         "Ids": [torch.as_tensor(emb["ids"])]},
        {"ring_id": 0, "start_index": r * n_local})["Out"][0])
    out["static_tp"] = _static_tp(payload["static"])
    return out


def _static_tp(p):
    """The tensor-parallel pattern as a static program (c_embedding over
    this rank's vocabulary rows, c_identity, a column-split matmul,
    c_softmax_with_cross_entropy, mean) run on this rank: the loss and
    this rank's gradients."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import static
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.ops.dispatch import dispatch_static

    tp.set_device("cpu")
    r, n = dist.get_rank(), dist.get_world_size()
    v, h = p["table"].shape
    vl = v // n
    main, startup = static.Program(), static.Program()
    tp.enable_static()
    try:
        with static.program_guard(main, startup), unique_name.guard():
            ids = static.data("ids", list(p["ids"].shape), "int64")
            label = static.data("label", list(p["label"].shape), "int64")
            table = tp.create_parameter([vl, h], "float32", name="table")
            w = tp.create_parameter([h, vl], "float32", name="w")
            x = dispatch_static("c_embedding", {"W": [table], "Ids": [ids]},
                                {"ring_id": 0, "start_index": r * vl})
            x = dispatch_static("c_identity", {"X": x["Out"]},
                                {"ring_id": 0})["Out"][0]
            logits = tp.matmul(x, w)
            loss = dispatch_static("c_softmax_with_cross_entropy",
                                   {"Logits": [logits], "Label": [label]},
                                   {"ring_id": 0})["Loss"][0]
            avg = tp.mean(loss)
            static.append_backward(avg)
    finally:
        tp.disable_static()
    exe = static.Executor(tp.CPUPlace())
    scope = static.global_scope()
    exe.run(startup)
    scope.set("table", torch.as_tensor(p["table"][r * vl:(r + 1) * vl]))
    scope.set("w", torch.as_tensor(p["w"][:, r * vl:(r + 1) * vl]))
    got = exe.run(main, feed={"ids": p["ids"], "label": p["label"]},
                  fetch_list=[avg, "table@GRAD", "w@GRAD"])
    return {"ops": [o.type for o in main.global_block().ops],
            "loss": float(got[0]), "table_grad": np.asarray(got[1]),
            "w_grad": np.asarray(got[2])}


def bn_net(P):
    """A small conv net with BatchNorm (both packages build it)."""
    nn = P.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                         nn.ReLU(), nn.Flatten(), nn.Linear(4 * 6 * 6, 5))


def bn_net_loss(P):
    def loss(m, x, y):
        return P.mean(P.nn.functional.softmax_with_cross_entropy(m(x), y))

    return loss


def step_builder_dp(payload):
    """``build_model_train_step`` over the mesh's dp x sharding group from
    the payload's state, each rank feeding its rows of each global batch:
    the losses, the final parameters and buffers."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models.step_builder import build_model_train_step
    from paddle_tpu_torch.weights import load_paddle_state_dict

    tp.set_device("cpu")
    _fleet(**payload["dims"])
    with unique_name.guard():
        tp.seed(0)
        model = bn_net(tp)
    load_paddle_state_dict(model, payload["state"])
    step, params, bufs, opt = build_model_train_step(
        model, bn_net_loss(tp), compute_dtype=None, **payload["opts"])
    losses = []
    for x, y in payload["batches"]:
        params, bufs, opt, loss = step(params, bufs, opt,
                                       mesh_mod.shard_batch(x),
                                       mesh_mod.shard_batch(y))
        losses.append(float(loss))
    return {"losses": losses, "params": [_np(p) for p in params],
            "buffers": [_np(b) for b in bufs]}


def ckpt_train(payload):
    """Per run: the distributed GPT step over the run's degrees from the
    reference's weights, ``steps`` steps, then its state saved to the
    run's directory (every rank); this rank's unsharded parameters."""
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTParams,
                                             build_functional_train_step,
                                             save_train_state)
    from paddle_tpu_torch.weights import load_jax_named_params

    out = []
    for run in payload["runs"]:
        mesh = _fleet(**run["dims"], stage=run.get("stage"))
        cfg = GPTConfig(**payload["cfg"], use_parallel=run["dims"].get(
            "mp", 1) > 1)
        model = GPTParams(cfg, device="cpu")
        load_jax_named_params(model, payload["named"])
        step, params, opt = build_functional_train_step(model, lr=1e-3)
        ids = mesh_mod.shard_batch(payload["ids"])
        labels = mesh_mod.shard_batch(payload["labels"])
        losses = []
        for _ in range(payload["steps"]):
            params, opt, loss = step(params, opt, ids, labels)
            losses.append(float(loss))
        save_train_state(step, params, opt, run["path"])
        out.append({"losses": losses, "stage": step.stage,
                    "coord": mesh.coord,
                    "params": {n: _np(p) for n, p in
                               zip(step.names, step.unshard(params))}})
    return out


def train_gpt_example(payload):
    """``examples/train_gpt.py``'s build, the reference's weights loaded
    into its model, its run: the losses."""
    from paddle_tpu_torch.examples import train_gpt
    from paddle_tpu_torch.weights import load_jax_named_params

    job = train_gpt.build(payload["argv"])
    load_jax_named_params(job.model, payload["named"])
    return {"losses": train_gpt.run(job), "coord": job.mesh.coord}


def _tp_params(layers):
    """The layers' weights and biases in order (a layer built in static
    mode holds program parameters, which it does not list)."""
    return [p for layer in layers for p in (layer.weight, layer.bias)
            if p is not None]


def static_tp_layers(payload):
    """The tensor-parallel layers on the reference's global weights at
    ``payload["mp"]``, eagerly and as a static program run by the
    Executor: the program's op types, and both runs' outputs and this
    rank's parameter gradients of ``sum(y * gy) + sum(z * gz) + sum(e *
    ge)`` (y = row(col(x)), z = row2(gather-column(x)), e = emb(ids))."""
    import torch

    import paddle_tpu_torch as tp
    from paddle_tpu_torch import static
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpp
    from paddle_tpu_torch.framework import unique_name

    tp.set_device("cpu")
    _fleet(mp=payload["mp"], dp=1)

    def build(P=tp):
        col = mpp.ColumnParallelLinear(8, 16, gather_output=False)
        row = mpp.RowParallelLinear(16, 8, input_is_parallel=True)
        gcol = mpp.ColumnParallelLinear(8, 16, gather_output=True)
        row2 = mpp.RowParallelLinear(16, 8, input_is_parallel=False)
        emb = mpp.VocabParallelEmbedding(32, 16)
        return [col, row, gcol, row2, emb]

    def forward(layers, x, ids, gy, gz, ge):
        col, row, gcol, row2, emb = layers
        y, z, e = row(col(x)), row2(gcol(x)), emb(ids)
        loss = (tp.sum(y * gy) + tp.sum(z * gz) + tp.sum(e * ge))
        return [y, z, e], loss

    weights = [(payload["wc"], payload["bc"]), (payload["wr"], payload["br"]),
               (payload["wc"], payload["bc"]), (payload["wr"], payload["br"]),
               (payload["emb"], None)]
    feeds = [payload[k] for k in ("x", "ids", "gy", "gz", "ge")]
    with unique_name.guard():
        eager = build()
    for layer, (w, b) in zip(eager, weights):
        layer.set_global(w, b)
    outs, loss = forward(eager, *[tp.to_tensor(a) for a in feeds])
    loss.backward()
    params = _tp_params(eager)
    out = {"eager": ([_np(o) for o in outs], [_np(p.grad) for p in params])}

    main, startup = static.Program(), static.Program()
    tp.enable_static()
    try:
        with static.program_guard(main, startup), unique_name.guard():
            vs = [static.data(n, list(a.shape), str(a.dtype)) for n, a in
                  zip(("x", "ids", "gy", "gz", "ge"), feeds)]
            layers = build()
            souts, sloss = forward(layers, *vs)
            static.append_backward(sloss)
    finally:
        tp.disable_static()
    exe = static.Executor(tp.CPUPlace())
    scope = static.global_scope()
    exe.run(startup)
    sparams = _tp_params(layers)
    for layer, (w, b) in zip(layers, weights):
        for p, full in ((layer.weight, w), (layer.bias, b)):
            if p is None:
                continue
            if p.tp_split is not None:
                dim, idx, _ = p.tp_split
                full = np.take(full, idx, axis=dim)
            scope.set(p.name, torch.as_tensor(np.ascontiguousarray(full)))
    got = exe.run(main, feed=dict(zip(("x", "ids", "gy", "gz", "ge"), feeds)),
                  fetch_list=souts + [p.name + "@GRAD" for p in sparams])
    out["static"] = ([np.asarray(g) for g in got[:3]],
                     [np.asarray(g) for g in got[3:]])
    out["ops"] = [o.type for o in main.global_block().ops]
    out["shapes"] = [tuple(p.shape) for p in sparams]
    return out
