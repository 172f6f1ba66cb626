"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points refuse to fall back to the CPU quietly.

The import check runs in a subprocess, since this test process has JAX and
the reference loaded already (tests/conftest.py imports jax).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.models import GPTConfig, GPTParams
from paddle_tpu_torch.models.gpt import build_functional_train_step
from paddle_tpu_torch.serving import (KVPool, ServingEngine, ServingFrontend,
                                      make_cluster)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    return sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_no_reference_at_runtime():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import paddle_tpu_torch, paddle_tpu_torch.models, "
        "paddle_tpu_torch.models.gpt, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.kernels, paddle_tpu_torch.kernels.flash, "
        "paddle_tpu_torch.kernels.attention, paddle_tpu_torch.ops, "
        "paddle_tpu_torch.weights, paddle_tpu_torch.serving.faults, "
        "paddle_tpu_torch.serving.flight_recorder, "
        "paddle_tpu_torch.serving.metrics, paddle_tpu_torch.serving.tracing, "
        "paddle_tpu_torch.serving.snapshot, paddle_tpu_torch.serving.router, "
        "paddle_tpu_torch.serving.tenancy, paddle_tpu_torch.utils.tensorboard, "
        "paddle_tpu_torch.serving.frontend, paddle_tpu_torch.profiler, "
        "paddle_tpu_torch.framework.random, paddle_tpu_torch.framework.flags, "
        "paddle_tpu_torch.ops.nn_ops, paddle_tpu_torch.examples.serve_gpt, "
        "paddle_tpu_torch.distributed, paddle_tpu_torch.distributed.env, "
        "paddle_tpu_torch.distributed.launch_utils, "
        "paddle_tpu_torch.distributed.spawn, "
        "paddle_tpu_torch.distributed.parallel, "
        "paddle_tpu_torch.distributed.mesh, "
        "paddle_tpu_torch.distributed.collective, "
        "paddle_tpu_torch.distributed.fleet, "
        "paddle_tpu_torch.distributed.fleet.topology, "
        "paddle_tpu_torch.distributed.fleet.distributed_strategy, "
        "paddle_tpu_torch.distributed.fleet.meta_parallel, "
        "paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers, "
        "paddle_tpu_torch.kernels.ring, paddle_tpu_torch.io, "
        "paddle_tpu_torch.io.shm_ring, paddle_tpu_torch.reader, "
        "paddle_tpu_torch.io_api, paddle_tpu_torch.utils.cpp_extension, "
        "paddle_tpu_torch.vision, paddle_tpu_torch.vision.models, "
        "paddle_tpu_torch.vision.models.resnet, "
        "paddle_tpu_torch.vision.datasets, "
        "paddle_tpu_torch.nn.layer.conv, paddle_tpu_torch.nn.layer.pooling, "
        "paddle_tpu_torch.models.step_builder, "
        "paddle_tpu_torch.nn.layer.transformer, "
        "paddle_tpu_torch.vision.models.vit, paddle_tpu_torch.models.ernie, "
        "paddle_tpu_torch.examples.train_vit, "
        "paddle_tpu_torch.examples.pretrain_bert, "
        "paddle_tpu_torch.metric, paddle_tpu_torch.models.rec, "
        "paddle_tpu_torch.examples.train_deepfm, "
        "paddle_tpu_torch.ops.collective_ops, paddle_tpu_torch.device, "
        "paddle_tpu_torch.distributed.launch, "
        "paddle_tpu_torch.distributed.checkpoint, "
        "paddle_tpu_torch.distributed.utils, "
        "paddle_tpu_torch.distributed.cloud_utils, "
        "paddle_tpu_torch.distributed.fleet.launch, "
        "paddle_tpu_torch.distributed.fleet.elastic, "
        "paddle_tpu_torch.distributed.fleet.utils.fs, "
        "paddle_tpu_torch.incubate.auto_checkpoint, "
        "paddle_tpu_torch.examples.train_gpt, "
        "paddle_tpu_torch.examples.train_multiprocess_dp, "
        "paddle_tpu_torch.hapi, paddle_tpu_torch.hapi.model, "
        "paddle_tpu_torch.hapi.callbacks, paddle_tpu_torch.hapi.progressbar, "
        "paddle_tpu_torch.hapi.dynamic_flops, "
        "paddle_tpu_torch.vision.transforms, paddle_tpu_torch.vision.ops, "
        "paddle_tpu_torch.vision.image, "
        "paddle_tpu_torch.vision.datasets.folder, "
        "paddle_tpu_torch.vision.datasets.extra, chip_smoke\n"
        "new = set(sys.modules) - before\n"
        f"bad = sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps([len(new), bad]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_new, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert n_new > 0 and bad == []


def test_no_import_statement_names_jax_or_the_reference():
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPTConfig(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                    max_seq_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTParams(cfg)
    model = GPTParams(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    assert ServingEngine(model, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cluster(model, 2, disaggregate=True)
    assert all(e.device.type == "cpu"
               for e in make_cluster(model, 2, device="cpu").replicas)
    with pytest.raises(ValueError):     # the model lives elsewhere
        ServingEngine(model, device="meta")
    # the front end serves an engine, which wants the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFrontend(ServingEngine(model))
    assert ServingFrontend(ServingEngine(model, device="cpu")).engine
    # the process group is NCCL on the card unless gloo is asked for, and
    # a distributed train step wants a group: neither runs on the CPU
    # quietly
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        init_parallel_env()
    with pytest.raises(RuntimeError, match="process group"):
        build_functional_train_step(model, mesh=object())
    with pytest.raises(RuntimeError, match="process group"):
        build_functional_train_step(model, dp_axis="dp")
    # the examples of the distributed slice default to the card
    from paddle_tpu_torch.examples import train_gpt, train_multiprocess_dp

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_gpt.build(["--steps", "1"])
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        train_multiprocess_dp.main(["--steps", "1"])


def test_serve_cli_wants_the_card_without_device():
    """``python -m paddle_tpu_torch.examples.serve_gpt`` without
    ``--device`` and with no card visible stops with the device policy's
    error; it does not fall back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.serve_gpt",
         "--requests", "1"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert "requests" not in proc.stdout


def test_kv_pool_follows_the_device_policy(monkeypatch):
    """A bare KVPool is an entry point too: the card unless the caller
    passes a device, and the device's dtype (fp32 on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVPool(1, 2, 16, num_pages=4, page_size=4)
    pool = KVPool(1, 2, 16, num_pages=4, page_size=4, device="cpu")
    assert pool.buffers["k"].device.type == "cpu"
    assert pool.buffers["k"].dtype == torch.float32


EAGER_MODULES = (
    "paddle_tpu_torch.framework", "paddle_tpu_torch.framework.dtype",
    "paddle_tpu_torch.framework.place", "paddle_tpu_torch.framework.scope",
    "paddle_tpu_torch.framework.unique_name",
    "paddle_tpu_torch.framework.nan_inf",
    "paddle_tpu_torch.framework.program", "paddle_tpu_torch.ops.registry",
    "paddle_tpu_torch.ops.dispatch", "paddle_tpu_torch.ops.math_ops",
    "paddle_tpu_torch.ops.activation_ops", "paddle_tpu_torch.ops.tensor_ops",
    "paddle_tpu_torch.ops.optimizer_ops", "paddle_tpu_torch.dygraph",
    "paddle_tpu_torch.dygraph.tensor", "paddle_tpu_torch.dygraph.tracer",
    "paddle_tpu_torch.dygraph.engine", "paddle_tpu_torch.dygraph.base",
    "paddle_tpu_torch.tensor_api", "paddle_tpu_torch.autograd",
    "paddle_tpu_torch.nn", "paddle_tpu_torch.nn.layer_base",
    "paddle_tpu_torch.nn.initializer", "paddle_tpu_torch.nn.functional",
    "paddle_tpu_torch.nn.layer.common", "paddle_tpu_torch.nn.layer.norm",
    "paddle_tpu_torch.nn.layer.activation", "paddle_tpu_torch.nn.layer.loss",
    "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.optimizer.lr", "paddle_tpu_torch.regularizer",
    "paddle_tpu_torch.amp", "paddle_tpu_torch.amp.auto_cast",
    "paddle_tpu_torch.amp.grad_scaler", "paddle_tpu_torch.models.bert",
    "paddle_tpu_torch.examples.pretrain_bert",
    "paddle_tpu_torch.static", "paddle_tpu_torch.static.executor",
    "paddle_tpu_torch.static.backward", "paddle_tpu_torch.static.io",
    "paddle_tpu_torch.static.amp", "paddle_tpu_torch.static.nn",
    "paddle_tpu_torch.static.control_flow", "paddle_tpu_torch.static.input",
    "paddle_tpu_torch.fluid", "paddle_tpu_torch.fluid.layers",
    "paddle_tpu_torch.fluid.dygraph", "paddle_tpu_torch.fluid.io",
    "paddle_tpu_torch.fluid.contrib", "paddle_tpu_torch.examples.fluid_mnist",
    "paddle_tpu_torch.ops.quant_ops", "paddle_tpu_torch.jit",
    "paddle_tpu_torch.jit.dy2static", "paddle_tpu_torch.static.quant_int8",
    "paddle_tpu_torch.inference", "paddle_tpu_torch.incubate",
    "paddle_tpu_torch.incubate.quant", "paddle_tpu_torch.examples.infer_int8",
    "paddle_tpu_torch.examples.fluid_word2vec",
    "paddle_tpu_torch.text", "paddle_tpu_torch.text.datasets",
    "paddle_tpu_torch.dataset", "paddle_tpu_torch.dataset.cifar",
    "paddle_tpu_torch.dataset.conll05", "paddle_tpu_torch.dataset.flowers",
    "paddle_tpu_torch.dataset.imdb", "paddle_tpu_torch.dataset.imikolov",
    "paddle_tpu_torch.dataset.mnist", "paddle_tpu_torch.dataset.movielens",
    "paddle_tpu_torch.dataset.uci_housing",
    "paddle_tpu_torch.dataset.voc2012", "paddle_tpu_torch.dataset.wmt14",
    "paddle_tpu_torch.dataset.wmt16", "paddle_tpu_torch.distribution",
    "paddle_tpu_torch.linalg", "paddle_tpu_torch.onnx",
    "paddle_tpu_torch.onnx.proto", "paddle_tpu_torch.onnx.convert",
    "paddle_tpu_torch.onnx.runner", "paddle_tpu_torch.incubate.asp",
    "paddle_tpu_torch.framework.crypto", "paddle_tpu_torch.utils",
    "paddle_tpu_torch.utils.download", "paddle_tpu_torch.utils.cpp_extension",
    "paddle_tpu_torch.hub", "paddle_tpu_torch.compat",
    "paddle_tpu_torch.sysconfig", "paddle_tpu_torch.version",
    "paddle_tpu_torch.fluid.contrib.slim.quantization")


def test_eager_core_imports_no_jax_and_no_reference():
    """Every module of the eager core, the layers, the optimizers, amp and
    BERT imports in a fresh process without JAX or the reference."""
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {EAGER_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        f"bad = sorted(m for m in new if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps([len(new), bad]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_new, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert n_new > len(EAGER_MODULES) and bad == []


def test_to_tensor_wants_the_card_without_set_device():
    """The eager API's place is the card: without one, and without
    ``set_device("cpu")``, making a tensor raises; after it, it works."""
    code = (
        "import paddle_tpu_torch as paddle\n"
        "try:\n"
        "    paddle.to_tensor([1.0])\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "paddle.set_device('cpu')\n"
        "print('cpu:', paddle.to_tensor([1.0]).place)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("PADDLE_TPU_DEVICE", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "raised:" in proc.stdout and "set_device('cpu')" in proc.stdout
    assert "cpu: CPUPlace(0)" in proc.stdout
