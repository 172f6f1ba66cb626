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

from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.serving import KVPool, ServingEngine

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
        "paddle_tpu_torch.weights, chip_smoke\n"
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
        GPTForPretraining(cfg)
    model = GPTForPretraining(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)
    assert ServingEngine(model, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):     # the model lives elsewhere
        ServingEngine(model, device="meta")


def test_kv_pool_follows_the_device_policy(monkeypatch):
    """A bare KVPool is an entry point too: the card unless the caller
    passes a device, and the device's dtype (fp32 on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVPool(1, 2, 16, num_pages=4, page_size=4)
    pool = KVPool(1, 2, 16, num_pages=4, page_size=4, device="cpu")
    assert pool.buffers["k"].device.type == "cpu"
    assert pool.buffers["k"].dtype == torch.float32
