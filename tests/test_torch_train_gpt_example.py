"""``paddle_tpu_torch/examples/train_gpt.py`` (BASELINE config 3) against
the reference's train step, on the CPU.

The example's :func:`build` makes the job, the reference GPT's weights
(``paddle.seed(0)``, ``--config tiny``) go into its model through
``weights.load_jax_named_params``, and :func:`run` trains 3 steps on the
seed's batch.  Its losses are held to the reference's
``build_functional_train_step`` over the same global batch with the
example's options, at ``tests/test_torch_train.py``'s fp32 loss tolerance
(1e-5 relative): on one device, and at dp 2 x mp 2 on 4 gloo ranks (each
rank's rows and tensor-parallel slices; every rank reports the global
batch's loss).  Also: the MFU's default peak is the H100's 989e12, and
the CLI runs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt

import paddle_tpu_torch as tp
from paddle_tpu_torch.examples import train_gpt
from paddle_tpu_torch.weights import load_jax_named_params
import torch_dist_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--config", "tiny", "--device", "cpu", "--steps", "3", "--seq", "64",
        "--batch", "4"]
RTOL = 1e-5


@pytest.fixture(scope="module")
def reference():
    """The reference GPT's named weights and its first 3 losses."""
    paddle.seed(0)
    jm = jgpt.GPTForPretraining(jgpt.gpt_tiny())
    named = [(n, np.asarray(p._array)) for n, p in jm.named_parameters()]
    step, params, opt = jgpt.build_functional_train_step(
        jm, lr=3e-4, remat=False, sharding_stage=None, ce_chunk_rows=0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, (4, 64)).astype("int32")
    labels = rng.randint(0, 1024, (4, 64)).astype("int64")
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, ids, labels)
        losses.append(float(np.asarray(loss)))
    return named, losses


def test_one_device_matches_reference(reference):
    named, want = reference
    tp.set_device("cpu")
    job = train_gpt.build(ARGV)
    assert job.mesh is None
    load_jax_named_params(job.model, named)
    got = train_gpt.run(job)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert len(job.step_ms) == 3 and job.tokens_per_s > 0


def test_dp2_mp2_on_gloo_matches_reference(reference, tmp_path):
    named, want = reference
    res = W.run(tmp_path, 4, "train_gpt_example",
                {"argv": ARGV + ["--dp", "2", "--mp", "2"], "named": named})
    assert sorted((r["coord"]["dp"], r["coord"]["mp"]) for r in res) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        np.testing.assert_allclose(r["losses"], want, rtol=RTOL)


def test_peak_flops_defaults_to_the_card():
    args = train_gpt.parse([])
    assert args.peak_flops == 989e12 and args.device == "gpu"
    assert args.config == "tiny" and args.batch == 8 and args.remat == "0"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.train_gpt",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "H100" in proc.stdout
    for flag in ("--dp", "--mp", "--pp", "--sharding", "--sharding-stage",
                 "--remat", "--seq-major", "--int8", "--kv-heads",
                 "--window", "--metrics-dir", "--device"):
        assert flag in proc.stdout, flag


def test_cli_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.train_gpt",
         "--device", "cpu", "--steps", "3", "--seq", "32", "--batch", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK: loss" in proc.stdout
