"""The port's launcher, elastic restarts, auto_checkpoint and the
launcher's helpers, on the CPU; mirrors ``tests/test_launch.py``,
``tests/test_elastic.py`` and ``tests/test_auto_checkpoint.py``.

The launcher runs real trainer processes (``tests/torch_launch_script.py``
and ``tests/torch_elastic_script.py``, gloo, no JAX): two ranks through
the CLI, the fleet module path, a rank's failure stopping the rest, the
timeout's rc 124, a restart of the world that resumes from the
auto_checkpoint snapshot and ends on the parameters of an uninterrupted
run (within 1e-6: the same fp32 SGD steps, run in another process), and
a job that gives up after
``--max_restarts``.  In process: stale heartbeats, auto_checkpoint's
environment protocol and epoch-granular resume of layers, optimizers and
the global scope, and the helpers against the reference's.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import launch_utils as jlu
from paddle_tpu.distributed import utils as jutils

import paddle_tpu_torch as tp
from paddle_tpu_torch.distributed import cloud_utils, launch_utils, utils
from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus)
from paddle_tpu_torch.incubate import auto_checkpoint as acp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_launch_script.py")
ELASTIC = os.path.join(REPO, "tests", "torch_elastic_script.py")


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("PADDLE_", "MASTER_", "FLAGS_selected"))}
    env.update(OMP_NUM_THREADS="1", **kw)
    return env


def _logs(d):
    out = ""
    if os.path.isdir(d):
        for root, _, files in os.walk(d):
            for f in sorted(files):
                out += f"\n--- {f} ---\n" + open(os.path.join(root, f)).read()
    return out[-3000:]


def test_launch_cli_two_ranks(tmp_path):
    logs = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node=2", "--gpus", "3,5", "--log_dir", str(logs),
         SCRIPT, str(tmp_path)],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout, proc.stderr, _logs(logs))
    for rank, dev in ((0, "3"), (1, "5")):
        with open(tmp_path / f"result.{rank}.json") as f:
            res = json.load(f)
        assert res["world_size"] == 2 and res["rank"] == rank
        assert res["gathered"] == [1.0, 2.0]
        assert res["grad"] == [1.5] * 4
        assert res["endpoint"].startswith("127.0.0.1:")
        assert res["device_flag"] == dev


def test_fleet_launch_alias_and_args():
    """The reference's module path works and bad args fail cleanly."""
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.fleet.launch",
         "--help"], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=60)
    assert proc.returncode == 0
    for flag in ("--nproc_per_node", "--devices", "--gpus", "--tpus",
                 "--elastic", "--max_restarts", "--job_id"):
        assert flag in proc.stdout, flag
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--devices", "0", SCRIPT],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and "one id per" in proc.stderr


def test_first_failure_stops_the_rest_and_timeout_gives_124(tmp_path):
    cluster = launch_utils.Cluster(["127.0.0.1"], 2, "127.0.0.1",
                                   launch_utils.find_free_port())
    cmd = [sys.executable, "-c",
           "import os, sys, time\n"
           "if os.environ['PADDLE_TRAINER_ID'] == '1': sys.exit(3)\n"
           "time.sleep(60)"]
    t0 = time.time()
    procs = launch_utils.start_local_trainers(cluster, cmd, base_env=_env(),
                                              log_dir=str(tmp_path))
    assert launch_utils.watch_local_trainers(procs) == 3
    assert time.time() - t0 < 30
    assert all(t.proc.poll() is not None for t in procs)
    sleeper = [sys.executable, "-c", "import time; time.sleep(60)"]
    procs = launch_utils.start_local_trainers(cluster, sleeper,
                                              base_env=_env())
    assert launch_utils.watch_local_trainers(procs, timeout=1.0) == 124
    assert all(t.proc.poll() is not None for t in procs)


def test_elastic_restart_resumes_from_checkpoint(tmp_path):
    flag, run_log = tmp_path / "fail_once.flag", tmp_path / "runlog"
    final = tmp_path / "final.npy"
    env = _env(PADDLE_RUNNING_ENV="PADDLE_EDL_AUTO_CHECKPOINT",
               PADDLE_JOB_ID="elastic_it",
               PADDLE_EDL_HDFS_CHECKPOINT_PATH=str(tmp_path / "ckpt"),
               PADDLE_EDL_SAVE_CHECKPOINT_INTER="0",
               PADDLE_ELASTIC_STORE=str(tmp_path / "store"),
               PADDLE_ELASTIC_TIMEOUT="30", ELASTIC_FAIL_EPOCH="2",
               ELASTIC_FAIL_FLAG=str(flag), ELASTIC_RUN_LOG=str(run_log),
               ELASTIC_FINAL=str(final))
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--elastic", "--max_restarts", "2",
         "--log_dir", str(tmp_path / "logs"), ELASTIC],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:],
                                  _logs(tmp_path / "logs"))
    assert flag.exists()
    assert "restarting the world" in proc.stderr
    lines = [json.loads(x) for x in open(run_log).read().splitlines()]
    pids = list(dict.fromkeys(x["pid"] for x in lines))
    assert len(pids) == 2, lines
    run1 = [x for x in lines if x["pid"] == pids[0]]
    run2 = [x for x in lines if x["pid"] == pids[1]]
    assert [x["epoch"] for x in run1][:2] == [0, 1]
    assert run2 and run2[0]["epoch"] > 0, run2        # resumed, not restarted
    assert run2[-1]["epoch"] == 5
    assert run2[0]["loss"] < run1[0]["loss"] * 0.5, (run1, run2)
    assert sorted({x["epoch"] for x in lines}) == list(range(6))
    # the resumed job ends on the uninterrupted run's parameters
    sys.path.insert(0, os.path.dirname(ELASTIC))
    import torch_elastic_script as E

    tp.set_device("cpu")
    model, opt = E.build()
    E.train(range(E.EPOCHS), model, opt)
    np.testing.assert_allclose(np.load(final), model.weight.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_elastic_gives_up_after_budget(tmp_path):
    bad = tmp_path / "always_fail.py"
    bad.write_text("import sys; sys.exit(3)\n")
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "1", "--elastic", "--max_restarts", "1",
         str(bad)],
        env=_env(PADDLE_ELASTIC_STORE=str(tmp_path / "store")), cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 3
    assert proc.stderr.count("restarting the world") == 1
    assert "giving up" in proc.stderr


def test_heartbeat_stale_detection(tmp_path):
    store = str(tmp_path / "hb")
    m0 = ElasticManager(store_dir=store, rank=0, world_size=2, timeout=0.5)
    m1 = ElasticManager(store_dir=store, rank=1, world_size=2, timeout=0.5)
    watcher = ElasticManager(store_dir=store, rank=-1, world_size=2,
                             timeout=0.5)
    m0.start_beat_thread(interval=0.1)
    m1.register()           # beats once, then goes silent (a hang)
    assert watcher.watch() == ElasticStatus.HOLD
    time.sleep(0.9)
    assert watcher.failed_ranks() == [1]
    assert watcher.alive_ranks() == [0]
    assert watcher.watch() == ElasticStatus.RESTART
    m0.stop_beat_thread()
    m0.exit()
    m1.exit()
    assert watcher.watch() == ElasticStatus.COMPLETED


@pytest.fixture
def acp_env(tmp_path, monkeypatch):
    tp.set_device("cpu")
    monkeypatch.setenv("PADDLE_RUNNING_ENV", "PADDLE_EDL_AUTO_CHECKPOINT")
    monkeypatch.setenv("PADDLE_JOB_ID", "job_test_1")
    monkeypatch.setenv("PADDLE_EDL_HDFS_CHECKPOINT_PATH", str(tmp_path))
    monkeypatch.setenv("PADDLE_EDL_SAVE_CHECKPOINT_INTER", "0")
    monkeypatch.delenv("PADDLE_TRAINER_ID", raising=False)
    yield tmp_path
    acp._registered.clear()


def test_auto_checkpoint_disabled_without_env(monkeypatch):
    monkeypatch.delenv("PADDLE_RUNNING_ENV", raising=False)
    assert not acp.AutoCheckpointChecker().valid()
    assert list(acp.train_epoch_range(3)) == [0, 1, 2]


def test_resume_at_epoch_granularity(acp_env):
    """A relaunched job resumes after the last snapshot, with its
    registered layer, optimizer and global-scope values restored."""
    from paddle_tpu_torch.framework.scope import global_scope

    scope = global_scope()
    tp.seed(0)
    net = tp.nn.Linear(4, 2)
    o = tp.optimizer.Adam(0.01, parameters=net.parameters())
    acp.register(net, o)
    x = tp.to_tensor(np.ones((2, 4), "float32"))
    seen, w_after = [], {}
    for epoch in acp.train_epoch_range(5):
        net(x).sum().backward()
        o.step()
        o.clear_grad()
        scope.set("acp_counter", torch.full((3,), float(epoch)))
        seen.append(epoch)
        w_after[epoch] = net.weight.numpy().copy()
        if epoch == 3:
            break           # preempted in epoch 3: its snapshot never lands
    assert seen == [0, 1, 2, 3]
    acp._registered.clear()
    scope.set("acp_counter", torch.zeros(3))
    tp.seed(0)
    net2 = tp.nn.Linear(4, 2)
    o2 = tp.optimizer.Adam(0.01, parameters=net2.parameters())
    acp.register(net2, o2)
    r = acp.train_epoch_range(5)
    assert r.restored_from == 2
    np.testing.assert_array_equal(net2.weight.numpy(), w_after[2])
    np.testing.assert_array_equal(scope.find_var("acp_counter").numpy(),
                                  [2.0] * 3)
    assert list(r) == [3, 4]
    scope.erase("acp_counter")
    # another set of registered objects is refused
    acp._registered.clear()
    with pytest.raises(RuntimeError, match="register"):
        acp.train_epoch_range(5)


def test_helpers_match_reference():
    c = launch_utils.Cluster(["10.0.0.1", "10.0.0.2"], 2, "10.0.0.1", 6170,
                             node_rank=1)
    jc = jlu.Cluster(["10.0.0.1", "10.0.0.2"], 2, "10.0.0.1", 6170,
                     node_rank=1)
    assert c.endpoints() == jc.endpoints()
    assert c.local_ranks() == jc.local_ranks() == [2, 3]
    mine, ref = launch_utils.rank_env(c, 3, "7"), jlu.rank_env(jc, 3, "7")
    ref.pop("FLAGS_selected_tpus")
    assert {k: mine[k] for k in ref} == ref
    assert (mine["FLAGS_selected_gpus"], mine["RANK"], mine["WORLD_SIZE"],
            mine["LOCAL_RANK"]) == ("7", "3", "4", "1")
    g = utils.get_cluster(["10.0.0.1", "10.0.0.2"], "10.0.0.2",
                          devices_per_proc=[0, 1])
    jg = jutils.get_cluster(["10.0.0.1", "10.0.0.2"], "10.0.0.2",
                            devices_per_proc=[0, 1])
    assert (g.ips, g.nproc_per_node, g.node_rank) == (
        jg.ips, jg.nproc_per_node, jg.node_rank)
    assert sorted(utils.__all__) == sorted(jutils.__all__)


def test_cloud_utils_reads_the_environment(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS", "10.0.0.1,10.0.0.2")
    monkeypatch.setenv("PADDLE_TRAINER_PROCS", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_MASTER_PORT", "6170")
    cluster, ranks = cloud_utils.get_cluster_and_pod()
    assert (cluster.ips, cluster.master_port, cluster.node_rank, ranks) == (
        ["10.0.0.1", "10.0.0.2"], 6170, 1, [2, 3])
    assert cloud_utils.get_trainers_num() == 4
