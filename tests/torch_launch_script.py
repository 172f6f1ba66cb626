"""A training script that the port's launcher starts on two ranks
(``tests/test_torch_launch.py``): the ``PADDLE_*`` environment read,
a gloo rendezvous, a cross-rank all-gather and one data-parallel
gradient that mixes both ranks' data.  Imports no JAX."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from paddle_tpu_torch.distributed import (all_gather, all_reduce,  # noqa: E402
                                          init_parallel_env)

torch.set_num_threads(1)
env = init_parallel_env(backend="gloo")
rank, ws = env.rank, env.world_size
assert ws == 2, ws
assert env.current_endpoint and len(env.trainer_endpoints) == 2

gathered = []
all_gather(gathered, torch.tensor([float(rank + 1)]))
# rank r's rows are full of r + 1: the gradient of the global batch's mean
# of x @ w is the column mean over both ranks, (1 + 2) / 2
x = torch.full((2, 4), float(rank + 1))
w = torch.ones(4, requires_grad=True)
(g,) = torch.autograd.grad((x @ w).mean(), [w])
all_reduce(g)
g /= ws
with open(os.path.join(sys.argv[1], f"result.{rank}.json"), "w") as f:
    json.dump({"rank": rank, "world_size": ws,
               "gathered": [float(t) for t in gathered],
               "grad": g.tolist(), "endpoint": env.current_endpoint,
               "device_flag": os.environ.get("FLAGS_selected_gpus")}, f)
torch.distributed.destroy_process_group()
print(f"rank {rank} OK")
