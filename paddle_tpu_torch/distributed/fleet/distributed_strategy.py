"""DistributedStrategy: the switches and degrees of a distributed run.

Counterpart of ``paddle_tpu/distributed/fleet/distributed_strategy.py``
(its own copy, the same fields and defaults).  ``hybrid_configs`` merges
what is assigned into its defaults; the train step reads
``sharding_configs["stage"]`` when it is not given a ZeRO stage.
"""

from __future__ import annotations

from typing import Dict


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.amp_configs: Dict = {
            "init_loss_scaling": 32768.0, "use_dynamic_loss_scaling": True,
            "custom_white_list": [], "custom_black_list": [],
            "use_pure_fp16": False,
        }
        self.recompute = False
        self.recompute_configs: Dict = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs: Dict = {"k_steps": 1, "avg": True}
        self.pipeline = False
        self.pipeline_configs: Dict = {"accumulate_steps": 1,
                                       "micro_batch_size": 1}
        self.sharding = False
        self.sharding_configs: Dict = {
            "sharding_degree": 1, "stage": 1, "segment_broadcast_MB": 32.0,
            "offload": False,
        }
        self.tensor_parallel = False
        self.tensor_parallel_configs: Dict = {"tensor_parallel_degree": 1}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.a_sync = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.gradient_scale_configs: Dict = {"scale_strategy": "avg"}
        self.hybrid_configs: Dict = {
            "dp_degree": -1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1,
        }

    def __setattr__(self, k, v):
        if k == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            merged = dict(self.__dict__["hybrid_configs"])
            merged.update(v)
            self.__dict__[k] = merged
            return
        self.__dict__[k] = v

    def __repr__(self):
        on = [k for k, v in self.__dict__.items() if v is True]
        return f"DistributedStrategy(enabled={on}, hybrid={self.hybrid_configs})"
