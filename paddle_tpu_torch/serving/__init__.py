"""Paged, continuous-batching serving of a GPT (PyTorch port of
``paddle_tpu/serving``): the page pool, the prefix index, the FCFS
scheduler, the n-gram drafter and the engine."""

from .drafter import NGramDrafter
from .engine import FinishedRequest, ServingEngine
from .kv_pool import KVPool
from .prefix_cache import PrefixIndex
from .scheduler import Admission, FCFSScheduler, Request
from .tenancy import FCFSPolicy, SchedulerPolicy, make_policy

__all__ = ["ServingEngine", "FinishedRequest", "KVPool", "NGramDrafter",
           "PrefixIndex", "FCFSScheduler", "Request", "Admission",
           "SchedulerPolicy", "FCFSPolicy", "make_policy"]
