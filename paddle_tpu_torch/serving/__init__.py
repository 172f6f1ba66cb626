"""Paged, continuous-batching serving of a GPT (PyTorch port of
``paddle_tpu/serving``): the page pool, the prefix index, the scheduler
and its tenancy policies, the n-gram drafter, the engine, fault
injection, metrics, tracing, the flight recorder, snapshots and the
multi-replica router, the profiler bridge (``attach_profiler`` /
``detach_profiler``) and the streaming HTTP front end
(:class:`~.frontend.ServingFrontend`, :func:`~.frontend.serve`)."""

from .kv_pool import KVPool
from .prefix_cache import PrefixIndex
from .scheduler import Admission, FCFSScheduler, Request
from .tenancy import (DEFAULT_TENANT, ClusterWFQState, FCFSPolicy,
                      SchedulerPolicy, TenantConfig, WFQPolicy, make_policy)
from .metrics import (Counter, Gauge, Histogram, MetricsFileExporter,
                      MetricsRegistry, SLOTracker, aggregate_scalars,
                      cluster_prometheus, merge_registries)
from .tracing import (PID_ENGINE, PID_HOST, PID_REQUESTS, PID_ROUTER,
                      TraceRecorder, attach_profiler, detach_profiler,
                      flow_id, merge_traces, validate_trace)
from .drafter import NGramDrafter
from .flight_recorder import FlightRecorder
from .engine import TERMINAL_REASONS, FinishedRequest, ServingEngine
from .faults import FaultPlan, InjectedFault
from .snapshot import handoff_state, restore_engine, snapshot_engine
from .frontend import ServingFrontend, serve
from .router import Router, make_cluster

__all__ = ["KVPool", "PrefixIndex", "FCFSScheduler", "Request", "Admission",
           "ServingEngine", "FinishedRequest", "TERMINAL_REASONS",
           "FaultPlan", "InjectedFault", "snapshot_engine",
           "restore_engine", "handoff_state", "MetricsRegistry", "Counter",
           "Gauge", "Histogram", "MetricsFileExporter", "TraceRecorder",
           "attach_profiler", "detach_profiler", "PID_ENGINE",
           "PID_REQUESTS", "PID_HOST", "PID_ROUTER",
           "SchedulerPolicy", "FCFSPolicy", "WFQPolicy", "TenantConfig",
           "ClusterWFQState", "DEFAULT_TENANT", "make_policy",
           "ServingFrontend", "serve",
           "NGramDrafter", "Router", "make_cluster",
           "aggregate_scalars", "cluster_prometheus", "merge_registries",
           "SLOTracker", "FlightRecorder", "flow_id", "merge_traces",
           "validate_trace"]
