"""``fleet.meta_parallel``: the tensor-parallel layers, the pipeline
layer and its 1F1B engine, the model wrappers and the sharding and
hybrid optimizers, as the reference exports them."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RNGStatesTracker,
    RowParallelLinear, VocabParallelEmbedding, get_rng_state_tracker,
    model_parallel_random_seed,
)
from .pp_layers import (LayerDesc, PipelineLayer, SegmentLayers,  # noqa: F401
                        SharedLayerDesc)
from .pipeline_engine import PipelineEngine  # noqa: F401
from .parallel_wrappers import (  # noqa: F401
    DataParallelSPMD, MetaParallelBase, PipelineParallel, ShardingParallel,
    TensorParallel,
)
from .sharding_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, HybridParallelOptimizer,
)
