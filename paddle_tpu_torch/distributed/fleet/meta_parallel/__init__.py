"""Tensor-parallel layers (the rest of the reference's ``meta_parallel`` —
``PipelineLayer``, the 1F1B engine, the wrappers and the sharding
optimizer — is built on ``nn.Layer`` and ``paddle.optimizer`` and comes
after them, ROADMAP A.7)."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RNGStatesTracker,
    RowParallelLinear, VocabParallelEmbedding, get_rng_state_tracker,
    model_parallel_random_seed,
)
