from .generation import build_beam_search_fn, build_generate_fn, generate
from .gpt import (GPTConfig, GPTForPretraining, gpt_13b, gpt_1p3b, gpt_medium,
                  gpt_small, gpt_tiny)

__all__ = ["GPTConfig", "GPTForPretraining", "gpt_tiny", "gpt_small",
           "gpt_medium", "gpt_1p3b", "gpt_13b", "build_generate_fn",
           "generate", "build_beam_search_fn"]
