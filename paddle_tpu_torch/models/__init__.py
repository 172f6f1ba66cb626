from .bert import (BertConfig, BertForPretraining, BertModel,
                   BertPretrainingCriterion)
from .generation import build_beam_search_fn, build_generate_fn, generate
from .gpt import (GPTConfig, GPTForPretraining, gpt_13b, gpt_1p3b, gpt_medium,
                  gpt_small, gpt_tiny)
from .step_builder import build_model_train_step
from .gpt_layers import (GPTAttention, GPTEmbeddings, GPTForPretrainingPipe,
                         GPTMLP, GPTModel)

__all__ = ["GPTConfig", "GPTForPretraining", "gpt_tiny", "gpt_small",
           "gpt_medium", "gpt_1p3b", "gpt_13b", "build_generate_fn",
           "generate", "build_beam_search_fn", "BertConfig", "BertModel",
           "BertForPretraining", "BertPretrainingCriterion",
           "GPTForPretrainingPipe", "GPTModel", "GPTAttention", "GPTMLP",
           "GPTEmbeddings", "build_model_train_step"]
