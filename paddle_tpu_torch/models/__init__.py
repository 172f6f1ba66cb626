"""``paddle.models``: GPT, BERT and ERNIE, DeepFM and wide&deep,
generation, and the generic train step.

Counterpart of ``paddle_tpu/models/__init__.py``, with its names and
kinds: ``GPTForPretraining``, ``GPTModel`` and ``GPTPretrainingCriterion``
are the paddle ``nn.Layer``s of :mod:`.gpt_layers`; ``GPTParams`` (and
``GPTParamsCriterion``) is the torch parameter holder that generation,
serving and ``build_functional_train_step`` read, and each of them also
takes a paddle ``GPTForPretraining``.  :mod:`.rec` holds the sparse
recommendation models of BASELINE config 4 (``RecConfig``, ``DeepFM``,
``WideDeep``, ``FusedSparseEmbedding``, ``synthetic_click_batch``).
"""

from .gpt import (GPTConfig, GPTForPretraining, GPTForPretrainingPipe,
                  GPTModel, GPTParams, GPTParamsCriterion,
                  GPTPretrainingCriterion, build_functional_train_step,
                  gpt_13b, gpt_1p3b, gpt_medium, gpt_small, gpt_tiny)
from .bert import (BertConfig, BertForPretraining, BertModel,
                   BertPretrainingCriterion)
from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification,
                    ErnieForTokenClassification, ErnieModel,
                    ErniePretrainingCriterion, ernie_3_0_base,
                    ernie_3_0_medium, ernie_3_0_micro)
from .generation import build_beam_search_fn, build_generate_fn, generate
from .step_builder import build_model_train_step
from .gpt_layers import GPTAttention, GPTEmbeddings, GPTMLP
from .rec import (DeepFM, FusedSparseEmbedding, RecConfig, WideDeep,
                  synthetic_click_batch)

__all__ = ["GPTConfig", "GPTForPretraining", "GPTForPretrainingPipe",
           "GPTModel", "GPTPretrainingCriterion",
           "build_functional_train_step", "GPTParams", "GPTParamsCriterion",
           "gpt_tiny", "gpt_small", "gpt_medium", "gpt_1p3b", "gpt_13b",
           "build_generate_fn", "generate", "build_beam_search_fn",
           "BertConfig", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "ErnieConfig", "ErnieModel",
           "ErnieForPretraining", "ErniePretrainingCriterion",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ernie_3_0_base", "ernie_3_0_medium", "ernie_3_0_micro",
           "GPTAttention", "GPTMLP", "GPTEmbeddings",
           "build_model_train_step", "RecConfig", "FusedSparseEmbedding",
           "DeepFM", "WideDeep", "synthetic_click_batch"]
