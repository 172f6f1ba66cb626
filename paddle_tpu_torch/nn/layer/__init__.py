"""The layers (counterpart of ``paddle_tpu/nn/layer``): common, conv,
pooling, norm, activation, loss, transformer, rnn and extras."""

from .common import (  # noqa: F401
    Bilinear, CosineSimilarity, Dropout, Dropout2D, Embedding, Flatten,
    Identity, Linear, Pad2D, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D,
)
from .conv import Conv1D, Conv2D, Conv2DTranspose  # noqa: F401
from .pooling import (  # noqa: F401
    AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool1D, AvgPool2D, MaxPool1D,
    MaxPool2D,
)
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SyncBatchNorm,
)
from .activation import (  # noqa: F401
    ELU, GELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
    LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, SELU, SiLU,
    Sigmoid, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh, Tanhshrink,
    ThresholdedReLU,
)
from .loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, KLDivLoss, L1Loss,
    MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from .rnn import (  # noqa: F401
    RNNCellBase, SimpleRNNCell, LSTMCell, GRUCell, RNN, BiRNN,
    SimpleRNN, LSTM, GRU,
)
from .extras import (  # noqa: F401
    Silu, AlphaDropout, Dropout3D, Pad1D, Pad3D, PairwiseDistance,
    PixelShuffle, Unfold, SpectralNorm, LayerDict, MaxPool1D, AvgPool1D,
    MaxPool3D, AvgPool3D, AdaptiveAvgPool1D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool3D, Conv3D, Conv3DTranspose,
    Conv1DTranspose, CTCLoss, HSigmoidLoss, BeamSearchDecoder,
    dynamic_decode,
)
