"""``paddle.nn`` (port of ``paddle_tpu/nn/__init__.py``): the layers,
``Layer``, ``functional``, ``initializer``, beam search (``decode``) and
the parameter reparametrizations (``utils``), under the reference's
names."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import (  # noqa: F401
    Layer,
    Parameter,
    buffer_state,
    functional_call,
    param_state,
    rng_context,
    take_rng_key,
)
from .layers.activation import (  # noqa: F401
    CELU, ELU, GELU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, Sigmoid, Silu, Softmax, Softmax2D, Softplus, Softshrink,
    Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU,
)
from .layers.common import (  # noqa: F401
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, Linear, Pad1D,
    Pad2D, Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle, Unfold,
    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
)
from .layers.containers import (  # noqa: F401
    LayerDict, LayerList, ParameterList, Sequential,
)
from .layers.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
)
from .layers.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, HingeEmbeddingLoss, HSigmoidLoss, KLDivLoss, L1Loss,
    MarginRankingLoss, MSELoss, MultiLabelSoftMarginLoss, MultiMarginLoss,
    NLLLoss, SmoothL1Loss, SoftMarginLoss, TripletMarginLoss,
    TripletMarginWithDistanceLoss,
)
from .layers.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm, InstanceNorm1D,
    InstanceNorm2D, InstanceNorm3D, LayerNorm, LocalResponseNorm, RMSNorm,
    SpectralNorm, SyncBatchNorm,
)
from .layers.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D,
)
from .layers.rnn import (  # noqa: F401
    GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell,
)
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401
from . import decode  # noqa: F401
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .layers.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder, TransformerDecoderLayer,
    TransformerEncoder, TransformerEncoderLayer,
)
from . import utils  # noqa: F401
