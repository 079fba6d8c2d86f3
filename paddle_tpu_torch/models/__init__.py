"""The port's model zoo, exported as ``paddle_tpu.models`` exports its
own: the decoder-only language models (:mod:`.gpt`, :mod:`.llama`, with
the shared decoder plumbing :mod:`.lm_utils`, KV-cache generation
:mod:`.generation` and :mod:`.speculative` decoding), the encoders
(:mod:`.bert`, :mod:`.ernie`), and the vision models (:mod:`.resnet`,
the detectors :mod:`.ppyoloe` and :mod:`.yolo`, and the text recognizer
:mod:`.ocr`, which the reference leaves to be imported by name too).
The reference's ``per_row_keys`` (JAX keys a row) is the port's
``generation.per_row_generators``."""
from . import bert  # noqa: F401
from . import ernie  # noqa: F401
from . import generation  # noqa: F401
from . import gpt  # noqa: F401
from . import llama  # noqa: F401
from . import ppyoloe  # noqa: F401
from . import resnet  # noqa: F401
from . import speculative  # noqa: F401
from . import yolo  # noqa: F401
from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel, bert_base,
                   bert_tiny)
from .ernie import (ErnieConfig, ErnieForPretraining,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel,
                    ernie_3_base, ernie_tiny)
from .generation import (GenerationEngine, generate, init_cache,  # noqa: F401
                         cache_nbytes, filter_logits, sample_logits,
                         sample_logits_rows, scatter_cache_rows,
                         slice_cache_rows)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel, gpt_1p3b, gpt_tiny  # noqa: F401
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    llama2_7b, llama_tiny)
from .ppyoloe import PPYOLOE, ppyoloe_s, ppyoloe_tiny  # noqa: F401
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101, resnet152  # noqa: F401
from .speculative import SpeculativeEngine, build_draft_model  # noqa: F401
from .yolo import YOLOv3  # noqa: F401
