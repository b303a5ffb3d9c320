"""PyTorch / CUDA port of the multimodal token-merging transformer policy.

Mirrors the layout of ``multi_modal_transformers_tokenmerge_tpu`` and is
held against it by the ``tests/test_torch_*.py`` parity tests.  Plain
tensor code is PyTorch; the kernels of the serving and training paths are
hand-written CUDA for Hopper (``csrc/``), built by ``_build`` at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The top-level names are the JAX package's (its ``__init__.py``), plus the
port's ``PRESETS``, ``CheckpointManager`` and ``make_optimizer``.
"""

from .core.config import (
    AttentionConfig,
    CategoricalHeadConfig,
    ContinuousHeadConfig,
    DiffusionHeadConfig,
    HeadsConfig,
    ImageTokenizerConfig,
    OctoConfig,
    ResNetEmbedderConfig,
    TextEncoderConfig,
    TransformerConfig,
)
from .core.yaml_loader import load_config
from .models.octo import Octo, TokenEmbeddings
from .models.presets import (PRESETS, get_preset, octo_base, octo_small,
                             octo_tiny)
from .sequence.dsl import TokenSetSpec, parse_sequence
from .sequence.layout import SequenceLayout
from .serve.policy import PolicyEngine
from .train.checkpoint import CheckpointManager
from .train.loop import evaluate, fit, graceful_stop
from .train.optim import make_optimizer
from .train.state import Metrics, OctoTrainState, create_train_state
from .train.steps import make_train_step

__version__ = "0.1.0"

__all__ = [
    "AttentionConfig", "CategoricalHeadConfig", "ContinuousHeadConfig",
    "DiffusionHeadConfig", "HeadsConfig", "ImageTokenizerConfig",
    "OctoConfig", "ResNetEmbedderConfig", "TextEncoderConfig",
    "TransformerConfig", "load_config", "Octo", "TokenEmbeddings",
    "get_preset", "octo_base", "octo_small", "octo_tiny", "TokenSetSpec",
    "parse_sequence", "SequenceLayout", "PolicyEngine", "evaluate", "fit",
    "graceful_stop", "Metrics", "OctoTrainState", "create_train_state",
    "make_train_step", "PRESETS", "CheckpointManager", "make_optimizer",
]
