"""PyTorch / CUDA port of the multimodal token-merging transformer policy.

Mirrors the layout of ``multi_modal_transformers_tokenmerge_tpu`` and is
held against it by the ``tests/test_torch_*.py`` parity tests.  Plain
tensor code is PyTorch; the kernels of the serving and training paths are
hand-written CUDA for Hopper (``csrc/``), built by ``_build`` at first use.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .core.config import OctoConfig
from .models.octo import Octo
from .models.presets import PRESETS, get_preset
from .serve.policy import PolicyEngine
from .train.checkpoint import CheckpointManager
from .train.loop import evaluate, fit, graceful_stop
from .train.optim import make_optimizer
from .train.state import create_train_state
from .train.steps import make_train_step

__all__ = ["Octo", "OctoConfig", "PolicyEngine", "PRESETS", "get_preset",
           "CheckpointManager", "create_train_state", "evaluate", "fit",
           "graceful_stop", "make_optimizer", "make_train_step"]
