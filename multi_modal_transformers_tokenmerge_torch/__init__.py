"""PyTorch / CUDA port of the multimodal token-merging transformer policy.

Mirrors the layout of ``multi_modal_transformers_tokenmerge_tpu`` and is
held against it by the ``tests/test_torch_*.py`` parity tests.  Plain
tensor code is PyTorch; the kernels of the serving path are hand-written
CUDA for Hopper (``csrc/``), built by ``_build`` at first use.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .core.config import OctoConfig
from .models.octo import Octo
from .models.presets import PRESETS, get_preset
from .serve.policy import PolicyEngine

__all__ = ["Octo", "OctoConfig", "PolicyEngine", "PRESETS", "get_preset"]
