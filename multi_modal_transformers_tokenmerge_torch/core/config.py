"""Typed, frozen model configuration.

The same frozen dataclasses and field names as the JAX package's
``core/config.py``, so a configuration describes the same model in both
packages.  Dtype strings map to torch dtypes.  ``attention_impl``,
``flash_*`` and ``pool_vjp`` choose between a plain path and a kernel as
they do in the JAX package (``modules.attention.select_attention_fn``,
``modules.image_tokenizer``), and raise where the choice is not ported.
Fields that only select a JAX layout or compilation (``conv_layout``,
``sampler_impl``, ``t5_scan_unroll``) are accepted and do not change the
port's arithmetic.  ``remat`` rematerializes the transformer blocks in
the backward (``core.replay.checkpointed``), as ``nn.remat`` does: less
memory, one more forward a block, the same results.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

__all__ = [
    "ResNetEmbedderConfig",
    "ImageTokenizerConfig",
    "TextEncoderConfig",
    "AttentionConfig",
    "MoEConfig",
    "TransformerConfig",
    "LatentMoETransformerConfig",
    "ContinuousHeadConfig",
    "CategoricalHeadConfig",
    "DiffusionHeadConfig",
    "HeadsConfig",
    "OctoConfig",
    "resolve_dtype",
]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; one of {sorted(_DTYPES)}")


class _Replaceable:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ResNetEmbedderConfig(_Replaceable):
    """Per-patch ResNetV2 conv embedder."""

    num_blocks: int = 2
    features: int = 64
    input_kernel: Tuple[int, int] = (12, 12)
    input_stride: Tuple[int, int] = (2, 2)
    pool_window: Tuple[int, int] = (3, 3)
    pool_stride: Tuple[int, int] = (1, 1)
    block_kernel: Tuple[int, int] = (3, 3)
    group_norm_groups: int = 32
    group_norm_epsilon: float = 1e-6
    output_features: int = 768
    # 'image' pools GroupNorm statistics over every patch and frame of a
    # batch element (the reference's flax-default reduction); 'patch'
    # normalizes each patch on its own.
    norm_stats_scope: str = "image"  # 'image' | 'patch'
    conv_layout: str = "hwcn"  # JAX layout choice; the port is NCHW
    # max-pool backward: 'xla' (= 'auto') torch's own, 'pallas' the kernel
    pool_vjp: str = "xla"


@dataclass(frozen=True)
class ImageTokenizerConfig(_Replaceable):
    """Patchify + patch-position encoding + conv embed."""

    image_size: Tuple[int, int, int] = (280, 280, 3)
    patch_size: int = 56
    normalize: bool = True
    position_interval: int = 128
    rng_collection: str = "patch_encoding"
    embedding_dim: int = 768
    resnet: ResNetEmbedderConfig = field(default_factory=ResNetEmbedderConfig)

    @property
    def patches_per_dim(self) -> int:
        return self.image_size[0] // self.patch_size

    @property
    def tokens_per_image(self) -> int:
        return self.patches_per_dim ** 2


@dataclass(frozen=True)
class TextEncoderConfig(_Replaceable):
    """``kind='embed'``: learned token + position embeddings;
    ``kind='t5'``: the frozen T5-architecture encoder."""

    kind: str = "embed"  # 'embed' | 't5'
    vocab_size: int = 32128
    max_length: int = 16
    embedding_dim: int = 768
    t5_num_layers: int = 12
    t5_num_heads: int = 12
    t5_d_ff: int = 3072
    t5_d_kv: int = 64
    t5_rel_pos_buckets: int = 32
    t5_rel_pos_max_distance: int = 128
    t5_scan_unroll: int = 1  # JAX scan option; unused by the port
    frozen: bool = True


@dataclass(frozen=True)
class AttentionConfig(_Replaceable):
    num_heads: int = 3
    qkv_features: int = 768
    dropout_rate: float = 0.1
    use_bias: bool = True


@dataclass(frozen=True)
class MoEConfig(_Replaceable):
    num_experts: int = 4
    top_k: int = 1
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class TransformerConfig(_Replaceable):
    """Stacked pre-LN encoder blocks."""

    num_blocks: int = 1
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    mlp_dim: int = 768
    mlp_activation: str = "relu"
    mlp_type: str = "dense"  # 'dense' | 'moe'
    moe: MoEConfig = field(default_factory=MoEConfig)
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    # 'features' is standard LN; 'sequence_compat' reproduces the
    # reference's LayerNorm over the sequence axis
    layer_norm_reduction: str = "features"
    attention_impl: str = "auto"
    flash_min_seq: int = 1024
    flash_block_q: int = 0
    flash_block_k: int = 0
    flash_backward: str = "pallas"
    compression_mode: str = "none"  # 'none' | 'merge' | 'prune'
    tome_merge_every: int = 1
    prestack_merge: bool = False
    proportional_attention: bool = False
    remat: bool = False
    final_norm: bool = False


@dataclass(frozen=True)
class LatentMoETransformerConfig(TransformerConfig):
    """A DeepSeek-V3-style decoder stack (``modules.latent_moe``): pre-
    RMSNorm blocks of latent attention (MLA, no query compression) with
    decoupled RoPE, the first ``first_k_dense_replace`` blocks with a dense
    SwiGLU MLP of width ``mlp_dim``, the rest a dropless routed layer of
    ``n_routed_experts`` SwiGLU experts of width ``moe_intermediate_size``
    (sigmoid scores, top ``num_experts_per_tok`` by score plus a selection
    bias, the chosen scores normalised to sum to one, the published
    ``norm_topk_prob``, and scaled by ``routed_scaling_factor``) beside
    ``n_shared_experts`` shared experts, and a final RMSNorm.  Field names
    follow the published ``config.json``.

    Of the base fields the stack reads ``num_blocks``,
    ``attention.num_heads``, ``mlp_dim``, ``attention_impl``,
    ``compression_mode`` ('merge'), ``tome_merge_every`` (blocks a stage)
    and ``final_norm``; it has no dropout, no biases and no learned
    position embedding.  A class of its own, so that no field is added to
    the configurations of the other stacks."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    first_k_dense_replace: int = 1
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446


@dataclass(frozen=True)
class ContinuousHeadConfig(_Replaceable):
    max_action: float = 1.0
    action_space_dim: int = 8
    pooling: str = "mean"
    map_num_heads: int = 3


@dataclass(frozen=True)
class CategoricalHeadConfig(_Replaceable):
    num_bins: int = 256
    max_action: float = 1.0
    action_space_dim: int = 8


@dataclass(frozen=True)
class DiffusionHeadConfig(_Replaceable):
    """DDPM action head."""

    diffusion_steps: int = 32
    action_space_dim: int = 8
    time_dim: int = 768
    mlp_dim: int = 768
    num_blocks: int = 1
    dropout_rate: float = 0.1
    clip_value: float = 5.0
    rng_collection: str = "diffusion"
    # 'folded': fresh noise at every step, none added at t=0;
    # 'reference': the reference's sampler — the initial sample's noise is
    # reused at every step and noise is still added at t=0
    sampler_rng_mode: str = "folded"
    sampler_impl: str = "auto"  # JAX option; the port's path follows the device
    # deterministic DDIM (eta=0) with this many steps instead of DDPM
    ddim_steps: Optional[int] = None
    ddim_eps_mode: str = "raw"  # 'raw' | 'recompute'


@dataclass(frozen=True)
class HeadsConfig(_Replaceable):
    continuous: Optional[ContinuousHeadConfig] = None
    categorical: Optional[CategoricalHeadConfig] = None
    diffusion: Optional[DiffusionHeadConfig] = None


@dataclass(frozen=True)
class OctoConfig(_Replaceable):
    input_sequence: str = "[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2"
    compression_sequence: Optional[str] = None
    token_embedding_dim: int = 768
    num_observation_blocks: int = 2
    tokens_per_readout: int = 4

    text: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    images: ImageTokenizerConfig = field(default_factory=ImageTokenizerConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    heads: HeadsConfig = field(
        default_factory=lambda: HeadsConfig(continuous=ContinuousHeadConfig())
    )

    dtype: str = "float32"
    param_dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return resolve_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return resolve_dtype(self.param_dtype)
