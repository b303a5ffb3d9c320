"""Model presets matching the BASELINE benchmark configs.

``octo_base`` mirrors the reference's committed configuration exactly
(reference: model_configs/octo_base.yaml + vanilla_decoder.yaml +
gato_resnet.yaml + diffusion.yaml): 280x280 2-frame images, 56px patches,
16 T5 text tokens, 2x(25 image + 4 readout) tokens = 74-token sequence,
768-dim, 3-head single-block transformer, 32-step DDPM diffusion head.
"""

from __future__ import annotations

from ..core.config import (
    AttentionConfig,
    CategoricalHeadConfig,
    ContinuousHeadConfig,
    DiffusionHeadConfig,
    HeadsConfig,
    ImageTokenizerConfig,
    LatentMoETransformerConfig,
    OctoConfig,
    ResNetEmbedderConfig,
    TextEncoderConfig,
    TransformerConfig,
)

__all__ = ["octo_tiny", "octo_small", "octo_base", "octo_multicam",
           "octo_base_deep", "octo_deep", "octo_moonlight", "get_preset",
           "PRESETS"]


def octo_tiny(**overrides) -> OctoConfig:
    """BASELINE config 1: single-frame 256x256 RGB + text, MSE head."""
    cfg = OctoConfig(
        input_sequence="[TaskDescriptionPrefix{16}] [Image{16};Readout{4}]",
        token_embedding_dim=256,
        num_observation_blocks=1,
        tokens_per_readout=4,
        text=TextEncoderConfig(kind="embed", vocab_size=1024, max_length=16,
                               embedding_dim=256),
        images=ImageTokenizerConfig(
            image_size=(256, 256, 3), patch_size=64, position_interval=128,
            embedding_dim=256,
            resnet=ResNetEmbedderConfig(num_blocks=2, features=32,
                                        output_features=256)),
        transformer=TransformerConfig(
            num_blocks=2,
            attention=AttentionConfig(num_heads=4, qkv_features=256),
            mlp_dim=512),
        heads=HeadsConfig(continuous=ContinuousHeadConfig(
            max_action=1.0, action_space_dim=8)),
    )
    return cfg.replace(**overrides)


def octo_small(**overrides) -> OctoConfig:
    """BASELINE config 2: OCTO-Small with ToMe token merging."""
    cfg = OctoConfig(
        input_sequence="[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2",
        compression_sequence=(
            "[TaskDescriptionPrefix{0}] [Image{4};Readout{0}]*2"),
        token_embedding_dim=384,
        num_observation_blocks=2,
        tokens_per_readout=4,
        text=TextEncoderConfig(kind="embed", vocab_size=2048, max_length=16,
                               embedding_dim=384),
        images=ImageTokenizerConfig(
            image_size=(280, 280, 3), patch_size=56, position_interval=128,
            embedding_dim=384,
            resnet=ResNetEmbedderConfig(num_blocks=2, features=64,
                                        output_features=384)),
        transformer=TransformerConfig(
            num_blocks=6,
            attention=AttentionConfig(num_heads=6, qkv_features=384),
            mlp_dim=1536,
            compression_mode="merge", tome_merge_every=2),
        heads=HeadsConfig(continuous=ContinuousHeadConfig(
            max_action=1.0, action_space_dim=8)),
    )
    return cfg.replace(**overrides)


def octo_base(**overrides) -> OctoConfig:
    """BASELINE config 3: the reference's committed octo_base — T5 text
    tower + diffusion action head (model_configs/octo_base.yaml)."""
    cfg = OctoConfig(
        input_sequence="[TaskDescriptionPrefix{16}] [Image{25};Readout{4}]*2",
        token_embedding_dim=768,
        num_observation_blocks=2,
        tokens_per_readout=4,
        text=TextEncoderConfig(kind="t5", vocab_size=32128, max_length=16,
                               embedding_dim=768, t5_scan_unroll=0),
        images=ImageTokenizerConfig(
            image_size=(280, 280, 3), patch_size=56, position_interval=128,
            embedding_dim=768,
            resnet=ResNetEmbedderConfig(num_blocks=2, features=64,
                                        output_features=768)),
        transformer=TransformerConfig(
            num_blocks=1,
            attention=AttentionConfig(num_heads=3, qkv_features=768),
            mlp_dim=768),
        heads=HeadsConfig(
            continuous=ContinuousHeadConfig(max_action=1.0,
                                            action_space_dim=8),
            categorical=CategoricalHeadConfig(num_bins=256, max_action=1.0,
                                              action_space_dim=8),
            diffusion=DiffusionHeadConfig(diffusion_steps=32,
                                          action_space_dim=8)),
    )
    return cfg.replace(**overrides)


def octo_multicam(**overrides) -> OctoConfig:
    """BASELINE config 4: multi-camera / 2-frame history — base + wrist
    views per timestep, readout tokens, longer (124-token) sequence."""
    base = octo_base()
    cfg = base.replace(
        input_sequence=(
            "[TaskDescriptionPrefix{16}] "
            "[Image{25};Image{25};Readout{4}]*2"),
    )
    return cfg.replace(**overrides)


def octo_base_deep(**overrides) -> OctoConfig:
    """12-block OCTO-Base variant with ToMe: the regime where per-layer
    token merging actually pays (the committed reference config has ONE
    block, where compression is a no-op — BASELINE.md)."""
    base = octo_base()
    cfg = base.replace(
        compression_sequence=(
            "[TaskDescriptionPrefix{0}] [Image{4};Readout{0}]*2"),
        transformer=base.transformer.replace(
            num_blocks=12, compression_mode="merge", tome_merge_every=4),
    )
    return cfg.replace(**overrides)


def octo_deep(**overrides) -> OctoConfig:
    """ToMe flagship: 224-token sequence (2 frames x 100 image tokens at
    28px patches + readouts + 16 text tokens), 12 blocks, 4x MLP.  Grouped
    merging (`tome_merge_every=4`) sheds 32 image tokens per set at each
    merge event: 224 -> 96 tokens by block 8."""
    base = octo_base()
    cfg = base.replace(
        input_sequence=(
            "[TaskDescriptionPrefix{16}] [Image{100};Readout{4}]*2"),
        compression_sequence=(
            "[TaskDescriptionPrefix{0}] [Image{32};Readout{0}]*2"),
        images=base.images.replace(patch_size=28),
        transformer=base.transformer.replace(
            num_blocks=12, mlp_dim=3072,
            attention=base.transformer.attention.replace(num_heads=12),
            compression_mode="merge", tome_merge_every=4,
            # deep pre-LN stacks normalize the stack output
            final_norm=True),
    )
    return cfg.replace(**overrides)


def octo_moonlight(**overrides) -> OctoConfig:
    """``octo_deep``'s token layout around Moonlight-16B-A3B's 27 decoder
    layers at their published widths (huggingface.co/moonshotai/
    Moonlight-16B-A3B config.json): hidden 2048, latent attention (16 heads,
    qk 128 + 64 RoPE, v 128, kv_lora_rank 512), a dense SwiGLU first block
    and 26 layers of 64 routed experts (6 a token) and 2 shared; bfloat16
    parameters and compute.  The tower, readouts and head input are 2048
    wide; the diffusion head alone.  ToMe merges follow blocks 9 and 18
    (224 -> 160 -> 96 tokens)."""
    deep = octo_deep()
    cfg = deep.replace(
        token_embedding_dim=2048,
        images=deep.images.replace(
            embedding_dim=2048,
            resnet=deep.images.resnet.replace(output_features=2048)),
        transformer=LatentMoETransformerConfig(
            num_blocks=27,
            attention=AttentionConfig(num_heads=16, qkv_features=2048,
                                      dropout_rate=0.0, use_bias=False),
            mlp_dim=11264, mlp_activation="silu", dropout_rate=0.0,
            attention_impl="flash", compression_mode="merge",
            tome_merge_every=9, final_norm=True),
        heads=HeadsConfig(diffusion=deep.heads.diffusion),
        dtype="bfloat16", param_dtype="bfloat16",
    )
    return cfg.replace(**overrides)


PRESETS = {
    "octo_tiny": octo_tiny,
    "octo_small": octo_small,
    "octo_base": octo_base,
    "octo_multicam": octo_multicam,
    "octo_base_deep": octo_base_deep,
    "octo_deep": octo_deep,
    "octo_moonlight": octo_moonlight,
}


def get_preset(name: str, **overrides) -> OctoConfig:
    try:
        return PRESETS[name](**overrides)
    except KeyError:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}")
