"""The legacy model families.

Counterpart of the JAX package's ``models/legacy.py``:

* :class:`GatoConceptLearner`: a decoder over text and interleaved
  (image tokens, action token) observation blocks under a padding mask,
  predicting the next action's logits at the episode's frontier;
* :class:`SingleImageConceptLearner`: text and one image, a flattened
  classification head; :func:`attention_importance` reads its attention
  weights through ``modules.attention.capture_intermediates``;
* :class:`ConceptLearnerMetaLoss`: text, image and action -> |scalar|;
* :class:`ConceptPlanner`: next-token logits and a state value, with
  greedy generation as a loop on the device (no host read-back);
* :class:`VisualConceptPlanner`: a pair of train states;
* :class:`PointCloudTransformer`: LBR x2 -> SampleAndGroup x2 ->
  OffsetAttention x4 -> concat.

Flax infers a Dense's input width at its first call; here it is fixed when
the module is built, so the flattened heads take the text length from the
configuration (``ConceptLearnerConfig.text.max_length``, or the planner's
``text_length``).  Weights come across with ``convert.from_flax_variables``.
Train mode needs a ``patch_encoding`` generator for the image tokens and,
with dropout, a ``dropout`` one (``rngs``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from ..core.config import (AttentionConfig, ImageTokenizerConfig,
                           ResNetEmbedderConfig, TextEncoderConfig,
                           TransformerConfig)
from ..modules.attention import EncoderBlock, capture_intermediates
from ..modules.image_tokenizer import ImageTokenizer
from ..modules.layers import BatchNorm, Dense, Embed
from ..modules.offset_attention import OffsetAttention
from ..modules.pointcloud import SampleAndGroup
from ..modules.text import EmbedTextEncoder
from ..modules.value_tokenizer import ActionTokenizer

__all__ = ["ConceptLearnerConfig", "make_concept_learner",
           "GatoConceptLearner", "SingleImageConceptLearner",
           "attention_importance", "ConceptLearnerMetaLoss",
           "ConceptPlanner", "VisualConceptPlanner",
           "PointCloudTransformerConfig", "PointCloudTransformer"]


@dataclass(frozen=True)
class ConceptLearnerConfig:
    text: TextEncoderConfig = field(default_factory=lambda: TextEncoderConfig(
        kind="embed", vocab_size=256, max_length=8, embedding_dim=64))
    images: ImageTokenizerConfig = field(
        default_factory=lambda: ImageTokenizerConfig(
            image_size=(64, 64, 3), patch_size=32, position_interval=16,
            embedding_dim=64,
            resnet=ResNetEmbedderConfig(
                num_blocks=1, features=8, input_kernel=(8, 8),
                input_stride=(4, 4), group_norm_groups=4,
                output_features=64)))
    transformer: TransformerConfig = field(
        default_factory=lambda: TransformerConfig(
            num_blocks=2,
            attention=AttentionConfig(num_heads=2, qkv_features=64),
            mlp_dim=128))
    num_actions: int = 32
    max_seq_len: int = 4  # observation blocks per episode
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _padding_attention_mask(valid: torch.Tensor) -> torch.Tensor:
    """(B, S) validity -> (B, 1, S, S) bool mask (heads broadcast)."""
    return (valid[:, :, None] & valid[:, None, :])[:, None]


class _LegacyModule(nn.Module):
    """Shared construction: the config, the layers' keyword arguments and
    the flax initializers' draws."""

    def __init__(self, cfg, device):
        super().__init__()
        self.config = cfg
        self.kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype,
                       device=device)

    def reset_parameters(self, seed: int) -> None:
        device = next(self.parameters()).device
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)


class _EncoderStackLoop(nn.Module):
    """Unrolled encoder blocks ``block_{i}`` (the JAX module's names)."""

    def __init__(self, cfg: TransformerConfig, features: int, **kw):
        super().__init__()
        self.num_blocks = cfg.num_blocks
        for i in range(cfg.num_blocks):
            setattr(self, f"block_{i}", EncoderBlock(cfg, features, **kw))

    def forward(self, x, mask, train: bool = False,
                rng: Optional[torch.Generator] = None):
        for i in range(self.num_blocks):
            x = getattr(self, f"block_{i}")(x, mask, train, rng)
        return x


def _flax_dense(in_features, out_features, **kw) -> Dense:
    """flax ``nn.Dense``'s defaults: lecun-normal kernel, zero bias."""
    return Dense(in_features, out_features, kernel_init="lecun",
                 bias_init="zeros", **kw)


def _rng(rngs: Optional[Mapping], name: str):
    return (rngs or {}).get(name)


def make_concept_learner(version: str, cfg: "ConceptLearnerConfig",
                         **kw):
    """'v1' is the GATO-style multi-observation decoder, 'v2' the
    single-image variant."""
    if version == "v1":
        return GatoConceptLearner(cfg, **kw)
    if version == "v2":
        return SingleImageConceptLearner(cfg, **kw)
    raise NotImplementedError(f"ConceptLearner version {version!r}")


class GatoConceptLearner(_LegacyModule):
    """Decoder over [text, (image tokens, action token) x T] sequences,
    predicting the next action's logits at the episode's frontier."""

    def __init__(self, cfg: ConceptLearnerConfig, *, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__(cfg, device)
        kw, e = self.kw, cfg.images.embedding_dim
        self.p = cfg.images.tokens_per_image
        self.text_encoder = EmbedTextEncoder(cfg.text, **kw)
        self.image_encoder = ImageTokenizer(cfg.images, **kw)
        self.action_tokenizer = ActionTokenizer(cfg.num_actions, e, **kw)
        self.observation_position_embedding = Embed(self.p + 1, e, **kw)
        self.transformer = _EncoderStackLoop(cfg.transformer, e, **kw)
        self.output_dense = _flax_dense(e, cfg.num_actions, **kw)
        if seed is not None:
            self.reset_parameters(seed)

    def forward(self, text, images, actions, train: bool = False,
                rngs: Optional[Mapping] = None, positions=None):
        b, t = images.shape[:2]
        p = self.p
        text_emb = self.text_encoder(text)
        img_emb = self.image_encoder(
            images, train, positions,
            _rng(rngs, self.config.images.rng_collection)).reshape(
                b, t, p, -1)
        act_emb = self.action_tokenizer(actions)
        obs = torch.cat([img_emb, act_emb[:, :, None, :]], dim=2)
        pos = self.observation_position_embedding(
            torch.arange(p + 1, device=images.device))
        obs = (obs + pos[None, None]).reshape(b, t * (p + 1), -1)
        x = torch.cat([text_emb, obs], dim=1)
        # action id 0 marks an unfilled observation block
        obs_valid = (actions != 0).repeat_interleave(p + 1, dim=-1)
        text_valid = torch.ones((b, text_emb.shape[1]), dtype=torch.bool,
                                device=images.device)
        mask = _padding_attention_mask(torch.cat([text_valid, obs_valid],
                                                 dim=-1))
        x = self.transformer(x, mask, train, _rng(rngs, "dropout"))
        logits = self.output_dense(x)
        # the action slot of the first unfilled block
        target_block = (actions == 0).int().argmax(dim=-1)
        target_idx = text_emb.shape[1] + (target_block + 1) * (p + 1) - 1
        return logits[torch.arange(b, device=logits.device), target_idx]


class SingleImageConceptLearner(_LegacyModule):
    """Text + one image through the encoder blocks, flattened into a
    classification head."""

    def __init__(self, cfg: ConceptLearnerConfig, *, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__(cfg, device)
        kw, e = self.kw, cfg.images.embedding_dim
        tokens = cfg.text.max_length + cfg.images.tokens_per_image
        self.text_encoder = EmbedTextEncoder(cfg.text, **kw)
        self.image_encoder = ImageTokenizer(cfg.images, **kw)
        self.transformer = _EncoderStackLoop(cfg.transformer, e, **kw)
        self.output_dense = _flax_dense(tokens * e, cfg.num_actions, **kw)
        if seed is not None:
            self.reset_parameters(seed)

    def forward(self, text, images, train: bool = False,
                rngs: Optional[Mapping] = None, positions=None):
        img = self.image_encoder(
            images, train, positions,
            _rng(rngs, self.config.images.rng_collection))
        x = torch.cat([self.text_encoder(text), img], dim=1)
        x = self.transformer(x, None, train, _rng(rngs, "dropout"))
        return self.output_dense(x.reshape(x.shape[0], -1))


def attention_importance(model: nn.Module, *inputs, layer: int = 0):
    """Per-token importance at ``layer``: the attention weight each key
    receives, averaged over heads and queries and renormalized to sum to
    one, (B, K).  Runs ``model(*inputs)`` under ``capture_intermediates``;
    works for unrolled ``block_{i}`` stacks and for the stacked
    ``TransformerStack`` (one (L, B, H, Q, K) entry)."""
    with torch.no_grad(), capture_intermediates(model) as inter:
        model(*inputs)
    w = None
    for key, calls in inter.items():
        if f"block_{layer}/" in key:
            w = calls[0][0]
    if w is None:
        stacked = [calls[0] for key, calls in inter.items()
                   if "block_" not in key]
        if stacked and stacked[0].dim() == 5:
            if not 0 <= layer < stacked[0].shape[0]:
                raise ValueError(f"layer {layer} out of range for a "
                                 f"{stacked[0].shape[0]}-block stack")
            w = stacked[0][layer]
    if w is None:
        raise ValueError(f"no attention weights recorded for layer {layer}")
    importance = w.mean(dim=(1, 2))
    return importance / importance.sum(-1, keepdim=True)


class ConceptLearnerMetaLoss(_LegacyModule):
    """text + image + action -> |scalar| meta-loss."""

    def __init__(self, cfg: ConceptLearnerConfig, *, device="cuda",
                 seed: Optional[int] = 0):
        super().__init__(cfg, device)
        kw, e = self.kw, cfg.images.embedding_dim
        tokens = cfg.text.max_length + cfg.images.tokens_per_image + 1
        self.text_encoder = EmbedTextEncoder(cfg.text, **kw)
        self.image_encoder = ImageTokenizer(cfg.images, **kw)
        self.action_tokenizer = ActionTokenizer(cfg.num_actions, e, **kw)
        self.transformer = _EncoderStackLoop(cfg.transformer, e, **kw)
        self.output_dense = _flax_dense(tokens * e, 1, **kw)
        if seed is not None:
            self.reset_parameters(seed)

    def forward(self, text, images, actions, train: bool = False,
                rngs: Optional[Mapping] = None, positions=None):
        img = self.image_encoder(
            images, train, positions,
            _rng(rngs, self.config.images.rng_collection))
        x = torch.cat([self.text_encoder(text), img,
                       self.action_tokenizer(actions)[:, None, :]], dim=1)
        x = self.transformer(x, None, train, _rng(rngs, "dropout"))
        return self.output_dense(x.reshape(x.shape[0], -1)).abs()


class ConceptPlanner(_LegacyModule):
    """[image tokens, text tokens] -> next-token logits and a state value;
    greedy concept generation.  ``text_length``: the text tokens the value
    head flattens (the generation length; flax infers it from the text it
    is initialized with)."""

    def __init__(self, cfg: ConceptLearnerConfig, text_length: int = 4, *,
                 device="cuda", seed: Optional[int] = 0):
        super().__init__(cfg, device)
        kw, e = self.kw, cfg.images.embedding_dim
        self.num_image_tokens = cfg.images.tokens_per_image
        self.text_length = text_length
        self.text_encoder = EmbedTextEncoder(cfg.text, **kw)
        self.image_encoder = ImageTokenizer(cfg.images, **kw)
        self.transformer = _EncoderStackLoop(cfg.transformer, e, **kw)
        self.token_logit_head = _flax_dense(e, cfg.text.vocab_size, **kw)
        self.state_value_head = _flax_dense(
            (self.num_image_tokens + text_length) * e, 1, **kw)
        if seed is not None:
            self.reset_parameters(seed)

    def _contextual(self, images, text, train, rngs, positions=None):
        img = self.image_encoder(
            images, train, positions,
            _rng(rngs, self.config.images.rng_collection))
        x = torch.cat([img, self.text_encoder(text)], dim=1)
        img_valid = torch.ones(img.shape[:2], dtype=torch.bool,
                               device=img.device)
        mask = _padding_attention_mask(torch.cat([img_valid, text != 0],
                                                 dim=-1))
        return self.transformer(x, mask, train, _rng(rngs, "dropout"))

    def _next_token_idx(self, text):
        # the first pad position of the text is the next token's slot
        return self.num_image_tokens + (text == 0).int().argmax(dim=-1)

    def _token_logits(self, ctx, text):
        rows = torch.arange(text.shape[0], device=text.device)
        return self.token_logit_head(ctx)[rows, self._next_token_idx(text)]

    def predict_next_token_logits(self, images, text, train: bool = False,
                                  rngs: Optional[Mapping] = None):
        return self._token_logits(self._contextual(images, text, train, rngs),
                                  text)

    def forward(self, images, text, train: bool = False,
                rngs: Optional[Mapping] = None):
        """(next token (B,), its log-probability (B,), value (B, 1))."""
        ctx = self._contextual(images, text, train, rngs)
        logits = self._token_logits(ctx, text)
        token = logits.argmax(dim=-1)
        log_prob = torch.log_softmax(logits.float(), dim=-1).gather(
            -1, token[:, None])[:, 0]
        value = self.state_value_head(ctx.reshape(ctx.shape[0], -1))
        return token, log_prob, value

    def predict_concept_and_value(self, images, max_length: int = 4,
                                  terminate_token: int = 5,
                                  train: bool = False,
                                  rngs: Optional[Mapping] = None):
        """Greedy generation of ``max_length`` tokens, each written at its
        step's slot; after ``terminate_token`` a row emits 0 with log-prob
        0.  A loop on the device: nothing is read back.  Returns (tokens
        (B, max_length) int32, summed log-probabilities (B,), the value of
        the empty text (B, 1))."""
        b = images.shape[0]
        dev = images.device
        rows = torch.arange(b, device=dev)
        text = torch.zeros((b, max_length), dtype=torch.int32, device=dev)
        value = self.state_value_head(self._contextual(
            images, text, train, rngs).reshape(b, -1))
        log_probs = torch.zeros((b,), device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for idx in range(max_length):
            logits = self._token_logits(
                self._contextual(images, text, train, rngs), text)
            token = logits.argmax(dim=-1).int()
            lp = torch.log_softmax(logits.float(), dim=-1)[rows, token.long()]
            token = torch.where(done, torch.zeros_like(token), token)
            lp = torch.where(done, torch.zeros_like(lp), lp)
            text = text.clone()
            text[:, idx] = token
            log_probs = log_probs + lp
            done = done | (token == terminate_token)
        return text, log_probs, value


@dataclass
class VisualConceptPlanner:
    """The planner's and the learner's train states together."""

    planner_state: Any
    learner_state: Any


@dataclass(frozen=True)
class PointCloudTransformerConfig:
    lbr_features: Tuple[int, int] = (64, 64)
    sample1: Tuple[int, int, int] = (512, 32, 128)   # (samples, knn, embed)
    sample2: Tuple[int, int, int] = (256, 32, 256)
    attention_heads: int = 4
    attention_layers: int = 4
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32


class PointCloudTransformer(_LegacyModule):
    """PCT: LBR x2 -> SampleAndGroup x2 -> OffsetAttention x N -> concat.
    ``in_features``: the points' feature count, xyz first."""

    def __init__(self, cfg: PointCloudTransformerConfig = None,
                 in_features: int = 3, *, device="cuda",
                 seed: Optional[int] = 0):
        cfg = cfg or PointCloudTransformerConfig()
        super().__init__(cfg, device)
        kw = self.kw
        width = in_features
        for i, feats in enumerate(cfg.lbr_features):
            setattr(self, f"lbr{i}_dense", Dense(
                width, feats, kernel_init="xavier", bias_init="zeros", **kw))
            setattr(self, f"lbr{i}_bn", BatchNorm(feats, **kw))
            width = 3 + feats          # xyz stays in front
        self.sample_group1 = SampleAndGroup(width, *cfg.sample1, **kw)
        self.sample_group2 = SampleAndGroup(3 + cfg.sample1[2],
                                            *cfg.sample2, **kw)
        e = cfg.sample2[2]
        for i in range(cfg.attention_layers):
            setattr(self, f"offset_attention{i}", OffsetAttention(
                e, cfg.attention_heads, e, **kw))
        if seed is not None:
            self.reset_parameters(seed)

    def forward(self, points, train: bool = False, starts=(None, None),
                generator: Optional[torch.Generator] = None):
        """(B, N, F) points -> (B, M2, layers * E2).  ``starts``: the FPS
        start index of each stage (an int or one per cloud; the JAX model
        takes one per stage for the whole batch from its key), else drawn
        from ``generator``."""
        c = self.config
        x = points
        for i in range(len(c.lbr_features)):
            y = getattr(self, f"lbr{i}_dense")(x)
            y = torch.relu(getattr(self, f"lbr{i}_bn")(y, train))
            x = torch.cat([x[..., :3].to(y.dtype), y], dim=-1)
        x = self.sample_group1(x, train, starts[0], generator)
        x = self.sample_group2(x, train, starts[1], generator)
        x = x[..., 3:]
        outputs = []
        for i in range(c.attention_layers):
            x = getattr(self, f"offset_attention{i}")(x, train=train)
            outputs.append(x)
        return torch.cat(outputs, dim=-1)
