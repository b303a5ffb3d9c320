"""Octo: the vision-language-action transformer policy.

Counterpart of the JAX package's ``models/octo.py``: ``encode_text``, the
``generate_readouts*`` backbone, ``assemble_embeddings``, and every head's
predict and loss methods: the diffusion head's
(``predict_diffusion_action`` with its cached-text ``_with_text`` and
external-tower ``_with_modalities`` variants,
``compute_diffusion_denoise_loss[_with_text]``,
``predict_diffusion_denoise_term``), the continuous head's
(``predict_continuous_action[_with_text]``, ``compute_l2_loss[_with_text]``)
and the categorical head's (``predict_action_logits[_with_text]``,
``compute_ce_loss[_with_text]``).  The sequence layout, the block-causal
masks and the assembly permutation are static tables built once; assembly
is one concat and one gather.  With a compression string of nonzero rates
and ``compression_mode`` 'merge' or 'prune' the transformer is the
``CompressedTransformerStack`` (ToMe merging or pruning), and the readouts
are taken at its final layout.

``train=True`` runs the stochastic pieces from ``rngs``, a mapping of rng
collection name to ``torch.Generator`` (``dropout``, ``patch_encoding``,
``diffusion``); each draw may be passed in instead (``positions``,
``time``, ``noise``).  The transformer's attention core is chosen when the
model is built (``modules.attention.select_attention_fn``).

The model is built on ``device`` ('cuda' unless the caller says otherwise)
and initialized from an explicit seed.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch
from torch import nn

from ..core.config import LatentMoETransformerConfig, OctoConfig
from ..heads.categorical import CategoricalActionHead, assign_bins
from ..heads.continuous import ContinuousActionHead
from ..heads.diffusion import DiffusionActionHead
from ..modules.attention import TransformerStack, select_attention_fn
from ..modules.image_tokenizer import ImageTokenizer
from ..modules.latent_moe import LatentMoEStack
from ..modules.layers import Dense
from ..modules.readout import ReadoutTokens
from ..modules.text import build_text_encoder
from ..modules.tome_stack import CompressedTransformerStack
from ..sequence.layout import SequenceLayout
from ..utils.profiling import section

__all__ = ["Octo", "TokenEmbeddings"]


class TokenEmbeddings(NamedTuple):
    text: torch.Tensor
    images: torch.Tensor
    readouts: torch.Tensor


class Octo(nn.Module):
    def __init__(self, config: OctoConfig, *, device="cuda",
                 seed: Optional[int] = 0):
        """``seed=None`` leaves the parameters uninitialized (to be loaded
        from a state_dict)."""
        super().__init__()
        cfg = config
        self.config = cfg
        self.layout = SequenceLayout.from_strings(cfg.input_sequence,
                                                  cfg.compression_sequence)
        use_compression = (self.layout.compressible
                           and cfg.transformer.compression_mode != "none")
        if cfg.transformer.prestack_merge and not use_compression:
            raise ValueError(
                "transformer.prestack_merge requires an active compression "
                "config (a compression_sequence with nonzero rates AND "
                "compression_mode 'merge'/'prune'); with compression off "
                "the flag would be silently inert")
        self.use_compression = use_compression
        kw = dict(dtype=cfg.compute_dtype, param_dtype=cfg.params_dtype,
                  device=device)
        e = cfg.token_embedding_dim
        self.text_encoder = build_text_encoder(cfg.text, **kw)
        # a text tower narrower or wider than the tokens is projected to them
        self.text_projection = (
            Dense(cfg.text.embedding_dim, e, **kw)
            if cfg.text.embedding_dim != e else None)
        self.image_encoder = ImageTokenizer(cfg.images, **kw)
        self.readout_encoder = ReadoutTokens(
            self.layout.modality_tokens("readouts"), e, **kw)
        if isinstance(cfg.transformer, LatentMoETransformerConfig):
            self.transformer = LatentMoEStack(cfg.transformer, self.layout,
                                              e, **kw)
            readout_layer = self.transformer.final_layer()
            self.use_compression = True
        elif use_compression:
            self.transformer = CompressedTransformerStack(
                cfg.transformer, self.layout, e, **kw)
            readout_layer = self.transformer.final_layer()
        else:
            self.transformer = TransformerStack(
                cfg.transformer, self.layout.total_tokens, e,
                select_attention_fn(cfg.transformer,
                                    self.layout.attention_mask(),
                                    self.layout.total_tokens, device), **kw)
            readout_layer = 0
        heads = cfg.heads
        if heads.continuous is not None:
            self.continuous_action_head = ContinuousActionHead(
                heads.continuous, e, **kw)
        if heads.categorical is not None:
            self.categorical_action_head = CategoricalActionHead(
                heads.categorical, e, **kw)
        if heads.diffusion is not None:
            self.diffusion_action_head = DiffusionActionHead(
                heads.diffusion, e, **kw)

        self.register_buffer("attention_mask", torch.as_tensor(
            self.layout.attention_mask(), device=device), persistent=False)
        self.register_buffer("assembly_permutation", torch.as_tensor(
            self.layout.assembly_permutation, dtype=torch.long,
            device=device), persistent=False)
        self.register_buffer("readout_index", torch.as_tensor(
            self.layout.modality_index("readouts", layer=readout_layer),
            dtype=torch.long,
            device=device), persistent=False)
        if seed is not None:
            self.reset_parameters(seed)

    @property
    def device(self) -> torch.device:
        return self.attention_mask.device

    def moe_aux_loss(self) -> Optional[torch.Tensor]:
        """The transformer's pre-weighted mixture-of-experts balance loss
        from its last forward (``aux_loss_weight`` times the sum over its
        blocks, a float32 device tensor; the JAX package's sown ``'losses'``
        collection), or None for a dense MLP.  ``make_train_step`` adds it
        to the loss."""
        return self.transformer.moe_aux

    def reset_parameters(self, seed: int) -> None:
        """Draw every parameter from the flax initializers' distributions
        with one generator seeded by ``seed``, on the model's device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    # -- backbone ----------------------------------------------------------

    def encode_text(self, text_tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) ids -> (B, T, E) text embeddings."""
        with section("model.text"):
            x = self.text_encoder(text_tokens)
            if self.text_projection is not None:
                x = self.text_projection(x)
            return x

    def generate_readouts(self, text_tokens, images, train: bool = False,
                          *, rngs: Optional[Mapping] = None,
                          positions=None):
        return self.generate_readouts_with_text(
            self.encode_text(text_tokens), images, train, rngs=rngs,
            positions=positions)

    def generate_readouts_with_text(self, text_embeddings, images,
                                    train: bool = False, *,
                                    rngs: Optional[Mapping] = None,
                                    positions=None):
        rngs = rngs or {}
        with section("model.image"):
            image_embeddings = self.image_encoder(
                images, train, positions,
                rngs.get(self.config.images.rng_collection))
        return self.generate_readouts_with_modalities(
            text_embeddings, image_embeddings, train, rngs=rngs)

    def generate_readouts_with_modalities(self, text_embeddings,
                                          image_embeddings,
                                          train: bool = False, *,
                                          rngs: Optional[Mapping] = None):
        """Both modality streams given -> (B, R, E) readout embeddings."""
        with section("model.stack"):
            readouts = self.readout_encoder(image_embeddings.shape[0])
            x = self.assemble_embeddings(TokenEmbeddings(
                text=text_embeddings, images=image_embeddings,
                readouts=readouts))
            rng = (rngs or {}).get("dropout")
            if self.use_compression:
                x = self.transformer(x, train, rng)
            else:
                x = self.transformer(x, self.attention_mask, train, rng)
            return x.index_select(1, self.readout_index)

    def assemble_embeddings(self, embeddings: TokenEmbeddings):
        """Interleave the modality streams: one concat, one gather."""
        streams = (("text", embeddings.text), ("images", embeddings.images),
                   ("readouts", embeddings.readouts))
        for name, stream in streams:
            expected = self.layout.modality_tokens(name)
            if stream.shape[1] != expected:
                raise ValueError(
                    f"{name} stream has {stream.shape[1]} tokens but the "
                    f"sequence layout {self.config.input_sequence!r} "
                    f"expects {expected}")
        dtype = self.config.compute_dtype
        combined = torch.cat([s.to(dtype) for _, s in streams], dim=1)
        return combined.index_select(1, self.assembly_permutation)

    # -- continuous head ---------------------------------------------------

    def predict_continuous_action(self, text_tokens, images,
                                  train: bool = False, **kw):
        """(B, 1, A) actions; ``kw``: ``rngs``, ``positions``."""
        return self.continuous_action_head(
            self.generate_readouts(text_tokens, images, train, **kw))

    def predict_continuous_action_with_text(self, text_embeddings, images,
                                            train: bool = False, **kw):
        return self.continuous_action_head(
            self.generate_readouts_with_text(text_embeddings, images, train,
                                             **kw))

    def _l2_from_readouts(self, readouts, actions):
        pred = self.continuous_action_head(readouts).squeeze()
        return (pred - actions).square().sum(dim=-1)

    def compute_l2_loss(self, text_tokens, images, actions,
                        train: bool = True, **kw):
        """Per-example squared error (B,)."""
        return self._l2_from_readouts(
            self.generate_readouts(text_tokens, images, train, **kw), actions)

    def compute_l2_loss_with_text(self, text_embeddings, images, actions,
                                  train: bool = True, **kw):
        return self._l2_from_readouts(
            self.generate_readouts_with_text(text_embeddings, images, train,
                                             **kw), actions)

    # -- categorical head --------------------------------------------------

    def predict_action_logits(self, text_tokens, images, train: bool = False,
                              **kw):
        return self.categorical_action_head(
            self.generate_readouts(text_tokens, images, train, **kw))

    def predict_action_logits_with_text(self, text_embeddings, images,
                                        train: bool = False, **kw):
        return self.categorical_action_head(
            self.generate_readouts_with_text(text_embeddings, images, train,
                                             **kw))

    def _ce_from_readouts(self, readouts, actions):
        cfg = self.config.heads.categorical
        target_bin = assign_bins(actions, (-cfg.max_action, cfg.max_action),
                                 cfg.num_bins)
        # one-hot over num_bins classes: a bin index past them (an action at
        # or above the top edge) selects nothing, as jax.nn.one_hot
        classes = torch.arange(cfg.num_bins, device=actions.device)
        targets = (target_bin[..., None] == classes).float()
        logits = self.categorical_action_head(readouts)
        logprobs = torch.log_softmax(logits.float(), dim=-1)
        return -(targets * logprobs).sum(dim=-1)

    def compute_ce_loss(self, text_tokens, images, actions,
                        train: bool = True, **kw):
        """Per-example, per-dimension cross entropy (B, A)."""
        return self._ce_from_readouts(
            self.generate_readouts(text_tokens, images, train, **kw), actions)

    def compute_ce_loss_with_text(self, text_embeddings, images, actions,
                                  train: bool = True, **kw):
        return self._ce_from_readouts(
            self.generate_readouts_with_text(text_embeddings, images, train,
                                             **kw), actions)

    # -- diffusion head ----------------------------------------------------

    def predict_diffusion_denoise_term(self, text_tokens, images, time,
                                       noisy_actions, train: bool = False,
                                       *, rngs: Optional[Mapping] = None,
                                       positions=None):
        readouts = self.generate_readouts(text_tokens, images, train,
                                          rngs=rngs, positions=positions)
        return self.diffusion_action_head.predict_denoise_term(
            readouts, time, noisy_actions, train, (rngs or {}).get("dropout"))

    def compute_diffusion_denoise_loss(self, text_tokens, images, actions,
                                       train: bool = True, *,
                                       rngs: Optional[Mapping] = None,
                                       positions=None, time=None,
                                       noise=None):
        """Scalar denoising loss; ``positions``, ``time`` and ``noise``
        replace the draws of the ``patch_encoding`` and ``diffusion``
        generators."""
        return self.compute_diffusion_denoise_loss_with_text(
            self.encode_text(text_tokens), images, actions, train, rngs=rngs,
            positions=positions, time=time, noise=noise)

    def compute_diffusion_denoise_loss_with_text(
            self, text_embeddings, images, actions, train: bool = True, *,
            rngs: Optional[Mapping] = None, positions=None, time=None,
            noise=None):
        """As :meth:`compute_diffusion_denoise_loss` with the frozen text
        tower's embeddings given (``utils.data.cache_text_embeddings``)."""
        readouts = self.generate_readouts_with_text(
            text_embeddings, images, train, rngs=rngs, positions=positions)
        return self.diffusion_action_head.denoise_loss(
            readouts, actions, train, time, noise, rngs=rngs)

    def predict_diffusion_action(self, text_tokens, images, **sample_kw):
        """``sample_kw``: ``noisy``, ``noise``, ``generator``,
        ``ddim_steps`` of ``DiffusionActionHead.predict_action``."""
        return self.diffusion_action_head.predict_action(
            self.generate_readouts(text_tokens, images), **sample_kw)

    def predict_diffusion_action_with_text(self, text_embeddings, images,
                                           **sample_kw):
        return self.diffusion_action_head.predict_action(
            self.generate_readouts_with_text(text_embeddings, images),
            **sample_kw)

    def predict_diffusion_action_with_modalities(
            self, text_embeddings, image_embeddings, **sample_kw):
        return self.diffusion_action_head.predict_action(
            self.generate_readouts_with_modalities(text_embeddings,
                                                   image_embeddings),
            **sample_kw)
